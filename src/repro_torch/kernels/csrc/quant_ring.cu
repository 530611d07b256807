// Fused int8 ring hop kernels for Hopper (sm_90a), bound to Python with
// ctypes by repro_torch/kernels/quant_ring.py.
//
// Each kernel replaces one Pallas TPU kernel of src/repro/kernels/quant_ring.py:
//   quantize_pack          quantize_pack_pallas          (pallas_call at :188)
//   dequant_add_quantize   dequant_add_quantize_pallas   (pallas_call at :226)
//   dequant_accumulate     dequant_accumulate_pallas     (with acc, :275)
//   dequant                dequant_accumulate_pallas     (acc=None, :267)
//
// Bound: bytes. Each kernel reads every input element once, writes every
// output element once and does a handful of flops per element, far below
// the card's operations-per-byte line. Per element: quantize_pack 5 bytes
// (f32 in, int8 out), dequant_add_quantize 6 (int8 + f32 in, int8 out),
// dequant_accumulate 9 (int8 + f32 in, f32 out), dequant 5 (int8 in, f32
// out): the counts quant_ring.py:187,223,261 budget, plus 4 or 8 bytes of
// scales per row. The two quantizing kernels give each sub-block row to one
// thread block: the row's amax is a block reduction, and the second pass
// reads the row again from L1/L2 rather than holding it in registers, which
// puts no limit on the row length. The dequantizers take one row per thread
// block as well, so each thread reads its row's scale once.
//
// Bits. The kernels are bit-exact against the plain PyTorch versions:
//   scale = amax > 0 ? amax / 127 : 1, q = rint(x / scale) clamped to +-127,
//   with correctly rounded division (__fdiv_rn; a multiply by 1/scale would
//   give other bits) and rintf rounding half to even as torch.round does;
//   y = acc + q * scale as __fadd_rn(acc, __fmul_rn(q, scale)), which the
//   compiler never contracts into an FMA.
// fmaxf drops a NaN where torch.amax propagates it, so inputs must be finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kWarps = kRowThreads / 32;
constexpr float kQmax = 127.f;

// Max over the thread block; every thread gets the result. Called once per
// kernel, so the shared scratch is never reused.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_max[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) v = fmaxf(v, warp_max[i]);
  return v;
}

__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, kQmax) : 1.f;
}

__device__ __forceinline__ int8_t quantize(float y, float scale) {
  const float v = rintf(__fdiv_rn(y, scale));
  return static_cast<int8_t>(fminf(fmaxf(v, -kQmax), kQmax));
}

__device__ __forceinline__ float dequant_add(int8_t q, float scale, float acc) {
  return __fadd_rn(acc, __fmul_rn(static_cast<float>(q), scale));
}

__global__ void __launch_bounds__(kRowThreads)
quantize_pack_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, int64_t block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  float m = 0.f;
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    m = fmaxf(m, fabsf(x[base + i]));
  const float scale = row_scale(block_max(m));
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    q[base + i] = quantize(x[base + i], scale);
}

__global__ void __launch_bounds__(kRowThreads)
dequant_add_quantize_kernel(const int8_t* __restrict__ q,
                            const float* __restrict__ scales,
                            const float* __restrict__ acc,
                            int8_t* __restrict__ q_out,
                            float* __restrict__ s_out, int64_t block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const float s = scales[blockIdx.x];
  float m = 0.f;
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    m = fmaxf(m, fabsf(dequant_add(q[base + i], s, acc[base + i])));
  const float scale = row_scale(block_max(m));
  if (threadIdx.x == 0) s_out[blockIdx.x] = scale;
  // recomputing y gives the same bits as the first pass
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    q_out[base + i] = quantize(dequant_add(q[base + i], s, acc[base + i]), scale);
}

__global__ void __launch_bounds__(kRowThreads)
dequant_accumulate_kernel(const int8_t* __restrict__ q,
                          const float* __restrict__ scales,
                          const float* __restrict__ acc,
                          float* __restrict__ out, int64_t block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const float s = scales[blockIdx.x];
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    out[base + i] = dequant_add(q[base + i], s, acc[base + i]);
}

__global__ void __launch_bounds__(kRowThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
               float* __restrict__ out, int64_t block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const float s = scales[blockIdx.x];
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    out[base + i] = __fmul_rn(static_cast<float>(q[base + i]), s);
}

}  // namespace

// Plain C entry points. Each launches on the given stream, allocates
// nothing, and returns cudaGetLastError() of its launch. Sizes are > 0
// (the wrapper does not call for empty tensors).
extern "C" {

int quant_ring_quantize_pack(const void* x, void* q, void* scales,
                             int64_t n_blocks, int64_t block, void* stream) {
  quantize_pack_kernel<<<static_cast<unsigned int>(n_blocks), kRowThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), block);
  return static_cast<int>(cudaGetLastError());
}

int quant_ring_dequant_add_quantize(const void* q, const void* scales,
                                    const void* acc, void* q_out, void* s_out,
                                    int64_t n_blocks, int64_t block,
                                    void* stream) {
  dequant_add_quantize_kernel<<<static_cast<unsigned int>(n_blocks), kRowThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<const float*>(acc), static_cast<int8_t*>(q_out),
      static_cast<float*>(s_out), block);
  return static_cast<int>(cudaGetLastError());
}

int quant_ring_dequant_accumulate(const void* q, const void* scales,
                                  const void* acc, void* out, int64_t n_blocks,
                                  int64_t block, void* stream) {
  dequant_accumulate_kernel<<<static_cast<unsigned int>(n_blocks), kRowThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<const float*>(acc), static_cast<float*>(out), block);
  return static_cast<int>(cudaGetLastError());
}

int quant_ring_dequant(const void* q, const void* scales, void* out,
                       int64_t n_blocks, int64_t block, void* stream) {
  dequant_kernel<<<static_cast<unsigned int>(n_blocks), kRowThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
