// Fused ring hop kernels for Hopper (sm_90a), bound to Python with ctypes by
// repro_torch/kernels/quant_ring.py.
//
// Each kernel replaces one Pallas TPU kernel of src/repro/kernels/quant_ring.py:
//   quantize_pack[_fp8]          quantize_pack_pallas          (pallas_call at :188)
//   dequant_add_quantize[_fp8]   dequant_add_quantize_pallas   (pallas_call at :226)
//   dequant_accumulate[_fp8]     dequant_accumulate_pallas     (with acc, :275)
//   dequant[_fp8]                dequant_accumulate_pallas     (acc=None, :267)
//   cast_pack_bf16               cast_pack_bf16_pallas         (pallas_call at :303)
//   bf16_add_cast                bf16_add_cast_pallas          (pallas_call at :328)
//   bf16_accumulate              bf16_accumulate_pallas        (with acc, :370)
//   bf16_upcast                  bf16_accumulate_pallas        (acc=None, :362)
// The four quantized kernels are templates over the wire payload: int8
// (qmax 127, rounded half to even) and fp8 e4m3 (qmax 448, rounded by the
// cast); the *_fp8 entry points are the e4m3 instantiations.
//
// Bound: bytes. Each kernel reads every input element once, writes every
// output element once and does a handful of flops per element, far below
// the card's operations-per-byte line. Per element: quantize_pack 5 bytes
// (f32 in, 1-byte payload out), dequant_add_quantize 6 (payload + f32 in,
// payload out), dequant_accumulate 9 (payload + f32 in, f32 out), dequant 5
// (payload in, f32 out): the counts quant_ring.py:187,223,261 budget, plus
// 4 or 8 bytes of scales per row. The bf16 kernels move 6 (cast_pack_bf16),
// 8 (bf16_add_cast), 10 (bf16_accumulate) and 6 (bf16_upcast) bytes per
// element, the counts of quant_ring.py:301,326,358.
//
// The two quantizing kernels give each sub-block row to one thread block:
// the row's amax is a block reduction, and the second pass reads the row
// again from L1/L2 rather than holding it in registers, which puts no limit
// on the row length. The dequantizers take one row per thread block as
// well, so each thread reads its row's scale once. The quantizing kernels
// write payload and scales through two pointers, so the ring points them
// into one wire message (the payload, then its trailer); dequant reads the
// Share-Only gather's messages where they landed, a message apart, and
// writes each to its chunk's place in the sum. The bf16 kernels have no
// rows (no scales): a flat grid-stride loop over all elements.
//   cast_pack_bf16 moves 16 bytes a load: a block of kCastThreads casts
// kCastVecs * kCastThreads consecutive float4s, each thread kCastVecs of
// them (four elements each, written as one 8-byte store of four bf16),
// both loads issued before the first store and neighbouring lanes on
// neighbouring vectors. Its grid covers the whole tensor once (a grid-stride
// loop takes what a grid of 2^31 - 1 blocks cannot). The elements past the
// last whole vector go one by one, and so does every element where x is not
// on 16 bytes or out not on 8 (a view; the wrapper's fresh out always is on
// 16). At the embed chunk's
// shape it runs with x.to(bfloat16)'s own kernel, both about 99% of the
// byte bound on the device alone; a grid sized to the card (SMs times
// resident blocks) with four float4s a thread ran 2.7% slower, and the
// scalar loop it replaces (4 bytes a thread at a time, at most 16 blocks an
// SM) 67% of the bound (tools/cast_forms.py times the forms; PERF.md).
//
// Bits. The kernels are bit-exact against the plain PyTorch versions:
//   scale = amax > 0 ? amax / qmax : 1 with correctly rounded division
//   (__fdiv_rn; a multiply by 1/scale would give other bits);
//   int8: q = rint(x / scale) clamped to +-127, rintf rounding half to even
//   as torch.round does;
//   fp8: q = e4m3(clamp(x / scale, +-448)), the cast rounding to nearest
//   even (subnormals included) as torch's float8_e4m3fn cast does;
//   y = acc + q * scale as __fadd_rn(acc, __fmul_rn(q, scale)), which the
//   compiler never contracts into an FMA; e4m3 -> f32 is exact;
//   bf16: __float2bfloat16_rn (round to nearest even) and the exact upcast.
// fmaxf drops a NaN where torch.amax propagates it, so inputs must be finite.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_config.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kWarps = kRowThreads / 32;
constexpr int kFlatThreads = 256;
constexpr int kCastThreads = 128;  // cast_pack_bf16's block
constexpr int kCastVecs = 2;       // its float4s a thread

// The int8 wire: integer codes, rounded half to even.
struct Int8Wire {
  using T = int8_t;
  static constexpr float kQmax = 127.f;
  __device__ static __forceinline__ T encode(float y, float scale) {
    const float v = rintf(__fdiv_rn(y, scale));
    return static_cast<T>(fminf(fmaxf(v, -kQmax), kQmax));
  }
  __device__ static __forceinline__ float decode(T q) {
    return static_cast<float>(q);
  }
};

// The fp8 wire: e4m3 codes (stored as their raw byte), the cast rounding.
struct Fp8Wire {
  using T = __nv_fp8_storage_t;
  static constexpr float kQmax = 448.f;
  __device__ static __forceinline__ T encode(float y, float scale) {
    const float v = fminf(fmaxf(__fdiv_rn(y, scale), -kQmax), kQmax);
    return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  }
  __device__ static __forceinline__ float decode(T q) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E4M3)));
  }
};

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

template <class W>
__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, W::kQmax) : 1.f;
}

template <class W>
__device__ __forceinline__ float dequant_add(typename W::T q, float scale, float acc) {
  return __fadd_rn(acc, __fmul_rn(W::decode(q), scale));
}

template <class W>
__global__ void __launch_bounds__(kRowThreads)
quantize_pack_kernel(const float* __restrict__ x, typename W::T* __restrict__ q,
                     float* __restrict__ scales, int64_t block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  float m = 0.f;
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    m = fmaxf(m, fabsf(x[base + i]));
  const float scale = row_scale<W>(block_max(m));
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    q[base + i] = W::encode(x[base + i], scale);
}

template <class W>
__global__ void __launch_bounds__(kRowThreads)
dequant_add_quantize_kernel(const typename W::T* __restrict__ q,
                            const float* __restrict__ scales,
                            const float* __restrict__ acc,
                            typename W::T* __restrict__ q_out,
                            float* __restrict__ s_out, int64_t block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const float s = scales[blockIdx.x];
  float m = 0.f;
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    m = fmaxf(m, fabsf(dequant_add<W>(q[base + i], s, acc[base + i])));
  const float scale = row_scale<W>(block_max(m));
  if (threadIdx.x == 0) s_out[blockIdx.x] = scale;
  // recomputing y gives the same bits as the first pass
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    q_out[base + i] = W::encode(dequant_add<W>(q[base + i], s, acc[base + i]), scale);
}

template <class W>
__global__ void __launch_bounds__(kRowThreads)
dequant_accumulate_kernel(const typename W::T* __restrict__ q,
                          const float* __restrict__ scales,
                          const float* __restrict__ acc,
                          float* __restrict__ out, int64_t block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const float s = scales[blockIdx.x];
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    out[base + i] = dequant_add<W>(q[base + i], s, acc[base + i]);
}

// `rows` messages of n_blocks sub-blocks each, message r's payload q_row
// elements and its scales s_row floats past message r-1's (the rows of one
// gather buffer: each message's scales are its own trailer); message r is
// written to chunk (first - r) mod rows of out. One sub-block a thread block.
template <class W>
__global__ void __launch_bounds__(kRowThreads)
dequant_kernel(const typename W::T* __restrict__ q, int64_t q_row,
               const float* __restrict__ scales, int64_t s_row,
               float* __restrict__ out, int64_t n_blocks, int64_t block,
               int64_t rows, int64_t first) {
  const int64_t r = blockIdx.x / n_blocks;
  const int64_t j = blockIdx.x - r * n_blocks;
  const int64_t chunk = (first - r + rows) % rows;
  const typename W::T* __restrict__ src = q + r * q_row + j * block;
  float* __restrict__ dst = out + (chunk * n_blocks + j) * block;
  const float s = scales[r * s_row + j];
  for (int64_t i = threadIdx.x; i < block; i += kRowThreads)
    dst[i] = __fmul_rn(W::decode(src[i]), s);
}

// Four f32 values as four bf16 in one 8-byte word, the first in the low half.
__device__ __forceinline__ uint2 bf16x4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// out = bf16(x): the first 4 nvec elements as float4s (x on 16 bytes and out
// on 8), the rest one by one.
__global__ void __launch_bounds__(kCastThreads)
cast_pack_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
                      int64_t n, int64_t nvec) {
  constexpr int64_t kPerBlock = static_cast<int64_t>(kCastVecs) * kCastThreads;
  const float4* __restrict__ xv = reinterpret_cast<const float4*>(x);
  uint2* __restrict__ ov = reinterpret_cast<uint2*>(out);
  for (int64_t b0 = blockIdx.x * kPerBlock; b0 < nvec; b0 += gridDim.x * kPerBlock) {
    const int64_t i0 = b0 + threadIdx.x;
    float4 v[kCastVecs];
#pragma unroll
    for (int u = 0; u < kCastVecs; ++u)
      if (i0 + u * kCastThreads < nvec) v[u] = xv[i0 + u * kCastThreads];
#pragma unroll
    for (int u = 0; u < kCastVecs; ++u)
      if (i0 + u * kCastThreads < nvec) ov[i0 + u * kCastThreads] = bf16x4(v[u]);
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kCastThreads;
  for (int64_t i = 4 * nvec + blockIdx.x * static_cast<int64_t>(kCastThreads) + threadIdx.x;
       i < n; i += threads)
    out[i] = __float2bfloat16_rn(x[i]);
}

__global__ void __launch_bounds__(kFlatThreads)
bf16_add_cast_kernel(const __nv_bfloat16* __restrict__ recv,
                     const float* __restrict__ acc,
                     __nv_bfloat16* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kFlatThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kFlatThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = __float2bfloat16_rn(__fadd_rn(acc[i], __bfloat162float(recv[i])));
}

__global__ void __launch_bounds__(kFlatThreads)
bf16_accumulate_kernel(const __nv_bfloat16* __restrict__ recv,
                       const float* __restrict__ acc, float* __restrict__ out,
                       int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kFlatThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kFlatThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = __fadd_rn(acc[i], __bfloat162float(recv[i]));
}

__global__ void __launch_bounds__(kFlatThreads)
bf16_upcast_kernel(const __nv_bfloat16* __restrict__ recv, float* __restrict__ out,
                   int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kFlatThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kFlatThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = __bfloat162float(recv[i]);
}

// Thread blocks of a flat kernel: one per kFlatThreads elements, at most
// 16 per SM of the card's 132 (the grid-stride loop covers the rest).
unsigned int flat_blocks(int64_t n) {
  const int64_t want = (n + kFlatThreads - 1) / kFlatThreads;
  return static_cast<unsigned int>(want < 132 * 16 ? want : 132 * 16);
}

// Blocks of cast_pack_bf16's grid: one per kCastVecs * kCastThreads float4s
// of n elements (at least one), at most 2^31 - 1.
unsigned int cast_blocks(int64_t n) {
  const int64_t per_block = static_cast<int64_t>(4) * kCastVecs * kCastThreads;
  const int64_t want = (n + per_block - 1) / per_block;
  return static_cast<unsigned int>(want < 0x7fffffff ? want : 0x7fffffff);
}

cudaStream_t as_stream(void* stream) { return static_cast<cudaStream_t>(stream); }

template <class W>
int launch_quantize_pack(const void* x, void* q, void* scales,
                         int64_t n_blocks, int64_t block, void* stream) {
  quantize_pack_kernel<W><<<static_cast<unsigned int>(n_blocks), kRowThreads, 0,
                            as_stream(stream)>>>(
      static_cast<const float*>(x), static_cast<typename W::T*>(q),
      static_cast<float*>(scales), block);
  return static_cast<int>(cudaGetLastError());
}

template <class W>
int launch_dequant_add_quantize(const void* q, const void* scales, const void* acc,
                                void* q_out, void* s_out, int64_t n_blocks,
                                int64_t block, void* stream) {
  dequant_add_quantize_kernel<W><<<static_cast<unsigned int>(n_blocks), kRowThreads,
                                   0, as_stream(stream)>>>(
      static_cast<const typename W::T*>(q), static_cast<const float*>(scales),
      static_cast<const float*>(acc), static_cast<typename W::T*>(q_out),
      static_cast<float*>(s_out), block);
  return static_cast<int>(cudaGetLastError());
}

template <class W>
int launch_dequant_accumulate(const void* q, const void* scales, const void* acc,
                              void* out, int64_t n_blocks, int64_t block,
                              void* stream) {
  dequant_accumulate_kernel<W><<<static_cast<unsigned int>(n_blocks), kRowThreads,
                                 0, as_stream(stream)>>>(
      static_cast<const typename W::T*>(q), static_cast<const float*>(scales),
      static_cast<const float*>(acc), static_cast<float*>(out), block);
  return static_cast<int>(cudaGetLastError());
}

template <class W>
int launch_dequant(const void* q, int64_t q_row, const void* scales, int64_t s_row,
                   void* out, int64_t rows, int64_t n_blocks, int64_t block,
                   int64_t first, void* stream) {
  dequant_kernel<W><<<static_cast<unsigned int>(rows * n_blocks), kRowThreads, 0,
                      as_stream(stream)>>>(
      static_cast<const typename W::T*>(q), q_row, static_cast<const float*>(scales),
      s_row, static_cast<float*>(out), n_blocks, block, rows, first);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points. Each launches on the given stream, allocates
// nothing, and returns cudaGetLastError() of its launch. Sizes are > 0
// (the wrapper does not call for empty tensors).
extern "C" {

int quant_ring_quantize_pack(const void* x, void* q, void* scales,
                             int64_t n_blocks, int64_t block, void* stream) {
  return launch_quantize_pack<Int8Wire>(x, q, scales, n_blocks, block, stream);
}

int quant_ring_quantize_pack_fp8(const void* x, void* q, void* scales,
                                 int64_t n_blocks, int64_t block, void* stream) {
  return launch_quantize_pack<Fp8Wire>(x, q, scales, n_blocks, block, stream);
}

int quant_ring_dequant_add_quantize(const void* q, const void* scales,
                                    const void* acc, void* q_out, void* s_out,
                                    int64_t n_blocks, int64_t block,
                                    void* stream) {
  return launch_dequant_add_quantize<Int8Wire>(q, scales, acc, q_out, s_out,
                                               n_blocks, block, stream);
}

int quant_ring_dequant_add_quantize_fp8(const void* q, const void* scales,
                                        const void* acc, void* q_out, void* s_out,
                                        int64_t n_blocks, int64_t block,
                                        void* stream) {
  return launch_dequant_add_quantize<Fp8Wire>(q, scales, acc, q_out, s_out,
                                              n_blocks, block, stream);
}

int quant_ring_dequant_accumulate(const void* q, const void* scales,
                                  const void* acc, void* out, int64_t n_blocks,
                                  int64_t block, void* stream) {
  return launch_dequant_accumulate<Int8Wire>(q, scales, acc, out, n_blocks, block,
                                             stream);
}

int quant_ring_dequant_accumulate_fp8(const void* q, const void* scales,
                                      const void* acc, void* out, int64_t n_blocks,
                                      int64_t block, void* stream) {
  return launch_dequant_accumulate<Fp8Wire>(q, scales, acc, out, n_blocks, block,
                                            stream);
}

// rows messages, each n_blocks sub-blocks, message r to chunk (first - r)
// mod rows (0 <= first < rows); rows = 1, first = 0 is one (n_blocks, block)
// payload dequantized in place order.
int quant_ring_dequant(const void* q, int64_t q_row, const void* scales,
                       int64_t s_row, void* out, int64_t rows, int64_t n_blocks,
                       int64_t block, int64_t first, void* stream) {
  return launch_dequant<Int8Wire>(q, q_row, scales, s_row, out, rows, n_blocks,
                                  block, first, stream);
}

int quant_ring_dequant_fp8(const void* q, int64_t q_row, const void* scales,
                           int64_t s_row, void* out, int64_t rows, int64_t n_blocks,
                           int64_t block, int64_t first, void* stream) {
  return launch_dequant<Fp8Wire>(q, q_row, scales, s_row, out, rows, n_blocks,
                                 block, first, stream);
}

// Whole float4s where x is on 16 bytes and out on 8, else every element one by one.
int quant_ring_cast_pack_bf16(const void* x, void* out, int64_t n, void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  cast_pack_bf16_kernel<<<cast_blocks(n), kCastThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(out), n, vec ? n / 4 : 0);
  return static_cast<int>(cudaGetLastError());
}

int quant_ring_bf16_add_cast(const void* recv, const void* acc, void* out,
                             int64_t n, void* stream) {
  bf16_add_cast_kernel<<<flat_blocks(n), kFlatThreads, 0, as_stream(stream)>>>(
      static_cast<const __nv_bfloat16*>(recv), static_cast<const float*>(acc),
      static_cast<__nv_bfloat16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

int quant_ring_bf16_accumulate(const void* recv, const void* acc, void* out,
                               int64_t n, void* stream) {
  bf16_accumulate_kernel<<<flat_blocks(n), kFlatThreads, 0, as_stream(stream)>>>(
      static_cast<const __nv_bfloat16*>(recv), static_cast<const float*>(acc),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

int quant_ring_bf16_upcast(const void* recv, void* out, int64_t n, void* stream) {
  bf16_upcast_kernel<<<flat_blocks(n), kFlatThreads, 0, as_stream(stream)>>>(
      static_cast<const __nv_bfloat16*>(recv), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// The resources of kernel `which` (see launch_resources()), in the order of
// the entry points above: the int8 then the fp8 instantiations of
// quantize_pack, dequant_add_quantize, dequant_accumulate and dequant; then
// cast_pack_bf16, bf16_add_cast, bf16_accumulate and bf16_upcast. None takes
// dynamic shared memory.
int quant_ring_launch_config(int which, void* out) {
  int* o = static_cast<int*>(out);
  switch (which) {
    case 0: return launch_resources(quantize_pack_kernel<Int8Wire>, kRowThreads, 0, o);
    case 1: return launch_resources(dequant_add_quantize_kernel<Int8Wire>, kRowThreads, 0, o);
    case 2: return launch_resources(dequant_accumulate_kernel<Int8Wire>, kRowThreads, 0, o);
    case 3: return launch_resources(dequant_kernel<Int8Wire>, kRowThreads, 0, o);
    case 4: return launch_resources(quantize_pack_kernel<Fp8Wire>, kRowThreads, 0, o);
    case 5: return launch_resources(dequant_add_quantize_kernel<Fp8Wire>, kRowThreads, 0, o);
    case 6: return launch_resources(dequant_accumulate_kernel<Fp8Wire>, kRowThreads, 0, o);
    case 7: return launch_resources(dequant_kernel<Fp8Wire>, kRowThreads, 0, o);
    case 8: return launch_resources(cast_pack_bf16_kernel, kCastThreads, 0, o);
    case 9: return launch_resources(bf16_add_cast_kernel, kFlatThreads, 0, o);
    case 10: return launch_resources(bf16_accumulate_kernel, kFlatThreads, 0, o);
    case 11: return launch_resources(bf16_upcast_kernel, kFlatThreads, 0, o);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
