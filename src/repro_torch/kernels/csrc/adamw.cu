// AdamW's update of one leaf in one pass, for Hopper (sm_90a), bound to
// Python with ctypes by repro_torch/kernels/adamw.py.
//
// Replaces no Pallas TPU kernel: the JAX package's AdamW
// (src/repro/training/optimizer.py) is jnp arithmetic that XLA fuses into
// one loop a leaf. The port's update ran it as 16 separate PyTorch
// elementwise kernels a leaf (10 with a scalar operand, 8 bytes an element
// each; 6 binary, 12 bytes each): 152 bytes a parameter, near the HBM rate.
// This kernel reads p, g, m and v once and writes p', m' and v' once.
//
// Bound: bytes. A handful of f32 operations an element (two divisions and
// a square root the most costly) against 28 bytes an element with f32 p
// and g, 22 with bf16 p and g (m and v are always f32), far below the
// card's operations-per-byte line: at 3.35 TB/s, 8.36 ps an element (f32)
// or 6.57 ps (bf16).
//
// Design: a grid sized to the leaf, each thread kVecs vectors of four
// elements (neighbouring lanes on neighbouring vectors), every load of
// a thread issued before its first store; m and v move as one 16-byte
// float4 a vector, f32 p and g as one too, bf16 p and g as one 8-byte
// word of four. The elements past the last whole vector go one by one, and
// so does every element where a pointer is off its vector's width (a view;
// the wrapper's fresh outputs always are on 16 bytes).
//
// Bits. Today's arithmetic, operation for operation, each result rounded
// as PyTorch's own elementwise kernel rounds it (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn, __fsub_rn: the compiler contracts nothing into an
// FMA), in the order of adamw_leaf_plain:
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + ((1 - b2) g) g
//   delta = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd p
//   p' = p - lr delta
// g and p widened to f32 first (exact), p' rounded to p's type last
// (__float2bfloat16_rn, round to nearest even, as torch's cast). The
// scalars come rounded to f32 from the caller, as torch rounds a Python
// scalar operand; bc1 = 1 - b1^t and bc2 = 1 - b2^t are the caller's 0-d
// f32 device tensors, read through their pointers, so the host never waits
// for the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_config.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // vectors of four elements a thread

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd;
};

// One element: p and g widened to f32; m and v updated in place.
__device__ __forceinline__ float step(float p, float g, float& m, float& v, float bc1,
                                      float bc2, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, h.omb2), g));
  const float mh = __fdiv_rn(m, bc1);
  const float vh = __fdiv_rn(v, bc2);
  const float delta = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps)),
                                __fmul_rn(p, h.wd));
  return __fsub_rn(p, __fmul_rn(delta, h.lr));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four elements of a tensor as one vector: a float4 of f32, an 8-byte word
// of bf16.
__device__ __forceinline__ float4 load4(const float* x, int64_t i) {
  return reinterpret_cast<const float4*>(x)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, int64_t i) {
  const uint2 w = reinterpret_cast<const uint2*>(x)[i];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* x, int64_t i, float4 v) {
  reinterpret_cast<float4*>(x)[i] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* x, int64_t i, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  reinterpret_cast<uint2*>(x)[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
}

// n elements; the first 4 nvec as vectors, the rest one by one.
template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const TP* __restrict__ p, const TG* __restrict__ g,
             const float* __restrict__ m, const float* __restrict__ v,
             const float* __restrict__ bc1p, const float* __restrict__ bc2p,
             TP* __restrict__ p_out, float* __restrict__ m_out, float* __restrict__ v_out,
             int64_t n, int64_t nvec, Hyper h) {
  constexpr int64_t kPerBlock = static_cast<int64_t>(kVecs) * kThreads;
  const float bc1 = *bc1p, bc2 = *bc2p;
  for (int64_t b0 = blockIdx.x * kPerBlock; b0 < nvec; b0 += gridDim.x * kPerBlock) {
    const int64_t i0 = b0 + threadIdx.x;
    float4 pv[kVecs], gv[kVecs], mv[kVecs], vv[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < nvec) {
        pv[u] = load4(p, i);
        gv[u] = load4(g, i);
        mv[u] = load4(m, i);
        vv[u] = load4(v, i);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < nvec) {
        float4 out;
        out.x = step(pv[u].x, gv[u].x, mv[u].x, vv[u].x, bc1, bc2, h);
        out.y = step(pv[u].y, gv[u].y, mv[u].y, vv[u].y, bc1, bc2, h);
        out.z = step(pv[u].z, gv[u].z, mv[u].z, vv[u].z, bc1, bc2, h);
        out.w = step(pv[u].w, gv[u].w, mv[u].w, vv[u].w, bc1, bc2, h);
        store4(p_out, i, out);
        store4(m_out, i, mv[u]);
        store4(v_out, i, vv[u]);
      }
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = 4 * nvec + blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n; i += threads) {
    float mi = m[i], vi = v[i];
    p_out[i] = narrow<TP>(step(widen(p[i]), widen(g[i]), mi, vi, bc1, bc2, h));
    m_out[i] = mi;
    v_out[i] = vi;
  }
}

// Blocks of the grid: one per kVecs * kThreads vectors of n elements (at
// least one), at most 2^31 - 1 (the loop strides over what that leaves).
unsigned int grid_blocks(int64_t n) {
  const int64_t per_block = static_cast<int64_t>(4) * kVecs * kThreads;
  const int64_t want = (n + per_block - 1) / per_block;
  return static_cast<unsigned int>(want < 0x7fffffff ? want : 0x7fffffff);
}

bool on(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename TP, typename TG>
int launch(const void* p, const void* g, const void* m, const void* v, const void* bc1,
           const void* bc2, void* p_out, void* m_out, void* v_out, int64_t n, Hyper h,
           void* stream) {
  // whole vectors where every pointer is on its vector's width
  const bool vec = on(p, 4 * sizeof(TP)) && on(p_out, 4 * sizeof(TP)) &&
                   on(g, 4 * sizeof(TG)) && on(m, 16) && on(v, 16) && on(m_out, 16) &&
                   on(v_out, 16);
  adamw_kernel<TP, TG><<<grid_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TP*>(p), static_cast<const TG*>(g), static_cast<const float*>(m),
      static_cast<const float*>(v), static_cast<const float*>(bc1),
      static_cast<const float*>(bc2), static_cast<TP*>(p_out), static_cast<float*>(m_out),
      static_cast<float*>(v_out), n, vec ? n / 4 : 0, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points. Each launches on the given stream, allocates
// nothing, and returns cudaGetLastError() of its launch.
extern "C" {

// One leaf of n > 0 elements: p and p_out in p's type (bf16 if p_bf16, else
// f32), g in g's (g_bf16), m, v, m_out, v_out f32, bc1 and bc2 one f32 each
// on the device. The scalars: lr, b1, 1 - b1, b2, 1 - b2, eps, weight decay.
int adamw_leaf(const void* p, const void* g, const void* m, const void* v, const void* bc1,
               const void* bc2, void* p_out, void* m_out, void* v_out, int64_t n,
               int p_bf16, int g_bf16, float lr, float b1, float omb1, float b2,
               float omb2, float eps, float wd, void* stream) {
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd};
  if (p_bf16 && g_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, bc1, bc2, p_out, m_out, v_out,
                                                n, h, stream);
  if (p_bf16)
    return launch<__nv_bfloat16, float>(p, g, m, v, bc1, bc2, p_out, m_out, v_out, n, h,
                                        stream);
  if (g_bf16)
    return launch<float, __nv_bfloat16>(p, g, m, v, bc1, bc2, p_out, m_out, v_out, n, h,
                                        stream);
  return launch<float, float>(p, g, m, v, bc1, bc2, p_out, m_out, v_out, n, h, stream);
}

// The resources of instantiation `which` (see launch_resources()): 0
// adamw_kernel<float, float>, 1 <float, bf16>, 2 <bf16, float>, 3 <bf16,
// bf16>, the parameter's type first. None takes dynamic shared memory.
int adamw_launch_config(int which, void* out) {
  int* o = static_cast<int*>(out);
  switch (which) {
    case 0: return launch_resources(adamw_kernel<float, float>, kThreads, 0, o);
    case 1: return launch_resources(adamw_kernel<float, __nv_bfloat16>, kThreads, 0, o);
    case 2: return launch_resources(adamw_kernel<__nv_bfloat16, float>, kThreads, 0, o);
    case 3: return launch_resources(adamw_kernel<__nv_bfloat16, __nv_bfloat16>, kThreads, 0, o);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
