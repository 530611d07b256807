// Flash attention for Hopper (sm_90a), forward and backward, bound to Python
// with ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention.py (pallas_call at :105), which is
// forward only; the three backward kernels are new, so that the dense LM can
// train through the forward:
//   flash_attention_fwd              F1  O and the row log-sum-exp m + log l
//   flash_attention_bwd_preprocess   F2  delta = rowsum(dO * O)
//   flash_attention_bwd_dkdv         F3  dK, dV
//   flash_attention_bwd_dq           F4  dQ
// Layout (B, S, H, D) for q, k, v, O, dO and the gradients, contiguous; lse
// and delta (B, Hq, S) f32. Inputs f32 or bf16 (all of one dtype), outputs
// in that dtype, all arithmetic in f32. head_dim 32, 64, 80 or 128: the dims
// of the registered dense configs. GQA reads k/v at head hq / (Hq / Hkv), as
// the Pallas index map does (:112-115): no repeated k/v is ever formed.
//
// What it computes, as B4 does: s = (f32(q) * scale) . f32(k), scale =
// 1/sqrt(D); s = -1e30 where the key is masked (kpos >= Skv, kpos > qpos when
// causal, qpos - kpos >= window); over kv tiles in order the online softmax
// m' = max(m, rowmax s), p = exp(s - m'), corr = exp(m - m'), l = l*corr +
// rowsum p, acc = acc*corr + p.v; O = acc / max(l, 1e-30). The backward
// recomputes P = exp(S - lse) (0 where masked: exp(-1e30 - lse) is 0) and
// forms dV = P^T dO, dP = dO V^T, dS = P * (dP - delta), dQ = scale * dS K,
// dK = dS^T (scale * q).
//
// Skipped tiles. A kv tile that lies wholly above the diagonal (causal) or
// wholly before the window of every row of a q tile is not visited. The
// result is B4's, bit for bit as far as the online softmax goes: in B4 such a
// tile either comes after a visible key, where p = exp(-1e30 - m) = 0 and
// corr = 1, or before one, where the visible key's corr = exp(-1e30 - m) = 0
// wipes what it added to l and acc. This needs every query row to see at
// least one key, which fails only for Sq > Skv + window - 1; the wrapper
// refuses that case. The backward skips the same (q tile, kv tile) pairs,
// whose P is all 0.
//
// Design. One thread block of 256 threads (16 x 16) per output tile of 64
// rows: F1 and F4 per (q tile, q head, batch), F3 per (kv tile, kv head,
// batch). Tiles of 64 rows of q, k, v and dO are staged in shared memory as
// f32 with a row stride of D + 1 (odd: the column reads of 16 rows hit 16
// banks); each thread holds 4 rows x 4 columns of a 64 x 64 score tile and 4
// rows x D/16 columns of its output rows in registers, and a row's max and
// sum are reduced over the 16 lanes that share it with shuffles. The
// probabilities (and dS) go through shared memory to the second product.
// F3 loops over the group's q heads and the q tiles that can see its kv tile
// and accumulates dK and dV in registers: no atomics, so every run gives the
// same bits. Plain f32 FMAs, no tensor cores (TF32 would change numbers the
// tests hold); expf and logf, never the fast intrinsics.
//
// Bound: operations. Per visible (q, k) pair the forward does 4*D flops (two
// products), F3 8*D (scores, dP, dV, dK) and F4 6*D (scores, dP, dQ), against
// about 4 bytes a row element moved: at the main path's shapes (S = 1024,
// D = 128) the products' flops over the card's 67 TFLOP/s f32 rate exceed
// the bytes over 3.35 TB/s by eight times or more. F2 is bound by its bytes.
// Shared memory per block at D = 128: F1 115,712 bytes, F3 165,888, F4
// 148,736, all above the 48 KiB default (cudaFuncSetAttribute below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // B4's NEG_INF, not -inf
constexpr int kTile = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kRows = kTile / 16;  // tile rows per thread
constexpr int kCols = kTile / 16;  // score columns per thread
constexpr int kPStride = kTile + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Dims {
  int batch, sq, skv, hq, hkv, causal, window;  // window <= 0: no window
  float scale;
};

// Offset of element (b, s, h, 0) of a contiguous (B, S, H, D) tensor.
template <int D>
__device__ __forceinline__ int64_t row_offset(int b, int s, int h, int S, int H) {
  return ((static_cast<int64_t>(b) * S + s) * H + h) * D;
}

// Rows [row0, row0 + kTile) of head h of a (B, S, H, D) tensor into shared
// memory (stride D + 1), each times mul, zero past row S - 1 (B4's padding).
template <int D, typename T>
__device__ void load_tile(float* dst, const T* src, int b, int row0, int S,
                          int h, int H, float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int s = row0 + r;
    float x = 0.f;
    if (s < S) x = to_f32(src[row_offset<D>(b, s, h, S, H) + c]) * mul;
    dst[r * (D + 1) + c] = x;
  }
}

// Per-row values (lse or delta, layout (B, H, S)) of rows [row0, row0+kTile).
__device__ void load_rowvals(float* dst, const float* src, int b, int h, int row0,
                             int S, int H) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int s = row0 + i;
    dst[i] = s < S ? src[(static_cast<int64_t>(b) * H + h) * S + s] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, const Dims& d) {
  return kpos < d.skv && (!d.causal || qpos >= kpos) &&
         (d.window <= 0 || qpos - kpos < d.window);
}

// Max and sum over the 16 lanes of a half warp (the threads sharing a row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The kv tiles [lo, hi) that hold a key visible to some real row of the q
// tile starting at q0.
__device__ __forceinline__ void kv_tile_range(int q0, const Dims& d, int* lo, int* hi) {
  const int nk = (d.skv + kTile - 1) / kTile;
  const int q_last = min(q0 + kTile, d.sq) - 1;
  *lo = d.window > 0 ? max(0, q0 - d.window + 1) / kTile : 0;
  *hi = d.causal ? min(nk, q_last / kTile + 1) : nk;
}

// acc[i][j] += sum_c a[row i][c] * b[col j][c] over c < D, with row i of the
// thread at tile row ty*kRows + i and col j at tile row tx + 16*j of b.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[kRows][kCols], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int P = D + 1;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float x[kRows], y[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) x[i] = a[(ty * kRows + i) * P + c];
#pragma unroll
    for (int j = 0; j < kCols; ++j) y[j] = b[(tx + 16 * j) * P + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// out[i][c] += sum_r w[row i][r] * m[r][col c] over the kTile rows r of m,
// with w (kTile x kTile, stride kPStride) and out columns tx + 16*c.
template <int D>
__device__ __forceinline__ void tile_apply(float (&out)[kRows][D / 16], const float* w,
                                           const float* m, int ty, int tx) {
  constexpr int P = D + 1;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float x[kRows], y[D / 16];
#pragma unroll
    for (int i = 0; i < kRows; ++i) x[i] = w[(ty * kRows + i) * kPStride + r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) y[c] = m[r * P + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) out[i][c] = fmaf(x[i], y[c], out[i][c]);
  }
}

// F1: grid (q tiles, Hq, B).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, Dims d) {
  constexpr int P = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * P;
  float* vs = ks + kTile * P;
  float* ps = vs + kTile * P;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (d.hq / d.hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(qs, q, b, q0, d.sq, h, d.hq, d.scale);
  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  int lo, hi;
  kv_tile_range(q0, d, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    load_tile<D>(ks, k, b, k0, d.skv, hk, d.hkv, 1.f);
    load_tile<D>(vs, v, b, k0, d.skv, hk, d.hkv, 1.f);
    __syncthreads();
    float s[kRows][kCols] = {};
    tile_dot<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (!visible(qpos, k0 + tx + 16 * j, d)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * kRows + i) * kPStride + tx + 16 * j] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();
    tile_apply<D>(acc, ps, vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= d.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + row_offset<D>(b, qpos, h, d.sq, d.hq);
#pragma unroll
    for (int c = 0; c < DC; ++c) put(orow + tx + 16 * c, acc[i][c] / den);
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * d.hq + h) * d.sq + qpos] = m[i] + logf(l[i]);
  }
}

// F2: delta[b, h, s] = sum_c dO[b, s, h, c] * O[b, s, h, c]; a warp per row.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int batch, int sq, int hq) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(batch) * sq * hq) return;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32)
    sum = fmaf(to_f32(dout[row * D + c]), to_f32(o[row * D + c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {  // row = (b * sq + s) * hq + h
    const int h = static_cast<int>(row % hq);
    const int64_t bs = row / hq;
    const int s = static_cast<int>(bs % sq);
    const int64_t b = bs / sq;
    delta[(b * hq + h) * sq + s] = sum;
  }
}

// F3: grid (kv tiles, Hkv, B). Thread rows are kv rows, score columns q rows.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                Dims d) {
  constexpr int P = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * P;
  float* qs = vs + kTile * P;
  float* dos = qs + kTile * P;
  float* pts = dos + kTile * P;          // P^T tile
  float* dsts = pts + kTile * kPStride;  // dS^T tile
  float* lses = dsts + kTile * kPStride;
  float* deltas = lses + kTile;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = d.hq / d.hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(ks, k, b, k0, d.skv, hk, d.hkv, 1.f);
  load_tile<D>(vs, v, b, k0, d.skv, hk, d.hkv, 1.f);
  float dkr[kRows][DC], dvr[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dkr[i][c] = dvr[i][c] = 0.f;

  // the q tiles with a row that sees a key of this tile
  const int nq = (d.sq + kTile - 1) / kTile;
  const int k_last = min(k0 + kTile, d.skv) - 1;
  const int iq_lo = d.causal ? k0 / kTile : 0;
  const int iq_hi = d.window > 0 ? min(nq, (k_last + d.window - 1) / kTile + 1) : nq;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int iq = iq_lo; iq < iq_hi; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();  // the previous q tile's reads are done
      load_tile<D>(qs, q, b, q0, d.sq, h, d.hq, d.scale);
      load_tile<D>(dos, dout, b, q0, d.sq, h, d.hq, 1.f);
      load_rowvals(lses, lse, b, h, q0, d.sq, d.hq);
      load_rowvals(deltas, delta, b, h, q0, d.sq, d.hq);
      __syncthreads();
      float st[kRows][kCols] = {}, dpt[kRows][kCols] = {};
      tile_dot<D>(st, ks, qs, ty, tx);
      tile_dot<D>(dpt, vs, dos, ty, tx);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kpos = k0 + ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + 16 * j, qpos = q0 + col;
          const bool vis = qpos < d.sq && visible(qpos, kpos, d);
          const float p = vis ? expf(st[i][j] - lses[col]) : 0.f;
          pts[(ty * kRows + i) * kPStride + col] = p;
          dsts[(ty * kRows + i) * kPStride + col] = p * (dpt[i][j] - deltas[col]);
        }
      }
      __syncthreads();
      tile_apply<D>(dvr, pts, dos, ty, tx);
      tile_apply<D>(dkr, dsts, qs, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kpos = k0 + ty * kRows + i;
    if (kpos >= d.skv) continue;
    const int64_t off = row_offset<D>(b, kpos, hk, d.skv, d.hkv);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      put(dk + off + tx + 16 * c, dkr[i][c]);
      put(dv + off + tx + 16 * c, dvr[i][c]);
    }
  }
}

// F4: grid (q tiles, Hq, B). Thread rows are q rows, score columns kv rows.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, Dims d) {
  constexpr int P = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * P;
  float* ks = dos + kTile * P;
  float* vs = ks + kTile * P;
  float* dss = vs + kTile * P;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (d.hq / d.hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(qs, q, b, q0, d.sq, h, d.hq, d.scale);
  load_tile<D>(dos, dout, b, q0, d.sq, h, d.hq, 1.f);
  float lse_r[kRows], delta_r[kRows], dqr[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    const int64_t at = (static_cast<int64_t>(b) * d.hq + h) * d.sq + qpos;
    lse_r[i] = qpos < d.sq ? lse[at] : 0.f;
    delta_r[i] = qpos < d.sq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dqr[i][c] = 0.f;
  }
  int lo, hi;
  kv_tile_range(q0, d, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(ks, k, b, k0, d.skv, hk, d.hkv, 1.f);
    load_tile<D>(vs, v, b, k0, d.skv, hk, d.hkv, 1.f);
    __syncthreads();
    float s[kRows][kCols] = {}, dp[kRows][kCols] = {};
    tile_dot<D>(s, qs, ks, ty, tx);
    tile_dot<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool vis = qpos < d.sq && visible(qpos, k0 + tx + 16 * j, d);
        const float p = vis ? expf(s[i][j] - lse_r[i]) : 0.f;
        dss[(ty * kRows + i) * kPStride + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_apply<D>(dqr, dss, ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= d.sq) continue;
    T* row = dq + row_offset<D>(b, qpos, h, d.sq, d.hq);
#pragma unroll
    for (int c = 0; c < DC; ++c) put(row + tx + 16 * c, dqr[i][c] * d.scale);
  }
}

template <int D>
constexpr size_t fwd_smem() { return (3 * kTile * (D + 1) + kTile * kPStride) * sizeof(float); }
template <int D>
constexpr size_t dkdv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kPStride + 2 * kTile) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() { return (4 * kTile * (D + 1) + kTile * kPStride) * sizeof(float); }

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }
inline int tiles(int n) { return (n + kTile - 1) / kTile; }

// Launch `kernel` with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, as_stream(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, Dims d,
        void* stream) {
  return launch(fwd_kernel<D, T>, dim3(tiles(d.sq), d.hq, d.batch), fwd_smem<D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse), d);
}

template <int D, typename T>
int preprocess(const void* o, const void* dout, void* delta, int batch, int sq, int hq,
               void* stream) {
  const int64_t rows = static_cast<int64_t>(batch) * sq * hq;
  const int warps = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>((rows + warps - 1) / warps);
  bwd_preprocess_kernel<D, T><<<blocks, kThreads, 0, as_stream(stream)>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta),
      batch, sq, hq);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
         const void* delta, void* dk, void* dv, Dims d, void* stream) {
  return launch(bwd_dkdv_kernel<D, T>, dim3(tiles(d.skv), d.hkv, d.batch), dkdv_smem<D>(),
                stream, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), d);
}

template <int D, typename T>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* delta, void* dqp, Dims d, void* stream) {
  return launch(bwd_dq_kernel<D, T>, dim3(tiles(d.sq), d.hq, d.batch), dq_smem<D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dqp), d);
}

// Call F<D, T>::run(args...) for the runtime head_dim and dtype; an
// unsupported head_dim is cudaErrorInvalidValue.
#define DISPATCH(head_dim, bf16, FN, ...)                                        \
  do {                                                                           \
    switch (head_dim) {                                                          \
      case 32: return bf16 ? FN<32, __nv_bfloat16>(__VA_ARGS__) : FN<32, float>(__VA_ARGS__);   \
      case 64: return bf16 ? FN<64, __nv_bfloat16>(__VA_ARGS__) : FN<64, float>(__VA_ARGS__);   \
      case 80: return bf16 ? FN<80, __nv_bfloat16>(__VA_ARGS__) : FN<80, float>(__VA_ARGS__);   \
      case 128: return bf16 ? FN<128, __nv_bfloat16>(__VA_ARGS__) : FN<128, float>(__VA_ARGS__); \
      default: return static_cast<int>(cudaErrorInvalidValue);                   \
    }                                                                            \
  } while (0)

Dims make_dims(int batch, int sq, int skv, int hq, int hkv, int causal, int window,
               float scale) {
  Dims d;
  d.batch = batch;
  d.sq = sq;
  d.skv = skv;
  d.hq = hq;
  d.hkv = hkv;
  d.causal = causal;
  d.window = window;
  d.scale = scale;
  return d;
}

}  // namespace

extern "C" {

int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int batch, int sq, int skv, int hq, int hkv, int head_dim,
                        int causal, int window, float scale, int bf16, void* stream) {
  const Dims d = make_dims(batch, sq, skv, hq, hkv, causal, window, scale);
  DISPATCH(head_dim, bf16, fwd, q, k, v, o, lse, d, stream);
}

int flash_attention_bwd_preprocess(const void* o, const void* dout, void* delta, int batch,
                                   int sq, int hq, int head_dim, int bf16, void* stream) {
  DISPATCH(head_dim, bf16, preprocess, o, dout, delta, batch, sq, hq, stream);
}

int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             int batch, int sq, int skv, int hq, int hkv, int head_dim,
                             int causal, int window, float scale, int bf16, void* stream) {
  const Dims d = make_dims(batch, sq, skv, hq, hkv, causal, window, scale);
  DISPATCH(head_dim, bf16, dkdv, q, k, v, dout, lse, delta, dk, dv, d, stream);
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dqp, int batch, int sq,
                           int skv, int hq, int hkv, int head_dim, int causal, int window,
                           float scale, int bf16, void* stream) {
  const Dims d = make_dims(batch, sq, skv, hq, hkv, causal, window, scale);
  DISPATCH(head_dim, bf16, dq, q, k, v, dout, lse, delta, dqp, d, stream);
}

}  // extern "C"
