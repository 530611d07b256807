// RWKV6's chunked WKV recurrence for Hopper (sm_90a), forward and backward,
// bound to Python with ctypes by repro_torch/kernels/rwkv6_wkv.py.
//
// Replaces the Pallas TPU kernel wkv6_pallas of
// src/repro/kernels/rwkv6_wkv.py (pallas_call at :76), which is forward
// only; the backward is new, so that Rwkv6LM can train through the
// forward:
//   wkv6_fwd   W1  y, the state at the start of every chunk, and the final
//                  state, from an initial state (or zeros)
//   wkv6_bwd   W2  dr, dk, dv, dlogw and du, from the final state's gradient
//                  (or zeros), and the initial state's gradient
// Layout (B, S, H, P) for r, k, v, logw, y, dy and the four gradients,
// contiguous; u and du (H, P) f32; states (B, H, chunks, P, P) f32; the
// initial and final states and their gradients (B, H, P, P) f32; r, k, v,
// logw, dy, the states and their gradients on 16 bytes. r, k, v, logw, dy f32 or bf16 (all of
// one dtype), y in that dtype, gradients f32, all arithmetic in f32. P
// (head_dim) 32 or 64: the reduced and the full rwkv6-7b. The scratch
// (exp(cum_L) of every chunk, W2's dS and du partials) is the caller's:
// these functions allocate nothing.
//
// What it computes, as B8 does, per chunk of L = min(32, S) steps (rows past
// S read as zeros, which leaves cum flat over the pad): cum = cumsum(logw)
// down the chunk, cumprev = cum - logw, A_tj = sum_p r_tp k_jp
// exp(cumprev_tp - cum_jp) for j < t (0 elsewhere), y = A v + bonus v +
// (r exp(cumprev)) S with bonus_t = sum_p r u k; then S <- exp(cum_L) S +
// (k exp(cum_L - cum))^T v, exp(cum_L) scaling S's rows. The backward
// carries dS, the gradient of the state after a chunk, back over the
// chunks; with dA = dy v^T below the diagonal:
//   dr_dec = sum_j dA_tj k_j exp(cumprev_t - cum_j) + exp(cumprev_t) (dy S^T)_t
//   dr     = dr_dec + dbonus u k                     (dbonus_t = dy_t . v_t)
//   dk     = sum_t dA_tj r_t exp(cumprev_t - cum_j) + exp(cum_L - cum_j)(v dS^T)_j
//            + dbonus u r
//   dv     = A^T dy + bonus dy + (k exp(cum_L - cum)) dS
//   dlogw  = reverse cumsum of dcum, minus dcumprev, where dcumprev = r dr_dec,
//            dcum = dcumprev - k (the two dk terms) + [t = L-1] dcum_L and
//            dcum_L = sum_j k dk_tail + exp(cum_L) sum_q S dS
//   du     = sum over the batch and the chunks of sum_t dbonus r k
//   dS    <- exp(cum_L) dS + (r exp(cumprev))^T dy
// The carry starts from the initial state S_0 (the reference's
// wkv6_chunked(initial_state=)), and dS from the final state's gradient; a
// null pointer for either is zeros, today's arithmetic. The final state is
// exp(cum_L) S + the last chunk's summary, and the initial state's gradient
// exp(cum_L) dS + the first chunk's (r exp(cumprev))^T dy: the pass takes one
// step more, past the edge. S_0 reaches every other term as states[0].
//
// The pairs' decay is referred to the chunk's middle row. With m the cum of
// row 15 (row ceil(L/2) - 1 of a chunk of L < 32), r' = r exp(cumprev - m)
// and k' = k exp(m - cum):
//   A        = r' k'^T below the diagonal           r exp(cumprev) S = r' (exp(m) S)
//   dr_dec   = exp(cumprev - m) (dA k' + dy (exp(m) S)^T)
//   dk_boost = exp(m - cum) (dA^T r'),  dk_tail = exp(m - cum) (v dS''^T)
//   k_tail dS = k' dS''
// where dS'' = exp(cum_L - m) dS, each exp(.) of a P-vector scaling rows.
// Every exponent is then within (L/2) 2.5 = 40 of 0 (the model clamps logw
// at -2.5): the operands stay within e^40 of |r| and |k| and never come
// near f32's subnormals, where the tensor cores would flush them (referred
// to row 0, as B8 forms A, k exp(-cum) reaches e^80 and r exp(cumprev)
// e^-77.5, and their lo halves are subnormal). The masked pairs (j >= t)
// still reach r k e^80: they are dropped by a select, never multiplied by 0.
// cum is a sequential f32 sum down each column, as the plain version's
// cumsum: a scan that rounds in another order moved B9's y by 0.68 of its
// limit.
//
// Design: a chunk-parallel scan, each stage a grid over (chunk, batch row,
// head), as B9's kernels (ssd_scan.cu) are split:
//   W1  1. chunk_sum_kernel: each chunk's summary (k exp(cum_L - cum))^T v,
//          an (P x L)(L x P) product, into the states slot of the next
//          chunk (the last chunk's into the final state), and exp(cum_L)
//          into el;
//       2. pass_kernel: states[0] = S_0, states[c] = el[c-1] states[c-1] +
//          states[c] (el scaling rows), in place, a float4 a thread walking
//          the chunks, and the final state el[nc-1] states[nc-1] + its
//          summary;
//       3. fwd_out_kernel: A, then y = A v + bonus v + r' (exp(m) S).
//   W2  1. chunk_sum_kernel: (r exp(cumprev))^T dy into the dS slot of the
//          chunk before (the first chunk's into the initial state's
//          gradient), and el;
//       2. pass_kernel in reverse: dS[nc-1] = the final state's gradient,
//          dS[c] = el[c+1] dS[c+1] + dS[c], and the initial state's gradient
//          el[0] dS[0] + its chunk sum;
//       3. bwd_chunk_kernel: every chunk-local term from states[c] and
//          dS[c]: A and dA again, dr, dk, dv, dlogw (the column sums and the
//          in-chunk reverse cumulative sum on f32 FMAs, in order), and du's
//          partial of (batch row, head, chunk);
//       4. du_finish_kernel: du summed over the batch and the chunks in a
//          fixed order.
// At the main shape (B 2, S 1024, H 64, P 64) each stage runs 4,096 blocks
// (one head a block), against 128 blocks that each walked 32
// chunks in order before. A block's tiles are copied all at once (cp.async;
// bf16 through registers), in two groups in stage 3: the states (and dS)
// arrive while cum runs down the columns and A is formed. Every product is
// mma.sync m16n8k8 with TF32
// operands in three terms, as in flash_attention.cu and ssd_scan.cu: each
// f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi) (two
// integer operations), lo.hi and hi.lo go into the accumulator before
// hi.hi; a bf16 input (v, dy) is exact in TF32 and its lo terms are
// skipped. The tensor cores add with truncation, so each 16 of a product's
// k go to a fresh accumulator, added in f32, and each product has its own
// accumulator. A warp owns 16 rows of the chunk (warps w and w + 4, which
// share a scheduler, the two halves, so that the triangular products share
// out evenly) and a quarter of the columns; a P x P summary a warp 16 rows
// and 32 (P 64) or 8 (P 32) columns. Operands are read from shared memory
// as f32 (bf16 widened when staged), each tile with a row stride of width +
// 4 or + 8 after its commonest fragment read. No atomics: every run gives
// the same bits.
//
// Bound: bytes. At the main shape (f32) W1 moves 235 MB (four inputs read
// once, y and the 67 MB of chunk states written once), 0.070 ms at 3.35
// TB/s, against about 786k flops a chunk (the L x L and L x P products
// counted in full), 3.2 GFLOP in all: 0.048 ms at 67 TFLOP/s, 0.0195 ms as
// three TF32 products at 495 TFLOP/s; W2 moves 369 MB (0.110 ms) for 7.0
// GFLOP (0.104 ms; 0.042 ms on the tensor cores). The scan's own traffic is
// larger: stage 1 reads three inputs and writes the summaries, the pass
// reads and writes them again, stage 3 reads every input and the states
// (W1 537 MB in all, 0.160 ms; W2 738 MB, 0.220 ms). Stages 1 and 2 run
// near the memory rate; stage 3 is bound by its instructions (without its
// tile loads it still takes 80-85% of its time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_config.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kL = 32;         // B8's chunk: the rows of every chunk tile

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Dims {
  int batch, seq, heads, chunk, nc, mid;  // mid: m's row
};

// ---------------------------------------------------------------------------
// split TF32 on the tensor cores (flash_attention.cu's form)
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as f32 bits:
// cvt.rna.tf32.f32's rounding in two integer operations.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t hi, lo;
};
template <bool kExact>
__device__ __forceinline__ Split operand(float x) {
  if (kExact) return {__float_as_uint(x), 0u};
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

// c += a . b on one 16 x 8 x 8 tile.
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a . b in split TF32: a.lo b.hi and a.hi b.lo first, then a.hi b.hi.
// The lo terms of an exact operand are 0 and skipped.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[4], const Split (&a)[4], const Split (&b)[2]) {
  if (!kExactA) mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  if (!kExactB) mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// c[n] += A . B over k in [k0, k1) (multiples of 16) on the warp's tile of
// 16 rows and the column tiles n < n_hi of 8 (of NT): a(r, k) is A at the
// warp's row r (0..15), b(k, j) is B at the warp's column j (0..8 NT - 1),
// read where the mma's fragments want them (lane 4g + t: A rows g and g + 8,
// k columns t and t + 4; B k rows t and t + 4, column g). Each 16 of k go to
// a fresh accumulator, added to c in f32.
template <int NT, bool kExactA, bool kExactB, typename FA, typename FB>
__device__ __forceinline__ void mma_tile(float (&c)[NT][4], int k0, int k1, int n_hi, FA a,
                                         FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int kb = k0; kb < k1; kb += 16) {
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = kb + 8 * s;
      const Split af[4] = {operand<kExactA>(a(g, k + t)), operand<kExactA>(a(g + 8, k + t)),
                           operand<kExactA>(a(g, k + t + 4)),
                           operand<kExactA>(a(g + 8, k + t + 4))};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < n_hi) {
          const Split bf[2] = {operand<kExactB>(b(k + t, 8 * n + g)),
                               operand<kExactB>(b(k + t + 4, 8 * n + g))};
          mma3<kExactA, kExactB>(part[n], af, bf);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += part[n][e];
  }
}

// Store a warp's 16 x 8NT accumulators to rows (row0 + g, + 8) and columns
// col0 + 8n + 2t of a row-major f32 matrix with row pitch `pitch`.
template <int NT>
__device__ __forceinline__ void store_tile(float* dst, int64_t pitch, const float (&c)[NT][4],
                                           int row0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      put2(dst + r * pitch + col0 + 8 * n + 2 * t, c[n][2 * half], c[n][2 * half + 1]);
  }
}

// The warp's 8-column tile of an L x L product (A, dA) below the diagonal:
// masked pairs (j >= t) by a select, into `dst` (row stride SD).
template <int SD>
__device__ __forceinline__ void store_lower(float* dst, const float (&c)[1][4], int row0,
                                            int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row0 + g + 8 * (e >> 1), j = col0 + 2 * t + (e & 1);
    dst[r * SD + j] = j < r ? c[0][e] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Asynchronous copies to shared memory (f32): `full` false fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0) : "memory");
}
// Close the group of copies this thread issued since the last one.
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// Wait until at most N of this thread's groups are still in flight; the
// block's barrier comes after.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// N rows of W values into shared memory as f32, row stride SD: row r from
// src + r * pitch where r < rows, zeros past. Every copy of the tile is in
// flight at once: f32 by cp.async (complete after its group's cp_wait),
// bf16 through registers, widened, all its loads issued before its stores.
template <int W, int SD, int N = kL>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int64_t pitch,
                                      int rows) {
  constexpr int Q = W / 4;
  static_assert(N * Q % kThreads == 0, "a tile is whole float4s a thread");
#pragma unroll
  for (int it = 0; it < N * Q / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / Q, c = 4 * (i - r * Q);
    cp_async16(dst + r * SD + c, src + (r < rows ? r * pitch + c : 0), r < rows);
  }
}
template <int W, int SD, int N = kL>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* __restrict__ src,
                                      int64_t pitch, int rows) {
  constexpr int Q = W / 4, K = N * Q / kThreads;
  static_assert(N * Q % kThreads == 0, "a tile is whole float4s a thread");
  float4 v[K];
#pragma unroll
  for (int it = 0; it < K; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / Q, c = 4 * (i - r * Q);
    v[it] = r < rows ? load4(src + r * pitch + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int it = 0; it < K; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / Q, c = 4 * (i - r * Q);
    *reinterpret_cast<float4*>(dst + r * SD + c) = v[it];
  }
}

// ---------------------------------------------------------------------------
// stage 1 (W1 and W2): chunk summaries and exp(cum_L)
// ---------------------------------------------------------------------------

// Grid (chunk, batch row, head). W1 (kBwd false), for every chunk but the
// last: (k exp(cum_L - cum))^T v into states[b, h, c + 1] and el[b, h, c] =
// exp(cum_L); W2, for every chunk but the first: (r exp(cumprev))^T dy into
// dS[b, h, c - 1] and el[b, h, c]. The edge chunk (W1's last, W2's first)
// does the same into edge[b, h] where edge is given, and nothing where it is
// not. `x` is k (W1) or r (W2), `y` v or dy.
template <int P, typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    chunk_sum_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ lw,
                     float* __restrict__ out, float* __restrict__ edge, float* __restrict__ el,
                     Dims d) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int SD = P + 8;
  __shared__ __align__(16) float sx[kL * SD];
  __shared__ __align__(16) float sy[kL * SD];
  __shared__ __align__(16) float sw[kL * SD];  // logw, then cum (W1) or cumprev (W2)
  __shared__ float slast[P];                   // cum_L
  const int c = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const bool at_edge = kBwd ? c == 0 : c + 1 == d.nc;  // no slot: the edge's
  if (at_edge && edge == nullptr) return;
  const int t0 = c * d.chunk, rows = min(d.chunk, d.seq - t0);
  const int64_t pitch = static_cast<int64_t>(d.heads) * P;
  const int64_t at = ((static_cast<int64_t>(b) * d.seq + t0) * d.heads + h) * P;  // (b, t0, h, 0)
  const int64_t bh = static_cast<int64_t>(b) * d.heads + h;
  stage<P, SD>(sx, x + at, pitch, rows);
  stage<P, SD>(sy, y + at, pitch, rows);
  stage<P, SD>(sw, lw + at, pitch, rows);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  if (threadIdx.x < P) {
    const int p = threadIdx.x;
    float w[kL];
#pragma unroll
    for (int t = 0; t < kL; ++t) w[t] = sw[t * SD + p];
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      acc += w[t];
      sw[t * SD + p] = kBwd ? acc - w[t] : acc;
    }
    slast[p] = acc;
    el[(bh * d.nc + c) * P + p] = expf(acc);
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.x; i < kL * P; i += kThreads) {
    const int at_s = (i / P) * SD + i % P;
    sx[at_s] *= kBwd ? expf(sw[at_s]) : expf(slast[i % P] - sw[at_s]);
  }
  __syncthreads();
  // out = sx^T sy, P x P over the chunk's rows
  constexpr int kPerSlice = kWarps / (P / 16), NT = P / 8 / kPerSlice;
  const int warp = threadIdx.x >> 5;
  const int row0 = 16 * (warp / kPerSlice), col0 = (warp % kPerSlice) * 8 * NT;
  float acc[NT][4] = {};
  mma_tile<NT, false, kExact>(
      acc, 0, kL, NT, [&](int r, int k) { return sx[k * SD + row0 + r]; },
      [&](int k, int j) { return sy[k * SD + col0 + j]; });
  store_tile<NT>(at_edge ? edge + bh * P * P : out + (bh * d.nc + (kBwd ? c - 1 : c + 1)) * P * P,
                 P, acc, row0, col0);
}

// ---------------------------------------------------------------------------
// stage 2: the carried states (W1) or dS (W2), in place
// ---------------------------------------------------------------------------

// Grid (batch row x head, float4s of a slot / kThreads). Slot c holds the
// summary of chunk c - 1 (W1) or c + 1 (W2); a thread walks its float4 (four
// columns of one row p) over the chunks: W1 s[0] = seed, s[c] = el[c-1, p]
// s[c-1] + s[c] upward; W2 s[nc-1] = seed, s[c] = el[c+1, p] s[c+1] + s[c]
// downward; a null seed is zeros. Four chunks' loads are issued before their
// updates. Where edge is given, one step more: edge = el[nc-1, p] s[nc-1] +
// edge (W1, the final state) or el[0, p] s[0] + edge (W2, the initial
// state's gradient).
template <int P, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    pass_kernel(float* __restrict__ s, const float* __restrict__ el,
                const float* __restrict__ seed, float* __restrict__ edge, int nc) {
  constexpr int Q = P * P / 4;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= Q) return;
  const int64_t bh = blockIdx.x;
  float4* base = reinterpret_cast<float4*>(s + bh * nc * P * P) + i;
  const float* e = el + bh * nc * P + (4 * i) / P;
  float4 prev = make_float4(0.f, 0.f, 0.f, 0.f);
  if (seed != nullptr) prev = reinterpret_cast<const float4*>(seed + bh * P * P)[i];
  base[static_cast<int64_t>(kBwd ? nc - 1 : 0) * Q] = prev;
  for (int step = 1; step < nc; step += 4) {
    float4 sum[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = kBwd ? nc - 1 - (step + k) : step + k;
      if (step + k < nc) sum[k] = base[static_cast<int64_t>(c) * Q];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (step + k >= nc) break;
      const int c = kBwd ? nc - 1 - (step + k) : step + k;
      const float f = e[(kBwd ? c + 1 : c - 1) * P];
      prev = make_float4(f * prev.x + sum[k].x, f * prev.y + sum[k].y, f * prev.z + sum[k].z,
                         f * prev.w + sum[k].w);
      base[static_cast<int64_t>(c) * Q] = prev;
    }
  }
  if (edge != nullptr) {
    float4* out = reinterpret_cast<float4*>(edge + bh * P * P) + i;
    const float4 sum = *out;
    const float f = e[(kBwd ? 0 : nc - 1) * P];
    *out = make_float4(f * prev.x + sum.x, f * prev.y + sum.y, f * prev.z + sum.z,
                       f * prev.w + sum.w);
  }
}

// ---------------------------------------------------------------------------
// what stage 3 of W1 and W2 share
// ---------------------------------------------------------------------------

// By thread p < P: cum = cumsum(logw) down column p in order (logw staged in
// `cum`, row stride SD), in place, and cumprev = cum - logw into `cp`;
// m = cum of row `mid` into sm, exp(m) into sem, and exp(cum_L - m) and
// exp(cum_L) into selm and sel where given.
template <int SD>
__device__ __forceinline__ void column_scan(float* cum, float* cp, float* sm, float* sem,
                                            float* selm, float* sel, int p, int mid) {
  float w[kL];
#pragma unroll
  for (int t = 0; t < kL; ++t) w[t] = cum[t * SD + p];
  float acc = 0.f, m = 0.f;
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    acc += w[t];
    cum[t * SD + p] = acc;
    cp[t * SD + p] = acc - w[t];
    if (t == mid) m = acc;
  }
  sm[p] = m;
  sem[p] = expf(m);
  if (selm != nullptr) {
    selm[p] = expf(acc - m);
    sel[p] = expf(acc);
  }
}

// By thread t < kL: sum_p a_tp u_p b_tp, each term (a u) b as the plain
// version's bonus (a = r, b = k), p from t on, round the row (the 32 rows'
// reads then fall in 32 banks); u null gives sum_p a_tp b_tp (dbonus).
template <int P, int SD>
__device__ __forceinline__ float row_dot(const float* a, const float* u, const float* b, int t) {
  float s = 0.f;
#pragma unroll 8
  for (int i = 0; i < P; ++i) {
    const int p = (i + t) & (P - 1);
    s += (u != nullptr ? a[t * SD + p] * u[p] : a[t * SD + p]) * b[t * SD + p];
  }
  return s;
}

// ---------------------------------------------------------------------------
// stage 3 of W1: the outputs
// ---------------------------------------------------------------------------

template <int P>
__host__ __device__ constexpr int fwd_floats() {
  return 4 * kL * (P + 4) + kL * (P + 8) + P * (P + 8) + kL * (kL + 4) + 3 * P + kL;
}

// Grid (chunk, batch row, head). r, k and logw staged, v and states[c]
// copied while cum runs down the columns and r' and k' take the place of r
// and k; A = r' k'^T below the diagonal, a tile of 8 columns a warp; then
// each warp's 16 rows and P / 4 columns of y = A v + bonus v + r' (exp(m)
// S), exp(m) applied to S's rows as its fragments are read.
template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_out_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ lw, const float* __restrict__ u,
                   const float* __restrict__ states, T* __restrict__ y, Dims d) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int SR = P + 4, SV = P + 8, SA = kL + 4, NT = P / 32;
  extern __shared__ float4 smem4[];
  float* sr = reinterpret_cast<float*>(smem4);  // r, then r'
  float* sk = sr + kL * SR;                      // k, then k'
  float* scum = sk + kL * SR;                    // logw, then cum
  float* scp = scum + kL * SR;                   // cumprev
  float* sv = scp + kL * SR;                     // v
  float* ss = sv + kL * SV;                      // states[c] (row stride SV)
  float* sa = ss + P * SV;                       // A
  float* sm = sa + kL * SA;                      // m
  float* sem = sm + P;                           // exp(m)
  float* su = sem + P;                           // u
  float* sbonus = su + P;
  const int c = blockIdx.x, b = blockIdx.y, t0 = c * d.chunk;
  const int rows = min(d.chunk, d.seq - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int row0 = 16 * (warp >> 2), col0 = (warp & 3) * (P / 4);
  const int64_t pitch = static_cast<int64_t>(d.heads) * P;
  const int h = blockIdx.z;
  const int64_t at = ((static_cast<int64_t>(b) * d.seq + t0) * d.heads + h) * P;
  const int64_t bh = static_cast<int64_t>(b) * d.heads + h;
  stage<P, SR>(sr, r + at, pitch, rows);
  stage<P, SR>(sk, k + at, pitch, rows);
  stage<P, SR>(scum, lw + at, pitch, rows);
  cp_commit();
  stage<P, SV>(sv, v + at, pitch, rows);
  stage<P, SV, P>(ss, states + (bh * d.nc + c) * P * P, P, P);
  cp_commit();
  for (int p = threadIdx.x; p < P; p += kThreads) su[p] = u[h * P + p];
  cp_wait<1>();  // r, k, logw
  __syncthreads();
  if (threadIdx.x < P)
    column_scan<SR>(scum, scp, sm, sem, nullptr, nullptr, threadIdx.x, d.mid);
  else if (threadIdx.x < P + kL)
    sbonus[threadIdx.x - P] = row_dot<P, SR>(sr, su, sk, threadIdx.x - P);
  __syncthreads();
#pragma unroll
  for (int e = threadIdx.x; e < kL * P; e += kThreads) {
    const int p = e % P, at_s = (e / P) * SR + p;
    sr[at_s] *= expf(scp[at_s] - sm[p]);
    sk[at_s] *= expf(sm[p] - scum[at_s]);
  }
  __syncthreads();
  {  // A = r' k'^T, the warp's 8 columns, where they reach the diagonal
    const int cA = 8 * (warp & 3);
    if (cA < row0 + 16) {
      float acc[1][4] = {};
      mma_tile<1, false, false>(
          acc, 0, P, 1, [&](int rr, int kk) { return sr[(row0 + rr) * SR + kk]; },
          [&](int kk, int j) { return sk[(cA + j) * SR + kk]; });
      store_lower<SA>(sa, acc, row0, cA);
    }
  }
  cp_wait<0>();  // v, states[c]
  __syncthreads();
  float av[NT][4] = {}, rsn[NT][4] = {};
  mma_tile<NT, false, kExact>(
      av, 0, row0 + 16, NT, [&](int rr, int kk) { return sa[(row0 + rr) * SA + kk]; },
      [&](int kk, int j) { return sv[kk * SV + col0 + j]; });
  mma_tile<NT, false, false>(
      rsn, 0, P, NT, [&](int rr, int kk) { return sr[(row0 + rr) * SR + kk]; },
      [&](int kk, int j) { return ss[kk * SV + col0 + j] * sem[kk]; });
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row0 + g + 8 * half;
    if (t >= rows) continue;
    const float bo = sbonus[t];
    T* out = y + at + t * pitch + col0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int q = col0 + 8 * n + 2 * tq;
      put2(out + 8 * n, (av[n][2 * half] + bo * sv[t * SV + q]) + rsn[n][2 * half],
           (av[n][2 * half + 1] + bo * sv[t * SV + q + 1]) + rsn[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// stage 3 of W2: the chunk-local terms
// ---------------------------------------------------------------------------

template <int P>
__host__ __device__ constexpr int bwd_floats() {
  return 6 * kL * (P + 4) + 2 * P * (P + 4) + 2 * kL * (kL + 8) + 9 * P + 2 * kL;
}

// The sum over the warp's 16 rows of a column value held by the lanes of
// each g (rows g and g + 8 already added), in every lane.
__device__ __forceinline__ float column_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (chunk, batch row, head). r, k, v, dy and logw staged, states[c]
// and dS[c] copied while cum and cumprev run down the columns, fr =
// exp(cumprev - m), fk = exp(m - cum), r' and k' take the place of
// cumprev, cum, r and k, and A and dA are formed below the diagonal, a
// tile of 8 columns a warp; then, exp(m) S and dS'' = exp(cum_L - m) dS
// scaled by rows as their fragments are read, each warp's 16 rows and P / 4
// columns of
//   dr_dec = fr (dA k' + dy (exp(m) S)^T),  dk = fk (dA^T r') + fk (v dS''^T)
//   (+ the bonus terms), dv = A^T dy + bonus dy + k' dS'',
// with dcumprev and dcum in place of fr and fk and the column sums of
// k dk_tail and dbonus r k (per row half); then thread p < P: dcum_L, the
// reverse cumulative sum down column p into dlogw, and du's partial.
template <int P, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ lw, const float* __restrict__ u,
                     const float* __restrict__ states, const T* __restrict__ dy,
                     const float* __restrict__ ds, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dlw,
                     float* __restrict__ du_part, Dims d) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int SR = P + 4, SA = kL + 8, NT = P / 32;
  extern __shared__ float4 smem4[];
  float* sr = reinterpret_cast<float*>(smem4);  // r, then r'
  float* sk = sr + kL * SR;                      // k, then k'
  float* sv = sk + kL * SR;
  float* sdy = sv + kL * SR;
  float* sfr = sdy + kL * SR;                    // cumprev, then fr, then dcumprev
  float* sfk = sfr + kL * SR;                    // logw, then cum, then fk, then dcum
  float* ss = sfk + kL * SR;                     // states[c]
  float* sds = ss + P * SR;                      // dS[c]''
  float* sa = sds + P * SR;                      // A
  float* sda = sa + kL * SA;                     // dA
  float* sm = sda + kL * SA;                     // m
  float* sem = sm + P;                           // exp(m)
  float* selm = sem + P;                         // exp(cum_L - m)
  float* sel = selm + P;                         // exp(cum_L)
  float* su = sel + P;                           // u
  float* scol = su + P;                          // per row half: column sums of k dk_tail
  float* sdu = scol + 2 * P;                     //   of dbonus r k
  float* sbonus = sdu + 2 * P;
  float* sdbonus = sbonus + kL;
  const int c = blockIdx.x, b = blockIdx.y, t0 = c * d.chunk;
  const int rows = min(d.chunk, d.seq - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int rs = warp >> 2, row0 = 16 * rs, col0 = (warp & 3) * (P / 4);
  const int64_t pitch = static_cast<int64_t>(d.heads) * P;
  const int h = blockIdx.z;
  const int64_t at = ((static_cast<int64_t>(b) * d.seq + t0) * d.heads + h) * P;
  const int64_t bh = static_cast<int64_t>(b) * d.heads + h;
  stage<P, SR>(sr, r + at, pitch, rows);
  stage<P, SR>(sk, k + at, pitch, rows);
  stage<P, SR>(sv, v + at, pitch, rows);
  stage<P, SR>(sdy, dy + at, pitch, rows);
  stage<P, SR>(sfk, lw + at, pitch, rows);
  cp_commit();
  stage<P, SR, P>(ss, states + (bh * d.nc + c) * P * P, P, P);
  stage<P, SR, P>(sds, ds + (bh * d.nc + c) * P * P, P, P);
  cp_commit();
  for (int p = threadIdx.x; p < P; p += kThreads) su[p] = u[h * P + p];
  cp_wait<1>();  // r, k, v, dy, logw
  __syncthreads();
  if (threadIdx.x < P)
    column_scan<SR>(sfk, sfr, sm, sem, selm, sel, threadIdx.x, d.mid);
  else if (threadIdx.x < P + kL)
    sbonus[threadIdx.x - P] = row_dot<P, SR>(sr, su, sk, threadIdx.x - P);
  else if (threadIdx.x < P + 2 * kL)
    sdbonus[threadIdx.x - P - kL] = row_dot<P, SR>(sdy, nullptr, sv, threadIdx.x - P - kL);
  __syncthreads();
#pragma unroll
  for (int e = threadIdx.x; e < kL * P; e += kThreads) {
    const int p = e % P, at_s = (e / P) * SR + p;
    const float fr = expf(sfr[at_s] - sm[p]), fk = expf(sm[p] - sfk[at_s]);
    sfr[at_s] = fr;
    sfk[at_s] = fk;
    sr[at_s] *= fr;
    sk[at_s] *= fk;
  }
  __syncthreads();
  {  // A = r' k'^T and dA = dy v^T, the warp's 8 columns, where they reach the diagonal
    const int cA = 8 * (warp & 3);
    if (cA < row0 + 16) {
      float acc[1][4] = {}, dacc[1][4] = {};
      mma_tile<1, false, false>(
          acc, 0, P, 1, [&](int rr, int kk) { return sr[(row0 + rr) * SR + kk]; },
          [&](int kk, int j) { return sk[(cA + j) * SR + kk]; });
      mma_tile<1, kExact, kExact>(
          dacc, 0, P, 1, [&](int rr, int kk) { return sdy[(row0 + rr) * SR + kk]; },
          [&](int kk, int j) { return sv[(cA + j) * SR + kk]; });
      store_lower<SA>(sa, acc, row0, cA);
      store_lower<SA>(sda, dacc, row0, cA);
    }
  }
  cp_wait<0>();  // states[c], dS[c]
  __syncthreads();
  {  // dr and dk, with dcumprev, dcum and the column sums
    float d1[NT][4] = {}, d2[NT][4] = {}, k1[NT][4] = {}, k2[NT][4] = {};
    mma_tile<NT, false, false>(
        d1, 0, row0 + 16, NT, [&](int rr, int kk) { return sda[(row0 + rr) * SA + kk]; },
        [&](int kk, int j) { return sk[kk * SR + col0 + j]; });
    mma_tile<NT, kExact, false>(
        d2, 0, P, NT, [&](int rr, int kk) { return sdy[(row0 + rr) * SR + kk]; },
        [&](int kk, int j) { return ss[(col0 + j) * SR + kk] * sem[col0 + j]; });
    mma_tile<NT, false, false>(
        k1, row0, kL, NT, [&](int rr, int kk) { return sda[kk * SA + row0 + rr]; },
        [&](int kk, int j) { return sr[kk * SR + col0 + j]; });
    mma_tile<NT, kExact, false>(
        k2, 0, P, NT, [&](int rr, int kk) { return sv[(row0 + rr) * SR + kk]; },
        [&](int kk, int j) { return sds[(col0 + j) * SR + kk] * selm[col0 + j]; });
    float colk[NT][2] = {}, coldu[NT][2] = {};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = row0 + g + 8 * half;
      const bool valid = t < rows;
      const float dbo = sdbonus[t];
      const int64_t row_at = at + t * pitch;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int p = col0 + 8 * n + 2 * tq;
        const float2 rv = valid ? load2(r + row_at + p) : make_float2(0.f, 0.f);
        const float2 kv = valid ? load2(k + row_at + p) : make_float2(0.f, 0.f);
        float out_r[2], out_k[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ei = 2 * half + e, at_s = t * SR + p + e;
          const float rx = e ? rv.y : rv.x, kx = e ? kv.y : kv.x;
          const float dr_dec = sfr[at_s] * (d1[n][ei] + d2[n][ei]);
          const float fk = sfk[at_s];
          const float dkb = fk * k1[n][ei], dkt = fk * k2[n][ei];
          const float dbu = dbo * su[p + e];
          out_r[e] = dr_dec + dbu * kx;
          out_k[e] = (dkb + dkt) + dbu * rx;
          const float dcp = rx * dr_dec;
          sfr[at_s] = dcp;
          sfk[at_s] = (dcp - kx * dkb) - kx * dkt;
          colk[n][e] += kx * dkt;
          coldu[n][e] += dbo * rx * kx;
        }
        if (valid) {
          put2(dr + row_at + p, out_r[0], out_r[1]);
          put2(dk + row_at + p, out_k[0], out_k[1]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sk_col = column_sum(colk[n][e]), du_col = column_sum(coldu[n][e]);
        if (g == 0) {
          scol[rs * P + col0 + 8 * n + 2 * tq + e] = sk_col;
          sdu[rs * P + col0 + 8 * n + 2 * tq + e] = du_col;
        }
      }
  }
  {  // dv = A^T dy + bonus dy + k' dS''
    float v1[NT][4] = {}, v2[NT][4] = {};
    mma_tile<NT, false, kExact>(
        v1, row0, kL, NT, [&](int rr, int kk) { return sa[kk * SA + row0 + rr]; },
        [&](int kk, int j) { return sdy[kk * SR + col0 + j]; });
    mma_tile<NT, false, false>(
        v2, 0, P, NT, [&](int rr, int kk) { return sk[(row0 + rr) * SR + kk]; },
        [&](int kk, int j) { return sds[kk * SR + col0 + j] * selm[kk]; });
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = row0 + g + 8 * half;
      if (j >= rows) continue;
      const float bo = sbonus[j];
      float* out = dv + at + j * pitch + col0 + 2 * tq;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int q = col0 + 8 * n + 2 * tq;
        put2(out + 8 * n, (v1[n][2 * half] + bo * sdy[j * SR + q]) + v2[n][2 * half],
             (v1[n][2 * half + 1] + bo * sdy[j * SR + q + 1]) + v2[n][2 * half + 1]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < P) {  // dcum_L, dlogw down column p, du's partial
    const int p = threadIdx.x;
    float sdot = 0.f;  // <S, dS> of row p
    for (int q = 0; q < P; ++q) sdot += ss[p * SR + q] * sds[p * SR + q];
    const float dcum_l = (scol[p] + scol[P + p]) + sel[p] * sdot;
    float run = 0.f;
    for (int t = kL - 1; t >= 0; --t) {
      float dc = sfk[t * SR + p];
      if (t == kL - 1) dc += dcum_l;
      run += dc;
      if (t < rows) dlw[at + t * pitch + p] = run - sfr[t * SR + p];
    }
    du_part[(bh * d.nc + c) * P + p] = sdu[p] + sdu[P + p];
  }
}

// ---------------------------------------------------------------------------
// stage 4 of W2: du
// ---------------------------------------------------------------------------

// du (H, P): per batch row the chunks' partials in reverse order, then the
// batch rows in order, as the plain version sums them.
template <int P>
__global__ void __launch_bounds__(kThreads)
    du_finish_kernel(const float* __restrict__ du_part, float* __restrict__ du, Dims d) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= d.heads * P) return;
  const int h = i / P, p = i % P;
  float s = 0.f;
  for (int b = 0; b < d.batch; ++b) {
    const float* part = du_part + (static_cast<int64_t>(b) * d.heads + h) * d.nc * P + p;
    float sb = 0.f;
    for (int c = d.nc - 1; c >= 0; --c) sb += part[static_cast<int64_t>(c) * P];
    s += sb;
  }
  du[i] = s;
}

static_assert(bwd_floats<64>() * sizeof(float) * 2 <= 232448 - 2048,
              "W2's chunk-local stage no longer fits two blocks an SM");

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

// Launch `kernel` on `grid` with `floats` of dynamic shared memory; returns
// the cudaError.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int floats, void* stream, Args... args) {
  const int bytes = floats * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, bytes, as_stream(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The dimensions for the launches, or false if the kernels do not take them.
inline bool dims(int batch, int seq, int heads, int chunk, Dims* d) {
  if (chunk < 1 || chunk > kL || seq < 1 || batch < 1 || heads < 1 || batch > 65535 ||
      heads > 65535)
    return false;
  *d = Dims{batch, seq, heads, chunk, (seq + chunk - 1) / chunk, (chunk + 1) / 2 - 1};
  return true;
}

template <int P, typename T>
int fwd(const void* r, const void* k, const void* v, const void* lw, const void* u, void* y,
        void* states, const void* initial, void* final_state, void* el, Dims d, void* stream) {
  const T *rt = static_cast<const T*>(r), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *lt = static_cast<const T*>(lw);
  float *st = static_cast<float*>(states), *elf = static_cast<float*>(el);
  float* fin = static_cast<float*>(final_state);
  int err = launch(chunk_sum_kernel<P, T, false>, dim3(d.nc, d.batch, d.heads), 0, stream, kt,
                   vt, lt, st, fin, elf, d);
  if (err) return err;
  err = launch(pass_kernel<P, false>, dim3(d.batch * d.heads, (P * P / 4 + kThreads - 1) / kThreads),
               0, stream, st, static_cast<const float*>(elf), static_cast<const float*>(initial),
               fin, d.nc);
  if (err) return err;
  return launch(fwd_out_kernel<P, T>, dim3(d.nc, d.batch, d.heads), fwd_floats<P>(),
                stream, rt, kt, vt, lt, static_cast<const float*>(u),
                static_cast<const float*>(st), static_cast<T*>(y), d);
}

template <int P, typename T>
int bwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
        const void* states, const void* dy, const void* d_final, void* dr, void* dk, void* dv,
        void* dlw, void* du, void* d_initial, void* ds, void* el, void* du_part, Dims d,
        void* stream) {
  const T *rt = static_cast<const T*>(r), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *lt = static_cast<const T*>(lw),
          *dyt = static_cast<const T*>(dy);
  float *dsf = static_cast<float*>(ds), *elf = static_cast<float*>(el),
        *dup = static_cast<float*>(du_part);
  float* dini = static_cast<float*>(d_initial);
  int err = launch(chunk_sum_kernel<P, T, true>, dim3(d.nc, d.batch, d.heads), 0, stream, rt,
                   dyt, lt, dsf, dini, elf, d);
  if (err) return err;
  err = launch(pass_kernel<P, true>, dim3(d.batch * d.heads, (P * P / 4 + kThreads - 1) / kThreads),
               0, stream, dsf, static_cast<const float*>(elf), static_cast<const float*>(d_final),
               dini, d.nc);
  if (err) return err;
  err = launch(bwd_chunk_kernel<P, T>, dim3(d.nc, d.batch, d.heads), bwd_floats<P>(),
               stream, rt, kt, vt, lt, static_cast<const float*>(u),
               static_cast<const float*>(states), dyt, static_cast<const float*>(dsf),
               static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(dlw), dup, d);
  if (err) return err;
  return launch(du_finish_kernel<P>, dim3((d.heads * P + kThreads - 1) / kThreads), 0, stream,
                static_cast<const float*>(dup), static_cast<float*>(du), d);
}

// Call FN<P, T>(args...) for the runtime head_dim and dtype; an unsupported
// head_dim is cudaErrorInvalidValue.
#define DISPATCH(head_dim, bf16, FN, ...)                                                   \
  do {                                                                                      \
    switch (head_dim) {                                                                     \
      case 32: return bf16 ? FN<32, __nv_bfloat16>(__VA_ARGS__) : FN<32, float>(__VA_ARGS__); \
      case 64: return bf16 ? FN<64, __nv_bfloat16>(__VA_ARGS__) : FN<64, float>(__VA_ARGS__); \
      default: return static_cast<int>(cudaErrorInvalidValue);                              \
    }                                                                                       \
  } while (0)

template <int P, typename T>
int launch_config(int which, int* out) {
  switch (which) {
    case 0: return launch_resources(chunk_sum_kernel<P, T, false>, kThreads, 0, out);
    case 1: return launch_resources(pass_kernel<P, false>, kThreads, 0, out);
    case 2: return launch_resources(fwd_out_kernel<P, T>, kThreads,
                                    sizeof(float) * fwd_floats<P>(), out);
    case 3: return launch_resources(chunk_sum_kernel<P, T, true>, kThreads, 0, out);
    case 4: return launch_resources(pass_kernel<P, true>, kThreads, 0, out);
    case 5: return launch_resources(bwd_chunk_kernel<P, T>, kThreads,
                                    sizeof(float) * bwd_floats<P>(), out);
    case 6: return launch_resources(du_finish_kernel<P>, kThreads, 0, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// W1, from initial (null: zeros), into final (null: not formed). Scratch:
// el (B, H, chunks, P) f32.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
             void* y, void* states, const void* initial, void* final_state, void* el, int batch,
             int seq, int heads, int head_dim, int chunk, int bf16, void* stream) {
  Dims d;
  if (!dims(batch, seq, heads, chunk, &d)) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(head_dim, bf16, fwd, r, k, v, lw, u, y, states, initial, final_state, el, d, stream);
}

// W2, from d_final (null: zeros), into d_initial (null: not formed).
// Scratch: ds (B, H, chunks, P, P), el and du_part (B, H, chunks, P), all
// f32.
int wkv6_bwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
             const void* states, const void* dy, const void* d_final, void* dr, void* dk,
             void* dv, void* dlw, void* du, void* d_initial, void* ds, void* el, void* du_part,
             int batch, int seq, int heads, int head_dim, int chunk, int bf16, void* stream) {
  Dims d;
  if (!dims(batch, seq, heads, chunk, &d)) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(head_dim, bf16, bwd, r, k, v, lw, u, states, dy, d_final, dr, dk, dv, dlw, du,
           d_initial, ds, el, du_part, d, stream);
}

// The resources of W1's kernels (which 0-2: chunk sums, pass, outputs) and
// W2's (3-6: chunk sums, pass, chunk-local terms, du) at head_dim and dtype
// (see launch_resources()).
int wkv6_launch_config(int which, int head_dim, int bf16, void* out) {
  DISPATCH(head_dim, bf16, launch_config, which, static_cast<int*>(out));
}

}  // extern "C"
