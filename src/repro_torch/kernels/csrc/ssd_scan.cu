// Mamba2's SSD chunked scan for Hopper (sm_90a), forward and backward, bound
// to Python with ctypes by repro_torch/kernels/ssd_scan.py.
//
// Replaces the Pallas TPU kernel ssd_scan_pallas of
// src/repro/kernels/ssd_scan.py (pallas_call at :77), which is forward
// only; the backward is new, so that Mamba2LM and Zamba2LM can train
// through the forward:
//   ssd_fwd   S1  y, the state at the start of every chunk, and the final
//                 state, from an initial state (or zeros)
//   ssd_bwd   S2  dx, d(dt), dA, dB and dC, from the final state's gradient
//                 (or zeros), and the initial state's gradient
// Layout: x, y, dy, dx (B, S, H, P); dt, d(dt) (B, S, H) f32; A, dA (H,)
// f32; Bm, Cm, dB, dC (B, S, N), B and C shared by the heads (ngroups = 1);
// states (B, H, chunks, N, P) f32; the initial and final states and their
// gradients (B, H, N, P) f32; all contiguous, x, Bm, Cm, dy, the states and
// their gradients on 16 bytes. x, Bm, Cm, dy f32 or bf16 (all of one dtype), y in that
// dtype, gradients f32, all arithmetic in f32 but g's (f64). (N, P) is (16, 32) or
// (64, 64): the reduced and the full zamba2-1.2b. The scratch (C B^T of
// every chunk, e_L of every chunk and head, S2's dS and partial sums) is the
// caller's: these functions allocate nothing.
//
// What it computes, as B9 does, per chunk of L <= 64 steps (rows past S read
// as zeros, which leaves the decay flat over the pad): g = cumsum(dt A) down
// the chunk, xf = x dt, M_tj = (C_t . B_j) exp(g_t - g_j) for j <= t (0
// above the diagonal), y = M xf + exp(g) (C S), then
// S <- exp(g_L) S + sum_j exp(g_L - g_j) B_j (x) xf_j. Every exponent is at
// most 0, and masked before exp where it is not: exp(g_t - g_j) is never
// split into exp(g_t) exp(-g_j), which overflows once g falls past -88 (at
// init, A = -e and dt near 0.7).
//
// The backward carries dS, the gradient of the state after a chunk, back
// over the chunks. With G_tj = (dy_t . xf_j) exp(g_t - g_j) for j <= t and
// Q_tj = G_tj (C_t . B_j) for j < t:
//   dxf   = M^T dy + exp(g_L - g) (B dS)            dx = dxf dt
//   dC    = G B + exp(g) (dy S^T)
//   dB    = G^T C + exp(g_L - g) (xf dS^T)
//   dg_t  = sum_j Q_tj - sum_j Q_jt + C_t . exp(g_t) (dy S^T)_t - R_t,
//           R_t = B_t . exp(g_L - g_t) (xf dS^T)_t (the rows' dots of dC's
//           and dB's state terms: dy_t . (C S)_t and xf_t . (B dS)_t), and
//           the last step adds exp(g_L) <S, dS> + sum_t R_t
//   da    = reverse cumsum of dg; d(dt) = da A + dxf . x; dA = sum da dt
//   dS    <- exp(g_L) dS + (C exp(g))^T dy
// g restarts in every chunk, so every term but the carried S and dS is
// chunk-local. The carry starts from the initial state S_0 (the reference's
// ssd_chunked(initial_state=)), and dS from the final state's gradient; a
// null pointer for either is zeros, today's arithmetic. The final state is
// exp(g_L) S + the last chunk's summary, and the initial state's gradient
// exp(g_L) dS + the first chunk's (C exp(g))^T dy: the pass that carries S or
// dS takes one step more, past the edge. S_0 reaches every other term as
// states[0], which the backward reads as it reads every chunk's state.
//
// Design: a chunk-parallel scan, each stage a grid over (chunk, batch row,
// group of heads), as Mamba2's own chunked SSD is split:
//   S1  1. chunk_sum_kernel: each chunk's summary (B exp(g_L - g))^T xf, an
//          (N x L)(L x P) product, into the states slot of the next chunk
//          (the last chunk's into the final state), and e_L = exp(g_L); one
//          more block per (batch row, chunk) forms C B^T once for all the
//          heads (ngroups = 1) into scratch;
//       2. pass_kernel: states[0] = S_0, states[c] = e_L[c-1] states[c-1] +
//          states[c], in place, a float4 a thread walking the chunks, and
//          the final state e_L[nc-1] states[nc-1] + its summary;
//       3. fwd_out_kernel: per head of the block's group, y = (C B^T
//          exp(g_t - g_j)) xf + exp(g) (C states[c]).
//   S2  1. chunk_sum_kernel: (C exp(g))^T dy into the dS slot of the chunk
//          before (the first chunk's into the initial state's gradient), e_L,
//          and C B^T again;
//       2. pass_kernel in reverse: dS[nc-1] = the final state's gradient,
//          dS[c] = e_L[c+1] dS[c+1] + dS[c], and the initial state's
//          gradient e_L[0] dS[0] + its chunk sum;
//       3. bwd_chunk_kernel: per head of the block's group every chunk-local
//          term from states[c] and dS[c]: dx, d(dt), dA's partial a (batch
//          row, head, chunk), and dB and dC summed over the group's heads in
//          order in registers;
//       4. finish_kernel: dB and dC summed over the groups, dA over the
//          batch and the chunks, each in a fixed order.
// At the main shape (B 2, S 1024, H 64, P 64, N 64) that is 2,048 chunk
// summaries (4 heads a block), 512 blocks of S1's output stage (4 heads a
// block, 3 blocks an SM) and 128 of S2's chunk-local stage (16 heads a
// block, the wrapper's choice: one wave, one block an SM in 214 KB of shared
// memory, two buffers of a head's tiles so that the next head's copies,
// cp.async, run under this head's products), against 128 blocks that each
// walked 16 chunks in order before. g is a warp scan (a lane holds two
// rows) in f64, and so are the exponents g_t - g_j: at init g reaches -120
// over a chunk, where an f32 ulp is 7.6e-6 of every decay. Every product is
// mma.sync m16n8k8 with TF32 operands in three terms, as in
// flash_attention.cu: each f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (two integer operations), lo.hi and hi.lo go into the
// accumulator before hi.hi; a bf16 input is exact in TF32 and its lo terms
// are skipped (xf = x dt, C B^T, the decayed operands are f32 and always
// split). The tensor cores add with truncation, so each 16 of a product's k
// go to a fresh accumulator, added in f32. A warp owns 16 rows and half the
// columns of a 64-row tile; warps w and w + 4 (one scheduler) take row
// slices that pair 0 with 3 and 1 with 2, so the triangular products (M xf,
// G, M^T dy, G B, G^T C, C B^T), whose k or column ranges stop at the
// diagonal, share out evenly. Operands are read from shared memory as f32
// (bf16 widened when staged), each tile with a row stride of width + 4 or
// + 8 after its commonest fragment read, decays applied as the fragments
// are loaded. d(dt)'s sums (the rows' dots, Q's row and column sums, taken
// from G's fragments, the reverse cumulative sum, a warp scan) stay on f32
// FMAs in a fixed order. No atomics: every run gives the same bits.
//
// Bound: bytes, once on the tensor cores. At the main shape (f32) S1 reads
// x, dt, A, B, C and writes y: 68.7 MB, 0.0205 ms at 3.35 TB/s; S2 103.8 MB,
// 0.0310 ms. The function's fewest operations (chunks of 8; C B^T once per
// batch row and chunk) are 2.30 GFLOP for S1 and 4.73 for S2: 0.0343 and
// 0.0707 ms on f32 FMAs at 67 TFLOP/s, and 0.0140 and 0.0287 ms as three
// TF32 products at 495 TFLOP/s (chip_smoke.py's ssd_ops and ssd_bound). The
// chunk states S1 must write for S2 (33.5 MB), which the stages write, read
// and write again, and S2's dS likewise, are not in the function's bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_config.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kL = 64;          // the kernels' chunk: the rows of every chunk tile
constexpr int kSumHeads = 4;    // heads a block of chunk_sum_kernel
constexpr int kFwdHeads = 4;    // heads a block of fwd_out_kernel
constexpr float kMasked = -1e30f;  // a masked exponent: exp gives 0

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The sum over a warp, in one fixed order, in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum over the four lanes of a quad (one row of an mma tile).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Dims {
  int batch, seq, heads, chunk, nc, group;  // group: heads a block
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

// The warp's 16-row slice of a 64-row tile: warps w and w + 4 share a
// scheduler and take slices 0 and 3, or 1 and 2.
__device__ __forceinline__ int warp_slice() {
  const int w = threadIdx.x >> 5;
  return w < 4 ? w >> 1 : 3 - ((w - 4) >> 1);
}
// The warp's half of the columns.
__device__ __forceinline__ int warp_half() { return (threadIdx.x >> 5) & 1; }

// Column tiles of 8, from col0, of a warp's 16-row slice rs that reach the
// diagonal or below it (of NT).
template <int NT>
__device__ __forceinline__ int lower_tiles(int rs, int col0) {
  return min(NT, max(0, (16 * rs + 16 - col0) / 8));
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

// nrows rows of W values into shared memory as f32, row stride SD: row r
// from src + r * pitch where r < rows (times scale[r * scale_pitch] if scale
// is given), zeros past.
template <int W, int SD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int64_t pitch,
                                      int rows, int nrows = kL,
                                      const float* __restrict__ scale = nullptr,
                                      int64_t scale_pitch = 0) {
  constexpr int Q = W / 4;
  for (int i = threadIdx.x; i < nrows * Q; i += kThreads) {
    const int r = i / Q, c = 4 * (i - r * Q);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      v = load4(src + r * pitch + c);
      if (scale != nullptr) {
        const float s = __ldg(scale + r * scale_pitch);
        v = make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
      }
    }
    *reinterpret_cast<float4*>(dst + r * SD + c) = v;
  }
}

// By one whole warp: dt of one head over the chunk's rows into sdt (0 past
// `rows`), g = cumsum(dt a) in f64 (a warp scan, lane l holding rows 2l and
// 2l + 1), e = exp(g) and w = exp(g_63 - g). The pad leaves g flat, so g_63
// is g_L. g reaches -120 over a chunk at init, where an f32 ulp of g is
// 7.6e-6 of every decay: in f32 this scan alone put S1's y 1.4e-5 of its
// largest value from the plain version's (0.68 of the limit).
__device__ __forceinline__ void decays(float* sdt, double* sg, float* se, float* sw,
                                       const float* __restrict__ dt, int64_t off, int heads,
                                       int rows, float a) {
  const int lane = threadIdx.x & 31, r0 = 2 * lane;
  const float d0 = r0 < rows ? __ldg(dt + off + static_cast<int64_t>(r0) * heads) : 0.f;
  const float d1 = r0 + 1 < rows ? __ldg(dt + off + static_cast<int64_t>(r0 + 1) * heads) : 0.f;
  const double a0 = static_cast<double>(d0) * a, a1 = static_cast<double>(d1) * a;
  double incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double g0 = excl + a0, g1 = g0 + a1;
  const double gl = __shfl_sync(0xffffffffu, g1, 31);
  sdt[r0] = d0;
  sdt[r0 + 1] = d1;
  sg[r0] = g0;
  sg[r0 + 1] = g1;
  se[r0] = expf(static_cast<float>(g0));
  se[r0 + 1] = expf(static_cast<float>(g1));
  sw[r0] = expf(static_cast<float>(gl - g0));
  sw[r0 + 1] = expf(static_cast<float>(gl - g1));
}

// exp(g_t - g_j) where j <= t, 0 above the diagonal: the exponent, taken in
// f64, is masked before exp.
__device__ __forceinline__ float pair_decay(const double* sg, int t, int j) {
  return expf(j <= t ? static_cast<float>(sg[t] - sg[j]) : kMasked);
}

// Store a warp's 16 x 8NT accumulators to rows (row0 + g, + 8) and columns
// col0 + 8n + 2t of a row-major f32 matrix with row pitch `pitch`, rows at or
// past `rows` left out.
template <int NT>
__device__ __forceinline__ void store_tile(float* dst, int64_t pitch, const float (&c)[NT][4],
                                           int row0, int col0, int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      put2(dst + r * pitch + col0 + 8 * n + 2 * t, c[n][2 * half], c[n][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// stage 1 (S1 and S2): chunk summaries, e_L, and C B^T
// ---------------------------------------------------------------------------

template <int N, int P>
__host__ __device__ constexpr int sum_floats() {
  return (kL * (N + 8) + kL * (P + 8) + 5 * kL) > 2 * kL * (N + 4)
             ? kL * (N + 8) + kL * (P + 8) + 5 * kL
             : 2 * kL * (N + 4);
}

// Grid (chunk, batch row, head group + 1). Blocks of the head groups: per
// head h of the group, out[slot] = (U exp-weighted)^T V over the chunk's
// rows, an N x P product: S1 (kBwd false) (B exp(g_L - g))^T (x dt) into
// states[b, h, c + 1]; S2 (C exp(g))^T dy into dS[b, h, c - 1]; the edge
// chunk's (S1's last, S2's first), which has no such slot, into edge[b, h]
// where edge is given; and el[b, h, c] = exp(g_L). The last block of each
// (chunk, batch row) forms C B^T of the chunk (its lower triangle, zeros
// above) into cb[b, c].
template <int N, int P, typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    chunk_sum_kernel(const T* __restrict__ v, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ bm,
                     const T* __restrict__ cm, float* __restrict__ out,
                     float* __restrict__ edge, float* __restrict__ el,
                     float* __restrict__ cb, Dims d) {
  constexpr bool kExact = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.x, b = blockIdx.y, t0 = c * d.chunk;
  const int rows = min(d.chunk, d.seq - t0);
  const int64_t bc0 = (static_cast<int64_t>(b) * d.seq + t0) * N;  // (b, t0, 0) of B, C
  const int rs = warp_slice(), ch = warp_half();

  if (blockIdx.z == gridDim.z - 1) {
    constexpr int SN = N + 4, NT = kL / 16;
    float* sc = smem;
    float* sb = sc + kL * SN;
    stage<N, SN>(sc, cm + bc0, N, rows);
    stage<N, SN>(sb, bm + bc0, N, rows);
    __syncthreads();
    const int row0 = 16 * rs, col0 = ch * (kL / 2);
    float acc[NT][4] = {};
    mma_tile<NT, kExact, kExact>(
        acc, 0, N, lower_tiles<NT>(rs, col0),
        [&](int r, int k) { return sc[(row0 + r) * SN + k]; },
        [&](int k, int j) { return sb[(col0 + j) * SN + k]; });
    store_tile<NT>(cb + (static_cast<int64_t>(b) * d.nc + c) * kL * kL, kL, acc, row0, col0, kL);
    return;
  }

  constexpr int SU = N + 8, SV = P + 8, NT = P / 16;
  float* su = smem;            // B (S1) or C (S2), L x N
  float* sv = su + kL * SU;    // x dt (S1) or dy (S2), L x P
  float* sdt = sv + kL * SV;
  double* sg = reinterpret_cast<double*>(sdt + kL);
  float* se = sdt + 3 * kL;
  float* sw = se + kL;
  const bool at_edge = kBwd ? c == 0 : c + 1 == d.nc;  // no slot: the edge's
  const bool wanted = !at_edge || edge != nullptr;      // whether the summary goes somewhere
  if (wanted) stage<N, SU>(su, (kBwd ? cm : bm) + bc0, N, rows);
  const int row0 = 16 * rs, col0 = ch * (P / 2);
  for (int i = 0; i < d.group; ++i) {
    const int h = blockIdx.z * d.group + i;
    const int64_t row_dt = (static_cast<int64_t>(b) * d.seq + t0) * d.heads + h;  // (b, t0, h)
    __syncthreads();  // the previous head's reads are done
    if (wanted)
      stage<P, SV>(sv, v + row_dt * P, static_cast<int64_t>(d.heads) * P, rows, kL,
                   kBwd ? nullptr : dt + row_dt, d.heads);
    if (threadIdx.x < 32) decays(sdt, sg, se, sw, dt, row_dt, d.heads, rows, A[h]);
    __syncthreads();
    const int64_t bh = static_cast<int64_t>(b) * d.heads + h;
    if (threadIdx.x == 0) el[bh * d.nc + c] = se[kL - 1];
    if (!wanted || row0 >= N) continue;
    float acc[NT][4] = {};
    mma_tile<NT, false, kBwd && kExact>(
        acc, 0, kL, NT,
        [&](int r, int k) { return su[k * SU + row0 + r] * (kBwd ? se[k] : sw[k]); },
        [&](int k, int j) { return sv[k * SV + col0 + j]; });
    float* slot = at_edge ? edge + bh * N * P
                          : out + (bh * d.nc + (kBwd ? c - 1 : c + 1)) * N * P;
    store_tile<NT>(slot, P, acc, row0, col0, N);
  }
}

// ---------------------------------------------------------------------------
// stage 2: the carried states (S1) or dS (S2), in place
// ---------------------------------------------------------------------------

// Grid (batch row x head, float4s of a slot / kThreads). Slot c holds the
// summary of chunk c - 1 (S1) or c + 1 (S2); a thread walks its float4
// over the chunks: S1 s[0] = seed, s[c] = e_L[c-1] s[c-1] + s[c] upward; S2
// s[nc-1] = seed, s[c] = e_L[c+1] s[c+1] + s[c] downward; a null seed is
// zeros. Four chunks' loads are issued before their updates. Where edge is
// given, one step more: edge = e_L[nc-1] s[nc-1] + edge (S1, the final
// state) or e_L[0] s[0] + edge (S2, the initial state's gradient).
template <bool kBwd>
__global__ void __launch_bounds__(kThreads)
    pass_kernel(float* __restrict__ s, const float* __restrict__ el,
                const float* __restrict__ seed, float* __restrict__ edge, int nc,
                int slot_floats) {
  const int q = slot_floats / 4;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= q) return;
  const int64_t bh = blockIdx.x;
  float4* base = reinterpret_cast<float4*>(s + bh * nc * slot_floats) + i;
  const float* e = el + bh * nc;
  float4 prev = make_float4(0.f, 0.f, 0.f, 0.f);
  if (seed != nullptr) prev = reinterpret_cast<const float4*>(seed + bh * slot_floats)[i];
  base[static_cast<int64_t>(kBwd ? nc - 1 : 0) * q] = prev;
  for (int step = 1; step < nc; step += 4) {
    float4 sum[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = kBwd ? nc - 1 - (step + k) : step + k;
      if (step + k < nc) sum[k] = base[static_cast<int64_t>(c) * q];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (step + k >= nc) break;
      const int c = kBwd ? nc - 1 - (step + k) : step + k;
      const float f = e[kBwd ? c + 1 : c - 1];
      prev = make_float4(f * prev.x + sum[k].x, f * prev.y + sum[k].y, f * prev.z + sum[k].z,
                         f * prev.w + sum[k].w);
      base[static_cast<int64_t>(c) * q] = prev;
    }
  }
  if (edge != nullptr) {
    float4* out = reinterpret_cast<float4*>(edge + bh * slot_floats) + i;
    const float4 sum = *out;
    const float f = e[kBwd ? 0 : nc - 1];
    *out = make_float4(f * prev.x + sum.x, f * prev.y + sum.y, f * prev.z + sum.z,
                       f * prev.w + sum.w);
  }
}

// ---------------------------------------------------------------------------
// stage 3 of S1: the outputs
// ---------------------------------------------------------------------------

template <int N, int P>
__host__ __device__ constexpr int fwd_floats() {
  return kL * (kL + 4) + kL * (N + 4) + kL * (P + 8) + N * (P + 8) + 5 * kL;
}

// Grid (chunk, batch row, head group). C B^T of the chunk (from stage 1)
// and C are staged once; per head: xf = x dt, states[c], the decays, then
// each warp's 16 rows and P / 2 columns of y = (C B^T exp(g_t - g_j)) xf +
// exp(g) (C states[c]), the decay applied as M's fragments are loaded.
template <int N, int P, typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ cm,
                   const float* __restrict__ states, const float* __restrict__ cb,
                   T* __restrict__ y, Dims d) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int SA = kL + 4, SC = N + 4, SX = P + 8, NT = P / 16;
  extern __shared__ float4 smem4[];
  float* scb = reinterpret_cast<float*>(smem4);  // C B^T, L x L
  float* sc = scb + kL * SA;                      // C, L x N
  float* sx = sc + kL * SC;                       // xf, L x P
  float* ss = sx + kL * SX;                       // states[c], N x P
  float* sdt = ss + N * SX;
  double* sg = reinterpret_cast<double*>(sdt + kL);
  float* se = sdt + 3 * kL;
  float* sw = se + kL;
  const int c = blockIdx.x, b = blockIdx.y, t0 = c * d.chunk;
  const int rows = min(d.chunk, d.seq - t0);
  const int rs = warp_slice(), ch = warp_half();
  const int row0 = 16 * rs, col0 = ch * (P / 2);
  stage<kL, SA>(scb, cb + (static_cast<int64_t>(b) * d.nc + c) * kL * kL, kL, kL);
  stage<N, SC>(sc, cm + (static_cast<int64_t>(b) * d.seq + t0) * N, N, rows);
  for (int i = 0; i < d.group; ++i) {
    const int h = blockIdx.z * d.group + i;
    const int64_t row_dt = (static_cast<int64_t>(b) * d.seq + t0) * d.heads + h;
    const int64_t bh = static_cast<int64_t>(b) * d.heads + h;
    __syncthreads();
    stage<P, SX>(sx, x + row_dt * P, static_cast<int64_t>(d.heads) * P, rows, kL, dt + row_dt,
                 d.heads);
    stage<P, SX>(ss, states + (bh * d.nc + c) * N * P, P, N, N);
    if (threadIdx.x < 32) decays(sdt, sg, se, sw, dt, row_dt, d.heads, rows, A[h]);
    __syncthreads();
    float intra[NT][4] = {}, inter[NT][4] = {};
    mma_tile<NT, false, false>(
        intra, 0, row0 + 16, NT,
        [&](int r, int k) {
          const int tr = row0 + r;
          return scb[tr * SA + k] * pair_decay(sg, tr, k);
        },
        [&](int k, int j) { return sx[k * SX + col0 + j]; });
    mma_tile<NT, kExact, false>(
        inter, 0, N, NT, [&](int r, int k) { return sc[(row0 + r) * SC + k]; },
        [&](int k, int j) { return ss[k * SX + col0 + j]; });
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + g + 8 * half;
      if (r >= rows) continue;
      const float e = se[r];
      T* out = y + (row_dt + static_cast<int64_t>(r) * d.heads) * P + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        put2(out + 8 * n, intra[n][2 * half] + e * inter[n][2 * half],
             intra[n][2 * half + 1] + e * inter[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// stage 3 of S2: the chunk-local terms
// ---------------------------------------------------------------------------

// One head's tiles of stage 3: x and dy (L x P), states[c] and dS[c]
// (N x P), each with row stride P + 4.
template <int N, int P>
__host__ __device__ constexpr int head_floats() {
  return 2 * kL * (P + 4) + 2 * N * (P + 4);
}

template <int N, int P>
__host__ __device__ constexpr int bwd_floats() {
  return 2 * kL * (kL + 4) + 2 * kL * (N + 4) + 2 * head_floats<N, P>() + 2 * 5 * kL +
         12 * kL + kWarps;
}

// Asynchronous copies to shared memory (f32): `full` false fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// stage(), by cp.async for f32; bf16 is widened as it is staged, at once.
template <int W, int SD>
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src,
                                            int64_t pitch, int rows, int nrows = kL) {
  constexpr int Q = W / 4;
  for (int i = threadIdx.x; i < nrows * Q; i += kThreads) {
    const int r = i / Q, c = 4 * (i - r * Q);
    cp_async16(dst + r * SD + c, src + (r < rows ? r * pitch + c : 0), r < rows);
  }
}
template <int W, int SD>
__device__ __forceinline__ void stage_async(float* dst, const __nv_bfloat16* __restrict__ src,
                                            int64_t pitch, int rows, int nrows = kL) {
  stage<W, SD>(dst, src, pitch, rows, nrows);
}

// Grid (chunk, batch row, head group). C B^T (from stage 1), B and C are
// staged once; each head's x, dy, states[c] and dS[c] are copied while the
// head before is computed (two buffers), and its decays formed by warp 1
// then. Per head:
//   A. each warp: its part of G (to shared memory) and of Q's row and
//      column sums; of dxf = M^T dy + w (B dS), with dx and the rows' dxf .
//      x; of dC's and dB's state terms e (dy S^T) and w (xf dS^T), kept in
//      registers, with the rows' dots against C and B; and <S, dS>;
//   B. each warp: dC += G B + its state term and dB += G^T C + its state
//      term, in registers over the group's heads in order;
//   C. warp 0, beside B: dg, its reverse cumulative sum (a warp scan),
//      d(dt), and dA's partial of (b, h, c).
// After the last head, dB's and dC's sums over the group go to the group's
// partials (B, groups, S, N).
template <int N, int P, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ states,
                     const T* __restrict__ dy, const float* __restrict__ ds,
                     const float* __restrict__ cb, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ da_part,
                     float* __restrict__ db_part, float* __restrict__ dc_part, Dims d) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int SA = kL + 4, SN = N + 4, SP = P + 4;
  constexpr int NTL = kL / 16, NTP = P / 16, NTN = N / 16;  // column tiles of a warp's half
  extern __shared__ float4 smem4[];
  float* scb = reinterpret_cast<float*>(smem4);  // C B^T, L x L
  float* sgg = scb + kL * SA;                     // G, L x L
  float* sb = sgg + kL * SA;                      // B, L x N
  float* sc = sb + kL * SN;                       // C, L x N
  float* heads = sc + kL * SN;                    // two buffers of head_floats
  float* decay = heads + 2 * head_floats<N, P>();  // two buffers of dt, g (f64), e, w
  float* rowq = decay + 2 * 5 * kL;  // per column half and row: Q's row sums
  float* colq = rowq + 2 * kL;       // per row slice and column: Q's column sums
  float* rdx = colq + 4 * kL;        // per column half and row: dxf . x
  float* rread = rdx + 2 * kL;       //   C . e (dy S^T)
  float* rr = rread + 2 * kL;        //   B . w (xf dS^T)
  float* sdot = rr + 2 * kL;         // per warp: its share of <S, dS>

  const int c = blockIdx.x, b = blockIdx.y, t0 = c * d.chunk;
  const int rows = min(d.chunk, d.seq - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rs = warp_slice(), ch = warp_half(), row0 = 16 * rs;
  const int colL = ch * (kL / 2), colP = ch * (P / 2), colN = ch * (N / 2);
  const int64_t bc0 = (static_cast<int64_t>(b) * d.seq + t0) * N;
  const int h0 = blockIdx.z * d.group;
  auto row_of = [&](int h) {  // (b, t0, h) of a (B, S, H) tensor
    return (static_cast<int64_t>(b) * d.seq + t0) * d.heads + h;
  };
  auto fetch = [&](int i) {  // head h0 + i's tiles into buffer i % 2
    const int h = h0 + i;
    const int64_t bh = static_cast<int64_t>(b) * d.heads + h;
    float* buf = heads + (i & 1) * head_floats<N, P>();
    stage_async<P, SP>(buf, x + row_of(h) * P, static_cast<int64_t>(d.heads) * P, rows);
    stage_async<P, SP>(buf + kL * SP, dy + row_of(h) * P, static_cast<int64_t>(d.heads) * P,
                       rows);
    stage_async<P, SP>(buf + 2 * kL * SP, states + (bh * d.nc + c) * N * P, P, N, N);
    stage_async<P, SP>(buf + 2 * kL * SP + N * SP, ds + (bh * d.nc + c) * N * P, P, N, N);
    cp_commit();
  };
  auto form_decays = [&](int i) {  // by one warp: head h0 + i's into buffer i % 2
    float* dk = decay + (i & 1) * 5 * kL;
    decays(dk, reinterpret_cast<double*>(dk + kL), dk + 3 * kL, dk + 4 * kL, dt,
           row_of(h0 + i), d.heads, rows, A[h0 + i]);
  };
  stage<kL, SA>(scb, cb + (static_cast<int64_t>(b) * d.nc + c) * kL * kL, kL, kL);
  stage<N, SN>(sb, bm + bc0, N, rows);
  stage<N, SN>(sc, cm + bc0, N, rows);
  fetch(0);
  if (warp == 1) form_decays(0);
  float dc_sum[NTN][4] = {}, db_sum[NTN][4] = {};

  for (int i = 0; i < d.group; ++i) {
    const int h = h0 + i;
    const int64_t row_dt = row_of(h);
    const int64_t bh = static_cast<int64_t>(b) * d.heads + h;
    cp_wait_all();
    __syncthreads();  // head i's tiles and decays are in; head i - 1 is done
    if (i + 1 < d.group) fetch(i + 1);
    const float* sx = heads + (i & 1) * head_floats<N, P>();
    const float* sdy = sx + kL * SP;
    const float* ss = sdy + kL * SP;
    const float* sds = ss + N * SP;
    const float* sdt = decay + (i & 1) * 5 * kL;
    const double* sg = reinterpret_cast<const double*>(sdt + kL);
    const float* se = sdt + 3 * kL;
    const float* sw = se + kL;

    // A. G = (dy xf^T) exp(g_t - g_j), j <= t, and Q = G C B^T (j < t)
    {
      float acc[NTL][4] = {};
      mma_tile<NTL, kExact, false>(
          acc, 0, P, lower_tiles<NTL>(rs, colL),
          [&](int r, int k) { return sdy[(row0 + r) * SP + k]; },
          [&](int k, int j) { return sx[(colL + j) * SP + k] * sdt[colL + j]; });
      float qr[2] = {0.f, 0.f}, qc[NTL][2] = {};  // the lane's rows' and columns' sums
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tr = row0 + g + 8 * (e >> 1), j = colL + 8 * n + 2 * t + (e & 1);
          const float v = acc[n][e] * pair_decay(sg, tr, j);
          sgg[tr * SA + j] = v;
          const float q = j < tr ? v * scb[tr * SA + j] : 0.f;
          qr[e >> 1] += q;
          qc[n][e & 1] += q;
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v = quad_sum(qr[half]);
        if (t == 0) rowq[ch * kL + row0 + g + 8 * half] = v;
      }
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = qc[n][k];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (g == 0) colq[rs * kL + colL + 8 * n + 2 * t + k] = v;
        }
    }
    // dxf = M^T dy + w (B dS): rows j, M^T_jt = C B^T_tj exp(g_t - g_j), t >= j
    {
      float mdy[NTP][4] = {}, bds[NTP][4] = {};
      mma_tile<NTP, false, kExact>(
          mdy, row0, kL, NTP,
          [&](int r, int k) {
            const int j = row0 + r;
            return scb[k * SA + j] * pair_decay(sg, k, j);
          },
          [&](int k, int j) { return sdy[k * SP + colP + j]; });
      mma_tile<NTP, kExact, false>(
          bds, 0, N, NTP, [&](int r, int k) { return sb[(row0 + r) * SN + k]; },
          [&](int k, int j) { return sds[k * SP + colP + j]; });
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + g + 8 * half;
        const float w = sw[r], dtr = sdt[r];
        float* out = dx + (row_dt + static_cast<int64_t>(r) * d.heads) * P + colP + 2 * t;
        float dot = 0.f;
#pragma unroll
        for (int n = 0; n < NTP; ++n) {
          const float v0 = mdy[n][2 * half] + w * bds[n][2 * half];
          const float v1 = mdy[n][2 * half + 1] + w * bds[n][2 * half + 1];
          const int p = colP + 8 * n + 2 * t;
          dot += v0 * sx[r * SP + p] + v1 * sx[r * SP + p + 1];
          if (r < rows) put2(out + 8 * n, v0 * dtr, v1 * dtr);
        }
        dot = quad_sum(dot);
        if (t == 0) rdx[ch * kL + r] = dot;
      }
    }
    // dC's and dB's state terms, e (dy S^T) and w (xf dS^T), and the rows'
    // dots C . e (dy S^T) and B . w (xf dS^T)
    float cs[NTN][4] = {}, bs[NTN][4] = {};
    mma_tile<NTN, kExact, false>(
        cs, 0, P, NTN, [&](int r, int k) { return sdy[(row0 + r) * SP + k]; },
        [&](int k, int j) { return ss[(colN + j) * SP + k]; });
    mma_tile<NTN, false, false>(
        bs, 0, P, NTN,
        [&](int r, int k) { return sx[(row0 + r) * SP + k] * sdt[row0 + r]; },
        [&](int k, int j) { return sds[(colN + j) * SP + k]; });
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + g + 8 * half;
      const float e = se[r], w = sw[r];
      float read = 0.f, rsum = 0.f;
#pragma unroll
      for (int n = 0; n < NTN; ++n)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int col = colN + 8 * n + 2 * t + k;
          cs[n][2 * half + k] *= e;
          bs[n][2 * half + k] *= w;
          read += sc[r * SN + col] * cs[n][2 * half + k];
          rsum += sb[r * SN + col] * bs[n][2 * half + k];
        }
      read = quad_sum(read);
      rsum = quad_sum(rsum);
      if (t == 0) {
        rread[ch * kL + r] = read;
        rr[ch * kL + r] = rsum;
      }
    }
    // <S, dS>
    {
      float dot = 0.f;
      for (int k = threadIdx.x; k < N * P; k += kThreads) {
        const int at = (k / P) * SP + k % P;
        dot += ss[at] * sds[at];
      }
      dot = warp_sum(dot);
      if (lane == 0) sdot[warp] = dot;
    }
    __syncthreads();

    // C. dg, da = its reverse cumulative sum, d(dt), dA's partial; and the
    // next head's decays
    if (warp == 0) {
      const int r0 = 2 * lane;
      float dg[2], rt[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = r0 + k;
        rt[k] = rr[r] + rr[kL + r];
        const float col = ((colq[r] + colq[kL + r]) + colq[2 * kL + r]) + colq[3 * kL + r];
        dg[k] = (rowq[r] + rowq[kL + r]) - col - rt[k] + (rread[r] + rread[kL + r]);
      }
      const float r_all = warp_sum(rt[0] + rt[1]);
      if (lane == 31) {
        float s_ds = 0.f;
        for (int w = 0; w < kWarps; ++w) s_ds += sdot[w];
        dg[1] += se[kL - 1] * s_ds + r_all;
      }
      float incl = dg[0] + dg[1];  // the suffix sum from the lane's rows on
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
      const float da1 = after + dg[1], da0 = da1 + dg[0];
      const float das[2] = {da0, da1};
      const float a = A[h];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = r0 + k;
        if (r < rows)
          ddt[row_dt + static_cast<int64_t>(r) * d.heads] = das[k] * a + (rdx[r] + rdx[kL + r]);
      }
      const float part = warp_sum(da0 * sdt[r0] + da1 * sdt[r0 + 1]);
      if (lane == 0) da_part[bh * d.nc + c] = part;
    } else if (warp == 1 && i + 1 < d.group) {
      form_decays(i + 1);
    }

    // B. dC += G B + e (dy S^T); dB += G^T C + w (xf dS^T)
    {
      float gb[NTN][4] = {}, gc[NTN][4] = {};
      mma_tile<NTN, false, kExact>(
          gb, 0, row0 + 16, NTN, [&](int r, int k) { return sgg[(row0 + r) * SA + k]; },
          [&](int k, int j) { return sb[k * SN + colN + j]; });
      mma_tile<NTN, false, kExact>(
          gc, row0, kL, NTN, [&](int r, int k) { return sgg[k * SA + row0 + r]; },
          [&](int k, int j) { return sc[k * SN + colN + j]; });
#pragma unroll
      for (int n = 0; n < NTN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dc_sum[n][e] += gb[n][e] + cs[n][e];
          db_sum[n][e] += gc[n][e] + bs[n][e];
        }
    }
  }
  const int64_t part = (static_cast<int64_t>(b) * gridDim.z + blockIdx.z) * d.seq + t0;
  store_tile<NTN>(db_part + part * N, N, db_sum, row0, colN, rows);
  store_tile<NTN>(dc_part + part * N, N, dc_sum, row0, colN, rows);
}

// ---------------------------------------------------------------------------
// stage 4 of S2: the sums over head groups, batch rows and chunks
// ---------------------------------------------------------------------------

// dB and dC (B, S, N): the groups' partials summed in order; dA (H): the
// (batch row, chunk) partials summed in order.
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ db_part, const float* __restrict__ dc_part,
                  const float* __restrict__ da_part, float* __restrict__ dB,
                  float* __restrict__ dC, float* __restrict__ dA, Dims d, int state,
                  int groups) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t sn = static_cast<int64_t>(d.seq) * state;
  if (i < d.batch * sn) {
    const int64_t b = i / sn, rest = i - b * sn;
    float sb = 0.f, sc = 0.f;
    for (int z = 0; z < groups; ++z) {
      const int64_t at = (b * groups + z) * sn + rest;
      sb += db_part[at];
      sc += dc_part[at];
    }
    dB[i] = sb;
    dC[i] = sc;
  }
  if (i < d.heads) {
    float s = 0.f;
    for (int b = 0; b < d.batch; ++b)
      for (int c = 0; c < d.nc; ++c) s += da_part[(static_cast<int64_t>(b) * d.heads + i) * d.nc + c];
    dA[i] = s;
  }
}

static_assert(bwd_floats<64, 64>() * sizeof(float) <= 232448,
              "S2's tiles exceed an SM's shared memory");

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

// The largest divisor of `heads` that is at most `most`.
inline int group_of(int heads, int most) {
  for (int g = most; g > 1; --g)
    if (heads % g == 0) return g;
  return 1;
}

// The dimensions for the launches, or false if the kernels do not take them.
inline bool dims(int batch, int seq, int heads, int chunk, Dims* d) {
  if (chunk < 1 || chunk > kL || seq < 1 || batch < 1 || heads < 1 || batch > 65535)
    return false;
  *d = Dims{batch, seq, heads, chunk, (seq + chunk - 1) / chunk, 1};
  return true;
}

template <int N, int P, typename T>
int fwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm, void* y,
        void* states, const void* initial, void* final_state, void* cb, void* el, Dims d,
        void* stream) {
  const T *xt = static_cast<const T*>(x), *bt = static_cast<const T*>(bm),
          *ct = static_cast<const T*>(cm);
  const float *dtf = static_cast<const float*>(dt), *af = static_cast<const float*>(A);
  float *st = static_cast<float*>(states), *cbf = static_cast<float*>(cb),
        *elf = static_cast<float*>(el);
  Dims dsum = d;
  dsum.group = group_of(d.heads, kSumHeads);
  int err = launch(chunk_sum_kernel<N, P, T, false>,
                   dim3(d.nc, d.batch, d.heads / dsum.group + 1), sum_floats<N, P>(), stream, xt,
                   dtf, af, bt, ct, st, static_cast<float*>(final_state), elf, cbf, dsum);
  if (err) return err;
  err = launch(pass_kernel<false>, dim3(d.batch * d.heads, (N * P / 4 + kThreads - 1) / kThreads),
               0, stream, st, static_cast<const float*>(elf), static_cast<const float*>(initial),
               static_cast<float*>(final_state), d.nc, N * P);
  if (err) return err;
  Dims dout = d;
  dout.group = group_of(d.heads, kFwdHeads);
  return launch(fwd_out_kernel<N, P, T>, dim3(d.nc, d.batch, d.heads / dout.group),
                fwd_floats<N, P>(), stream, xt, dtf, af, ct, static_cast<const float*>(st),
                static_cast<const float*>(cbf), static_cast<T*>(y), dout);
}

template <int N, int P, typename T>
int bwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
        const void* states, const void* dy, const void* d_final, void* dx, void* ddt, void* dA,
        void* dB, void* dC, void* d_initial, void* cb, void* el, void* ds, void* da_part,
        void* db_part, void* dc_part, int group, Dims d, void* stream) {
  if (group < 1 || d.heads % group != 0 || d.heads / group > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const T *xt = static_cast<const T*>(x), *bt = static_cast<const T*>(bm),
          *ct = static_cast<const T*>(cm), *dyt = static_cast<const T*>(dy);
  const float *dtf = static_cast<const float*>(dt), *af = static_cast<const float*>(A);
  float *cbf = static_cast<float*>(cb), *elf = static_cast<float*>(el),
        *dsf = static_cast<float*>(ds);
  Dims dsum = d;
  dsum.group = group_of(d.heads, kSumHeads);
  int err = launch(chunk_sum_kernel<N, P, T, true>,
                   dim3(d.nc, d.batch, d.heads / dsum.group + 1), sum_floats<N, P>(), stream,
                   dyt, dtf, af, bt, ct, dsf, static_cast<float*>(d_initial), elf, cbf, dsum);
  if (err) return err;
  err = launch(pass_kernel<true>, dim3(d.batch * d.heads, (N * P / 4 + kThreads - 1) / kThreads),
               0, stream, dsf, static_cast<const float*>(elf), static_cast<const float*>(d_final),
               static_cast<float*>(d_initial), d.nc, N * P);
  if (err) return err;
  Dims dloc = d;
  dloc.group = group;
  const int groups = d.heads / group;
  err = launch(bwd_chunk_kernel<N, P, T>, dim3(d.nc, d.batch, groups), bwd_floats<N, P>(),
               stream, xt, dtf, af, bt, ct, static_cast<const float*>(states), dyt,
               static_cast<const float*>(dsf), static_cast<const float*>(cbf),
               static_cast<float*>(dx), static_cast<float*>(ddt), static_cast<float*>(da_part),
               static_cast<float*>(db_part), static_cast<float*>(dc_part), dloc);
  if (err) return err;
  const int64_t items = static_cast<int64_t>(d.batch) * d.seq * N;
  const int64_t most = items > d.heads ? items : d.heads;
  return launch(finish_kernel, dim3(static_cast<unsigned>((most + kThreads - 1) / kThreads)), 0,
                stream, static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
                static_cast<const float*>(da_part), static_cast<float*>(dB),
                static_cast<float*>(dC), static_cast<float*>(dA), d, N, groups);
}

// Call FN<N, P, T>(args...) for the runtime state size, head_dim and dtype:
// (16, 32), the reduced zamba2-1.2b, or (64, 64), the full one; any other
// pair is cudaErrorInvalidValue.
#define DISPATCH(state, head_dim, bf16, FN, ...)                                         \
  do {                                                                                   \
    if (state == 16 && head_dim == 32)                                                   \
      return bf16 ? FN<16, 32, __nv_bfloat16>(__VA_ARGS__) : FN<16, 32, float>(__VA_ARGS__); \
    if (state == 64 && head_dim == 64)                                                   \
      return bf16 ? FN<64, 64, __nv_bfloat16>(__VA_ARGS__) : FN<64, 64, float>(__VA_ARGS__); \
    return static_cast<int>(cudaErrorInvalidValue);                                      \
  } while (0)

template <int N, int P, typename T>
int launch_config(int which, int* out) {
  switch (which) {
    case 0: return launch_resources(chunk_sum_kernel<N, P, T, false>, kThreads,
                                    sizeof(float) * sum_floats<N, P>(), out);
    case 1: return launch_resources(pass_kernel<false>, kThreads, 0, out);
    case 2: return launch_resources(fwd_out_kernel<N, P, T>, kThreads,
                                    sizeof(float) * fwd_floats<N, P>(), out);
    case 3: return launch_resources(chunk_sum_kernel<N, P, T, true>, kThreads,
                                    sizeof(float) * sum_floats<N, P>(), out);
    case 4: return launch_resources(pass_kernel<true>, kThreads, 0, out);
    case 5: return launch_resources(bwd_chunk_kernel<N, P, T>, kThreads,
                                    sizeof(float) * bwd_floats<N, P>(), out);
    case 6: return launch_resources(finish_kernel, kThreads, 0, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// S1, from initial (null: zeros), into final (null: not formed). Scratch:
// cb (B, chunks, 64, 64) f32, el (B, H, chunks) f32.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
            void* y, void* states, const void* initial, void* final_state, void* cb, void* el,
            int batch, int seq, int heads, int head_dim, int state, int chunk, int bf16,
            void* stream) {
  Dims d;
  if (!dims(batch, seq, heads, chunk, &d)) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(state, head_dim, bf16, fwd, x, dt, A, bm, cm, y, states, initial, final_state, cb, el,
           d, stream);
}

// S2, from d_final (null: zeros), into d_initial (null: not formed), with
// heads_per_block heads a block of its chunk-local stage (a divisor of
// heads). Scratch: cb and el as S1's, ds (B, H, chunks, N, P) f32, da_part
// (B, H, chunks) f32, db_part and dc_part (B, H / heads_per_block, S, N) f32.
int ssd_bwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
            const void* states, const void* dy, const void* d_final, void* dx, void* ddt,
            void* dA, void* dB, void* dC, void* d_initial, void* cb, void* el, void* ds,
            void* da_part, void* db_part, void* dc_part, int batch, int seq, int heads,
            int head_dim, int state, int chunk, int heads_per_block, int bf16, void* stream) {
  Dims d;
  if (!dims(batch, seq, heads, chunk, &d)) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(state, head_dim, bf16, bwd, x, dt, A, bm, cm, states, dy, d_final, dx, ddt, dA, dB,
           dC, d_initial, cb, el, ds, da_part, db_part, dc_part, heads_per_block, d, stream);
}

// The resources of S1's kernels (which 0-2: chunk sums, pass, outputs) and
// S2's (3-6: chunk sums, pass, chunk-local terms, sums) at the state size,
// head_dim and dtype (see launch_resources()).
int ssd_scan_launch_config(int which, int state, int head_dim, int bf16, void* out) {
  DISPATCH(state, head_dim, bf16, launch_config, which, static_cast<int*>(out));
}

}  // extern "C"
