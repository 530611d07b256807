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
// causal, qpos - kpos >= window), query row i sitting at qpos = i + q_offset
// (the reference's attention(q_offset=): a query block that continues a
// sequence whose keys come first; 0 for training); over kv tiles in order the
// online softmax
// m' = max(m, rowmax s), p = exp(s - m'), corr = exp(m - m'), l = l*corr +
// rowsum p, acc = acc*corr + p.v; O = acc / max(l, 1e-30). The backward
// recomputes P = exp(S - lse) (0 where masked: exp(-1e30 - lse) is 0) and
// forms dV = P^T dO, dP = dO V^T, dS = P * (dP - delta), dQ = scale * dS K,
// dK = scale * dS^T q. The kernels form s as scale * (q . k), the same
// function rounded once more.
//
// Skipped pairs. A kernel does not visit a stage of kv rows (F1, F4) or q
// rows (F3) in which none of a warp's pairs is visible. For F1 the result is
// B4's, bit for bit as far as the online softmax goes: in B4 such keys either
// come after a visible key, where p = exp(-1e30 - m) = 0 and corr = 1, or
// before one, where the visible key's corr = exp(-1e30 - m) = 0 wipes what
// they added to l and acc. This needs every query row to see at least one
// key, which fails only for q_offset + Sq > Skv + window - 1, or under the
// causal mask for q_offset < 0; the wrapper refuses those cases. In the
// backward the skipped pairs' P is all 0. The offset moves every tile range
// below by q_offset positions and changes no arithmetic: at 0 the kernels
// are the offset-free ones, launch for launch and bit for bit.
//
// F1, F3 and F4: the products on the tensor cores in split TF32. Every
// product (F1: S = q K^T, O += P V; F3: S^T = K q^T, dP^T = V dO^T, dV +=
// P^T dO, dK += dS^T q; F4: S = q K^T, dP = dO V^T, dQ += dS K; the scale
// applied to S, dK and dQ afterwards, in f32, so that a bf16 q stays exact in
// TF32) is mma.sync m16n8k8 with TF32 operands in three terms: each f32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (rounded to
// nearest, ties away), and lo.hi and hi.lo go into the accumulator before
// hi.hi. A bf16 input is exact in TF32: its lo is 0 and its terms are
// skipped; P and dS are f32 and always split. Plain TF32 (hi.hi alone) puts
// dQ, dK and dV at 5.6e-4, 5.5e-4 and 4.2e-4 relative norm of the f32 plain
// versions at the main shape on the H100, over the limit of 1e-4; the split
// form 8.4e-7, 1.2e-6 and 1.1e-6. F1's O in plain TF32 misses its limit of
// 2e-5 of max |O| too: emulated on the CPU (tests/test_torch_flash_attention.py)
// it lands at 4.2e-4 of max |O|, the split form at 3.8e-7. The tensor cores add with truncation: one accumulator
// carried over a long sum lost 1.3e-4 (dK at h2o-danube-1.8b's shape, S =
// 5120), so each stage's products go to a fresh accumulator that is added to
// the running sum in f32 (2.6e-6 there; tools/flash_attention_forms.py
// measures each of these choices against the source).
//   A block's warps hold 16 resident rows each (F1 and F4 q rows, F3 kv
// rows) and the other side streams by in stages of 16 rows, double-buffered
// with cp.async (16 bytes a thread; lse and delta 4): F1 and F4 stream k and
// v, F3 q, dO, lse and delta of each q head of the kv head's group. Tiles
// are f32 in shared memory (bf16 widened when staged) with a row stride of
// D + 4: every fragment load is a float4 (F1's P, F3's P^T and dS^T, F4's dS
// stay in registers: the mma's accumulator layout is read as the next
// product's A operand with its k permuted, and B's rows in the same order)
// and free of bank conflicts. F1 keeps each row's running max m, its lane's
// share of the sum l and its 16 x D output O in registers; a stage's S is
// scaled and masked and turned into P = exp(S - m') in the accumulators, O
// is multiplied by corr = exp(m - m'), and the stage's P V, formed in fresh
// accumulators, is added to it in f32. F3's dK and dV stay in registers over
// the whole walk and the GQA group's sum is formed there: no atomics, the
// same bits every run.
//   Filling the card. F1's and F4's grids take the q tiles from the last,
// the long ones under the causal mask first. F3's block holds two kv tiles,
// kt and nk - 1 - kt, one per group of 4 warps with its own shared memory
// and named barrier, so that every block has the same causal work (a kv tile
// a block leaves the SMs that drew two long tiles to finish last); at D =
// 128 its 128 accumulator registers a thread leave room for one block (8
// warps) an SM (203,264 bytes of shared memory, 255 registers a thread).
// F4's block has 4 warps, 101,376 bytes and 179 registers at D = 128: two
// blocks an SM. F1's has 4 warps and 67,584 bytes at D = 128 (q, and two
// stages of k and v).
//
// F2 is a warp per row, on FMAs.
//
// Bound: operations. Per visible (q, k) pair F1 does 4*D flops (two
// products), F3 8*D (scores, dP, dV, dK) and F4 6*D (scores, dP, dQ),
// against about 4 bytes a row element moved. At the main path's shapes (S =
// 1024, D = 128) the products over the card's 67 TFLOP/s f32 rate take F1
// 0.1283 ms, F3 0.2567 ms and F4 0.1925 ms, and in split TF32 (three times
// the products over 495 TFLOP/s) 0.0521, 0.1042 and 0.0782 ms, against bytes
// at 3.35 TB/s of a tenth of that. F2 is bound by its bytes. Shared memory
// above the 48 KiB default is set with cudaFuncSetAttribute below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_config.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // B4's NEG_INF, not -inf
constexpr int kThreads = 256;      // F2: a warp per row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Dims {
  int batch, sq, skv, hq, hkv, causal, window;  // window <= 0: no window
  float scale;
  int q_offset;  // query row i sits at position i + q_offset
};

// Offset of element (b, s, h, 0) of a contiguous (B, S, H, D) tensor.
template <int D>
__device__ __forceinline__ int64_t row_offset(int b, int s, int h, int S, int H) {
  return ((static_cast<int64_t>(b) * S + s) * H + h) * D;
}

// Whether query row `qrow` (at position qrow + q_offset) sees key kpos.
__device__ __forceinline__ bool visible(int qrow, int kpos, const Dims& d) {
  const int qpos = qrow + d.q_offset;
  return kpos < d.skv && (!d.causal || qpos >= kpos) &&
         (d.window <= 0 || qpos - kpos < d.window);
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

// ---------------------------------------------------------------------------
// F1, F3 and F4: the products on the tensor cores in split TF32
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps, 16 resident rows each
constexpr int kMmaRows = 64;      // resident rows of a block: F1's and F4's q tile, F3's kv tile
constexpr int kStage = 16;        // streamed rows a stage: F3's q rows, F4's kv rows
constexpr int kDkdvGroups = 2;    // F3: kv tiles a block, one a group of kMmaThreads

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as f32 bits:
// cvt.rna.tf32.f32's rounding for every finite x, in two integer operations:
// ptxas expands the cvt into a compare-and-select sequence, which made F3
// and F4 about a quarter slower for the same bits (tools/flash_attention_forms.py
// times both; PERF.md records it).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// One mma operand: hi = tf32(x) and lo = tf32(x - hi). An operand exact in
// TF32 (a bf16 input) keeps lo unused.
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

// c += a . b in split TF32: a.lo b.hi and a.hi b.lo first, then a.hi b.hi,
// all into the f32 accumulator. The lo terms of an exact operand are 0 and
// skipped.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[4], const Split (&a)[4], const Split (&b)[2]) {
  if (!kExactA) mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  if (!kExactB) mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// c[n] += A . B_n^T over the D columns: A the warp's 16 rows at a, B_n the
// 8 rows at b + 8n * (D + 4), f32 in shared memory with row stride D + 4.
// The mma's k is permuted so that a lane reads its columns as float4s, free
// of bank conflicts: in a block of 32 columns lane t holds 8t .. 8t+7 and k
// step s takes 8t+2s and 8t+2s+1 as the mma's k = t and t+4 (in the 16
// columns past the last whole block, D = 80, lane t holds 4t .. 4t+3). Each
// block's products go to a fresh accumulator, added to c in f32. The blocks
// are unrolled kUnroll at a time: F3's dK and dV hold 128 registers a thread
// at D = 128, and F3 unrolls two, since unrolled in full it spills
// (tools/flash_attention_forms.py times both and the loop); F4's dQ holds 64
// and F4 unrolls in full.
template <int D, int NT, bool kExact, int kUnroll>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const float* a, const float* b,
                                       int lane) {
  constexpr int P = D + 4;
  static_assert(D % 32 == 0 || D % 32 == 16, "head_dim");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll(kUnroll)
  for (int c0 = 0; c0 < D; c0 += 32) {
    constexpr int kW = 8;                         // columns a lane holds in a whole block
    const int w = c0 + 32 <= D ? kW : kW / 2;     // in the 16-column tail
    float av[2][kW], bv[NT][kW];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 0; x < kW; x += 4) {
        if (x >= w) break;
        const float4 v4 = lds4(a + (g + 8 * r) * P + c0 + w * t + x);
        av[r][x] = v4.x; av[r][x + 1] = v4.y; av[r][x + 2] = v4.z; av[r][x + 3] = v4.w;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int x = 0; x < kW; x += 4) {
        if (x >= w) break;
        const float4 v4 = lds4(b + (8 * n + g) * P + c0 + w * t + x);
        bv[n][x] = v4.x; bv[n][x + 1] = v4.y; bv[n][x + 2] = v4.z; bv[n][x + 3] = v4.w;
      }
    float part[NT][4] = {};
#pragma unroll
    for (int s = 0; s < kW / 2; ++s) {
      if (2 * s >= w) break;
      const Split af[4] = {operand<kExact>(av[0][2 * s]), operand<kExact>(av[1][2 * s]),
                           operand<kExact>(av[0][2 * s + 1]),
                           operand<kExact>(av[1][2 * s + 1])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const Split bf[2] = {operand<kExact>(bv[n][2 * s]), operand<kExact>(bv[n][2 * s + 1])};
        mma3<kExact, kExact>(part[n], af, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += part[n][e];
  }
}

// c[n] += F . B over B's 16 rows (at b, stride D + 4), for the D / 8 column
// tiles n of B. F is a 16 x 16 product of the warp, held as the mma's
// accumulators f[j][e] of its column tiles j (split here). As an A operand, k step
// j takes F's columns 8j+2t and 8j+2t+1 (where lane t holds them) as the
// mma's k = t and t+4, so B's rows are read in that order. The n index is
// permuted so that a lane's B values of four n tiles are one float4: in a
// block of 32 columns, tile 4J+i's column n is 32J + 4n + i (in the 16
// columns past the last whole block, tile 2J+i's is 32J + 2n + i), and the
// accumulator c[4J+i][e] holds output column 32J + 8t + 4(e & 1) + i. The
// 16 rows' products go to a fresh accumulator, added to c in f32.
template <int D, bool kExactB>
__device__ __forceinline__ void mma_rn(float (&c)[D / 8][4], const float (&f)[2][4],
                                       const float* b, int lane) {
  constexpr int P = D + 4;
  const int g = lane >> 2, t = lane & 3;
  Split af[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    af[j][0] = operand<false>(f[j][0]);
    af[j][1] = operand<false>(f[j][2]);
    af[j][2] = operand<false>(f[j][1]);
    af[j][3] = operand<false>(f[j][3]);
  }
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int w = c0 + 32 <= D ? 4 : 2;  // n tiles in this block of columns
    float bv[2][2][4];                    // [k step j][b0, b1][tile i]
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* row = b + (8 * j + 2 * t + r) * P + c0;
        if (w == 4) {
          const float4 v4 = lds4(row + 4 * g);
          bv[j][r][0] = v4.x; bv[j][r][1] = v4.y; bv[j][r][2] = v4.z; bv[j][r][3] = v4.w;
        } else {
          const float2 v2 = *reinterpret_cast<const float2*>(row + 2 * g);
          bv[j][r][0] = v2.x; bv[j][r][1] = v2.y;
        }
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= w) break;
      float part[4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const Split bf[2] = {operand<kExactB>(bv[j][0][i]), operand<kExactB>(bv[j][1][i])};
        mma3<false, kExactB>(part, af[j], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) c[c0 / 8 + i][e] += part[e];
    }
  }
}

// Row `half` (0: g, 1: g + 8) of mma_rn's accumulators, times mul, to the
// output row at dst (D elements of T).
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
template <int D, typename T>
__device__ __forceinline__ void store_row(T* dst, const float (&c)[D / 8][4], int half, int t,
                                          float mul) {
  const int e = 2 * half;
#pragma unroll
  for (int c0 = 0; c0 + 32 <= D; c0 += 32) {
    const int n = c0 / 8;
    store4(dst + c0 + 8 * t, c[n][e] * mul, c[n + 1][e] * mul, c[n + 2][e] * mul,
           c[n + 3][e] * mul);
    store4(dst + c0 + 8 * t + 4, c[n][e + 1] * mul, c[n + 1][e + 1] * mul,
           c[n + 2][e + 1] * mul, c[n + 3][e + 1] * mul);
  }
  if constexpr (D % 32 != 0) {
    constexpr int c0 = D - 16, n = c0 / 8;
    store4(dst + c0 + 4 * t, c[n][e] * mul, c[n + 1][e] * mul, c[n][e + 1] * mul,
           c[n + 1][e + 1] * mul);
  }
}

// Asynchronous copies to shared memory; `full` false fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Four elements of a row into shared memory as f32: f32 by cp.async, bf16
// (4 x 2 bytes) loaded, widened and stored here.
__device__ __forceinline__ void stage4(float* dst, const float* src, bool full) {
  cp_async16(dst, src, full);
}
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src, bool full) {
  uint2 u = make_uint2(0u, 0u);
  if (full) u = __ldg(reinterpret_cast<const uint2*>(src));
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Rows [row0, row0 + R) of head h of a (B, S, H, D) tensor into shared
// memory (stride D + 4), zero past row S - 1, by the kMmaThreads threads
// tid of a group.
template <int D, int R, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int b, int row0, int S,
                                           int h, int H, int tid) {
  constexpr int P = D + 4, C = D / 4;
  for (int i = tid; i < R * C; i += kMmaThreads) {
    const int r = i / C, c = i - (i / C) * C, s = row0 + r;
    const bool in = s < S;
    stage4(dst + r * P + 4 * c, src + (in ? row_offset<D>(b, s, h, S, H) + 4 * c : 0), in);
  }
}

// kStage per-row values (lse or delta, (B, H, S)) from row0, zero past S - 1,
// by the threads tid in [lane0, lane0 + kStage).
__device__ __forceinline__ void stage_vals(float* dst, const float* src, int b, int h, int row0,
                                           int S, int H, int tid, int lane0) {
  const int i = tid - lane0;
  if (i < 0 || i >= kStage) return;
  const bool in = row0 + i < S;
  cp_async4(dst + i, src + (in ? (static_cast<int64_t>(b) * H + h) * S + row0 + i : 0), in);
}

// Whether some pair of the q rows [qa, qa + nq) and kv rows [ka, ka + nk)
// is visible.
__device__ __forceinline__ bool tile_sees(int qa, int nq, int ka, int nk, const Dims& d) {
  const int qb = min(qa + nq, d.sq) - 1, kb = min(ka + nk, d.skv) - 1;
  if (qb < qa || kb < ka) return false;
  const int pa = qa + d.q_offset, pb = qb + d.q_offset;  // the rows' positions
  if (d.causal && pb - ka < 0) return false;             // every q - kv < 0
  if (d.window > 0 && pa - kb >= d.window) return false;  // every q - kv >= window
  return true;
}

// A barrier of the kMmaThreads threads of group `id` (1 + the group's index;
// 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kMmaThreads) : "memory");
}

// The kv stages [lo, hi) of kStage rows that hold a key visible to some row
// of the q tile of kMmaRows rows starting at q0 (F1's and F4's walk), the
// rows at positions q0 + q_offset on.
__device__ __forceinline__ void kv_stages(int q0, const Dims& d, int* lo, int* hi) {
  const int nst = (d.skv + kStage - 1) / kStage;
  const int p0 = q0 + d.q_offset, p_last = min(q0 + kMmaRows, d.sq) - 1 + d.q_offset;
  *lo = d.window > 0 ? max(0, p0 - d.window + 1) / kStage : 0;
  *hi = !d.causal ? nst : p_last < 0 ? 0 : min(nst, p_last / kStage + 1);
}

// The block of F1 and F4 for blockIdx.x: its q tile's first row (the tiles
// taken from the last, so that the long ones under the causal mask start
// first), q head and batch row.
__device__ __forceinline__ void q_tile_block(const Dims& d, int* q0, int* h, int* b) {
  const int heads = d.hq * d.batch, nq = (d.sq + kMmaRows - 1) / kMmaRows;
  const int rank = blockIdx.x / heads, rest = blockIdx.x - rank * heads;
  *h = rest % d.hq;
  *b = rest / d.hq;
  *q0 = (nq - 1 - rank) * kMmaRows;
}

// F1's shared memory: the q tile; two stages of k and v.
template <int D>
__host__ __device__ constexpr int fwd_floats() {
  return kMmaRows * (D + 4) + 4 * kStage * (D + 4);
}

// F1: one block per (q tile, q head, batch). Each warp holds 16 q rows with
// their running max m, its lanes' shares of the sum l and the output O in
// registers; the kv rows stream by in stages of kStage, double-buffered.
// Per stage: S = q K^T, scaled and masked; m' = max(m, rowmax S); P =
// exp(S - m') in S's accumulators; corr = exp(m - m'); l = l corr + rowsum
// P; O = O corr + P V, P V in fresh accumulators.
template <int D, typename T>
__global__ void __launch_bounds__(kMmaThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, Dims d) {
  constexpr int P = D + 4, NT = D / 8;
  constexpr bool kExact = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kMmaRows * P;    // [2][kStage * P]
  float* vs = ks + 2 * kStage * P;  // [2][kStage * P]
  int q0, h, b;
  q_tile_block(d, &q0, &h, &b);
  const int hk = h / (d.hq / d.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int qr0 = q0 + 16 * warp;  // the warp's q rows: g and g + 8 of them a lane's

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int st_lo, st_hi;
  kv_stages(q0, d, &st_lo, &st_hi);
  const int items = max(0, st_hi - st_lo);
  auto issue = [&](int i) {
    const int buf = i & 1, k0 = (st_lo + i) * kStage;
    stage_rows<D, kStage>(ks + buf * kStage * P, k, b, k0, d.skv, hk, d.hkv, threadIdx.x);
    stage_rows<D, kStage>(vs + buf * kStage * P, v, b, k0, d.skv, hk, d.hkv, threadIdx.x);
  };
  if (items > 0) {
    stage_rows<D, kMmaRows>(qs, q, b, q0, d.sq, h, d.hq, threadIdx.x);
    issue(0);
    cp_commit();
  }
  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) {
      issue(i + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = i & 1, k0 = (st_lo + i) * kStage;
    if (tile_sees(qr0, 16, k0, kStage, d)) {
      float s[2][4] = {};  // S, then P: q rows x kv columns
      mma_nt<D, 2, kExact, D / 32 + 1>(s, qs + 16 * warp * P, ks + buf * kStage * P, lane);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1, qpos = qr0 + g + 8 * half;
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = qpos < d.sq && visible(qpos, kpos, d) ? s[j][e] * d.scale : kNegInf;
          mx[half] = fmaxf(mx[half], s[j][e]);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // the row's max over its 4 lanes
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        const float m_new = fmaxf(m[half], mx[half]);
        corr[half] = expf(m[half] - m_new);
        m[half] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] + sum[half];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      mma_rn<D, kExact>(acc, s, vs + buf * kStage * P, lane);
    }
    __syncthreads();  // every read of buffer buf is done before it is refilled
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);  // the row's sum over its 4 lanes
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int qpos = qr0 + g + 8 * half;
    if (qpos >= d.sq) continue;
    const float den = fmaxf(l[half], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][2 * half] /= den;
      acc[n][2 * half + 1] /= den;
    }
    store_row<D>(o + row_offset<D>(b, qpos, h, d.sq, d.hq), acc, half, t, 1.f);
    if (t == 0) lse[(static_cast<int64_t>(b) * d.hq + h) * d.sq + qpos] = m[half] + logf(l[half]);
  }
}

// F3's shared memory for one kv tile: k, v; two stages of q, dO, lse, delta.
template <int D>
__host__ __device__ constexpr int dkdv_floats() {
  return 2 * kMmaRows * (D + 4) + 4 * kStage * (D + 4) + 4 * kStage;
}

// F3: one block per (pair of kv tiles, kv head, batch), a group of 4 warps
// on each tile of the pair: kv tiles kt and nk - 1 - kt, so that under the
// causal mask every block has the same work (the middle tile of an odd count
// goes alone). Each warp holds 16 kv rows; the q rows of the group's heads
// stream by in stages of kStage, double-buffered.
template <int D, typename T>
__global__ void __launch_bounds__(kDkdvGroups * kMmaThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                Dims d) {
  constexpr int P = D + 4, NT = D / 8;
  constexpr bool kExact = sizeof(T) == 2;
  const int grp = threadIdx.x / kMmaThreads, tid = threadIdx.x % kMmaThreads;
  const int heads = d.hkv * d.batch, nk = (d.skv + kMmaRows - 1) / kMmaRows;
  const int pair = blockIdx.x / heads, rest = blockIdx.x - pair * heads;
  const int kt = grp == 0 ? pair : nk - 1 - pair;
  if (grp == 1 && kt == pair) return;  // the middle tile: group 0 has it
  const int hk = rest % d.hkv, b = rest / d.hkv;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4) + grp * dkdv_floats<D>();
  float* vs = ks + kMmaRows * P;
  float* qs = vs + kMmaRows * P;      // [2][kStage * P]
  float* dos = qs + 2 * kStage * P;   // [2][kStage * P]
  float* lses = dos + 2 * kStage * P; // [2][kStage]
  float* deltas = lses + 2 * kStage;  // [2][kStage]
  const int k0 = kt * kMmaRows, group = d.hq / d.hkv;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + 16 * warp;  // the warp's kv rows

  // the q stages with a row that sees a key of this tile, for each q head:
  // under the causal mask rows at k0 - q_offset on, under the window rows
  // up to k_last + window - 1 - q_offset
  const int nst = (d.sq + kStage - 1) / kStage;
  const int k_last = min(k0 + kMmaRows, d.skv) - 1;
  const int w_last = k_last + d.window - 1 - d.q_offset;
  const int st_lo = d.causal ? min(nst, max(0, k0 - d.q_offset) / kStage) : 0;
  const int st_hi = d.window <= 0 ? nst : w_last < 0 ? 0 : min(nst, w_last / kStage + 1);
  const int n_st = max(0, st_hi - st_lo), items = group * n_st;

  float dkr[NT][4], dvr[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkr[n][e] = dvr[n][e] = 0.f;

  auto issue = [&](int i) {  // item i: q head hk * group + i / n_st, stage st_lo + i % n_st
    const int buf = i & 1, h = hk * group + i / n_st, q0 = (st_lo + i % n_st) * kStage;
    stage_rows<D, kStage>(qs + buf * kStage * P, q, b, q0, d.sq, h, d.hq, tid);
    stage_rows<D, kStage>(dos + buf * kStage * P, dout, b, q0, d.sq, h, d.hq, tid);
    stage_vals(lses + buf * kStage, lse, b, h, q0, d.sq, d.hq, tid, 0);
    stage_vals(deltas + buf * kStage, delta, b, h, q0, d.sq, d.hq, tid, kStage);
  };
  if (items > 0) {
    stage_rows<D, kMmaRows>(ks, k, b, k0, d.skv, hk, d.hkv, tid);
    stage_rows<D, kMmaRows>(vs, v, b, k0, d.skv, hk, d.hkv, tid);
    issue(0);
    cp_commit();
  }
  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) {
      issue(i + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    group_sync(1 + grp);  // stage i is in shared memory for every thread of the group
    const int buf = i & 1, q0 = (st_lo + i % n_st) * kStage;
    const float* qb = qs + buf * kStage * P;
    const float* dob = dos + buf * kStage * P;
    const float* lb = lses + buf * kStage;
    const float* db = deltas + buf * kStage;
    if (tile_sees(q0, kStage, kr0, 16, d)) {
      // S^T, then P^T and dV; then dP^T, dS^T and dK: kv rows x q columns
      float pt[2][4] = {};
      mma_nt<D, 2, kExact, 2>(pt, ks + 16 * warp * P, qb, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kr0 + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
          const int qpos = q0 + col;
          pt[j][e] = qpos < d.sq && visible(qpos, kpos, d)
                         ? expf(pt[j][e] * d.scale - lb[col]) : 0.f;
        }
      mma_rn<D, kExact>(dvr, pt, dob, lane);
      float dst[2][4] = {};
      mma_nt<D, 2, kExact, 2>(dst, vs + 16 * warp * P, dob, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[j][e] = pt[j][e] * (dst[j][e] - db[8 * j + 2 * t + (e & 1)]);
      mma_rn<D, kExact>(dkr, dst, qb, lane);
    }
    group_sync(1 + grp);  // every read of buffer buf is done before it is refilled
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = kr0 + g + 8 * half;
    if (kpos >= d.skv) continue;
    const int64_t off = row_offset<D>(b, kpos, hk, d.skv, d.hkv);
    store_row<D>(dk + off, dkr, half, t, d.scale);
    store_row<D>(dv + off, dvr, half, t, 1.f);
  }
}

// F4: one block per (q tile, q head, batch), as F1. Each warp holds 16 q
// rows; the kv rows stream by in stages of kStage, double-buffered.
template <int D, typename T>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, Dims d) {
  constexpr int P = D + 4, NT = D / 8;
  constexpr bool kExact = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kMmaRows * P;
  float* ks = dos + kMmaRows * P;   // [2][kStage * P]
  float* vs = ks + 2 * kStage * P;  // [2][kStage * P]
  int q0, h, b;
  q_tile_block(d, &q0, &h, &b);
  const int hk = h / (d.hq / d.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int qr0 = q0 + 16 * warp;  // the warp's q rows

  float lse_r[2], delta_r[2], dqr[NT][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qr0 + g + 8 * half;
    const int64_t at = (static_cast<int64_t>(b) * d.hq + h) * d.sq + qpos;
    lse_r[half] = qpos < d.sq ? lse[at] : 0.f;
    delta_r[half] = qpos < d.sq ? delta[at] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqr[n][e] = 0.f;

  int st_lo, st_hi;
  kv_stages(q0, d, &st_lo, &st_hi);
  const int items = max(0, st_hi - st_lo);

  auto issue = [&](int i) {
    const int buf = i & 1, k0 = (st_lo + i) * kStage;
    stage_rows<D, kStage>(ks + buf * kStage * P, k, b, k0, d.skv, hk, d.hkv, threadIdx.x);
    stage_rows<D, kStage>(vs + buf * kStage * P, v, b, k0, d.skv, hk, d.hkv, threadIdx.x);
  };
  if (items > 0) {
    stage_rows<D, kMmaRows>(qs, q, b, q0, d.sq, h, d.hq, threadIdx.x);
    stage_rows<D, kMmaRows>(dos, dout, b, q0, d.sq, h, d.hq, threadIdx.x);
    issue(0);
    cp_commit();
  }
  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) {
      issue(i + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = i & 1, k0 = (st_lo + i) * kStage;
    const float* kb = ks + buf * kStage * P;
    const float* vb = vs + buf * kStage * P;
    if (tile_sees(qr0, 16, k0, kStage, d)) {
      float s[2][4] = {}, dp[2][4] = {};  // S and dP, then dS: q rows x kv columns
      mma_nt<D, 2, kExact, D / 32 + 1>(s, qs + 16 * warp * P, kb, lane);
      mma_nt<D, 2, kExact, D / 32 + 1>(dp, dos + 16 * warp * P, vb, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1, qpos = qr0 + g + 8 * half;
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const float p = qpos < d.sq && visible(qpos, kpos, d)
                              ? expf(s[j][e] * d.scale - lse_r[half]) : 0.f;
          dp[j][e] = p * (dp[j][e] - delta_r[half]);
        }
      mma_rn<D, kExact>(dqr, dp, kb, lane);
    }
    __syncthreads();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qr0 + g + 8 * half;
    if (qpos >= d.sq) continue;
    store_row<D>(dq + row_offset<D>(b, qpos, h, d.sq, d.hq), dqr, half, t, d.scale);
  }
}

template <int D>
constexpr size_t fwd_smem() { return fwd_floats<D>() * sizeof(float); }
template <int D>
constexpr size_t dkdv_smem() { return kDkdvGroups * dkdv_floats<D>() * sizeof(float); }
template <int D>
constexpr size_t dq_smem() {  // q, dO tiles; two stages of k, v
  return (2 * kMmaRows * (D + 4) + 4 * kStage * (D + 4)) * sizeof(float);
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }
inline int tiles(int n) { return (n + kMmaRows - 1) / kMmaRows; }

// Launch `kernel` with `threads` threads a block and `smem` bytes of dynamic
// shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, as_stream(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// F1's, F3's and F4's one-dimensional grid: tiles x heads x batch blocks.
inline int flat_grid(int n_tiles, int heads, int batch, unsigned* blocks) {
  const int64_t n = static_cast<int64_t>(n_tiles) * heads * batch;
  if (n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

template <int D, typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, Dims d,
        void* stream) {
  unsigned blocks;
  if (int err = flat_grid(tiles(d.sq), d.hq, d.batch, &blocks)) return err;
  return launch(fwd_kernel<D, T>, dim3(blocks), kMmaThreads, fwd_smem<D>(), stream,
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
  unsigned blocks;
  if (int err = flat_grid((tiles(d.skv) + 1) / 2, d.hkv, d.batch, &blocks)) return err;
  return launch(bwd_dkdv_kernel<D, T>, dim3(blocks), kDkdvGroups * kMmaThreads, dkdv_smem<D>(),
                stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), d);
}

template <int D, typename T>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* delta, void* dqp, Dims d, void* stream) {
  unsigned blocks;
  if (int err = flat_grid(tiles(d.sq), d.hq, d.batch, &blocks)) return err;
  return launch(bwd_dq_kernel<D, T>, dim3(blocks), kMmaThreads, dq_smem<D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dqp), d);
}

// The resources of F1 (which 0), F2 (1), F3 (2) or F4 (3) at head_dim D and
// type T (see launch_resources()).
template <int D, typename T>
int launch_config(int which, int* out) {
  switch (which) {
    case 0: return launch_resources(fwd_kernel<D, T>, kMmaThreads, fwd_smem<D>(), out);
    case 1: return launch_resources(bwd_preprocess_kernel<D, T>, kThreads, 0, out);
    case 2:
      return launch_resources(bwd_dkdv_kernel<D, T>, kDkdvGroups * kMmaThreads,
                              dkdv_smem<D>(), out);
    case 3: return launch_resources(bwd_dq_kernel<D, T>, kMmaThreads, dq_smem<D>(), out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
               float scale, int q_offset) {
  Dims d;
  d.batch = batch;
  d.sq = sq;
  d.skv = skv;
  d.hq = hq;
  d.hkv = hkv;
  d.causal = causal;
  d.window = window;
  d.scale = scale;
  d.q_offset = q_offset;
  return d;
}

}  // namespace

extern "C" {

int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int batch, int sq, int skv, int hq, int hkv, int head_dim,
                        int causal, int window, float scale, int bf16, int q_offset,
                        void* stream) {
  const Dims d = make_dims(batch, sq, skv, hq, hkv, causal, window, scale, q_offset);
  DISPATCH(head_dim, bf16, fwd, q, k, v, o, lse, d, stream);
}

int flash_attention_bwd_preprocess(const void* o, const void* dout, void* delta, int batch,
                                   int sq, int hq, int head_dim, int bf16, void* stream) {
  DISPATCH(head_dim, bf16, preprocess, o, dout, delta, batch, sq, hq, stream);
}

int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             int batch, int sq, int skv, int hq, int hkv, int head_dim,
                             int causal, int window, float scale, int bf16, int q_offset,
                             void* stream) {
  const Dims d = make_dims(batch, sq, skv, hq, hkv, causal, window, scale, q_offset);
  DISPATCH(head_dim, bf16, dkdv, q, k, v, dout, lse, delta, dk, dv, d, stream);
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dqp, int batch, int sq,
                           int skv, int hq, int hkv, int head_dim, int causal, int window,
                           float scale, int bf16, int q_offset, void* stream) {
  const Dims d = make_dims(batch, sq, skv, hq, hkv, causal, window, scale, q_offset);
  DISPATCH(head_dim, bf16, dq, q, k, v, dout, lse, delta, dqp, d, stream);
}

// The resources of F1 (which 0), F2 (1), F3 (2) or F4 (3) at head_dim and
// dtype (see launch_resources()).
int flash_attention_launch_config(int which, int head_dim, int bf16, void* out) {
  DISPATCH(head_dim, bf16, launch_config, which, static_cast<int*>(out));
}

}  // extern "C"
