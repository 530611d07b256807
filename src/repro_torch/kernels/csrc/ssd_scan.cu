// Mamba2's SSD chunked scan for Hopper (sm_90a), forward and backward, bound
// to Python with ctypes by repro_torch/kernels/ssd_scan.py.
//
// Replaces the Pallas TPU kernel ssd_scan_pallas of
// src/repro/kernels/ssd_scan.py (pallas_call at :77), which is forward
// only; the backward kernel is new, so that Mamba2LM and Zamba2LM can train
// through the forward:
//   ssd_fwd   S1  y, and the state at the start of every chunk
//   ssd_bwd   S2  dx, d(dt), and per-(b, h) partials of dA, dB and dC
// Layout: x, y, dy, dx (B, S, H, P); dt, d(dt) (B, S, H) f32; A (H,) f32;
// Bm, Cm (B, S, N), shared by the heads (ngroups = 1); states
// (B, H, chunks, N, P) f32; dB and dC partials (B, H, S, N) f32; dA partials
// (B, H) f32; all contiguous. x, Bm, Cm, dy f32 or bf16 (all of one dtype),
// y in that dtype, gradients f32, all arithmetic in f32. (N, P) is (16, 32)
// or (64, 64): the reduced and the full zamba2-1.2b.
//
// What it computes, as B9 does, per chunk of L <= 64 steps (rows past S read
// as zeros, which leaves the decay flat over the pad): g = cumsum(dt A) down
// the chunk, xf = x dt, M_tj = (C_t . B_j) exp(g_t - g_j) for j <= t (0
// above the diagonal), y = M xf + exp(g) (C S), then
// S <- exp(g_L) S + sum_j exp(g_L - g_j) B_j (x) xf_j. Every exponent is at
// most 0: exp(g_t - g_j) is never split into exp(g_t) exp(-g_j), which
// overflows once g falls past -88 (at init, A = -e and dt near 0.7).
//
// The backward walks the chunks in reverse and carries dS, the gradient of
// the state after the chunk. With G_tj = (dy_t . xf_j) exp(g_t - g_j) for
// j <= t and Q_tj = G_tj (C_t . B_j) for j < t:
//   dxf   = M^T dy + exp(g_L - g) (B dS)            dx = dxf dt
//   dC    = G B + exp(g) (dy S^T)
//   dB    = G^T C + exp(g_L - g) (xf dS^T)
//   dg_t  = sum_j Q_tj - sum_j Q_jt + exp(g_t) dy_t . (C S)_t - R_t,
//           R_t = exp(g_L - g_t) xf_t . (B dS)_t, and the last step adds
//           exp(g_L) <S, dS> + sum_t R_t
//   da    = reverse cumsum of dg; d(dt) = da A + dxf . x; dA += sum da dt
//   dS   <- exp(g_L) dS + sum_t exp(g_t) C_t (x) dy_t
// Every decay is again an exponent at most 0; the exponent gradients of
// exp(g_t - g_j) enter dg as +Q (row t) and -Q (column j), never through
// exp(-g_j).
//
// Design. One thread block of 256 threads per (head, batch) walks that head's
// chunks in order (in reverse for S2), as B9's grid walks its innermost
// chunk axis; the N x P state (and dS) stays in shared memory. The kernels'
// chunk is 64, not B9's 128: the L x L tiles (M; and G and Q in S2) at 64
// are 16 KB each, and S2's tiles come to 150 KB, inside an SM's 227 KB. A
// chunk's tiles are staged in shared memory as f32 with a row stride of
// width + 1, so the column reads of a warp hit 32 banks. g's cumulative sum
// runs down the chunk in one thread. Plain f32 FMAs, expf (never the fast
// intrinsics), no atomics: the row sums over P are warp sums in a fixed
// butterfly, dB and dC leave as per-(b, h) partials that the wrapper sums
// over the heads, and dA as partials it sums over the batch, each in a fixed
// order, so every run gives the same bits. S1 writes each chunk's starting
// state for S2 (33.5 MB at the main shape) rather than S2 walking the chunks
// forward once more.
//
// Bound: operations. At the main shape (B 2, S 1024, H 64, P 64, N 64, f32)
// the function reads x, dt, A, B, C and writes y: 68.7 MB, 0.0205 ms at
// 3.35 TB/s. Its fewest operations come at chunks of 8: C B^T once per batch
// row and chunk (B and C are shared by the heads), the causal pairs only,
// and per head the readout and state update, about 17,550 flops a token and
// head, 2.30 GFLOP, 0.0343 ms at 67 TFLOP/s; S2's function needs 4.73 GFLOP
// (chunks of 9), 0.0707 ms (chip_smoke.py's ssd_ops and ssd_bound). Only
// B x H = 128 blocks run, each one chunk after another, with about eight
// barriers a chunk and two shared-memory loads per FMA, and each head forms
// C B^T again, so the kernels are far from either bound; tensor cores, TMA,
// sharing C B^T across heads and a chunk-parallel split are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;       // the kernels' chunk
constexpr int kSL = kMaxL + 1;  // row stride of the L x L tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The sum over a warp, in one fixed order, in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Dims {
  int batch, seq, heads, chunk;
};

// offset of element (b, t, h, 0) of a (B, S, H, P) tensor
template <int P>
__device__ __forceinline__ int64_t row_offset(int b, int t, int h, const Dims& d) {
  return ((static_cast<int64_t>(b) * d.seq + t) * d.heads + h) * P;
}

// Stage rows t0 .. t0 + L - 1 of head h of x (B, S, H, P) as f32 in dst
// (row stride P + 1); rows past S are zeros.
template <int P, typename T>
__device__ void load_rows(float* dst, const T* __restrict__ x, int b, int h, int t0,
                          const Dims& d) {
  for (int i = threadIdx.x; i < d.chunk * P; i += kThreads) {
    const int t = i / P, p = i % P;
    dst[t * (P + 1) + p] = t0 + t < d.seq ? to_f32(x[row_offset<P>(b, t0 + t, h, d) + p]) : 0.f;
  }
}

// Stage the chunk's dt (L), x (L x P) and B, C (L x N, row stride N + 1) as
// f32; rows past S are zeros.
template <int N, int P, typename T>
__device__ void load_chunk(float* sdt, float* sx, float* sb, float* sc, const T* __restrict__ x,
                           const float* __restrict__ dt, const T* __restrict__ bm,
                           const T* __restrict__ cm, int b, int h, int t0, const Dims& d) {
  for (int t = threadIdx.x; t < d.chunk; t += kThreads)
    sdt[t] = t0 + t < d.seq ? dt[(static_cast<int64_t>(b) * d.seq + t0 + t) * d.heads + h] : 0.f;
  load_rows<P>(sx, x, b, h, t0, d);
  for (int i = threadIdx.x; i < d.chunk * N; i += kThreads) {
    const int t = i / N, n = i % N;
    const bool in = t0 + t < d.seq;
    const int64_t off = (static_cast<int64_t>(b) * d.seq + t0 + t) * N + n;
    sb[t * (N + 1) + n] = in ? to_f32(bm[off]) : 0.f;
    sc[t * (N + 1) + n] = in ? to_f32(cm[off]) : 0.f;
  }
}

// After the chunk's dt is staged (and a barrier): g = cumsum(dt a) in one
// thread, a barrier, then e = exp(g) and w = exp(g_L - g). The caller
// places a barrier before e and w are read.
__device__ void decays(const float* sdt, float a, float* sg, float* se, float* sw, int L) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int t = 0; t < L; ++t) {
      acc += sdt[t] * a;
      sg[t] = acc;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += kThreads) {
    se[t] = expf(sg[t]);
    sw[t] = expf(sg[L - 1] - sg[t]);
  }
}

template <int N, int P, typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ bm,
                   const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ states,
                   Dims d) {
  constexpr int SP = P + 1, SN = N + 1;
  extern __shared__ float smem[];
  float* st = smem;             // N x P state, stride SP
  float* sx = st + N * SP;      // xf = x dt, L x P
  float* sb = sx + kMaxL * SP;  // L x N, stride SN
  float* sc = sb + kMaxL * SN;
  float* sm = sc + kMaxL * SN;  // M, L x L, stride kSL
  float* sdt = sm + kMaxL * kSL;
  float* sg = sdt + kMaxL;
  float* se = sg + kMaxL;
  float* sw = se + kMaxL;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, L = d.chunk;
  const int nc = (d.seq + L - 1) / L;
  const float a = A[h];
  for (int i = tid; i < N * SP; i += kThreads) st[i] = 0.f;
  float* st_out = states + (static_cast<int64_t>(b) * d.heads + h) * nc * N * P;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    load_chunk<N, P>(sdt, sx, sb, sc, x, dt, bm, cm, b, h, t0, d);
    __syncthreads();
    decays(sdt, a, sg, se, sw, L);
    for (int i = tid; i < L * P; i += kThreads) sx[(i / P) * SP + i % P] *= sdt[i / P];
    __syncthreads();
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, j = i % L;
      float m = 0.f;
      if (j <= t) {
        float cb = 0.f;
#pragma unroll 16
        for (int n = 0; n < N; ++n) cb += sc[t * SN + n] * sb[j * SN + n];
        m = cb * expf(sg[t] - sg[j]);
      }
      sm[t * kSL + j] = m;
    }
    float* out = st_out + static_cast<int64_t>(c) * N * P;
    for (int i = tid; i < N * P; i += kThreads) out[i] = st[(i / P) * SP + i % P];
    __syncthreads();
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P, p = i % P;
      float intra = 0.f;
      for (int j = 0; j <= t; ++j) intra += sm[t * kSL + j] * sx[j * SP + p];
      float inter = 0.f;
#pragma unroll 16
      for (int n = 0; n < N; ++n) inter += sc[t * SN + n] * st[n * SP + p];
      if (t0 + t < d.seq) put(y + row_offset<P>(b, t0 + t, h, d) + p, intra + se[t] * inter);
    }
    __syncthreads();
    const float e_last = se[L - 1];
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P, p = i % P;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc += sw[j] * sb[j * SN + n] * sx[j * SP + p];
      st[n * SP + p] = st[n * SP + p] * e_last + acc;
    }
    __syncthreads();
  }
}

template <int N, int P, typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ bm,
                   const T* __restrict__ cm, const float* __restrict__ states,
                   const T* __restrict__ dy, float* __restrict__ dx, float* __restrict__ ddt,
                   float* __restrict__ da_part, float* __restrict__ db_part,
                   float* __restrict__ dc_part, Dims d) {
  constexpr int SP = P + 1, SN = N + 1, kParts = P / 32;
  extern __shared__ float smem[];
  float* st = smem;               // the state at the chunk's start, N x P
  float* sds = st + N * SP;       // dS: gradient of the state after the chunk
  float* sx = sds + N * SP;       // x (not scaled by dt), L x P
  float* sdy = sx + kMaxL * SP;
  float* sb = sdy + kMaxL * SP;   // L x N
  float* sc = sb + kMaxL * SN;
  float* sm = sc + kMaxL * SN;    // M, L x L
  float* sgg = sm + kMaxL * kSL;  // G
  float* sq = sgg + kMaxL * kSL;  // Q, strictly below the diagonal
  float* sdt = sq + kMaxL * kSL;
  float* sg = sdt + kMaxL;
  float* se = sg + kMaxL;
  float* sw = se + kMaxL;
  float* sdg = sw + kMaxL;
  float* sr = sdg + kMaxL;                 // R
  float* pdx = sr + kMaxL;                 // per row and 32 columns: dxf . x
  float* pread = pdx + kMaxL * kParts;     //   dy . (C S)
  float* pr = pread + kMaxL * kParts;      //   xf . (B dS)
  float* swarp = pr + kMaxL * kParts;      // per warp: <S, dS>

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, L = d.chunk;
  const int lane = tid & 31, warp = tid >> 5;
  const int nc = (d.seq + L - 1) / L;
  const float a = A[h];
  for (int i = tid; i < N * SP; i += kThreads) sds[i] = 0.f;
  const float* st_in = states + (static_cast<int64_t>(b) * d.heads + h) * nc * N * P;
  float* db_out = db_part + (static_cast<int64_t>(b) * d.heads + h) * d.seq * N;
  float* dc_out = dc_part + (static_cast<int64_t>(b) * d.heads + h) * d.seq * N;
  float da_acc = 0.f;  // thread 0

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    load_chunk<N, P>(sdt, sx, sb, sc, x, dt, bm, cm, b, h, t0, d);
    load_rows<P>(sdy, dy, b, h, t0, d);
    const float* in = st_in + static_cast<int64_t>(c) * N * P;
    for (int i = tid; i < N * P; i += kThreads) st[(i / P) * SP + i % P] = in[i];
    __syncthreads();
    decays(sdt, a, sg, se, sw, L);
    __syncthreads();
    // the pairs (t, j): M, G and Q
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, j = i % L;
      float m = 0.f, gg = 0.f, q = 0.f;
      if (j <= t) {
        float cb = 0.f, dm = 0.f;
#pragma unroll 16
        for (int n = 0; n < N; ++n) cb += sc[t * SN + n] * sb[j * SN + n];
#pragma unroll 16
        for (int p = 0; p < P; ++p) dm += sdy[t * SP + p] * sx[j * SP + p];
        const float dec = expf(sg[t] - sg[j]);
        m = cb * dec;
        gg = dm * sdt[j] * dec;
        if (j < t) q = gg * cb;
      }
      sm[t * kSL + j] = m;
      sgg[t * kSL + j] = gg;
      sq[t * kSL + j] = q;
    }
    float sdot = 0.f;
    for (int i = tid; i < N * P; i += kThreads) {
      const int k = (i / P) * SP + i % P;
      sdot += st[k] * sds[k];
    }
    sdot = warp_sum(sdot);
    if (lane == 0) swarp[warp] = sdot;
    __syncthreads();
    // the elements (t, p): dx, and the row sums over p of dg and d(dt)
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P, p = i % P;
      float intra = 0.f;
      for (int tt = t; tt < L; ++tt) intra += sm[tt * kSL + t] * sdy[tt * SP + p];
      float bds = 0.f, cs = 0.f;
#pragma unroll 16
      for (int n = 0; n < N; ++n) {
        bds += sb[t * SN + n] * sds[n * SP + p];
        cs += sc[t * SN + n] * st[n * SP + p];
      }
      const float dxf = intra + sw[t] * bds;
      const float xv = sx[t * SP + p], dtt = sdt[t];
      if (t0 + t < d.seq) dx[row_offset<P>(b, t0 + t, h, d) + p] = dxf * dtt;
      // a warp holds 32 columns of one row (P is 32 or 64)
      const float v_dx = warp_sum(dxf * xv);
      const float v_read = warp_sum(sdy[t * SP + p] * cs);
      const float v_r = warp_sum(xv * dtt * bds);
      if (lane == 0) {
        const int k = t * kParts + p / 32;
        pdx[k] = v_dx;
        pread[k] = v_read;
        pr[k] = v_r;
      }
    }
    // the elements (t, n): the (b, h) partials of dC and dB
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, n = i % N;
      float gc = 0.f, gb = 0.f;
      for (int j = 0; j <= t; ++j) gc += sgg[t * kSL + j] * sb[j * SN + n];
      for (int tt = t; tt < L; ++tt) gb += sgg[tt * kSL + t] * sc[tt * SN + n];
      float sdy_n = 0.f, dsx_n = 0.f;
#pragma unroll 16
      for (int p = 0; p < P; ++p) {
        sdy_n += st[n * SP + p] * sdy[t * SP + p];
        dsx_n += sds[n * SP + p] * sx[t * SP + p];
      }
      if (t0 + t < d.seq) {
        const int64_t off = static_cast<int64_t>(t0 + t) * N + n;
        dc_out[off] = gc + se[t] * sdy_n;
        db_out[off] = gb + sw[t] * sdt[t] * dsx_n;
      }
    }
    __syncthreads();
    // the rows: dg without the last step's carried terms
    for (int t = tid; t < L; t += kThreads) {
      float row = 0.f, col = 0.f, read = 0.f, r = 0.f;
      for (int j = 0; j < L; ++j) {
        row += sq[t * kSL + j];
        col += sq[j * kSL + t];
      }
      for (int k = 0; k < kParts; ++k) {
        read += pread[t * kParts + k];
        r += pr[t * kParts + k];
      }
      sr[t] = sw[t] * r;
      sdg[t] = row - col + se[t] * read - sr[t];
    }
    __syncthreads();
    if (tid == 0) {
      float s_ds = 0.f, r_sum = 0.f;
      for (int w = 0; w < kWarps; ++w) s_ds += swarp[w];
      for (int t = 0; t < L; ++t) r_sum += sr[t];
      sdg[L - 1] += se[L - 1] * s_ds + r_sum;
      float run = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        run += sdg[t];
        float pd = 0.f;
        for (int k = 0; k < kParts; ++k) pd += pdx[t * kParts + k];
        if (t0 + t < d.seq)
          ddt[(static_cast<int64_t>(b) * d.seq + t0 + t) * d.heads + h] = run * a + pd;
        da_acc += run * sdt[t];
      }
    }
    // every read of dS in this chunk is done: carry it to the chunk's start
    const float e_last = se[L - 1];
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P, p = i % P;
      float acc = 0.f;
      for (int t = 0; t < L; ++t) acc += se[t] * sc[t * SN + n] * sdy[t * SP + p];
      sds[n * SP + p] = e_last * sds[n * SP + p] + acc;
    }
    __syncthreads();
  }
  if (tid == 0) da_part[static_cast<int64_t>(b) * d.heads + h] = da_acc;
}

template <int N, int P>
constexpr size_t fwd_smem() {
  return (N * (P + 1) + kMaxL * (P + 1) + 2 * kMaxL * (N + 1) + kMaxL * kSL + 4 * kMaxL) *
         sizeof(float);
}
template <int N, int P>
constexpr size_t bwd_smem() {
  return (2 * N * (P + 1) + 2 * kMaxL * (P + 1) + 2 * kMaxL * (N + 1) + 3 * kMaxL * kSL +
          6 * kMaxL + 3 * kMaxL * (P / 32) + kWarps) *
         sizeof(float);
}
static_assert(bwd_smem<64, 64>() <= 232448, "S2's tiles exceed an SM's shared memory");

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

// Launch `kernel` over (heads, batch) with `smem` bytes of dynamic shared
// memory.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Dims& d, size_t smem, void* stream, Args... args) {
  if (d.chunk < 1 || d.chunk > kMaxL || d.seq < 1 || d.batch < 1 || d.heads < 1 ||
      d.batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(d.heads, d.batch), kThreads, smem, as_stream(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int P, typename T>
int fwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm, void* y,
        void* states, Dims d, void* stream) {
  return launch(ssd_fwd_kernel<N, P, T>, d, fwd_smem<N, P>(), stream,
                static_cast<const T*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(A), static_cast<const T*>(bm),
                static_cast<const T*>(cm), static_cast<T*>(y), static_cast<float*>(states), d);
}

template <int N, int P, typename T>
int bwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
        const void* states, const void* dy, void* dx, void* ddt, void* da_part, void* db_part,
        void* dc_part, Dims d, void* stream) {
  return launch(ssd_bwd_kernel<N, P, T>, d, bwd_smem<N, P>(), stream,
                static_cast<const T*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(A), static_cast<const T*>(bm),
                static_cast<const T*>(cm), static_cast<const float*>(states),
                static_cast<const T*>(dy), static_cast<float*>(dx), static_cast<float*>(ddt),
                static_cast<float*>(da_part), static_cast<float*>(db_part),
                static_cast<float*>(dc_part), d);
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

}  // namespace

extern "C" {

int ssd_fwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
            void* y, void* states, int batch, int seq, int heads, int head_dim, int state,
            int chunk, int bf16, void* stream) {
  const Dims d{batch, seq, heads, chunk};
  DISPATCH(state, head_dim, bf16, fwd, x, dt, A, bm, cm, y, states, d, stream);
}

int ssd_bwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
            const void* states, const void* dy, void* dx, void* ddt, void* da_part,
            void* db_part, void* dc_part, int batch, int seq, int heads, int head_dim,
            int state, int chunk, int bf16, void* stream) {
  const Dims d{batch, seq, heads, chunk};
  DISPATCH(state, head_dim, bf16, bwd, x, dt, A, bm, cm, states, dy, dx, ddt, da_part, db_part,
           dc_part, d, stream);
}

}  // extern "C"
