// RWKV6's chunked WKV recurrence for Hopper (sm_90a), forward and backward,
// bound to Python with ctypes by repro_torch/kernels/rwkv6_wkv.py.
//
// Replaces the Pallas TPU kernel wkv6_pallas of
// src/repro/kernels/rwkv6_wkv.py (pallas_call at :76), which is forward
// only; the backward kernel is new, so that Rwkv6LM can train through the
// forward:
//   wkv6_fwd   W1  y, and the state at the start of every chunk
//   wkv6_bwd   W2  dr, dk, dv, dlogw, and per-(b, h) partials of du
// Layout (B, S, H, P) for r, k, v, logw, y, dy and the four gradients,
// contiguous; u (H, P) f32; states (B, H, chunks, P, P) f32; du partials
// (B, H, P) f32. r, k, v, logw, dy f32 or bf16 (all of one dtype), y in that
// dtype, gradients f32, all arithmetic in f32. P (head_dim) 32 or 64: the
// reduced and the full rwkv6-7b.
//
// What it computes, as B8 does, per chunk of L = min(32, S) steps (rows past
// S read as zeros, which leaves cum flat over the pad): cum = cumsum(logw)
// down the chunk, cumprev = cum - logw, r_dec = r exp(cumprev), k_boost =
// k exp(-cum), A = r_dec k_boost^T strictly below the diagonal, y = A v +
// bonus v + r_dec S with bonus_t = sum_p r u k; then S <- S exp(cum_L) +
// (k exp(cum_L - cum))^T v. The forward keeps B8's factorization: k_boost
// reaches |k| e^80 and r_dec falls to |r| e^-80, both inside f32 because the
// model clamps logw at -2.5 and a chunk is 32 steps.
//
// The backward walks the chunks in reverse and carries dS, the gradient of
// the state after the chunk: with dA = dy v^T strictly below the diagonal,
//   dr_dec = sum_j dA_tj k_j exp(cumprev_t - cum_j) + exp(cumprev_t) (dy S^T)_t
//   dr     = dr_dec + dbonus u k                     (dbonus_t = dy_t . v_t)
//   dk     = sum_t dA_tj r_t exp(cumprev_t - cum_j) + exp(cum_L - cum_j)(v dS^T)_j
//            + dbonus u r
//   dv     = A^T dy + bonus dy + k_tail dS
//   dlogw  = reverse cumsum of dcum, minus dcumprev, where dcumprev = r dr_dec,
//            dcum = dcumprev - k (the two dk terms) + [t = L-1] dcum_L and
//            dcum_L = sum_j k dk_tail + exp(cum_L) sum_q S dS
//   du    += sum_t dbonus r k
//   dS    <- exp(cum_L) dS + r_dec^T dy
// Each intra-chunk pair's decay exp(cumprev_t - cum_j) is computed on its own
// (it is at most 1): the factorized dA k_boost would sum values up to
// |k| e^80 before the small factor comes in.
//
// Design. One thread block of 256 threads per (head, batch) walks that head's
// chunks in order (in reverse for W2), as B8's grid walks its innermost
// chunk axis; the P x P state (and dS) stays in shared memory. A chunk's
// tiles are staged in shared memory as f32 with a row stride of P + 1, so
// the column reads of a warp hit 32 banks. The cumulative sums run down one
// column per thread. Plain f32 FMAs, expf (never the fast intrinsics), no
// atomics: du leaves as per-(b, h) partials that the wrapper sums over the
// batch in a fixed order, so every run gives the same bits. W1 writes each
// chunk's starting state for W2 (67 MB at the main shape) rather than W2
// walking the chunks forward once more.
//
// Bound: bytes. At the main shape (B 2, S 1024, H 64, P 64, f32) W1 moves
// 235 MB (four inputs read once, y and the 67 MB of chunk states written
// once), 0.070 ms at 3.35 TB/s, against about 786k flops a chunk (the L x L
// and L x P products counted in full), 3.2 GFLOP in all, 0.048 ms at 67
// TFLOP/s; W2 moves 369 MB (0.110 ms) for 7.0 GFLOP (0.104 ms). Only
// B x H = 128 blocks run, each one chunk after another, so the kernels are
// far from either bound; a chunk-parallel split is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 32;  // B8's chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
__device__ void load_tile(float* dst, const T* __restrict__ x, int b, int h, int t0,
                          const Dims& d) {
  for (int i = threadIdx.x; i < d.chunk * P; i += kThreads) {
    const int t = i / P, p = i % P;
    dst[t * (P + 1) + p] = t0 + t < d.seq ? to_f32(x[row_offset<P>(b, t0 + t, h, d) + p]) : 0.f;
  }
}

// Column p of the chunk (P threads): cum in place of logw, cumprev = cum -
// logw, r_dec, k_boost, k_tail, exp(cum_L); the threads after them take the
// bonus (and, given dy, dbonus) of one row each.
template <int P>
__device__ void chunk_terms(float* cum, float* cumprev, const float* r, const float* k,
                            const float* v, const float* dy, const float* u, float* rd,
                            float* kb, float* kt, float* dec, float* bonus, float* dbonus,
                            int L) {
  constexpr int SP = P + 1;
  const int tid = threadIdx.x;
  if (tid < P) {
    const int p = tid;
    float acc = 0.f;
    for (int t = 0; t < L; ++t) {
      const float w = cum[t * SP + p];
      acc += w;
      cum[t * SP + p] = acc;
      const float cp = acc - w;
      if (cumprev != nullptr) cumprev[t * SP + p] = cp;
      rd[t * SP + p] = r[t * SP + p] * expf(cp);
    }
    for (int t = 0; t < L; ++t) {
      const float c = cum[t * SP + p];
      kb[t * SP + p] = k[t * SP + p] * expf(-c);
      kt[t * SP + p] = k[t * SP + p] * expf(acc - c);
    }
    dec[p] = expf(acc);
  } else if (tid < P + L) {
    const int t = tid - P;
    float bo = 0.f, dbo = 0.f;
    for (int p = 0; p < P; ++p) bo += r[t * SP + p] * u[p] * k[t * SP + p];
    bonus[t] = bo;
    if (dy != nullptr) {
      for (int q = 0; q < P; ++q) dbo += dy[t * SP + q] * v[t * SP + q];
      dbonus[t] = dbo;
    }
  }
}

template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
    wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ lw, const float* __restrict__ u, T* __restrict__ y,
                    float* __restrict__ states, Dims d) {
  constexpr int SP = P + 1;
  constexpr int kTileF = kMaxL * SP;
  extern __shared__ float smem[];
  float* st = smem;  // P x P state, stride SP
  float* sr = st + P * SP;
  float* sk = sr + kTileF;
  float* sv = sk + kTileF;
  float* scum = sv + kTileF;
  float* srd = scum + kTileF;
  float* skb = srd + kTileF;
  float* skt = skb + kTileF;
  float* sa = skt + kTileF;  // L x L, stride kMaxL
  float* sbonus = sa + kMaxL * kMaxL;
  float* su = sbonus + kMaxL;
  float* sdec = su + P;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, L = d.chunk;
  const int nc = (d.seq + L - 1) / L;
  for (int i = tid; i < P * SP; i += kThreads) st[i] = 0.f;
  for (int p = tid; p < P; p += kThreads) su[p] = u[h * P + p];
  float* st_out = states + (static_cast<int64_t>(b) * d.heads + h) * nc * P * P;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    load_tile<P>(sr, r, b, h, t0, d);
    load_tile<P>(sk, k, b, h, t0, d);
    load_tile<P>(sv, v, b, h, t0, d);
    load_tile<P>(scum, lw, b, h, t0, d);
    __syncthreads();
    chunk_terms<P>(scum, nullptr, sr, sk, sv, nullptr, su, srd, skb, skt, sdec, sbonus,
                   nullptr, L);
    __syncthreads();
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, j = i % L;
      float a = 0.f;
      if (j < t) {
#pragma unroll 16
        for (int p = 0; p < P; ++p) a += srd[t * SP + p] * skb[j * SP + p];
      }
      sa[t * kMaxL + j] = a;
    }
    __syncthreads();
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P, q = i % P;
      float acc = 0.f;
      for (int j = 0; j < t; ++j) acc += sa[t * kMaxL + j] * sv[j * SP + q];
      acc += sbonus[t] * sv[t * SP + q];
      float inter = 0.f;
#pragma unroll 16
      for (int p = 0; p < P; ++p) inter += srd[t * SP + p] * st[p * SP + q];
      if (t0 + t < d.seq) put(y + row_offset<P>(b, t0 + t, h, d) + q, acc + inter);
    }
    float* out = st_out + static_cast<int64_t>(c) * P * P;
    for (int i = tid; i < P * P; i += kThreads) out[i] = st[(i / P) * SP + i % P];
    __syncthreads();
    for (int i = tid; i < P * P; i += kThreads) {
      const int p = i / P, q = i % P;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc += skt[j * SP + p] * sv[j * SP + q];
      st[p * SP + q] = st[p * SP + q] * sdec[p] + acc;
    }
    __syncthreads();
  }
}

template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ lw, const float* __restrict__ u,
                    const float* __restrict__ states, const T* __restrict__ dy,
                    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dlw, float* __restrict__ du_part, Dims d) {
  constexpr int SP = P + 1;
  constexpr int kTileF = kMaxL * SP;
  extern __shared__ float smem[];
  float* st = smem;        // state at the chunk's start
  float* sds = st + P * SP;  // dS: gradient of the state after the chunk
  float* sr = sds + P * SP;
  float* sk = sr + kTileF;
  float* sv = sk + kTileF;
  float* sdy = sv + kTileF;
  float* scum = sdy + kTileF;
  float* scp = scum + kTileF;
  float* srd = scp + kTileF;
  float* skb = srd + kTileF;
  float* skt = skb + kTileF;
  float* sdcp = skt + kTileF;   // dcumprev
  float* sdcum = sdcp + kTileF;  // dcum without dcum_L
  float* skdkt = sdcum + kTileF;  // k * dk_tail
  float* sa = skdkt + kTileF;     // L x L, stride kMaxL
  float* sda = sa + kMaxL * kMaxL;
  float* sbonus = sda + kMaxL * kMaxL;
  float* sdbonus = sbonus + kMaxL;
  float* su = sdbonus + kMaxL;
  float* sdec = su + P;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, L = d.chunk;
  const int nc = (d.seq + L - 1) / L;
  for (int i = tid; i < P * SP; i += kThreads) sds[i] = 0.f;
  for (int p = tid; p < P; p += kThreads) su[p] = u[h * P + p];
  const float* st_in = states + (static_cast<int64_t>(b) * d.heads + h) * nc * P * P;
  float du_acc = 0.f;  // thread p < P: du partial of column p

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    load_tile<P>(sr, r, b, h, t0, d);
    load_tile<P>(sk, k, b, h, t0, d);
    load_tile<P>(sv, v, b, h, t0, d);
    load_tile<P>(sdy, dy, b, h, t0, d);
    load_tile<P>(scum, lw, b, h, t0, d);
    const float* in = st_in + static_cast<int64_t>(c) * P * P;
    for (int i = tid; i < P * P; i += kThreads) st[(i / P) * SP + i % P] = in[i];
    __syncthreads();
    chunk_terms<P>(scum, scp, sr, sk, sv, sdy, su, srd, skb, skt, sdec, sbonus, sdbonus, L);
    __syncthreads();
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, j = i % L;
      float a = 0.f, da = 0.f;
      if (j < t) {
#pragma unroll 16
        for (int p = 0; p < P; ++p) a += srd[t * SP + p] * skb[j * SP + p];
#pragma unroll 16
        for (int q = 0; q < P; ++q) da += sdy[t * SP + q] * sv[j * SP + q];
      }
      sa[t * kMaxL + j] = a;
      sda[t * kMaxL + j] = da;
    }
    __syncthreads();
    const float* cum_l = scum + (L - 1) * SP;
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P, x = i % P;  // x: p for dr, dk; q for dv
      const float cpt = scp[t * SP + x], cumt = scum[t * SP + x];
      float intra = 0.f;
      for (int j = 0; j < t; ++j)
        intra += sda[t * kMaxL + j] * sk[j * SP + x] * expf(cpt - scum[j * SP + x]);
      float dys = 0.f;
#pragma unroll 16
      for (int q = 0; q < P; ++q) dys += sdy[t * SP + q] * st[x * SP + q];
      const float dr_dec = intra + expf(cpt) * dys;
      float dkb = 0.f;
      for (int tt = t + 1; tt < L; ++tt)
        dkb += sda[tt * kMaxL + t] * sr[tt * SP + x] * expf(scp[tt * SP + x] - cumt);
      float vds = 0.f;
#pragma unroll 16
      for (int q = 0; q < P; ++q) vds += sv[t * SP + q] * sds[x * SP + q];
      const float dkt = expf(cum_l[x] - cumt) * vds;
      float dvt = 0.f;
      for (int tt = t + 1; tt < L; ++tt) dvt += sa[tt * kMaxL + t] * sdy[tt * SP + x];
      dvt += sbonus[t] * sdy[t * SP + x];
      float ktds = 0.f;
#pragma unroll 16
      for (int p = 0; p < P; ++p) ktds += skt[t * SP + p] * sds[p * SP + x];
      const float rx = sr[t * SP + x], kx = sk[t * SP + x];
      if (t0 + t < d.seq) {
        const int64_t off = row_offset<P>(b, t0 + t, h, d) + x;
        dr[off] = dr_dec + sdbonus[t] * su[x] * kx;
        dk[off] = dkb + dkt + sdbonus[t] * su[x] * rx;
        dv[off] = dvt + ktds;
      }
      const float dcp = rx * dr_dec;
      sdcp[t * SP + x] = dcp;
      sdcum[t * SP + x] = dcp - kx * dkb - kx * dkt;
      skdkt[t * SP + x] = kx * dkt;
    }
    __syncthreads();
    if (tid < P) {
      const int p = tid;
      float sdot = 0.f;
      for (int q = 0; q < P; ++q) sdot += st[p * SP + q] * sds[p * SP + q];
      float kk = 0.f, dub = 0.f;
      for (int t = 0; t < L; ++t) {
        kk += skdkt[t * SP + p];
        dub += sdbonus[t] * sr[t * SP + p] * sk[t * SP + p];
      }
      du_acc += dub;
      const float dcum_l = kk + sdec[p] * sdot;
      float run = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        float dc = sdcum[t * SP + p];
        if (t == L - 1) dc += dcum_l;
        run += dc;
        if (t0 + t < d.seq) dlw[row_offset<P>(b, t0 + t, h, d) + p] = run - sdcp[t * SP + p];
      }
    }
    __syncthreads();
    for (int i = tid; i < P * P; i += kThreads) {
      const int p = i / P, q = i % P;
      float acc = 0.f;
      for (int t = 0; t < L; ++t) acc += srd[t * SP + p] * sdy[t * SP + q];
      sds[p * SP + q] = sdec[p] * sds[p * SP + q] + acc;
    }
    __syncthreads();
  }
  if (tid < P) du_part[(static_cast<int64_t>(b) * d.heads + h) * P + tid] = du_acc;
}

template <int P>
constexpr size_t fwd_smem() {
  return (P * (P + 1) + 7 * kMaxL * (P + 1) + kMaxL * kMaxL + kMaxL + 2 * P) * sizeof(float);
}
template <int P>
constexpr size_t bwd_smem() {
  return (2 * P * (P + 1) + 12 * kMaxL * (P + 1) + 2 * kMaxL * kMaxL + 2 * kMaxL + 2 * P) *
         sizeof(float);
}

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

template <int P, typename T>
int fwd(const void* r, const void* k, const void* v, const void* lw, const void* u, void* y,
        void* states, Dims d, void* stream) {
  return launch(wkv6_fwd_kernel<P, T>, d, fwd_smem<P>(), stream, static_cast<const T*>(r),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(lw), static_cast<const float*>(u), static_cast<T*>(y),
                static_cast<float*>(states), d);
}

template <int P, typename T>
int bwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
        const void* states, const void* dy, void* dr, void* dk, void* dv, void* dlw,
        void* du_part, Dims d, void* stream) {
  return launch(wkv6_bwd_kernel<P, T>, d, bwd_smem<P>(), stream, static_cast<const T*>(r),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(lw), static_cast<const float*>(u),
                static_cast<const float*>(states), static_cast<const T*>(dy),
                static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
                static_cast<float*>(dlw), static_cast<float*>(du_part), d);
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

}  // namespace

extern "C" {

int wkv6_fwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
             void* y, void* states, int batch, int seq, int heads, int head_dim, int chunk,
             int bf16, void* stream) {
  const Dims d{batch, seq, heads, chunk};
  DISPATCH(head_dim, bf16, fwd, r, k, v, lw, u, y, states, d, stream);
}

int wkv6_bwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
             const void* states, const void* dy, void* dr, void* dk, void* dv, void* dlw,
             void* du_part, int batch, int seq, int heads, int head_dim, int chunk, int bf16,
             void* stream) {
  const Dims d{batch, seq, heads, chunk};
  DISPATCH(head_dim, bf16, bwd, r, k, v, lw, u, states, dy, dr, dk, dv, dlw, du_part, d,
           stream);
}

}  // extern "C"
