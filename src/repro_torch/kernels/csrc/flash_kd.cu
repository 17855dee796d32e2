// Flash-KD for Hopper (sm_90a), plain C interface: vocab-streamed knowledge
// distillation with an online logsumexp, unfused and with the LM head fused.
//
// Replaces the TPU kernels of repro/kernels/kd_loss/flash.py:
//
//   flash_kd_fwd       (flash.py:438; bodies _flash_fwd_kernel :362 and
//                       _flash_fwd_lse_kernel :400)        -> kernel 7
//   flash_kd_bwd       (flash.py:500; body :490)           -> kernel 8
//   flash_kd_head_fwd  (flash.py:608; bodies :545, :581)   -> kernel 9
//   flash_kd_head_bwd  (flash.py:698; body :668)           -> kernel 10
//
// With s = z_s / tau and t = z_mean / tau, per row: the student's running max
// and sum of exp (ms, ls), and either the teacher's (mt, lt) with the cross
// term x = sum e^{t - mt} (t - s), rescaled when mt advances, or, with the
// teacher's lse given, x = sum e^{t - lse_t} (t - s).  Then
//   lse_s = ms + log ls,  lse_t = mt + log lt,  kl = x / lt - lse_t + lse_s
// (or kl = x - lse_t + lse_s), loss = mean(kl) * tau^2, and the backward is
//   d = g * tau / B * (e^{s - lse_s} - e^{t - lse_t}).
// Lanes past V are FLASH_PAD (-1e30) in s and t (exp -> 0, t - s = 0), and
// 0 in W and b; nothing is padded on the host.
//
// Same functions, not the same block structure.  The TPU grid walks V in
// order and carries (m, l, x) in output blocks revisited along it.  Here
// blocks run in parallel and in no order, so:
//
//   * kernel 7: one CTA per (row, chunk of kRowChunk columns) keeps a
//     per-thread online state over its strided columns, merges the 256
//     states in a fixed tree (warp shuffles, then warps in order) and
//     writes one partial (ms, ls, mt, lt, x) per (row, chunk); a one-CTA
//     combine kernel merges each row's partials in chunk order and sums the
//     rows' kl in a fixed order into the loss.  No atomics: bit-stable.
//   * kernel 8: elementwise over (B, V), one thread per element.
//   * kernel 9: the student tile h @ W[:, tile] is a 64 x 64 output tile of
//     an f32 CUDA-core GEMM (shared-memory tiles of depth 16, 4 x 4 outputs a
//     thread) formed inside the kernel; each CTA walks kHeadChunkTiles such
//     tiles of its 64 rows, feeding every value straight into the thread's
//     online state, then merges the 16 lanes of each row and writes partials
//     for the same combine kernel.  The (B, V) student row never exists.
//   * kernel 10: one pass per chunk of kBwdChunk columns (four launches):
//     (a) the GEMM tile again, then d = g tau/B (q - p) into a (B, chunk) f32
//     workspace; (b) dW[:, chunk] = h^T d, written once in W's own layout
//     and type; (c) dh += d W[:, chunk]^T into an f32 (B, D) buffer, chunks in
//     order (each element owned by one thread: no atomics, bit-stable, and
//     no (n_tiles, B, D) workspace); (d) with a bias, db[chunk] = sum_b d.
//
// W is read through its strides, so the tied head (embed^T, a (D, V) view
// with strides (1, D)) is used in place and its gradient is written with the
// same strides: autograd's transpose back to the embedding copies nothing.
//
// Bound on this card (H100 SXM: HBM 3.35 TB/s; f32 outside the tensor cores
// 67 TFLOP/s) at the LM path's shapes, B = 512 rows, D = 2048, V = 256,000:
//   kernel 7: bytes, s f32 and z_mean bf16 read once: 0.79 GB, 0.235 ms;
//   kernel 8: bytes, s and z_mean read, the f32 gradient written: 1.3 GB,
//   0.39 ms;
//   kernel 9: operations, 2 B D V = 537 GFLOP: 8.0 ms (bytes alone 0.70 ms);
//   kernel 10: operations, three such products, 1.61 TFLOP: 24 ms (bytes
//   alone 1.33 ms).
// Kernels 7 and 8 stream every byte once (kernel 7's partials are 20 B per
// 4096 columns).  Kernels 9 and 10 run their products on the CUDA cores in
// f32, the TPU kernel's precision, which caps them at the 67 TFLOP/s peak;
// a simple 64 x 64 tile without double buffering reaches a fraction of it.
//
// What a later version changes: tensor-core tiles (wgmma, with TMA loads
// into a ring of shared-memory stages) for kernels 9 and 10, bf16 compute
// where the accuracy budget allows, and 16-byte vector loads in 7 and 8.
//
// Types: s, z_mean, h, W and b f32 or bf16 (h, W and b share one type); the
// accumulation is f32 throughout.  The caller checks shapes, types and
// strides, and allocates every output and workspace; each launch runs on
// the given stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr float kPad = -1e30f;          // FLASH_PAD
constexpr int kThreads = 256;
constexpr int kParts = 5;               // floats per partial: ms, ls, mt, lt, x
constexpr int kRowChunk = 4096;         // kernel 7: columns of one row per CTA
constexpr int kTile = 64;               // GEMM output tile, rows and columns
constexpr int kDepth = 16;              // GEMM k-slab in shared memory
constexpr int kLd = kTile + 4;          // shared-memory row pitch
constexpr int kHeadChunkTiles = 16;     // kernel 9: 64-column tiles per CTA
constexpr int kBwdChunk = 16384;        // kernel 10: columns per pass
constexpr int kCombineThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ------------------------------------------------------ online accumulator
struct State {
  float ms, ls, mt, lt, x;
};

__device__ __forceinline__ State empty_state() { return {-INFINITY, 0.f, -INFINITY, 0.f, 0.f}; }

// One (s, t) pair, both already scaled by 1/tau.
template <bool kLse>
__device__ __forceinline__ void push(State& a, float s, float t, float lse_t) {
  if (s > a.ms) {
    a.ls = a.ls * expf(a.ms - s) + 1.f;
    a.ms = s;
  } else {
    a.ls += expf(s - a.ms);
  }
  if (kLse) {
    a.x += expf(t - lse_t) * (t - s);
  } else if (t > a.mt) {
    const float sc = expf(a.mt - t);
    a.lt = a.lt * sc + 1.f;
    a.x = a.x * sc + (t - s);
    a.mt = t;
  } else {
    const float e = expf(t - a.mt);
    a.lt += e;
    a.x += e * (t - s);
  }
}

// a then b.  A state that saw no value (ls == 0; any value makes ls >= 1)
// is the identity.
template <bool kLse>
__device__ __forceinline__ State merge(State a, State b) {
  if (b.ls == 0.f) return a;
  if (a.ls == 0.f) return b;
  State r;
  r.ms = fmaxf(a.ms, b.ms);
  r.ls = a.ls * expf(a.ms - r.ms) + b.ls * expf(b.ms - r.ms);
  if (kLse) {
    r.mt = 0.f;
    r.lt = 0.f;
    r.x = a.x + b.x;
  } else {
    r.mt = fmaxf(a.mt, b.mt);
    const float ea = expf(a.mt - r.mt), eb = expf(b.mt - r.mt);
    r.lt = a.lt * ea + b.lt * eb;
    r.x = a.x * ea + b.x * eb;
  }
  return r;
}

template <bool kLse>
__device__ __forceinline__ State shfl_merge(State a, int offset) {
  State b;
  b.ms = __shfl_xor_sync(0xffffffffu, a.ms, offset);
  b.ls = __shfl_xor_sync(0xffffffffu, a.ls, offset);
  b.mt = __shfl_xor_sync(0xffffffffu, a.mt, offset);
  b.lt = __shfl_xor_sync(0xffffffffu, a.lt, offset);
  b.x = __shfl_xor_sync(0xffffffffu, a.x, offset);
  return merge<kLse>(a, b);
}

__device__ __forceinline__ void write_state(float* p, const State& a) {
  p[0] = a.ms;
  p[1] = a.ls;
  p[2] = a.mt;
  p[3] = a.lt;
  p[4] = a.x;
}

__device__ __forceinline__ State read_state(const float* p) { return {p[0], p[1], p[2], p[3], p[4]}; }

// ---------------------------------------------------------------- kernel 7
template <typename TS, typename TT, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_rows(const TS* __restrict__ s, const TT* __restrict__ t,
               const float* __restrict__ lse_t, float* __restrict__ part, int V,
               int n_chunks, float inv_temp) {
  __shared__ float warp_states[kThreads / 32][kParts];
  const int row = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const size_t base = (size_t)row * V;
  const int v0 = chunk * kRowChunk;
  const int v1 = min(V, v0 + kRowChunk);
  const float lt = kLse ? lse_t[row] : 0.f;
  State a = empty_state();
  for (int v = v0 + (int)threadIdx.x; v < v1; v += kThreads)
    push<kLse>(a, to_float(s[base + v]) * inv_temp, to_float(t[base + v]) * inv_temp, lt);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = shfl_merge<kLse>(a, o);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) write_state(warp_states[w], a);
  __syncthreads();
  if (threadIdx.x == 0) {
    State r = read_state(warp_states[0]);
    for (int i = 1; i < kThreads / 32; ++i) r = merge<kLse>(r, read_state(warp_states[i]));
    write_state(part + ((size_t)row * n_chunks + chunk) * kParts, r);
  }
}

// Kernels 7 and 9, second launch: each row's partials merged in chunk order,
// the rows' kl summed in a fixed order; loss = sum kl * tau^2 / B.
template <bool kLse>
__global__ void __launch_bounds__(kCombineThreads)
flash_combine(const float* __restrict__ part, const float* __restrict__ lse_t_in,
              float* __restrict__ lse_s, float* __restrict__ lse_t, float* __restrict__ loss,
              int B, int n_chunks, float loss_scale) {
  __shared__ float sums[kCombineThreads];
  float total = 0.f;
  for (int row = threadIdx.x; row < B; row += kCombineThreads) {
    const float* p = part + (size_t)row * n_chunks * kParts;
    State a = read_state(p);
    for (int c = 1; c < n_chunks; ++c) a = merge<kLse>(a, read_state(p + (size_t)c * kParts));
    const float ls = a.ms + logf(a.ls);
    float kl;
    if (kLse) {
      kl = a.x - lse_t_in[row] + ls;
    } else {
      const float lt = a.mt + logf(a.lt);
      lse_t[row] = lt;
      kl = a.x / a.lt - lt + ls;
    }
    lse_s[row] = ls;
    total += kl;
  }
  sums[threadIdx.x] = total;
  __syncthreads();
  for (int n = kCombineThreads / 2; n > 0; n >>= 1) {
    if ((int)threadIdx.x < n) sums[threadIdx.x] += sums[threadIdx.x + n];
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = sums[0] * loss_scale;
}

// ---------------------------------------------------------------- kernel 8
template <typename TS, typename TT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const TS* __restrict__ s, const TT* __restrict__ t,
                 const float* __restrict__ lse_s, const float* __restrict__ lse_t,
                 const float* __restrict__ g, TS* __restrict__ out, int B, int V,
                 float inv_temp, float tau_over_b) {
  const float c = *g * tau_over_b;
  for (int row = blockIdx.y; row < B; row += gridDim.y) {
    const size_t base = (size_t)row * V;
    const float ls = lse_s[row], lt = lse_t[row];
    for (int v = blockIdx.x * kThreads + threadIdx.x; v < V; v += gridDim.x * kThreads) {
      const float q = expf(to_float(s[base + v]) * inv_temp - ls);
      const float p = expf(to_float(t[base + v]) * inv_temp - lt);
      store(out + base + v, (q - p) * c);
    }
  }
}

// ------------------------------------------------------------ the GEMM tile
struct Slabs {
  float a[kDepth][kLd];
  float b[kDepth][kLd];
};

// dst[k][x] = src[(k0 + k) * sk + (x0 + x) * sx], 0 past (K, X).  Neighbouring
// threads take neighbouring x where x is the unit-stride axis, else
// neighbouring k, so a warp reads contiguous runs either way.
template <typename T>
__device__ __forceinline__ void load_slab(float (*dst)[kLd], const T* __restrict__ src,
                                          long long sk, long long sx, int k0, int x0, int K,
                                          int X) {
#pragma unroll
  for (int r = 0; r < kDepth * kTile / kThreads; ++r) {
    const int e = threadIdx.x + r * kThreads;
    int k, x;
    if (sx == 1) {
      k = e / kTile;
      x = e % kTile;
    } else {
      k = e % kDepth;
      x = e / kDepth;
    }
    const int gk = k0 + k, gx = x0 + x;
    dst[k][x] = (gk < K && gx < X) ? to_float(src[gk * sk + gx * sx]) : 0.f;
  }
}

// acc[i][j] = sum_{k < K} A(k, m0 + 4 ty + i) * B(k, n0 + 4 tx + j), summed in
// k order, with A(k, m) = A[k * a_sk + m * a_sx] (M rows) and
// B(k, n) = B[k * b_sk + n * b_sx] (N columns); ty = tid / 16, tx = tid % 16.
template <typename TA, typename TB>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], Slabs& sm, const TA* A,
                                          long long a_sk, long long a_sx, int M, const TB* Bm,
                                          long long b_sk, long long b_sx, int N, int K, int m0,
                                          int n0) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    load_slab(sm.a, A, a_sk, a_sx, k0, m0, K, M);
    load_slab(sm.b, Bm, b_sk, b_sx, k0, n0, K, N);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- kernel 9
// grid (n_chunks, ceil(B / 64)); h (B, D) row-major, W (D, V) at strides
// (sw_d, sw_v), bias (V,) or null, t (B, V) row-major.
template <typename TM, typename TT, bool kLse>
__global__ void __launch_bounds__(kThreads)
head_fwd_kernel(const TM* __restrict__ h, const TM* __restrict__ W, long long sw_d,
                long long sw_v, const TM* __restrict__ bias, const TT* __restrict__ t,
                const float* __restrict__ lse_t, float* __restrict__ part, int B, int D, int V,
                int n_chunks, float inv_temp) {
  __shared__ Slabs sm;
  const int chunk = blockIdx.x, m0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  State st[4];
  float lt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    st[i] = empty_state();
    lt[i] = (kLse && row < B) ? lse_t[row] : 0.f;
  }
  for (int tile = 0; tile < kHeadChunkTiles; ++tile) {
    const int n0 = (chunk * kHeadChunkTiles + tile) * kTile;
    if (n0 >= V) break;                                  // the same for every thread
    float acc[4][4];
    gemm_tile(acc, sm, h, 1, D, B, W, sw_d, sw_v, V, D, m0, n0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        float sv = kPad, tv = kPad;
        if (col < V) {
          sv = acc[i][j] + (bias != nullptr ? to_float(bias[col]) : 0.f);
          tv = row < B ? to_float(t[(size_t)row * V + col]) : 0.f;
        }
        push<kLse>(st[i], sv * inv_temp, tv * inv_temp, lt[i]);
      }
    }
  }
  // the 16 lanes tx = 0..15 of a half-warp hold the same four rows
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) st[i] = shfl_merge<kLse>(st[i], o);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row < B) write_state(part + ((size_t)row * n_chunks + chunk) * kParts, st[i]);
    }
  }
}

// --------------------------------------------------------------- kernel 10
// (a) grid (ceil(N / 64), ceil(B / 64)) over the chunk's N = min(C, V - v0)
// columns: d = g tau/B (q - p) into dws (B, C).
template <typename TM, typename TT>
__global__ void __launch_bounds__(kThreads)
head_d_kernel(const TM* __restrict__ h, const TM* __restrict__ W, long long sw_d,
              long long sw_v, const TM* __restrict__ bias, const TT* __restrict__ t,
              const float* __restrict__ lse_s, const float* __restrict__ lse_t,
              const float* __restrict__ g, float* __restrict__ dws, int B, int D, int V, int v0,
              int C, float inv_temp, float tau_over_b) {
  __shared__ Slabs sm;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int N = min(C, V - v0);
  float acc[4][4];
  gemm_tile(acc, sm, h, 1, D, B, W + v0 * sw_v, sw_d, sw_v, N, D, m0, n0);
  const float coef = *g * tau_over_b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= B) continue;
    const float ls = lse_s[row], lt = lse_t[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j, col = v0 + c;
      if (c >= N) continue;
      const float sv = acc[i][j] + (bias != nullptr ? to_float(bias[col]) : 0.f);
      const float q = expf(sv * inv_temp - ls);
      const float p = expf(to_float(t[(size_t)row * V + col]) * inv_temp - lt);
      dws[(size_t)row * C + c] = (q - p) * coef;
    }
  }
}

// (b) grid (ceil(N / 64), ceil(D / 64)): dW[:, v0 + c] = sum_b h[b, :] d[b, c].
template <typename TM>
__global__ void __launch_bounds__(kThreads)
head_gw_kernel(const TM* __restrict__ h, const float* __restrict__ dws, TM* __restrict__ gw,
               long long sw_d, long long sw_v, int B, int D, int V, int v0, int C) {
  __shared__ Slabs sm;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int N = min(C, V - v0);
  float acc[4][4];
  gemm_tile(acc, sm, h, D, 1, D, dws, C, 1, N, B, m0, n0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (d < D && c < N) store(gw + d * sw_d + (v0 + c) * sw_v, acc[i][j]);
    }
  }
}

// (c) grid (ceil(D / 64), ceil(B / 64)): dh[b, j] (+)= sum_c d[b, c] W[j, v0 + c].
template <typename TM>
__global__ void __launch_bounds__(kThreads)
head_gh_kernel(const float* __restrict__ dws, const TM* __restrict__ W, long long sw_d,
               long long sw_v, float* __restrict__ gh, int B, int D, int V, int v0, int C,
               int first) {
  __shared__ Slabs sm;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int K = min(C, V - v0);
  float acc[4][4];
  gemm_tile(acc, sm, dws, 1, C, B, W + v0 * sw_v, sw_v, sw_d, D, K, m0, n0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (b < B && col < D) {
        float* p = gh + (size_t)b * D + col;
        *p = first ? acc[i][j] : *p + acc[i][j];
      }
    }
  }
}

// (d) db[v0 + c] = sum_b d[b, c], rows in order, one thread per column.
template <typename TM>
__global__ void __launch_bounds__(kThreads)
head_gb_kernel(const float* __restrict__ dws, TM* __restrict__ gb, int B, int V, int v0, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= min(C, V - v0)) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += dws[(size_t)b * C + c];
  store(gb + v0 + c, s);
}

// ---------------------------------------------------------------- launches
inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
inline int fwd_chunks(int V) { return cdiv(V, kRowChunk); }
inline int head_chunks(int V) { return cdiv(cdiv(V, kTile), kHeadChunkTiles); }

template <typename TS, typename TT>
void launch_fwd(const void* s, const void* t, const float* lse_t_in, float* part, float* lse_s,
                float* lse_t, float* loss, int B, int V, float inv_temp, float loss_scale,
                cudaStream_t st) {
  const int n = fwd_chunks(V);
  const TS* sp = static_cast<const TS*>(s);
  const TT* tp = static_cast<const TT*>(t);
  if (lse_t_in != nullptr) {
    flash_fwd_rows<TS, TT, true><<<B * n, kThreads, 0, st>>>(sp, tp, lse_t_in, part, V, n, inv_temp);
    flash_combine<true><<<1, kCombineThreads, 0, st>>>(part, lse_t_in, lse_s, lse_t, loss, B, n,
                                                       loss_scale);
  } else {
    flash_fwd_rows<TS, TT, false><<<B * n, kThreads, 0, st>>>(sp, tp, nullptr, part, V, n, inv_temp);
    flash_combine<false><<<1, kCombineThreads, 0, st>>>(part, nullptr, lse_s, lse_t, loss, B, n,
                                                        loss_scale);
  }
}

template <typename TS, typename TT>
void launch_bwd(const void* s, const void* t, const float* lse_s, const float* lse_t,
                const float* g, void* out, int B, int V, float inv_temp, float tau_over_b,
                cudaStream_t st) {
  const dim3 grid(std::min(cdiv(V, kThreads), 4096), std::min(B, 65535));
  flash_bwd_kernel<TS, TT><<<grid, kThreads, 0, st>>>(
      static_cast<const TS*>(s), static_cast<const TT*>(t), lse_s, lse_t, g,
      static_cast<TS*>(out), B, V, inv_temp, tau_over_b);
}

template <typename TM, typename TT>
void launch_head_fwd(const void* h, const void* W, long long sw_d, long long sw_v,
                     const void* bias, const void* t, const float* lse_t_in, float* part,
                     float* lse_s, float* lse_t, float* loss, int B, int D, int V,
                     float inv_temp, float loss_scale, cudaStream_t st) {
  const int n = head_chunks(V);
  const dim3 grid(n, cdiv(B, kTile));
  const TM* hp = static_cast<const TM*>(h);
  const TM* wp = static_cast<const TM*>(W);
  const TM* bp = static_cast<const TM*>(bias);
  const TT* tp = static_cast<const TT*>(t);
  if (lse_t_in != nullptr) {
    head_fwd_kernel<TM, TT, true><<<grid, kThreads, 0, st>>>(hp, wp, sw_d, sw_v, bp, tp, lse_t_in,
                                                             part, B, D, V, n, inv_temp);
    flash_combine<true><<<1, kCombineThreads, 0, st>>>(part, lse_t_in, lse_s, lse_t, loss, B, n,
                                                       loss_scale);
  } else {
    head_fwd_kernel<TM, TT, false><<<grid, kThreads, 0, st>>>(hp, wp, sw_d, sw_v, bp, tp, nullptr,
                                                              part, B, D, V, n, inv_temp);
    flash_combine<false><<<1, kCombineThreads, 0, st>>>(part, nullptr, lse_s, lse_t, loss, B, n,
                                                        loss_scale);
  }
}

template <typename TM, typename TT>
int launch_head_bwd(const void* h, const void* W, long long sw_d, long long sw_v,
                    const void* bias, const void* t, const float* lse_s, const float* lse_t,
                    const float* g, float* gh, void* gw, void* gb, float* dws, int B, int D,
                    int V, int C, float inv_temp, float tau_over_b, cudaStream_t st) {
  const TM* hp = static_cast<const TM*>(h);
  const TM* wp = static_cast<const TM*>(W);
  const TM* bp = static_cast<const TM*>(bias);
  const TT* tp = static_cast<const TT*>(t);
  for (int v0 = 0; v0 < V; v0 += C) {
    const int N = std::min(C, V - v0);
    head_d_kernel<TM, TT><<<dim3(cdiv(N, kTile), cdiv(B, kTile)), kThreads, 0, st>>>(
        hp, wp, sw_d, sw_v, bp, tp, lse_s, lse_t, g, dws, B, D, V, v0, C, inv_temp, tau_over_b);
    head_gw_kernel<TM><<<dim3(cdiv(N, kTile), cdiv(D, kTile)), kThreads, 0, st>>>(
        hp, dws, static_cast<TM*>(gw), sw_d, sw_v, B, D, V, v0, C);
    head_gh_kernel<TM><<<dim3(cdiv(D, kTile), cdiv(B, kTile)), kThreads, 0, st>>>(
        dws, wp, sw_d, sw_v, gh, B, D, V, v0, C, v0 == 0);
    if (gb != nullptr)
      head_gb_kernel<TM><<<cdiv(N, kThreads), kThreads, 0, st>>>(dws, static_cast<TM*>(gb), B, V,
                                                                 v0, C);
    const cudaError_t err = cudaGetLastError();   // stop at the first refused launch
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Each launcher returns 0 on success, a cudaError_t code if a launch failed,
// -1 for a shape or type the kernels do not take.  dtype: 0 float32,
// 1 bfloat16.  g: the upstream gradient, one f32 on the device.

// Workspace sizes the caller allocates: kernel 7's and 9's partials are
// (B, chunks, 5) f32; kernel 10's workspace is (B, chunk) f32.
int flash_kd_fwd_chunks(int V) { return fwd_chunks(V); }
int flash_kd_head_fwd_chunks(int V) { return head_chunks(V); }
int flash_kd_head_bwd_chunk(int V) { return std::min(V, kBwdChunk); }

// Kernel 7.  lse_t_in: the teacher's lse (B,) or null; lse_t is written only
// when it is null.  loss_scale = tau^2 / B.
int flash_kd_fwd(const void* s, const void* t, const float* lse_t_in, float* part, float* lse_s,
                 float* lse_t, float* loss, int B, int V, float inv_temp, float loss_scale,
                 int sdtype, int tdtype, void* stream) {
  if (B < 1 || V < 1 || (long long)B * fwd_chunks(V) > 0x7fffffffLL) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sdtype == 0 && tdtype == 0)
    launch_fwd<float, float>(s, t, lse_t_in, part, lse_s, lse_t, loss, B, V, inv_temp, loss_scale, st);
  else if (sdtype == 0 && tdtype == 1)
    launch_fwd<float, __nv_bfloat16>(s, t, lse_t_in, part, lse_s, lse_t, loss, B, V, inv_temp,
                                     loss_scale, st);
  else if (sdtype == 1 && tdtype == 0)
    launch_fwd<__nv_bfloat16, float>(s, t, lse_t_in, part, lse_s, lse_t, loss, B, V, inv_temp,
                                     loss_scale, st);
  else if (sdtype == 1 && tdtype == 1)
    launch_fwd<__nv_bfloat16, __nv_bfloat16>(s, t, lse_t_in, part, lse_s, lse_t, loss, B, V,
                                             inv_temp, loss_scale, st);
  else
    return -1;
  return (int)cudaGetLastError();
}

// Kernel 8.  out takes s's type; tau_over_b = tau / B.
int flash_kd_bwd(const void* s, const void* t, const float* lse_s, const float* lse_t,
                 const float* g, void* out, int B, int V, float inv_temp, float tau_over_b,
                 int sdtype, int tdtype, void* stream) {
  if (B < 1 || V < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sdtype == 0 && tdtype == 0)
    launch_bwd<float, float>(s, t, lse_s, lse_t, g, out, B, V, inv_temp, tau_over_b, st);
  else if (sdtype == 0 && tdtype == 1)
    launch_bwd<float, __nv_bfloat16>(s, t, lse_s, lse_t, g, out, B, V, inv_temp, tau_over_b, st);
  else if (sdtype == 1 && tdtype == 0)
    launch_bwd<__nv_bfloat16, float>(s, t, lse_s, lse_t, g, out, B, V, inv_temp, tau_over_b, st);
  else if (sdtype == 1 && tdtype == 1)
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(s, t, lse_s, lse_t, g, out, B, V, inv_temp,
                                             tau_over_b, st);
  else
    return -1;
  return (int)cudaGetLastError();
}

// Kernel 9.  W (D, V) at element strides (sw_d, sw_v); bias (V,) or null;
// mdtype is the type of h, W and bias.
int flash_kd_head_fwd(const void* h, const void* W, long long sw_d, long long sw_v,
                      const void* bias, const void* t, const float* lse_t_in, float* part,
                      float* lse_s, float* lse_t, float* loss, int B, int D, int V,
                      float inv_temp, float loss_scale, int mdtype, int tdtype, void* stream) {
  if (B < 1 || D < 1 || V < 1 || cdiv(B, kTile) > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mdtype == 0 && tdtype == 0)
    launch_head_fwd<float, float>(h, W, sw_d, sw_v, bias, t, lse_t_in, part, lse_s, lse_t, loss,
                                  B, D, V, inv_temp, loss_scale, st);
  else if (mdtype == 0 && tdtype == 1)
    launch_head_fwd<float, __nv_bfloat16>(h, W, sw_d, sw_v, bias, t, lse_t_in, part, lse_s, lse_t,
                                          loss, B, D, V, inv_temp, loss_scale, st);
  else if (mdtype == 1 && tdtype == 0)
    launch_head_fwd<__nv_bfloat16, float>(h, W, sw_d, sw_v, bias, t, lse_t_in, part, lse_s, lse_t,
                                          loss, B, D, V, inv_temp, loss_scale, st);
  else if (mdtype == 1 && tdtype == 1)
    launch_head_fwd<__nv_bfloat16, __nv_bfloat16>(h, W, sw_d, sw_v, bias, t, lse_t_in, part,
                                                  lse_s, lse_t, loss, B, D, V, inv_temp,
                                                  loss_scale, st);
  else
    return -1;
  return (int)cudaGetLastError();
}

// Kernel 10.  gh: (B, D) f32; gw: W's shape, strides and type; gb: (V,) in
// W's type, or null without a bias; dws: (B, C) f32 with C from
// flash_kd_head_bwd_chunk.
int flash_kd_head_bwd(const void* h, const void* W, long long sw_d, long long sw_v,
                      const void* bias, const void* t, const float* lse_s, const float* lse_t,
                      const float* g, float* gh, void* gw, void* gb, float* dws, int B, int D,
                      int V, int C, float inv_temp, float tau_over_b, int mdtype, int tdtype,
                      void* stream) {
  if (B < 1 || D < 1 || V < 1 || C < 1 || cdiv(B, kTile) > 65535 || cdiv(D, kTile) > 65535)
    return -1;
  if ((bias == nullptr) != (gb == nullptr)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mdtype == 0 && tdtype == 0)
    return launch_head_bwd<float, float>(h, W, sw_d, sw_v, bias, t, lse_s, lse_t, g, gh, gw, gb,
                                         dws, B, D, V, C, inv_temp, tau_over_b, st);
  if (mdtype == 0 && tdtype == 1)
    return launch_head_bwd<float, __nv_bfloat16>(h, W, sw_d, sw_v, bias, t, lse_s, lse_t, g, gh,
                                                 gw, gb, dws, B, D, V, C, inv_temp, tau_over_b,
                                                 st);
  if (mdtype == 1 && tdtype == 0)
    return launch_head_bwd<__nv_bfloat16, float>(h, W, sw_d, sw_v, bias, t, lse_s, lse_t, g, gh,
                                                 gw, gb, dws, B, D, V, C, inv_temp, tau_over_b,
                                                 st);
  if (mdtype == 1 && tdtype == 1)
    return launch_head_bwd<__nv_bfloat16, __nv_bfloat16>(h, W, sw_d, sw_v, bias, t, lse_s, lse_t,
                                                         g, gh, gw, gb, dws, B, D, V, C, inv_temp,
                                                         tau_over_b, st);
  return -1;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
