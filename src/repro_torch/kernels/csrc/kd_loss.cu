// Dense ensemble knowledge distillation for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of repro/kernels/kd_loss/kernel.py:38-135:
//
//   ensemble_softmax  (kernel.py:57, body :38)   x (M,N,V) -> softmax(mean_m x[m] / tau), f32
//   kd_loss_fwd       (kernel.py:88, body :77)   per row sum t*(log max(t,1e-20) - log_softmax(s/tau))
//   kd_loss_bwd       (kernel.py:120, body :109) (softmax(s/tau) - t) * g * tau / B
//
// Same functions, not the same block structure.  The TPU grid runs in
// order and carries the ensemble sum in its output block across the M axis;
// here one row-group (a warp when V <= 1024, else a CTA of 1024 threads)
// owns one row and loops over M and V itself:
//
//   * ensemble_softmax: pass 1 accumulates x[m,n,v] * (1/M) in m order (as
//     the TPU kernel does), scales by 1/tau, writes the scaled mean into the
//     output row as scratch and keeps a running max and exp-sum; the
//     row-group merges them; pass 2 rewrites the row as exp(z - max) / sum;
//   * kd_loss_fwd: pass 1 the log-sum-exp of s/tau (running max and sum),
//     pass 2 the row's KL term, reduced in a fixed order (no atomics), one
//     f32 per row; the wrapper takes kl.sum() / B * tau^2 as kernel.py:103
//     does outside its kernel;
//   * kd_loss_bwd: pass 1 the log-sum-exp, pass 2 (exp(s/tau - lse) - t) * c
//     with c = g * tau / B, g read from device memory (a scalar from
//     autograd: reading it on the host would sync every KD step).
//
// Rows are not padded: the 128-lane pad of the TPU version is a TPU
// artifact.  A row of V = 152,064 f32 (608 KB) does not fit in shared
// memory, so each kernel takes two passes over global memory.
//
// Bound on this card: HBM bytes at 3.35 TB/s (H100 SXM).  At V = 152,064,
// B = 256, f32: ensemble_softmax with M = 4 reads 4 rows and writes 1 per
// row, 0.232 ms; kd_loss_fwd reads s and t, 0.093 ms; kd_loss_bwd reads s
// and t and writes the gradient, 0.139 ms.  The two-pass design moves
// about 1.4x, 1.5x and 1.33x those bytes (the second pass re-reads what
// the first read or wrote).  At the FedSDD round's own V = 10 every
// launch is bound by its latency.
//
// What a later version changes: a row per warp with vectorised 16-byte
// loads for mid-size V, and one pass for rows that fit in shared memory
// (the row staged once, reduced and rewritten from there).
//
// Types: s and the teacher logits f32 or bf16, t f32; outputs f32 except
// the gradient, which takes s's type.  The caller checks shapes, types and
// contiguity; every launch runs on the given stream, allocates nothing and
// does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarpMaxV = 1024;        // V up to this: one warp per row
constexpr int kWarpRows = 8;           // rows (warps) per CTA in that case
constexpr int kRowThreads = 1024;      // else one CTA of this many threads per row

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Running max m and sum l of exp(z - m) over the values seen.
struct MaxSum {
  float m, l;
};

__device__ __forceinline__ MaxSum push(MaxSum a, float z) {
  if (z > a.m) {
    a.l = a.l * expf(a.m - z) + 1.f;
    a.m = z;
  } else {
    a.l += expf(z - a.m);
  }
  return a;
}

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  return {m, a.l * expf(a.m - m) + b.l * expf(b.m - m)};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ MaxSum warp_max_sum(MaxSum a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const MaxSum b{__shfl_xor_sync(0xffffffffu, a.m, o), __shfl_xor_sync(0xffffffffu, a.l, o)};
    a = merge(a, b);
  }
  return a;
}

// A row-group is a warp or a whole CTA; ``lane`` runs over [0, kSize).
// Both reduce in a fixed order, so the results are deterministic.
struct WarpRow {
  static constexpr int kSize = 32;
  int lane;
  __device__ float sum(float v) const { return warp_sum(v); }
  __device__ MaxSum max_sum(MaxSum a) const { return warp_max_sum(a); }
};

struct BlockRow {
  static constexpr int kSize = kRowThreads;
  static constexpr int kWarps = kRowThreads / 32;
  int lane;
  float* smem;  // 2 * kWarps + 2 floats

  __device__ float sum(float v) const {
    v = warp_sum(v);
    const int w = lane >> 5, l = lane & 31;
    if (l == 0) smem[w] = v;
    __syncthreads();
    if (w == 0) {
      float r = warp_sum(l < kWarps ? smem[l] : 0.f);
      if (l == 0) smem[2 * kWarps] = r;
    }
    __syncthreads();
    const float r = smem[2 * kWarps];
    __syncthreads();  // smem is reused by the next reduction
    return r;
  }

  __device__ MaxSum max_sum(MaxSum a) const {
    a = warp_max_sum(a);
    const int w = lane >> 5, l = lane & 31;
    if (l == 0) {
      smem[w] = a.m;
      smem[kWarps + w] = a.l;
    }
    __syncthreads();
    if (w == 0) {
      MaxSum b = l < kWarps ? MaxSum{smem[l], smem[kWarps + l]} : MaxSum{kNegInf, 0.f};
      b = warp_max_sum(b);
      if (l == 0) {
        smem[2 * kWarps] = b.m;
        smem[2 * kWarps + 1] = b.l;
      }
    }
    __syncthreads();
    const MaxSum r{smem[2 * kWarps], smem[2 * kWarps + 1]};
    __syncthreads();
    return r;
  }
};

// -------------------------------------------------------------- row bodies
template <typename T, typename G>
__device__ void ensemble_row(const T* __restrict__ x, float* __restrict__ out, int M,
                             size_t plane, int V, float inv_m, float inv_temp, const G& g) {
  MaxSum a{kNegInf, 0.f};
  for (int v = g.lane; v < V; v += G::kSize) {
    float z = to_float(x[v]) * inv_m;
    for (int m = 1; m < M; ++m) z += to_float(x[m * plane + v]) * inv_m;
    z *= inv_temp;
    out[v] = z;  // scratch until pass 2; each lane re-reads only its own
    a = push(a, z);
  }
  a = g.max_sum(a);
  for (int v = g.lane; v < V; v += G::kSize) out[v] = expf(out[v] - a.m) / a.l;
}

template <typename T, typename G>
__device__ float row_lse(const T* __restrict__ s, int V, float inv_temp, const G& g) {
  MaxSum a{kNegInf, 0.f};
  for (int v = g.lane; v < V; v += G::kSize) a = push(a, to_float(s[v]) * inv_temp);
  a = g.max_sum(a);
  return a.m + logf(a.l);
}

template <typename T, typename G>
__device__ float kd_fwd_row(const T* __restrict__ s, const float* __restrict__ t, int V,
                            float inv_temp, const G& g) {
  const float lse = row_lse(s, V, inv_temp, g);
  float kl = 0.f;
  for (int v = g.lane; v < V; v += G::kSize) {
    const float tv = t[v];
    kl += tv * (logf(fmaxf(tv, 1e-20f)) - (to_float(s[v]) * inv_temp - lse));
  }
  return g.sum(kl);
}

template <typename T, typename G>
__device__ void kd_bwd_row(const T* __restrict__ s, const float* __restrict__ t,
                           T* __restrict__ out, int V, float inv_temp, float c, const G& g) {
  const float lse = row_lse(s, V, inv_temp, g);
  for (int v = g.lane; v < V; v += G::kSize)
    store(out + v, (expf(to_float(s[v]) * inv_temp - lse) - t[v]) * c);
}

// ----------------------------------------------------------------- kernels
// Warp-per-row kernels: kWarpRows rows per CTA; a warp past the last row
// leaves as a whole, so its shuffles never see a missing lane.
template <typename T>
__global__ void __launch_bounds__(kWarpRows * 32)
ensemble_softmax_warp(const T* x, float* out, int M, int N, int V, float inv_m, float inv_temp) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= N) return;
  ensemble_row(x + (size_t)row * V, out + (size_t)row * V, M, (size_t)N * V, V, inv_m,
               inv_temp, WarpRow{(int)(threadIdx.x & 31)});
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ensemble_softmax_block(const T* x, float* out, int M, int N, int V, float inv_m, float inv_temp) {
  __shared__ float smem[2 * BlockRow::kWarps + 2];
  const size_t row = blockIdx.x;
  ensemble_row(x + row * V, out + row * V, M, (size_t)N * V, V, inv_m, inv_temp,
               BlockRow{(int)threadIdx.x, smem});
}

template <typename T>
__global__ void __launch_bounds__(kWarpRows * 32)
kd_fwd_warp(const T* s, const float* t, float* kl, int B, int V, float inv_temp) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= B) return;
  const WarpRow g{(int)(threadIdx.x & 31)};
  const float r = kd_fwd_row(s + (size_t)row * V, t + (size_t)row * V, V, inv_temp, g);
  if (g.lane == 0) kl[row] = r;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
kd_fwd_block(const T* s, const float* t, float* kl, int B, int V, float inv_temp) {
  __shared__ float smem[2 * BlockRow::kWarps + 2];
  const size_t row = blockIdx.x;
  const BlockRow g{(int)threadIdx.x, smem};
  const float r = kd_fwd_row(s + row * V, t + row * V, V, inv_temp, g);
  if (g.lane == 0) kl[row] = r;
}

template <typename T>
__global__ void __launch_bounds__(kWarpRows * 32)
kd_bwd_warp(const T* s, const float* t, const float* gup, T* out, int B, int V, float inv_temp,
            float scale) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= B) return;
  const size_t off = (size_t)row * V;
  kd_bwd_row(s + off, t + off, out + off, V, inv_temp, *gup * scale,
             WarpRow{(int)(threadIdx.x & 31)});
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
kd_bwd_block(const T* s, const float* t, const float* gup, T* out, int B, int V, float inv_temp,
             float scale) {
  __shared__ float smem[2 * BlockRow::kWarps + 2];
  const size_t off = (size_t)blockIdx.x * V;
  kd_bwd_row(s + off, t + off, out + off, V, inv_temp, *gup * scale,
             BlockRow{(int)threadIdx.x, smem});
}

inline int warp_grid(int rows) { return (rows + kWarpRows - 1) / kWarpRows; }

template <typename T>
void launch_ensemble(const void* x, void* out, int M, int N, int V, float inv_temp,
                     cudaStream_t s) {
  const float inv_m = 1.f / (float)M;
  const T* xt = static_cast<const T*>(x);
  float* o = static_cast<float*>(out);
  if (V <= kWarpMaxV)
    ensemble_softmax_warp<T><<<warp_grid(N), kWarpRows * 32, 0, s>>>(xt, o, M, N, V, inv_m, inv_temp);
  else
    ensemble_softmax_block<T><<<N, kRowThreads, 0, s>>>(xt, o, M, N, V, inv_m, inv_temp);
}

template <typename T>
void launch_fwd(const void* s_, const float* t, float* kl, int B, int V, float inv_temp,
                cudaStream_t s) {
  const T* st = static_cast<const T*>(s_);
  if (V <= kWarpMaxV)
    kd_fwd_warp<T><<<warp_grid(B), kWarpRows * 32, 0, s>>>(st, t, kl, B, V, inv_temp);
  else
    kd_fwd_block<T><<<B, kRowThreads, 0, s>>>(st, t, kl, B, V, inv_temp);
}

template <typename T>
void launch_bwd(const void* s_, const float* t, const float* g, void* out, int B, int V,
                float inv_temp, float scale, cudaStream_t s) {
  const T* st = static_cast<const T*>(s_);
  T* o = static_cast<T*>(out);
  if (V <= kWarpMaxV)
    kd_bwd_warp<T><<<warp_grid(B), kWarpRows * 32, 0, s>>>(st, t, g, o, B, V, inv_temp, scale);
  else
    kd_bwd_block<T><<<B, kRowThreads, 0, s>>>(st, t, g, o, B, V, inv_temp, scale);
}

}  // namespace

extern "C" {

// Each returns 0 on success, a cudaError_t code if the launch failed, -1
// for a shape or type the kernels do not take.  dtype: 0 float32, 1 bfloat16.

int ensemble_softmax(const void* x, void* out, int M, int N, int V, float inv_temp, int dtype,
                     void* stream) {
  if (M < 1 || N < 1 || V < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_ensemble<float>(x, out, M, N, V, inv_temp, s);
  else if (dtype == 1)
    launch_ensemble<__nv_bfloat16>(x, out, M, N, V, inv_temp, s);
  else
    return -1;
  return (int)cudaGetLastError();
}

int kd_loss_fwd(const void* s_logits, const void* t_probs, void* kl, int B, int V,
                float inv_temp, int dtype, void* stream) {
  if (B < 1 || V < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(t_probs);
  float* k = static_cast<float*>(kl);
  if (dtype == 0)
    launch_fwd<float>(s_logits, t, k, B, V, inv_temp, s);
  else if (dtype == 1)
    launch_fwd<__nv_bfloat16>(s_logits, t, k, B, V, inv_temp, s);
  else
    return -1;
  return (int)cudaGetLastError();
}

// g: one f32 on the device (the upstream gradient); scale = tau / B.
int kd_loss_bwd(const void* s_logits, const void* t_probs, const void* g, void* out, int B,
                int V, float inv_temp, float scale, int dtype, void* stream) {
  if (B < 1 || V < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(t_probs);
  const float* gp = static_cast<const float*>(g);
  if (dtype == 0)
    launch_bwd<float>(s_logits, t, gp, out, B, V, inv_temp, scale, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(s_logits, t, gp, out, B, V, inv_temp, scale, s);
  else
    return -1;
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
