// Dense ensemble knowledge distillation for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of repro/kernels/kd_loss/kernel.py:38-135:
//
//   ensemble_softmax  (kernel.py:57, body :38)   x (M,N,V) -> softmax(mean_m x[m] / tau), f32
//   kd_loss_fwd       (kernel.py:88, body :77)   mean_b sum_v t*(log max(t,1e-20) - log_softmax(s/tau)) * tau^2
//   kd_loss_bwd       (kernel.py:120, body :109) (softmax(s/tau) - t) * g * tau / B
//
// Same functions, not the same block structure: the TPU grid runs in
// order and keeps a (4, V) row tile in VMEM; here blocks run in no order.
//
// ensemble_softmax (plan: ensemble_plan in kernels/kd_loss/ops.py).  Every
// byte of the M teacher rows and of the output crosses HBM once: z =
// (sum_m x[m] * (1/M)) * (1/tau) is accumulated in registers in m order
// (explicit __fmul_rn / __fmaf_rn, so no load width changes a bit), written
// once into shared memory, and the output written once as exp(z - max) / sum.
//
//   * staged (V > 1024): a row goes to one CTA or a cluster of C CTAs, each
//     owning a slice whose f32 z fits its shared memory (at most 110 KB a
//     CTA, two CTAs an SM: the fewest CTAs up to 16, non-portable above 8;
//     gemma-2b's row takes 10).  A CTA streams its slice of the M teacher
//     rows with 16-byte loads, four rows' loads in flight a thread (plain
//     loads at a ragged head and tail, and for every element when the
//     rows' 16-byte phases differ), keeping the slice's max as z lands;
//     then the sum of exp(z - max) over shared memory in a fixed order; the
//     cluster's (max, sum) states go to every CTA over distributed shared
//     memory and each CTA merges them in rank order; it writes its slice
//     with 16-byte stores.  On the card (NVIDIA H100 80GB HBM3, 700 W;
//     tools/kernel_ab.py --ens-plans), 8 CTAs of 128 KB for gemma-2b's
//     row (one CTA an SM) were 14-22% slower than 10 of 102 KB; at 10,
//     eight rows' loads in flight or a fast exp moved nothing beyond the
//     noise, and streaming cache hints were 2-6% slower (PERF.md).
//   * small (V <= 1024): a CTA takes a block of whole rows, whose elements
//     are contiguous in every teacher plane, and stages their z the same
//     way (16-byte loads over the block, all M planes in flight; blocks of
//     whole 16-byte groups where V allows); then `lanes` lanes a row form
//     the row's max and sum from shared memory by xor shuffles and write
//     its probabilities.  The FedSDD round's 8 x 2,048 x 10 is 41 such
//     CTAs: it is bound by one round trip to HBM and the launch.
//
// No step depends on where x or the output lies in memory: the same
// inputs at any storage offset give the same bits.  Bound: HBM bytes (M
// rows read, one written).
//
// kd_loss_fwd / kd_loss_bwd.  What bounds them: HBM bytes at an LM
// vocabulary (s and t read once, the gradient written once: at V = 256,000,
// B = 512, f32, 0.313 ms and 0.469 ms at 3.35 TB/s), one launch at the
// FedSDD round's V = 10 (256 x 10 f32 is 20 KB, 6 ns of HBM time).  Both
// need the row's log-sum-exp before the second pass over the row, and a row
// of V = 256,000 f32 is 1 MB: 132 such rows in flight overflow the 50 MB L2,
// so a second read of s from global memory goes back to HBM.  The one-pass
// form (online lse, KL = sum t log t - sum t z + lse sum t) would avoid it
// but cancels terms of size |lse| ~ 12 and misses the loss's rtol 1e-4 for
// a student near its teacher (tests/test_torch_kd_staged.py), so both
// kernels keep the reference's two passes and stage s in shared memory:
//
//   * staged (V > 1024): a row-group, one CTA or a cluster of C CTAs over
//     slices of the row, copies its slice of s into shared memory once: the
//     16-byte-aligned middle by cp.async.bulk in kStageChunks pieces, each
//     on its own mbarrier, the ragged head and tail (any 4- or 2-byte
//     offset) by plain loads.  Pass 1 takes the slice's max of z = s / tau
//     piece by piece as the pieces land, then its sum of exp(z - max), each
//     reduced over the CTA's warps in a fixed order; the cluster's (max,
//     sum) states go to every CTA over distributed shared memory and each
//     CTA merges them in rank order, so all hold the same lse.  Pass 2
//     reads s from shared memory and streams t with 16-byte loads, the next
//     16 floats a thread in flight while it works on these: kd_loss_fwd
//     sums t * (log max(t, 1e-20) - (z - lse)) and rank 0 adds the CTAs'
//     sums in rank order; kd_loss_bwd writes (exp(z - lse) - t) * g * tau /
//     B in s's type with 16-byte stores.  Every byte of s, t and the
//     gradient crosses HBM once.  No step depends on where the row lies in
//     memory, so a student at any offset gives the same bits.
//   * small (V <= 1024, B * V <= 8192): kd_loss_fwd runs ONE CTA of 1024
//     threads that stages all of s and t; each row goes to a group of lanes
//     (4 at the round's 256 x 10) that forms its lse and KL, and the same
//     CTA sums the rows and writes the loss: one launch (it was four: the
//     kernel, then the wrapper's kl.sum(), / B, * tau^2).  kd_loss_bwd needs
//     no sum over rows and spreads the rows over one-warp CTAs with the
//     same lanes a row, so its lse has the forward's bits.
//     What bounds both here is latency: the one CTA's round trip to HBM
//     and its reductions.
//   * rows (V <= 1024, larger B): a thread (V <= 32) or a warp per row over
//     global memory; its second read of the row (4 KB at most) hits L1.
//
// kd_loss_fwd writes the scalar itself: in the small path, and in the
// staged path when B = 1; otherwise the row kernel writes the (B,) KLs and
// a one-CTA finish kernel sums them (thread i the rows [i*k, i*k + k) in
// row order, then a fixed shuffle tree) and scales by tau^2 / B: two
// launches.  No atomics anywhere, so two calls give the same bits, and
// kd_loss_bwd forms lse with the same code and order as kd_loss_fwd for
// the same (B, V), so both passes of a training step use the same lse.
//
// Sizes (the plan is kd_plan in kernels/kd_loss/ops.py, passed in by the
// caller, as the card chose them with tools/kernel_ab.py --kd-plans): 512
// threads a staged CTA; a slice of at most 110 KB of s a CTA (two CTAs an
// SM), in slices of whole 8-element groups; the fewest CTAs a cluster that
// keeps to that share, up to the portable 8 (V = 152,064 f32: 6 CTAs of 99
// KB; V = 256,000 bf16: 5 of 100 KB; V = 256,000 f32: 8 of 125 KB, one CTA
// an SM), and up to 16 (non-portable) only for rows that do not fit 8 CTAs.
// On the card, a cluster of 10 for 256,000 f32 (two CTAs an SM) and
// smaller or larger shares were not faster for both kernels; an L2
// prefetch of t's slice while s staged, and persistent clusters that
// stage the next row's slice under this row's passes (one CTA an SM, two
// slices each), were slower (PERF.md).
//
// Types: s and the teacher logits f32 or bf16, t f32; outputs f32 except
// the gradient, which takes s's type.  The caller checks shapes, types and
// contiguity; every launch runs on the given stream, allocates nothing and
// does not synchronise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarpMaxV = 1024;        // kernels 3-4: V up to this, lanes of one warp a row

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Running max m and sum l of exp(z - m) over the values seen.
struct MaxSum {
  float m, l;
};

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  return {m, a.l * expf(a.m - m) + b.l * expf(b.m - m)};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ================================================= kd_loss_fwd / kd_loss_bwd
// Paths and sizes: kd_plan in kernels/kd_loss/ops.py (kept in step with these).
enum Path { kSmall = 0, kRows = 1, kStaged = 2 };
constexpr int kSmallMaxElems = 8192;   // small: B * V up to this, in one CTA
constexpr int kSmallThreads = 1024;    // small, and the finish kernel
constexpr int kRowsThreads = 256;      // rows: threads a CTA
constexpr int kStagedThreads = 512;    // staged: threads a CTA
constexpr int kMaxCluster = 16;        // staged: CTAs a row, at most (8 portable)
constexpr int kSmemMax = 232448 - 1024;  // dynamic shared memory a CTA (227 KB less static)
constexpr long kBulkBytes = 65536;     // bytes a bulk copy, at most

// Bytes of a staged copy of n elements of `elt` bytes: a 16-byte lead-in so
// the copy keeps the source's 16-byte phase, rounded to 16.
__host__ __device__ constexpr long staged_bytes(long n, int elt) {
  return (n * elt + 16 + 15) / 16 * 16;
}

template <int kWarps>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  // every warp reduces the same partials in the same order: one result
  const int l = threadIdx.x & 31;
  const float r = warp_sum(l < kWarps ? red[l] : 0.f);
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <int kWarps>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int l = threadIdx.x & 31;
  const float r = warp_max(l < kWarps ? red[l] : kNegInf);
  __syncthreads();
  return r;
}

// loss = (sum_r kl[r]) * scale over B rows, by the kSmallThreads threads of
// one CTA: thread i adds the rows [i*k, i*k + k) in row order (k = ceil(B /
// kSmallThreads)), then block_sum.
__device__ void finish_rows(const float* kl, int B, float scale, float* loss, float* red) {
  const int k = (B + kSmallThreads - 1) / kSmallThreads;
  const int r0 = min(B, (int)threadIdx.x * k), r1 = min(B, r0 + k);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) acc += kl[r];
  acc = block_sum<kSmallThreads / 32>(acc, red);
  if (threadIdx.x == 0) *loss = acc * scale;
}

__global__ void __launch_bounds__(kSmallThreads)
kd_finish(const float* __restrict__ kl, int B, float scale, float* __restrict__ loss) {
  __shared__ float red[32];
  finish_rows(kl, B, scale, loss, red);
}

// ---- the row code of the small and rows paths (any memory) -------------
// A row is `size` lanes of one warp (a power of two up to 32): lane i takes
// elements i, i + size, ... in order, and the lanes' values meet by xor
// shuffles, a fixed order.  Every lane of the warp calls the reductions: a
// lane without a row passes V = 0.
struct LaneRow {
  int lane, size;
  __device__ float sum(float v) const {
    for (int o = size >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  __device__ float max(float v) const {
    for (int o = size >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
};

// lse of z = s * inv_temp: the max, then the sum of exp(z - max).
template <typename T>
__device__ __forceinline__ float row_lse(const T* s, int V, float inv_temp, const LaneRow& g) {
  float m = kNegInf;
  for (int v = g.lane; v < V; v += g.size) m = fmaxf(m, to_float(s[v]) * inv_temp);
  m = g.max(m);
  float l = 0.f;
  for (int v = g.lane; v < V; v += g.size) l += expf(to_float(s[v]) * inv_temp - m);
  return m + logf(g.sum(l));
}

__device__ __forceinline__ float kl_term(float t, float z, float lse) {
  return t * (logf(fmaxf(t, 1e-20f)) - (z - lse));
}

template <typename T>
__device__ __forceinline__ float row_kl(const T* s, const float* t, int V, float inv_temp,
                                        float lse, const LaneRow& g) {
  float acc = 0.f;
  for (int v = g.lane; v < V; v += g.size) acc += kl_term(t[v], to_float(s[v]) * inv_temp, lse);
  return g.sum(acc);
}

// ---- staging: global -> shared, keeping the source's 16-byte phase -----
// Element i of a staged range lies at dst + pad + i, pad = (src & 15) /
// sizeof(X): the 16-byte-aligned middle [head, head + mid) goes by bulk
// copies; the head and the tail are plain loads.
struct Parts {
  int pad, head, mid, n;
};

template <typename X>
__device__ __forceinline__ Parts parts(const X* src, int n) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  Parts p;
  p.n = n;
  p.pad = mis / (int)sizeof(X);
  p.head = mis ? min(n, (16 - mis) / (int)sizeof(X)) : 0;
  p.mid = (int)(((long)(n - p.head) * sizeof(X)) / 16 * 16 / sizeof(X));
  return p;
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(hopper::smem_u32(dst)), "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// Thread 0: the middle of a staged range, in copies of at most kBulkBytes.
template <typename X>
__device__ __forceinline__ void stage_bulk(const Parts& p, X* dst, const X* src, uint64_t* bar) {
  const char* g = reinterpret_cast<const char*>(src + p.head);
  char* d = reinterpret_cast<char*>(dst + p.pad + p.head);
  const long total = (long)p.mid * sizeof(X);
  for (long off = 0; off < total; off += kBulkBytes)
    bulk_g2s(d + off, g + off, (uint32_t)(total - off < kBulkBytes ? total - off : kBulkBytes), bar);
}

// Every thread: the head and tail elements of a staged range.
template <typename X>
__device__ __forceinline__ void stage_edges(const Parts& p, X* dst, const X* src, int tid,
                                            int threads) {
  const int tail0 = p.head + p.mid, edges = p.head + (p.n - tail0);
  for (int i = tid; i < edges; i += threads) {
    const int j = i < p.head ? i : tail0 + (i - p.head);
    dst[p.pad + j] = src[j];
  }
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count = 1) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) hopper::mbar_init(bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---- vector helpers for the staged pass 2 -------------------------------
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// W values from p as floats; ``vec``: p is aligned to 4 elements (16 bytes
// in f32, 8 in bf16), so they go by vector loads.
template <int W, typename X>
__device__ __forceinline__ void load_vals(const X* p, float (&x)[W], bool vec) {
  if constexpr (std::is_same<X, float>::value) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const float4 q = reinterpret_cast<const float4*>(p)[k];
        x[4 * k] = q.x, x[4 * k + 1] = q.y, x[4 * k + 2] = q.z, x[4 * k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) x[k] = p[k];
    }
  } else {
    if (vec) {
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const uint2 q = reinterpret_cast<const uint2*>(p)[k];
        unpack_bf16x2(q.x, x[4 * k], x[4 * k + 1]);
        unpack_bf16x2(q.y, x[4 * k + 2], x[4 * k + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) x[k] = to_float(p[k]);
    }
  }
}

// 16 bytes of results to a 16-byte-aligned p (W = 4 f32 or 8 bf16).
template <int W, typename T>
__device__ __forceinline__ void store_vals(T* p, const float (&y)[W]) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]),
                                              pack_bf16x2(y[4], y[5]), pack_bf16x2(y[6], y[7]));
  }
}

template <typename X>
__device__ __forceinline__ bool aligned_to(const X* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Elements before the first 16-byte boundary of `anchor`, at most n.
template <typename X>
__device__ __forceinline__ int lead(const X* anchor, int n) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(anchor) & 15);
  return mis ? min(n, (16 - mis) / (int)sizeof(X)) : 0;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// Groups [0, groups) of W floats of t from t0 (group i at t0 + i * W), U at
// a time: thread tid takes groups tid, tid + kStagedThreads, ... in order and
// calls f(group, values); the next U groups' loads are in flight while f
// runs on these.
template <int W, int U, typename F>
__device__ __forceinline__ void stream_groups(const float* t0, int groups, bool vec, F&& f) {
  constexpr int kStep = U * kStagedThreads;
  float cur[U][W], nxt[U][W];
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (tid + u * kStagedThreads < groups)
      load_vals<W>(t0 + (tid + u * kStagedThreads) * W, cur[u], vec);
  for (int g0 = tid; g0 < groups; g0 += kStep) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (g0 + kStep + u * kStagedThreads < groups)
        load_vals<W>(t0 + (g0 + kStep + u * kStagedThreads) * W, nxt[u], vec);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (g0 + u * kStagedThreads < groups) f(g0 + u * kStagedThreads, cur[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < W; ++k) cur[u][k] = nxt[u][k];
  }
}

// ---- the staged path ------------------------------------------------------
// Grid: B * cluster CTAs, clusters of `cluster` along x; CTA rank q of the
// row's cluster owns the slice [q * slice, min(V, q * slice + slice)).  The
// slice's bulk copy goes in kStageChunks pieces, each on its own mbarrier,
// and pass 1 takes the max of each piece as it lands.
// kd_loss_fwd: the row's KL into kl[row], or the loss into *loss when kl is
// null (B = 1).  kd_loss_bwd: the gradient row into out.
constexpr int kStageChunks = 4;

template <typename T, bool kFwd>
__global__ void __launch_bounds__(kStagedThreads, 2)
kd_staged(const T* __restrict__ s, const float* __restrict__ t, const float* __restrict__ gup,
          T* __restrict__ out, float* __restrict__ kl, float* __restrict__ loss, int V, int slice,
          int cluster, float inv_temp, float scale) {
  constexpr int kWarps = kStagedThreads / 32;
  constexpr int kAlign = 16 / sizeof(T);  // elements a 16-byte piece of s
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ uint64_t bars[kStageChunks];
  __shared__ float red[32];
  __shared__ float2 ml_in[kMaxCluster];  // the cluster's (max, sum), by rank
  __shared__ float kl_in[kMaxCluster];   // rank 0: the cluster's KL sums, by rank

  const int tid = threadIdx.x;
  const int rank = cluster > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t row = blockIdx.x / cluster;
  const int lo = min(V, rank * slice), n = min(V, lo + slice) - lo;
  const T* srow = s + row * V + lo;
  const float* trow = t + row * V + lo;
  if (cluster > 1) cluster_arrive_relaxed();  // waited on before the first remote store

  T* ss = reinterpret_cast<T*>(dsm);
  const Parts ps = parts(srow, n);
  // piece c of the middle: elements [head + c * per, head + min(mid, (c + 1) * per))
  const int per = ((ps.mid + kStageChunks - 1) / kStageChunks + kAlign - 1) / kAlign * kAlign;
  bar_init(bars, kStageChunks);
  if (tid == 0) {
    for (int c = 0; c < kStageChunks; ++c) {
      Parts pc = ps;
      pc.head += min(ps.mid, c * per);
      pc.mid = max(0, min(ps.mid, (c + 1) * per) - min(ps.mid, c * per));
      hopper::mbar_expect_tx(bars + c, (uint32_t)(pc.mid * sizeof(T)));
      stage_bulk(pc, ss, srow, bars + c);
    }
  }
  stage_edges(ps, ss, srow, tid, kStagedThreads);
  __syncthreads();
  const T* sv = ss + ps.pad;  // element j of the slice

  // pass 1: the slice's max of z, read piece by piece as the pieces land
  // (a max does not depend on the order), then its sum of exp(z - max)
  float m = kNegInf;
  int j = tid;
  for (int c = 0; c < kStageChunks; ++c) {
    const int c1 = c == kStageChunks - 1 ? n : ps.head + min(ps.mid, (c + 1) * per);
    hopper::mbar_wait(bars + c, 0);
    for (; j < c1; j += kStagedThreads) m = fmaxf(m, to_float(sv[j]) * inv_temp);
  }
  m = block_max<kWarps>(m, red);
  float l = 0.f;
  for (j = tid; j < n; j += kStagedThreads) l += expf(to_float(sv[j]) * inv_temp - m);
  const MaxSum a{m, block_sum<kWarps>(l, red)};

  float lse;
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cluster_wait();  // every CTA of the cluster runs: its shared memory exists
    if (tid < cluster) *cl.map_shared_rank(&ml_in[rank], tid) = make_float2(a.m, a.l);
    cluster_sync();
    MaxSum r{ml_in[0].x, ml_in[0].y};
    for (int q = 1; q < cluster; ++q) r = merge(r, MaxSum{ml_in[q].x, ml_in[q].y});
    lse = r.m + logf(r.l);
  } else {
    lse = a.m + logf(a.l);
  }

  if constexpr (kFwd) {
    // pass 2: groups of 4 aligned on t's 16-byte boundaries
    constexpr int W = 4;
    const int head = lead(trow, n), groups = (n - head) / W, tail0 = head + groups * W;
    const bool svec = aligned_to(sv + head, 4 * sizeof(T));
    float acc = 0.f;
    if (tid < head) acc += kl_term(trow[tid], to_float(sv[tid]) * inv_temp, lse);
    stream_groups<W, 16 / W>(trow + head, groups, true, [&](int gi, const float(&tv)[W]) {
      float zv[W];
      load_vals<W>(sv + head + gi * W, zv, svec);
#pragma unroll
      for (int k = 0; k < W; ++k) acc += kl_term(tv[k], zv[k] * inv_temp, lse);
    });
    if (tail0 + tid < n) acc += kl_term(trow[tail0 + tid], to_float(sv[tail0 + tid]) * inv_temp, lse);
    acc = block_sum<kWarps>(acc, red);
    if (cluster > 1) {
      cg::cluster_group cl = cg::this_cluster();
      if (tid == 0) *cl.map_shared_rank(&kl_in[rank], 0) = acc;
      cluster_sync();
      if (rank == 0 && tid == 0) {
        for (int q = 1; q < cluster; ++q) acc += kl_in[q];
      }
    }
    if (rank == 0 && tid == 0) {
      if (kl) kl[row] = acc;
      else *loss = acc * scale;
    }
  } else {
    // pass 2: groups of 16 bytes aligned on the gradient row
    constexpr int W = 16 / sizeof(T);
    T* orow = out + row * V + lo;
    const float c = *gup * scale;
    const int head = lead(orow, n), groups = (n - head) / W, tail0 = head + groups * W;
    const bool tvec = aligned_to(trow + head, 16), svec = aligned_to(sv + head, 4 * sizeof(T));
    if (tid < head)
      store(orow + tid, (expf(to_float(sv[tid]) * inv_temp - lse) - trow[tid]) * c);
    stream_groups<W, 16 / W>(trow + head, groups, tvec, [&](int gi, const float(&tv)[W]) {
      float zv[W], y[W];
      load_vals<W>(sv + head + gi * W, zv, svec);
#pragma unroll
      for (int k = 0; k < W; ++k) y[k] = (expf(zv[k] * inv_temp - lse) - tv[k]) * c;
      store_vals<W>(orow + head + gi * W, y);
    });
    if (tail0 + tid < n) {
      const int j = tail0 + tid;
      store(orow + j, (expf(to_float(sv[j]) * inv_temp - lse) - trow[j]) * c);
    }
  }
}

// ---- the small path: one CTA, every row (kd_loss_fwd) -------------------
// Shared memory: s staged (staged_bytes(B*V, sizeof(T))), t staged
// (staged_bytes(B*V, 4)), then the B rows' KL.  Rows go `lanes` lanes each,
// kSmallThreads / lanes rows a round.  kd_loss_bwd needs no sum over the
// rows: its small plan runs kd_rows, whose lanes form each row's lse with
// the same code in the same order.
template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
kd_small(const T* __restrict__ s, const float* __restrict__ t, float* __restrict__ loss, int B,
         int V, int lanes, float inv_temp, float scale) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ uint64_t bar;
  __shared__ float red[32];
  const int tid = threadIdx.x, n = B * V;
  T* ss = reinterpret_cast<T*>(dsm);
  float* ts = reinterpret_cast<float*>(dsm + staged_bytes(n, sizeof(T)));
  float* kl = reinterpret_cast<float*>(dsm + staged_bytes(n, sizeof(T)) + staged_bytes(n, 4));
  const Parts ps = parts(s, n), pt = parts(t, n);
  bar_init(&bar);
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar, (uint32_t)(ps.mid * sizeof(T) + pt.mid * 4));
    stage_bulk(ps, ss, s, &bar);
    stage_bulk(pt, ts, t, &bar);
  }
  stage_edges(ps, ss, s, tid, kSmallThreads);
  stage_edges(pt, ts, t, tid, kSmallThreads);
  hopper::mbar_wait(&bar, 0);
  __syncthreads();
  const T* sv = ss + ps.pad;
  const float* tv = ts + pt.pad;

  const LaneRow g{tid % lanes, lanes};
  for (int r0 = 0; r0 < B; r0 += kSmallThreads / lanes) {
    const int r = r0 + tid / lanes, vr = r < B ? V : 0;
    const float lse = row_lse(sv + (size_t)r * V, vr, inv_temp, g);
    const float v = row_kl(sv + (size_t)r * V, tv + (size_t)r * V, vr, inv_temp, lse, g);
    if (r < B && g.lane == 0) kl[r] = v;
  }
  __syncthreads();
  finish_rows(kl, B, scale, loss, red);
}

// ---- the rows path: `lanes` lanes a row, in global memory ----------------
template <typename T, bool kFwd>
__global__ void __launch_bounds__(kRowsThreads)
kd_rows(const T* __restrict__ s, const float* __restrict__ t, const float* __restrict__ gup,
        T* __restrict__ out, float* __restrict__ kl, int B, int V, int lanes, float inv_temp,
        float scale) {
  const int row = blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const int vr = row < B ? V : 0;  // the warp's other rows still shuffle
  const LaneRow g{(int)threadIdx.x % lanes, lanes};
  const size_t off = (size_t)row * V;
  const float lse = row_lse(s + off, vr, inv_temp, g);
  if constexpr (kFwd) {
    const float r = row_kl(s + off, t + off, vr, inv_temp, lse, g);
    if (row < B && g.lane == 0) kl[row] = r;
  } else {
    const float c = *gup * scale;
    for (int v = g.lane; v < vr; v += lanes)
      store(out + off + v, (expf(to_float(s[off + v]) * inv_temp - lse) - t[off + v]) * c);
  }
}

// ================================================= ensemble_softmax
// Paths and sizes: ensemble_plan in kernels/kd_loss/ops.py (kept in step with these).
enum EnsPath { kEnsSmall = 0, kEnsStaged = 1 };
constexpr int kEnsSmallThreads = 128;   // small: threads a CTA, over a block of whole rows
constexpr int kEnsStagedThreads = 512;  // staged: threads a CTA, over a slice of one row
constexpr int kEnsSmallUnroll = 8;      // teacher rows whose loads are in flight together
constexpr int kEnsStagedUnroll = 4;     // (staged: 2 CTAs of 512 threads an SM, 64 registers)

// 16 bytes of T as floats.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& q, float (&v)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(q.x), v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z), v[3] = __uint_as_float(q.w);
  } else {
    unpack_bf16x2(q.x, v[0], v[1]);
    unpack_bf16x2(q.y, v[2], v[3]);
    unpack_bf16x2(q.z, v[4], v[5]);
    unpack_bf16x2(q.w, v[6], v[7]);
  }
}

// z[j] = (sum_m x[m * plane + j] * inv_m) * inv_temp for j in [0, n), in m
// order, into zs[j]; returns the max of the z this thread wrote.  x[j]'s
// 16-byte phase is every teacher's (the caller's `head`: the elements before
// x's first 16-byte boundary, or n when the phases differ): [head, head + W
// * groups) goes by 16-byte loads, kUnroll teachers' in flight, and zs +
// head must be 16-byte aligned; the rest by plain loads.
template <typename T, int kThreads, int kUnroll>
__device__ float stage_z(const T* __restrict__ x, size_t plane, int M, int n, int head,
                         float* __restrict__ zs, float inv_m, float inv_temp) {
  constexpr int W = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int groups = (n - head) / W, tail0 = head + groups * W, edges = head + (n - tail0);
  float mx = kNegInf;
  for (int i = tid; i < edges; i += kThreads) {
    const int j = i < head ? i : tail0 + (i - head);
    float acc = 0.f;
    for (int m0 = 0; m0 < M; m0 += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (m0 + u < M) v[u] = to_float(x[(size_t)(m0 + u) * plane + j]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (m0 + u < M) acc = m0 + u == 0 ? __fmul_rn(v[u], inv_m) : __fmaf_rn(v[u], inv_m, acc);
    }
    const float z = __fmul_rn(acc, inv_temp);
    zs[j] = z;
    mx = fmaxf(mx, z);
  }
  for (int c = tid; c < groups; c += kThreads) {
    const int j = head + c * W;
    float acc[W];
    for (int m0 = 0; m0 < M; m0 += kUnroll) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (m0 + u < M) q[u] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + u) * plane + j);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (m0 + u >= M) break;
        float v[W];
        unpack16<T>(q[u], v);
#pragma unroll
        for (int k = 0; k < W; ++k)
          acc[k] = m0 + u == 0 ? __fmul_rn(v[k], inv_m) : __fmaf_rn(v[k], inv_m, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < W; k += 4) {
      float4 z;
      z.x = __fmul_rn(acc[k], inv_temp), z.y = __fmul_rn(acc[k + 1], inv_temp);
      z.z = __fmul_rn(acc[k + 2], inv_temp), z.w = __fmul_rn(acc[k + 3], inv_temp);
      *reinterpret_cast<float4*>(zs + j + k) = z;
      mx = fmaxf(mx, fmaxf(fmaxf(z.x, z.y), fmaxf(z.z, z.w)));
    }
  }
  return mx;
}

// z's shared-memory start: zs + head lands on a 16-byte boundary of `base`
// (16-byte aligned), so x's 16-byte groups become float4 stores.
__device__ __forceinline__ float* z_start(float* base, int head) {
  return base + ((4 - head % 4) & 3);
}

// o[j] = exp(zs[j] - s.m) / s.l for j in [0, n): 16-byte stores on o's own
// boundaries, plain stores at its head and tail.
template <int kThreads>
__device__ __forceinline__ void write_probs(float* __restrict__ o, int n, const float* zs,
                                            MaxSum s) {
  const int tid = threadIdx.x;
  const int head = lead(o, n), groups = (n - head) / 4, tail0 = head + groups * 4;
  const bool zvec = aligned_to(zs + head, 16);
  for (int i = tid; i < head + (n - tail0); i += kThreads) {
    const int j = i < head ? i : tail0 + (i - head);
    o[j] = expf(zs[j] - s.m) / s.l;
  }
  for (int c = tid; c < groups; c += kThreads) {
    const int j = head + 4 * c;
    float z[4], y[4];
    load_vals<4>(zs + j, z, zvec);
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] = expf(z[k] - s.m) / s.l;
    store_vals<4>(o + j, y);
  }
}

// The staged path: grid N * cluster CTAs, clusters of `cluster` along x; CTA
// rank q of row n's cluster owns the slice [q * slice, min(V, q * slice +
// slice)).  Shared memory: the slice's z (slice + 4 floats).
template <typename T>
__global__ void __launch_bounds__(kEnsStagedThreads, 2)
ensemble_staged(const T* __restrict__ x, float* __restrict__ out, int M, int N, int V, int slice,
                int cluster, float inv_m, float inv_temp) {
  constexpr int kWarps = kEnsStagedThreads / 32;
  extern __shared__ __align__(16) float zbuf[];
  __shared__ float red[32];
  __shared__ float2 ml_in[kMaxCluster];  // the cluster's (max, sum), by rank
  const int tid = threadIdx.x;
  const int rank = cluster > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t row = blockIdx.x / cluster;
  const int lo = min(V, rank * slice), n = min(V, lo + slice) - lo;
  if (cluster > 1) cluster_arrive_relaxed();  // waited on before the first remote store
  const T* xr = x + row * V + lo;
  const size_t plane = (size_t)N * V;
  const int head = (plane * sizeof(T)) % 16 == 0 ? lead(xr, n) : n;
  float* zs = z_start(zbuf, head);
  float m = stage_z<T, kEnsStagedThreads, kEnsStagedUnroll>(xr, plane, M, n, head, zs, inv_m,
                                                            inv_temp);
  m = block_max<kWarps>(m, red);  // its barrier also publishes zs
  float l = 0.f;
  for (int j = tid; j < n; j += kEnsStagedThreads) l += expf(zs[j] - m);
  MaxSum a{m, block_sum<kWarps>(l, red)};
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cluster_wait();  // every CTA of the cluster runs: its shared memory exists
    if (tid < cluster) *cl.map_shared_rank(&ml_in[rank], tid) = make_float2(a.m, a.l);
    cluster_sync();
    a = MaxSum{ml_in[0].x, ml_in[0].y};
    for (int q = 1; q < cluster; ++q) a = merge(a, MaxSum{ml_in[q].x, ml_in[q].y});
  }
  write_probs<kEnsStagedThreads>(out + row * V + lo, n, zs, a);
}

// The small path: CTA b takes rows [b * rows, b * rows + rows); `lanes`
// lanes a row (a power of two, rows * lanes <= kEnsSmallThreads) form each
// row's max, then its sum of exp(z - max), lane i over elements i, i + lanes,
// ..., then xor shuffles, and write the row's probabilities, lane i the same
// elements (a row of at most 1,024 floats: a warp's stores stay contiguous).
template <typename T>
__global__ void __launch_bounds__(kEnsSmallThreads)
ensemble_small(const T* __restrict__ x, float* __restrict__ out, int M, int N, int V, int rows,
               int lanes, float inv_m, float inv_temp) {
  extern __shared__ __align__(16) float zbuf[];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows, nr = min(rows, N - r0), n = nr * V;
  const T* xr = x + (size_t)r0 * V;
  const size_t plane = (size_t)N * V;
  const int head = (plane * sizeof(T)) % 16 == 0 ? lead(xr, n) : n;
  float* zs = z_start(zbuf, head);
  stage_z<T, kEnsSmallThreads, kEnsSmallUnroll>(xr, plane, M, n, head, zs, inv_m, inv_temp);
  __syncthreads();
  const LaneRow g{tid % lanes, lanes};
  const int r = tid / lanes, vr = r < nr ? V : 0;  // the warp's other lanes still shuffle
  const float* zr = zs + (size_t)r * V;
  float m = kNegInf;
  for (int v = g.lane; v < vr; v += lanes) m = fmaxf(m, zr[v]);
  m = g.max(m);
  float l = 0.f;
  for (int v = g.lane; v < vr; v += lanes) l += expf(zr[v] - m);
  l = g.sum(l);
  float* o = out + (size_t)(r0 + r) * V;
  for (int v = g.lane; v < vr; v += lanes) o[v] = expf(zr[v] - m) / l;
}

// ---- launchers -------------------------------------------------------------
// The plan a launch takes (from kd_plan); checked here against what the
// kernels need.
struct Plan {
  int path, cluster, slice, lanes, smem;
};

inline bool plan_ok(const Plan& p, int B, int V, int elt) {
  if (p.smem < 0 || p.smem > kSmemMax) return false;
  if (p.path == kSmall || p.path == kRows) {
    const bool lanes_ok = p.lanes >= 1 && p.lanes <= 32 && (p.lanes & (p.lanes - 1)) == 0;
    if (!lanes_ok || V > kWarpMaxV) return false;
    return p.path == kRows ||
           ((long)B * V <= kSmallMaxElems &&
            p.smem >= staged_bytes((long)B * V, elt) + staged_bytes((long)B * V, 4) + 4L * B);
  }
  return p.path == kStaged && p.cluster >= 1 && p.cluster <= kMaxCluster && p.slice >= 1 &&
         (long)p.slice * p.cluster >= V && p.smem >= staged_bytes(p.slice, elt) &&
         (long)B * p.cluster <= 0x7fffffffL;
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

template <typename T, bool kFwd>
cudaError_t launch_kd(const Plan& p, const void* s_, const float* t, const float* g, void* out_,
                      float* kl, float* loss, int B, int V, float inv_temp, float scale,
                      cudaStream_t st) {
  const T* s = static_cast<const T*>(s_);
  T* out = static_cast<T*>(out_);
  if (p.path == kSmall && kFwd) {
    const cudaError_t e = allow_smem(kd_small<T>, p.smem);
    if (e != cudaSuccess) return e;
    kd_small<T><<<1, kSmallThreads, p.smem, st>>>(s, t, loss, B, V, p.lanes, inv_temp, scale);
    return cudaGetLastError();
  }
  if (p.path != kStaged) {  // the rows path, and kd_loss_bwd's small plan in one-warp CTAs
    const int threads = p.path == kSmall ? 32 : kRowsThreads, rows = threads / p.lanes;
    kd_rows<T, kFwd><<<(B + rows - 1) / rows, threads, 0, st>>>(s, t, g, out, kl, B, V, p.lanes,
                                                              inv_temp, scale);
    return cudaGetLastError();
  }
  auto kernel = kd_staged<T, kFwd>;
  cudaError_t e = allow_smem(kernel, p.smem);
  if (e == cudaSuccess && p.cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * p.cluster));
  cfg.blockDim = dim3(kStagedThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, s, t, g, out, kl, loss, V, p.slice, p.cluster, inv_temp,
                            scale);
}

// kernel 2's plan (from ensemble_plan), checked against what its kernels need.
struct EnsPlan {
  int path, cluster, slice, rows, lanes, smem;
};

inline bool ens_plan_ok(const EnsPlan& p, int N, int V) {
  if (p.smem < 0 || p.smem > kSmemMax) return false;
  if (p.path == kEnsSmall)
    return V <= kWarpMaxV && p.rows >= 1 && p.lanes >= 1 && p.lanes <= 32 &&
           (p.lanes & (p.lanes - 1)) == 0 && p.rows * p.lanes <= kEnsSmallThreads &&
           p.smem >= 4L * (p.rows * V + 4);
  return p.path == kEnsStaged && p.cluster >= 1 && p.cluster <= kMaxCluster && p.slice >= 1 &&
         (long)p.slice * p.cluster >= V && p.smem >= 4L * (p.slice + 4) &&
         (long)N * p.cluster <= 0x7fffffffL;
}

template <typename T>
cudaError_t launch_ensemble(const EnsPlan& p, const void* x_, float* out, int M, int N, int V,
                            float inv_temp, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const float inv_m = 1.f / (float)M;
  if (p.path == kEnsSmall) {
    const cudaError_t e = allow_smem(ensemble_small<T>, p.smem);
    if (e != cudaSuccess) return e;
    ensemble_small<T><<<(N + p.rows - 1) / p.rows, kEnsSmallThreads, p.smem, st>>>(
        x, out, M, N, V, p.rows, p.lanes, inv_m, inv_temp);
    return cudaGetLastError();
  }
  auto kernel = ensemble_staged<T>;
  cudaError_t e = allow_smem(kernel, p.smem);
  if (e == cudaSuccess && p.cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(N * p.cluster));
  cfg.blockDim = dim3(kEnsStagedThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, out, M, N, V, p.slice, p.cluster, inv_m, inv_temp);
}

}  // namespace

extern "C" {

// Each returns 0 on success, a cudaError_t code if the launch failed, -1
// for a shape, type or plan the kernels do not take.  dtype: 0 float32,
// 1 bfloat16.  Kernels 3 and 4's plan fields (path, cluster, slice, lanes,
// smem) are kd_plan's in kernels/kd_loss/ops.py.

// x (M, N, V) in dtype -> out (N, V) f32; the plan's fields (path, cluster,
// slice, rows, lanes, smem) are ensemble_plan's.
int ensemble_softmax(const void* x, void* out, int M, int N, int V, float inv_temp, int path,
                     int cluster, int slice, int rows, int lanes, int smem, int dtype,
                     void* stream) {
  const EnsPlan p{path, cluster, slice, rows, lanes, smem};
  if (M < 1 || N < 1 || V < 1 || (dtype != 0 && dtype != 1) || !ens_plan_ok(p, N, V)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const cudaError_t e = dtype == 0
      ? launch_ensemble<float>(p, x, o, M, N, V, inv_temp, st)
      : launch_ensemble<__nv_bfloat16>(p, x, o, M, N, V, inv_temp, st);
  return (int)e;
}

// buf: B + 1 floats; the rows' KL go to buf[0:B] where a second launch
// needs them, the loss mean_b KL * tau^2 (scale = tau^2 / B) to buf[B].
int kd_loss_fwd(const void* s_logits, const void* t_probs, void* buf, int B, int V,
                float inv_temp, float scale, int path, int cluster, int slice, int lanes,
                int smem, int dtype, void* stream) {
  const Plan p{path, cluster, slice, lanes, smem};
  if (B < 1 || V < 1 || (dtype != 0 && dtype != 1) || !plan_ok(p, B, V, dtype == 0 ? 4 : 2))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(t_probs);
  float* kl = static_cast<float*>(buf);
  float* loss = kl + B;
  const bool finish = p.path == kRows || (p.path == kStaged && B > 1);
  float* rows_kl = finish ? kl : nullptr;
  cudaError_t e = dtype == 0
      ? launch_kd<float, true>(p, s_logits, t, nullptr, nullptr, rows_kl, loss, B, V, inv_temp, scale, st)
      : launch_kd<__nv_bfloat16, true>(p, s_logits, t, nullptr, nullptr, rows_kl, loss, B, V, inv_temp, scale, st);
  if (e == cudaSuccess && finish) {
    kd_finish<<<1, kSmallThreads, 0, st>>>(kl, B, scale, loss);
    e = cudaGetLastError();
  }
  return (int)e;
}

// g: one f32 on the device (the upstream gradient); scale = tau / B.
int kd_loss_bwd(const void* s_logits, const void* t_probs, const void* g, void* out, int B,
                int V, float inv_temp, float scale, int path, int cluster, int slice, int lanes,
                int smem, int dtype, void* stream) {
  const Plan p{path, cluster, slice, lanes, smem};
  if (B < 1 || V < 1 || (dtype != 0 && dtype != 1) || !plan_ok(p, B, V, dtype == 0 ? 4 : 2))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(t_probs);
  const float* gp = static_cast<const float*>(g);
  const cudaError_t e = dtype == 0
      ? launch_kd<float, false>(p, s_logits, t, gp, out, nullptr, nullptr, B, V, inv_temp, scale, st)
      : launch_kd<__nv_bfloat16, false>(p, s_logits, t, gp, out, nullptr, nullptr, B, V, inv_temp, scale, st);
  return (int)e;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
