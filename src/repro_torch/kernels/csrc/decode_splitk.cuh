// Split-K GQA decode for Hopper (sm_90a): the device code that kernel 1
// (paged_decode.cu, a block table into one pool) and kernel 11
// (flash_attention.cu, a contiguous cache) share.  One query token, G rows
// per KV head, attends the live positions of its request's cache.
//
// The two kernels differ only in how a position's K/V row is found and in
// which positions are live, so the body is a template over an addressing
// policy (`PagedRows`, `ContiguousRows` below).  A policy gives, per
// (request, KV head), a `Row` with the live range [lo, hi), the element
// offset of position t's K/V row, and `score`, which the TPU kernels'
// semantics need:
//
//   * PagedRows (kernel 1): lo = seq_len - window when window > 0 (else 0),
//     hi = min(seq_len, nbmax·bs); t's row is block_tables[b, t / bs]'s
//     slot t % bs.  A seq_len == 0 row has no live position: its output is
//     zeros (acc / max(l, 1e-30)), as the TPU kernel gives.
//   * ContiguousRows (kernel 11): lo = 0, hi = min(cache_len, S); t's row is
//     ((b·S + t)·Hkv + h)·dh.  cache_len <= 0 is an explicit branch: every
//     position of the cache is live and scores NEG_INF, so p = 1 everywhere
//     and the output is the mean of V over all S, as the TPU kernel returns
//     when no position is valid.
//
// Bound on this card: bytes.  The work reads each live K and V row once,
// at 3.35 TB/s (H100 SXM); its 4·G·dh f32 operations per live row and KV
// head stay under the f32 rate at G <= 16.  What the design does about it:
//
//   * Split-K: grid (splits, B·Hkv·ng).  Each CTA walks one chunk of its
//     row's live range.  The host picks `chunk` and `splits` from shapes
//     alone (kernel 1: whole pool blocks, aiming at four CTAs per SM;
//     kernel 11: whole 32-position tiles, as many CTAs as the card holds
//     at once, `resident_ctas`, so that no second wave runs a few CTAs
//     alone), so that a few long rows fill the card; it never reads a
//     device tensor.  A CTA whose chunk starts
//     at or past its row's end exits at once.
//   * Loads overlap the math: the K and V rows of the next tile of 32
//     positions stream into shared memory with 16-byte `cp.async` (rows
//     padded so that a quarter-warp's reads hit distinct banks) while the
//     four warps compute on the current tile, double-buffered.
//   * Math in f32 on the CUDA cores.  The G query rows of the KV head
//     (cast to f32, then scaled by dh^-0.5, as the TPU kernels do) sit in
//     shared memory and are read as broadcasts; a warp takes 8 positions
//     of each tile, a quarter of dh per lane for Q·Kᵀ, then column pairs of
//     dh for P·V; the running max, sum and the G x dh accumulators of each
//     warp's rows stay in registers.  The body is built for 1, 2, 4, 8, 12
//     and 16 rows a CTA (and 5 for kernel 11, qwen2.5-14b's G): the rows
//     past G compute on zero queries, with no branch to break the chains of
//     independent rows, and are not stored.
//     G rows beyond a register budget (G > 8 at dh 256) go to a second CTA
//     of the same split (ng = 2).
//   * Merge in split order, no atomics on the data: the four warps' states
//     merge in warp order in shared memory; a row with one live chunk
//     writes its output directly; otherwise each CTA writes its (m, l, acc)
//     partial to an f32 workspace and the last CTA of the row to arrive
//     (an arrival counter per row, which that CTA resets to 0) merges the
//     row's partials (at most kMaxSplits) in split order, so the result is
//     bit-stable from run to run and the op stays one launch.
//
// An empty partial (m = NEG_INF = -1e30, l = 0, acc = 0) merges with
// weight exp(m_c - M), which is 0 beside a real score and leaves nothing
// to add beside another NEG_INF one.  Positions past a chunk's end score
// -inf and weigh 0.
//
// Types: float32 and bfloat16 (q, caches and out of one type); dh in
// {32, 64, 80, 128, 256} as a template parameter (dh = 80's rows are 160
// bf16 or 320 f32 bytes: the lanes past dh add nothing); any G <= 16.
// The caller checks shapes, types, alignment and contiguity and allocates
// the workspace and the counters; a launch runs on the given stream and
// does not synchronise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace splitk {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                 // positions per pipeline stage
constexpr int kWarpTok = kTile / kWarps;  // positions per warp per tile
constexpr int kMaxG = 16;
constexpr int kMaxSplits = 128;           // CTAs per row at most (the merge's weights)

// Kernel 1: a block table into one pool (nb, bs, Hkv, dh).
struct PagedRows {
  static constexpr bool kFiveRows = false;   // gb 5 is not built for kernel 1
  const int* block_tables;  // (B, nbmax)
  const int* seq_lens;      // (B,)
  int Hkv, bs, nbmax, window;

  struct Row {
    const int* table;
    size_t row_stride, head;
    int bs, lo, hi;
    __device__ __forceinline__ size_t offset(int t) const {
      return ((size_t)table[t / bs] * bs + t % bs) * row_stride + head;
    }
    __device__ __forceinline__ float score(float s) const { return s; }
  };
  __device__ __forceinline__ Row row(int b, int h, int dh) const {
    const int sl = seq_lens[b];
    Row r;
    r.table = block_tables + (size_t)b * nbmax;
    r.row_stride = (size_t)Hkv * dh;
    r.head = (size_t)h * dh;
    r.bs = bs;
    r.lo = window > 0 ? max(0, sl - window) : 0;
    r.hi = min(sl, nbmax * bs);
    return r;
  }
};

// Kernel 11: a contiguous cache (B, S, Hkv, dh), its first cache_len
// positions valid.
struct ContiguousRows {
  static constexpr bool kFiveRows = true;    // qwen2.5-14b's G = 5 without padding
  int S, Hkv, cache_len;

  struct Row {
    size_t base, row_stride;
    int lo, hi;
    bool none;                 // cache_len <= 0: every position scores NEG_INF
    __device__ __forceinline__ size_t offset(int t) const { return base + (size_t)t * row_stride; }
    __device__ __forceinline__ float score(float s) const { return none ? kNegInf : s; }
  };
  __device__ __forceinline__ Row row(int b, int h, int dh) const {
    Row r;
    r.row_stride = (size_t)Hkv * dh;
    r.base = ((size_t)b * S * Hkv + h) * dh;
    r.none = cache_len <= 0;
    r.lo = 0;
    r.hi = r.none ? S : min(cache_len, S);
    return r;
  }
};

template <typename T, int DH>
struct Geom {
  static constexpr int kVec = 16 / (int)sizeof(T);          // elements per 16-byte chunk
  static constexpr int kChunks = DH / kVec;                  // chunks per K/V row
  static constexpr int kChunksPerLane = (kChunks + 3) / 4;   // Q·Kᵀ: a quarter per lane
  static constexpr int kRowWords = DH * (int)sizeof(T) / 4;
  // row stride = 16 (mod 32) words: the two rows a quarter-warp reads in
  // Q·Kᵀ fall on distinct banks
  static constexpr int kLdWords = kRowWords + (16 - kRowWords % 32 + 32) % 32;
  static constexpr int kLdBytes = kLdWords * 4;
  static constexpr int kPairs = (DH + 63) / 64;              // P·V: column pairs per lane
  static constexpr int kStageBytes = 2 * kTile * kLdBytes;   // K and V
};

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16(v); }

// One 16-byte chunk of a K row, widened to f32.
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

template <typename T, int DH, int GB, typename Addr>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q,       // (B, Hkv, G, DH)
              const T* __restrict__ k,       // K rows, addressed by `addr`
              const T* __restrict__ v,       // V rows, at the same offsets
              Addr addr,
              T* __restrict__ out,           // (B, Hkv, G, DH)
              float* __restrict__ part,      // (rows, splits, GB·(DH + 2)) if splits > 1
              int* __restrict__ counters,    // (rows,) zeros, if splits > 1
              int Hkv, int G, int ng, int chunk, float scale) {
  using Gm = Geom<T, DH>;
  constexpr int GBP = (GB + 3) / 4 * 4;             // row stride of the probabilities
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);                  // GB x DH scaled queries
  float* Ps = Qs + GB * DH;                                    // kWarps x kWarpTok x GBP
  unsigned char* stages = reinterpret_cast<unsigned char*>(Ps + kWarps * kWarpTok * GBP);
  __shared__ int last_flag;

  const int split = blockIdx.x, row = blockIdx.y;   // row = (b·Hkv + h)·ng + gi
  const int gi = row % ng, bh = row / ng, b = bh / Hkv, h = bh % Hkv;
  const int g0 = gi * GB, gn = min(GB, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane >> 2, dq = lane & 3;          // Q·Kᵀ: position, quarter of dh

  const typename Addr::Row rw = addr.row(b, h, DH);
  const int lo = rw.lo, hi = rw.hi;
  const int live = max(0, hi - lo);
  const int n_live = (live + chunk - 1) / chunk;
  const size_t qo = ((size_t)bh * G + g0) * DH;     // first of this CTA's query rows
  if (split >= n_live) {                            // nothing of the row to walk
    if (n_live == 0 && split == 0)
      for (int e = tid; e < gn * DH; e += kThreads) store(out + qo + e, 0.f);
    return;
  }
  const int begin = lo + split * chunk, end = min(begin + chunk, hi);

  // issue the cp.async loads of tile `it` into stage `st`; rows past `end`
  // are zero-filled
  auto load_tile = [&](int it, int st) {
    unsigned char* ks = stages + st * Gm::kStageBytes;
    unsigned char* vs = ks + kTile * Gm::kLdBytes;
    for (int e = tid; e < kTile * Gm::kChunks; e += kThreads) {
      const int r = e / Gm::kChunks, c = e % Gm::kChunks, t = begin + it * kTile + r;
      const bool ok = t < end;
      size_t off = 0;
      if (ok) off = rw.offset(t);
      off += (size_t)c * Gm::kVec;
      cp_async16(ks + r * Gm::kLdBytes + c * 16, ok ? k + off : k, ok);
      cp_async16(vs + r * Gm::kLdBytes + c * 16, ok ? v + off : v, ok);
    }
  };

  const int ntiles = (end - begin + kTile - 1) / kTile;
  load_tile(0, 0);
  cp_async_commit();
  // rows past gn are zeros: every row of the template computes, without
  // branches, and only rows < gn are stored
  for (int e = tid; e < GB * DH; e += kThreads)
    Qs[e] = e < gn * DH ? to_float(q[qo + e]) * scale : 0.f;
  for (int e = tid; e < kWarps * kWarpTok * GBP; e += kThreads) Ps[e] = 0.f;

  float m[GB], l[GB], acc[GB][Gm::kPairs][2];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < Gm::kPairs; ++j) acc[g][j][0] = acc[g][j][1] = 0.f;
  }
  float* pw = Ps + warp * kWarpTok * GBP;           // this warp's probabilities

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_tile(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();                               // tile it has landed
    __syncthreads();
    const unsigned char* ks = stages + (it & 1) * Gm::kStageBytes;
    const unsigned char* vs = ks + kTile * Gm::kLdBytes;
    const int r = warp * kWarpTok + tq;             // this lane's position in the tile
    const bool valid = begin + it * kTile + r < end;

    // 1. scores of the lane's position, over its quarter of dh
    float s[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) s[g] = 0.f;
#pragma unroll
    for (int i = 0; i < Gm::kChunksPerLane; ++i) {
      const int c = dq + 4 * i;
      if (Gm::kChunks % 4 == 0 || c < Gm::kChunks) {
        float kf[Gm::kVec];
        widen16(reinterpret_cast<const T*>(ks + r * Gm::kLdBytes + c * 16), kf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float* qr = Qs + g * DH + c * Gm::kVec;
#pragma unroll
          for (int v4 = 0; v4 < Gm::kVec; v4 += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qr + v4);
            s[g] = fmaf(qq.x, kf[v4], s[g]);
            s[g] = fmaf(qq.y, kf[v4 + 1], s[g]);
            s[g] = fmaf(qq.z, kf[v4 + 2], s[g]);
            s[g] = fmaf(qq.w, kf[v4 + 3], s[g]);
          }
        }
      }
    }

    // 2. online softmax over the warp's 8 positions
    float corr[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float x = s[g];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      x = rw.score(x);
      float mx = valid ? x : -CUDART_INF_F;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[g], mx);
      const float p = valid ? expf(x - m_new) : 0.f;
      corr[g] = expf(m[g] - m_new);
      l[g] = l[g] * corr[g] + p;                    // this lane's position only
      m[g] = m_new;
      if (dq == 0) pw[tq * GBP + g] = p;
    }
    __syncwarp();

    // 3. acc = acc * corr + P·V over the warp's 8 positions
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int j = 0; j < Gm::kPairs; ++j) {
        acc[g][j][0] *= corr[g];
        acc[g][j][1] *= corr[g];
      }
#pragma unroll
    for (int t = 0; t < kWarpTok; ++t) {
      const T* vr = reinterpret_cast<const T*>(vs + (warp * kWarpTok + t) * Gm::kLdBytes);
      float2 vv[Gm::kPairs];
#pragma unroll
      for (int j = 0; j < Gm::kPairs; ++j) {
        const int d = 2 * lane + 64 * j;
        vv[j] = (DH % 64 == 0 || d < DH) ? load_pair(vr + d) : make_float2(0.f, 0.f);
      }
      const float* pt = pw + t * GBP;
#pragma unroll
      for (int g4 = 0; g4 < GBP; g4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pt + g4);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (g4 + u < GB) {
#pragma unroll
            for (int j = 0; j < Gm::kPairs; ++j) {
              acc[g4 + u][j][0] = fmaf(pv[u], vv[j].x, acc[g4 + u][j][0]);
              acc[g4 + u][j][1] = fmaf(pv[u], vv[j].y, acc[g4 + u][j][1]);
            }
          }
        }
      }
    }
    __syncthreads();                                // the stage is refilled next
  }

  // 4. merge the four warps' states in warp order (stage memory reused)
  float* Mw = reinterpret_cast<float*>(stages);     // kWarps x GB
  float* Lw = Mw + kWarps * GB;                     // kWarps x GB
  float* Aw = Lw + kWarps * GB;                     // kWarps x GB x DH
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float lt = l[g];
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    lt += __shfl_xor_sync(0xffffffffu, lt, 8);
    lt += __shfl_xor_sync(0xffffffffu, lt, 16);
    if (lane == 0) {
      Mw[warp * GB + g] = m[g];
      Lw[warp * GB + g] = lt;
    }
#pragma unroll
    for (int j = 0; j < Gm::kPairs; ++j) {
      const int d = 2 * lane + 64 * j;
      if (DH % 64 == 0 || d < DH) {
        Aw[(warp * GB + g) * DH + d] = acc[g][j][0];
        Aw[(warp * GB + g) * DH + d + 1] = acc[g][j][1];
      }
    }
  }
  __syncthreads();

  const bool direct = n_live == 1;
  const size_t pstride = (size_t)GB * (DH + 2);
  float* pp = direct ? nullptr : part + ((size_t)row * gridDim.x + split) * pstride;
  for (int e = tid; e < gn * DH; e += kThreads) {
    const int g = e / DH, d = e % DH;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Mw[w * GB + g]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(Mw[w * GB + g] - M);
      A = fmaf(Aw[(w * GB + g) * DH + d], wt, A);
      L = fmaf(Lw[w * GB + g], wt, L);
    }
    if (direct) {
      store(out + qo + e, A / fmaxf(L, 1e-30f));
    } else {
      pp[2 * GB + g * DH + d] = A;
      if (d == 0) {
        pp[g] = M;
        pp[GB + g] = L;
      }
    }
  }
  if (direct) return;

  // 5. the row's last CTA to arrive merges the row's partials in split
  // order: out = sum_c acc_c·w_c / sum_c l_c·w_c, w_c = exp(m_c - max_c m_c)
  __threadfence();
  __syncthreads();
  if (tid == 0) last_flag = atomicAdd(counters + row, 1) == n_live - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  const float* base = part + (size_t)row * gridDim.x * pstride;
  float* Wc = reinterpret_cast<float*>(stages);     // n_live x GB weights
  float* Mg = Wc + kMaxSplits * GB;                 // GB maxima
  float* Lg = Mg + GB;                              // GB sums
  for (int g = tid; g < gn; g += kThreads) {
    float M = kNegInf;
    for (int c = 0; c < n_live; ++c) M = fmaxf(M, __ldcg(base + c * pstride + g));
    Mg[g] = M;
  }
  __syncthreads();
  for (int i = tid; i < n_live * gn; i += kThreads) {
    const int c = i / gn, g = i % gn;
    Wc[c * GB + g] = expf(__ldcg(base + c * pstride + g) - Mg[g]);
  }
  __syncthreads();
  for (int g = tid; g < gn; g += kThreads) {
    float L = 0.f;
    for (int c = 0; c < n_live; ++c)
      L = fmaf(__ldcg(base + c * pstride + GB + g), Wc[c * GB + g], L);
    Lg[g] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  constexpr int kPer = (GB * DH + kThreads - 1) / kThreads;
  float A[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) A[i] = 0.f;
  for (int c = 0; c < n_live; ++c) {
    const float* pc = base + c * pstride + 2 * GB;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < gn * DH) A[i] = fmaf(__ldcg(pc + e), Wc[c * GB + e / DH], A[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    if (e < gn * DH) store(out + qo + e, A[i] / Lg[e / DH]);
  }
  if (tid == 0) counters[row] = 0;                  // ready for the next launch
}

template <typename T, int DH, int GB>
constexpr size_t smem_bytes() {
  using Gm = Geom<T, DH>;
  constexpr int GBP = (GB + 3) / 4 * 4;
  constexpr size_t stage = 2 * (size_t)Gm::kStageBytes;
  constexpr size_t merge = sizeof(float) * ((size_t)2 * kWarps * GB + (size_t)kWarps * GB * DH);
  constexpr size_t final_merge = sizeof(float) * ((size_t)kMaxSplits * GB + 2 * GB);
  constexpr size_t reuse0 = stage > merge ? stage : merge;
  constexpr size_t reuse = reuse0 > final_merge ? reuse0 : final_merge;
  return sizeof(float) * ((size_t)GB * DH + (size_t)kWarps * kWarpTok * GBP) + reuse;
}

template <typename T, int DH, int GB, typename Addr>
int launch(const void* q, const void* k, const void* v, const Addr& addr, void* out,
           float* part, int* counters, int B, int Hkv, int G, int ng, int chunk, int splits,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DH, GB>();
  auto kernel = decode_kernel<T, DH, GB, Addr>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (splits < 0) {                          // the query: resident CTAs per SM
    int n = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
    return err != cudaSuccess ? -(int)err - 1 : n;
  }
  kernel<<<dim3(splits, B * Hkv * ng), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), addr,
      static_cast<T*>(out), part, counters, Hkv, G, ng, chunk, scale);
  return (int)cudaGetLastError();
}

#define SPLITK_ARGS q, k, v, addr, out, part, cnt, B, Hkv, G, ng, chunk, splits, scale, stream

template <typename T, int DH, typename Addr>
int dispatch_gb(int gb, const void* q, const void* k, const void* v, const Addr& addr,
                void* out, float* part, int* cnt, int B, int Hkv, int G, int ng, int chunk,
                int splits, float scale, cudaStream_t stream) {
  switch (gb) {
    case 1: return launch<T, DH, 1>(SPLITK_ARGS);
    case 2: return launch<T, DH, 2>(SPLITK_ARGS);
    case 4: return launch<T, DH, 4>(SPLITK_ARGS);
    case 5:
      if constexpr (Addr::kFiveRows) return launch<T, DH, 5>(SPLITK_ARGS);
      return -1;
    case 8: return launch<T, DH, 8>(SPLITK_ARGS);
    case 12:
      if constexpr (DH <= 128) return launch<T, DH, 12>(SPLITK_ARGS);
      return -1;
    case 16:
      if constexpr (DH <= 128) return launch<T, DH, 16>(SPLITK_ARGS);
      return -1;
    default: return -1;
  }
}

// Checks the launch shape and runs the body for dtype (0 float32, 1
// bfloat16), dh and gb query rows per CTA; `scale_of(dh)` gives dh^-0.5 as
// the caller's TPU kernel rounds it.  Returns 0, a cudaError_t code, or -1
// for a shape or type the body does not take.
template <typename Addr, typename Scale>
int run(int dtype, int dh, int gb, const void* q, const void* k, const void* v,
        const Addr& addr, void* out, void* part_v, void* cnt_v, int B, int Hkv, int G,
        int chunk, int splits, Scale scale_of, cudaStream_t stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxG || gb < 1 || chunk < 1 || splits < 1 ||
      splits > kMaxSplits)
    return -1;
  const int ng = (G + gb - 1) / gb;
  if ((long long)B * Hkv * ng > 65535) return -1;
  if (splits > 1 && (part_v == nullptr || cnt_v == nullptr)) return -1;
  float* part = static_cast<float*>(part_v);
  int* cnt = static_cast<int*>(cnt_v);
  const float scale = scale_of(dh);
#define SPLITK_DH(T)                                                          \
  switch (dh) {                                                               \
    case 32: return dispatch_gb<T, 32>(gb, SPLITK_ARGS);                      \
    case 64: return dispatch_gb<T, 64>(gb, SPLITK_ARGS);                      \
    case 80: return dispatch_gb<T, 80>(gb, SPLITK_ARGS);                      \
    case 128: return dispatch_gb<T, 128>(gb, SPLITK_ARGS);                    \
    case 256: return dispatch_gb<T, 256>(gb, SPLITK_ARGS);                    \
    default: return -1;                                                       \
  }
  if (dtype == 0) SPLITK_DH(float)
  if (dtype == 1) SPLITK_DH(__nv_bfloat16)
  return -1;
}

// CTAs of the (dtype, dh, gb) instance that one SM holds at once (>= 0), or
// -1 for an instance that is not built; a failed query gives -1 - error.
template <typename Addr>
int resident_ctas(int dtype, int dh, int gb) {
  const void *q = nullptr, *k = nullptr, *v = nullptr;
  const Addr addr{};
  void* out = nullptr;
  float* part = nullptr;
  int* cnt = nullptr;
  const int B = 1, Hkv = 1, G = gb, ng = 1, chunk = 1, splits = -1;
  const float scale = 1.f;
  const cudaStream_t stream = nullptr;
  if (dtype == 0) SPLITK_DH(float)
  if (dtype == 1) SPLITK_DH(__nv_bfloat16)
  return -1;
}
#undef SPLITK_DH

#undef SPLITK_ARGS

}  // namespace splitk
