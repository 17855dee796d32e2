// Paged GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:226
// (`paged_flash_decode`, body `_paged_decode_kernel` at :182-222): one
// query token per request attends its KV cache through a block table into
// ONE pool shared by every request.  Same function, not the same block
// structure.
//
// Bound on this card: bytes.  The work reads each live K and V row once,
// sum_b min(seq_len_b, window) * Hkv * dh * 2 * sizeof(dtype) bytes, at
// 3.35 TB/s (H100 SXM); its 4·G·dh f32 operations per live row and KV head
// stay under the f32 rate at G <= 16.  What the design does about it:
//
//   * Split-K over the block table: grid (splits, B·Hkv·ng).  Each CTA
//     walks one chunk of its row's live range [lo, hi), lo = seq_len -
//     window when window > 0 (else 0), hi = min(seq_len, nbmax·bs), and
//     reads block_tables[b, t / bs] itself (there is no scalar prefetch).
//     The host picks `chunk` (a whole number of pool blocks) and `splits`
//     from shapes alone, aiming at a few CTAs per SM, so that a few long
//     rows fill the card instead of one CTA each; it never reads seq_lens
//     (a device tensor: reading it would sync the host inside a decode
//     step).  With a window the chunks split the window's positions
//     relative to each row's own lo, so a windowed row idles no CTA; a CTA
//     whose chunk starts at or past the row's end exits at once.
//   * Loads overlap the math: the K and V rows of the next tile of 32
//     positions stream into shared memory with 16-byte `cp.async` (rows
//     padded so that a quarter-warp's reads hit distinct banks) while the
//     four warps compute on the current tile, double-buffered.
//   * Math in f32 on the CUDA cores.  The G query rows of the KV head
//     (pre-scaled by dh^-0.5 after the cast, as the TPU kernel does) sit
//     in shared memory and are read as broadcasts; a warp takes 8 positions
//     of each tile, a quarter of dh per lane for Q·Kᵀ, then column pairs of
//     dh for P·V; the running max, sum and the G x dh accumulators of each
//     warp's rows stay in registers.  The kernel is built for 1, 2, 4, 8,
//     12 and 16 rows a CTA: the rows past G compute on zero queries, with
//     no branch to break the chains of independent rows, and are not
//     stored.  G rows beyond a register budget (G > 8 at dh 256) go to a
//     second CTA of the same split (ng = 2).
//   * Merge in split order, no atomics on the data: the four warps' states
//     merge in warp order in shared memory; a row with one live chunk
//     writes its output directly (one launch, no merge); otherwise each
//     CTA writes its (m, l, acc) partial to an f32 workspace and the last
//     CTA of the row to arrive (an arrival counter per row, which that CTA
//     resets to 0) merges the row's partials (at most 128) in split order,
//     so the result is bit-stable from run to run and the op stays one
//     launch.
//
// Semantics of the TPU kernel: the output is acc / max(l, 1e-30), so a
// seq_len == 0 row is zeros; an empty partial (m = NEG_INF = -1e30, l = 0,
// acc = 0) merges with weight exp(m_c - M), which is 0 beside a real
// score.  The TPU kernel also visits blocks that lie wholly before the
// window (their NEG_INF scores give p = 1 until a real score resets the
// running sum); those positions are never visited here, which changes no
// output.  Positions past a chunk's end score -inf and weigh 0.
//
// Types: float32 and bfloat16 (q, pools, out of one type); dh in
// {32, 64, 80, 128, 256} as a template parameter (dh = 80's rows are 160
// bf16 or 320 f32 bytes: the lanes past dh add nothing); any G <= 16.
// The caller checks shapes, types, alignment and contiguity and allocates
// the workspace and the counters; the launch runs on the given stream and
// does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                 // positions per pipeline stage
constexpr int kWarpTok = kTile / kWarps;  // positions per warp per tile
constexpr int kMaxG = 16;
constexpr int kMaxSplits = 128;         // CTAs per row at most (the merge's weights)

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

template <typename T, int DH, int GB>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,       // (B, Hkv, G, DH)
                    const T* __restrict__ k_pool,  // (nb, bs, Hkv, DH)
                    const T* __restrict__ v_pool,  // (nb, bs, Hkv, DH)
                    const int* __restrict__ block_tables,  // (B, nbmax)
                    const int* __restrict__ seq_lens,      // (B,)
                    T* __restrict__ out,           // (B, Hkv, G, DH)
                    float* __restrict__ part,      // (rows, splits, GB·(DH + 2)) if splits > 1
                    int* __restrict__ counters,    // (rows,) zeros, if splits > 1
                    int Hkv, int G, int ng, int bs, int nbmax, int window, int chunk,
                    float scale) {
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

  const int sl = seq_lens[b];
  const int lo = window > 0 ? max(0, sl - window) : 0;
  const int hi = min(sl, nbmax * bs);
  const int live = max(0, hi - lo);
  const int n_live = (live + chunk - 1) / chunk;
  const size_t qo = ((size_t)bh * G + g0) * DH;     // first of this CTA's query rows
  if (split >= n_live) {                            // nothing of the row to walk
    if (n_live == 0 && split == 0)
      for (int e = tid; e < gn * DH; e += kThreads) store(out + qo + e, 0.f);
    return;
  }
  const int begin = lo + split * chunk, end = min(begin + chunk, hi);
  const int* table = block_tables + (size_t)b * nbmax;
  const size_t row_stride = (size_t)Hkv * DH;       // pool elements per token slot

  // issue the cp.async loads of tile `it` into stage `st`; rows past `end`
  // are zero-filled
  auto load_tile = [&](int it, int st) {
    unsigned char* ks = stages + st * Gm::kStageBytes;
    unsigned char* vs = ks + kTile * Gm::kLdBytes;
    for (int e = tid; e < kTile * Gm::kChunks; e += kThreads) {
      const int r = e / Gm::kChunks, c = e % Gm::kChunks, t = begin + it * kTile + r;
      const bool ok = t < end;
      size_t off = 0;
      if (ok) off = ((size_t)table[t / bs] * bs + t % bs) * row_stride + (size_t)h * DH;
      off += (size_t)c * Gm::kVec;
      cp_async16(ks + r * Gm::kLdBytes + c * 16, ok ? k_pool + off : k_pool, ok);
      cp_async16(vs + r * Gm::kLdBytes + c * 16, ok ? v_pool + off : v_pool, ok);
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
int launch(const void* q, const void* k_pool, const void* v_pool, const int* bt,
           const int* sl, void* out, float* part, int* counters, int B, int Hkv, int G,
           int ng, int bs, int nbmax, int window, int chunk, int splits,
           cudaStream_t stream) {
  using Gm = Geom<T, DH>;
  constexpr int GBP = (GB + 3) / 4 * 4;
  const size_t stage = 2 * (size_t)Gm::kStageBytes;
  const size_t merge = sizeof(float) * ((size_t)2 * kWarps * GB + (size_t)kWarps * GB * DH);
  const size_t final_merge = sizeof(float) * ((size_t)kMaxSplits * GB + 2 * GB);
  size_t reuse = stage > merge ? stage : merge;
  reuse = reuse > final_merge ? reuse : final_merge;
  const size_t smem = sizeof(float) * ((size_t)GB * DH + (size_t)kWarps * kWarpTok * GBP) + reuse;
  auto kernel = paged_decode_kernel<T, DH, GB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(splits, B * Hkv * ng), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), bt, sl, static_cast<T*>(out), part, counters, Hkv, G,
      ng, bs, nbmax, window, chunk, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

#define PD_ARGS q, k, v, bt, sl, out, part, cnt, B, Hkv, G, ng, bs, nbmax, window, chunk, \
                splits, stream

template <typename T, int DH>
int dispatch_gb(int gb, const void* q, const void* k, const void* v, const int* bt,
                const int* sl, void* out, float* part, int* cnt, int B, int Hkv, int G,
                int ng, int bs, int nbmax, int window, int chunk, int splits,
                cudaStream_t stream) {
  switch (gb) {
    case 1: return launch<T, DH, 1>(PD_ARGS);
    case 2: return launch<T, DH, 2>(PD_ARGS);
    case 4: return launch<T, DH, 4>(PD_ARGS);
    case 8: return launch<T, DH, 8>(PD_ARGS);
    case 12:
      if constexpr (DH <= 128) return launch<T, DH, 12>(PD_ARGS);
      return -1;
    case 16:
      if constexpr (DH <= 128) return launch<T, DH, 16>(PD_ARGS);
      return -1;
    default: return -1;
  }
}

template <typename T>
int dispatch_dh(int dh, int gb, const void* q, const void* k, const void* v, const int* bt,
                const int* sl, void* out, float* part, int* cnt, int B, int Hkv, int G,
                int ng, int bs, int nbmax, int window, int chunk, int splits,
                cudaStream_t stream) {
  switch (dh) {
    case 32: return dispatch_gb<T, 32>(gb, PD_ARGS);
    case 64: return dispatch_gb<T, 64>(gb, PD_ARGS);
    case 80: return dispatch_gb<T, 80>(gb, PD_ARGS);
    case 128: return dispatch_gb<T, 128>(gb, PD_ARGS);
    case 256: return dispatch_gb<T, 256>(gb, PD_ARGS);
    default: return -1;
  }
}

#undef PD_ARGS

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch failed, -1 for a
// shape or type the kernel does not take.  dtype: 0 float32, 1 bfloat16.
// gb: query rows per CTA (1, 2, 4, 8, 12 or 16; at most 8 for dh 256), ng =
// ceil(G / gb) CTAs per (request, KV head) and split.  chunk: positions per
// split, a multiple of bs; splits: CTAs per row, at most 128.  With splits > 1, part
// holds B·Hkv·ng·splits·gb·(dh + 2) floats and counters B·Hkv·ng zeros.
int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                 const void* block_tables, const void* seq_lens, void* out, void* part,
                 void* counters, int B, int Hkv, int G, int dh, int gb, int bs, int nbmax,
                 int window, int chunk, int splits, int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxG || bs < 1 || nbmax < 1 || chunk < 1 ||
      chunk % bs || splits < 1 || splits > kMaxSplits)
    return -1;
  if (gb < 1) return -1;
  const int ng = (G + gb - 1) / gb;
  if ((long long)B * Hkv * ng > 65535) return -1;
  if (splits > 1 && (part == nullptr || counters == nullptr)) return -1;
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  float* pw = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dh, gb, q, k_pool, v_pool, bt, sl, out, pw, cnt, B, Hkv, G, ng,
                              bs, nbmax, window, chunk, splits, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, gb, q, k_pool, v_pool, bt, sl, out, pw, cnt, B, Hkv,
                                      G, ng, bs, nbmax, window, chunk, splits, s);
  return -1;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
