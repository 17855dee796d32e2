// Flash attention forward and split-K flash decode for Hopper (sm_90a),
// plain C interface.
//
// flash_forward replaces the TPU kernel
// repro/kernels/flash_attention/kernel.py:87 (`flash_forward`, body
// `_flash_fwd_kernel` at :39-84): causal / sliding-window attention of
// q (B, Sq, H, dh) over k, v (B, Skv, Hkv, dh), GQA with G = H / Hkv.
//
//   * One CTA per (64-row query tile, b·H + h), 256 threads as 16 x 16.
//     A loop inside the CTA walks the KV tiles of 64 keys in order,
//     replacing the Pallas grid's sequential third axis; the online
//     (m, l, acc) state of the tile's rows stays in registers (thread
//     (ty, tx) owns rows 4·ty..4·ty+3, keys 4·tx..4·tx+3 of S and columns
//     tx + 16·j of the output).
//   * K and V of KV head h / G are read straight from (B, S, Hkv, dh) by
//     their layout's strides: no copy G times (the reference's `_to_bh`).
//   * Only the KV tiles in the causal / window band are visited.  The
//     band is the Pallas grid's own `block_needed` rule on its 128-key
//     blocks (the Pallas grid visits every block and skips the FLOPs), so a
//     row whose allowed keys all lie outside the visited blocks gets the
//     Pallas result too; the 64-key tiles cost at most one extra tile at
//     each edge of the band.
//   * Masked scores are NEG_INF = -1e30 as in Pallas (a visited row with
//     every key masked so far gets p = 1 until a real score resets it);
//     keys past Skv in a ragged tile are -inf and never count.
//   * Compute is f32 from the inputs widened (q scaled after the cast), as
//     the Pallas kernel computes; only the output is rounded.
//
// Bound on this card: operations.  4·dh f32 operations per visited
// (query, key) pair and head, against 67 TFLOP/s on the CUDA cores (or
// 989 TFLOP/s for bf16 on the tensor cores, a `wgmma` kernel's target);
// the bytes, each of q, k, v read once and the output written once, are
// far below it.  This first version runs its two products as f32 FMAs on
// the CUDA cores from shared memory: 16-byte transposed Q and K tiles give
// 2 loads per 16 FMAs in Q·Kᵀ, and the loads of a tile are not overlapped
// with the math of the previous one.  What a later version changes: bf16
// `wgmma` tiles fed by TMA through a ring of shared-memory stages.
//
// flash_decode replaces kernel.py:151 (`flash_decode`, body
// `_flash_decode_kernel` at :120-148): one query token (G rows per KV
// head) attends a contiguous cache (B, S, Hkv, dh) of which the first
// `cache_len` positions are valid.
//
//   * Split-K: grid (splits, B·Hkv).  Each CTA walks one chunk of the
//     valid positions in tiles of 32 keys staged with 16-byte loads, keeps
//     an online (m, l, acc) per query row, and writes that partial state;
//     a second kernel merges each head's partials in chunk order (no
//     atomics, so the result is bit-stable).  At B = 8, Hkv = 8 a CTA per
//     head would fill 64 of the 132 SMs.
//   * Positions at or past cache_len are skipped.  cache_len <= 0 leaves
//     no valid position: every score is NEG_INF and the result is the mean
//     of V over all S, as the Pallas kernel returns.
//
// Bound on this card: memory.  2·B·S_valid·Hkv·dh·sizeof(dtype) bytes of
// K and V at 3.35 TB/s; the 4·G·dh operations per key are far below the
// f32 rate.  The split gives every SM several CTAs whose loads overlap one
// another's math; within a CTA the loads of a tile are not overlapped.
//
// Types: float32 and bfloat16 (all inputs and the output of one type); dh
// in {32, 64, 80, 128, 256} as a template parameter; G <= 16 for decode.
// The caller checks shapes, types, alignment (16 bytes) and contiguity;
// the launches run on the given stream, allocate nothing (the decode
// partials live in a caller-allocated f32 workspace) and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;   // the Pallas kernels' mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16(v); }

// Four consecutive elements widened to f32 (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// One 16-byte load (4 floats or 8 bfloat16s) widened into shared memory.
__device__ __forceinline__ void stage16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void stage16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}
template <typename T>
__device__ __forceinline__ void zero16(float* dst) {
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); i += 4)
    reinterpret_cast<float4*>(dst)[i / 4] = make_float4(0.f, 0.f, 0.f, 0.f);
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
// Over the 16 lanes that share bit 4 of the lane index.
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------------ forward
constexpr int kFwdThreads = 256;    // 16 x 16
constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // keys per tile
constexpr int kLd = kBQ + 4;        // row stride (floats) of the transposed tiles

template <typename T, int DH>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const T* __restrict__ q,   // (B, Sq, H, DH)
                 const T* __restrict__ k,   // (B, Skv, Hkv, DH)
                 const T* __restrict__ v,   // (B, Skv, Hkv, DH)
                 T* __restrict__ out,       // (B, Sq, H, DH)
                 int Sq, int Skv, int H, int Hkv, int causal, int window,
                 int qb_p, int kb_p, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // DH x kLd: scaled Qᵀ
  float* KV = Qt + DH * kLd;                     // DH x kLd: Kᵀ, then kBK x DH: V
  float* Pt = KV + DH * kLd;                     // kBK x kLd: Pᵀ

  constexpr int kC = DH / 4;                     // 4-element loads per row
  constexpr int kJ = DH / 16;                    // output columns per thread
  const int iq = gridDim.x - 1 - blockIdx.x;     // the longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = iq * kBQ;
  const size_t q_row = (size_t)H * DH, kv_row = (size_t)Hkv * DH;
  const T* qp = q + ((size_t)b * Sq * H + h) * DH;
  const T* kp = k + ((size_t)b * Skv * Hkv + hk) * DH;
  const T* vp = v + ((size_t)b * Skv * Hkv + hk) * DH;

  // Qᵀ, scaled after the cast; consecutive threads take consecutive rows
  for (int c = tid; c < kBQ * kC; c += kFwdThreads) {
    const int r = c % kBQ, d = (c / kBQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = load4(qp + (size_t)(q0 + r) * q_row + d);
    Qt[(d + 0) * kLd + r] = x.x * scale;
    Qt[(d + 1) * kLd + r] = x.y * scale;
    Qt[(d + 2) * kLd + r] = x.z * scale;
    Qt[(d + 3) * kLd + r] = x.w * scale;
  }

  // the Pallas blocks this query tile computes (kernel.py:54-60)
  const int iqp = q0 / qb_p;
  int lo_p = 0, hi_p = Skv / kb_p - 1;
  if (causal) hi_p = min(hi_p, (iqp * qb_p + qb_p - 1) / kb_p);
  if (window > 0) {
    const int t = iqp * qb_p - window + 1;     // need (ik + 1)·kb - 1 > iq·qb - window
    if (t > 0) lo_p = t / kb_p;
  }
  const int k_lo = lo_p * kb_p, k_hi = min(Skv, (hi_p + 1) * kb_p);

  float m[4], l[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();                           // Qᵀ written; last tile's V, Pᵀ read
    for (int c = tid; c < kBK * kC; c += kFwdThreads) {
      const int r = c % kBK, d = (c / kBK) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < Skv) x = load4(kp + (size_t)(k0 + r) * kv_row + d);
      KV[(d + 0) * kLd + r] = x.x;
      KV[(d + 1) * kLd + r] = x.y;
      KV[(d + 2) * kLd + r] = x.z;
      KV[(d + 3) * kLd + r] = x.w;
    }
    __syncthreads();

    // S = Q·Kᵀ, a 4 x 4 block per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kLd + ty * 4);
      const float4 bq = *reinterpret_cast<const float4*>(KV + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, then the online softmax of each row over its 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = s[i][j];
        if (kpos >= Skv)
          x = -CUDART_INF_F;
        else if ((causal && qpos < kpos) || (window > 0 && qpos - kpos >= window))
          x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Pt[(tx * 4 + j) * kLd + ty * 4 + i] = s[i][j];
    __syncthreads();                           // Kᵀ read; Pᵀ visible

    for (int c = tid; c < kBK * kC; c += kFwdThreads) {
      const int r = c / kC, d = (c % kC) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < Skv) x = load4(vp + (size_t)(k0 + r) * kv_row + d);
      *reinterpret_cast<float4*>(KV + r * DH + d) = x;
    }
    __syncthreads();

    // acc += P·V
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + kk * kLd + ty * 4);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float vv = KV[kk * DH + tx + 16 * j];
        acc[0][j] = fmaf(p4.x, vv, acc[0][j]);
        acc[1][j] = fmaf(p4.y, vv, acc[1][j]);
        acc[2][j] = fmaf(p4.z, vv, acc[2][j]);
        acc[3][j] = fmaf(p4.w, vv, acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)b * Sq + row) * q_row + (size_t)h * DH;
#pragma unroll
    for (int j = 0; j < kJ; ++j) store(o + tx + 16 * j, acc[i][j] / li);
  }
}

// ------------------------------------------------------------------- decode
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecTile = 32;        // keys per tile: one per lane in the softmax
constexpr int kMaxG = 16;           // query rows per KV head

template <typename T, int DH>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split(const T* __restrict__ q,    // (B, Hkv, G, DH)
                   const T* __restrict__ k,    // (B, S, Hkv, DH)
                   const T* __restrict__ v,    // (B, S, Hkv, DH)
                   float* __restrict__ part,   // (B·Hkv, splits, G·(DH + 2))
                   int len, int S, int Hkv, int G, int chunk, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int kLdK = DH + 4;                  // padded K rows: conflict-free float4 reads
  float* Qs = reinterpret_cast<float*>(smem4);  // G x DH scaled queries
  float* Ks = Qs + G * DH;                      // kDecTile x kLdK
  float* Vs = Ks + kDecTile * kLdK;             // kDecTile x DH
  float* Ss = Vs + kDecTile * DH;               // G x kDecTile probabilities
  float* Ms = Ss + G * kDecTile;                // G running max
  float* Ls = Ms + G;                           // G running sum
  float* Cs = Ls + G;                           // G rescale of this tile

  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int kChunks = DH / kVec;
  constexpr int kPerThread = (kMaxG * DH + kDecThreads - 1) / kDecThreads;

  const int split = blockIdx.x, row = blockIdx.y;   // row = b·Hkv + hk
  const int b = row / Hkv, hk = row % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool none = len <= 0;                   // no valid position at all
  const int hi = none ? S : min(len, S);
  const int lo = split * chunk, end = min(lo + chunk, hi);
  const size_t kv_row = (size_t)Hkv * DH;
  const T* kp = k + ((size_t)b * S * Hkv + hk) * DH;
  const T* vp = v + ((size_t)b * S * Hkv + hk) * DH;
  const T* qp = q + (size_t)row * G * DH;

  for (int e = tid; e < G * DH; e += kDecThreads) Qs[e] = to_float(qp[e]) * scale;
  for (int g = tid; g < G; g += kDecThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = lo; t0 < end; t0 += kDecTile) {
    // 1. stage the tile's K and V rows; rows at or past `end` are zeros
    for (int c = tid; c < kDecTile * kChunks; c += kDecThreads) {
      const int r = c / kChunks, col = (c % kChunks) * kVec, t = t0 + r;
      float* kd = Ks + r * kLdK + col;
      float* vd = Vs + r * DH + col;
      if (t < end) {
        stage16(kp + (size_t)t * kv_row + col, kd);
        stage16(vp + (size_t)t * kv_row + col, vd);
      } else {
        zero16<T>(kd);
        zero16<T>(vd);
      }
    }
    __syncthreads();

    // 2. scores and the online softmax: one warp per query row, a lane per key
    for (int g = warp; g < G; g += kDecWarps) {
      const float* kr = Ks + lane * kLdK;
      const float* qr = Qs + g * DH;
      float s = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
        const float4 qq = *reinterpret_cast<const float4*>(qr + d);
        s = fmaf(qq.x, kk.x, s);
        s = fmaf(qq.y, kk.y, s);
        s = fmaf(qq.z, kk.z, s);
        s = fmaf(qq.w, kk.w, s);
      }
      const float x = t0 + lane < end ? (none ? kNegInf : s) : -CUDART_INF_F;
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = expf(x - m_new);
      const float psum = warp_sum(p);
      Ss[g * kDecTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + psum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + P·V; a thread owns elements tid + i·kDecThreads
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kDecThreads;
      if (e < G * DH) {
        const int g = e / DH, d = e % DH;
        float a = acc[i] * Cs[g];
#pragma unroll 8
        for (int r = 0; r < kDecTile; ++r) a = fmaf(Ss[g * kDecTile + r], Vs[r * DH + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  // the partial state of this chunk: G maxima, G sums, G x DH accumulators
  float* pp = part + ((size_t)row * gridDim.x + split) * G * (DH + 2);
  for (int g = tid; g < G; g += kDecThreads) {
    pp[g] = Ms[g];
    pp[G + g] = Ls[g];
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kDecThreads;
    if (e < G * DH) pp[2 * G + e] = acc[i];
  }
}

// Merges each head's partials in chunk order: out = Σ acc·w / Σ l·w with
// w = exp(m_c - max_c m_c).
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_merge(const float* __restrict__ part, T* __restrict__ out, int G, int dh,
                   int splits) {
  const int row = blockIdx.x;
  const size_t stride = (size_t)G * (dh + 2);
  const float* base = part + (size_t)row * splits * stride;
  for (int e = threadIdx.x; e < G * dh; e += kDecThreads) {
    const int g = e / dh;
    float M = kNegInf;
    for (int c = 0; c < splits; ++c) M = fmaxf(M, base[c * stride + g]);
    float L = 0.f, A = 0.f;
    for (int c = 0; c < splits; ++c) {
      const float* pc = base + c * stride;
      const float w = expf(pc[g] - M);
      L = fmaf(pc[G + g], w, L);
      A = fmaf(pc[2 * G + e], w, A);
    }
    store(out + (size_t)row * G * dh + e, A / fmaxf(L, 1e-30f));
  }
}

inline float inv_sqrt(int dh) { return (float)(1.0 / sqrt((double)dh)); }

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int DH>
int launch_forward(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int H, int Hkv, int causal, int window, int qb_p, int kb_p,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * DH * kLd + (size_t)kBK * kLd);
  auto kernel = flash_fwd_kernel<T, DH>;
  if (const int err = allow_smem(kernel, smem)) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, Hkv, causal, window, qb_p, kb_p, inv_sqrt(DH));
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_decode(const void* q, const void* k, const void* v, void* out, float* part,
                  int len, int B, int S, int Hkv, int G, int chunk, int splits,
                  cudaStream_t stream) {
  constexpr int kLdK = DH + 4;
  const size_t smem = sizeof(float) * ((size_t)G * DH + (size_t)kDecTile * kLdK +
                                       (size_t)kDecTile * DH + (size_t)G * kDecTile + 3 * G);
  auto kernel = flash_decode_split<T, DH>;
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3(splits, B * Hkv), kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part,
      len, S, Hkv, G, chunk, inv_sqrt(DH));
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  flash_decode_merge<T><<<B * Hkv, kDecThreads, 0, stream>>>(part, static_cast<T*>(out), G,
                                                              DH, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int forward_dh(int dh, const void* q, const void* k, const void* v, void* out, int B, int Sq,
               int Skv, int H, int Hkv, int causal, int window, int qb, int kb,
               cudaStream_t s) {
  switch (dh) {
    case 32: return launch_forward<T, 32>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, qb, kb, s);
    case 64: return launch_forward<T, 64>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, qb, kb, s);
    case 80: return launch_forward<T, 80>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, qb, kb, s);
    case 128: return launch_forward<T, 128>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, qb, kb, s);
    case 256: return launch_forward<T, 256>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, qb, kb, s);
    default: return -1;
  }
}

template <typename T>
int decode_dh(int dh, const void* q, const void* k, const void* v, void* out, float* part,
              int len, int B, int S, int Hkv, int G, int chunk, int splits,
              cudaStream_t s) {
  switch (dh) {
    case 32: return launch_decode<T, 32>(q, k, v, out, part, len, B, S, Hkv, G, chunk, splits, s);
    case 64: return launch_decode<T, 64>(q, k, v, out, part, len, B, S, Hkv, G, chunk, splits, s);
    case 80: return launch_decode<T, 80>(q, k, v, out, part, len, B, S, Hkv, G, chunk, splits, s);
    case 128: return launch_decode<T, 128>(q, k, v, out, part, len, B, S, Hkv, G, chunk, splits, s);
    case 256: return launch_decode<T, 256>(q, k, v, out, part, len, B, S, Hkv, G, chunk, splits, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Each returns 0 on success, a cudaError_t code if a launch failed, -1 for
// a shape or type the kernel does not take.  dtype: 0 float32, 1 bfloat16.

// q (B, Sq, H, dh), k/v (B, Skv, Hkv, dh), out like q; qb/kb are the
// Pallas kernel's blocks (min(128, Sq), min(128, Skv)), which decide the
// visited band.
int flash_forward(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                  int Skv, int H, int Hkv, int dh, int causal, int window, int qb, int kb,
                  int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv || B * H > 65535) return -1;
  if (qb < 1 || kb < 1 || Sq % qb || Skv % kb || (qb < Sq && qb % kBQ) ||
      (kb < Skv && kb % kBK))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward_dh<float>(dh, q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, qb, kb, s);
  if (dtype == 1)
    return forward_dh<__nv_bfloat16>(dh, q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, qb,
                                     kb, s);
  return -1;
}

// q (B, 1, Hkv·G, dh), caches (B, S, Hkv, dh), out like q; the first
// cache_len positions are valid; part holds B·Hkv·splits·G·(dh + 2)
// floats; CTA c covers positions [c·chunk, (c + 1)·chunk) of the valid ones.
int flash_decode(const void* q, const void* k, const void* v, void* out, void* part,
                 int cache_len, int B, int S, int Hkv, int G, int dh,
                 int chunk, int splits, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || G > kMaxG || chunk < 1 || splits < 1 ||
      B * Hkv > 65535)
    return -1;
  float* pw = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return decode_dh<float>(dh, q, k, v, out, pw, cache_len, B, S, Hkv, G, chunk, splits, s);
  if (dtype == 1)
    return decode_dh<__nv_bfloat16>(dh, q, k, v, out, pw, cache_len, B, S, Hkv, G, chunk,
                                    splits, s);
  return -1;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
