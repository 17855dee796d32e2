// Paged GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:182-264
// (`_paged_decode_kernel` / `paged_flash_decode`): one query token per
// request attends its KV cache through a block table into ONE pool shared
// by every request.  Same function, not the same block structure:
//
//   * one CTA per (request b, KV head h): grid (B, Hkv), 128 threads.  The
//     CTA holds that head's G query rows (pre-scaled by dh^-0.5, in f32)
//     and the f32 running max, sum and G x dh accumulators (registers);
//   * the TPU grid visits all nbmax table entries and no-ops past the tail;
//     here the CTA reads block_tables[b, t/bs] itself (there is no scalar
//     prefetch) and walks only tokens [lo, seq_len), lo = seq_len - window
//     when window > 0, in tiles of 16 tokens staged in shared memory with
//     16-byte loads;
//   * masked positions carry NEG_INF = -1e30 and get probability 0; the
//     final divide is clamped at 1e-30, so a seq_len == 0 row returns zeros
//     as the TPU kernel does.
//
// Bound on this card: memory.  The work reads each live K and V row once,
// sum_b min(seq_len_b, window) * Hkv * dh * 2 * sizeof(dtype) bytes, at
// 3.35 TB/s (H100 SXM); the arithmetic (4 flops per K/V element and query
// row) is far below the tensor-core rate.  This first version stages one
// tile at a time with no overlap of loads and math, so it is latency-bound
// when B * Hkv is small.  What a later version changes: split-K over the
// blocks when B * Hkv < 132 SMs (a second pass merges the partial
// softmax states), and TMA (or cp.async) multi-stage loads of the K/V tiles.
//
// Types: float32 and bfloat16 (q, pools, out of one type); dh in
// {32, 64, 80, 128, 256} as a template parameter (dh = 80, StableLM-3B's,
// is 20 f32 or 10 bf16 16-byte loads a row; the score loop's lanes past
// dh add nothing); any G <= 16.  The caller checks
// shapes, types, alignment and contiguity; the launch runs on the given
// stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;     // tokens staged per iteration
constexpr int kMaxG = 16;     // query rows per KV head

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16(v); }

// One 16-byte load of 4 floats or 8 bfloat16s, widened to f32 in shared
// memory with 16-byte stores.
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
__device__ __forceinline__ void zero16(const float*, float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero16(const __nv_bfloat16*, float* dst) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(dst)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,       // (B, Hkv, G, DH)
                    const T* __restrict__ k_pool,  // (nb, bs, Hkv, DH)
                    const T* __restrict__ v_pool,  // (nb, bs, Hkv, DH)
                    const int* __restrict__ block_tables,  // (B, nbmax)
                    const int* __restrict__ seq_lens,      // (B,)
                    T* __restrict__ out,           // (B, Hkv, G, DH)
                    int Hkv, int G, int bs, int nbmax, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // G x DH scaled queries
  float* Ks = Qs + G * DH;                      // kTile x DH
  float* Vs = Ks + kTile * DH;                  // kTile x DH
  float* Ss = Vs + kTile * DH;                  // G x kTile scores, then probs
  float* Ms = Ss + G * kTile;                   // G running max
  float* Ls = Ms + G;                           // G running sum
  float* Cs = Ls + G;                           // G rescale of this tile

  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int kChunks = DH / kVec;            // 16-byte loads per token row
  constexpr int kPerThread = (kMaxG * DH + kThreads - 1) / kThreads;

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = seq_lens[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int* table = block_tables + (size_t)b * nbmax;
  const size_t row_stride = (size_t)Hkv * DH;   // pool elements per token slot
  const size_t qo = ((size_t)b * Hkv + h) * G * DH;

  for (int e = tid; e < G * DH; e += kThreads) Qs[e] = to_float(q[qo + e]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = (lo / kTile) * kTile; t0 < len; t0 += kTile) {
    // 1. stage the tile's K and V rows; rows outside [lo, len) are zeros
    for (int c = tid; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * kVec, t = t0 + r;
      float* kd = Ks + r * DH + col;
      float* vd = Vs + r * DH + col;
      if (t >= lo && t < len) {
        const size_t slot = (size_t)table[t / bs] * bs + (t % bs);
        const size_t off = slot * row_stride + (size_t)h * DH + col;
        stage16(k_pool + off, kd);
        stage16(v_pool + off, vd);
      } else {
        zero16(k_pool, kd);
        zero16(v_pool, vd);
      }
    }
    __syncthreads();

    // 2. scores: one warp per (query row, token) pair, lanes across DH
    for (int pr = warp; pr < G * kTile; pr += kWarps) {
      const int g = pr / kTile, r = pr % kTile, t = t0 + r;
      float s = 0.f;
#pragma unroll
      for (int d = lane; d < DH; d += 32) s += Qs[g * DH + d] * Ks[r * DH + d];
      s = warp_sum(s);
      if (lane == 0) Ss[pr] = (t >= lo && t < len) ? s : kNegInf;
    }
    __syncthreads();

    // 3. online softmax: one warp per query row, one lane per token
    for (int g = warp; g < G; g += kWarps) {
      const int t = t0 + lane;
      const bool ok = lane < kTile && t >= lo && t < len;
      const float s = ok ? Ss[g * kTile + lane] : kNegInf;
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      if (lane < kTile) Ss[g * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + psum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + P @ V; thread owns elements tid + i * kThreads
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * DH) {
        const int g = e / DH, d = e % DH;
        float a = acc[i] * Cs[g];
#pragma unroll
        for (int r = 0; r < kTile; ++r) a += Ss[g * kTile + r] * Vs[r * DH + d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * DH) store(out + qo + e, acc[i] / fmaxf(Ls[e / DH], 1e-30f));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* bt,
           const int* sl, void* out, int B, int Hkv, int G, int bs, int nbmax,
           int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * DH + 2 * kTile * DH + G * kTile + 3 * G);
  auto kernel = paged_decode_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), bt, sl, static_cast<T*>(out), Hkv, G, bs,
      nbmax, window, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, const int* bt,
                const int* sl, void* out, int B, int Hkv, int G, int bs, int nbmax,
                int window, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, bt, sl, out, B, Hkv, G, bs, nbmax, window, stream);
    case 64: return launch<T, 64>(q, k, v, bt, sl, out, B, Hkv, G, bs, nbmax, window, stream);
    case 80: return launch<T, 80>(q, k, v, bt, sl, out, B, Hkv, G, bs, nbmax, window, stream);
    case 128: return launch<T, 128>(q, k, v, bt, sl, out, B, Hkv, G, bs, nbmax, window, stream);
    case 256: return launch<T, 256>(q, k, v, bt, sl, out, B, Hkv, G, bs, nbmax, window, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch failed, -1 for a
// shape or type the kernel does not take.  dtype: 0 float32, 1 bfloat16.
int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                 const void* block_tables, const void* seq_lens, void* out, int B,
                 int Hkv, int G, int dh, int bs, int nbmax, int window, int dtype,
                 void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxG || bs < 1 || nbmax < 1) return -1;
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k_pool, v_pool, bt, sl, out, B, Hkv, G, bs, nbmax, window, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k_pool, v_pool, bt, sl, out, B, Hkv, G, bs, nbmax,
                                      window, s);
  return -1;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
