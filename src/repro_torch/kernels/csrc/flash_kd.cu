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
//   * kernels 9 and 10 run their products on the tensor cores (`wgmma`
//     m64n128k16, bf16 operands, f32 accumulators, fed by TMA; one GEMM for
//     both, namespace split_gemm below).  f32 operands do not fit one bf16
//     product: at the path's magnitudes one bf16 product misses the head
//     gradients' bound (2^-14 of the summed magnitudes) by up to 8x, one
//     TF32 product by 1.3x.  So each f32 operand x is split into
//     hi = bf16(x) and lo = bf16(x - hi), and each product runs as
//     hi·hi + hi·lo + lo·hi (within 0.024 of the bound on the CPU; the
//     lo·lo term is below f32's own rounding).  A bf16 head has no lo half,
//     so its products take one (logits) or two bf16 products.  Both walk V
//     in chunks of 16,384 columns; per chunk (0) a split pass reads
//     W[:, chunk] through W's strides, via a shared-memory tile so that the
//     read runs along W's unit-stride axis and the write along d, and
//     writes its hi/lo planes as (chunk, D) rows into a workspace (h, and
//     for kernel 10 h^T, are split once a call); every workspace dimension
//     is padded to 128 with zeros, so the TMA maps never see the caller's
//     strides (an untied head at V = 517 has a 2,068-byte row pitch, which
//     TMA cannot map) and no tile is ragged; then (a) S = h W[:, chunk].
//   * kernel 9: pass (a)'s epilogue feeds S into online states and never
//     stores it.  A thread holds rows r0 and r0 + 8 and 32 columns of each;
//     per row it takes the max over its 32 values, then sums their
//     exponentials and the cross term (one rescale a row, as the Pallas
//     body's per-block update), merges the four lanes of the row (xor 1,
//     then 2) and writes one partial (ms, ls, mt, lt, x) per (row,
//     128-column tile).  The teacher's tile and the bias are read before
//     the mainloop, so their latency hides behind it.  A row's partials
//     (2,000 at V = 256,000) are merged by one warp, lane i taking tiles i,
//     i + 32, ... in order and the lanes merged in a fixed tree, and kernel
//     7's combine turns the rows' states into lse_s, lse_t and the loss.
//   * kernel 10: pass (a)'s epilogue forms d = g tau/B (e^{s - lse_s}
//     - e^{t - lse_t}) (0 past V, as FLASH_PAD gives) and writes d's hi/lo
//     planes; (b) dW[:, chunk] = h^T d, written once from the accumulators
//     in W's own layout and type (eight lanes hold eight consecutive rows,
//     so the f32 stores fill whole sectors in either layout); (c) dh +=
//     d W[:, chunk]^T: its 64 output tiles of 128 x 128 at B 512, D 2048
//     would fill half the card, so the chunk's depth is split (in two
//     there; shapes alone decide), each split writes an f32 partial and a
//     reduction adds them to dh in split order, chunks in order; (d) with
//     a bias, db[chunk] = sum_b d, rows in order.
//   No atomics on data anywhere: bit-stable from call to call.  A stays
//   K-major everywhere and B is K-major (a) or MN-major (b, c), the two
//   forms kernel 12 runs; the scaffolding (TMA, mbarrier ring, descriptors,
//   128-byte swizzle) is shared with kernel 12 through hopper_tma.cuh.
//
// W is read through its strides, so the tied head (embed^T, a (D, V) view
// with strides (1, D)) is used in place and its gradient is written with the
// same strides: autograd's transpose back to the embedding copies nothing.
//
// Bound on this card (H100 SXM: HBM 3.35 TB/s; 989 TFLOP/s bf16 dense) at
// the LM path's shapes, B = 512 rows, D = 2048, V = 256,000:
//   kernel 7: bytes, s f32 and z_mean bf16 read once: 0.79 GB, 0.235 ms;
//   kernel 8: bytes, s and z_mean read, the f32 gradient written: 1.3 GB,
//   0.39 ms;
//   kernel 9: operations, 3 bf16 products x 2 B D V = 1.61 TFLOP, 1.63 ms
//   (the bytes alone, 0.70 ms).  One bf16 product (0.54 ms) holds the
//   forward's own bounds with less margin, and kernel 10, which uses these
//   normalisers with its own three-product logits, would carry the
//   difference; the f32 CUDA-core bound is 8.0 ms;
//   kernel 10: operations, 3 GEMMs x 3 bf16 products x 2 B D V = 4.83 TFLOP,
//   4.9 ms (the bytes alone, 1.33 ms).  A one-product bound (1.6 ms) is out
//   of reach at this accuracy; the f32 CUDA-core bound of the same three
//   GEMMs is 24 ms.
// Kernels 7 and 8 stream every byte once (kernel 7's partials are 20 B per
// 4096 columns).  The GEMMs' 128 x 128 tiles, three stages deep, read
// their operands from L2; the W split moves W's bytes three times.
//
// What a later version changes: W's hi/lo planes kept from kernel 9 for
// kernel 10, or the split folded into the producer's loads; persistent
// CTAs and 128 x 256 tiles; 16-byte vector loads in 7 and 8.
//
// Types: s, z_mean, h, W and b f32 or bf16 (h, W and b share one type); the
// accumulation is f32 throughout.  The caller checks shapes, types and
// strides, and allocates every output and workspace; each launch runs on
// the given stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper_tma.cuh"

namespace {

constexpr float kPad = -1e30f;          // FLASH_PAD
constexpr int kThreads = 256;
constexpr int kParts = 5;               // floats per partial: ms, ls, mt, lt, x
constexpr int kRowChunk = 4096;         // kernel 7: columns of one row per CTA
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

// Kernels 7 and 9, last launch: each row's partials merged in chunk order,
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

// ---------------------------------------------------------------- launches
inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
inline int fwd_chunks(int V) { return cdiv(V, kRowChunk); }

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

// ------------------------------------------------------- the split GEMM
// The tensor-core GEMM of kernels 9 and 10, each product as hi·hi + hi·lo +
// lo·hi of bf16 halves (see the file's header), and its split pass.
namespace split_gemm {

using namespace hopper;

constexpr int kBM = 128;                 // CTA tile rows: two consumer warpgroups of 64
constexpr int kBN = 128;                 // CTA tile columns
constexpr int kBK = 64;                  // depth per stage: one 128-byte swizzled row
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;
constexpr int kGemmThreads = 32 * kConsumerWarps + 32;   // + one producer warp
constexpr int kPlaneBytes = kBM * kBK * 2;               // 16 KB: one bf16 plane of a tile
constexpr int kStageBytes = 4 * kPlaneBytes;             // A hi, A lo, B hi, B lo
constexpr size_t kGemmSmem = 1024 + (size_t)kStages * kStageBytes + 2 * kStages * 8;
constexpr int kChunk = 16384;            // columns of V per pass
constexpr int kRound = 128;              // every workspace dimension is a multiple of this
constexpr int kSplitTile = 64;           // the split passes' shared-memory tile

inline long long pad(long long x) { return (x + kRound - 1) / kRound * kRound; }

// D (64 x 128, f32) += A·B, A K-major, B K-major (TB = 0) or MN-major
// (TB = 1) in 128-byte-swizzled shared memory.
template <int TB>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// C (M x N) = A·B over the k steps [z·k_steps, (z + 1)·k_steps) of kBK, z =
// blockIdx.z, for the CTA's kBM x kBN tile (blockIdx.x over M, so that the
// CTAs sharing a B tile run together; blockIdx.y over N).  A: a (2, M, K)
// bf16 map (hi, lo planes), K-major, boxes of kBK x kBM.  B: a (2, N, K)
// map, K-major, boxes of kBK x kBN (TB = 0), or a (2, K, N) map, MN-major,
// boxes of 64 columns x kBK rows (TB = 1).  LA / LB: whether A / B have a
// lo plane; at every k16 step the products are A_hi·B_hi, then A_hi·B_lo
// (LB), then A_lo·B_hi (LA), into one f32 accumulator.  One producer warp
// keeps a ring of kStages stages in flight with TMA; two consumer
// warpgroups own 64 rows each and keep one step's products in flight
// while they release the stage before it.  The epilogue's inputs
// are read before the mainloop (Epi::load), so their latency hides behind
// it; Epi::write gets the accumulators: a thread holds rows r0 and r0 + 8
// and, per 8 columns, the pair c0 + 8j, c0 + 8j + 1 (acc[4j + 2r] and the
// next).
template <bool LA, bool LB, int TB, typename Epi>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm3(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
      int k_steps, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t off = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* tiles = smem_raw + off;                 // 1024-byte aligned (swizzle atoms)
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, k_first = blockIdx.z * k_steps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {                          // the producer warp
    if (lane == 0) {
      constexpr uint32_t kBytes = kPlaneBytes * ((LA ? 2 : 1) + (LB ? 2 : 1));
      for (int it = 0; it < k_steps; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);  // a fresh barrier passes parity 1
        mbar_expect_tx(full + s, kBytes);
        unsigned char* st = tiles + s * kStageBytes;
        const int k = (k_first + it) * kBK;
        tma_load3(st, &ma, k, m0, 0, full + s);
        if (LA) tma_load3(st + kPlaneBytes, &ma, k, m0, 1, full + s);
#pragma unroll
        for (int pl = 0; pl < (LB ? 2 : 1); ++pl) {
          unsigned char* bt = st + (2 + pl) * kPlaneBytes;
          if (TB) {                                      // two 64-column panels of kBK rows
            tma_load3(bt, &mb, n0, k, pl, full + s);
            tma_load3(bt + kPlaneBytes / 2, &mb, n0 + 64, k, pl, full + s);
          } else {
            tma_load3(bt, &mb, k, n0, pl, full + s);
          }
        }
      }
      // stay until the consumers have released every stage in flight
      for (int it = max(0, k_steps - kStages); it < k_steps; ++it)
        mbar_wait(empty + it % kStages, (it / kStages) & 1);
    }
    return;
  }

  // consumers: warpgroup wgi owns rows m0 + 64·wgi .. +63 of the tile
  const int wgi = warp >> 2;
  const int r0 = m0 + wgi * 64 + (warp & 3) * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  typename Epi::Pre pre;
  epi.load(pre, r0, c0);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < k_steps; ++it) {
    const int s = it % kStages;
    mbar_wait(full + s, (it / kStages) & 1);
    const unsigned char* ah = tiles + s * kStageBytes + wgi * 64 * 128;
    const unsigned char* al = ah + kPlaneBytes;
    const unsigned char* bh = tiles + s * kStageBytes + 2 * kPlaneBytes;
    const unsigned char* bl = bh + kPlaneBytes;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dah = desc(ah + kk * 32, 16, 1024), dal = desc(al + kk * 32, 16, 1024);
      const uint64_t dbh = TB ? desc(bh + kk * 16 * 128, kPlaneBytes / 2, 1024)
                              : desc(bh + kk * 32, 16, 1024);
      const uint64_t dbl = TB ? desc(bl + kk * 16 * 128, kPlaneBytes / 2, 1024)
                              : desc(bl + kk * 32, 16, 1024);
      mma<TB>(acc, dah, dbh);
      if (LB) mma<TB>(acc, dah, dbl);
      if (LA) mma<TB>(acc, dal, dbh);
    }
    wg_commit();
    wg_wait1();                                          // step it - 1's products are done
    fence_regs(acc);
    if (it > 0 && lane == 0) mbar_arrive(empty + (it - 1) % kStages);
  }
  wg_wait0();
  fence_regs(acc);
  if (k_steps > 0 && lane == 0) mbar_arrive(empty + (k_steps - 1) % kStages);

  epi.write(pre, acc, r0, c0);
}

// The epilogues without inputs: nothing to read ahead, and a call per
// accumulator pair (row, column, value, its right neighbour).
struct NoPre {};

template <typename Pair>
__device__ __forceinline__ void for_pairs(const Pair& pair, const float (&acc)[64], int r0,
                                          int c0) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      pair(r0 + 8 * r, c0 + 8 * j, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
}

__device__ __forceinline__ void store_split(__nv_bfloat16* hi, __nv_bfloat16* lo, float x0,
                                            float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
}

// dst (2, Rp, Cp): the bf16 hi/lo planes of src(r, c) = src[r·s_r + c·s_c]
// for r < R, c < Cc, zeros elsewhere; with dst_t, the same transposed into
// (2, Cp, Rp).  A 64 x 64 tile goes through shared memory, read along src's
// unit-stride axis and written along the rows of each destination, so both
// sides coalesce.  grid (Cp / 64, Rp / 64).
template <typename TM>
__global__ void __launch_bounds__(256)
split_planes(const TM* __restrict__ src, long long s_r, long long s_c, int R, int Cc,
             __nv_bfloat16* __restrict__ dst, __nv_bfloat16* __restrict__ dst_t, int Rp,
             int Cp) {
  __shared__ float tile[kSplitTile][kSplitTile + 1];
  const int r0 = blockIdx.y * kSplitTile, c0 = blockIdx.x * kSplitTile;
  const bool c_unit = s_c == 1;
  for (int e = threadIdx.x; e < kSplitTile * kSplitTile; e += 256) {
    const int a = e / kSplitTile, z = e % kSplitTile;    // z along the unit-stride axis
    const int r = c_unit ? a : z, c = c_unit ? z : a;
    const int gr = r0 + r, gc = c0 + c;
    tile[r][c] = (gr < R && gc < Cc) ? to_float(src[gr * s_r + gc * s_c]) : 0.f;
  }
  __syncthreads();
  const size_t plane = (size_t)Rp * Cp;
  for (int e = threadIdx.x; e < kSplitTile * kSplitTile / 2; e += 256) {
    const int r = e / (kSplitTile / 2), c = 2 * (e % (kSplitTile / 2));
    __nv_bfloat16* hi = dst + (size_t)(r0 + r) * Cp + c0 + c;
    store_split(hi, hi + plane, tile[r][c], tile[r][c + 1]);
  }
  if (dst_t == nullptr) return;
  for (int e = threadIdx.x; e < kSplitTile * kSplitTile / 2; e += 256) {
    const int c = e / (kSplitTile / 2), r = 2 * (e % (kSplitTile / 2));
    __nv_bfloat16* hi = dst_t + (size_t)(c0 + c) * Rp + r0 + r;
    store_split(hi, hi + plane, tile[r][c], tile[r + 1][c]);
  }
}

// A (2, rows, cols) bf16 workspace as a 3-d map read in boxes of 64 columns
// x box_rows rows of one plane, 128-byte swizzle.
inline bool encode3(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                    int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)(rows * cols * 2)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline size_t align256(size_t x) { return (x + 255) / 256 * 256; }

template <bool LA, bool LB, int TB, typename Epi>
cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb, dim3 grid, int k_steps,
                        const Epi& epi, cudaStream_t st) {
  auto kernel = gemm3<LA, LB, TB, Epi>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGemmThreads, kGemmSmem, st>>>(ma, mb, k_steps, epi);
  return cudaGetLastError();
}

}  // namespace split_gemm

// ---------------------------------------------------------------- kernel 9
// Per chunk of kChunk columns the split pass and pass (a), whose epilogue
// writes one online state per (row, 128-column tile); then a warp per row
// merges its tiles' states and kernel 7's combine finishes.
namespace k9 {

using namespace split_gemm;

// (a) rows b, columns c of the chunk, s = (h W + b) / tau and t = z_mean / tau,
// FLASH_PAD / tau past N: one State per (row, tile) into part (B, tiles,
// kParts).  The teacher's tile, its lse and the bias are read before the
// mainloop.
template <typename TM, typename TT, bool kLse>
struct EpiState {
  const TM* bias;
  const TT* t;
  const float* lse_t;
  float* part;
  int B, V, v0, N, tiles;
  float inv_temp;

  struct Pre {
    float t[2][kBN / 8][2];   // t / tau, FLASH_PAD / tau past (B, N)
    float b[kBN / 8][2];      // the bias, 0 past N
    float lt[2];              // the teacher's lse (kLse)
  };
  __device__ __forceinline__ void load(Pre& pre, int r0, int c0) const {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        pre.b[j][e] = (bias != nullptr && c < N) ? to_float(bias[v0 + c]) : 0.f;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int b = r0 + 8 * r;
      const bool row = b < B;
      pre.lt[r] = (kLse && row) ? lse_t[b] : 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + e;
          pre.t[r][j][e] = (row && c < N) ? to_float(t[(size_t)b * V + v0 + c]) * inv_temp
                                          : kPad * inv_temp;
        }
    }
  }
  // Per row: the max over the thread's 32 values first, then their
  // exponentials, then the row's four lanes merged (xor 1, then 2).
  __device__ __forceinline__ void write(const Pre& pre, const float (&acc)[64], int r0,
                                        int c0) const {
    const float pad_s = kPad * inv_temp;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s[kBN / 8][2];
      float ms = -INFINITY, mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = c0 + 8 * j + e < N ? (acc[4 * j + 2 * r + e] + pre.b[j][e]) * inv_temp
                                       : pad_s;
          ms = fmaxf(ms, s[j][e]);
          if (!kLse) mt = fmaxf(mt, pre.t[r][j][e]);
        }
      State a = {ms, 0.f, kLse ? 0.f : mt, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[j][e], tv = pre.t[r][j][e];
          a.ls += expf(sv - ms);
          if (kLse) {
            a.x += expf(tv - pre.lt[r]) * (tv - sv);
          } else {
            const float p = expf(tv - mt);
            a.lt += p;
            a.x += p * (tv - sv);
          }
        }
      a = shfl_merge<kLse>(a, 1);
      a = shfl_merge<kLse>(a, 2);
      const int b = r0 + 8 * r;
      if ((threadIdx.x & 3) == 0 && b < B)
        write_state(part + ((size_t)b * tiles + v0 / kBN + blockIdx.y) * kParts, a);
    }
  }
};

// rows (B, kParts) = each row's tile states merged: warp w of a CTA takes
// row 8·blockIdx.x + w, lane i its tiles i, i + 32, ... in order, and the
// lanes merge in a fixed tree.
template <bool kLse>
__global__ void __launch_bounds__(256)
combine_rows(const float* __restrict__ part, float* __restrict__ rows, int B, int tiles) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= B) return;                                  // the whole warp
  const float* p = part + (size_t)row * tiles * kParts;
  State a = empty_state();
#pragma unroll 4
  for (int i = lane; i < tiles; i += 32) a = merge<kLse>(a, read_state(p + (size_t)i * kParts));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) a = shfl_merge<kLse>(a, o);
  if (lane == 0) write_state(rows + (size_t)row * kParts, a);
}

// The workspace, carved in this order (each piece 256-byte aligned): h's
// planes (2, Bp, Dp); W's chunk (2, Cn, Dp), its rows the chunk's columns;
// the tile states (B, tiles, kParts) f32; the row states (B, kParts) f32.
struct Plan {
  long long Bp, Dp, Cn;
  int C, tiles;
  size_t off_h, off_w, off_part, off_rows, bytes;
};

inline Plan plan(int B, int D, int V) {
  Plan p;
  p.C = V < kChunk ? V : kChunk;
  p.Bp = pad(B);
  p.Dp = pad(D);
  p.Cn = pad(p.C);
  p.tiles = cdiv(V, kBN);                                // kChunk is whole tiles
  size_t at = 0;
  p.off_h = at;
  at = align256(at + 2 * 2 * p.Bp * p.Dp);
  p.off_w = at;
  at = align256(at + 2 * 2 * p.Cn * p.Dp);
  p.off_part = at;
  at = align256(at + 4 * (size_t)kParts * B * p.tiles);
  p.off_rows = at;
  at = align256(at + 4 * (size_t)kParts * B);
  p.bytes = at;
  return p;
}

template <typename TM, typename TT, bool kLse>
int launch_head_fwd(const void* h, const void* W, long long sw_d, long long sw_v,
                    const void* bias, const void* t, const float* lse_t_in, float* lse_s,
                    float* lse_t, float* loss, void* ws, int B, int D, int V, float inv_temp,
                    float loss_scale, cudaStream_t st) {
  constexpr bool kLo = std::is_same<TM, float>::value;  // a bf16 head has no lo half
  const Plan p = plan(B, D, V);
  unsigned char* base = static_cast<unsigned char*>(ws);
  auto* hs = reinterpret_cast<__nv_bfloat16*>(base + p.off_h);
  auto* wsp = reinterpret_cast<__nv_bfloat16*>(base + p.off_w);
  auto* part = reinterpret_cast<float*>(base + p.off_part);
  auto* rows = reinterpret_cast<float*>(base + p.off_rows);
  if (const cudaError_t err = bind_context()) return (int)err;
  CUtensorMap m_h, m_w;
  if (!encode3(&m_h, hs, p.Bp, p.Dp, kBM) || !encode3(&m_w, wsp, p.Cn, p.Dp, kBN))
    return (int)cudaErrorInvalidValue;
  const TM* hp = static_cast<const TM*>(h);
  const TM* wp = static_cast<const TM*>(W);
  split_planes<TM><<<dim3(p.Dp / kSplitTile, p.Bp / kSplitTile), 256, 0, st>>>(
      hp, D, 1, B, D, hs, nullptr, (int)p.Bp, (int)p.Dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int v0 = 0; v0 < V; v0 += p.C) {
    const int N = std::min(p.C, V - v0);
    // (0) W[:, v0 : v0 + N] as the rows of the chunk, up to the last tile pass (a) reads
    split_planes<TM><<<dim3(p.Dp / kSplitTile, pad(N) / kSplitTile), 256, 0, st>>>(
        wp + v0 * sw_v, sw_v, sw_d, N, D, wsp, nullptr, (int)p.Cn, (int)p.Dp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // (a) S = h W_chunk (M = Bp, N's tiles, K = Dp) into the tile states
    const EpiState<TM, TT, kLse> epi{static_cast<const TM*>(bias), static_cast<const TT*>(t),
                                     lse_t_in, part, B, V, v0, N, p.tiles, inv_temp};
    err = launch_gemm<kLo, kLo, 0>(m_h, m_w, dim3(p.Bp / kBM, cdiv(N, kBN), 1),
                                   (int)(p.Dp / kBK), epi, st);
    if (err != cudaSuccess) return (int)err;
  }
  combine_rows<kLse><<<cdiv(B, 8), 256, 0, st>>>(part, rows, B, p.tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_combine<kLse><<<1, kCombineThreads, 0, st>>>(rows, lse_t_in, lse_s, lse_t, loss, B, 1,
                                                     loss_scale);
  return (int)cudaGetLastError();
}

}  // namespace k9

// --------------------------------------------------------------- kernel 10
// Three GEMM passes per chunk of kChunk columns, then dh's reduction and db.
namespace k10 {

using namespace split_gemm;

constexpr int kMaxKSplits = 8;           // pass (c): partial sums per output tile at most

// (a) rows b, columns c of the chunk: d = g tau/B (e^{s/tau - lse_s} -
// e^{t/tau - lse_t}) with s = h W + b; 0 past (B, N), as FLASH_PAD lanes
// give; split into the d workspace (2, Bp, Cn).  The teacher's term, the
// bias and the row constants are read before the mainloop.
template <typename TM, typename TT>
struct EpiD {
  const TM* bias;
  const TT* t;
  const float *lse_s, *lse_t, *g;
  __nv_bfloat16* ds;
  long long plane;
  int ld, B, V, v0, N;
  float inv_temp, tau_over_b;

  struct Pre {
    float p[2][kBN / 8][2];   // e^{t/tau - lse_t}, 0 past (B, N)
    float b[kBN / 8][2];      // the bias
    float ls[2], coef;
  };
  __device__ __forceinline__ void load(Pre& pre, int r0, int c0) const {
    pre.coef = *g * tau_over_b;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        pre.b[j][e] = (bias != nullptr && c < N) ? to_float(bias[v0 + c]) : 0.f;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int b = r0 + 8 * r;
      const bool row = b < B;
      pre.ls[r] = row ? lse_s[b] : 0.f;
      const float lt = row ? lse_t[b] : 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + e;
          pre.p[r][j][e] = (row && c < N)
              ? expf(to_float(t[(size_t)b * V + v0 + c]) * inv_temp - lt) : 0.f;
        }
    }
  }
  __device__ __forceinline__ void write(const Pre& pre, const float (&acc)[64], int r0,
                                        int c0) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int b = r0 + 8 * r;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = c0 + 8 * j;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float q = expf((acc[4 * j + 2 * r + e] + pre.b[j][e]) * inv_temp - pre.ls[r]);
          d[e] = (b < B && c + e < N) ? (q - pre.p[r][j][e]) * pre.coef : 0.f;
        }
        __nv_bfloat16* hi = ds + (size_t)b * ld + c;
        store_split(hi, hi + plane, d[0], d[1]);
      }
    }
  }
};

// (b) rows of D, columns c of the chunk: dW, written once in W's layout and
// type.  Eight lanes hold eight consecutive rows and four lanes a column
// pair's neighbours, so a warp's f32 stores fill whole 32-byte sectors in
// either layout (tied: rows unit-stride; untied: columns).
template <typename TM>
struct EpiW {
  TM* gw;
  long long sw_d, sw_v;
  int D, v0, N;
  using Pre = NoPre;
  __device__ __forceinline__ void load(Pre&, int, int) const {}
  __device__ __forceinline__ void write(const Pre&, const float (&acc)[64], int r0,
                                        int c0) const {
    for_pairs([&](int d, int c, float x0, float x1) {
      if (d >= D) return;
      TM* p = gw + d * sw_d + (v0 + c) * sw_v;
      if (c < N) store(p, x0);
      if (c + 1 < N) store(p + sw_v, x1);
    }, acc, r0, c0);
  }
};

// (c) rows b, columns of D: one k-split's partial dh, (Bp, Dp) f32 a split.
struct EpiH {
  float* part;
  long long plane;
  int ld;
  using Pre = NoPre;
  __device__ __forceinline__ void load(Pre&, int, int) const {}
  __device__ __forceinline__ void write(const Pre&, const float (&acc)[64], int r0,
                                        int c0) const {
    float* z = part + blockIdx.z * plane;
    for_pairs([&](int b, int d, float x0, float x1) {
      *reinterpret_cast<float2*>(z + (size_t)b * ld + d) = make_float2(x0, x1);
    }, acc, r0, c0);
  }
};

// dh (B, D) f32 = (first ? 0 : dh) + the k-splits' partials, in split order.
__global__ void __launch_bounds__(256)
reduce_dh(const float* __restrict__ part, float* __restrict__ gh, int B, int D, int ld,
          long long plane, int splits, int first) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)B * D) return;
  const int b = (int)(i / D), d = (int)(i % D);
  float acc = first ? 0.f : gh[i];
  for (int z = 0; z < splits; ++z) acc += part[z * plane + (size_t)b * ld + d];
  gh[i] = acc;
}

// (d) db[v0 + c] = sum_b d[b, c], rows in order, d = hi + lo.
template <typename TM>
__global__ void __launch_bounds__(256)
bias_grad(const __nv_bfloat16* __restrict__ ds, long long plane, int ld, TM* __restrict__ gb,
          int B, int v0, int N) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= N) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) {
    const size_t i = (size_t)b * ld + c;
    s += __bfloat162float(ds[i]) + __bfloat162float(ds[i + plane]);
  }
  store(gb + v0 + c, s);
}

// The workspace, carved in this order (each piece 256-byte aligned): h's
// planes (2, Bp, Dp) and hᵀ's (2, Dp, Bp); W's chunk (2, Cn, Dp), its rows
// the chunk's columns; d (2, Bp, Cn); pass (c)'s partials (ks, Bp, Dp) f32.
struct Plan {
  long long Bp, Dp, Cn;
  int C, ks;
  size_t off_h, off_ht, off_w, off_d, off_part, bytes;
};

inline Plan plan(int B, int D, int V) {
  Plan p;
  p.C = V < kChunk ? V : kChunk;
  p.Bp = pad(B);
  p.Dp = pad(D);
  p.Cn = pad(p.C);
  // pass (c) has (Bp / kBM)·(Dp / kBN) output tiles: split the chunk's
  // depth so that about one wave of 132 CTAs runs, at least 4 steps a split
  const long long tiles = (p.Bp / kBM) * (p.Dp / kBN), steps = p.Cn / kBK;
  long long ks = 132 / tiles;
  if (ks > steps / 4) ks = steps / 4;
  if (ks > kMaxKSplits) ks = kMaxKSplits;
  p.ks = ks < 1 ? 1 : (int)ks;
  while (steps % p.ks) --p.ks;                           // whole steps a split
  size_t at = 0;
  p.off_h = at;
  at = align256(at + 2 * 2 * p.Bp * p.Dp);
  p.off_ht = at;
  at = align256(at + 2 * 2 * p.Dp * p.Bp);
  p.off_w = at;
  at = align256(at + 2 * 2 * p.Cn * p.Dp);
  p.off_d = at;
  at = align256(at + 2 * 2 * p.Bp * p.Cn);
  p.off_part = at;
  at = align256(at + 4 * (size_t)p.ks * p.Bp * p.Dp);
  p.bytes = at;
  return p;
}

template <typename TM, typename TT>
int launch_head_bwd(const void* h, const void* W, long long sw_d, long long sw_v,
                    const void* bias, const void* t, const float* lse_s, const float* lse_t,
                    const float* g, float* gh, void* gw, void* gb, void* ws, int B, int D,
                    int V, float inv_temp, float tau_over_b, cudaStream_t st) {
  constexpr bool kLo = std::is_same<TM, float>::value;  // a bf16 head has no lo half
  const Plan p = plan(B, D, V);
  unsigned char* base = static_cast<unsigned char*>(ws);
  auto* hs = reinterpret_cast<__nv_bfloat16*>(base + p.off_h);
  auto* hts = reinterpret_cast<__nv_bfloat16*>(base + p.off_ht);
  auto* wsp = reinterpret_cast<__nv_bfloat16*>(base + p.off_w);
  auto* dsp = reinterpret_cast<__nv_bfloat16*>(base + p.off_d);
  auto* part = reinterpret_cast<float*>(base + p.off_part);
  if (const cudaError_t err = bind_context()) return (int)err;
  CUtensorMap m_h, m_ht, m_wk, m_wn, m_dk, m_dn;
  if (!encode3(&m_h, hs, p.Bp, p.Dp, kBM) || !encode3(&m_ht, hts, p.Dp, p.Bp, kBM) ||
      !encode3(&m_wk, wsp, p.Cn, p.Dp, kBN) || !encode3(&m_wn, wsp, p.Cn, p.Dp, kBK) ||
      !encode3(&m_dk, dsp, p.Bp, p.Cn, kBM) || !encode3(&m_dn, dsp, p.Bp, p.Cn, kBK))
    return (int)cudaErrorInvalidValue;
  const TM* hp = static_cast<const TM*>(h);
  const TM* wp = static_cast<const TM*>(W);
  split_planes<TM><<<dim3(p.Dp / kSplitTile, p.Bp / kSplitTile), 256, 0, st>>>(
      hp, D, 1, B, D, hs, hts, (int)p.Bp, (int)p.Dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long plane_d = p.Bp * p.Cn, plane_part = p.Bp * p.Dp;
  for (int v0 = 0; v0 < V; v0 += p.C) {
    const int N = std::min(p.C, V - v0);
    // (0) W[:, v0 : v0 + N] as the rows of the chunk: Ws[c][d]
    split_planes<TM><<<dim3(p.Dp / kSplitTile, p.Cn / kSplitTile), 256, 0, st>>>(
        wp + v0 * sw_v, sw_v, sw_d, N, D, wsp, nullptr, (int)p.Cn, (int)p.Dp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // (a) S = h W_chunk (M = Bp, N = Cn, K = Dp); d into the workspace
    const EpiD<TM, TT> ed{static_cast<const TM*>(bias), static_cast<const TT*>(t), lse_s, lse_t,
                          g, dsp, plane_d, (int)p.Cn, B, V, v0, N, inv_temp, tau_over_b};
    err = launch_gemm<kLo, kLo, 0>(m_h, m_wk, dim3(p.Bp / kBM, p.Cn / kBN, 1),
                                   (int)(p.Dp / kBK), ed, st);
    if (err != cudaSuccess) return (int)err;
    // (d) db
    if (gb != nullptr) {
      bias_grad<TM><<<(N + 255) / 256, 256, 0, st>>>(dsp, plane_d, (int)p.Cn,
                                                     static_cast<TM*>(gb), B, v0, N);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    // (b) dW[:, chunk] = hᵀ d (M = Dp, N = Cn, K = Bp)
    const EpiW<TM> ew{static_cast<TM*>(gw), sw_d, sw_v, D, v0, N};
    err = launch_gemm<kLo, true, 1>(m_ht, m_dn, dim3(p.Dp / kBM, p.Cn / kBN, 1),
                                    (int)(p.Bp / kBK), ew, st);
    if (err != cudaSuccess) return (int)err;
    // (c) dh += d W_chunkᵀ (M = Bp, N = Dp, K = Cn in p.ks splits), summed in order
    const EpiH eh{part, plane_part, (int)p.Dp};
    err = launch_gemm<true, kLo, 1>(m_dk, m_wn, dim3(p.Bp / kBM, p.Dp / kBN, p.ks),
                                    (int)(p.Cn / kBK / p.ks), eh, st);
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)B * D;
    reduce_dh<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, gh, B, D, (int)p.Dp,
                                                          plane_part, p.ks, v0 == 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace k10

// f(TM*, TT*), called with null pointers of the types that mdtype and tdtype
// name (0 float32, 1 bfloat16); -1 for another pair.
template <typename F>
int by_dtypes(int mdtype, int tdtype, F f) {
  if (mdtype == 0 && tdtype == 0) return f((float*)nullptr, (float*)nullptr);
  if (mdtype == 0 && tdtype == 1) return f((float*)nullptr, (__nv_bfloat16*)nullptr);
  if (mdtype == 1 && tdtype == 0) return f((__nv_bfloat16*)nullptr, (float*)nullptr);
  if (mdtype == 1 && tdtype == 1) return f((__nv_bfloat16*)nullptr, (__nv_bfloat16*)nullptr);
  return -1;
}

}  // namespace

extern "C" {

// Each launcher returns 0 on success, a cudaError_t code if a launch failed,
// -1 for a shape or type the kernels do not take.  dtype: 0 float32,
// 1 bfloat16.  g: the upstream gradient, one f32 on the device.

// Sizes the caller allocates: kernel 7's partials are (B, chunks, 5) f32;
// kernels 9 and 10 take workspaces of this many bytes.
int flash_kd_fwd_chunks(int V) { return fwd_chunks(V); }
long long flash_kd_head_fwd_workspace(int B, int D, int V) {
  return (long long)k9::plan(B, D, V).bytes;
}
long long flash_kd_head_bwd_workspace(int B, int D, int V) {
  return (long long)k10::plan(B, D, V).bytes;
}

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
// mdtype is the type of h, W and bias; lse_t_in as for kernel 7; ws:
// flash_kd_head_fwd_workspace(B, D, V) bytes, 256-byte aligned.
int flash_kd_head_fwd(const void* h, const void* W, long long sw_d, long long sw_v,
                      const void* bias, const void* t, const float* lse_t_in, float* lse_s,
                      float* lse_t, float* loss, void* ws, int B, int D, int V, float inv_temp,
                      float loss_scale, int mdtype, int tdtype, void* stream) {
  if (B < 1 || D < 1 || V < 1 || k9::pad(B) / k9::kBM > 65535 ||
      reinterpret_cast<uintptr_t>(ws) % 256)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool lse = lse_t_in != nullptr;
  return by_dtypes(mdtype, tdtype, [&](auto hw, auto tz) {
    using TM = std::remove_pointer_t<decltype(hw)>;
    using TT = std::remove_pointer_t<decltype(tz)>;
    const auto run =
        lse ? &k9::launch_head_fwd<TM, TT, true> : &k9::launch_head_fwd<TM, TT, false>;
    return run(h, W, sw_d, sw_v, bias, t, lse_t_in, lse_s, lse_t, loss, ws, B, D, V, inv_temp,
               loss_scale, st);
  });
}

// Kernel 10.  gh: (B, D) f32; gw: W's shape, strides and type; gb: (V,) in
// W's type, or null without a bias; ws: flash_kd_head_bwd_workspace(B, D, V)
// bytes, 256-byte aligned.
int flash_kd_head_bwd(const void* h, const void* W, long long sw_d, long long sw_v,
                      const void* bias, const void* t, const float* lse_s, const float* lse_t,
                      const float* g, float* gh, void* gw, void* gb, void* ws, int B, int D,
                      int V, float inv_temp, float tau_over_b, int mdtype, int tdtype,
                      void* stream) {
  if (B < 1 || D < 1 || V < 1 || k10::pad(B) / k10::kBM > 65535 ||
      k10::pad(D) / k10::kBN > 65535 || reinterpret_cast<uintptr_t>(ws) % 256)
    return -1;
  if ((bias == nullptr) != (gb == nullptr)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtypes(mdtype, tdtype, [&](auto hw, auto tz) {
    using TM = std::remove_pointer_t<decltype(hw)>;
    using TT = std::remove_pointer_t<decltype(tz)>;
    return k10::launch_head_bwd<TM, TT>(h, W, sw_d, sw_v, bias, t, lse_s, lse_t, g, gh, gw, gb, ws,
                                        B, D, V, inv_temp, tau_over_b, st);
  });
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
