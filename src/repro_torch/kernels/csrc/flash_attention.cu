// Flash attention forward and split-K flash decode for Hopper (sm_90a),
// plain C interface.
//
// flash_forward replaces the TPU kernel
// repro/kernels/flash_attention/kernel.py:87 (`flash_forward`, body
// `_flash_fwd_kernel` at :39-84): causal / sliding-window attention of
// q (B, Sq, H, dh) over k, v (B, Skv, Hkv, dh), GQA with G = H / Hkv.
//
//   * Only the KV tiles in the causal / window band are visited.  The
//     band is the Pallas grid's own `block_needed` rule on its 128-key
//     blocks (the Pallas grid visits every block and skips the FLOPs), so a
//     row whose allowed keys all lie outside the visited blocks gets the
//     Pallas result too.
//   * Masked scores are NEG_INF = -1e30 as in Pallas (a visited row with
//     every key masked so far gets p = 1 until a real score resets it);
//     keys past Skv in a ragged tile are -inf and never count.
//   * K and V of KV head h / G are read straight from (B, S, Hkv, dh) by
//     their layout's strides: no copy G times (the reference's `_to_bh`).
//
// Bound on this card: operations, 4·dh per visited (query, key) pair and
// head, against 67 TFLOP/s for f32 on the CUDA cores or 989 TFLOP/s for
// bf16 on the tensor cores; the bytes, each of q, k, v read once and the
// output written once, are far below it.  The two dtypes take two kernels:
//
//   * f32 (`flash_fwd_kernel`): f32 FMAs on the CUDA cores, as the Pallas
//     kernel computes (q scaled after the cast).  One CTA per (64-row
//     query tile, b·H + h), 256 threads as 16 x 16; a loop inside the CTA
//     walks the KV tiles of 64 keys, replacing the Pallas grid's sequential
//     third axis; the online (m, l, acc) stays in registers.  16-byte
//     transposed Q and K tiles give 2 shared loads per 16 FMAs in Q·Kᵀ;
//     the loads of a tile are not overlapped with the math of the last.
//   * bf16 (`wg::flash_fwd_wgmma`): the tensor cores through `wgmma`
//     (m64n64k16 for Q·Kᵀ, m64n(dh)k16 for P·V) with f32 accumulators.
//     One CTA per (128-row query tile,
//     b·H + h), the heaviest causal tiles first: one producer warp keeps K
//     and V tiles of 64 keys in flight through a ring of 2-4 shared-memory
//     stages with TMA (4-d tensor maps over the (B, S, heads, dh) layout,
//     128-byte swizzle) and mbarriers, and two consumer warpgroups own 64
//     query rows each.  S = Q·Kᵀ takes the unscaled bf16 q, whose
//     products are exact in f32, and multiplies the f32 scores by dh^-0.5
//     after (folded with log2(e) into one multiply, for base-2
//     exponentials): within 0.005 bf16 ulp of the Pallas kernel's "scale,
//     then dot".  P·V runs as P_hi·V + P_lo·V with P_hi = bf16(p) and
//     P_lo = bf16(p - P_hi), so p keeps about 16 bits (within 0.004 ulp;
//     one rounding of p would cost up to 0.91 ulp, against a check of one
//     ulp of each row's max); that doubles P·V, so the kernel does 1.5
//     times the operations the bound counts and can reach at most 2/3 of
//     it.  P·V covers all dh columns in one instruction per 16 keys; the
//     two warpgroups run their tiles side by side on the tensor cores, so
//     one's softmax can overlap the other's products.  dh 32 and 80 run
//     padded to 64 and 128 in shared
//     memory (TMA fills zeros); dh 256 runs one consumer warpgroup of 64
//     rows, since a thread of two would not hold 128 accumulators in the
//     registers left to it.  The output is rounded once.
//     What a later version changes: persistent CTAs, so that one tile's
//     epilogue overlaps the next one's loads; a producer warpgroup whose
//     registers `setmaxnreg` gives to the consumers, for key tiles of 128
//     and Q·Kᵀ of the next tile issued under this tile's softmax (at the
//     168 registers two warpgroups leave a thread, that overlap and a
//     ping-pong of the warpgroups each measured slower on an H100).
//
// flash_decode replaces kernel.py:151 (`flash_decode`, body
// `_flash_decode_kernel` at :120-148): one query token (G rows per KV
// head) attends a contiguous cache (B, S, Hkv, dh) of which the first
// `cache_len` positions are valid.  It runs kernel 1's split-K body
// (decode_splitk.cuh: double-buffered `cp.async` tiles of 32 positions, a
// quarter of dh per lane, rows without branches, the last-arriving CTA's
// in-order merge, one launch) with the contiguous addressing
// `splitk::ContiguousRows`: position t of (b, h) at ((b·S + t)·Hkv + h)·dh.
// What kernel 11 keeps of the Pallas kernel: q cast to f32, then scaled by
// dh^-0.5 (rounded from double, as the plain version's `dh ** -0.5`);
// positions at or past cache_len are skipped (Pallas scores them NEG_INF,
// which weighs 0 beside a real score); cache_len <= 0 leaves no valid
// position, so every score is NEG_INF and the result is the mean of V over
// all S (an explicit branch of the addressing, not of the merge).  Bound on
// this card: bytes, 2·B·S_valid·Hkv·dh·sizeof(dtype) of K and V at
// 3.35 TB/s; the host's split (whole 32-position tiles, from shapes and
// the host int cache_len alone) aims at four CTAs per SM.
//
// Types: float32 and bfloat16 (all inputs and the output of one type); dh
// in {32, 64, 80, 128, 256} as a template parameter; G <= 16 for decode.
// The caller checks shapes, types, alignment (16 bytes) and contiguity;
// the launches run on the given stream, allocate nothing (the decode
// partials and arrival counters are the caller's) and do not synchronise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "decode_splitk.cuh"
#include "hopper_tma.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the Pallas kernels' mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16(v); }

// Four consecutive f32 elements (the f32 forward's loads).
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
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

// ------------------------------------------------------- forward, bf16
// The tensor-core path: TMA loads into 128-byte-swizzled shared memory,
// `wgmma` m64n64k16 with f32 accumulators.  A CTA is one producer warp and
// KC consumer warpgroups of 64 query rows each (two, or one at dh 256).
namespace wg {

constexpr int kBN = 64;                // keys per tile
constexpr int kPanel = 64;             // bf16 elements in one 128-byte swizzled row
constexpr int kPanelRows = 128;        // bytes per panel row

using namespace hopper;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// D (64 x 64, f32) = A·B (+ D if accumulate): A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A·B: A (bf16) from registers, B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128 or 64 x 256, f32) += A·B: the same, with B spanning two or
// four 64-column panels LBO apart.
__device__ __forceinline__ void mma_rs128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
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
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q·Kᵀ of one tile from the unscaled bf16 inputs, f32 accumulators:
// qw the warpgroup's 64 query rows, kt the tile's keys, both K-major.
template <int DHP, int KC>
__device__ __forceinline__ void issue_qk(float (&sc)[32], const unsigned char* qw,
                                         const unsigned char* kt) {
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const int p = kk / 4, off = (kk % 4) * 32;
    mma_ss(sc, desc(qw + p * 64 * KC * kPanelRows + off, 16, 1024),
           desc(kt + p * kBN * kPanelRows + off, 16, 1024), kk > 0);
  }
}

// O += P_hi·V + P_lo·V of one tile; V MN-major, 16 keys (two 8-row groups)
// a step, one instruction over all DHP columns (the 64-column panels LBO
// apart).
template <int DHP>
__device__ __forceinline__ void issue_pv(float (&o)[DHP / 2], const uint32_t (&ph)[16],
                                         const uint32_t (&pl)[16], const unsigned char* vt) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t dv = desc(vt + kk * 16 * kPanelRows, kBN * kPanelRows, 1024);
    if constexpr (DHP == 64) {
      mma_rs(o, ph + 4 * kk, dv);
      mma_rs(o, pl + 4 * kk, dv);
    } else if constexpr (DHP == 128) {
      mma_rs128(o, ph + 4 * kk, dv);
      mma_rs128(o, pl + 4 * kk, dv);
    } else {
      mma_rs256(o, ph + 4 * kk, dv);
      mma_rs256(o, pl + 4 * kk, dv);
    }
  }
}

// The exponentials of one tile's softmax, in base 2: scores times
// dh^-0.5·log2(e) after the product, masked as the Pallas kernel masks
// (NEG_INF in the band's visited blocks, -inf past Skv); the running (m,
// l) in base-2 units; sc becomes p and corr the rescale of O.  The thread
// holds rows r0 and r0 + 8 and, per 8 keys, the pair cpair, cpair + 1.
__device__ __forceinline__ void softmax_exp(float (&sc)[32], float (&m)[2], float (&l)[2],
                                            float (&corr)[2], int k0, int r0, int cpair,
                                            int row_min, int row_max, int Skv, int causal,
                                            int window, float scale_log2) {
  const bool whole = k0 + kBN <= Skv && (!causal || k0 + kBN - 1 <= row_min) &&
                     (window <= 0 || row_max - k0 < window);
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = sc[i] * scale_log2;
    if (!whole) {
      const int qpos = r0 + ((i & 2) ? 8 : 0);
      const int kpos = k0 + 8 * (i >> 2) + cpair + (i & 1);
      if (kpos >= Skv)
        x = -CUDART_INF_F;
      else if ((causal && qpos < kpos) || (window > 0 && qpos - kpos >= window))
        x = kNegInf;
    }
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += sc[i];
  }
}

// O *= corr (its last P·V has completed), and P = sc split into the bf16
// A fragments P_hi = bf16(p), P_lo = bf16(p - P_hi).
template <int DHP>
__device__ __forceinline__ void rescale_split(float (&o)[DHP / 2], const float (&sc)[32],
                                              uint32_t (&ph)[16], uint32_t (&pl)[16],
                                              const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[i], sc[i + 1]);
    const float2 hf = __bfloat1622float2(hi);
    ph[i >> 1] = *reinterpret_cast<const uint32_t*>(&hi);
    pl[i >> 1] = pack_bf16(sc[i] - hf.x, sc[i + 1] - hf.y);
  }
}

// DHP: dh padded to whole 64-element panels (TMA fills the padding with
// zeros, which add nothing to Q·Kᵀ and give output columns that are not
// stored); NS: K/V pipeline stages; KC: consumer warpgroups, each owning 64
// query rows of the CTA.
template <int DHP, int NS, int KC>
__global__ void __launch_bounds__(128 * KC + 32, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmq,   // q (B, Sq, H, dh)
                const __grid_constant__ CUtensorMap tmk,   // k (B, Skv, Hkv, dh)
                const __grid_constant__ CUtensorMap tmv,   // v (B, Skv, Hkv, dh)
                __nv_bfloat16* __restrict__ out,           // (B, Sq, H, dh)
                int Sq, int Skv, int H, int Hkv, int dh, int causal, int window,
                int qb_p, int kb_p, float scale) {
  constexpr int kPanels = DHP / kPanel;
  constexpr int kBM = 64 * KC;                            // query rows per CTA
  constexpr int kQBytes = kPanels * kBM * kPanelRows;     // Q: [panel][kBM rows][128 B]
  constexpr int kKVBytes = kPanels * kBN * kPanelRows;    // K or V tile: [panel][64 keys][128 B]
  constexpr int kConsumerWarps = 4 * KC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* Qs = smem_raw + pad;                     // 1024-byte aligned (swizzle atoms)
  unsigned char* Ks = Qs + kQBytes;
  unsigned char* Vs = Ks + NS * kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + NS * kKVBytes);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int iq = gridDim.x - 1 - blockIdx.x;              // the longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = iq * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the Pallas blocks that the Pallas query block holding these rows
  // computes (kernel.py:54-60)
  const int iqp = q0 / qb_p;
  int lo_p = 0, hi_p = Skv / kb_p - 1;
  if (causal) hi_p = min(hi_p, (iqp * qb_p + qb_p - 1) / kb_p);
  if (window > 0) {
    const int t = iqp * qb_p - window + 1;
    if (t > 0) lo_p = t / kb_p;
  }
  const int k_lo = lo_p * kb_p, k_hi = min(Skv, (hi_p + 1) * kb_p);
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + kBN - 1) / kBN : 0;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {                           // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, kQBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_load(Qs + p * kBM * kPanelRows, &tmq, p * kPanel, h, q0, b, qbar);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % NS;
        mbar_wait(empty + s, ((it / NS) & 1) ^ 1);        // a fresh barrier passes parity 1
        mbar_expect_tx(full + s, 2 * kKVBytes);
        const int k0 = k_lo + it * kBN;
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load(Ks + s * kKVBytes + p * kBN * kPanelRows, &tmk, p * kPanel, hk, k0, b, full + s);
          tma_load(Vs + s * kKVBytes + p * kBN * kPanelRows, &tmv, p * kPanel, hk, k0, b, full + s);
        }
      }
      // stay until the consumers have released every stage in flight
      for (int it = max(0, ntiles - NS); it < ntiles; ++it)
        mbar_wait(empty + it % NS, (it / NS) & 1);
    }
    return;
  }

  // consumers: warpgroup wgi owns query rows q0 + 64·wgi .. +63; a thread
  // holds rows r0 and r0 + 8 and, per 8 columns, the pair 2·(lane % 4)
  const int wgi = warp >> 2;
  const int r0 = q0 + wgi * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cpair = 2 * (lane & 3);
  const int row_min = q0 + wgi * 64, row_max = row_min + 63;
  const unsigned char* qw = Qs + wgi * 64 * kPanelRows;
  float o[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float sc[32];
  uint32_t ph[16], pl[16];                                // P = hi + lo, bf16 A fragments

  // Per tile: P·V of this tile, then Q·Kᵀ of the next and its softmax.
  // The two warpgroups run this loop side by side and share the tensor
  // cores, so one's softmax can overlap the other's products.
  const float scale_log2 = scale * 1.4426950408889634f;
  float corr[2];
  mbar_wait(qbar, 0);
  if (ntiles > 0) {
    mbar_wait(full, 0);
    fence_regs(sc);
    wg_fence();
    issue_qk<DHP, KC>(sc, qw, Ks);
    wg_commit();
    wg_wait0();
    fence_regs(sc);
    softmax_exp(sc, m, l, corr, k_lo, r0, cpair, row_min, row_max, Skv, causal, window,
                scale_log2);
    rescale_split<DHP>(o, sc, ph, pl, corr);
    for (int it = 0; it < ntiles; ++it) {
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      wg_fence();
      issue_pv<DHP>(o, ph, pl, Vs + (it % NS) * kKVBytes);
      wg_commit();
      wg_wait0();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty + it % NS);        // this warp is done with the stage
      if (it + 1 < ntiles) {
        mbar_wait(full + (it + 1) % NS, ((it + 1) / NS) & 1);
        fence_regs(sc);
        wg_fence();
        issue_qk<DHP, KC>(sc, qw, Ks + ((it + 1) % NS) * kKVBytes);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        softmax_exp(sc, m, l, corr, k_lo + (it + 1) * kBN, r0, cpair, row_min, row_max, Skv,
                    causal, window, scale_log2);
        rescale_split<DHP>(o, sc, ph, pl, corr);
      }
    }
  }

  // out = O / max(l, 1e-30), rounded once; rows past Sq and columns past
  // dh are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * dh;
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanel + 8 * j + cpair;
        if (col < dh)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              o[32 * p + 4 * j + 2 * r] * l[r], o[32 * p + 4 * j + 2 * r + 1] * l[r]);
      }
  }
}

// A (B, S, heads, dh) bf16 tensor as a 4-d map (dh, heads, S, B) read in
// boxes of 64 elements of dh x `rows` positions of one head.
inline bool encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int dh,
                   int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DHP, int NS, int KC>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int Hkv, int dh, int causal, int window, int qb_p, int kb_p,
           cudaStream_t stream) {
  constexpr int kBM = 64 * KC;
  if (const cudaError_t err = bind_context()) return (int)err;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, Sq, H, dh, kBM) || !encode(&tk, k, B, Skv, Hkv, dh, kBN) ||
      !encode(&tv, v, B, Skv, Hkv, dh, kBN))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = 1024 + (size_t)DHP / kPanel * kPanelRows * (kBM + 2 * NS * kBN) +
                          (2 * NS + 1) * sizeof(uint64_t);
  auto kernel = flash_fwd_wgmma<DHP, NS, KC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBM - 1) / kBM, B * H);
  kernel<<<grid, 128 * KC + 32, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
                                                 Sq, Skv, H, Hkv, dh, causal, window, qb_p,
                                                 kb_p, (float)(1.0 / sqrt((double)dh)));
  return (int)cudaGetLastError();
}

// dh 32 and 80 run padded to 64 and 128; dh 256 with one consumer
// warpgroup, whose 128 f32 accumulators a thread would not fit in the
// registers two warpgroups leave it.
int forward(int dh, const void* q, const void* k, const void* v, void* out, int B, int Sq,
            int Skv, int H, int Hkv, int causal, int window, int qb, int kb, cudaStream_t s) {
  switch (dh) {
    case 32:
    case 64:
      return launch<64, 4, 2>(q, k, v, out, B, Sq, Skv, H, Hkv, dh, causal, window, qb, kb, s);
    case 80:
    case 128:
      return launch<128, 3, 2>(q, k, v, out, B, Sq, Skv, H, Hkv, dh, causal, window, qb, kb, s);
    case 256:
      return launch<256, 2, 1>(q, k, v, out, B, Sq, Skv, H, Hkv, dh, causal, window, qb, kb, s);
    default: return -1;
  }
}

}  // namespace wg

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
  if (dtype == 1) return wg::forward(dh, q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, qb, kb, s);
  return -1;
}

// q (B, 1, Hkv·G, dh), caches (B, S, Hkv, dh), out like q; the first
// cache_len positions are valid (cache_len <= 0: none, and the output is the
// mean of V over all S).  gb: query rows per CTA (1, 2, 4, 8, 12 or 16; at
// most 8 for dh 256; 5 too), ng = ceil(G / gb) CTAs per (request, KV head) and
// split; chunk: positions per split, a multiple of 32; splits: CTAs per
// row, at most 128.  With splits > 1, part holds B·Hkv·ng·splits·gb·(dh + 2)
// floats and counters B·Hkv·ng zeros, which the merging CTAs leave zero.
int flash_decode(const void* q, const void* k, const void* v, void* out, void* part,
                 void* counters, int cache_len, int B, int S, int Hkv, int G, int dh, int gb,
                 int chunk, int splits, int dtype, void* stream) {
  if (S < 1 || chunk % splitk::kTile) return -1;
  const splitk::ContiguousRows addr{S, Hkv, cache_len};
  return splitk::run(dtype, dh, gb, q, k, v, addr, out, part, counters, B, Hkv, G, chunk,
                     splits, inv_sqrt, static_cast<cudaStream_t>(stream));
}

// CTAs of kernel 11's (dtype, dh, gb) instance that one SM holds at once;
// -1 for an instance that is not built, below -1 for a failed query.
int flash_decode_resident(int dtype, int dh, int gb) {
  return splitk::resident_ctas<splitk::ContiguousRows>(dtype, dh, gb);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
