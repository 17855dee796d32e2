// Streaming weighted model average, paper Eq. 2, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of repro/kernels/weight_avg/kernel.py:
//
//   multi_weighted_average  (kernel.py:53, body :47)  x (G,N,D), w (G,N) -> (G,D)
//   weighted_average        (kernel.py:29, body :23)  x (N,D),   w (N,)  -> (D,), the G = 1 case
//
// out[g, d] = sum_n w_hat[g, n] * x[g, n, d] with w_hat = w / sum_n w per group:
// the weights normalised and the products summed in f32, the result cast
// once to x's type (f32 or bf16).
//
// Same function, not the same launch structure.  The reference maps one
// pallas_call over each leaf of the client-stacked tree and walks (G, D / Db)
// in order with a whole (N, Db) column tile in VMEM.  Here ONE launch takes a
// table of leaves (tree_average): each leaf's x pointer, its output's offset
// in 16-byte units from the call's one output allocation, its D and its first
// tile, 20 bytes a leaf, passed by value as a __grid_constant__ struct, so no
// device buffer outlives the call and nothing is copied to the card first.
// The table holds up to kMaxLeaves leaves, 20 KB of the 32,764 bytes that
// CUDA >= 12.1 allows; on the card a launch with this table took the host
// the time of one with a 4 KB table, within its clock's spread (PERF.md).
// The plan (leaf order, 16-byte aligned output slices, one launch per dtype
// and per kMaxLeaves leaves) is wa_tree_plan in kernels/weight_avg/ops.py.
// A single (G, N, D) or (N, D) tensor is the table's one-leaf case.
//
// The grid is flat over every leaf's column tiles, in any order.  A CTA
// finds its leaf by binary search over the table's tile prefix, copies the
// G*N weights into shared memory and normalises each group's in a fixed
// order (the same w_hat in every CTA), then each thread takes 16 bytes of
// columns (4 f32 or 8 bf16) and walks the G*N rows in (g, n) order, kUnroll
// rows' 16-byte loads in flight at once, accumulating fmaf(w_hat[g, n], x,
// acc) in n order and writing each group's 16 bytes once.  A leaf whose
// pointers or D are not 16-byte multiples takes the same number of columns
// as scalars kThreads apart (a warp's loads stay contiguous), group by
// group, summed in the same order, so both paths give the same bits.
// Nothing is padded; the ragged edge is masked.
//
// Bound on this card: HBM bytes at 3.35 TB/s (H100 SXM): G*N*D reads and G*D
// writes, no (G,N,D) temporary.  The FedSDD round's Eq. 2 over ResNet-56 (169
// leaves, 855,578 parameters, G = K = 4 groups of N = 2 clients, f32) moves
// 41 MB, 0.0123 ms: one launch of about a thousand 256-thread CTAs, where a
// launch per leaf left the card waiting on the host.
//
// The caller checks shapes, types and contiguity; every launch runs on the
// given stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = 12000;       // G*N f32 weights within 48 KB
constexpr int kMaxLeaves = 1024;   // leaves a launch (ops.py: WA_MAX_LEAVES)
constexpr int kUnroll = 4;         // rows whose loads are in flight together

// Up to kMaxLeaves leaves; tile0[n] is the grid.
struct Table {
  const void* x[kMaxLeaves];     // leaf l's (G, N, D) stack
  unsigned out16[kMaxLeaves];    // its (G, D) result: 16 * out16[l] bytes into the output
  unsigned D[kMaxLeaves];
  int tile0[kMaxLeaves + 1];     // leaf l's first tile
  int n;
};
constexpr int kArgBytes = 24;    // the kernel's other arguments
static_assert(sizeof(Table) + kArgBytes <= 32764, "the table fits the parameter block");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes as W floats, and back.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& q, float (&v)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(q.x), v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z), v[3] = __uint_as_float(q.w);
  } else {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  } else {
    return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                      pack_bf16x2(v[6], v[7]));
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tree_average(const __grid_constant__ Table tab, char* __restrict__ out_base,
             const float* __restrict__ w, int G, int N) {
  constexpr int W = 16 / sizeof(T);   // columns a thread: 16 bytes
  extern __shared__ float w_hat[];    // (G, N), normalised per group
  const int GN = G * N;
  for (int i = threadIdx.x; i < GN; i += kThreads) w_hat[i] = w[i];
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {  // a fixed order: every CTA, the same w_hat
    float* wg = w_hat + g * N;
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += wg[n];
    for (int n = 0; n < N; ++n) wg[n] = wg[n] / s;
  }
  __syncthreads();

  // the leaf: the last whose first tile is at most this one
  const int tile = blockIdx.x;
  int lo = 0, hi = tab.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.tile0[mid] <= tile) lo = mid;
    else hi = mid - 1;
  }
  const long long D = tab.D[lo];
  const T* x = static_cast<const T*>(tab.x[lo]);
  T* out = reinterpret_cast<T*>(out_base + 16 * (size_t)tab.out16[lo]);
  const long long c0 = (long long)(tile - tab.tile0[lo]) * (kThreads * W);

  if (D % W == 0 && aligned16(x) && aligned16(out)) {
    const long long d = c0 + (long long)threadIdx.x * W;
    if (d >= D) return;
    float acc[W];
    int g = 0, n = 0;
    for (int r0 = 0; r0 < GN; r0 += kUnroll) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r0 + u < GN) q[u] = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + u) * D + d);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u >= GN) break;
        float v[W];
        unpack<T>(q[u], v);
        const float wn = w_hat[r0 + u];
#pragma unroll
        for (int k = 0; k < W; ++k) acc[k] = fmaf(wn, v[k], n == 0 ? 0.f : acc[k]);
        if (++n == N) {
          *reinterpret_cast<uint4*>(out + (size_t)g * D + d) = pack<T>(acc);
          n = 0, ++g;
        }
      }
    }
  } else {
    // scalar: the tile's W columns a thread, kThreads apart, a group at a time
    const long long d0 = c0 + threadIdx.x;
    for (int g = 0; g < G; ++g) {
      const T* xg = x + (size_t)g * N * D;
      float acc[W];
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float wn = w_hat[g * N + n];
        const T* row = xg + (size_t)n * D;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const long long d = d0 + (long long)k * kThreads;
          if (d < D) acc[k] = fmaf(wn, to_float(row[d]), acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const long long d = d0 + (long long)k * kThreads;
        if (d < D) store(out + (size_t)g * D + d, acc[k]);
      }
    }
  }
}

constexpr long long cols(int dtype) { return (long long)kThreads * (dtype == 0 ? 4 : 8); }

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch failed, -1 for a
// shape, type or table the kernel does not take.  dtype: 0 float32, 1
// bfloat16; w (G, N) f32.
//
// One launch over n_leaves leaves of one dtype (wa_tree_plan's launches):
// leaf l's (G, N, D[l]) stack at x[l] (a device address), its (G, D[l])
// result 16 * out16[l] bytes into `out`, its first tile tile0[l];
// tile0[n_leaves] is the grid and each leaf has ceil(D / columns a tile)
// tiles, 1024 columns in f32 and 2048 in bf16.
int multi_weighted_average_tree(const long long* x, const unsigned* out16, const unsigned* D,
                                const int* tile0, int n_leaves, void* out, const void* w,
                                int G, int N, int dtype, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || G < 1 || N < 1 || (long long)G * N > kMaxW ||
      (dtype != 0 && dtype != 1) || tile0[0] != 0 || out == nullptr)
    return -1;
  static thread_local Table tab;   // a host buffer; the launch copies it by value
  for (int l = 0; l < n_leaves; ++l) {
    if (D[l] < 1 || x[l] == 0 ||
        (long long)tile0[l + 1] - tile0[l] != ((long long)D[l] + cols(dtype) - 1) / cols(dtype))
      return -1;
    tab.x[l] = reinterpret_cast<const void*>(x[l]);
    tab.out16[l] = out16[l];
    tab.D[l] = D[l];
    tab.tile0[l] = tile0[l];
  }
  tab.tile0[n_leaves] = tile0[n_leaves];
  tab.n = n_leaves;
  const unsigned grid = (unsigned)tile0[n_leaves];
  const size_t smem = (size_t)G * N * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* o = static_cast<char*>(out);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0)
    tree_average<float><<<grid, kThreads, smem, s>>>(tab, o, wf, G, N);
  else
    tree_average<__nv_bfloat16><<<grid, kThreads, smem, s>>>(tab, o, wf, G, N);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
