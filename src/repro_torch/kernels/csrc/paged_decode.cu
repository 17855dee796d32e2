// Paged GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:226
// (`paged_flash_decode`, body `_paged_decode_kernel` at :182-222): one
// query token per request attends its KV cache through a block table into
// ONE pool shared by every request.  Same function, not the same block
// structure.
//
// The device code is the split-K body of decode_splitk.cuh, which kernel 11
// (flash_attention.cu) shares; this file gives it the block-table
// addressing (`splitk::PagedRows`) and the C entry point.  The design, its
// bound (bytes) and its merge are described there.  Kernel 1's own rules:
// the host picks `chunk` as a whole number of pool blocks, aiming at a few
// CTAs per SM, from shapes alone (reading seq_lens, a device tensor, would
// sync the host inside a decode step); with a window the chunks split the
// window's positions relative to each row's own lo, so a windowed row
// idles no CTA.
//
// Semantics of the TPU kernel: the output is acc / max(l, 1e-30), so a
// seq_len == 0 row is zeros.  The TPU kernel also visits blocks that lie
// wholly before the window (their NEG_INF scores give p = 1 until a real
// score resets the running sum); those positions are never visited here,
// which changes no output.
//
// Types: float32 and bfloat16 (q, pools, out of one type); dh in
// {32, 64, 80, 128, 256}; any G <= 16.

#include "decode_splitk.cuh"

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
  if (bs < 1 || nbmax < 1 || chunk < 1 || chunk % bs) return -1;
  const splitk::PagedRows addr{static_cast<const int*>(block_tables),
                               static_cast<const int*>(seq_lens), Hkv, bs, nbmax, window};
  return splitk::run(dtype, dh, gb, q, k_pool, v_pool, addr, out, part, counters, B, Hkv, G,
                     chunk, splits, [](int d) { return 1.0f / sqrtf((float)d); },
                     static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
