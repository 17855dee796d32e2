#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
repository's ``src/`` beside this file; imports nothing of JAX or of the
JAX package.  Phases, each of which fails the run if it fails:

  1. card      name and power limit (nvidia-smi); TF32 off for matmul/cuDNN
  2. build     every kernel under src/repro_torch/kernels/csrc, one nvcc each,
               all started together; the HGMMA count of each bf16 instance
               of kernel 12 and of each GEMM instance of kernel 10 in the
               built SASS (cuobjdump -sass from nvcc's toolkit): none, or no
               cuobjdump, fails the run
  3. kernel    paged_decode against its plain version at the Qwen2.5-14B
               shapes (B=8, Hkv=8, G=5, dh=128, bs=16; ragged lens with 0, 1,
               bs, bs+1 and 2048; a windowed case), Gemma's (Hkv=1, G=8,
               dh=256), StableLM-3B's (Hkv=32, G=1, dh=80) and
               StarCoder2-3B's (Hkv=2, G=12, dh=128, lens 0 to 20,512 on
               both sides of its window, with window 4,096 and without),
               f32 and bf16, with CUDA-event timings; then the edges of its
               split-K at starcoder2-3b's and qwen2.5-14b's shapes: seq_len
               0, 1, 16k +- 1, live ranges ending on a split boundary, lo
               inside a block, first blocks wholly before the window, and
               tables far longer than every row (empty splits)
  4. f32/2     qwen2.5-14b at full width, 2 layers, f32: ContinuousEngine and
               generate_static give identical greedy tokens
  5. bf16/48   qwen2.5-14b as configured (48 layers, bf16, random weights
               made on the card): ContinuousEngine serves 16 requests; checks
               token counts, the drained pool, 48 kernel launches per decode
               micro-step, and one decode step's logits kernel vs plain;
               then one chunk with every lane busy under torch.profiler:
               wall and device ms per micro-step, idle share, kernel times,
               kernel 1's share of the device time and the kernel launches
               per micro-step beside the 3,429 of kernel 1's one-CTA-per-
               head design
  6. KD       ensemble_softmax, kd_loss_fwd and kd_loss_bwd against their
               plain versions, f32 and bf16: at the FedSDD round's own shapes
               (M = K·R = 8 teachers over 8 server batches of 256, V = 10),
               at the reference's sweep, and at V = 152,064 (Qwen2.5's
               vocabulary) with M = 4, B = 256; CUDA-event timings beside
               the HBM bound and a library composition
  7. f32 round ResNet-20 (classification_task, 8 clients), fedsdd K=4 R=2,
               2 rounds, twice from the same weights made on the card: with
               the kernels and with the three wrappers patched to their plain
               versions; cuDNN deterministic.  Main model within 2e-4, models
               k>0 bit-identical (KD never touches them)
  8. ResNet-56 the paper's model at full depth and width: fedsdd K=4 R=2 over
               20 clients (participation 0.4, CIFAR-10's 50,000 training
               images as the data scale), local_epochs=1, distill_steps=200,
               2 rounds through make_runner(...).run; checks the history, 8
               teachers, the kernels' launch counts (2 / 400 / 400) and that
               models k>0 differ from the main one; then 10 client steps and 10
               KD steps under torch.profiler
  9. weight_avg multi_weighted_average (kernel 5) against its plain version
               at G = 4, N = 2 for every ResNet-56 leaf and the leaves
               flattened to D = 855,578, the reference sweep (3, 5, 517) and
               (4, 8, 16,777,219); weighted_average (kernel 6) at N = 32,
               D = 16,777,219; f32 and bf16, CUDA-event timings beside the
               HBM bound and torch.einsum as the library yardstick
 10. vec CNN   classification_task(model="cnn"), 8 clients, fedsdd K=4 R=2,
               2 rounds on the vectorized and the sequential engine from the
               same weights made on the card, cuDNN deterministic: all K
               models within 2e-4; kernel 5 launched leaves x rounds times
 11. vec R-56  phase 8's configuration with execution="vectorized": per round
               t_local, t_kd, real and padded client steps, peak memory;
               kernel 5 launched 169 leaves x 2 rounds times, the KD kernels
               2 / 400 / 400; kernel 5 at the last round's own Eq. 2 inputs;
               then one bucket's 10 vmapped steps under torch.profiler
 12. Flash-KD  kernels 7-10 (flash_kd.cu) against their plain versions: 7/8 at
               rows 1, 5, 512 x V 517, 50,304, 256,000, f32 and bf16 caches,
               teacher lse on and off; 9/10 at D = 2,048 over the same rows and
               V with gemma-2b's tied head, and every option (untied, bias, f32
               cache, no lse) at (5, 50,304) and (512, 517), a bf16 head at two
               shapes; CUDA-event timings at 512 x 2,048 x 256,000 beside the
               bound, the plain version and a library composition; kernel 10's
               bound counts the bf16 tensor-core products it runs (9 with an
               f32 head: each product as hi·hi + hi·lo + lo·hi), with the
               f32 CUDA-core bound and the one-product bound beside it
 13. LM f32    gemma-2b reduced with V = 50,304, lm_task (8 clients, 512 KD
               rows), fedsdd K=4 R=2, 2 rounds from the same weights made on
               the card, deterministic algorithms on: head-fused and unfused
               Flash-KD (f32 cache) with the kernels and with the four wrappers
               patched to their plain versions, the head-fused run with the
               default bf16 cache both ways, and the dense KD kernels 2-4; main
               model within 2e-4 and models k>0 bit-identical for each pair and
               against dense (k>0 are never distilled: that shows the client
               side repeats); kernels 7/8 or 9/10 launched 20 x 2 times; the
               same rounds without KD give the main model's KD change, printed
               beside the tolerance
 14. gemma-2b  full width (d_model 2,048, 8 heads of 256, 1 KV head, d_ff
               16,384 GeGLU, V 256,000, tied), 2 of 18 layers, f32: lm_task(8
               clients x 8 docs of 128 tokens, 2 server batches of 4), fedsdd
               K=4 R=2, distill_steps 20, head-fused Flash-KD with the default
               bf16 cache, the teacher ring stored in bf16; per round t_local,
               t_kd, the cache build, peak memory and kernels 9/10's launches
               (20 each); then 5 KD steps under torch.profiler, kernels 9
               and 10's device time and share of the step
 15. flash     kernels 11-12 (flash_attention.cu): first their own path, the
               reference's kernel bench and tests through the public ops
               (counts zeroed before, read after); then against their plain
               versions: the reference sweep, dh 80 and dh 256, f32 and
               bf16; the four registered configs' full widths at S =
               4,096, causal, f32 and bf16; starcoder2-3b's window 4,096 at
               S = 16,384; one
               backward at qwen2.5-14b's width; decode at the bench shape and
               at qwen2.5-14b's decode_32k per card, cache_len 0 (the mean of
               V), 1, 700, S - 1, S; CUDA-event timings beside the bound, the
               plain version and scaled_dot_product_attention
 16. sc2 f32   starcoder2-3b at full width, 2 layers, f32: ContinuousEngine
               == generate_static within the window; a 20,480-token prompt
               (block-local sliding_attention prefill) served through kernel
               1 and through its plain version with identical tokens
 17. sc2 bf16  starcoder2-3b as configured (30 layers, bf16): ContinuousEngine
               serves 8 requests, prompts 32-2,048 tokens and one of 20,480;
               token counts, the drained pool, 30 launches of kernel 1 per
               decode micro-step; tokens/s, TTFT p50, the long prefill, peak
               memory; a profiled decode chunk as in phase 5 (launches per
               micro-step beside the earlier design's 2,360)
 18. kernels   one JSON line per the port's kernel contract; kernel 12's
               entry is its bf16 row at qwen2.5-14b's width (the configs'
               dtype), with the f32 row beside it under "f32"; kernel 1's
               also gives "starcoder2_ms", its times in the two starcoder2-3b
               bf16 cases its split-K was designed for; every entry's
               "host_ms" is its wrapper's host time a call
 19. ok        {"ok": true, "device": {...}} as the last line

Tolerances, paged_decode: f32 kernel vs plain at rtol = atol = 1e-5 (only
the order of summation differs).  bf16 per (request, query head) row: the row's max
|kernel - plain| is at most 1.6e-2 of its max |plain|, four bf16 ulps at
that value.  The plain version rounds the scaled query and its
probabilities to bf16 before P·V (as the reference's decode_attention
does), the kernel keeps both in f32, and both round the output once.  A
long row averages many values down to a small output, so the bound
follows each row's own scale: one tile of a 2048-token row left out
moves the row by several percent of it.

Tolerances, the KD kernels (both sides compute in f32 from the same
inputs): f32 per row, max |kernel - plain| at most 1e-5 of the row's max
|plain|; probabilities from bf16 teacher logits at atol 2e-3 (the
reference's own); the loss at rtol 1e-4; a bf16 gradient per row at 8e-3
of its max |plain| (two bf16 ulps: both sides round once).  A gradient
row also gets 1e-6·|g|·τ/B absolute: it is (p − t)·g·τ/B with p, t ≤ 1,
so f32 leaves about 1e-7 of that scale as noise, and a row the student
already matches (the distilled model's, at the round's own inputs) has a
max |plain| near that noise.

Tolerances, weight_avg (both sides sum the same f32 products in another
order): f32 at rtol 1e-5, atol 1e-6, the reference's own; bf16 within one
bf16 ulp of the plain result plus 2^-22 of sum_n |w_hat_n x_n| (the two f32
sums differ by a few f32 ulps of their terms, which a result much smaller
than its terms does not absorb).  The vectorized CNN round against the
sequential one: every model within 2e-4, the port's runner-parity
tolerance.

Tolerances, flash attention (kernels 11-12; both sides compute in f32 from
the same inputs and round the output once): f32 at rtol = atol = 1e-5; bf16
within one bf16 ulp of each row's max |plain| plus 2e-5.  The backward
recomputes through the plain chunked attention, held against autograd of
the plain version at 1e-4 (the reference's gradient test) of the largest
gradient, or absolute below 1.

Tolerances, Flash-KD (both sides compute in f32 from the same inputs, in
other orders): the loss at rtol 1e-5 (kernel 7) or 1e-4 (kernel 9, whose
student logits are sums of D = 2,048 products formed in the kernel) plus
2^-22·tau^2·max|lse| (KL = cross - lse_t + lse_s cancels terms of size
|lse|); the normalisers at rtol 1e-5 plus 2^-22·max|lse|; a logit gradient
within 1e-5 of (|q| + |p|)·|g|·tau/B per element, the magnitude of what it
subtracts, plus one bf16 ulp in bf16; the head's gradients within 2^-14 of
the sum of the magnitudes of the products each element adds up (up to
256,000 of them: u·sqrt(K) for K up to a million), plus one bf16 ulp in bf16.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, data sheet
PEAK_FLOPS = {torch.float32: 67e12,            # f32 outside the tensor cores
              torch.bfloat16: 989e12}          # bf16 tensor cores, dense
PAGED_DECODE_TPU = "src/repro/kernels/flash_attention/kernel.py:226"
F32_TOL = 1e-5                                 # rtol = atol, elementwise
BF16_ROW_TOL = 1.6e-2                          # of each row's max |plain|
KD_TPU = {"ensemble_softmax": "src/repro/kernels/kd_loss/kernel.py:57",
          "kd_loss_fwd": "src/repro/kernels/kd_loss/kernel.py:88",
          "kd_loss_bwd": "src/repro/kernels/kd_loss/kernel.py:120"}
KD_SOURCE = "src/repro_torch/kernels/csrc/kd_loss.cu"
KD_F32_ROW_TOL = 1e-5                          # of each row's max |plain|
KD_BF16_PROB_ATOL = 2e-3
KD_LOSS_RTOL = 1e-4
KD_BF16_GRAD_ROW_TOL = 8e-3                    # of each row's max |plain|
KD_GRAD_ATOL = 1e-6                            # × |g|·τ/B, the gradient's own scale
ROUND_TOL = 2e-4                               # main model, kernels vs plain
WA_TPU = {"multi_weighted_average": "src/repro/kernels/weight_avg/kernel.py:53",
          "weighted_average": "src/repro/kernels/weight_avg/kernel.py:29"}
WA_SOURCE = "src/repro_torch/kernels/csrc/weight_avg.cu"
WA_RTOL, WA_ATOL = 1e-5, 1e-6
FLASH_TPU = {"flash_kd_fwd": "src/repro/kernels/kd_loss/flash.py:438",
             "flash_kd_bwd": "src/repro/kernels/kd_loss/flash.py:500",
             "flash_kd_head_fwd": "src/repro/kernels/kd_loss/flash.py:608",
             "flash_kd_head_bwd": "src/repro/kernels/kd_loss/flash.py:698"}
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_kd.cu"
FLASH_LOSS_RTOL = 1e-5                         # kernel 7
FLASH_HEAD_LOSS_RTOL = 1e-4                    # kernel 9: its logits are sums of D products
FLASH_LSE_RTOL = 1e-5
FLASH_GRAD_TOL = 1e-5                          # of (|q| + |p|)·|g|·τ/B
ULP_LSE = 2.0 ** -22                           # × τ²·max|lse| for the loss
SUM_TOL = 2.0 ** -14                           # of the summed magnitudes (head gradients)
FA_TPU = {"flash_forward": "src/repro/kernels/flash_attention/kernel.py:87",
          "flash_decode": "src/repro/kernels/flash_attention/kernel.py:151"}
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_F32_TOL = 1e-5                              # rtol = atol, elementwise
FA_GRAD_TOL = 1e-4                             # the reference's gradient test
DEV = "cuda"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


T_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"\n== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


HOST_LEAD_MS = 0.2            # the least spin before a timed call
_CYCLES_PER_MS: list[float] = []


def _spin(ms: float) -> None:
    """Keep the card busy for about ``ms`` (torch.cuda._sleep counts clock
    cycles; the rate is measured once)."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(2_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(2_000_000 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def time_call(fn, reps: int = 25) -> tuple[float, float]:
    """(device ms, host ms) of one call of ``fn``.

    Host: the median wall time for ``fn()`` to return on an idle card (its
    enqueue, or all of it where ``fn`` waits for the card).  Device: the
    median CUDA-event time over ``reps`` runs, each after a write of 256 MB
    that evicts the 50 MB L2, as a decode step's attention finds it after
    the layer's weight reads.  The card then spins for twice the host time
    (at least ``HOST_LEAD_MS``, at most 20 ms) so that the host has
    enqueued ``fn``'s launches before the start event runs: the device time
    holds no gap the wrapper's host work would leave."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=DEV)
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    host_ms = statistics.median(host)
    lead = min(max(HOST_LEAD_MS, 2 * host_ms), 20.0)
    times = []
    for _ in range(reps):
        flush.zero_()
        _spin(lead)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), host_ms


def time_ms(fn, reps: int = 25) -> float:
    return time_call(fn, reps)[0]


def kernel_times(fn, reps: int = 25) -> dict:
    """A kernel wrapper's ``ms`` (device) and ``host_ms`` (its host time a call)."""
    ms, host_ms = time_call(fn, reps)
    return {"ms": ms, "host_ms": host_ms}


# ---------------------------------------------------------------- phase 2
def _cuobjdump(build) -> str:
    """cuobjdump beside the nvcc that built the kernels (the same toolkit)."""
    tool = Path(build.nvcc_path()).resolve().parent / "cuobjdump"
    check(tool.exists(), f"cuobjdump not found beside nvcc ({tool})")
    return str(tool)


SASS_WGMMA = {"flash_attention": "flash_fwd_wgmma",   # kernel 12, bf16
              "flash_kd": "k105gemm3"}                # kernel 10 (k10::gemm3, mangled)


def sass_phase(build) -> None:
    """Whether kernel 12's bf16 path and kernel 10's GEMM passes run on the
    tensor cores: the HGMMA instructions in the SASS of each of their
    instances in the built libraries (cuobjdump -sass).  Fails the run if
    an instance holds none, if a library has no instance, or if cuobjdump
    is missing from nvcc's toolkit."""
    tool = _cuobjdump(build)
    for lib, pattern in SASS_WGMMA.items():
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                if pattern in fn:
                    counts[fn] = 0
            elif fn in counts and "HGMMA" in line:
                counts[fn] += 1
        print(json.dumps({"phase": f"{lib} tensor-core SASS", "tool": tool,
                          "hgmma_per_function": counts}), flush=True)
        check(len(counts) > 0 and all(n > 0 for n in counts.values()),
              f"{lib}'s tensor-core instances hold no HGMMA: {counts}")


# ---------------------------------------------------------------- phase 3
def paged_case(gen, *, B, Hkv, G, dh, bs, lens, dtype, nbmax=None):
    """A shuffled pool holding ``lens[b]`` tokens for request b."""
    nbmax = nbmax or max(1, math.ceil(max(lens) / bs))
    need = [math.ceil(n / bs) for n in lens]
    nb = 1 + sum(need)
    ids = (1 + torch.randperm(nb - 1, generator=gen, device=DEV)).to(torch.int32)
    bt = torch.zeros((B, nbmax), dtype=torch.int32, device=DEV)
    at = 0
    for b, n in enumerate(need):
        bt[b, :n] = ids[at:at + n]
        at += n
    pool = lambda: torch.randn((nb, bs, Hkv, dh), generator=gen, device=DEV).to(dtype)  # noqa: E731
    q = torch.randn((B, 1, Hkv * G, dh), generator=gen, device=DEV).to(dtype)
    sl = torch.tensor(lens, dtype=torch.int32, device=DEV)
    return q, pool(), pool(), bt, sl


def paged_bound(q, k_pool, bt, sl, window: int):
    """(bound_ms, bound_by): live K/V rows read once, q/tables read once,
    the output written once, over HBM bandwidth vs 4·G·dh flops per live
    row and KV head over the dtype's peak rate."""
    B, _, H, dh = q.shape
    _, _, Hkv, _ = k_pool.shape
    live = sl.clamp(max=window) if window > 0 else sl
    rows = int(live.sum())
    elt = q.element_size()
    nbytes = (rows * Hkv * dh * 2 * elt + 2 * q.numel() * elt
              + bt.numel() * 4 + sl.numel() * 4)
    flops = 4 * rows * H * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(q, k_pool, v_pool, bt, sl, window: int = 0):
    """Yardstick only, never called by the port: gather the table, then
    torch's scaled_dot_product_attention with a length (and window) mask."""
    B, _, H, dh = q.shape
    _, bs, Hkv, _ = k_pool.shape
    S = bt.shape[1] * bs
    kg = k_pool[bt.long()].reshape(B, S, Hkv, dh).transpose(1, 2)
    vg = v_pool[bt.long()].reshape(B, S, Hkv, dh).transpose(1, 2)
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < sl[:, None]
    if window > 0:
        mask &= pos >= sl[:, None] - window
    mask = mask[:, None, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True)


def compare_kernel(ops, args, window: int, label: str, timed: bool):
    q = args[0]
    out = ops.paged_decode(*args, window=window).float()
    ref = ops.paged_decode_ref(*args, window=window).float()
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_err = float(err.max())
    if q.dtype == torch.float32:
        tol = F32_TOL
        ok = bool((err <= tol + tol * ref.abs()).all())
        row_rel = None
    else:                                   # per (b, h) row, against its scale
        tol = BF16_ROW_TOL
        row_err, row_scale = err.amax(-1), ref.abs().amax(-1)
        ok = bool((row_err <= tol * row_scale).all())
        row_rel = float((row_err / row_scale.clamp(min=1e-30)).max())
    ok = ok and bool(out.isfinite().all())
    empty = (args[4] == 0)
    if empty.any():
        ok = ok and not bool(out[empty].any())   # seq_len 0 rows are zeros
    row = {"case": label, "max_abs_err": max_err, "max_row_rel_err": row_rel, "tol": tol}
    if timed:
        bound, by = paged_bound(q, args[1], args[3], args[4], window)
        row.update(**kernel_times(lambda: ops.paged_decode(*args, window=window)),
                   plain_ms=time_ms(lambda: ops.paged_decode_ref(*args, window=window)),
                   library_ms=time_ms(lambda: library_call(*args, window)),
                   bound_ms=bound, bound_by=by)
    print(json.dumps(row), flush=True)
    check(ok, f"paged_decode disagrees with its plain version ({label}): "
              f"max_abs_err {max_err}, max_row_rel_err {row_rel}, tol {tol}")
    return row


STARCODER_WINDOW = 4096
STARCODER_LENS = [0, 1, 4095, 4096, 4097, 9000, 16384, 20512]
QWEN_WINDOW = 256
# the starcoder2-3b cases kernel 1's split-K was designed for
STARCODER_TIMED = ("starcoder2 bfloat16 window=4096", "starcoder2 bfloat16")


def split_edge_lens(ops, B, Hkv, G, dh, nbmax, window, dtype):
    """Eight lengths at the edges of kernel 1's split-K at these shapes:
    seq_len 0, 1 and 16·k ± 1; lengths whose live range ends on a split
    boundary; with a window, rows whose lo falls inside a block and whose
    first blocks lie wholly before the window."""
    meta = lambda *shape: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    plan = ops.paged_plan(meta(B, 1, Hkv * G, dh), meta(1, 16, Hkv, dh),
                          torch.empty((B, nbmax), dtype=torch.int32, device="meta"), window)
    c, top = plan["chunk"], nbmax * 16
    if window > 0:
        lens = [0, 1, c, 2 * c - 1, window + 7, window + c + 16, 3 * window + 5, top]
    else:
        lens = [0, 1, 16 * 5 - 1, 16 * 5 + 1, c, 2 * c, 3 * c + 1, top]
    return [min(n, top) for n in lens], plan


def kernel_phase(ops, seed: int) -> dict:
    """Returns the timed starcoder2-3b rows by case."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lens = [0, 1, 16, 17, 2048, 300, 777, 1500]
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        qwen = paged_case(gen, B=8, Hkv=8, G=5, dh=128, bs=16, lens=lens, dtype=dtype)
        compare_kernel(ops, qwen, 0, f"qwen {name}", timed=True)
        compare_kernel(ops, qwen, QWEN_WINDOW, f"qwen {name} window={QWEN_WINDOW}", timed=False)
        gemma = paged_case(gen, B=8, Hkv=1, G=8, dh=256, bs=16, lens=lens, dtype=dtype)
        compare_kernel(ops, gemma, 0, f"gemma {name}", timed=True)
        stablelm = paged_case(gen, B=8, Hkv=32, G=1, dh=80, bs=16, lens=lens, dtype=dtype)
        compare_kernel(ops, stablelm, 0, f"stablelm dh=80 {name}", timed=True)
        # starcoder2-3b's decode as phases 16-17 serve it: G 12 and lengths
        # on both sides of its window, up to the long prompt's
        starcoder = paged_case(gen, B=8, Hkv=2, G=12, dh=128, bs=16, lens=STARCODER_LENS,
                               dtype=dtype)
        for window in (STARCODER_WINDOW, 0):
            label = f"starcoder2 {name}" + (f" window={window}" if window else "")
            timed[label] = compare_kernel(ops, starcoder, window, label, timed=True)
        # the split-K's edges at starcoder2-3b's and qwen2.5-14b's shapes:
        # the long prompt's table and qwen's serve-run table, each with a
        # window and without, and tables far longer than every row (empty
        # splits)
        for shape, nbmax, window, sparse in (
                ((8, 2, 12, 128), 1282, 0, False), ((8, 2, 12, 128), 1282, STARCODER_WINDOW, False),
                ((8, 2, 12, 128), 1282, 0, True), ((8, 8, 5, 128), 36, 0, False),
                ((8, 8, 5, 128), 36, QWEN_WINDOW, False), ((8, 8, 5, 128), 400, 0, True)):
            B, Hkv, G, dh = shape
            edge, plan = split_edge_lens(ops, B, Hkv, G, dh, nbmax, window, dtype)
            if sparse:
                edge = [0, 1, 15, 17, 31, 33, 300, 600]
            args = paged_case(gen, B=B, Hkv=Hkv, G=G, dh=dh, bs=16, lens=edge, dtype=dtype,
                              nbmax=nbmax)
            compare_kernel(ops, args, window,
                           f"split edges G={G} nbmax={nbmax} window={window} {name} "
                           f"(chunk {plan['chunk']}, splits {plan['splits']}, lens {edge})",
                           timed=False)
    return timed


# ------------------------------------------------------------- phases 4-5
def make_requests(Request, vocab: int, n: int, rng, len_range, new_range):
    lens = rng.integers(len_range[0], len_range[1] + 1, n)
    news = rng.integers(new_range[0], new_range[1] + 1, n)
    return [Request(rid=i, tokens=rng.integers(0, vocab, int(lens[i])).astype(np.int32),
                    max_new_tokens=int(news[i])) for i in range(n)]


def drive(engine, requests):
    """``engine.run`` step by step: returns the results and the host tables
    at the busiest chunk boundary (the main path's decode inputs)."""
    for r in requests:
        engine.submit(r)
    out, busiest = [], None
    while not engine.idle:
        out.extend(engine.step())
        if engine.num_active and (busiest is None
                                  or engine.num_active >= busiest[0]):
            busiest = (engine.num_active, engine.block_tables.copy(),
                       engine.seq_lens.copy())
    return out, busiest


def f32_depth2_phase(serve, zoo, get_config, seed: int):
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), num_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    model = zoo.build_model(cfg)
    params = model.init(seed, device=DEV)
    rng = np.random.default_rng(seed)
    reqs = make_requests(serve.Request, cfg.vocab_size, 8, rng, (16, 200), (4, 24))
    engine = serve.ContinuousEngine(model, params, max_batch=4, num_blocks=128,
                                    block_size=16, max_seq_len=224, chunk_steps=4)
    from repro_torch import kernels
    kernels.launches.clear()
    results, _ = drive(engine, reqs)
    launches = kernels.launches["paged_decode"]
    got = {r.rid: r.tokens for r in results}
    for r in reqs:
        ref = serve.generate_static(model, params, r.tokens[None], r.max_new_tokens)
        ref = ref[0].cpu().tolist()
        check(got[r.rid] == ref, f"f32 depth-2: request {r.rid} engine {got[r.rid]} "
                                 f"!= static {ref}")
    check(launches == cfg.num_layers * engine.steps,
          f"f32 depth-2: {launches} launches for {engine.steps} micro-steps")
    print(json.dumps({"phase": "f32 depth 2, full width", "requests": len(reqs),
                      "tokens": sum(len(v) for v in got.values()),
                      "identical_tokens": True, "paged_decode_launches": launches,
                      "micro_steps": engine.steps}), flush=True)
    del engine, params, model
    torch.cuda.empty_cache()


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "pagedrows" in low:              # kernel 1: splitk::decode_kernel<..., PagedRows>
        return "paged_decode"
    if any(s in low for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def profile_chunk(engine, serve, vocab: int, rng, before_launches: int) -> dict:
    """Where a decode micro-step's time goes, with every lane busy: one
    chunk timed on the host clock, then the next chunk under torch.profiler
    for the device time by kernel (the profiler's own host cost would
    inflate that chunk's wall).  The idle share is 1 - device / wall;
    kernel 1's share is its device time over the micro-step's.  The kernel
    launches per micro-step stand beside ``before_launches``, the count
    with kernel 1's one-CTA-per-head design (one launch a layer then, as
    now)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    k = engine.chunk_steps
    reqs = make_requests(serve.Request, vocab, engine.max_batch, rng, (32, 512),
                         (1 + 3 * k, 1 + 3 * k))
    for r in reqs:
        engine.submit(r)
    engine.step()                           # prefills and the first chunk
    check(engine.num_active == engine.max_batch, "profile: not every lane is busy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / k
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.step()                       # the last chunk, then eviction
        torch.cuda.synchronize()
    check(engine.idle, "profile: requests left after their last chunk")
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / k
    groups = dict.fromkeys(("matmul", "paged_decode", "other"), 0.0)
    for e in kern:
        groups[_kernel_group(e.key)] += e.self_device_time_total / 1e3 / k
    check(not kern or groups["paged_decode"] > 0,
          f"profile: no device time found for kernel 1 (paged_decode): {groups}")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"phase": "decode micro-step profile", "lanes": engine.max_batch,
            "wall_ms_per_micro_step": wall_ms,
            "device_ms_per_micro_step": busy_ms if kern else None,
            "idle_share": 1 - busy_ms / wall_ms if kern else None,
            "device_ms_by_group": groups,
            "paged_decode_share_of_device": groups["paged_decode"] / busy_ms if kern else None,
            "kernel_launches_per_micro_step": sum(e.count for e in kern) / k,
            "kernel_launches_per_micro_step_before": before_launches,
            "top_kernels": [{"name": e.key[:80], "per_micro_step": e.count / k,
                             "ms_per_micro_step": e.self_device_time_total / 1e3 / k}
                            for e in top]}


def serve_phase(serve, zoo, ops, get_config, seed: int, card: str):
    from unittest import mock

    from repro_torch import kernels
    cfg = get_config("qwen2.5-14b")
    model = zoo.build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"init: {serve.pool_bytes(params) / 1e9:.2f} GB of {cfg.param_dtype} "
          f"weights in {init_s:.2f} s", flush=True)

    rng = np.random.default_rng(seed)
    engine = serve.ContinuousEngine(model, params, max_batch=8, num_blocks=512,
                                    block_size=16, max_seq_len=576, chunk_steps=8)
    warm = make_requests(serve.Request, cfg.vocab_size, 2, rng, (32, 64), (8, 8))
    drive(engine, warm)                       # cuBLAS handles, allocator
    reqs = make_requests(serve.Request, cfg.vocab_size, 16, rng, (32, 512), (8, 64))
    steps0 = engine.steps
    torch.cuda.synchronize()
    kernels.launches.clear()
    t0 = time.perf_counter()
    results, busiest = drive(engine, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches["paged_decode"]
    micro = engine.steps - steps0

    check(len(results) == len(reqs), f"{len(results)} results for {len(reqs)} requests")
    by_rid = {r.rid: r for r in results}
    for r in reqs:
        res = by_rid[r.rid]
        check(not res.cancelled and len(res.tokens) == r.max_new_tokens,
              f"request {r.rid}: {len(res.tokens)} tokens for {r.max_new_tokens}")
    check(engine.alloc.used_blocks == 0 and engine.reserved_tokens == 0,
          "pool not free after the drain")
    check(launches > 0 and launches == cfg.num_layers * micro,
          f"{launches} paged_decode launches for {micro} micro-steps x {cfg.num_layers}")
    ntok = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft for r in results)
    lat = sorted(r.latency for r in results)
    summary = {"phase": "bf16 full depth, full width", "card": card,
               "requests": len(results), "generated_tokens": ntok,
               "prompt_tokens": int(sum(len(r.tokens) for r in reqs)),
               "wall_s": wall, "tokens_per_s": ntok / wall,
               "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
               "latency_p50_ms": lat[len(lat) // 2] * 1e3,
               "micro_steps": micro, "paged_decode_launches": launches,
               "paged_decode_launches_per_micro_step": launches / micro,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(summary), flush=True)
    print(json.dumps(profile_chunk(engine, serve, cfg.vocab_size, rng, 3429)), flush=True)

    # one decode step's logits through the kernel vs the plain version, on
    # four fresh requests scattered into a small pool
    probe = make_requests(serve.Request, cfg.vocab_size, 4, rng, (40, 300), (2, 2))
    pool = model.init_paged_cache(1 + 4 * 20, 16, device=DEV)
    bt = np.zeros((4, 20), np.int32)
    first = []
    with torch.inference_mode():
        at = 1
        for b, r in enumerate(probe):
            L = len(r.tokens)
            lpad = math.ceil(L / 16) * 16
            toks = np.zeros((1, lpad), np.int32)
            toks[0, :L] = r.tokens
            logits, ctg = model.prefill(params, {"tokens": torch.from_numpy(toks).to(DEV)},
                                        last=[L - 1])
            serve.scatter_prefill(pool, ctg, list(range(at, at + lpad // 16)))
            bt[b, :math.ceil((L + 1) / 16)] = range(at, at + math.ceil((L + 1) / 16))
            at += math.ceil((L + 1) / 16)
            first.append(int(logits.argmax(-1)[0]))
        tok = torch.tensor(first, dtype=torch.int32, device=DEV)[:, None]
        btd = torch.from_numpy(bt).to(DEV)
        sl = torch.tensor([len(r.tokens) for r in probe], dtype=torch.int32, device=DEV)
        lk, _ = model.paged_decode_step(params, tok, pool, btd, sl)
        with mock.patch.object(ops, "paged_decode", ops.paged_decode_ref):
            lp, _ = model.paged_decode_step(params, tok, pool, btd, sl)
    rel = float((lk.float() - lp.float()).norm() / lp.float().norm())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(json.dumps({"phase": "bf16 decode-step logits, kernel vs plain",
                      "rel_l2_err": rel, "max_abs_err": float((lk.float() - lp.float()).abs().max()),
                      "argmax_agreement": agree, "tol_rel_l2": 5e-2}), flush=True)
    check(bool(lk.isfinite().all()), "non-finite logits")
    check(rel <= 5e-2, f"bf16 decode-step logits: kernel vs plain rel L2 {rel} > 5e-2")

    # the kernel's line: its wrapper at the main path's busiest decode
    # inputs (the pool as it stands, the host tables of that chunk boundary)
    _, bt_host, sl_host = busiest
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    q = torch.randn((8, 1, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=DEV).to(cfg.cdtype)
    kp, vp = engine.pool["blocks"]["b0"]["k"][0], engine.pool["blocks"]["b0"]["v"][0]
    sl_attn = np.where(sl_host > 0, sl_host + 1, 0).astype(np.int32)
    args = (q, kp, vp, torch.from_numpy(bt_host).to(DEV), torch.from_numpy(sl_attn).to(DEV))
    print(f"kernel at the main path's inputs: seq_lens {sl_attn.tolist()}", flush=True)
    row = compare_kernel(ops, args, 0, "qwen bf16, serve-run inputs", timed=True)
    return {"name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": PAGED_DECODE_TPU, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "host_ms": row["host_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


# ---------------------------------------------------------------- phase 6
def rows_within(out, ref, rel: float, atol: float = 0.0) -> bool:
    """Every row's max |out - ref| at most ``rel`` of its max |ref| plus ``atol``."""
    out, ref = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    return bool(((out - ref).abs().amax(-1) <= rel * ref.abs().amax(-1) + atol).all())


def kd_bound(name: str, M: int, B: int, V: int, elt: int):
    """(bound_ms, bound_by): each input read once and each output written
    once over HBM bandwidth, vs the f32 operations over the f32 peak."""
    if name == "ensemble_softmax":              # x (M,B,V) -> probs (B,V) f32
        nbytes, ops = M * B * V * elt + B * V * 4, 2 * M * B * V + 4 * B * V
    elif name == "kd_loss_fwd":                 # s, t -> kl (B,)
        nbytes, ops = B * V * (elt + 4) + B * 4, 8 * B * V
    else:                                       # s, t, g -> grad (B,V) in s's type
        nbytes, ops = B * V * (2 * elt + 4) + 4, 6 * B * V
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kd_plain(kd_ref) -> dict:
    """The KD kernels' plain versions by name; each takes its kernel
    wrapper's arguments, tau last."""
    return {"ensemble_softmax": kd_ref.ensemble_softmax_ref,
            "kd_loss_fwd": kd_ref.kd_loss_ref,
            "kd_loss_bwd": lambda s, t, g, tau: (kd_ref.kd_loss_grad_ref(s, t, tau) * g)
            .to(s.dtype)}


LIBRARY = {   # yardsticks only, never called by the port: the shortest compositions
    "ensemble_softmax": ("softmax(x.float().mean(0) / tau)",
                         lambda x, tau: torch.softmax(x.float().mean(0) / tau, -1)),
    "kd_loss_fwd": ("kl_div(log_softmax(s / tau), t, 'sum') / B * tau^2",
                    lambda s, t, tau: torch.nn.functional.kl_div(
                        torch.log_softmax(s.float() / tau, -1), t, reduction="sum")
                    / s.shape[0] * tau ** 2),
    "kd_loss_bwd": ("(softmax(s / tau) - t) * g * tau / B",
                    lambda s, t, g, tau: ((torch.softmax(s.float() / tau, -1) - t)
                                          * (g * tau / s.shape[0])).to(s.dtype)),
}


def kd_check(kd_ops, kd_ref, label: str, x, s, t, g, tau: float, timed: bool) -> dict:
    """The three KD kernels against their plain versions on (x, s, t, g);
    returns one row per kernel (and checks each)."""
    plain = kd_plain(kd_ref)
    args = {"ensemble_softmax": (x, tau), "kd_loss_fwd": (s, t, tau),
            "kd_loss_bwd": (s, t, g, tau)}
    rows = {}
    for name, a in args.items():
        kern = getattr(kd_ops, name)
        out, ref = kern(*a), plain[name](*a)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        bf16 = a[0].dtype == torch.bfloat16
        if name == "kd_loss_fwd":
            tol, ok = KD_LOSS_RTOL, err <= KD_LOSS_RTOL * abs(float(ref))
        elif name == "ensemble_softmax" and bf16:
            tol, ok = KD_BF16_PROB_ATOL, err <= KD_BF16_PROB_ATOL
        elif name == "ensemble_softmax":
            tol, ok = KD_F32_ROW_TOL, rows_within(out, ref, KD_F32_ROW_TOL)
        else:
            tol = KD_BF16_GRAD_ROW_TOL if bf16 else KD_F32_ROW_TOL
            ok = rows_within(out, ref, tol, KD_GRAD_ATOL * abs(float(g)) * tau / s.shape[0])
        ok = ok and bool(out.isfinite().all()) and out.dtype == ref.dtype
        M, B, V = x.shape if name == "ensemble_softmax" else (1, *s.shape)
        row = {"case": label, "kernel": name, "shape": [M, B, V] if name == "ensemble_softmax"
               else [B, V], "dtype": str(a[0].dtype).removeprefix("torch."), "tau": tau,
               "max_abs_err": err, "tol": tol}
        if timed:
            bound, by = kd_bound(name, M, B, V, a[0].element_size())
            library, library_fn = LIBRARY[name]
            row.update(**kernel_times(lambda: kern(*a)),
                       plain_ms=time_ms(lambda: plain[name](*a)),
                       library_ms=time_ms(lambda: library_fn(*a)), library=library,
                       bound_ms=bound, bound_by=by)
        print(json.dumps(row), flush=True)
        check(ok, f"{name} disagrees with its plain version ({label}): {row}")
        rows[name] = row
    return rows


def kd_phase(kd_ops, kd_ref, seed: int) -> None:
    gen = torch.Generator(device=DEV).manual_seed(seed)
    cases = [("FedSDD round (K=4, R=2, 8x256 server rows)", 8, 2048, 256, 10, 4.0, True),
             ("sweep", 1, 4, 4, 128, 1.0, False), ("sweep", 4, 8, 8, 1000, 4.0, False),
             ("sweep", 8, 4, 4, 257, 2.0, False), ("sweep", 2, 16, 16, 4096, 4.0, False),
             ("Qwen2.5 vocabulary", 4, 256, 256, 152064, 4.0, True)]
    g = torch.tensor(1.5, device=DEV)
    for label, M, N, B, V, tau, timed in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((M, N, V), generator=gen, device=DEV) * 3).to(dtype)
            s = (torch.randn((B, V), generator=gen, device=DEV) * 3).to(dtype)
            t = torch.softmax(torch.randn((B, V), generator=gen, device=DEV) * 2, -1)
            kd_check(kd_ops, kd_ref, label, x, s, t, g, tau, timed)
            del x, s, t
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7
def plain_kd(kd_ops, kd_ref):
    """The three KD wrappers patched to their plain versions."""
    from contextlib import ExitStack
    from unittest import mock
    stack = ExitStack()
    for name, fn in kd_plain(kd_ref).items():
        stack.enter_context(mock.patch.object(kd_ops, name, fn))
    return stack


def f32_round_phase(fed, kd_ops, kd_ref, seed: int) -> None:
    from contextlib import nullcontext

    from repro_torch import kernels
    from repro_torch.core.tasks import classification_task
    from repro_torch.utils.pytree import tree_map
    torch.backends.cudnn.deterministic = True
    task = classification_task(model="resnet20", num_clients=8, num_train=2000,
                               num_server=512, server_batch=256, seed=seed, device=DEV)
    kw = dict(K=4, R=2, num_clients=8, participation=1.0, local_epochs=1, distill_steps=20,
              client_lr=0.05, server_lr=0.05, seed=seed)
    init = fed.make_runner("fedsdd", task, device=DEV, **kw).init_state().global_models
    runs = {}
    for mode in ("kernels", "plain"):
        runner = fed.make_runner("fedsdd", task, device=DEV, **kw)
        state = fed.FedState(round=0, global_models=[tree_map(torch.clone, m) for m in init],
                             ensemble=fed.TeacherBank(4, 2))
        kernels.launches.clear()
        with plain_kd(kd_ops, kd_ref) if mode == "plain" else nullcontext():
            state = runner.run(2, state=state)
        torch.cuda.synchronize()
        runs[mode] = (state, dict(kernels.launches))
    torch.backends.cudnn.deterministic = False
    (st_k, launches), (st_p, plain_launches) = runs["kernels"], runs["plain"]
    main_ok = all(torch.allclose(a, b, rtol=ROUND_TOL, atol=ROUND_TOL) for a, b in
                  zip(_leaves(st_k.global_models[0]), _leaves(st_p.global_models[0])))
    rest_same = all(torch.equal(a, b) for k in range(1, 4) for a, b in
                    zip(_leaves(st_k.global_models[k]), _leaves(st_p.global_models[k])))
    print(json.dumps({"phase": "f32 ResNet-20 round, kernels vs plain",
                      "main_max_abs_err": _tree_err(st_k.global_models[0], st_p.global_models[0]),
                      "tol": ROUND_TOL, "models_k>0_bit_identical": rest_same,
                      "kd_loss_last": [r["kd_loss_last"] for r in st_k.history],
                      "kd_loss_last_plain": [r["kd_loss_last"] for r in st_p.history],
                      "launches": launches, "launches_plain": plain_launches}), flush=True)
    check(main_ok, "f32 round: main model, kernels vs plain, beyond 2e-4")
    check(rest_same, "f32 round: models k>0 differ between the kernel and plain runs")
    check(launches == {"ensemble_softmax": 2, "kd_loss_fwd": 40, "kd_loss_bwd": 40},
          f"f32 round: launches {launches}")
    check(not any(plain_launches.values()), f"plain run launched kernels: {plain_launches}")


def _leaves(tree):
    from repro_torch.utils.pytree import tree_leaves
    return tree_leaves(tree)


def _tree_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(_leaves(a), _leaves(b)))


# ---------------------------------------------------------------- phase 8
def _train_group(name: str) -> str:
    low = name.lower()
    for key, group in (("ensemble_softmax", "ensemble_softmax"), ("kd_fwd", "kd_loss_fwd"),
                       ("kd_bwd", "kd_loss_bwd")):
        if key in low:
            return group
    if "multi_tensor" in low or "foreach" in low:
        return "optimiser"
    if "index" in low:
        return "gather"
    if any(k in low for k in ("norm", "moments", "fusedparams", "gammabeta",
                              "internalgradients")):
        return "norm"
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "wgrad", "dgrad", "fprop",
                              "gemm", "gemv", "cutlass", "nvjet")):
        return "conv"
    if "elementwise" in low or "reduce" in low:
        return "elementwise"
    return "other"


def profile_window(label: str, fn, steps: int) -> dict:
    """``fn`` (``steps`` training steps) once to warm, once on the host clock,
    once under torch.profiler for device time by kernel group; the idle
    share is 1 - device / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    groups = dict.fromkeys(("conv", "norm", "elementwise", "optimiser", "gather",
                            "ensemble_softmax", "kd_loss_fwd", "kd_loss_bwd", "other"), 0.0)
    for e in kern:
        groups[_train_group(e.key)] += e.self_device_time_total / 1e3 / steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"phase": f"profile: {label}", "steps": steps,
            "wall_ms_per_step": wall_ms,
            "device_ms_per_step": busy_ms if kern else None,
            "idle_share": 1 - busy_ms / wall_ms if kern else None,
            "device_ms_by_group": groups,
            "kernel_launches_per_step": sum(e.count for e in kern) / steps,
            "top_kernels": [{"name": e.key[:80], "per_step": e.count / steps,
                             "ms_per_step": e.self_device_time_total / 1e3 / steps}
                            for e in top]}


def resnet56_phase(fed, kd_ops, kd_ref, seed: int, card: str) -> list[dict]:
    from repro_torch import kernels
    from repro_torch.core.tasks import classification_task
    from repro_torch.distill import KDPipeline
    t0 = time.perf_counter()
    task = classification_task(model="resnet56", num_clients=20, alpha=0.1, num_train=50000,
                               num_server=2048, server_batch=256, seed=seed, device=DEV)
    tau, steps_kd = 4.0, 200
    runner = fed.make_runner("fedsdd", task, device=DEV, K=4, R=2, num_clients=20, participation=0.4,
                             client_batch=64, client_lr=0.05, server_lr=0.05,
                             temperature=tau, local_epochs=1, distill_steps=steps_kd,
                             seed=seed)
    state = runner.init_state()
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(state.global_models[0]))
    print(f"task and init: {time.perf_counter() - t0:.1f} s; {n_params:,} parameters "
          f"per model", flush=True)
    client_steps = [0]
    make_batch = task.make_batch

    def counted(ds, idx):
        client_steps[0] += 1
        return make_batch(ds, idx)

    task.make_batch = counted
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.launches.clear()
    rounds = []
    for _ in range(2):
        before, t0 = client_steps[0], time.perf_counter()
        state = runner.run(1, state=state)
        torch.cuda.synchronize()
        rec = state.history[-1]
        n = client_steps[0] - before
        rounds.append({"round": rec["round"], "active": rec["active"], "client_steps": n,
                       "t_round_s": time.perf_counter() - t0, "t_local_s": rec["t_local"],
                       "t_kd_s": rec["t_kd"], "acc_main": rec["acc_main"],
                       "client_steps_per_s": n / rec["t_local"],
                       "kd_steps_per_s": steps_kd / rec["t_kd"],
                       "kd_loss_first": rec["kd_loss_first"],
                       "kd_loss_last": rec["kd_loss_last"]})
    launches = dict(kernels.launches)
    task.make_batch = make_batch
    peak = torch.cuda.max_memory_allocated() / 1e9
    for r in rounds:
        print(json.dumps({"phase": "ResNet-56 FedSDD round", "card": card, **r}), flush=True)
    print(json.dumps({"phase": "ResNet-56 FedSDD run", "card": card, "rounds": 2,
                      "launches": launches, "teachers": state.ensemble.num_members,
                      "rounds_held": state.ensemble.rounds_held(),
                      "peak_mem_gb": peak}), flush=True)
    check(len(state.history) == 2, "ResNet-56: two history records")
    check(all(math.isfinite(r["kd_loss_first"]) and math.isfinite(r["kd_loss_last"])
              for r in rounds), f"ResNet-56: non-finite KD losses {rounds}")
    check(state.ensemble.num_members == 8, "ResNet-56: the ring does not hold 8 teachers")
    check(launches.get("ensemble_softmax") == 2 and launches.get("kd_loss_fwd") == 2 * steps_kd
          and launches.get("kd_loss_bwd") == 2 * steps_kd, f"ResNet-56: launches {launches}")
    check(all(_tree_err(state.global_models[k], state.global_models[0]) > 0
              for k in range(1, 4)), "ResNet-56: a model k>0 equals the main model")
    check(all(bool(x.isfinite().all()) for m in state.global_models for x in _leaves(m)),
          "ResNet-56: non-finite weights")

    # where a step's time goes: 10 client steps (the largest client's first
    # 640 examples, ~2,500 at full size) and 10 KD steps over round 2's teacher cache
    sizes = [len(y) for _, y in task.client_data]
    cid = int(np.argmax(sizes))
    rows = (np.arange(640) % sizes[cid]).reshape(10, 64)
    pipe = runner._kd_pipeline()
    batches = pipe.batches_for(task.server_batches)
    teachers = state.ensemble.member_views()
    cache = pipe.precompute_cache(teachers, batches)
    pipe10 = KDPipeline(task.logits_fn, steps=10, lr=0.05, temperature=tau, device=DEV)
    for label, fn in (
            ("10 client steps, ResNet-56, batch 64",
             lambda: runner._local_train_scheduled(state.global_models[1], cid, state, rows)),
            ("10 KD steps, ResNet-56, batch 256, 8 teachers",
             lambda: pipe10._run(state.global_models[0], batches, cache))):
        print(json.dumps(profile_window(label, fn, 10)), flush=True)

    # the kernels at the round's own inputs: round 2's teacher logits over
    # the 8 server batches, and the distilled main model on batch 0
    with torch.no_grad():
        M, nB = len(teachers), batches["x"].shape[0]
        x = torch.stack([torch.stack([task.logits_fn(member, {"x": batches["x"][b]})
                                      for b in range(nB)]) for member in teachers])
        x = x.reshape(M, -1, x.shape[-1])
        s = task.logits_fn(state.global_models[0], {"x": batches["x"][0]})
    t = kd_ref.ensemble_softmax_ref(x, tau)[:s.shape[0]].contiguous()
    g = torch.ones((), device=DEV)
    rows = kd_check(kd_ops, kd_ref, "ResNet-56 round inputs", x, s, t, g, tau, timed=True)
    return [{"name": name, "route": "cuda", "source": KD_SOURCE, "replaces": KD_TPU[name],
             "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "host_ms": r["host_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]} for name, r in rows.items()], rounds


# ---------------------------------------------------------------- phase 9
def wa_within(out, ref, x, w) -> bool:
    """Kernel 5/6 output against the plain version; ``x`` (G, N, D) and ``w``
    (G, N) are the inputs (see the module docstring for the bounds)."""
    if out.dtype == torch.float32:
        return bool(((out - ref).abs() <= WA_ATOL + WA_RTOL * ref.abs()).all())
    want = ref.float()
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(min=2 ** -126))) - 7)
    w_hat = w / w.sum(-1, keepdim=True)
    terms = (x.float().abs() * w_hat[..., None]).sum(-2)
    return bool(((out.float() - want).abs() <= ulp + 2.0 ** -22 * terms).all())


def wa_bound(G: int, N: int, D: int, elt: int):
    """(bound_ms, bound_by): x read once, the weights read once, the output
    written once over HBM bandwidth, vs 2·G·N·D f32 operations."""
    t_bytes = (G * N * D * elt + G * N * 4 + G * D * elt) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * G * N * D / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wa_library(x, w):
    """Yardstick only, never called by the port: the normalised weights and
    one batched product, ``einsum("gn,gnd->gd")``."""
    return torch.einsum("gn,gnd->gd", (w / w.sum(1, keepdim=True)).to(x.dtype), x)


def wa_check(wa_ops, wa_ref, label: str, x, w, timed: bool) -> dict:
    """Kernel 5 on x (G, N, D), or kernel 6 when ``x`` is (N, D)."""
    single = x.ndim == 2
    kern = wa_ops.weighted_average if single else wa_ops.group_weighted_average
    plain = wa_ref.weighted_average_ref if single else wa_ref.group_weighted_average_ref
    out, ref = kern(x, w), plain(x, w)
    torch.cuda.synchronize()
    x3, w2 = (x[None], w[None]) if single else (x, w)
    ok = (wa_within(out.reshape(ref.shape), ref, x3, w2) and out.dtype == x.dtype
          and bool(out.isfinite().all()))
    G, N, D = x3.shape
    row = {"case": label, "kernel": "weighted_average" if single else "multi_weighted_average",
           "shape": [G, N, D] if not single else [N, D],
           "dtype": str(x.dtype).removeprefix("torch."),
           "max_abs_err": float((out.float() - ref.float()).abs().max())}
    if timed:
        bound, by = wa_bound(G, N, D, x.element_size())
        lib = (lambda: wa_library(x3, w2)[0]) if single else (lambda: wa_library(x, w))
        row.update(**kernel_times(lambda: kern(x, w)), plain_ms=time_ms(lambda: plain(x, w)),
                   library_ms=time_ms(lib), bound_ms=bound, bound_by=by)
    print(json.dumps(row), flush=True)
    check(ok, f"{row['kernel']} disagrees with its plain version ({label}): {row}")
    return row


def weight_avg_phase(wa_ops, wa_ref, seed: int) -> dict:
    """Kernels 5 and 6 against their plain versions; returns kernel 6's row
    at N = 32, D = 16,777,219, f32."""
    from repro_torch.configs.resnet_cifar import get_resnet_config
    from repro_torch.models.resnet import init_resnet
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shapes = [tuple(x.shape) for x in
              _leaves(init_resnet(torch.Generator(device=DEV).manual_seed(seed),
                                  get_resnet_config("resnet56")))]
    w = torch.randint(1, 7000, (4, 2), generator=gen, device=DEV).float()
    single = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        worst = 0.0
        for shp in shapes:              # every ResNet-56 leaf, G = 4 groups of N = 2
            x = torch.randn((4, 2, math.prod(shp)), generator=gen, device=DEV).to(dtype)
            out, ref = wa_ops.group_weighted_average(x, w), wa_ref.group_weighted_average_ref(x, w)
            check(wa_within(out, ref, x, w), f"multi_weighted_average, leaf {shp} {name}")
            worst = max(worst, float((out.float() - ref.float()).abs().max()))
        print(json.dumps({"case": f"every ResNet-56 leaf (G=4, N=2) {name}", "leaves": len(shapes),
                          "max_abs_err": worst}), flush=True)
        cases = [("ResNet-56 flattened (G=4, N=2)", (4, 2, 855_578), w, True),
                 ("sweep", (3, 5, 517), None, False),
                 ("large, odd D", (4, 8, 16_777_219), None, True)]
        for label, shape, wc, timed in cases:
            x = torch.randn(shape, generator=gen, device=DEV).to(dtype)
            if wc is None:
                wc = torch.randint(1, 40, shape[:2], generator=gen, device=DEV).float()
            wa_check(wa_ops, wa_ref, f"{label} {name}", x, wc, timed)
            del x
        x = torch.randn((32, 16_777_219), generator=gen, device=DEV).to(dtype)
        w1 = torch.randint(1, 40, (32,), generator=gen, device=DEV).float()
        row = wa_check(wa_ops, wa_ref, f"kernel 6, N=32, odd D {name}", x, w1, timed=True)
        single = single or row
        del x
    torch.cuda.empty_cache()
    return single


# ---------------------------------------------------------------- phase 10
def vectorized_cnn_phase(fed, seed: int) -> None:
    from repro_torch import kernels
    from repro_torch.core.tasks import classification_task
    from repro_torch.utils.pytree import tree_map
    torch.backends.cudnn.deterministic = True
    task = classification_task(model="cnn", num_clients=8, seed=seed, device=DEV)
    kw = dict(K=4, R=2, num_clients=8, participation=1.0, local_epochs=1, distill_steps=20,
              client_lr=0.05, server_lr=0.05, seed=seed)
    init = fed.make_runner("fedsdd", task, device=DEV, **kw).init_state().global_models
    runs = {}
    for execution in ("vectorized", "sequential"):
        runner = fed.make_runner("fedsdd", task, device=DEV, execution=execution, **kw)
        state = fed.FedState(round=0, global_models=[tree_map(torch.clone, m) for m in init],
                             ensemble=fed.TeacherBank(4, 2))
        kernels.launches.clear()
        state = runner.run(2, state=state)
        torch.cuda.synchronize()
        runs[execution] = (state, dict(kernels.launches))
    torch.backends.cudnn.deterministic = False
    (vec, launches), (seq, seq_launches) = runs["vectorized"], runs["sequential"]
    errs = [_tree_err(a, b) for a, b in zip(vec.global_models, seq.global_models)]
    n_leaves = len(_leaves(init[0]))
    print(json.dumps({"phase": "f32 CNN round, vectorized vs sequential", "models_max_abs_err": errs,
                      "tol": ROUND_TOL, "launches": launches, "launches_sequential": seq_launches,
                      "leaves": n_leaves,
                      "acc_main": [r["acc_main"] for r in vec.history],
                      "acc_main_sequential": [r["acc_main"] for r in seq.history]}), flush=True)
    check(all(torch.allclose(a, b, rtol=ROUND_TOL, atol=ROUND_TOL)
              for m, n in zip(vec.global_models, seq.global_models)
              for a, b in zip(_leaves(m), _leaves(n))),
          f"vectorized CNN round: models beyond 2e-4 of the sequential run ({errs})")
    check(launches.get("multi_weighted_average") == n_leaves * 2,
          f"vectorized CNN round: launches {launches}, want {n_leaves} leaves x 2 rounds")
    check(not seq_launches.get("multi_weighted_average"),
          f"sequential CNN round launched kernel 5: {seq_launches}")


# ---------------------------------------------------------------- phase 11
def resnet56_vectorized_phase(fed, wa_ops, wa_ref, seed: int, card: str,
                              sequential_rounds: list[dict]) -> dict:
    import dataclasses
    from unittest import mock

    from repro_torch import kernels
    from repro_torch.core.tasks import classification_task
    from repro_torch.utils.pytree import tree_map, tree_stack
    task = classification_task(model="resnet56", num_clients=20, alpha=0.1, num_train=50000,
                               num_server=2048, server_batch=256, seed=seed, device=DEV)
    tau, steps_kd = 4.0, 200
    runner = fed.make_runner("fedsdd", task, device=DEV, K=4, R=2, num_clients=20,
                             participation=0.4, client_batch=64, client_lr=0.05,
                             server_lr=0.05, temperature=tau, local_epochs=1,
                             distill_steps=steps_kd, seed=seed, execution="vectorized")
    state = runner.init_state()
    eng = runner._make_engine()
    plans, agg_inputs = [], []
    train_round, aggregate_groups = eng.train_round, fed.aggregate_groups

    def recording_train_round(rplan, *a, **k):
        plans.append(rplan.plans)
        return train_round(rplan, *a, **k)

    def recording_aggregate(stacked, sizes, gids, K):
        agg_inputs[:] = [(stacked, sizes, gids, K)]
        return aggregate_groups(stacked, sizes, gids, K)

    eng.train_round = recording_train_round
    torch.cuda.synchronize()
    kernels.launches.clear()
    rounds = []
    with mock.patch.object(fed, "aggregate_groups", recording_aggregate):
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = runner.run(1, state=state)
            torch.cuda.synchronize()
            rec = state.history[-1]
            real = int(sum(p.num_steps.sum() for p in plans[-1]))
            padded = int(sum(p.step_mask.numel() for p in plans[-1]))
            rounds.append({"round": rec["round"], "active": rec["active"],
                           "buckets": [[len(p.cids), int(p.step_mask.shape[1]), p.batch_size]
                                       for p in plans[-1]],
                           "real_client_steps": real, "padded_client_steps": padded,
                           "host_steps": int(sum(p.step_mask.shape[1] for p in plans[-1])),
                           "t_round_s": time.perf_counter() - t0, "t_local_s": rec["t_local"],
                           "t_kd_s": rec["t_kd"], "acc_main": rec["acc_main"],
                           "client_steps_per_s": real / rec["t_local"],
                           "kd_steps_per_s": steps_kd / rec["t_kd"],
                           "kd_loss_first": rec["kd_loss_first"],
                           "kd_loss_last": rec["kd_loss_last"],
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    launches = dict(kernels.launches)
    eng.train_round = train_round
    peak = max(r["peak_mem_gb"] for r in rounds)
    for r, seq in zip(rounds, sequential_rounds):
        print(json.dumps({"phase": "ResNet-56 FedSDD round, vectorized", "card": card, **r,
                          "sequential_t_local_s": seq["t_local_s"],
                          "sequential_client_steps": seq["client_steps"]}), flush=True)
    n_leaves = len(_leaves(state.global_models[0]))
    print(json.dumps({"phase": "ResNet-56 FedSDD run, vectorized", "card": card, "rounds": 2,
                      "launches": launches, "leaves": n_leaves,
                      "teachers": state.ensemble.num_members, "peak_mem_gb": peak}), flush=True)
    check(len(state.history) == 2, "vectorized ResNet-56: two history records")
    check(all(math.isfinite(r["kd_loss_first"]) and math.isfinite(r["kd_loss_last"])
              for r in rounds), f"vectorized ResNet-56: non-finite KD losses {rounds}")
    check(state.ensemble.num_members == 8, "vectorized ResNet-56: the ring does not hold 8 teachers")
    check(launches.get("multi_weighted_average") == n_leaves * 2 and n_leaves > 0,
          f"vectorized ResNet-56: kernel 5 launches {launches}, want {n_leaves} x 2")
    check(launches.get("ensemble_softmax") == 2 and launches.get("kd_loss_fwd") == 2 * steps_kd
          and launches.get("kd_loss_bwd") == 2 * steps_kd,
          f"vectorized ResNet-56: KD launches {launches}")
    check(all(_tree_err(state.global_models[k], state.global_models[0]) > 0
              for k in range(1, 4)), "vectorized ResNet-56: a model k>0 equals the main model")
    check(all(bool(x.isfinite().all()) for m in state.global_models for x in _leaves(m)),
          "vectorized ResNet-56: non-finite weights")

    # where a vmapped step's time goes: the last round's bucket, its first 10 steps
    plan = max(plans[-1], key=lambda p: len(p.cids))
    plan10 = dataclasses.replace(plan, indices=plan.indices[:, :10],
                                 step_mask=plan.step_mask[:, :10],
                                 num_steps=np.minimum(plan.num_steps, 10))
    gid = torch.from_numpy(plan.group_of).to(DEV)
    stacked_k = tree_stack(state.global_models)
    w0 = tree_map(lambda x: x[gid], stacked_k)
    s0 = eng.optimizer.init(w0)
    label = (f"10 vmapped client steps, ResNet-56, {len(plan.cids)} clients x batch "
             f"{plan.batch_size} (conv = cuDNN grouped convolutions, groups = clients)")
    print(json.dumps({**profile_window(label, lambda: eng.train_bucket(plan10, w0, s0), 10),
                      "card": card}), flush=True)

    # kernel 5 at the last round's own Eq. 2 inputs: the (8, ...) client stack
    # in group-major order, viewed as (K=4, 2, ...) per leaf
    stacked, sizes, gids, K = agg_inputs[0]
    n = len(sizes) // K
    check(len(sizes) == K * n and bool((np.diff(gids) >= 0).all()),
          "vectorized ResNet-56: the round's groups are not uniform")
    w = torch.as_tensor(np.asarray(sizes, np.float64).reshape(K, n), dtype=torch.float32,
                        device=DEV)
    flat = [x.reshape(K, n, -1) for x in _leaves(stacked)]
    worst = 0.0
    for x in flat:
        out, ref = wa_ops.group_weighted_average(x, w), wa_ref.group_weighted_average_ref(x, w)
        torch.cuda.synchronize()
        check(wa_within(out, ref, x, w), f"multi_weighted_average at the round's inputs {x.shape}")
        worst = max(worst, float((out - ref).abs().max()))
    bound = sum(wa_bound(K, n, x.shape[2], 4)[0] for x in flat)
    row = {"case": "ResNet-56 round inputs, one launch per leaf", "leaves": len(flat),
           "max_abs_err": worst,
           **kernel_times(lambda: [wa_ops.group_weighted_average(x, w) for x in flat]),
           "plain_ms": time_ms(lambda: [wa_ref.group_weighted_average_ref(x, w) for x in flat]),
           "library_ms": time_ms(lambda: [wa_library(x, w) for x in flat]),
           "bound_ms": bound, "bound_by": "bytes"}
    print(json.dumps(row), flush=True)
    return {"name": "multi_weighted_average", "route": "cuda", "source": WA_SOURCE,
            "replaces": WA_TPU["multi_weighted_average"],
            "launches": launches["multi_weighted_average"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "host_ms": row["host_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}, launches


# ---------------------------------------------------------------- phase 12
def flash_plain(flash) -> dict:
    """The Flash-KD kernels' plain versions by wrapper name."""
    return {"flash_kd_fwd": flash.flash_kd_fwd_tiled, "flash_kd_bwd": flash.flash_kd_bwd_ref,
            "flash_kd_head_fwd": flash.flash_kd_head_fwd_tiled,
            "flash_kd_head_bwd": flash.flash_kd_head_bwd_tiled}


def plain_flash(kd_ops, flash):
    """The four Flash-KD wrappers patched to their plain versions."""
    from contextlib import ExitStack
    from unittest import mock
    plain = flash_plain(flash)
    fns = {"flash_kd_fwd": lambda s, t, tau=1.0, tile_v=None, teacher_lse=None:
           plain["flash_kd_fwd"](s, t, tau, tile_v or flash.DEFAULT_TILE_V_HOST,
                                 teacher_lse=teacher_lse),
           "flash_kd_bwd": plain["flash_kd_bwd"],
           "flash_kd_head_fwd": lambda h, w, b, t, tau=1.0, tile_v=None, teacher_lse=None:
           plain["flash_kd_head_fwd"](h, w, b, t, tau, tile_v or flash.DEFAULT_TILE_V_HOST,
                                      teacher_lse=teacher_lse),
           "flash_kd_head_bwd": lambda h, w, b, t, ls, lt, g, tau=1.0, tile_v=None:
           plain["flash_kd_head_bwd"](h, w, b, t, ls, lt, g, tau,
                                      tile_v or flash.DEFAULT_TILE_V_HOST)}
    stack = ExitStack()
    for name, fn in fns.items():
        stack.enter_context(mock.patch.object(kd_ops, name, fn))
    return stack


def _bound(nbytes: float, ops: float, peak: float = PEAK_FLOPS[torch.float32]):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def head_bwd_products(es: int) -> int:
    """bf16 tensor-core products kernel 10 runs per 2·B·D·V: each f32
    operand is split into bf16 hi and lo and a product runs as hi·hi +
    hi·lo + lo·hi, 3 for each of its 3 GEMMs; a bf16 head has no lo half
    (logits 1, dW 2, dh 2)."""
    return 9 if es == 4 else 5


def flash_bound(name: str, B: int, V: int, D: int, es: int, et: int, bias: bool, lse: bool):
    """(bound_ms, bound_by): every input read once and every output written
    once over HBM, vs the operations over their peak: kernels 7-9 in f32 on
    the CUDA cores (the products 2·B·D·V each, about 10 per (row, column)
    for the streaming epilogue); kernel 10 the bf16 tensor-core products it
    runs at this accuracy (``head_bwd_products``) at the bf16 dense peak.
    ``head_bwd_bounds`` gives kernel 10's other two for comparison."""
    rows = B * 4 * (2 if name.endswith("bwd") else 1) + (B * 4 if lse else 0) + 12
    if name == "flash_kd_fwd":                  # s, t -> loss, lse_s, lse_t
        return _bound(B * V * (es + et) + rows, 10 * B * V)
    if name == "flash_kd_bwd":                  # s, t, lse_s, lse_t, g -> ds
        return _bound(B * V * (2 * es + et) + rows, 8 * B * V)
    head = D * V * es + B * D * es + (V * es if bias else 0) + B * V * et + rows
    if name == "flash_kd_head_fwd":             # h, W, b, t -> loss, lse_s, lse_t
        return _bound(head, 2 * B * D * V + 10 * B * V)
    return _bound(head + D * V * es + B * D * es + (V * es if bias else 0),   # + dh, dW, db
                  head_bwd_products(es) * 2 * B * D * V, PEAK_FLOPS[torch.bfloat16])


def head_bwd_bounds(B: int, V: int, D: int) -> dict:
    """Kernel 10's operation bounds that its design does not run at: its
    three GEMMs as one bf16 product each (below phase 12's accuracy), and
    in f32 on the CUDA cores (the kernel's earlier CUDA-core design)."""
    return {"bound_one_bf16_product_ms": 3 * 2 * B * D * V / PEAK_FLOPS[torch.bfloat16] * 1e3,
            "bound_f32_cuda_cores_ms": (3 * 2 * B * D * V + 10 * B * V)
            / PEAK_FLOPS[torch.float32] * 1e3}


FLASH_LIBRARY = {   # yardsticks only, never called by the port
    "flash_kd_fwd": "kl_div(log_softmax(s / tau), softmax(t / tau), 'batchmean') * tau^2",
    "flash_kd_bwd": "its backward through autograd",
    "flash_kd_head_fwd": "h @ W (+ b), then the kl_div composition",
    "flash_kd_head_bwd": "its backward to h, W (and b) through autograd",
}


def _library_loss(s, t, tau):
    return torch.nn.functional.kl_div(torch.log_softmax(s.float() / tau, -1),
                                      torch.softmax(t.float() / tau, -1),
                                      reduction="batchmean") * tau ** 2


def _ulp(ref):
    return 2.0 ** (torch.floor(torch.log2(ref.float().abs().clamp(min=2.0 ** -126))) - 7)


def flash_check(kd_ops, flash, label, s=None, h=None, w=None, b=None, z=None, tau=4.0,
                lse=True, timed=False) -> dict:
    """One kernel pair (7/8 with ``s``, 9/10 with ``h, w``) against its plain
    versions on the same inputs; returns {name: row} and checks each (see
    the module docstring for the bounds)."""
    head = s is None
    fwd, bwd = ("flash_kd_head_fwd", "flash_kd_head_bwd") if head else ("flash_kd_fwd",
                                                                      "flash_kd_bwd")
    plain = flash_plain(flash)
    tl = kd_ops.teacher_cache_lse(z, tau) if lse else None
    g = torch.tensor(1.5, device=DEV)
    if head:
        fargs = (h, w, b, z, tau)
        got = kd_ops.flash_kd_head_fwd(*fargs, teacher_lse=tl)
        want = plain[fwd](*fargs, teacher_lse=tl)
        bargs = (h, w, b, z, want[1], want[2], g, tau)
    else:
        fargs = (s, z, tau)
        got = kd_ops.flash_kd_fwd(*fargs, teacher_lse=tl)
        want = plain[fwd](*fargs, teacher_lse=tl)
        bargs = (s, z, want[1], want[2], g, tau)
    gk = getattr(kd_ops, bwd)(*bargs)
    gp = plain[bwd](*bargs)
    torch.cuda.synchronize()
    B, V = z.shape
    lse_scale = float(torch.maximum(want[1].abs().max(), want[2].abs().max()))
    loss_err = abs(float(got[0]) - float(want[0]))
    loss_tol = ((FLASH_HEAD_LOSS_RTOL if head else FLASH_LOSS_RTOL) * abs(float(want[0]))
                + ULP_LSE * tau ** 2 * lse_scale)
    lse_err = max(float((a - c).abs().max()) for a, c in zip(got[1:], want[1:]))
    fwd_ok = (loss_err <= loss_tol and bool(got[0].isfinite())
              and all(bool(((a - c).abs() <= FLASH_LSE_RTOL * c.abs() + ULP_LSE * lse_scale)
                           .all()) for a, c in zip(got[1:], want[1:])))
    c = 1.5 * tau / B
    st = (h.float() @ w.float() + (0 if b is None else b.float())) if head else s.float()
    mag = (torch.exp(st / tau - want[1][:, None]) + torch.exp(z.float() / tau - want[2][:, None])) * c
    if head:
        bounds = [mag @ w.float().abs().T, h.float().abs().T @ mag, mag.sum(0)]
        pairs = [(x, y, SUM_TOL * bd) for x, y, bd in zip(gk, gp, bounds) if x is not None]
        bwd_ok = gk[1].stride() == w.stride() and (gk[2] is None) == (b is None)
    else:
        pairs = [(gk, gp, FLASH_GRAD_TOL * mag + c * 2.0 ** -126)]
        bwd_ok = True
    bwd_err = 0.0
    for x, y, bound in pairs:
        bound = bound + (_ulp(y) if x.dtype == torch.bfloat16 else 0)
        diff = (x.float() - y.float()).abs()
        bwd_ok = bwd_ok and x.dtype == y.dtype and bool((diff <= bound).all()) \
            and bool(x.isfinite().all())
        bwd_err = max(bwd_err, float(diff.max()))
    del st, mag
    es = (h if head else s).element_size()
    D = h.shape[1] if head else 0
    case = {"case": label, "shape": [B, D, V] if head else [B, V],
            "dtype": str((h if head else s).dtype).removeprefix("torch."),
            "cache": str(z.dtype).removeprefix("torch."), "teacher_lse": lse,
            "bias": b is not None, "tied": bool(head and w.stride(0) == 1), "tau": tau}
    rows = {fwd: {**case, "kernel": fwd, "max_abs_err": loss_err, "tol": loss_tol,
                  "lse_max_abs_err": lse_err},
            bwd: {**case, "kernel": bwd, "max_abs_err": bwd_err}}
    if timed:
        rows[fwd].update(**kernel_times(lambda: getattr(kd_ops, fwd)(*fargs, teacher_lse=tl)),
                         plain_ms=time_ms(lambda: plain[fwd](*fargs, teacher_lse=tl)))
        rows[bwd].update(**kernel_times(lambda: getattr(kd_ops, bwd)(*bargs)),
                         plain_ms=time_ms(lambda: plain[bwd](*bargs)))
        leaves = [x.detach().requires_grad_(True) for x in ((h, w) if head else (s,))]
        if head and b is not None:
            leaves.append(b.detach().requires_grad_(True))

        def lib_fwd():
            st = (leaves[0] @ leaves[1] + (leaves[2] if len(leaves) > 2 else 0)) if head \
                else leaves[0]
            return _library_loss(st, z, tau)

        with torch.no_grad():
            rows[fwd]["library_ms"] = time_ms(lib_fwd)
        loss = lib_fwd()
        rows[bwd]["library_ms"] = time_ms(lambda: torch.autograd.grad(loss, leaves,
                                                                      retain_graph=True))
        del loss
        for name in (fwd, bwd):
            rows[name]["bound_ms"], rows[name]["bound_by"] = flash_bound(
                name, B, V, D, es, z.element_size(), b is not None, lse)
            rows[name]["library"] = FLASH_LIBRARY[name]
        if head:
            rows[bwd].update(head_bwd_bounds(B, V, D))
    for name in (fwd, bwd):
        print(json.dumps(rows[name]), flush=True)
    check(fwd_ok, f"{fwd} disagrees with its plain version ({label}): {rows[fwd]}")
    check(bwd_ok, f"{bwd} disagrees with its plain version ({label}): {rows[bwd]}")
    return rows


def flash_phase(kd_ops, flash, seed: int) -> dict:
    """Kernels 7-10 against their plain versions; returns the rows timed at
    the LM path's shapes: 512 rows, V = 256,000 (gemma-2b), D = 2,048,
    f32 student or head, bf16 cache with its lse, the tied head."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    timed = {}

    def rnd(shape, scale, dtype=f32):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)

    # kernels 7/8: every (rows, V), both caches, teacher lse on and off
    for B in (1, 5, 512):
        for V in (517, 50304, 256000):
            for cache in (f32, bf16):
                for lse in (True, False):
                    main = (B, V, cache, lse) == (512, 256000, bf16, True)
                    rows = flash_check(kd_ops, flash, f"{B}x{V}", s=rnd((B, V), 3),
                                       z=rnd((B, V), 3, cache), lse=lse, timed=main)
                    if main:
                        timed.update(rows)
    torch.cuda.empty_cache()
    # kernels 9/10 at D = 2,048: the path's options at every (rows, V) ...
    D = 2048
    for V in (517, 50304, 256000):
        embed = rnd((V, D), 0.02)
        for B in (1, 5, 512):
            main = (B, V) == (512, 256000)
            rows = flash_check(kd_ops, flash, f"{B}x{D}x{V} tied", h=rnd((B, D), 1),
                               w=embed.T, z=rnd((B, V), 3, bf16), timed=main)
            if main:
                timed.update(rows)
        del embed
        torch.cuda.empty_cache()
    # ... and every option where it is cheap: untied, bias, f32 cache, no lse
    for B, V in ((5, 50304), (512, 517)):
        for tied in (True, False):
            w = rnd((V, D), 0.02).T if tied else rnd((D, V), 0.02)
            for bias in (False, True):
                for cache in (f32, bf16):
                    for lse in (True, False):
                        flash_check(kd_ops, flash, f"{B}x{D}x{V} options", h=rnd((B, D), 1),
                                    w=w, b=rnd((V,), 0.5) if bias else None,
                                    z=rnd((B, V), 3, cache), lse=lse)
    # a bf16 head and features
    for B, V in ((5, 517), (512, 50304)):
        flash_check(kd_ops, flash, f"{B}x{D}x{V} bf16 head", h=rnd((B, D), 1, bf16),
                    w=rnd((V, D), 0.02, bf16).T, b=rnd((V,), 0.5, bf16), z=rnd((B, V), 3, bf16))
    torch.cuda.empty_cache()
    return timed


# ---------------------------------------------------------------- phase 13
def lm_round_phase(fed, kd_ops, flash, seed: int) -> dict:
    """Returns the launches of the unfused flash run (kernels 7/8's path)."""
    import dataclasses
    from contextlib import nullcontext

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tasks import lm_task
    from repro_torch.utils.pytree import tree_map
    cfg = dataclasses.replace(get_config("gemma-2b").reduced(), vocab_size=50304)
    task = lm_task(cfg, num_clients=8, docs_per_client=8, seq=128, server_batches_n=2,
                   server_batch=4, seed=seed, device=DEV)
    kw = dict(K=4, R=2, num_clients=8, participation=1.0, local_epochs=1, client_batch=4,
              distill_steps=20, client_lr=0.01, server_lr=0.01, seed=seed)
    init = fed.make_runner("fedsdd", task, device=DEV, **kw).init_state().global_models
    runs = {
        "head-fused, kernels": dict(kd_kernel="flash", kd_head_fusion=True,
                                    teacher_cache_dtype="float32"),
        "head-fused, plain": dict(kd_kernel="flash", kd_head_fusion=True,
                                  teacher_cache_dtype="float32"),
        "flash, kernels": dict(kd_kernel="flash", teacher_cache_dtype="float32"),
        "flash, plain": dict(kd_kernel="flash", teacher_cache_dtype="float32"),
        "dense, kernels 2-4": dict(kd_kernel="dense"),
        "head-fused bf16 cache, kernels": dict(kd_kernel="flash", kd_head_fusion=True),
        "head-fused bf16 cache, plain": dict(kd_kernel="flash", kd_head_fusion=True),
        # the same rounds without KD: how far the 20 KD steps a round move the
        # main model, beside the tolerance the pairs below are held to
        "no KD": dict(kd_kernel="flash", distill_steps=0),
    }
    # the client steps must repeat bit for bit (the embedding's backward
    # accumulates with atomics unless asked not to)
    torch.use_deterministic_algorithms(True)
    out = {}
    try:
        for label, opts in runs.items():
            runner = fed.make_runner("fedsdd", task, device=DEV, **{**kw, **opts})
            state = fed.FedState(round=0,
                                 global_models=[tree_map(torch.clone, m) for m in init],
                                 ensemble=fed.TeacherBank(4, 2))
            kernels.launches.clear()
            with plain_flash(kd_ops, flash) if label.endswith("plain") else nullcontext():
                state = runner.run(2, state=state)
            torch.cuda.synchronize()
            out[label] = (state, dict(kernels.launches))
    finally:
        torch.use_deterministic_algorithms(False)
    steps = 2 * kw["distill_steps"]
    summary = {"phase": "f32 LM rounds (gemma-2b reduced, V=50,304), kernels vs plain",
               "tol": ROUND_TOL, "launches": {k: v[1] for k, v in out.items()},
               "kd_change_main_max_abs": {
                   k: _tree_err(v[0].global_models[0], out["no KD"][0].global_models[0])
                   for k, v in out.items() if k.endswith("kernels") or "kernels 2-4" in k}}
    pairs = (("head-fused, kernels", "head-fused, plain"), ("flash, kernels", "flash, plain"),
             ("head-fused bf16 cache, kernels", "head-fused bf16 cache, plain"),
             ("head-fused, kernels", "dense, kernels 2-4"), ("flash, kernels",
                                                            "dense, kernels 2-4"))
    for a, b in pairs:
        sa, sb = out[a][0], out[b][0]
        err = _tree_err(sa.global_models[0], sb.global_models[0])
        rest = all(torch.equal(x, y) for k in range(1, 4) for x, y in
                   zip(_leaves(sa.global_models[k]), _leaves(sb.global_models[k])))
        summary[f"{a} vs {b}"] = {"main_max_abs_err": err, "models_k>0_bit_identical": rest,
                                  "kd_loss_last": [r["kd_loss_last"] for r in sa.history],
                                  "kd_loss_last_other": [r["kd_loss_last"] for r in sb.history]}
    print(json.dumps(summary), flush=True)
    for a, b in pairs:
        sa, sb = out[a][0], out[b][0]
        check(all(torch.allclose(x, y, rtol=ROUND_TOL, atol=ROUND_TOL) for x, y in
                  zip(_leaves(sa.global_models[0]), _leaves(sb.global_models[0]))),
              f"LM rounds: main model, {a} vs {b}, beyond 2e-4")
        check(summary[f"{a} vs {b}"]["models_k>0_bit_identical"],
              f"LM rounds: models k>0 differ between {a} and {b}")
        check(all(bool(x.isfinite().all()) for x in _leaves(sa.global_models[0])),
              f"LM rounds: non-finite main model ({a})")
    want = {"head-fused, kernels": {"flash_kd_head_fwd": steps, "flash_kd_head_bwd": steps},
            "head-fused bf16 cache, kernels": {"flash_kd_head_fwd": steps,
                                               "flash_kd_head_bwd": steps},
            "flash, kernels": {"flash_kd_fwd": steps, "flash_kd_bwd": steps},
            "dense, kernels 2-4": {"ensemble_softmax": 2, "kd_loss_fwd": steps,
                                   "kd_loss_bwd": steps}}
    for label, (_, launches) in out.items():
        check(launches == want.get(label, {}), f"LM rounds ({label}): launches {launches}")
    return out["flash, kernels"][1]


# ---------------------------------------------------------------- phase 14
def _kd_group(name: str) -> str:
    low = name.lower()
    if "head_fwd_kernel" in low or "flash_combine" in low:
        return "flash_kd_head_fwd"
    if "k10::" in low:                  # kernel 10's split, GEMM, bias and reduce passes
        return "flash_kd_head_bwd"
    return "backbone"


# the same profile with kernel 10 on the f32 CUDA cores (PERF.md §5; NVIDIA
# H100 80GB HBM3, 700 W): kernels 9 and 10 of a 140 ms head-fused KD step,
# printed beside this run's for comparison only
CUDA_CORE_KD_STEP = {"device_ms_per_step": 140, "flash_kd_head_fwd": 27 / 140,
                "flash_kd_head_bwd": 82 / 140}


def gemma_phase(fed, seed: int, card: str) -> dict:
    """gemma-2b at full width, 2 of 18 layers, f32: FedSDD with head-fused
    Flash-KD; returns the launches of the run."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tasks import lm_task
    from repro_torch.distill import KDPipeline
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    t0 = time.perf_counter()
    task = lm_task(cfg, num_clients=8, docs_per_client=8, seq=128, server_batches_n=2,
                   server_batch=4, seed=seed, device=DEV)
    steps_kd, tau = 20, 4.0
    # the ring in bf16 (teacher_dtype, the reference's option; the teachers
    # still forward in f32): with an f32 ring, round 2 peaked at 79.1 GB
    # (4 old and 4 new globals, 8 client models and 8 teachers, 2.98 GB each)
    runner = fed.make_runner("fedsdd", task, device=DEV, K=4, R=2, num_clients=8,
                             participation=1.0, client_batch=4, local_epochs=1,
                             distill_steps=steps_kd, client_lr=0.01, server_lr=0.01,
                             temperature=tau, kd_kernel="flash", kd_head_fusion=True,
                             teacher_dtype="bfloat16", seed=seed)
    state = runner.init_state()
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(state.global_models[0]))
    print(f"task and init: {time.perf_counter() - t0:.1f} s; {n_params:,} parameters per "
          f"model ({n_params * 4 / 1e9:.2f} GB f32)", flush=True)
    pipe = runner._kd_pipeline()
    check(pipe.head_fused and pipe.cache_dtype == torch.bfloat16,
          "gemma-2b: the KD pipeline is not head-fused with a bf16 cache")
    cache_s = []
    build_cache = pipe.precompute_cache

    def timed_cache(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = build_cache(*a, **k)
        torch.cuda.synchronize()
        cache_s.append(time.perf_counter() - t)
        return out

    pipe.precompute_cache = timed_cache
    rounds = []
    torch.cuda.synchronize()
    kernels.launches.clear()
    for _ in range(2):
        before = dict(kernels.launches)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = runner.run(1, state=state)
        torch.cuda.synchronize()
        rec = state.history[-1]
        rounds.append({"round": rec["round"], "active": rec["active"],
                       "t_round_s": time.perf_counter() - t0, "t_local_s": rec["t_local"],
                       "t_kd_s": rec["t_kd"], "t_cache_s": cache_s[-1],
                       "kd_steps_per_s": steps_kd / rec["t_kd"],
                       "kd_loss_first": rec["kd_loss_first"], "kd_loss_last": rec["kd_loss_last"],
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": {k: v - before.get(k, 0) for k, v in kernels.launches.items()}})
    launches = dict(kernels.launches)
    pipe.precompute_cache = build_cache
    for r in rounds:
        print(json.dumps({"phase": "gemma-2b FedSDD round, head-fused Flash-KD", "card": card,
                          **r}), flush=True)
    print(json.dumps({"phase": "gemma-2b FedSDD run", "card": card, "rounds": 2,
                      "launches": launches, "teachers": state.ensemble.num_members,
                      "teacher_bank_gb": state.ensemble.nbytes() / 1e9,
                      "cache_mb": pipe.cache_nbytes(state.ensemble.member_views(),
                                                    pipe.batches_for(task.server_batches)) / 1e6,
                      "peak_mem_gb": max(r["peak_mem_gb"] for r in rounds)}), flush=True)
    check(len(state.history) == 2, "gemma-2b: two history records")
    check(all(math.isfinite(r["kd_loss_first"]) and math.isfinite(r["kd_loss_last"])
              for r in rounds), f"gemma-2b: non-finite KD losses {rounds}")
    check(state.ensemble.num_members == 8, "gemma-2b: the ring does not hold 8 teachers")
    check(all(r["launches"].get("flash_kd_head_fwd") == steps_kd
              and r["launches"].get("flash_kd_head_bwd") == steps_kd for r in rounds),
          f"gemma-2b: kernels 9/10 not launched {steps_kd} times a round: {rounds}")
    check(not any(launches.get(k) for k in ("flash_kd_fwd", "flash_kd_bwd", "kd_loss_fwd",
                                            "kd_loss_bwd", "ensemble_softmax")),
          f"gemma-2b: another KD kernel ran: {launches}")
    check(all(bool(x.isfinite().all()) for m in state.global_models for x in _leaves(m)),
          "gemma-2b: non-finite weights")
    check(_tree_err(state.global_models[1], state.global_models[0]) > 0,
          "gemma-2b: model 1 equals the main model")

    # where a KD step's time goes: 5 head-fused steps over the last round's cache
    batches = pipe.batches_for(task.server_batches)
    cache = pipe.precompute_cache(state.ensemble.member_views(), batches)
    pipe5 = KDPipeline(task.logits_fn, steps=5, lr=0.01, temperature=tau, device=DEV,
                       kd_kernel="flash", features_fn=task.features_fn, head_fn=task.head_fn,
                       head_fusion=True)
    student = state.global_models[0]
    pipe5._run(student, batches, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe5._run(student, batches, cache)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe5._run(student, batches, cache)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / 5
    groups = dict.fromkeys(("flash_kd_head_fwd", "flash_kd_head_bwd", "backbone"), 0.0)
    for e in kern:
        groups[_kd_group(e.key)] += e.self_device_time_total / 1e3 / 5
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    share = {k: groups[k] / busy_ms for k in ("flash_kd_head_fwd", "flash_kd_head_bwd")} \
        if kern else None
    print(json.dumps({"phase": "profile: 5 head-fused KD steps, gemma-2b full width, 512 rows",
                      "card": card, "wall_ms_per_step": wall_ms,
                      "device_ms_per_step": busy_ms if kern else None,
                      "idle_share": 1 - busy_ms / wall_ms if kern else None,
                      "device_ms_by_group": groups, "device_share": share,
                      "device_share_cuda_core_kernel_10": CUDA_CORE_KD_STEP,
                      "kernel_launches_per_step": sum(e.count for e in kern) / 5,
                      "top_kernels": [{"name": e.key[:80], "per_step": e.count / 5,
                                       "ms_per_step": e.self_device_time_total / 1e3 / 5}
                                      for e in top]}), flush=True)
    check(bool(kern) and groups["flash_kd_head_fwd"] > 0 and groups["flash_kd_head_bwd"] > 0,
          f"gemma-2b profile: no device time for kernels 9/10: {groups}")
    del state, runner, pipe, pipe5, cache, student, task
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- phase 15
# (name, H, Hkv, dh) of the registered configs at full width
FA_CONFIGS = [("qwen2.5-14b", 40, 8, 128), ("gemma-2b", 8, 1, 256),
              ("stablelm-3b", 32, 32, 80), ("starcoder2-3b", 24, 2, 128)]
FA_SWEEP = [(2, 256, 4, 2, 64), (1, 128, 8, 1, 32), (2, 256, 4, 4, 128)]
FA_MODES = [(True, 0), (True, 64), (False, 0)]
FA_DECODE_SWEEP = [(2, 1024, 4, 2, 64, 700), (1, 512, 8, 1, 32, 512), (2, 512, 4, 4, 128, 1)]
# dh 80 (stablelm-3b: the bf16 kernel pads it to 128) and dh 256 (gemma-2b),
# a ragged Sq below one Pallas block for each
FA_WIDE_HEADS = [(1, 384, 4, 4, 80), (1, 100, 2, 1, 80), (1, 256, 4, 2, 256),
                 (1, 100, 2, 1, 256)]
FA_FULL_S = 4096                      # the configs' forward at full width
FA_WINDOW_CASE = (16384, 4096)        # starcoder2-3b: S, its window
FA_BWD = (4096, 40, 8, 128)           # S, H, Hkv, dh: qwen2.5-14b's width
FA_DECODE = [("bench", 8, 4096, 8, 8, 64, torch.float32),      # label, B, S, H, Hkv, dh
             ("qwen2.5-14b decode_32k", 8, 32768, 40, 8, 128, torch.bfloat16)]


def fa_close(out, ref) -> tuple[float, bool]:
    """f32 at rtol = atol = FA_F32_TOL; bf16 within one bf16 ulp of each
    row's max |plain| plus 2e-5 (both sides round one f32 result once)."""
    out_f, ref_f = out.float(), ref.float()
    err = (out_f - ref_f).abs()
    if ref.dtype == torch.float32:
        ok = bool((err <= FA_F32_TOL + FA_F32_TOL * ref_f.abs()).all())
    else:
        ok = bool((err <= _ulp(ref_f.abs().amax(-1, keepdim=True)) + 2e-5).all())
    return float(err.max()), ok and bool(out_f.isfinite().all())


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def band_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head's band allows."""
    q = torch.arange(Sq, dtype=torch.int64)
    hi = q.clamp(max=Skv - 1) if causal else torch.full_like(q, Skv - 1)
    lo = (q - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())


def fa_forward_bound(q, k, causal: bool, window: int):
    """(bound_ms, bound_by): q, k, v read once and the output written once
    over HBM, vs 4·dh operations per allowed pair and head over the peak
    for the inputs' type (f32 CUDA cores, or bf16 tensor cores)."""
    B, Sq, H, dh = q.shape
    ops = 4 * B * H * band_pairs(Sq, k.shape[1], causal, window) * dh
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fa_decode_bound(q1, k, live: int):
    """(bound_ms, bound_by): the ``live`` K and V rows read once, q read
    and the output written once, vs 4·dh operations per live key and query
    head over the peak for the inputs' type."""
    B, _, H, dh = q1.shape
    Hkv, elt = k.shape[2], q1.element_size()
    nbytes = 2 * B * live * Hkv * dh * elt + 2 * q1.numel() * elt
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * H * live * dh / PEAK_FLOPS[q1.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fa_library(q, k, v, causal: bool, window: int):
    """Yardstick only, never called by the port: scaled_dot_product_attention
    with enable_gqa over (B, H, S, dh) views, and a band mask built once
    when there is a window."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        pos = torch.arange(q.shape[1], device=DEV)
        rel = pos[:, None] - pos[None, :]
        mask = (rel < window) & ((rel >= 0) if causal else True)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def fa_check(label: str, fn, plain, *, bound=None, library=None, plain_reps: int = 25) -> dict:
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    err, ok = fa_close(out, ref)
    del out, ref
    row = {"case": label, "max_abs_err": err}
    if bound is not None:
        row.update(**kernel_times(fn), plain_ms=time_ms(plain, reps=plain_reps),
                   library_ms=time_ms(library) if library else None,
                   bound_ms=bound[0], bound_by=bound[1])
    print(json.dumps(row), flush=True)
    check(ok, f"{label}: kernel disagrees with its plain version, max_abs_err {err}")
    return row


def flash_path(ops, gen) -> dict:
    """The path the JAX package gives kernels 11-12: its kernel bench
    (benchmarks/bench_kernels.py:56-76: a causal forward at B 1, S 1,024,
    8 heads of 64; a decode at B 8, S 4,096, 8 heads of 64, the cache
    full) and its tests (tests/test_kernels.py:88-160: the forward sweep,
    the dtypes, the decode sweep and a gradient), through the public ops.
    Counts are zeroed before and read after; the outputs are then held
    against the plain versions."""
    from repro_torch import kernels
    calls = []
    torch.cuda.synchronize()
    kernels.launches.clear()
    q, k, v = (_rand(gen, (1, 1024, 8, 64), torch.float32) for _ in range(3))
    calls.append(("bench forward", (q, k, v, True, 0), ops.flash_attention(q, k, v, True, 0)))
    q1 = _rand(gen, (8, 1, 8, 64), torch.float32)
    kc, vc = (_rand(gen, (8, 4096, 8, 64), torch.float32) for _ in range(2))
    calls.append(("bench decode", (q1, kc, vc, 4096), ops.flash_decode(q1, kc, vc, 4096)))
    for B, S, H, Hkv, dh in FA_SWEEP:
        for causal, window in FA_MODES:
            q = _rand(gen, (B, S, H, dh), torch.float32)
            k, v = (_rand(gen, (B, S, Hkv, dh), torch.float32) for _ in range(2))
            calls.append((f"sweep {B}x{S}x{H}x{Hkv}x{dh} causal={causal} window={window}",
                          (q, k, v, causal, window), ops.flash_attention(q, k, v, causal, window)))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_rand(gen, (1, 128, 2, 64), dtype) for _ in range(3))
        calls.append((f"dtype {dtype}", (q, k, v, True, 0), ops.flash_attention(q, k, v, True, 0)))
    for B, S, H, Hkv, dh, clen in FA_DECODE_SWEEP:
        q1 = _rand(gen, (B, 1, H, dh), torch.float32)
        kc, vc = (_rand(gen, (B, S, Hkv, dh), torch.float32) for _ in range(2))
        calls.append((f"decode sweep {B}x{S}x{H}x{Hkv}x{dh} len={clen}", (q1, kc, vc, clen),
                      ops.flash_decode(q1, kc, vc, clen)))
    qkv = [_rand(gen, (1, 128, 2, 32), torch.float32).requires_grad_(True) for _ in range(3)]
    (ops.flash_attention(*qkv, True, 0) ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = {n: kernels.launches[n] for n in ("flash_forward", "flash_decode")}
    check(launches["flash_forward"] == 1 + 9 + 2 + 1 and launches["flash_decode"] == 1 + 3,
          f"flash path: launches {launches}")
    worst = 0.0
    for label, args, out in calls:
        plain = (ops.flash_forward_ref(*args[:3], causal=args[3], window=args[4])
                 if len(args) == 5 else ops.flash_decode_ref(*args))
        err, ok = fa_close(out, plain)
        check(ok, f"flash path, {label}: output disagrees with the plain version ({err})")
        worst = max(worst, err)
    ref = [t.detach().clone().requires_grad_(True) for t in qkv]
    (ops.flash_forward_ref(*ref, causal=True) ** 2).sum().backward()
    grad_err = max(float((a.grad - b.grad).abs().max()) for a, b in zip(qkv, ref))
    check(grad_err <= FA_GRAD_TOL, f"flash path: gradient off by {grad_err}")
    print(json.dumps({"phase": "flash kernels' path (reference bench and tests)",
                      "calls": len(calls) + 1, "launches": launches,
                      "max_abs_err": worst, "grad_max_abs_err": grad_err}), flush=True)
    return launches


def flash_attention_phase(ops, seed: int) -> tuple[dict, dict, dict]:
    """Returns (the path's launches, kernel 12's row, kernel 11's row)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    launches = flash_path(ops, gen)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for B, S, H, Hkv, dh in FA_SWEEP + FA_WIDE_HEADS:
            q = _rand(gen, (B, S, H, dh), dtype)
            k, v = (_rand(gen, (B, S, Hkv, dh), dtype) for _ in range(2))
            for causal, window in FA_MODES:
                fa_check(f"flash_forward {B}x{S}x{H}x{Hkv}x{dh} causal={causal} "
                         f"window={window} {name}",
                         lambda: ops.flash_attention(q, k, v, causal, window),
                         lambda: ops.flash_forward_ref(q, k, v, causal=causal, window=window))
    rows = {}
    S = FA_FULL_S
    for cfg_name, H, Hkv, dh in FA_CONFIGS:        # full widths, causal
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q = _rand(gen, (1, S, H, dh), dtype)
            k, v = (_rand(gen, (1, S, Hkv, dh), dtype) for _ in range(2))
            row = fa_check(f"flash_forward {cfg_name} S={S} causal {name}",
                           lambda: ops.flash_attention(q, k, v, True, 0),
                           lambda: ops.flash_forward_ref(q, k, v, causal=True),
                           bound=fa_forward_bound(q, k, True, 0),
                           library=fa_library(q, k, v, True, 0), plain_reps=5)
            if cfg_name == "qwen2.5-14b":
                rows[name] = row
            del q, k, v
    S, W = FA_WINDOW_CASE                          # starcoder2-3b's own window
    q = _rand(gen, (1, S, 24, 128), torch.bfloat16)
    k, v = (_rand(gen, (1, S, 2, 128), torch.bfloat16) for _ in range(2))
    fa_check(f"flash_forward starcoder2-3b S={S} window={W} bfloat16",
             lambda: ops.flash_attention(q, k, v, True, W),
             lambda: ops.flash_forward_ref(q, k, v, causal=True, window=W),
             bound=fa_forward_bound(q, k, True, W),
             library=fa_library(q, k, v, True, W), plain_reps=3)
    del q, k, v
    torch.cuda.empty_cache()

    # one backward at qwen2.5-14b's width: recompute through the plain
    # chunked attention against autograd of the plain version
    S, H, Hkv, dh = FA_BWD
    qkv = [_rand(gen, (1, S, n, dh), torch.float32).requires_grad_(True) for n in (H, Hkv, Hkv)]
    (ops.flash_attention(*qkv, True, 0) ** 2).sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in qkv]
    (ops.flash_forward_ref(*ref, causal=True) ** 2).sum().backward()
    torch.cuda.synchronize()
    errs = [float((a.grad - b.grad).abs().max()) for a, b in zip(qkv, ref)]
    scale = max(float(b.grad.abs().max()) for b in ref)
    print(json.dumps({"case": f"flash_attention backward qwen2.5-14b S={S} f32",
                      "grad_max_abs_err": errs, "grad_max_abs": scale,
                      "tol": FA_GRAD_TOL}), flush=True)
    check(all(e <= FA_GRAD_TOL * max(1.0, scale) for e in errs),
          f"flash_attention backward at qwen width: errors {errs} (scale {scale})")
    del qkv, ref
    torch.cuda.empty_cache()

    dec_row = None
    for label, B, S, H, Hkv, dh, dtype in FA_DECODE:
        name = str(dtype).removeprefix("torch.")
        q1 = _rand(gen, (B, 1, H, dh), dtype)
        kc, vc = (_rand(gen, (B, S, Hkv, dh), dtype) for _ in range(2))
        kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        for clen in (0, 1, 700, S - 1, S):             # 0: no valid position, the mean of V
            timed = clen == S
            row = fa_check(f"flash_decode {label} B={B} S={S} H={H} Hkv={Hkv} dh={dh} "
                           f"cache_len={clen} {name}",
                           lambda: ops.flash_decode(q1, kc, vc, clen),
                           lambda: ops.flash_decode_ref(q1, kc, vc, clen),
                           bound=fa_decode_bound(q1, kc, clen) if timed else None,
                           library=(lambda: torch.nn.functional.scaled_dot_product_attention(
                               q1.transpose(1, 2), kt, vt, enable_gqa=True)) if timed else None)
            if timed and label != "bench":
                dec_row = row
        del q1, kc, vc, kt, vt
    torch.cuda.empty_cache()
    # kernel 12's entry: the bf16 row (every config's dtype), f32 beside it
    fwd_row = {**rows["bfloat16"],
               "f32": {key: rows["float32"][key] for key in
                       ("ms", "plain_ms", "library_ms", "bound_ms")}}
    return launches, fwd_row, dec_row


# ---------------------------------------------------------- phases 16-17
LONG_PROMPT = 20480          # > 4·window and a multiple of 512: block-local prefill


def starcoder_f32_phase(serve, zoo, ops, get_config, seed: int) -> None:
    """starcoder2-3b at full width, 2 layers, f32: engine == static within
    the window; one 20,480-token prompt, prefilled through
    sliding_attention, served through kernel 1 and through its plain
    version with identical tokens."""
    import dataclasses
    from unittest import mock

    from repro_torch import kernels
    cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    model = zoo.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed, device=DEV)
    rng = np.random.default_rng(seed)
    reqs = make_requests(serve.Request, cfg.vocab_size, 6, rng,
                         (16, min(1000, cfg.sliding_window // 4)), (4, 24))
    check(all(len(r.tokens) + r.max_new_tokens <= cfg.sliding_window for r in reqs),
          "starcoder2 f32: a request outgrows the window")
    engine = serve.ContinuousEngine(model, params, max_batch=4, num_blocks=400,
                                    block_size=16, max_seq_len=1040, chunk_steps=4)
    kernels.launches.clear()
    results, _ = drive(engine, reqs)
    launches = kernels.launches["paged_decode"]
    got = {r.rid: r.tokens for r in results}
    for r in reqs:
        ref = serve.generate_static(model, params, r.tokens[None], r.max_new_tokens)[0]
        check(got[r.rid] == ref.cpu().tolist(),
              f"starcoder2 f32: request {r.rid} engine {got[r.rid]} != static {ref.tolist()}")
    check(launches == cfg.num_layers * engine.steps,
          f"starcoder2 f32: {launches} launches for {engine.steps} micro-steps")

    long = serve.Request(rid=99, tokens=rng.integers(0, cfg.vocab_size, LONG_PROMPT)
                         .astype(np.int32), max_new_tokens=6)
    long_tokens = {}
    for label, fn in (("kernel", ops.paged_decode), ("plain", ops.paged_decode_ref)):
        eng = serve.ContinuousEngine(model, params, max_batch=1,
                                     num_blocks=LONG_PROMPT // 16 + 4,
                                     block_size=16, max_seq_len=LONG_PROMPT + 16, chunk_steps=4)
        calls = []
        real = zoo.attn.sliding_attention
        with mock.patch.object(ops, "paged_decode", fn), \
                mock.patch.object(zoo.attn, "sliding_attention",
                                  lambda *a, **k: calls.append(1) or real(*a, **k)):
            long_tokens[label] = eng.run([long])[0].tokens
        check(len(calls) == cfg.num_layers,
              f"starcoder2 f32: the long prefill took sliding_attention {len(calls)} times")
    check(long_tokens["kernel"] == long_tokens["plain"],
          f"starcoder2 f32, {LONG_PROMPT}-token prompt: kernel {long_tokens['kernel']} "
          f"!= plain {long_tokens['plain']}")
    print(json.dumps({"phase": "starcoder2-3b f32 depth 2, full width", "requests": len(reqs),
                      "identical_tokens": True, "paged_decode_launches": launches,
                      "micro_steps": engine.steps, "long_prompt": LONG_PROMPT,
                      "long_tokens_kernel_eq_plain": True,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    del engine, params, model
    torch.cuda.empty_cache()


def starcoder_serve_phase(serve, zoo, get_config, seed: int, card: str) -> None:
    """starcoder2-3b as configured (30 layers, bf16, random weights made on
    the card): ContinuousEngine serves 8 requests, prompts of 32-2,048
    tokens and one of 20,480; then where the time goes: one decode chunk
    with every lane busy under torch.profiler, and the long prefill with
    its sliding_attention calls timed apart."""
    from unittest import mock

    from repro_torch import kernels
    cfg = get_config("starcoder2-3b")
    model = zoo.build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=DEV)
    torch.cuda.synchronize()
    print(f"init: {serve.pool_bytes(params) / 1e9:.2f} GB of {cfg.param_dtype} weights "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(seed)
    engine = serve.ContinuousEngine(model, params, max_batch=8, num_blocks=2600,
                                    block_size=16, max_seq_len=max(LONG_PROMPT, 2048) + 64,
                                    chunk_steps=8)
    drive(engine, make_requests(serve.Request, cfg.vocab_size, 2, rng, (32, 64), (8, 8)))
    reqs = make_requests(serve.Request, cfg.vocab_size, 7, rng, (32, 2048), (8, 64))
    reqs.append(serve.Request(rid=7, tokens=rng.integers(0, cfg.vocab_size, LONG_PROMPT)
                              .astype(np.int32), max_new_tokens=32))
    steps0 = engine.steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t0 = time.perf_counter()
    results, _ = drive(engine, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, micro = kernels.launches["paged_decode"], engine.steps - steps0
    by_rid = {r.rid: r for r in results}
    check(len(results) == len(reqs), f"starcoder2: {len(results)} results for {len(reqs)}")
    for r in reqs:
        check(not by_rid[r.rid].cancelled and len(by_rid[r.rid].tokens) == r.max_new_tokens,
              f"starcoder2: request {r.rid}: {len(by_rid[r.rid].tokens)} tokens")
    check(engine.alloc.used_blocks == 0 and engine.reserved_tokens == 0,
          "starcoder2: pool not free after the drain")
    check(launches > 0 and launches == cfg.num_layers * micro,
          f"starcoder2: {launches} paged_decode launches for {micro} micro-steps x "
          f"{cfg.num_layers}")
    ntok = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft for r in results)
    long = by_rid[7]
    print(json.dumps({"phase": "starcoder2-3b bf16 full depth, full width", "card": card,
                      "requests": len(results), "generated_tokens": ntok,
                      "prompt_tokens": int(sum(len(r.tokens) for r in reqs)),
                      "wall_s": wall, "tokens_per_s": ntok / wall,
                      "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
                      "long_prefill_s": long.t_first - long.t_admit,
                      "micro_steps": micro, "paged_decode_launches": launches,
                      "launches_per_micro_step": launches / micro,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    print(json.dumps(profile_chunk(engine, serve, cfg.vocab_size, rng, 2360)), flush=True)

    spent = [0.0]
    real = zoo.attn.sliding_attention

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out

    toks = torch.from_numpy(reqs[-1].tokens[None]).to(DEV)
    with mock.patch.object(zoo.attn, "sliding_attention", timed), torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, last=[LONG_PROMPT - 1])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    print(json.dumps({"phase": f"starcoder2-3b prefill of {LONG_PROMPT} tokens", "card": card,
                      "prefill_s": prefill_s, "sliding_attention_s": spent[0],
                      "sliding_attention_share": spent[0] / prefill_s}), flush=True)
    del engine, params, model
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    # cuBLAS repeats its sums bit for bit under phase 13's deterministic
    # algorithms only with a fixed workspace; set before the first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found: run from a checkout "
              f"of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch import serve
    from repro_torch.core import fedsdd as fed
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.kd_loss import ref as kd_ref
    from repro_torch.kernels.weight_avg import ops as wa_ops
    from repro_torch.kernels.weight_avg import ref as wa_ref

    phase("1. card")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase("2. build")
    secs = build.build_all()
    for name, s in secs.items():
        print(f"built {name} in {s:.1f} s", flush=True)
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print("  " + line.strip(), flush=True)
    sass_phase(build)

    phase("3. paged_decode vs plain")
    starcoder_rows = kernel_phase(ops, args.seed)

    phase("4. qwen2.5-14b full width, f32, 2 layers: engine == static")
    f32_depth2_phase(serve, zoo, get_config, args.seed)

    phase("5. qwen2.5-14b full width, bf16, 48 layers: serve 16 requests")
    entry = serve_phase(serve, zoo, ops, get_config, args.seed, card)
    # kernel 1 at the starcoder2-3b cases its split-K was designed for
    entry["starcoder2_ms"] = {case: starcoder_rows[case]["ms"] for case in STARCODER_TIMED}

    torch.cuda.empty_cache()

    phase("6. KD kernels vs plain")
    kd_phase(kd_ops, kd_ref, args.seed)

    phase("7. f32 ResNet-20 FedSDD round: kernels vs plain")
    f32_round_phase(fed, kd_ops, kd_ref, args.seed)

    phase("8. ResNet-56 FedSDD, K=4 R=2, 2 rounds at full depth and width")
    kd_entries, seq_rounds = resnet56_phase(fed, kd_ops, kd_ref, args.seed, card)

    phase("9. weight_avg (kernels 5 and 6) vs plain")
    single = weight_avg_phase(wa_ops, wa_ref, args.seed)

    phase("10. f32 CNN FedSDD round: vectorized vs sequential engine")
    vectorized_cnn_phase(fed, args.seed)

    phase("11. ResNet-56 FedSDD, K=4 R=2, 2 rounds on the vectorized engine")
    wa_entry, vec_launches = resnet56_vectorized_phase(fed, wa_ops, wa_ref, args.seed, card,
                                                       seq_rounds)
    single_entry = {"name": "weighted_average", "route": "cuda", "source": WA_SOURCE,
                    "replaces": WA_TPU["weighted_average"],
                    "launches": vec_launches.get("weighted_average", 0),
                    "max_abs_err": single["max_abs_err"], "ms": single["ms"],
                    "host_ms": single["host_ms"],
                    "plain_ms": single["plain_ms"], "bound_ms": single["bound_ms"],
                    "bound_by": single["bound_by"], "library_ms": single["library_ms"]}

    phase("12. Flash-KD kernels (7-10) vs plain")
    from repro_torch.kernels.kd_loss import flash
    flash_rows = flash_phase(kd_ops, flash, args.seed)

    phase("13. f32 LM FedSDD rounds (gemma-2b reduced, V = 50,304): kernels vs plain")
    unfused_launches = lm_round_phase(fed, kd_ops, flash, args.seed)

    phase("14. gemma-2b full width, FedSDD with head-fused Flash-KD")
    fused_launches = gemma_phase(fed, args.seed, card)
    path_launches = {**unfused_launches, **fused_launches}
    flash_entries = [{"name": name, "route": "cuda", "source": FLASH_SOURCE,
                      "replaces": FLASH_TPU[name], "launches": path_launches.get(name, 0),
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"], "host_ms": r["host_ms"],
                      "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]} for name, r in flash_rows.items()]
    check(all(e["launches"] > 0 for e in flash_entries),
          f"a Flash-KD kernel did not run on its path: {path_launches}")

    phase("15. flash attention kernels (11-12) vs plain")
    fa_launches, fwd_row, dec_row = flash_attention_phase(ops, args.seed)
    fa_entries = [{"name": name, "route": "cuda", "source": FA_SOURCE, "replaces": FA_TPU[name],
                   "launches": fa_launches[name], "max_abs_err": r["max_abs_err"],
                   "ms": r["ms"], "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                   "case": r["case"],
                   **({"f32": r["f32"]} if "f32" in r else {})}
                  for name, r in (("flash_forward", fwd_row), ("flash_decode", dec_row))]

    phase("16. starcoder2-3b full width, f32, 2 layers: engine == static, long prompt")
    starcoder_f32_phase(serve, zoo, ops, get_config, args.seed)

    phase("17. starcoder2-3b full width, bf16, 30 layers: serve 8 requests")
    starcoder_serve_phase(serve, zoo, get_config, args.seed, card)

    phase("18. kernels")
    print(f"total {time.perf_counter() - T_START:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [entry, *kd_entries, wa_entry, single_entry,
                                  *flash_entries, *fa_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
