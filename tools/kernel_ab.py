#!/usr/bin/env python3
"""Kernels 1 (paged_decode), 10 (flash_kd_head_bwd), 11 (flash_decode) and
12 (flash_forward) of two checkouts, timed with one timer on one card.

    python3 tools/kernel_ab.py --parent DIR   # DIR, this checkout, this checkout, DIR
    python3 tools/kernel_ab.py --tree DIR     # one checkout's times

Each tree runs in a process of its own, which imports ``repro_torch`` from
``DIR/src`` (and so builds that tree's kernels from its own sources into
``DIR/build``) and times its wrappers with this checkout's
``chip_smoke.time_call``: the device ms and the host ms of one call.  The
cases are chip_smoke.py's: kernel 1 at starcoder2-3b's decode shape with
its window and without and at qwen2.5-14b's serve lengths, bf16; kernel 12
at qwen2.5-14b's width, S 4,096, causal, bf16 and f32, and starcoder2-3b's
window at S 16,384, bf16; kernel 11 at qwen2.5-14b's `decode_32k` (B 8, S
32,768, 40 heads over 8 of 128, bf16) and the reference bench's decode (B
8, S 4,096, 8 heads of 64, f32); kernel 10 at gemma-2b's KD step (512 x
2,048 x 256,000, tied head, f32, bf16 cache).  Prints the card's name and
power limit, then one JSON line per tree.  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
QWEN_SERVE_LENS = [456, 412, 504, 441, 98, 84, 340, 552]   # phase 5's busiest decode chunk


def time_tree(tree: Path, seed: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.kd_loss import ops as kd_ops
    assert Path(ops.__file__).resolve().is_relative_to(tree.resolve()), ops.__file__
    build.build_all(["paged_decode", "flash_attention", "flash_kd"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    out = {"tree": str(tree)}

    def record(label, fn):
        ms, host_ms = cs.time_call(fn)
        out[label] = {"ms": ms, "host_ms": host_ms}

    sc2 = cs.paged_case(gen, B=8, Hkv=2, G=12, dh=128, bs=16, lens=cs.STARCODER_LENS,
                        dtype=bf16)
    record("k1 starcoder2 bf16 window=4096",
           lambda: ops.paged_decode(*sc2, window=cs.STARCODER_WINDOW))
    record("k1 starcoder2 bf16", lambda: ops.paged_decode(*sc2, window=0))
    qwen = cs.paged_case(gen, B=8, Hkv=8, G=5, dh=128, bs=16, lens=QWEN_SERVE_LENS, dtype=bf16)
    record("k1 qwen serve lens bf16", lambda: ops.paged_decode(*qwen, window=0))
    del sc2, qwen
    for dtype in (bf16, torch.float32):
        q = cs._rand(gen, (1, cs.FA_FULL_S, 40, 128), dtype)
        k, v = (cs._rand(gen, (1, cs.FA_FULL_S, 8, 128), dtype) for _ in range(2))
        record(f"k12 qwen S={cs.FA_FULL_S} causal {str(dtype).removeprefix('torch.')}",
               lambda: ops.flash_attention(q, k, v, True, 0))
        del q, k, v
    S, W = cs.FA_WINDOW_CASE
    q = cs._rand(gen, (1, S, 24, 128), bf16)
    k, v = (cs._rand(gen, (1, S, 2, 128), bf16) for _ in range(2))
    record(f"k12 starcoder2 S={S} window={W} bfloat16",
           lambda: ops.flash_attention(q, k, v, True, W))
    del q, k, v
    for label, B, S, H, Hkv, dh, dtype in cs.FA_DECODE:
        q1 = cs._rand(gen, (B, 1, H, dh), dtype)
        kc, vc = (cs._rand(gen, (B, S, Hkv, dh), dtype) for _ in range(2))
        record(f"k11 {label} {str(dtype).removeprefix('torch.')}",
               lambda: ops.flash_decode(q1, kc, vc, S))
        del q1, kc, vc
    torch.cuda.empty_cache()
    B, D, V, tau = 512, 2048, 256000, 4.0
    embed = torch.randn((V, D), generator=gen, device="cuda") * 0.02
    h = torch.randn((B, D), generator=gen, device="cuda")
    z = (torch.randn((B, V), generator=gen, device="cuda") * 3).to(bf16)
    _, lse_s, lse_t = kd_ops.flash_kd_head_fwd(h, embed.T, None, z, tau,
                                               teacher_lse=kd_ops.teacher_cache_lse(z, tau))
    g = torch.tensor(1.5, device="cuda")
    record(f"k10 {B}x{D}x{V} tied bf16 cache",
           lambda: kd_ops.flash_kd_head_bwd(h, embed.T, None, z, lse_s, lse_t, g, tau))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--parent", type=Path, help="the other checkout: runs it, this, this, it")
    group.add_argument("--tree", type=Path, help="time one checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(time_tree(args.tree, args.seed)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in (args.parent, ROOT, ROOT, args.parent):
        subprocess.run([sys.executable, __file__, "--tree", str(tree), "--seed",
                        str(args.seed)], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
