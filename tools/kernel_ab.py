#!/usr/bin/env python3
"""Kernels 1 (paged_decode), 2 (ensemble_softmax), 3 (kd_loss_fwd), 4
(kd_loss_bwd), 5 (multi_weighted_average), 9 (flash_kd_head_fwd), 10
(flash_kd_head_bwd), 11 (flash_decode) and 12 (flash_forward) of two
checkouts, timed with one timer on one card.

    python3 tools/kernel_ab.py --parent DIR   # DIR, this checkout, this checkout, DIR
    python3 tools/kernel_ab.py --tree DIR     # one checkout's times
    python3 tools/kernel_ab.py --kd-plans     # kernels 3 and 4 of this checkout under other plans
    python3 tools/kernel_ab.py --ens-plans [DIR]  # kernel 2 of DIR (this checkout), other plans

Each tree runs in a process of its own, which imports ``repro_torch`` from
``DIR/src`` (and so builds that tree's kernels from its own sources into
``DIR/build``) and times its wrappers with this checkout's
``chip_smoke.time_call``: the device ms and the host ms of one call.  The
cases are chip_smoke.py's: kernel 1 at starcoder2-3b's decode shape with
its window and without and at qwen2.5-14b's serve lengths, bf16; kernels 3
and 4 at the FedSDD round's KD step (B 256, V 10, f32, tau 4) and at LM
vocabularies, Qwen2.5's (256 x 152,064) and gemma-2b's (512 x 256,000), f32
and bf16; kernel 12 at qwen2.5-14b's width, S 4,096, causal, bf16 and f32,
and starcoder2-3b's window at S 16,384, bf16; kernel 11 at qwen2.5-14b's
`decode_32k` (B 8, S 32,768, 40 heads over 8 of 128, bf16) and the
reference bench's decode (B 8, S 4,096, 8 heads of 64, f32); kernels 9 and
10 at gemma-2b's KD step (512 x 2,048 x 256,000, tied head, f32, bf16 cache
with its lse); kernel 2 at the FedSDD round's teacher cache (M 8, N 2,048,
V 10) and at M x N of 4 x 256 and 8 x 512 over those two vocabularies, f32
and bf16; kernel 5 through ``group_weighted_average_pytree`` over
ResNet-56's tree (169 leaves) at G 4, N 2, f32 and bf16, the FedSDD
round's Eq. 2 (one launch a leaf before the tree launch), and kernels 5 and
6 on one tensor of odd D at chip_smoke.py phase 9's (4, 8, 16,777,219) and
(32, 16,777,219).  Prints the
card's name and power limit, then one JSON line per tree, which also holds
the device ms of the launches of one call of kernels 2 (at 8 x 2,048 x 10),
3 (at 256 x 10 and 512 x 256,000), 5 (f32), 9 and 10 under torch.profiler
(no L2 flush), by kernel name.  ``--kd-plans`` times kernels 3 and 4 at
the LM shapes with ``kd_plan``'s other choices passed to the launcher:
clusters up to 16 CTAs and other shares of shared memory a CTA;
``--ens-plans`` does the same for kernel 2 (``ensemble_plan``) at the
round's and the LM shapes, of this checkout or of ``DIR`` (a copy with a
constant changed).  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
QWEN_SERVE_LENS = [456, 412, 504, 441, 98, 84, 340, 552]   # phase 5's busiest decode chunk
KD_ROUND = (256, 10)                    # the FedSDD round's KD step (ResNet-56, CIFAR-10)
KD_LM = [(256, 152064), (512, 256000)]  # Qwen2.5's and gemma-2b's vocabularies
ENSEMBLE = [(8, 2048, 10), (4, 256, 152064), (8, 512, 256000)]  # kernel 2: M, N, V


def pass_times(fn) -> dict:
    """{kernel name: device ms, launches} of one call of ``fn``, profiled
    after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:160]: {"ms": e.self_device_time_total / 1e3, "launches": e.count}
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def kd_inputs(gen, B: int, V: int, dtype):
    """Student logits (B, V) in ``dtype`` and teacher probabilities, as phase 6 makes them."""
    import torch
    s = (torch.randn((B, V), generator=gen, device="cuda") * 3).to(dtype)
    return s, torch.softmax(torch.randn((B, V), generator=gen, device="cuda") * 2, -1)


def kd_plans(seed: int) -> dict:
    """Kernels 3 and 4 of this checkout at the LM shapes under kd_plan's
    choices: the default, clusters up to 16 CTAs and other shares of shared
    memory a CTA."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.kd_loss import ops as kd_ops
    build.build_all(["kd_loss"])
    lib = kd_ops._lib()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.tensor(1.5, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    variants = {"default": {}, "cluster<=16": {"cluster_max": 16},
                "cluster<=16, share 72 KB": {"cluster_max": 16, "share": 72 * 1024},
                "share 227 KB": {"share": kd_ops.KD_SMEM_MAX}}
    out = {"tree": str(ROOT)}
    for B, V in KD_LM:
        for dtype in (torch.float32, torch.bfloat16):
            s, t = kd_inputs(gen, B, V, dtype)
            want = kd_ops.kd_loss_fwd(s, t, 4.0)
            buf = torch.empty((B + 1,), device="cuda")
            grad = torch.empty_like(s)
            for label, kw in variants.items():
                p = kd_ops.kd_plan(B, V, s.element_size(), **kw)
                args = (*kd_ops.kd_plan_args(p), kd_ops._DTYPES[dtype], stream)

                def fwd():
                    build.check(lib, lib.kd_loss_fwd(s.data_ptr(), t.data_ptr(), buf.data_ptr(),
                                                     B, V, 0.25, 16.0 / B, *args), "kd_loss_fwd")

                def bwd():
                    build.check(lib, lib.kd_loss_bwd(s.data_ptr(), t.data_ptr(), g.data_ptr(),
                                                     grad.data_ptr(), B, V, 0.25, 4.0 / B, *args),
                                "kd_loss_bwd")

                fwd()
                torch.cuda.synchronize()
                row = {"cluster": p["cluster"], "smem": p["smem"],
                       "rel_err": abs(float(buf[B]) / float(want) - 1),
                       "k3_ms": cs.time_call(fwd)[0], "k4_ms": cs.time_call(bwd)[0]}
                out[f"{B}x{V} {str(dtype).removeprefix('torch.')} {label}"] = row
            del s, t, grad
            torch.cuda.empty_cache()
    return out


def ens_plans(tree: Path, seed: int) -> dict:
    """Kernel 2 of ``tree`` at the FedSDD round's and the LM shapes under
    ensemble_plan's choices: the default, the portable clusters of up to 8
    CTAs and other shares of shared memory a CTA (the same plan at V 10);
    each variant's largest difference from the default's output."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.kd_loss import ops as kd_ops
    build.build_all(["kd_loss"])
    lib = kd_ops._lib()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stream = torch.cuda.current_stream().cuda_stream
    variants = {"default": {}, "cluster<=8": {"cluster_max": 8},
                "share 72 KB": {"share": 72 * 1024},
                "share 227 KB": {"share": kd_ops.KD_SMEM_MAX}}
    out = {"tree": str(tree)}
    for M, N, V in ENSEMBLE:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((M, N, V), generator=gen, device="cuda") * 3).to(dtype)
            want = kd_ops.ensemble_softmax(x, 4.0)
            got = torch.empty_like(want)
            for label, kw in variants.items():
                p = kd_ops.ensemble_plan(M, N, V, x.element_size(), **kw)
                args = (*kd_ops.ensemble_plan_args(p), kd_ops._DTYPES[dtype], stream)

                def run():
                    build.check(lib, lib.ensemble_softmax(x.data_ptr(), got.data_ptr(), M, N, V,
                                                          0.25, *args), "ensemble_softmax")

                run()
                torch.cuda.synchronize()
                out[f"{M}x{N}x{V} {str(dtype).removeprefix('torch.')} {label}"] = {
                    "cluster": p["cluster"], "smem": p["smem"],
                    "max_abs_diff": float((got - want).abs().max()),
                    "k2_ms": cs.time_call(run)[0]}
            del x, want, got
            torch.cuda.empty_cache()
    return out


def time_tree(tree: Path, seed: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.kd_loss import ops as kd_ops
    assert Path(ops.__file__).resolve().is_relative_to(tree.resolve()), ops.__file__
    from repro_torch.configs.resnet_cifar import get_resnet_config
    from repro_torch.kernels.weight_avg import ops as wa_ops
    from repro_torch.models.resnet import init_resnet
    from repro_torch.utils.pytree import tree_map
    build.build_all(["paged_decode", "flash_attention", "flash_kd", "kd_loss", "weight_avg"])
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
    tl = kd_ops.teacher_cache_lse(z, tau)
    g = torch.tensor(1.5, device="cuda")

    def k9():
        return kd_ops.flash_kd_head_fwd(h, embed.T, None, z, tau, teacher_lse=tl)

    def k10():
        return kd_ops.flash_kd_head_bwd(h, embed.T, None, z, lse_s, lse_t, g, tau)

    record(f"k9 {B}x{D}x{V} tied bf16 cache", k9)
    _, lse_s, lse_t = k9()
    record(f"k10 {B}x{D}x{V} tied bf16 cache", k10)
    out["k9 passes"], out["k10 passes"] = pass_times(k9), pass_times(k10)
    del embed, h, z, tl, lse_s, lse_t
    torch.cuda.empty_cache()
    for (B, V), dtype in [(KD_ROUND, torch.float32)] + [(c, d) for c in KD_LM
                                                         for d in (torch.float32, bf16)]:
        s, t = kd_inputs(gen, B, V, dtype)
        name = f"{B}x{V} {str(dtype).removeprefix('torch.')}"
        record(f"k3 {name}", lambda: kd_ops.kd_loss_fwd(s, t, 4.0))
        record(f"k4 {name}", lambda: kd_ops.kd_loss_bwd(s, t, g, 4.0))
        if dtype == torch.float32 and (B, V) in (KD_ROUND, KD_LM[-1]):
            out[f"k3 {name} passes"] = pass_times(lambda: kd_ops.kd_loss_fwd(s, t, 4.0))
        del s, t
    torch.cuda.empty_cache()
    for (M, N, V), dtype in [(c, d) for c in ENSEMBLE for d in (torch.float32, bf16)]:
        x = (torch.randn((M, N, V), generator=gen, device="cuda") * 3).to(dtype)
        name = f"{M}x{N}x{V} {str(dtype).removeprefix('torch.')}"
        record(f"k2 {name}", lambda: kd_ops.ensemble_softmax(x, 4.0))
        if dtype == torch.float32 and V == 10:
            out[f"k2 {name} passes"] = pass_times(lambda: kd_ops.ensemble_softmax(x, 4.0))
        del x
    torch.cuda.empty_cache()
    for shape in [(4, 8, 16_777_219), (32, 16_777_219)]:   # chip_smoke.py phase 9's
        for dtype in (torch.float32, bf16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randint(1, 40, shape[:-1], generator=gen, device="cuda").float()
            k, fn = (("k6", wa_ops.weighted_average) if len(shape) == 2
                     else ("k5", wa_ops.group_weighted_average))
            record(f"{k} {'x'.join(map(str, shape))} {str(dtype).removeprefix('torch.')}",
                   lambda: fn(x, w))
            del x
    torch.cuda.empty_cache()
    params = init_resnet(torch.Generator(device="cuda").manual_seed(seed),
                         get_resnet_config("resnet56"))
    w = torch.randint(1, 7000, (4, 2), generator=gen, device="cuda").float()
    for dtype in (torch.float32, bf16):
        stack = tree_map(lambda p: torch.randn((4, 2) + tuple(p.shape), generator=gen,
                                               device="cuda").to(dtype), params)
        name = f"k5 resnet56 tree G=4 N=2 {str(dtype).removeprefix('torch.')}"
        record(name, lambda: wa_ops.group_weighted_average_pytree(stack, w))
        if dtype == torch.float32:
            out[f"{name} passes"] = pass_times(
                lambda: wa_ops.group_weighted_average_pytree(stack, w))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--parent", type=Path, help="the other checkout: runs it, this, this, it")
    group.add_argument("--tree", type=Path, help="time one checkout")
    group.add_argument("--kd-plans", action="store_true",
                       help="kernels 3 and 4 of this checkout under kd_plan's other choices")
    group.add_argument("--ens-plans", nargs="?", const=ROOT, type=Path, metavar="DIR",
                       help="kernel 2 of DIR (default this checkout) under ensemble_plan's "
                            "other choices")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(time_tree(args.tree, args.seed)), flush=True)
        return 0
    if args.ens_plans:
        print(json.dumps(ens_plans(args.ens_plans, args.seed)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.kd_plans:
        print(json.dumps(kd_plans(args.seed)), flush=True)
        return 0
    for tree in (args.parent, ROOT, ROOT, args.parent):
        subprocess.run([sys.executable, __file__, "--tree", str(tree), "--seed",
                        str(args.seed)], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
