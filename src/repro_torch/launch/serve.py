"""Serving CLI over ``repro_torch.serve`` — static oracle or continuous
batching (port of ``repro/launch/serve.py``).

  # static batch: one prefill + a loop of decode steps
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --prompt-len 64 --decode-steps 32 --batch 4

  # continuous batching: paged KV pool + Poisson arrivals
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
      --continuous --num-requests 16 --rate 50

Like the reference, it serves the arch's ``reduced()`` variant.  Runs on
``--device`` (default cuda; no GPU is an error, not a fallback).  The
continuous path needs an all-GQA schedule (paged KV blocks have a sequence
axis per KV head; MLA's latent cache and the recurrent states do not):
deepseek-v2-lite-16b, xlstm-1.3b and jamba-1.5-large-398b serve through
the static path, and ``--continuous`` raises the reference's
``ValueError``.  The recurrent families' static batch needs
``--prompt-len + --decode-steps`` a multiple of the reduced chunk (16).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.data.synthetic import make_model_batch
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import ContinuousEngine, Request, generate_static, run_closed_loop


def _load_npz(path: str, like, device):
    """Restore a ``repro.fedckpt`` npz checkpoint (leaf keys joined by
    ``§``, bf16 stored as f32) into the structure of ``like``."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, prefix + (str(i),)) for i, v in enumerate(tree)]
        arr = data["§".join(prefix)]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"shape mismatch for {prefix}: {arr.shape} vs {tuple(tree.shape)}")
        return torch.from_numpy(arr).to(device=device, dtype=tree.dtype)

    return walk(like, ())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=list_configs())
    ap.add_argument("--ckpt", default=None, help="npz checkpoint to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV pool")
    ap.add_argument("--num-requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only: no decode")
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    if args.ckpt:
        params = _load_npz(args.ckpt, params, params["embed"].device)

    def sync():
        if params["embed"].is_cuda:
            torch.cuda.synchronize()

    if not args.continuous:
        toks = make_model_batch(cfg, args.batch, args.prompt_len, seed=args.seed)["tokens"]
        t0 = time.perf_counter()
        out = generate_static(model, params, toks, args.decode_steps).cpu().numpy()
        dt = time.perf_counter() - t0
        n = args.decode_steps * args.batch
        print(f"static: {n} tokens in {dt:.2f}s ({n / max(dt, 1e-9):.1f} tok/s)")
        for b in range(min(args.batch, 2)):
            print(f"  seq{b}: {out[b][:16].tolist()}...")
        return

    rng = np.random.default_rng(args.seed)
    prompts = make_model_batch(cfg, args.num_requests, args.prompt_len,
                               seed=args.seed)["tokens"]
    reqs = [Request(rid=i, tokens=prompts[i],
                    max_new_tokens=int(rng.integers(4, args.decode_steps + 1)))
            for i in range(args.num_requests)]
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.num_requests))
    engine = ContinuousEngine(
        model, params, max_batch=args.batch, num_blocks=args.num_blocks,
        block_size=args.block_size,
        max_seq_len=args.prompt_len + args.decode_steps)
    sync()
    t0 = time.perf_counter()
    results = run_closed_loop(engine, reqs, arrivals)
    sync()
    dt = time.perf_counter() - t0
    lat = sorted(r.latency for r in results)
    n = sum(len(r.tokens) for r in results)
    print(f"continuous: {len(results)} requests, {n} tokens in {dt:.2f}s "
          f"({n / max(dt, 1e-9):.1f} tok/s)")
    print(f"  latency p50={lat[len(lat) // 2] * 1e3:.1f}ms "
          f"p99={lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3:.1f}ms  "
          f"engine steps={engine.steps}")


if __name__ == "__main__":
    main()
