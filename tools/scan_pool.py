#!/usr/bin/env python3
"""The scan mode's CUDA-graph memory pool against a model's depth.

    python3 tools/scan_pool.py [--layers 1 2 4 8] [--seed N]

For gemma-2b at full width in f32 (chip_smoke.py phase 14's model and
step shapes: client batches of 4 x 128 tokens, 2 server batches of 4 x 128,
head-fused Flash-KD with the bf16 cache, the ring in bf16) at each depth:
a fresh runner (fedsdd, 4 clients, K=2, R=2) runs one round under the
card's default step mode, "scan", which captures the sequential client
step and the KD step into the runner's one graph pool.  Prints the card's
name and power limit, then one JSON line a depth: the model's f32 bytes,
the pool's bytes after the round (the caching allocator's segments in
CUDA graphs' private pools), the pool over the model, the round's peak
allocation, and the captures.  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def pool_bytes() -> int:
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def depth(layers: int, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import fedsdd as fed
    from repro_torch.core.step_graph import captures
    from repro_torch.core.tasks import lm_task
    from repro_torch.utils.pytree import tree_leaves
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=layers, param_dtype="float32",
                              compute_dtype="float32")
    task = lm_task(cfg, num_clients=4, docs_per_client=8, seq=128, server_batches_n=2,
                   server_batch=4, seed=seed, device="cuda")
    runner = fed.make_runner("fedsdd", task, device="cuda", K=2, R=2, num_clients=4,
                             participation=1.0, client_batch=4, local_epochs=1,
                             distill_steps=4, client_lr=0.01, server_lr=0.01,
                             temperature=4.0, kd_kernel="flash", kd_head_fusion=True,
                             teacher_dtype="bfloat16", seed=seed)
    state = runner.init_state()
    model_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state.global_models[0]))
    torch.cuda.synchronize()
    pool0, captures0 = pool_bytes(), sum(captures.values())
    torch.cuda.reset_peak_memory_stats()
    state = runner.run(1, state=state)
    torch.cuda.synchronize()
    pool = pool_bytes() - pool0
    out = {"model": "gemma-2b", "layers": layers, "model_gb": model_bytes / 1e9,
           "pool_gb": pool / 1e9, "pool_over_model": pool / model_bytes,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "captures": sum(captures.values()) - captures0,
           "kd_loss_last": state.history[-1]["kd_loss_last"]}
    del state, runner, task
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_pool: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for layers in args.layers:
        print(json.dumps({"card": card, **depth(layers, args.seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
