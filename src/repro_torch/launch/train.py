"""End-to-end federated training CLI (port of ``repro/launch/train.py``).

Runs FedSDD or any preset baseline on the paper's image-classification
setting (the synthetic CIFAR stand-in; ResNet-20/56, WRN16-2 or the fast
CNN) or, with ``--arch``, on the LM task over a reduced model-zoo
architecture, on either client engine:

  PYTHONPATH=src python -m repro_torch.launch.train --preset fedsdd --rounds 10
  PYTHONPATH=src python -m repro_torch.launch.train --model resnet56 --execution vectorized
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --kd-kernel flash --kd-head-fusion
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --execution vectorized --overlap fused
  PYTHONPATH=src python -m repro_torch.launch.train --kd-pipeline legacy

The flags are the reference's, plus ``--device`` (default cuda; no GPU is
an error, not a fallback).  ``--overlap async|fused`` defers each round's KD
into the next round's k>0 training; a round's line then shows its accuracy
and KD loss only once its KD has resolved, and the run ends with
``runner.finalize``, which drains the last round's KD.  A flag for what the
port does not run yet raises ``NotImplementedError`` naming the slice that
brings it: an ``--arch`` outside the dense GQA families, the fault and
checkpoint flags here, and the runner's own options (robust aggregation and
the rest) through ``FedConfig``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_configs
from repro_torch.core.fedsdd import PRESETS, make_runner
from repro_torch.core.tasks import classification_task, lm_task


def _refuse_unported(args) -> None:
    """The CLI-level options of the reference this port does not run yet."""
    unported = (
        (args.arch is not None and args.arch not in list_configs(),
         f"--arch {args.arch}: the model families beyond dense GQA (MoE, MLA, SSM, "
         f"the audio/VLM frontends) arrive with their own slice of the port; the "
         f"LM task runs {list_configs()}"),
        (args.faults or args.zero_fill or args.attack != "none"
         or any(r > 0 for r in (args.dropout_rate, args.straggler_rate, args.corrupt_rate,
                                args.spill_fail_rate, args.attack_rate)),
         "fault injection (--faults, the rates, --zero-fill, --attack) arrives with "
         "the robustness slice"),
        (args.ckpt_dir is not None or args.resume,
         "checkpoints (--ckpt-dir, --resume) arrive with the robustness slice "
         "(fedckpt)"),
    )
    for cond, what in unported:
        if cond:
            raise NotImplementedError(f"repro_torch.launch.train: {what}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="fedsdd", choices=sorted(PRESETS))
    ap.add_argument("--model", default="cnn",
                    choices=["cnn", "resnet20", "resnet56", "wrn16-2"])
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED_ARCHS),
                    help="run the LM task on a reduced assigned architecture")
    ap.add_argument("--device", default="cuda",
                    help="where the run's tensors live (cuda unless 'cpu' is asked for)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--K", type=int, default=4)
    ap.add_argument("--R", type=int, default=1)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--client-lr", type=float, default=0.05)
    ap.add_argument("--server-lr", type=float, default=0.05)
    ap.add_argument("--distill-steps", type=int, default=50)
    ap.add_argument("--execution", default="sequential",
                    choices=["sequential", "vectorized"],
                    help="client-execution engine (vectorized = every bucket "
                         "of clients as one vmapped step)")
    ap.add_argument("--kd-pipeline", default="fused", choices=["legacy", "fused"])
    ap.add_argument("--kd-kernel", default="dense", choices=["dense", "flash"])
    ap.add_argument("--kd-head-fusion", action="store_true")
    ap.add_argument("--teacher-cache-dtype", default=None, choices=["float32", "bfloat16"])
    ap.add_argument("--overlap", default="off", choices=["off", "async", "fused"])
    ap.add_argument("--teacher-dtype", default=None, choices=["float32", "bfloat16"],
                    help="teacher-bank storage precision (bfloat16 halves bank "
                         "memory; ensemble compute stays f32)")
    ap.add_argument("--client-store", default="memory", choices=["memory", "spilling"])
    ap.add_argument("--client-store-dir", default=None)
    ap.add_argument("--client-cache-buckets", type=int, default=64,
                    help="LRU capacity of the store's device tier (rows + "
                         "bucket stacks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--straggler-rate", type=float, default=0.0)
    ap.add_argument("--straggler-frac", type=float, default=0.5)
    ap.add_argument("--corrupt-rate", type=float, default=0.0)
    ap.add_argument("--spill-fail-rate", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=None)
    ap.add_argument("--zero-fill", action="store_true")
    ap.add_argument("--attack", default="none",
                    choices=["none", "sign_flip", "scale", "gauss"])
    ap.add_argument("--attack-rate", type=float, default=0.0)
    ap.add_argument("--attack-scale", type=float, default=10.0)
    ap.add_argument("--aggregator", default="mean",
                    choices=["mean", "trimmed_mean", "median", "krum", "multi_krum"])
    ap.add_argument("--trim-frac", type=float, default=0.2)
    ap.add_argument("--clip-norm", type=float, default=None)
    ap.add_argument("--teacher-trust", action="store_true")
    ap.add_argument("--out", default=None, help="write history JSON here")
    args = ap.parse_args()
    _refuse_unported(args)

    if args.arch:
        cfg = get_config(args.arch).reduced()
        task = lm_task(cfg, num_clients=args.clients, seed=args.seed, device=args.device)
        overrides = dict(client_lr=0.01, server_lr=0.01, client_batch=4)
    else:
        task = classification_task(model=args.model, num_clients=args.clients,
                                   alpha=args.alpha, seed=args.seed, device=args.device)
        overrides = dict(client_lr=args.client_lr, server_lr=args.server_lr)
    runner = make_runner(
        args.preset, task, device=args.device,
        aggregator=args.aggregator, trim_frac=args.trim_frac,
        clip_norm=args.clip_norm, teacher_trust=args.teacher_trust,
        num_clients=args.clients, participation=args.participation,
        rounds=args.rounds, local_epochs=args.local_epochs,
        distill_steps=args.distill_steps, seed=args.seed,
        execution=args.execution, kd_pipeline=args.kd_pipeline,
        kd_kernel=args.kd_kernel, kd_head_fusion=args.kd_head_fusion,
        teacher_cache_dtype=args.teacher_cache_dtype,
        overlap=args.overlap, teacher_dtype=args.teacher_dtype,
        client_store=args.client_store, client_store_dir=args.client_store_dir,
        client_cache_buckets=args.client_cache_buckets,
        **({"K": args.K, "R": args.R} if PRESETS[args.preset].get("K", 1) > 1 else {}),
        **overrides)

    t0 = time.perf_counter()
    state = runner.init_state()
    for _ in range(state.round, args.rounds):
        state = runner.run_round(state)
        rec = state.history[-1]
        msg = f"[{args.preset}] round {state.round}/{args.rounds}"
        if "acc_main" in rec:
            msg += f" acc={rec['acc_main']:.4f}"
        if rec.get("kd_loss_last") is not None:
            msg += f" kd={rec['kd_loss_last']:.4f}"
        print(msg, flush=True)
    # overlap modes defer the last round's KD: drain it, so that the final
    # model is the overlap="off" one
    state = runner.finalize(state)
    print(f"done in {time.perf_counter() - t0:.1f}s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(state.history, f, indent=1, default=str)


if __name__ == "__main__":
    main()
