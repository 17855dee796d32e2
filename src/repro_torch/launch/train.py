"""End-to-end federated training CLI (port of ``repro/launch/train.py``).

Runs FedSDD or any preset baseline on the paper's image-classification
setting (the synthetic CIFAR stand-in; ResNet-20/56, WRN16-2 or the fast
CNN) or, with ``--arch``, on the LM task over a reduced model-zoo
architecture, on either client engine:

  PYTHONPATH=src python -m repro_torch.launch.train --preset fedsdd --rounds 10
  PYTHONPATH=src python -m repro_torch.launch.train --model resnet56 --execution vectorized
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --kd-kernel flash --kd-head-fusion
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-lite-16b --K 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b --kd-kernel flash --kd-head-fusion
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge --kd-kernel flash --kd-head-fusion
  PYTHONPATH=src python -m repro_torch.launch.train --preset fedbe
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --execution vectorized --overlap fused
  PYTHONPATH=src python -m repro_torch.launch.train --kd-pipeline legacy

The flags are the reference's, plus ``--device`` (default cuda; no GPU is
an error, not a fallback).  ``--overlap async|fused`` defers each round's KD
into the next round's k>0 training; a round's line then shows its accuracy
and KD loss only once its KD has resolved, and the run ends with
``runner.finalize``, which drains the last round's KD.  ``--faults`` and
the rate flags build a seeded ``FaultPlan`` (``--attack`` adds Byzantine
uploads, ``--aggregator`` / ``--clip-norm`` the robust Eq. 2,
``--teacher-trust`` the trust-weighted teachers); ``--ckpt-dir`` keeps
``ckpt_*`` model snapshots and ``state_*`` full-state checkpoints (a
pending KD job included) there after every round, and ``--resume`` starts
from the newest loadable one.  ``--arch`` takes every assigned
architecture, the audio and VLM frontends included (their batches carry
frame or patch embeddings).  The LM task's ``seq`` (32) is a multiple of
the reduced SSM chunk (16), as the recurrent families' full forward
needs.

Several ranks, one process a card, through ``torchrun``:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --execution vectorized
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --device cpu --execution vectorized

With ``WORLD_SIZE`` above 1 the default process group is initialised
before the runner is built (NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``); every rank runs the whole runner from the same seed, and the runner's
``client_sharding="auto"`` splits the vectorized engine's clients and the
KD teachers over the ranks.  Rank
0 alone prints the history and writes ``--out`` and ``--ckpt-dir``; each
rank spills its client store under ``--client-store-dir``'s ``rank<r>``.
Run as one process, nothing of this happens.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core.faults import FaultPlan
from repro_torch.core.fedsdd import PRESETS, make_runner
from repro_torch.core.tasks import classification_task, lm_task
from repro_torch.fedckpt.checkpointer import Checkpointer


def _fault_plan(args) -> FaultPlan | None:
    """The seeded plan of the fault flags: any nonzero rate builds one, and
    ``--faults`` alone builds one at rate 0 (bit-identical to none)."""
    if not (args.faults or any(r > 0 for r in (args.dropout_rate, args.straggler_rate,
                                               args.corrupt_rate, args.spill_fail_rate,
                                               args.attack_rate))):
        return None
    return FaultPlan(seed=args.seed if args.fault_seed is None else args.fault_seed,
                     dropout=args.dropout_rate, straggler=args.straggler_rate,
                     straggler_frac=args.straggler_frac, corrupt=args.corrupt_rate,
                     attack=args.attack, attack_rate=args.attack_rate,
                     attack_scale=args.attack_scale, spill_fail=args.spill_fail_rate,
                     zero_fill=args.zero_fill)


def _init_ranks(args) -> tuple[int, int]:
    """(rank, world size); under ``torchrun`` (``WORLD_SIZE`` > 1) the
    default process group, initialised from its environment, and
    ``args.device`` made this rank's card."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    import torch
    import torch.distributed as dist
    if torch.device(args.device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return dist.get_rank(), world


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
    rank, world = _init_ranks(args)
    if world > 1 and args.client_store_dir:
        args.client_store_dir = os.path.join(args.client_store_dir, f"rank{rank}")
    try:
        _train(args, rank, world)
    finally:
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, rank: int, world: int) -> None:
    if args.arch:
        cfg = get_config(args.arch).reduced()
        task = lm_task(cfg, num_clients=args.clients, seed=args.seed, device=args.device)
        overrides = dict(client_lr=0.01, server_lr=0.01, client_batch=4)
    else:
        task = classification_task(model=args.model, num_clients=args.clients,
                                   alpha=args.alpha, seed=args.seed, device=args.device)
        overrides = dict(client_lr=args.client_lr, server_lr=args.server_lr)
    runner = make_runner(
        args.preset, task, device=args.device, faults=_fault_plan(args),
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

    # two checkpoint families share --ckpt-dir: ckpt_* model snapshots and
    # state_* full-state resume checkpoints (save_state / restore_state);
    # rank 0 writes them, every rank resumes from them
    lead = rank == 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir and lead else None
    state_ckpt = (Checkpointer(args.ckpt_dir, prefix="state")
                  if args.ckpt_dir and (lead or args.resume) else None)
    t0 = time.perf_counter()
    state = runner.restore_state(state_ckpt) if (args.resume and state_ckpt) else None
    if state is not None:
        if lead:
            print(f"resumed from round {state.round}", flush=True)
    else:
        state = runner.init_state()
    if world > 1:
        import torch.distributed as dist
        dist.barrier()      # every rank has read the checkpoints before rank 0 writes
    if not lead:
        state_ckpt = None
    for _ in range(state.round, args.rounds):
        state = runner.run_round(state)
        rec = state.history[-1]
        msg = f"[{args.preset}] round {state.round}/{args.rounds}"
        if "acc_main" in rec:
            msg += f" acc={rec['acc_main']:.4f}"
        if rec.get("kd_loss_last") is not None:
            msg += f" kd={rec['kd_loss_last']:.4f}"
        # each defence's ruling of the round
        if rec.get("survivors") is not None:
            msg += f" survivors={len(rec['survivors'])}"
        if rec.get("dropped") or rec.get("rejected"):
            msg += f" dropped={len(rec.get('dropped', []))} rejected={len(rec.get('rejected', []))}"
        if rec.get("attacked"):
            msg += f" attacked={len(rec['attacked'])}"
        if rec.get("degraded_groups"):
            msg += f" degraded_groups={rec['degraded_groups']}"
        if rec.get("teacher_trust") is not None:
            tw = rec["teacher_trust"]
            msg += (f" trust=[{', '.join(f'{w:.2f}' for w in tw)}]"
                    f" filtered={sum(1 for w in tw if w == 0.0)}")
        if lead:
            print(msg, flush=True)
        if ckpt:
            if state.pending_kd is None:
                ckpt.save(state.round, state.global_models[0], meta={"round": state.round})
            elif state.last_distilled is not None:
                # overlap: round t's KD is in flight, so the newest resolved
                # round goes here; save_state keeps the job itself
                r_done, model = state.last_distilled
                ckpt.save(r_done, model, meta={"round": r_done})
        if state_ckpt:
            runner.save_state(state_ckpt, state)
    # overlap modes defer the last round's KD: drain it, so that the final
    # model is the overlap="off" one
    state = runner.finalize(state)
    if ckpt and args.overlap != "off":
        ckpt.save(state.round, state.global_models[0],
                  meta={"round": state.round, "drained": True})
    if state_ckpt:
        runner.save_state(state_ckpt, state)     # drained: no pending spill left
    if not lead:
        return
    print(f"done in {time.perf_counter() - t0:.1f}s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(state.history, f, indent=1, default=str)


if __name__ == "__main__":
    main()
