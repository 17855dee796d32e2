"""Round execution as a phase plan (port of ``repro/core/round_plan.py``,
``overlap="off"`` only).

The back-to-back order of the reference's oracle::

    train all ─▶ finish_local ─▶ aggregate ─▶ push ─▶ KD ─▶ eval ─▶ record

Engine-specific work is delegated to the per-round ``ops`` adapter
(``fedsdd._SequentialRoundOps`` or ``_VectorizedRoundOps``).  Before each
phase clock is read the device is synchronised, so ``t_local`` and
``t_kd`` hold the device's work and not only its enqueueing.  Overlapping round t's KD with round t+1's
local training arrives with its own slice.
"""
from __future__ import annotations

import time
import weakref
from typing import Any

import torch


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RoundExecutor:
    """Drives one federated round as the phase plan above."""

    def __init__(self, runner):
        # the runner owns its executor: a proxy, so that the pair is no
        # cycle and the runner's step programs go with the runner
        self.runner = weakref.proxy(runner)
        self.cfg = runner.cfg

    def kd_active(self, t: int) -> bool:
        cfg = self.cfg
        return cfg.distill_target != "none" and t > cfg.distill_warmup_rounds

    def execute(self, state, t: int, active_count: int, ops):
        """Run round t's phases over the engine adapter ``ops``."""
        task, dev = self.runner.task, self.runner.device
        t_start = time.perf_counter()
        rec: dict[str, Any] = {"round": t, "active": active_count}
        ops.train()
        ops.finish_local()
        new_globals = ops.aggregate()
        ops.push(t, state)
        synchronize(dev)
        rec["t_local"] = time.perf_counter() - t_start
        if self.kd_active(t):
            t0 = time.perf_counter()
            rec.update(ops.inline_kd(new_globals))
            synchronize(dev)
            rec["t_kd"] = time.perf_counter() - t0
        state.global_models = new_globals
        if task.eval_fn is not None:
            rec["acc_main"] = task.eval_fn(new_globals[0])
        rec["t_round"] = time.perf_counter() - t_start
        state.history.append(rec)
        state.round = t
        return state
