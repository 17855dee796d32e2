"""Round execution as a phase plan, with server KD overlapped with k>0
local training (port of ``repro/core/round_plan.py``).

The paper's scalability claim (Fig. 2, §3.2): only the main global model
(group 0) consumes the KD output, so groups k>0 can train round t+1 while
round t's KD runs.  ``core/scheduler.py`` models that overlap; this module
executes it.  A round is a phase plan::

    kd_dispatch ─▶ train_rest ─▶ kd_resolve ─▶ train_main ─▶ finish_local
         │              │
         └── overlap ───┘
        ─▶ aggregate ─▶ push ─▶ kd_emit ─▶ record

Round t's KD job (student: round t's raw group-0 aggregate; teachers: the
ring right after round t's push) has one consumer, group 0's round-t+1
broadcast, so the executor defers it: the job is emitted as a ``PendingKD``
at the end of round t and resolved before group 0 trains in round t+1,
which makes the overlap an exact reordering of ``overlap="off"``.
``FederatedRunner.finalize`` (called by ``run``) drains the last job.

Modes (``FedConfig.overlap``):

  off    the back-to-back order, KD inline: the oracle
         (``train all ─▶ finish_local ─▶ aggregate ─▶ push ─▶ KD ─▶ eval``).
  async  the KD is issued at emit time on the KD pipeline's own CUDA stream
         (``KDPipeline.distill_async``: the cache build and every step
         replay, no host sync), and the k>0 training goes on on the
         caller's stream; the resolve is an event wait, then the host reads
         the losses and evaluates.  One host thread issues both sides: each
         step is one CUDA-graph replay (``core/step_graph.py``), so the GIL
         never serialises two dispatchers (the reference's worker thread).
         On the CPU the job runs in the calling thread at dispatch.
  fused  one KD step and one k>0 bucket step run as one paired program, a
         CUDA graph of two branches (``StepGraphs.pair``), for as many steps
         as both sides have; what remains of either runs as its single
         program.  Needs the vectorized engine with ``"scan"`` on both sides
         (the reference's condition); otherwise the configuration falls back
         to ``async``, as the reference's does.

Deferral needs ``distill_target == "main"`` and ``K > 1``: with one group
(FedDF) or every model distilled (Table 6's basic KD) every group consumes
the KD output, and such rounds keep the off-mode order in every mode, as do
warm-up rounds.  Overlapped rounds record no ``t_local`` or ``t_kd``; their
``t_round`` is read after the caller's stream drains (the KD stream's work
is left running).

A checkpoint taken with a job pending keeps the job's inputs, not its
output (``spill_pending_kd``): the KD is a function of (student, teachers,
weights), so a restored job re-dispatched gives the drained result bit for
bit.  The spill reads the inputs on the caller's stream and does not wait
for the KD stream, where the job may still run.
"""
from __future__ import annotations

import json
import os
import time
import weakref
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.analysis.sync import allowed_sync
from repro_torch.core.step_graph import StepGraphs
from repro_torch.fedckpt.checkpointer import leaf_to_numpy, load_pytree, save_json, save_pytree
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unstack

PyTree = Any

OVERLAP_MODES = ("off", "async", "fused")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU): the phase
    timer's wait before ``t_local`` / ``t_kd`` are read."""
    if device.type == "cuda":
        with allowed_sync("the phase timer: t_local and t_kd are read once the "
                          "device drains, as the reference's block_until_ready"):
            torch.cuda.synchronize(device)


def synchronize_stream(device: torch.device) -> None:
    """Wait for the current stream's queued work, not for other streams':
    the overlapped round's timer (ROADMAP.md §C: a wait the reference's
    overlapped round does not make)."""
    if device.type == "cuda":
        with allowed_sync("the overlapped round's timer: t_round is read once "
                          "the caller's stream drains"):
            torch.cuda.current_stream(device).synchronize()


@dataclass
class PendingKD:
    """A deferred round-t KD job: emitted at the end of round t, dispatched
    beside round t+1's k>0 training, resolved before group 0's round-t+1
    training (or at the drain).  ``teachers`` are the ring's views while
    ``bank`` holds it (no copy: the next push comes after the resolve), or
    the round's client models; ``dispatched`` is the device pair
    ``(student, losses)`` once ``pipe`` (the KD pipeline) issued it.  A job
    restored from a spill has no bank: its teachers are its own."""
    round_idx: int
    student: PyTree                 # round t's raw group-0 aggregate
    teachers: list                  # the member trees
    record: dict                    # round t's history record, patched late
    dispatched: Optional[tuple] = None
    bank: Optional[Any] = None      # the TeacherBank whose views `teachers` are
    teacher_weights: Optional[torch.Tensor] = None   # (M,) trust weights or None
    pipe: Optional[weakref.ref] = None   # the KDPipeline that issued `dispatched`

    def result(self) -> tuple:
        """The dispatched ``(student, losses)``.  Where the job is still in
        flight on the KD lane, the caller's stream waits for it (an event
        wait, no host sync) and the pipeline's programs are free again.
        The job holds its pipeline weakly (a state must not keep the
        pipeline's step programs and graph pool alive), so this raises once
        the runner and its pipeline are gone."""
        pipe = None if self.pipe is None else self.pipe()
        if self.dispatched is None or pipe is None:
            raise RuntimeError(f"PendingKD(round {self.round_idx}): "
                               + ("not dispatched" if self.dispatched is None
                                  else "its KD pipeline is gone"))
        return pipe.join(self.dispatched)


def spill_pending_kd(directory: str, pending: PendingKD) -> str:
    """A deferred KD job through fedckpt: ``pending_kd_r{round:05d}.npz``
    with the student, the (M, ...) teacher stack and the weights (the
    reference's names), and a ``.json`` sidecar (round, the partly filled
    history record, M).  Returns the npz path."""
    path = os.path.join(directory, f"pending_kd_r{pending.round_idx:05d}.npz")
    # the (M, ...) teacher stack, leaf by leaf on the host
    teachers = tree_map(lambda *xs: np.stack([leaf_to_numpy(x) for x in xs]), *pending.teachers)
    tree = {"student": pending.student, "teachers": teachers}
    if pending.teacher_weights is not None:
        tree["teacher_weights"] = pending.teacher_weights.float()
    save_pytree(path, tree)
    save_json(path.replace(".npz", ".json"), {
        "round_idx": pending.round_idx,
        "record": dict(pending.record),
        "num_teachers": len(pending.teachers),
        "has_teacher_weights": pending.teacher_weights is not None,
    })
    return path


def restore_pending_kd(path: str, student_like: PyTree) -> PendingKD:
    """Rebuild a spilled job (undispatched: its resolve issues it).  The
    teachers come back as f32 containers, each a view of the restored
    (M, ...) stack; a bf16 ring's members are the same values, and the KD
    upcasts every member to f32 before its forward."""
    with open(path.replace(".npz", ".json")) as f:
        meta = json.load(f)
    m = int(meta["num_teachers"])
    like = {"student": student_like,
            "teachers": tree_map(lambda x: torch.zeros((m,) + tuple(x.shape),
                                                       dtype=torch.float32, device=x.device),
                                 student_like)}
    if meta.get("has_teacher_weights", False):
        like["teacher_weights"] = torch.zeros((m,), dtype=torch.float32,
                                              device=tree_leaves(student_like)[0].device)
    tree = load_pytree(path, like)
    return PendingKD(round_idx=int(meta["round_idx"]), student=tree["student"],
                     teachers=tree_unstack(tree["teachers"]), record=dict(meta["record"]),
                     teacher_weights=tree.get("teacher_weights"))


def trust_record(weights: torch.Tensor) -> list[float]:
    """The history record's trust weights: one host read, 4 decimals."""
    with allowed_sync("per-round teacher-trust weights into the history record"):
        host = weights.cpu().tolist()
    return [round(float(w), 4) for w in host]


class RoundExecutor:
    """Drives one federated round as the phase plan above.

    Engine-specific work is delegated to the per-round ``ops`` adapter built
    by the runner (``fedsdd._SequentialRoundOps`` / ``_VectorizedRoundOps``);
    the executor owns the phase order, the ``PendingKD`` state machine and
    the per-phase wall-clock record.
    """

    def __init__(self, runner):
        # the runner owns its executor: a proxy, so that the pair is no
        # cycle and the runner's step programs go with the runner
        self.runner = weakref.proxy(runner)
        self.cfg = runner.cfg
        self._pairs: StepGraphs | None = None    # the fused mode's paired programs

    # ------------------------------------------------------- predicates
    def kd_active(self, t: int) -> bool:
        cfg = self.cfg
        return cfg.distill_target != "none" and t > cfg.distill_warmup_rounds

    def defer_eligible(self) -> bool:
        """True when the KD's only consumer is next round's group-0 training."""
        cfg = self.cfg
        return cfg.overlap != "off" and cfg.distill_target == "main" and cfg.K > 1

    # ------------------------------------------------------ KD plumbing
    def _pipe(self):
        return self.runner._kd_pipeline()

    def dispatch(self, pending: PendingKD) -> None:
        """Issue the deferred KD on the KD stream (no host sync); on the CPU
        it runs here."""
        if pending.dispatched is None:
            pipe = self._pipe()
            pending.pipe = weakref.ref(pipe)
            pending.dispatched = pipe.distill_async(
                pending.student, pending.teachers, self.runner.task.server_batches,
                teacher_weights=pending.teacher_weights)

    def resolve_pending(self, state) -> None:
        """Wait for the deferred KD (an event wait), install its output as
        the main global model and complete the emitting round's record."""
        pending = state.pending_kd
        if pending is None:
            return
        self.dispatch(pending)
        student, losses = pending.result()
        pending.record.update(self._pipe().losses_info(losses))
        if pending.teacher_weights is not None:
            pending.record["teacher_trust"] = trust_record(pending.teacher_weights)
        if pending.bank is not None:
            pending.bank.release()
        state.global_models[0] = student
        state.last_distilled = (pending.round_idx, student)
        if self.runner.task.eval_fn is not None:
            with allowed_sync("per-round eval of the distilled main model"):
                pending.record["acc_main"] = self.runner.task.eval_fn(student)
        state.pending_kd = None

    def close(self) -> None:
        """After the drain: nothing of the KD may still be in flight."""
        if self.runner._kd_pipe is not None and self.runner._kd_pipe.graphs.in_flight:
            raise RuntimeError("RoundExecutor.close: a KD job is still in flight")

    def _fused_capable(self, ops) -> bool:
        return (self.cfg.overlap == "fused" and ops.fused_capable()
                and self._pipe().scan_capable())

    def _run_fused(self, pending: PendingKD, bucket_args: list) -> list:
        """The pending KD's steps and the k>0 buckets' steps, a KD step and a
        bucket step a paired program while both have steps left, then the
        rest of either alone; ``pending.dispatched`` gets the KD's device
        outputs and the buckets' outputs are returned in order."""
        pipe, eng = self._pipe(), self.runner._make_engine()
        pending.pipe = weakref.ref(pipe)
        if not pipe.steps:
            pending.dispatched = pipe.distill_async(pending.student, pending.teachers,
                                                    self.runner.task.server_batches,
                                                    teacher_weights=pending.teacher_weights)
            return [eng.run_prepared(args) for args in bucket_args]
        if self._pairs is None:
            self._pairs = StepGraphs()
        kd = pipe.start_steps(pending.student, pending.teachers,
                              self.runner.task.server_batches,
                              teacher_weights=pending.teacher_weights)
        left = pipe.steps
        started = [eng.start_prepared(args) for args in bucket_args]
        for prog, S in started:
            for _ in range(S):
                if left:
                    self._pairs.pair("fused/kd+bucket", kd, prog)()
                    left -= 1
                else:
                    prog()
        for _ in range(left):
            kd()
        pending.dispatched = pipe.finish_steps(kd)
        return [eng.finish_prepared(prog, args) for (prog, _), args in zip(started, bucket_args)]

    # ------------------------------------------------------------ round
    def execute(self, state, t: int, active_count: int, ops):
        """Run round t's phases over the engine adapter ``ops``."""
        cfg, task, dev = self.cfg, self.runner.task, self.runner.device
        t_start = time.perf_counter()
        rec: dict[str, Any] = {"round": t, "active": active_count}

        if not self.defer_eligible():
            # ---- back-to-back phase order (the off-mode oracle) ----
            self.resolve_pending(state)
            ops.train("all")
            ops.finish_local()
            new_globals = ops.aggregate()
            rec.update(ops.fault_info)
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
                with allowed_sync("per-round eval of the main model"):
                    rec["acc_main"] = task.eval_fn(new_globals[0])
            rec["t_round"] = time.perf_counter() - t_start
            state.history.append(rec)
            state.round = t
            return state

        # ---- overlapped phase order ----
        pending = state.pending_kd
        if pending is not None and self._fused_capable(ops):
            ops.train("rest", run_buckets=lambda args: self._run_fused(pending, args))
            self.dispatch(pending)      # no k>0 clients this round: the async path
        else:
            if pending is not None:
                self.dispatch(pending)  # async issued it at emit already
            ops.train("rest")
        self.resolve_pending(state)     # round t-1's main model is final
        ops.train("main")               # group 0 starts from the KD output
        ops.finish_local()
        new_globals = ops.aggregate()
        rec.update(ops.fault_info)
        ops.push(t, state)
        state.global_models = new_globals
        state.round = t
        if self.kd_active(t):
            # emit round t's KD; async issues it now, so that it also
            # overlaps the host's planning of round t+1
            teachers, bank = ops.kd_teachers(new_globals)
            if bank is not None:
                bank.hold()
            state.pending_kd = PendingKD(
                round_idx=t, student=new_globals[0], teachers=teachers, record=rec, bank=bank,
                teacher_weights=self.runner._teacher_trust_weights(state, teachers))
            if cfg.overlap == "async":
                self.dispatch(state.pending_kd)
        elif task.eval_fn is not None:
            with allowed_sync("per-round eval of the main model"):
                rec["acc_main"] = task.eval_fn(new_globals[0])
        synchronize_stream(dev)
        rec["t_round"] = time.perf_counter() - t_start
        state.history.append(rec)
        return state
