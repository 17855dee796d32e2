"""Server KD over stacked teachers, paper Eqs. 3-4 (port of
``repro/distill/pipeline.py``, the dense cache).

One round's distillation phase:

  1. **Teacher cache** — the teachers (upcast to f32) forward every server
     batch, member by member and batch by batch into one
     ``(M, n_batches, B, V)`` logit stack; ONE ``ensemble_softmax_many``
     launch turns it into the ``(n_batches, B, V)`` f32 probability cache,
     adding the members in ``members_stacked``' order (newest round first).
  2. **KD schedule** — ``distill_steps`` SGD steps (momentum 0.9, the
     server optimiser), step ``s`` on batch ``s % n_batches``, each through
     the ``kd_loss`` kernels (forward and backward).  Losses stay on the
     device; ONE host pull per round fills the history record.
  3. **Multi-student** — ``distill_all`` runs the K students one after the
     other over the same cache (the reference vmaps them); the reported
     losses are the main model's.

The flash kernel family (``kd_kernel="flash"``), head fusion, the
compressed cache, teacher trust weights and the sharded precompute arrive
with later slices.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels.kd_loss import ops as kd_ops
from repro_torch.optim.optimizers import apply_updates, sgd, value_and_grad
from repro_torch.utils.pytree import (tree_cast, tree_leaves, tree_map, tree_stack,
                                      tree_unstack)

PyTree = Any
LogitsFn = Callable[[PyTree, Any], torch.Tensor]


def stack_server_batches(batches: Sequence[Any]) -> PyTree:
    """Server batch list -> one tree with leaves (n_batches, B, ...).  Task
    builders emit full-size server batches only, so a ragged tail means a
    misbuilt task."""
    try:
        return tree_stack(list(batches))
    except (RuntimeError, TypeError) as e:
        shapes = sorted({tuple(x.shape) for b in batches for x in tree_leaves(b)})
        raise ValueError(
            f"fused KD pipeline needs same-shape server batches (saw leaf "
            f"shapes {shapes}); drop the ragged tail batch") from e


class KDPipeline:
    """One round's distillation phase.  Built once per runner; the stacked
    server batches are cached keyed on the batch list's identity."""

    def __init__(self, logits_fn: LogitsFn, *, steps: int, lr: float,
                 temperature: float = 4.0, momentum: float = 0.9, device=None):
        self.logits_fn = logits_fn
        self.steps = int(steps)
        self.temperature = float(temperature)
        self.optimizer = sgd(lr, momentum=momentum)
        self.device = device_lib.resolve(device)
        self._batches: PyTree | None = None
        self._batches_src: Sequence[Any] | None = None
        self._loss_and_grad = value_and_grad(self._loss)

    # ------------------------------------------------- server batch cache
    def batches_for(self, server_batches: Sequence[Any]) -> PyTree:
        # identity check against a retained reference: holding the keyed
        # list alive means a same-id reallocation can never alias the cache
        if self._batches_src is not server_batches:
            self._batches = tree_map(lambda x: x.to(self.device),
                                     stack_server_batches(server_batches))
            self._batches_src = server_batches
        return self._batches

    # --------------------------------------------------- teacher precompute
    @torch.no_grad()
    def precompute_teacher_probs(self, teacher_stack: PyTree, batches: PyTree) -> torch.Tensor:
        """(M, ...) teachers × (n_batches, B, ...) batches -> (n_batches, B, V)
        f32 ensemble probabilities, in one ``ensemble_softmax`` launch."""
        ts = tree_cast(teacher_stack, torch.float32)
        M = tree_leaves(ts)[0].shape[0]
        nB = tree_leaves(batches)[0].shape[0]
        logits = None
        for m in range(M):
            member = tree_map(lambda x: x[m], ts)
            for b in range(nB):
                lg = self.logits_fn(member, tree_map(lambda x: x[b], batches))
                if logits is None:
                    logits = torch.empty((M, nB) + tuple(lg.shape), dtype=torch.float32,
                                         device=lg.device)
                logits[m, b] = lg
        return kd_ops.ensemble_softmax_many(logits, self.temperature)

    def precompute_cache(self, teacher_stack: PyTree, batches: PyTree) -> torch.Tensor:
        """The tensor the KD steps consume: for the dense kernel, the f32
        probability cache itself."""
        return self.precompute_teacher_probs(teacher_stack, batches)

    # ------------------------------------------------------- KD step body
    def _loss(self, student, batch, cache_row):
        return kd_ops.kd_loss(self.logits_fn(student, batch), cache_row, self.temperature)

    def _run(self, student: PyTree, batches: PyTree, cache: torch.Tensor):
        """The whole schedule for one student; returns it and the (steps,)
        device tensor of losses."""
        n = cache.shape[0]
        opt_state = self.optimizer.init(student)
        losses = []
        for s in range(self.steps):
            bi = s % n
            batch = tree_map(lambda x: x[bi], batches)
            loss, grads = self._loss_and_grad(student, batch, cache[bi])
            updates, opt_state = self.optimizer.update(grads, opt_state, student)
            student = apply_updates(student, updates)
            losses.append(loss)              # a device scalar: no sync here
        if not losses:
            return student, torch.zeros((0,), device=cache.device)
        return student, torch.stack(losses)

    # ------------------------------------------------------------- public
    def distill(self, student: PyTree, teacher_stack: PyTree,
                server_batches: Sequence[Any]) -> tuple[PyTree, dict]:
        """Single-student KD (``distill_target='main'``)."""
        batches = self.batches_for(server_batches)
        cache = self.precompute_cache(teacher_stack, batches)
        student, losses = self._run(student, batches, cache)
        return student, self._info(losses)

    def distill_all(self, students_stacked: PyTree, teacher_stack: PyTree,
                    server_batches: Sequence[Any]) -> tuple[PyTree, dict]:
        """All K students over one cache (``distill_target='all'``); the
        reported losses are the main model's (row 0)."""
        batches = self.batches_for(server_batches)
        cache = self.precompute_cache(teacher_stack, batches)
        outs, losses = zip(*(self._run(st, batches, cache)
                             for st in tree_unstack(students_stacked)))
        return tree_stack(list(outs)), self._info(torch.stack(losses))

    def _info(self, losses: torch.Tensor) -> dict:
        """The per-round KD record: the one host pull of the phase."""
        losses = np.asarray(losses.cpu())  # lint-ok: RA101 the one per-round loss pull
        if losses.ndim == 2:                    # multi-student: main model
            losses = losses[0]
        return {"kd_loss_first": float(losses[0]) if losses.size else None,
                "kd_loss_last": float(losses[-1]) if losses.size else None,
                "kd_steps": self.steps}
