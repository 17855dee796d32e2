"""Diversity-enhanced knowledge distillation, the host-driven oracle (port
of ``repro/core/distillation.py``; paper §3.1.2, Eqs. 3-5).

The teacher is the logit-mean ensemble of the K·R temporal members; KD
updates only the main global model (k=0).  ``distill`` is generic over a
``logits_fn(params, batch) -> (B, V)``, so the same code distils the
paper's ResNets and the model-zoo LMs.

Every KD step goes through ``kernels.kd_loss.ops``: on a card the
hand-written kernels (kernel 2 builds each batch's teacher probabilities,
kernels 3-4 or the Flash-KD kernels 7-10 run the step), on the CPU their
plain versions.  ``distill`` is the loop of one step a Python iteration,
with each server batch's teacher row built the first time the batch comes
round; it is the oracle that ``FedConfig.kd_pipeline="legacy"`` selects
beside the fused ``repro_torch.distill.KDPipeline``.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.kernels.kd_loss import ops as kd_ops
from repro_torch.optim.optimizers import Optimizer, apply_updates, sgd, value_and_grad
from repro_torch.utils.pytree import tree_cast, tree_unstack

PyTree = Any
LogitsFn = Callable[[PyTree, Any], torch.Tensor]


def precast_teachers(teachers: Sequence[PyTree]) -> list[PyTree]:
    """The teacher list in f32, cast once (an f32 member passes through
    without a copy): a loop over many batches hoists the cast here."""
    return [tree_cast(t, torch.float32) for t in teachers]


@torch.no_grad()
def ensemble_logits(teachers: Sequence[PyTree], batch, logits_fn: LogitsFn, *,
                    precast: bool = False) -> torch.Tensor:
    """Eq. 3/5: the mean logit over the members (uniform 1/(K·R) weights),
    each member's forward in f32, summed in list order."""
    if not precast:
        teachers = precast_teachers(teachers)
    acc = None
    for t in teachers:
        lg = logits_fn(t, batch).float()
        acc = lg if acc is None else acc + lg
    return acc / len(teachers)


@torch.no_grad()
def stacked_teacher_logits(stacked_teachers: PyTree, batch,
                           logits_fn: LogitsFn) -> torch.Tensor:
    """(M, B, V) f32 teacher logits from a tree whose leaves carry the
    leading member axis (M = K·R for FedSDD, M = C for FedDF)."""
    members = tree_unstack(tree_cast(stacked_teachers, torch.float32))
    return torch.stack([logits_fn(p, batch).float() for p in members])


def ensemble_probs_stacked(stacked_teachers: PyTree, batch, logits_fn: LogitsFn,
                           temperature: float = 1.0) -> torch.Tensor:
    """τ-softened ensemble probabilities of the stacked members through
    kernel 2 (``ensemble_softmax``): the (M, B, V) stack reduced over M and
    normalised in one launch."""
    return kd_ops.ensemble_softmax(stacked_teacher_logits(stacked_teachers, batch, logits_fn),
                                   temperature)


def ensemble_mean_logits_stacked(stacked_teachers: PyTree, batch,
                                 logits_fn: LogitsFn) -> torch.Tensor:
    """(B, V) mean teacher logit of the stacked members: the Flash-KD cache
    row (Eq. 3/5 before the τ-softmax)."""
    return stacked_teacher_logits(stacked_teachers, batch, logits_fn).mean(dim=0)


@torch.no_grad()
def ensemble_probs(teachers: Sequence[PyTree], batch, logits_fn: LogitsFn,
                   temperature: float = 1.0, *, precast: bool = False) -> torch.Tensor:
    """τ-softened ensemble probabilities of the member list through kernel 2:
    softmax(mean logit / τ)."""
    if not precast:
        teachers = precast_teachers(teachers)
    lg = torch.stack([logits_fn(t, batch).float() for t in teachers])
    return kd_ops.ensemble_softmax(lg, temperature)


def ensemble_predict(teachers: Sequence[PyTree], batch, logits_fn: LogitsFn) -> torch.Tensor:
    """The ensemble's class per row: argmax of the mean logit."""
    return ensemble_logits(teachers, batch, logits_fn).argmax(dim=-1)


def make_kd_step(logits_fn: LogitsFn, optimizer: Optimizer, temperature: float,
                 kd_kernel: str = "dense", features_fn=None, head_fn=None,
                 head_fusion: bool = False) -> Callable:
    """``step(student, opt_state, batch, teacher_row) -> (student,
    opt_state, loss)``: student ← student − lr ∇ KL(teacher ‖ student).

    ``kd_kernel="dense"`` consumes f32 teacher probabilities (kernels 3-4);
    ``"flash"`` the mean teacher logit row through the vocab-tiled kernels
    7-8, or, with ``head_fusion`` and a task's ``features_fn``/``head_fn``
    split, kernels 9-10, which form the student's LM-head tile themselves.
    """
    if kd_kernel not in ("dense", "flash"):
        raise ValueError(f"kd_kernel must be 'dense' or 'flash', got {kd_kernel!r}")
    head_fused = (head_fusion and kd_kernel == "flash"
                  and features_fn is not None and head_fn is not None)

    def loss_fn(student, batch, teacher_row):
        if head_fused:
            w, b = head_fn(student)
            return kd_ops.flash_kd_head_loss(features_fn(student, batch), w, b, teacher_row,
                                             temperature)
        s_logits = logits_fn(student, batch)
        if kd_kernel == "flash":
            return kd_ops.flash_kd_loss(s_logits, teacher_row, temperature)
        return kd_ops.kd_loss(s_logits, teacher_row, temperature)

    loss_and_grad = value_and_grad(loss_fn)

    def step(student, opt_state, batch, teacher_row):
        loss, grads = loss_and_grad(student, batch, teacher_row)
        updates, opt_state = optimizer.update(grads, opt_state, student)
        return apply_updates(student, updates), opt_state, loss

    return step


def distill(student: PyTree, teachers: Sequence[PyTree], server_batches: Sequence[Any],
            logits_fn: LogitsFn, *, steps: int, lr: float = 0.1, temperature: float = 4.0,
            momentum: float = 0.9, stacked_teachers: bool = False, kd_kernel: str = "dense",
            features_fn=None, head_fn=None, head_fusion: bool = False) -> tuple[PyTree, dict]:
    """``steps`` KD minibatch steps (paper: 5000 steps, SGD, τ = 4), batch
    ``s % len(server_batches)`` at step ``s``.

    The teachers are frozen (Eq. 4's argmin is over the student only): each
    batch's teacher row (probabilities, or the mean logits for Flash-KD) is
    built the first time the batch comes round and kept.
    ``stacked_teachers=True``: ``teachers`` is one tree whose leaves carry
    the leading member axis.  The losses stay on the device until the one
    pull at the end.
    """
    optimizer = sgd(lr, momentum=momentum)
    opt_state = optimizer.init(student)
    kd_step = make_kd_step(logits_fn, optimizer, temperature, kd_kernel=kd_kernel,
                           features_fn=features_fn, head_fn=head_fn, head_fusion=head_fusion)
    # the members serve every server batch: cast them to f32 once
    teachers = (tree_cast(teachers, torch.float32) if stacked_teachers
                else precast_teachers(teachers))
    if kd_kernel == "flash":
        if stacked_teachers:
            def teacher_row(batch):
                return ensemble_mean_logits_stacked(teachers, batch, logits_fn)
        else:
            def teacher_row(batch):
                return ensemble_logits(teachers, batch, logits_fn, precast=True)
    elif stacked_teachers:
        def teacher_row(batch):
            return ensemble_probs_stacked(teachers, batch, logits_fn, temperature)
    else:
        def teacher_row(batch):
            return ensemble_probs(teachers, batch, logits_fn, temperature, precast=True)

    losses = []
    n = len(server_batches)
    cache: dict[int, torch.Tensor] = {}
    for s in range(steps):
        bi = s % n
        if bi not in cache:
            cache[bi] = teacher_row(server_batches[bi])
        student, opt_state, loss = kd_step(student, opt_state, server_batches[bi], cache[bi])
        losses.append(loss.detach())     # a device scalar: pulled once below
    first = float(losses[0]) if losses else None    # lint-ok: RA101 the oracle's one pull
    last = float(losses[-1]) if losses else None    # lint-ok: RA101 the oracle's one pull
    return student, {"kd_loss_first": first, "kd_loss_last": last, "kd_steps": steps}
