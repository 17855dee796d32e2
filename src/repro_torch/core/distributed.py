"""The FedSDD round as ONE program of plain tensor functions (port of
``repro/core/distributed.py``).

This is the paper's dataflow made literal:

  K groups   — independent within a round (the reference's "pod" axis);
  N clients  — of a group, each with its own batch (the "data" axis);
  one model replica per client (tensor parallelism inside it: "model").

``make_fedsdd_round_fn`` builds a function
    (stacked_globals (K,·), client_batches (K,N,·), client_weights (K,N),
     server_batch) -> new stacked_globals
computing: per-client local SGD step(s) → per-group weighted averaging
(Eq. 2 — a reduction over the client axis only) → teacher-ensemble logits
on the server batch (the ONLY cross-group reduction: a (B, V) logit-mean
over K — bytes independent of the client count, the paper's scalability
claim) → a KD gradient step applied to the main global model alone (Eq. 4,
diversity preserved).

The functions are mesh-agnostic, as the reference's are: its sharding of
them comes from the dry run's ``in_shardings`` over the production mesh
(``launch.mesh``, ``sharding.specs``).  The arithmetic:

  - local training: ``torch.func.vmap`` over the K groups of a ``vmap``
    over the N clients (the group's params broadcast) of ``local_steps``
    steps of ``torch.func.grad(loss_fn)``, each on its slice of the
    client's batch;
  - Eq. 2: the reference's f32 ``tensordot`` of the normalised weights
    with each leaf (the reference computes it outside any Pallas kernel);
  - Eq. 3: the K aggregates' logits (and ``make_distill_step_fn``'s M
    teachers'), one member at a time (so that one teacher's activations
    are live at once; the arithmetic is the reference's vmap's), through
    ``kd_ops.ensemble_softmax`` (kernel 2);
  - Eq. 4: ``kd_ops.kd_loss`` (kernels 3 and 4 through ``_KDLoss``) on the
    main model alone, differentiated by autograd (a kernel's autograd
    Function needs no vmap there).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.kernels.kd_loss import ops as kd_ops
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.utils.pytree import tree_leaves, tree_map

PyTree = Any


@torch.no_grad()
def _ensemble_probs(logits_fn: Callable, stacked: PyTree, server_batch,
                    temperature: float) -> torch.Tensor:
    """Kernel 2 over the (M, rows, V) logits of a stacked model tree on the
    server batch, each member's forward on its own (the reference vmaps
    them: the same arithmetic, M times the live activations)."""
    t_logits = None
    M = tree_leaves(stacked)[0].shape[0]
    for m in range(M):
        lg = logits_fn(tree_map(lambda x: x[m], stacked), server_batch)
        if t_logits is None:
            t_logits = torch.empty((M,) + tuple(lg.shape), dtype=lg.dtype, device=lg.device)
        t_logits[m] = lg
        del lg
    return kd_ops.ensemble_softmax(t_logits.reshape(M, -1, t_logits.shape[-1]), temperature)


def make_fedsdd_round_fn(loss_fn: Callable, logits_fn: Callable, *,
                         client_lr: float = 0.8,
                         server_lr: float = 0.1,
                         temperature: float = 4.0,
                         local_steps: int = 1,
                         remat_logits: bool = False):
    """Build the FedSDD round step.

    loss_fn(params, batch) -> scalar; logits_fn(params, batch) -> (..., V).
    ``remat_logits`` is the reference's flag, which its round ignores too.
    """
    grad_fn = torch.func.grad(loss_fn)

    def client_update(params, batch):
        p = params
        for i in range(local_steps):
            mb = tree_map(lambda x: x.reshape((local_steps, -1) + tuple(x.shape[1:]))[i],
                          batch)
            g = grad_fn(p, mb)
            p = tree_map(lambda pp, gg: pp - client_lr * gg.to(pp.dtype), p, g)
        return p

    def group_aggregate(client_params, weights):
        """client_params leaves (N, ...), weights (N,) -> Eq. 2 mean."""
        w = (weights / weights.sum()).to(torch.float32)
        return tree_map(lambda x: torch.tensordot(w, x.to(torch.float32), dims=1).to(x.dtype),
                        client_params)

    def kd_loss_fn(student, server_batch, teacher_probs):
        s_logits = logits_fn(student, server_batch)
        V = s_logits.shape[-1]
        return kd_ops.kd_loss(s_logits.reshape(-1, V), teacher_probs.reshape(-1, V),
                              temperature)

    def round_step(stacked_globals: PyTree, client_batches: PyTree,
                   client_weights: torch.Tensor, server_batch) -> PyTree:
        # --- 1. local training: vmap groups × clients ---
        client_params = torch.func.vmap(
            torch.func.vmap(client_update, in_dims=(None, 0)),
            in_dims=(0, 0))(stacked_globals, client_batches)

        # --- 2. per-group weight averaging (Eq. 2) ---
        new_globals = torch.func.vmap(group_aggregate)(client_params, client_weights)
        del client_params

        # --- 3. teacher-ensemble softmax over the K aggregates (Eq. 3) ---
        teacher_probs = _ensemble_probs(logits_fn, new_globals, server_batch, temperature)

        # --- 4. KD updates ONLY the main global model (Eq. 4) ---
        main = tree_map(lambda x: x[0], new_globals)
        _, kd_g = value_and_grad(kd_loss_fn)(main, server_batch, teacher_probs)
        main = tree_map(lambda p, g: p - server_lr * g.to(p.dtype), main, kd_g)
        return tree_map(lambda stack, m: torch.cat([m[None].to(stack.dtype), stack[1:]]),
                        new_globals, main)

    return round_step


def make_distill_step_fn(logits_fn: Callable, *, server_lr: float = 0.1,
                         temperature: float = 4.0):
    """Standalone server KD step over a stacked teacher bank (M = K·R
    members, Eq. 5 temporal ensemble included in M): what the
    distillation-phase dry run lowers."""

    def loss(p, server_batch, probs):
        s = logits_fn(p, server_batch)
        return kd_ops.kd_loss(s.reshape(-1, s.shape[-1]), probs, temperature)

    def step(student: PyTree, stacked_teachers: PyTree, server_batch):
        probs = _ensemble_probs(logits_fn, stacked_teachers, server_batch, temperature)
        _, g = value_and_grad(loss)(student, server_batch, probs)
        return tree_map(lambda p, gg: p - server_lr * gg.to(p.dtype), student, g)

    return step
