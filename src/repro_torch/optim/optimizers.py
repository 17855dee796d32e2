"""Minimal functional optimizers over tensor pytrees (port of
``repro/optim/optimizers.py``).

An ``Optimizer`` is an (init, update) pair, as in the reference:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``update`` is out of place: the runner starts each client of a group
from the same global tensors, so an in-place update of one client's
params would corrupt the group's model for the next.  ``update_`` is the
same step in place, on params and state that a step program owns (its
static buffers, ``core/step_graph.py``), and it may overwrite the grads it
is given: the same ``torch._foreach_*`` ops in the same order, so the two
give the same bits.  A host counter in the state (SCAFFOLD's ``steps``) is
the caller's to advance there (``advance_steps``).  The vectorized
engine's bucket step keeps ``update``: a client on a padded step keeps its
params and state, so the step needs the old and the new tensors side by
side for its masked write-back, which an in-place update would have
overwritten.  The arithmetic of a step runs as ``torch._foreach_*``
ops over the tree's leaf list (a few multi-tensor launches on the GPU
instead of several per leaf), in the reference's order of operations.

FL-specific transforms:
  * ``with_fedprox``  — adds the FedProx proximal gradient μ(w − w_anchor)
                         [Li et al., MLSys 2020];
  * ``with_scaffold`` — SCAFFOLD control-variate correction g − c_i + c
                         [Karimireddy et al., ICML 2020].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils.pytree import (tree_leaves, tree_map, tree_sub,
                                      tree_unflatten, tree_zeros_like)

PyTree = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]
    update_: Callable[[PyTree, PyTree, PyTree], None]   # (grads, state, params), in place


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    ps = tree_leaves(params)
    us = [u.to(p.dtype) for u, p in zip(tree_leaves(updates), ps)]
    return tree_unflatten(params, torch._foreach_add(ps, us))


def _apply_updates_(ps: list, us: list) -> None:
    torch._foreach_add_(ps, [u.to(p.dtype) for u, p in zip(us, ps)])


def value_and_grad(fn: Callable, has_aux: bool = False) -> Callable:
    """``jax.value_and_grad`` for a function of a param tree: returns
    ``(value, grads)`` (``((loss, aux), grads)`` with ``has_aux``), the
    value detached and the grads a tree like the params.  A leaf the value
    never reaches (HuBERT's ``embed``) gets zeros, as ``jax.grad`` gives."""

    def wrapped(params, *args):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        out = fn(tree_unflatten(params, leaves), *args)
        loss = out[0] if has_aux else out
        grads = tree_unflatten(params, torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))
        if has_aux:
            return (loss.detach(), out[1]), grads
        return loss.detach(), grads

    return wrapped


# ---------------------------------------------------------------- SGD
def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_zeros_like(params)}

    def direction(grads, state, params, inplace: bool):
        """The update's leaves and the new momentum leaves (``state``'s own,
        advanced in place, with ``inplace``; then the update may be the
        gradient's leaves, scaled in place)."""
        g = tree_leaves(grads)
        if weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(tree_leaves(params), weight_decay))
        if momentum == 0.0:
            if inplace:
                torch._foreach_mul_(g, -lr)
                return g, None
            return torch._foreach_mul(g, -lr), None
        if inplace:
            mu = tree_leaves(state["mu"])
            torch._foreach_mul_(mu, momentum)
        else:
            mu = torch._foreach_mul(tree_leaves(state["mu"]), momentum)
        torch._foreach_add_(mu, g)
        return torch._foreach_mul(mu, -lr), mu

    def update(grads, state, params):
        u, mu = direction(grads, state, params, inplace=False)
        return (tree_unflatten(grads, u),
                state if mu is None else {"mu": tree_unflatten(grads, mu)})

    def update_(grads, state, params):
        u, _ = direction(grads, state, params, inplace=True)
        _apply_updates_(tree_leaves(params), u)

    return Optimizer(init, update, update_)


# ---------------------------------------------------------------- Adam
def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with the reference's bias correction and decoupled weight decay
    (``-lr·wd·p`` added to the update).  The step count ``t`` is an int32
    0-d tensor on the params' device, so ``update_`` advances it in place
    and a captured client step carries it with no host counter."""
    def init(params):
        dev = tree_leaves(params)[0].device
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def moments(grads, state, inplace: bool):
        g, m, v = tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"])
        if inplace:
            torch._foreach_mul_(m, b1)
            torch._foreach_mul_(v, b2)
        else:
            m, v = torch._foreach_mul(m, b1), torch._foreach_mul(v, b2)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        g2 = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(g2, g)
        torch._foreach_add_(v, g2)
        return m, v

    def direction(m, v, t, params):
        tf = t.float()
        u = torch._foreach_div(m, 1 - b1 ** tf)
        torch._foreach_mul_(u, -lr)
        d = torch._foreach_div(v, 1 - b2 ** tf)
        torch._foreach_sqrt_(d)
        torch._foreach_add_(d, eps)
        torch._foreach_div_(u, d)
        if weight_decay:
            ps = [p.to(x.dtype) for p, x in zip(tree_leaves(params), u)]
            torch._foreach_sub_(u, torch._foreach_mul(ps, lr * weight_decay))
        return u

    def update(grads, state, params):
        t = state["t"] + 1
        m, v = moments(grads, state, inplace=False)
        u = direction(m, v, t, params)
        return (tree_unflatten(grads, u),
                {"m": tree_unflatten(grads, m), "v": tree_unflatten(grads, v), "t": t})

    def update_(grads, state, params):
        state["t"].add_(1)
        m, v = moments(grads, state, inplace=True)
        _apply_updates_(tree_leaves(params), direction(m, v, state["t"], params))

    return Optimizer(init, update, update_)


# ---------------------------------------------------------------- FedProx
def with_fedprox(base: Optimizer, mu: float) -> Optimizer:
    """Adds μ(w − w_anchor) to the gradient.  State carries the anchor;
    set it once per round via ``state['anchor'] = global_params``."""

    def init(params):
        return {"base": base.init(params), "anchor": params}

    def proximal(grads, state, params):
        d = torch._foreach_sub(tree_leaves(params), tree_leaves(state["anchor"]))
        torch._foreach_mul_(d, mu)
        return tree_unflatten(grads, torch._foreach_add(tree_leaves(grads), d))

    def update(grads, state, params):
        upd, bstate = base.update(proximal(grads, state, params), state["base"], params)
        return upd, {"base": bstate, "anchor": state["anchor"]}

    def update_(grads, state, params):
        base.update_(proximal(grads, state, params), state["base"], params)

    return Optimizer(init, update, update_)


# ---------------------------------------------------------------- SCAFFOLD
class ScaffoldState(NamedTuple):
    base: Any
    c_local: Any     # client control variate c_i
    c_global: Any    # server control variate c
    steps: Any       # local step counter (for the c_i update rule): a host int,
                     # or a (C,) tensor of real steps on a stacked bucket


def with_scaffold(base: Optimizer, lr: float) -> Optimizer:
    """SCAFFOLD option-II.  Correction g − c_i + c each step; after local
    training, ``scaffold_new_control`` yields the updated c_i."""

    def init(params):
        return ScaffoldState(base.init(params), tree_zeros_like(params),
                             tree_zeros_like(params), 0)

    def corrected(grads, state):
        g = torch._foreach_sub(tree_leaves(grads), tree_leaves(state.c_local))
        torch._foreach_add_(g, tree_leaves(state.c_global))
        return tree_unflatten(grads, g)

    def update(grads, state, params):
        upd, bstate = base.update(corrected(grads, state), state.base, params)
        return upd, ScaffoldState(bstate, state.c_local, state.c_global,
                                  state.steps + 1)

    def update_(grads, state, params):
        base.update_(corrected(grads, state), state.base, params)

    return Optimizer(init, update, update_)


def advance_steps(state: PyTree, n: int) -> PyTree:
    """``state`` after ``n`` in-place steps: SCAFFOLD's host step count
    advanced by ``n`` (``update_`` leaves it to the caller); any other
    state as it is."""
    if isinstance(state, ScaffoldState):
        return state._replace(steps=state.steps + n)
    return state


def scaffold_new_control(state: ScaffoldState, w_start: PyTree, w_end: PyTree,
                         lr: float) -> PyTree:
    """Option-II control update: c_i' = c_i − c + (w_start − w_end)/(K·lr),
    with K·lr formed in f32 as the reference's device scalar is.

    On the vectorized engine's stacked state ``steps`` is a ``(C,)`` tensor
    of each client's real step count and every leaf carries the leading
    client axis: K·lr is formed per client and broadcast over each leaf."""
    delta = tree_sub(w_start, w_end)
    if isinstance(state.steps, torch.Tensor):
        denom = state.steps.to(torch.float32).clamp(min=1.0) * float(np.float32(lr))

        def per_client(d):
            return denom.reshape((-1,) + (1,) * (d.ndim - 1))

        return tree_map(lambda ci, c, d: ci - c + d.to(ci.dtype) / per_client(d),
                        state.c_local, state.c_global, delta)
    denom = float(np.float32(max(state.steps, 1)) * np.float32(lr))
    return tree_map(lambda ci, c, d: ci - c + d.to(ci.dtype) / denom,
                    state.c_local, state.c_global, delta)
