"""Whole-tree algebra over tensor pytrees (port of
``repro/utils/pytree.py``).

A tree is what the reference's parameter trees are: nested dicts (and
lists, tuples, NamedTuples) whose leaves are tensors.  Every function
here is out of place: the runner hands one group's global tensors to
several clients, so nothing may write into a leaf it was given.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.device import to_device

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over corresponding leaves of congruent trees; containers are
    rebuilt with the same keys in the same order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):      # NamedTuple
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """The leaves in ``tree_map`` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: PyTree, leaves: Sequence) -> PyTree:
    """Inverse of ``tree_leaves``: ``leaves`` placed in ``like``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_axpy(alpha, x: PyTree, y: PyTree) -> PyTree:
    """alpha * x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_scale(tree: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, tree)


def tree_cast(tree: PyTree, dtype: torch.dtype) -> PyTree:
    """Cast floating leaves to ``dtype``; leaves already there pass through
    without a copy."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_stack(trees: Sequence[PyTree]) -> PyTree:
    """List of congruent trees -> one tree with a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_concat(trees: Sequence[PyTree], axis: int = 0) -> PyTree:
    """Concatenate congruent trees along an existing (leading) axis."""
    return tree_map(lambda *xs: torch.cat(xs, dim=axis), *trees)


def tree_unstack(stacked: PyTree) -> list[PyTree]:
    """Inverse of ``tree_stack``: the leading axis split back into a list
    (each leaf a view of the stacked one)."""
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda x: x[i], stacked) for i in range(n)]


def seeded_normal(words: Sequence[int], shape, device) -> torch.Tensor:
    """Standard normal f32 draws from a CPU ``torch.Generator`` seeded from
    the non-negative ints ``words`` (through ``np.random.SeedSequence``),
    then copied to ``device``: every engine, device and restart draws the
    same values.  The port's stand-in for a ``jax.random`` key — equal to
    the reference's draws in distribution, not in value."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32).to(device)


def tree_where(pred: torch.Tensor, on_true: PyTree, on_false: PyTree) -> PyTree:
    """Leafwise ``torch.where`` with a ``(C,)`` predicate broadcast over each
    leaf's trailing axes: the masked-step combinator of the vectorized
    engine.  A leaf that is the same object on both sides (a FedProx anchor,
    SCAFFOLD's controls) and a non-tensor leaf (the host step count) come
    back as ``on_true``'s without a launch."""
    def leaf(a, b):
        if a is b or not isinstance(a, torch.Tensor):
            return a
        return torch.where(pred.reshape(pred.shape + (1,) * (a.ndim - pred.ndim)), a, b)

    return tree_map(leaf, on_true, on_false)


def _f32_weights(weights) -> torch.Tensor:
    """Host weights as the reference takes them: f32, normalised in f32."""
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32)
    return w / w.sum()


def tree_weighted_sum(trees: Sequence[PyTree], weights) -> PyTree:
    """sum_i weights[i] * trees[i]: the leaves are stacked in list order and
    summed over the new axis, as ``repro.utils.pytree`` does."""
    weights = to_device(torch.as_tensor(weights), tree_leaves(trees[0])[0].device)

    def leaf(*leaves):
        stacked = torch.stack(leaves)
        w = weights.to(stacked.dtype).reshape((-1,) + (1,) * (stacked.ndim - 1))
        return (stacked * w).sum(0)

    return tree_map(leaf, *trees)


def tree_weighted_mean(trees: Sequence[PyTree], weights) -> PyTree:
    return tree_weighted_sum(trees, _f32_weights(weights))


def tree_stacked_weighted_mean(stacked: PyTree, weights) -> PyTree:
    """Weighted mean over the leading (client) axis of every leaf: Eq. 2
    when ``weights`` are the |X_i| dataset sizes."""
    norm = _f32_weights(weights).to(tree_leaves(stacked)[0].device)

    def leaf(x):
        w = norm.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        return (x * w).sum(0)

    return tree_map(leaf, stacked)


def tree_group_weighted_mean(stacked: PyTree, weights, group_ids,
                             num_groups: int) -> PyTree:
    """Per-group Eq. 2 over a client-stacked tree, as the reference's segment
    reduction: ``norm = w / totals[gid]`` in f32, then a segment sum of
    ``x · norm`` into a zero ``(num_groups, ...)`` leaf (``index_add_``).
    Ragged groups need no padding."""
    dev = tree_leaves(stacked)[0].device
    w = to_device(torch.as_tensor(np.asarray(weights), dtype=torch.float32), dev)
    gid = to_device(torch.as_tensor(np.asarray(group_ids), dtype=torch.int64), dev)
    totals = torch.zeros((num_groups,), dtype=torch.float32, device=dev).index_add_(0, gid, w)
    norm = w / totals[gid]

    def leaf(x):
        wx = norm.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        out = torch.zeros((num_groups,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
        return out.index_add_(0, gid, x * wx)

    return tree_map(leaf, stacked)


def tree_dot(a: PyTree, b: PyTree):
    """Sum over the leaves of each pair's dot product (a 0-d tensor)."""
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


def tree_sq_dist(a: PyTree, b: PyTree):
    d = tree_sub(a, b)
    return tree_dot(d, d)


def tree_size(tree: PyTree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_flatten_to_vector(tree: PyTree) -> torch.Tensor:
    """Every leaf raveled into one flat f32 vector, in ``tree_leaves`` order."""
    return torch.cat([x.reshape(-1).float() for x in tree_leaves(tree)])


def tree_unflatten_from_vector(vec: torch.Tensor, like: PyTree) -> PyTree:
    """Inverse of ``tree_flatten_to_vector``: ``vec``'s slices in ``like``'s
    shapes and dtypes."""
    out, off = [], 0
    for x in tree_leaves(like):
        out.append(vec[off:off + x.numel()].reshape(x.shape).to(x.dtype))
        off += x.numel()
    return tree_unflatten(like, out)


def _map_with_path(fn: Callable, tree: PyTree, path: str) -> PyTree:
    """``tree_map`` with each leaf's path, written as ``jax.tree_util.keystr``
    writes it: ``['k']`` a dict key, ``[i]`` a sequence index, ``.f`` a
    NamedTuple field."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, f"{path}.{f}")
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def tree_map_with_path(fn: Callable, tree: PyTree) -> PyTree:
    """``fn(path, leaf)`` over the leaves, ``path`` as ``tree_paths`` gives it."""
    return _map_with_path(fn, tree, "")


def tree_paths(tree: PyTree) -> list[str]:
    """Each leaf's path, ``jax.tree_util.keystr``'s form (``['blocks']['b0']
    ['k']``), in ``tree_leaves`` order: dict keys in insertion order, where
    JAX sorts them."""
    out: list = []
    tree_map_with_path(lambda p, _: out.append(p), tree)
    return out


def tree_all_finite(tree: PyTree) -> torch.Tensor:
    """A 0-d bool tensor: every floating leaf all finite (True with none)."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree) if x.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()
