"""Model aggregation, paper Eq. 2: weight averaging within a group (port of
``repro/core/aggregation.py``, the mean half).

The sequential engine averages a list of client models
(``fedavg_aggregate``).  The vectorized engine averages every group at once
over its client-stacked tree (``fedavg_aggregate_grouped``): uniform,
group-major groups on a CUDA device go through the ``weight_avg`` kernel
(``multi_weighted_average``); anything else through the segment reduction
``tree_group_weighted_mean``, as the reference routes them.  Under
faults, ``fedavg_aggregate_grouped_masked`` restricts Eq. 2 to the
surviving clients (``survivor_group_weights``); a round whose clients all
survive short-circuits to ``fedavg_aggregate_grouped``, kernel 5 on a
card.  Secure aggregation (``secure_aggregate``) is the reference's
simulated Bonawitz-style protocol: antisymmetric pairwise masks, each
client uploading ``w_i + m_i / ŵ_i``, the server averaging the uploads.
The masks are ``seeded_normal`` draws seeded from (seed, i, j, leaf) where
the reference uses ``jax.random``: the same construction, equal in
distribution, not in value.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.kernels.weight_avg import ops as wops
from repro_torch.utils.pytree import (seeded_normal, tree_group_weighted_mean, tree_leaves,
                                      tree_map, tree_stacked_weighted_mean,
                                      tree_weighted_mean, tree_zeros_like)

PyTree = Any


def fedavg_aggregate(models: Sequence[PyTree], num_samples: Sequence[int]) -> PyTree:
    """w = Σ_i (|X_i| / Σ_j |X_j|) · w_i   (Eq. 2), summed in client order."""
    return tree_weighted_mean(
        list(models), np.asarray(num_samples, np.float64))  # lint-ok: RA101 host counts


def fedavg_aggregate_stacked(stacked: PyTree, num_samples) -> PyTree:
    """Same, over leaves with a leading client axis."""
    return tree_stacked_weighted_mean(stacked, num_samples)


def _kernel_route(stacked: PyTree) -> bool:
    """The reference's ``wops._use_pallas()``: the stack lies on a CUDA
    device, where the wrapper launches the kernel."""
    return tree_leaves(stacked)[0].device.type == "cuda"


def fedavg_aggregate_grouped(stacked: PyTree, num_samples, group_ids,
                             num_groups: int) -> PyTree:
    """Eq. 2 for all K groups in one pass over a client-stacked tree.

    ``stacked`` leaves are (C, ...) in group-major client order and
    ``group_ids`` (C,) maps each row to its group.  Uniform groups (|S|/K
    clients each) are viewed as (K, n, ...) and reduced by
    ``group_weighted_average_pytree``, one kernel launch for the whole tree
    (its leaves are views of one allocation); ragged groups take the
    segment reduction.  No per-group Python loop either way.
    """
    gid = np.asarray(group_ids)            # lint-ok: RA101 host group map
    counts = np.bincount(gid, minlength=num_groups)
    uniform = (counts == counts[0]).all() and counts[0] > 0
    group_major = bool((np.diff(gid) >= 0).all())
    if uniform and group_major and _kernel_route(stacked):
        n = int(counts[0])
        dev = tree_leaves(stacked)[0].device
        w = to_device(torch.as_tensor(
            np.asarray(num_samples, np.float64)  # lint-ok: RA101 host counts
            .reshape(num_groups, n), dtype=torch.float32), dev)
        regrouped = tree_map(lambda x: x.reshape((num_groups, n) + tuple(x.shape[1:])),
                             stacked)
        return wops.group_weighted_average_pytree(regrouped, w)
    return tree_group_weighted_mean(stacked, num_samples, gid, num_groups)


def survivor_group_weights(num_samples, group_ids, num_groups: int,
                           survivor_mask) -> tuple:
    """(masked per-client weights, per-group live weight, empty groups):
    non-survivors weigh zero, and a group whose surviving weight is zero is
    ``empty`` (its aggregate comes from the carry-forward fallback).
    Shared by the masked Eq. 2 and the robust statistics."""
    mask = np.asarray(survivor_mask, bool)  # lint-ok: RA101 host fault mask
    gid = np.asarray(group_ids)             # lint-ok: RA101 host group map
    w_full = np.asarray(num_samples, np.float64)  # lint-ok: RA101 host counts
    w = np.where(mask, w_full, 0.0)
    live_w = np.bincount(gid, weights=w, minlength=num_groups)
    empty = [k for k in range(num_groups) if live_w[k] == 0.0]
    return w, live_w, empty


def fedavg_aggregate_grouped_masked(
        stacked: PyTree, num_samples, group_ids, num_groups: int,
        survivor_mask, fallback_stacked: PyTree,
        zero_fill: bool = False) -> tuple[PyTree, list[int]]:
    """Eq. 2 under partial participation; returns (aggregate, degraded).

    Non-survivors weigh zero and each group renormalises over its surviving
    weight (``zero_fill=True``, the ablation, keeps the whole group's
    denominator, shrinking the aggregate by the lost fraction).  A group
    with no survivor takes its row from ``fallback_stacked`` (the (K, ...)
    previous globals) and is reported in ``degraded``.  An all-True mask
    without zero_fill is ``fedavg_aggregate_grouped`` as it is, so a
    fault-free round is bit-identical to a run with no faults.
    """
    mask = np.asarray(survivor_mask, bool)  # lint-ok: RA101 host fault mask
    gid = np.asarray(group_ids)             # lint-ok: RA101 host group map
    if mask.all() and not zero_fill:
        return fedavg_aggregate_grouped(stacked, num_samples, gid, num_groups), []
    w_full = np.asarray(num_samples, np.float64)  # lint-ok: RA101 host counts
    w, live_w, empty = survivor_group_weights(num_samples, gid, num_groups, mask)
    # a zero weight does not silence a poisoned row (0·NaN = NaN, summed
    # into its group): dead rows are zeroed outright
    dev = tree_leaves(stacked)[0].device
    maskt = to_device(mask, dev)
    stacked = tree_map(
        lambda x: torch.where(maskt.reshape((-1,) + (1,) * (x.ndim - 1)), x,
                              torch.zeros((), dtype=x.dtype, device=dev))
        if x.is_floating_point() else x, stacked)
    # an empty group's row divides 0/0 into NaN; the fallback overwrites it
    agg = tree_group_weighted_mean(stacked, w, gid, num_groups)
    if zero_fill:
        total_w = np.bincount(gid, weights=w_full, minlength=num_groups)
        frac = to_device((live_w / np.maximum(total_w, 1e-300)).astype(np.float32), dev)
        agg = tree_map(
            lambda x: x * frac.reshape((num_groups,) + (1,) * (x.ndim - 1)).to(x.dtype)
            if x.is_floating_point() else x, agg)
    if empty:
        idx = to_device(torch.tensor(empty, dtype=torch.int64), dev)
        agg = tree_map(lambda a, f: a.index_copy(0, idx, f.index_select(0, idx).to(a.dtype)),
                       agg, fallback_stacked)
    return agg, empty


# ---------------------------------------------------------------- secure agg
def pairwise_masks(models: Sequence[PyTree], seed: int) -> list[PyTree]:
    """Antisymmetric pairwise masks: client i adds Σ_{j>i} r_ij − Σ_{j<i} r_ji.
    Masks cancel exactly in the (weighted) sum."""
    n = len(models)
    like = models[0]
    masks = [tree_zeros_like(like) for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            leaves = iter(range(len(tree_leaves(like))))
            r = tree_map(lambda x: seeded_normal((seed, i, j, next(leaves)), x.shape,
                                                 x.device).to(x.dtype), like)
            masks[i] = tree_map(torch.add, masks[i], r)
            masks[j] = tree_map(torch.sub, masks[j], r)
    return masks


def secure_aggregate(models: Sequence[PyTree], num_samples: Sequence[int],
                     seed: int = 0) -> tuple[PyTree, list[PyTree]]:
    """Simulated Bonawitz-style secure aggregation.

    Each client uploads w_i + m_i / ŵ_i where the masks are antisymmetric
    *after* weighting, so the weighted mean of the uploads equals Eq. 2 while
    every individual upload is noise to the server.  Returns
    (aggregate, uploaded_masked_models) so tests can assert both properties.
    """
    w = np.asarray(num_samples, np.float64)  # lint-ok: RA101 host counts
    w = w / w.sum()
    masks = pairwise_masks(models, seed)
    uploads = []
    for i, (m, msk) in enumerate(zip(models, masks)):
        # divide the mask by this client's weight so weighting cancels it
        uploads.append(tree_map(lambda x, r, i=i: x + (r / w[i]).to(x.dtype), m, msk))
    agg = tree_weighted_mean(uploads, w)
    return agg, uploads
