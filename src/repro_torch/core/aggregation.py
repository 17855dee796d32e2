"""Model aggregation, paper Eq. 2: weight averaging within a group (port of
``repro/core/aggregation.py``, the mean half).

The sequential engine averages a list of client models
(``fedavg_aggregate``).  The vectorized engine averages every group at once
over its client-stacked tree (``fedavg_aggregate_grouped``): uniform,
group-major groups on a CUDA device go through the ``weight_avg`` kernel
(``multi_weighted_average``); anything else through the segment reduction
``tree_group_weighted_mean``, as the reference routes them.  Survivor
masks belong to the robustness slice; secure aggregation's masks are drawn
with ``jax.random`` and are not ported.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.kernels.weight_avg import ops as wops
from repro_torch.utils.pytree import (tree_group_weighted_mean, tree_leaves, tree_map,
                                      tree_stacked_weighted_mean, tree_weighted_mean)

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
        w = torch.as_tensor(
            np.asarray(num_samples, np.float64)  # lint-ok: RA101 host counts
            .reshape(num_groups, n), dtype=torch.float32).to(dev)
        regrouped = tree_map(lambda x: x.reshape((num_groups, n) + tuple(x.shape[1:])),
                             stacked)
        return wops.group_weighted_average_pytree(regrouped, w)
    return tree_group_weighted_mean(stacked, num_samples, gid, num_groups)
