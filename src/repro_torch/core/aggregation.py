"""Model aggregation, paper Eq. 2: weight averaging within a group (port of
``repro/core/aggregation.py``, the mean half).

Plain torch: on the sequential engine Eq. 2 is the reference's
``tree_weighted_mean`` too.  The grouped path, which reaches the
``weight_avg`` kernel, belongs to the vectorized engine; secure
aggregation's masks are drawn with ``jax.random`` and are not ported.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.utils.pytree import tree_stacked_weighted_mean, tree_weighted_mean

PyTree = Any


def fedavg_aggregate(models: Sequence[PyTree], num_samples: Sequence[int]) -> PyTree:
    """w = Σ_i (|X_i| / Σ_j |X_j|) · w_i   (Eq. 2), summed in client order."""
    return tree_weighted_mean(
        list(models), np.asarray(num_samples, np.float64))  # lint-ok: RA101 host counts


def fedavg_aggregate_stacked(stacked: PyTree, num_samples) -> PyTree:
    """Same, over leaves with a leading client axis."""
    return tree_stacked_weighted_mean(stacked, num_samples)
