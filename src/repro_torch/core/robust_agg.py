"""Byzantine-robust Eq. 2: order statistics over the client-stacked axis
(port of ``repro/core/robust_agg.py``).

The isfinite guard rejects NaN and Inf uploads, but a finite adversarial
update (``faults.attack_model``) passes it, and one sign-flipped client at
``attack_scale=10`` dominates a group's weighted mean.  These statistics,
over the same ``(C, ...)`` stacked tree the vectorized engine holds, break
down only at a constant fraction of the group:

  ``trimmed_mean``  per coordinate: sort the client axis, drop the
                    ``ceil(trim_frac·n)`` lowest and highest, mean the rest
                    (with nothing left, the median).
  ``median``        per coordinate; an even count averages the two middle
                    values, as ``jnp.median`` does (``torch.median`` would
                    return the lower one).
  ``krum``          the one update whose summed squared distance to its
                    ``n − f − 2`` nearest peers is smallest (Blanchard et
                    al.), from the Gram form |a|² + |b|² − 2a·b over the
                    flattened models, as the reference forms it.
  ``multi_krum``    the mean of the ``n − f`` best-scored updates.
  clip_norm         each survivor's update against its group's round-start
                    model is scaled down to at most ``clip_norm`` × the
                    group's median update norm before the statistic; it
                    composes with every aggregator, the mean included.

As in ``aggregation.fedavg_aggregate_grouped_masked``: only survivors
enter a statistic, a group with none carries its previous global forward
and is reported degraded, and ``aggregator="mean"`` is the masked Eq. 2
itself (kernel 5 on a card when every client survives).  The order
statistics ignore the |X_i| weights, which an adversary could lie about.
Everything is plain torch, a host loop over the K groups, once a round.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.analysis.sync import allowed_sync
from repro_torch.core.aggregation import (fedavg_aggregate_grouped_masked,
                                          survivor_group_weights)
from repro_torch.utils.pytree import tree_leaves, tree_map

PyTree = Any

AGGREGATORS = ("mean", "trimmed_mean", "median", "krum", "multi_krum")


def _byzantine_f(trim_frac: float, n: int) -> int:
    """The assumed adversary count in a group of n: ceil(trim_frac·n), kept
    below n so that one client always survives the trim."""
    return min(max(0, math.ceil(trim_frac * n)), n - 1)


# ---------------------------------------------------------------------
# per-group statistics over an (n, ...) stacked tree
# ---------------------------------------------------------------------
def _median_sorted(xs: torch.Tensor) -> torch.Tensor:
    """The median over axis 0 of an already sorted stack: the middle row,
    or the midpoint of the two middle rows for an even count."""
    n = xs.shape[0]
    if n % 2:
        return xs[n // 2]
    return (xs[n // 2 - 1] + xs[n // 2]) * 0.5


def median(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.median(x, axis=dim)``: an even count averages the two middle
    values."""
    return _median_sorted(torch.sort(x, dim=dim).values.movedim(dim, 0))


def _trimmed_mean(sub: PyTree, t: int) -> PyTree:
    def stat(x):
        if not x.is_floating_point():
            return x[0]
        n = x.shape[0]
        xs = torch.sort(x.float(), dim=0).values
        if 2 * t >= n:      # nothing left after the trim: the median
            return _median_sorted(xs).to(x.dtype)
        return xs[t:n - t].mean(dim=0).to(x.dtype)
    return tree_map(stat, sub)


def _median(sub: PyTree) -> PyTree:
    return tree_map(lambda x: median(x.float()).to(x.dtype)
                    if x.is_floating_point() else x[0], sub)


def _flatten_rows(sub: PyTree) -> torch.Tensor:
    """(n, P) f32: every floating leaf of each client, flattened."""
    return torch.cat([x.reshape(x.shape[0], -1).float()
                      for x in tree_leaves(sub) if x.is_floating_point()], dim=1)


def krum_scores(flat: torch.Tensor, f: int) -> torch.Tensor:
    """(n,) Krum scores: each row's sum of its n−f−2 smallest squared
    distances to the other rows (smaller: better supported)."""
    n = flat.shape[0]
    sq = (flat * flat).sum(dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)).clamp_min(0.0)
    d2.fill_diagonal_(float("inf"))
    m = max(1, n - f - 2)
    return torch.sort(d2, dim=1).values[:, :m].sum(dim=1)


def _krum(sub: PyTree, f: int, multi: bool) -> PyTree:
    n = tree_leaves(sub)[0].shape[0]
    if n == 1:
        return tree_map(lambda x: x[0], sub)
    scores = krum_scores(_flatten_rows(sub), f)
    if not multi:
        with allowed_sync("krum selection index: one scalar pull per group per round"):
            sel = int(torch.argmin(scores))
        return tree_map(lambda x: x[sel], sub)
    best = torch.argsort(scores, stable=True)[:max(1, n - f)]
    return tree_map(lambda x: x[best].float().mean(dim=0).to(x.dtype)
                    if x.is_floating_point() else x[0], sub)


# ---------------------------------------------------------------------
# median-norm-ball clipping (before the statistic)
# ---------------------------------------------------------------------
def clip_to_median_norm(stacked: PyTree, group_ids, num_groups: int, survivor_mask,
                        ref_stacked: PyTree, clip_norm: float) -> PyTree:
    """Clip each survivor's update onto its group's median-norm ball: row
    c's Δ_c = w_c − ref[group(c)] is scaled down to ``clip_norm`` × the
    median ‖Δ‖ over the group's survivors where it is longer.  The norms
    are one (C,) host read; the median is taken on the host in f64."""
    gid = np.asarray(group_ids)            # lint-ok: RA101 host group map
    mask = np.asarray(survivor_mask, bool)  # lint-ok: RA101 host fault mask
    dev = tree_leaves(stacked)[0].device
    gidt = torch.from_numpy(gid.astype(np.int64)).to(dev)
    refrows = tree_map(lambda r: r[gidt], ref_stacked)
    n2 = None
    for x, r in zip(tree_leaves(stacked), tree_leaves(refrows)):
        if not x.is_floating_point():
            continue
        d = (x.float() - r.float()).reshape(x.shape[0], -1)
        s = (d * d).sum(dim=1)
        n2 = s if n2 is None else n2 + s
    if n2 is None:
        return stacked
    with allowed_sync("host clip radius: one (C,) norm pull per round feeds the "
                      "per-group median-norm ball"):
        norms = torch.sqrt(n2).cpu().numpy().astype(np.float64)
    factor = np.ones_like(norms)
    for k in range(num_groups):
        rows = np.nonzero((gid == k) & mask)[0]
        if not len(rows):
            continue
        radius = clip_norm * float(np.median(norms[rows]))
        nz = rows[norms[rows] > max(radius, 1e-12)]
        factor[nz] = radius / norms[nz]
    if (factor >= 1.0).all():
        return stacked
    ft = torch.from_numpy(factor.astype(np.float32)).to(dev)
    return tree_map(
        lambda x, r: (r.float() + (x.float() - r.float())
                      * ft.reshape((-1,) + (1,) * (x.ndim - 1))).to(x.dtype)
        if x.is_floating_point() else x, stacked, refrows)


# ---------------------------------------------------------------------
# the grouped entry point (beside fedavg_aggregate_grouped_masked)
# ---------------------------------------------------------------------
def robust_aggregate_grouped(
        stacked: PyTree, num_samples, group_ids, num_groups: int, *,
        aggregator: str = "mean", trim_frac: float = 0.2,
        clip_norm: Optional[float] = None, survivor_mask=None,
        fallback_stacked: Optional[PyTree] = None) -> tuple[PyTree, list[int]]:
    """Robust Eq. 2 for all K groups; returns (aggregate, degraded), with
    ``fedavg_aggregate_grouped_masked``'s contract: (C, ...) leaves, rows
    mapped to groups by ``group_ids``, non-survivors excluded, an emptied
    group's row from ``fallback_stacked``.  ``aggregator="mean"`` (with or
    without ``clip_norm``) is the masked weighted mean; the order
    statistics are unweighted."""
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; "
                         f"pick one of {AGGREGATORS}")
    gid = np.asarray(group_ids)            # lint-ok: RA101 host group map
    if survivor_mask is None:
        survivor_mask = np.ones((len(gid),), bool)
    mask = np.asarray(survivor_mask, bool)  # lint-ok: RA101 host fault mask
    _, _, empty = survivor_group_weights(num_samples, gid, num_groups, mask)
    if empty and fallback_stacked is None:
        raise ValueError(f"groups {empty} have no surviving clients and no "
                         "fallback_stacked was provided to carry forward")
    if clip_norm is not None:
        if fallback_stacked is None:
            raise ValueError("clip_norm needs fallback_stacked (the round-"
                             "start globals) as the update reference point")
        stacked = clip_to_median_norm(stacked, gid, num_groups, mask, fallback_stacked,
                                      clip_norm)
    if aggregator == "mean":
        return fedavg_aggregate_grouped_masked(stacked, num_samples, gid, num_groups, mask,
                                               fallback_stacked)
    dev = tree_leaves(stacked)[0].device
    per_group = []
    for k in range(num_groups):
        if k in empty:
            per_group.append(tree_map(lambda x: x[k], fallback_stacked))
            continue
        rows = np.nonzero((gid == k) & mask)[0]
        idx = torch.from_numpy(rows.astype(np.int64)).to(dev)
        sub = tree_map(lambda x: x.index_select(0, idx), stacked)
        f = _byzantine_f(trim_frac, len(rows))
        if aggregator == "trimmed_mean":
            per_group.append(_trimmed_mean(sub, f))
        elif aggregator == "median":
            per_group.append(_median(sub))
        else:
            per_group.append(_krum(sub, f, multi=aggregator == "multi_krum"))
    return tree_map(lambda *xs: torch.stack(xs), *per_group), empty
