"""The port's Byzantine-robust Eq. 2 (``repro_torch/core/robust_agg.py``)
and masked Eq. 2 (``core/aggregation.py``) against the reference's, the
spec of ``tests/test_robust_agg.py``.

The same numpy stacks go through both packages; each statistic matches at
rtol 1e-6 / atol 1e-7: the trimmed mean, the median (even group sizes
included: both average the two middle values), Krum and multi-Krum (the
same selected index, from inputs whose scores are separated by a planted
attacker), median-norm clipping, the masked mean with zero_fill and an
emptied group's carry-forward.  Within the port, ``aggregator="mean"`` and
clipping with a radius no row reaches are bit-identical to the masked
Eq. 2; survivors' order statistics ignore dead rows; the estimators are
invariant under a permutation of the clients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import robust_agg as jra  # noqa: E402
from repro.core.aggregation import fedavg_aggregate_grouped_masked as jax_masked  # noqa: E402
from repro.core.aggregation import survivor_group_weights as jax_survivor_weights  # noqa: E402
from repro_torch.core import robust_agg as ra  # noqa: E402
from repro_torch.core.aggregation import (fedavg_aggregate_grouped_masked,  # noqa: E402
                                          survivor_group_weights)
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def _rows(seed, n, shape=(3, 2)):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, 1, shape).astype(np.float32),
             "b": rng.normal(0, 1, (4,)).astype(np.float32)} for _ in range(n)]


def _both(rows):
    """The (C, ...) stack as the reference's jnp tree and the port's."""
    np_stack = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    return ({k: jnp.asarray(v) for k, v in np_stack.items()},
            {k: torch.from_numpy(v.copy()) for k, v in np_stack.items()})


def _close(port, ref, rtol=RTOL, atol=ATOL):
    for k in ref:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), rtol=rtol, atol=atol)


CASES = [  # (aggregator, n clients, groups, trim_frac)
    ("trimmed_mean", 8, 1, 0.25), ("trimmed_mean", 7, 2, 0.2), ("trimmed_mean", 3, 1, 0.4),
    ("median", 5, 1, 0.2), ("median", 6, 1, 0.2), ("median", 8, 2, 0.2), ("median", 2, 1, 0.2),
    ("multi_krum", 7, 1, 0.2), ("multi_krum", 8, 2, 0.25),
]


@pytest.mark.parametrize("aggregator,n,K,trim", CASES,
                         ids=[f"{a}-n{n}-K{k}" for a, n, k, _ in CASES])
def test_statistic_matches_reference(aggregator, n, K, trim):
    rows = _rows(n * 10 + K, n)
    rows[1]["w"] += 50.0                       # an outlier in group 0 or 1
    js, ps = _both(rows)
    gids = np.arange(n) % K
    sizes = np.arange(1, n + 1)
    want, wdeg = jra.robust_aggregate_grouped(js, sizes, gids, K, aggregator=aggregator,
                                              trim_frac=trim)
    got, deg = ra.robust_aggregate_grouped(ps, sizes, gids, K, aggregator=aggregator,
                                           trim_frac=trim)
    assert deg == wdeg == []
    _close(got, want)


@pytest.mark.parametrize("n", [2, 4, 6, 8])
def test_median_of_an_even_count_averages_the_middle_pair(n):
    x = np.random.default_rng(n).normal(0, 1, (n, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(ra.median(torch.from_numpy(x)).numpy(),
                               np.asarray(jnp.median(jnp.asarray(x), axis=0)),
                               rtol=0, atol=0)
    assert not np.allclose(ra.median(torch.from_numpy(x)).numpy(),
                           torch.from_numpy(x).median(dim=0).values.numpy())


@pytest.mark.parametrize("multi", [False, True])
def test_krum_selects_the_reference_index(multi):
    rng = np.random.default_rng(3)
    center = rng.normal(0, 1, (3, 2)).astype(np.float32)
    rows = [{"w": center + rng.normal(0, 0.01 * (i + 1), (3, 2)).astype(np.float32),
             "b": np.zeros(4, np.float32)} for i in range(6)]
    rows[2]["w"] = center + 100.0              # the planted attacker
    js, ps = _both(rows)
    f = ra._byzantine_f(0.2, 6)
    scores = ra.krum_scores(ra._flatten_rows(ps), f)
    jscores = jra._krum_scores(jra._flatten_rows(js), f)
    # the Gram form cancels: each score carries a few f32 ulps of |a|² + |b|²
    # for each of its n − f − 2 terms, whatever order the products sum in
    sq = float((ra._flatten_rows(ps) ** 2).sum(1).max())
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5,
                               atol=2.0 ** -20 * sq * (6 - f - 2))
    assert int(torch.argmin(scores)) == int(jnp.argmin(jscores))
    srt = np.sort(scores.numpy())
    assert srt[1] - srt[0] > 0                 # separated scores
    agg = "multi_krum" if multi else "krum"
    want, _ = jra.robust_aggregate_grouped(js, np.ones(6), np.zeros(6, int), 1,
                                           aggregator=agg, trim_frac=0.2)
    got, _ = ra.robust_aggregate_grouped(ps, np.ones(6), np.zeros(6, int), 1,
                                         aggregator=agg, trim_frac=0.2)
    _close(got, want)
    assert np.abs(got["w"][0].numpy() - center).max() < 1.0
    if not multi:       # Krum picks one honest row as it is
        assert any(np.array_equal(got["w"][0].numpy(), r["w"]) for i, r in enumerate(rows)
                   if i != 2)


def test_byzantine_f_matches_reference():
    for frac in (0.0, 0.2, 0.25, 0.49):
        for n in range(1, 12):
            assert ra._byzantine_f(frac, n) == jra._byzantine_f(frac, n)


# --------------------------------------------------- masks and carry-forward
@pytest.mark.parametrize("zero_fill", [False, True])
def test_masked_eq2_matches_reference(zero_fill):
    rows = _rows(5, 6)
    rows[2]["w"][:] = np.nan                   # a poisoned dead row
    js, ps = _both(rows)
    sizes = np.array([5, 1, 9, 3, 2, 7])
    gids = np.array([0, 1, 0, 1, 2, 2])
    mask = np.array([True, True, False, True, False, False])   # group 2 empties
    jfb = jax.tree.map(lambda x: jnp.full((3,) + x.shape[1:], 42.0), js)
    pfb = tree_map(lambda x: torch.full((3,) + x.shape[1:], 42.0), ps)
    want, wdeg = jax_masked(js, sizes, gids, 3, mask, jfb, zero_fill=zero_fill)
    got, deg = fedavg_aggregate_grouped_masked(ps, sizes, gids, 3, mask, pfb,
                                               zero_fill=zero_fill)
    assert deg == wdeg == [2]
    _close(got, want)
    assert np.isfinite(got["w"].numpy()).all() and (got["w"][2] == 42.0).all()


def test_survivor_group_weights_match_reference():
    args = (np.array([2, 4, 6, 8]), np.array([0, 0, 1, 1]), 2,
            np.array([True, False, False, False]))
    w, live, empty = survivor_group_weights(*args)
    jw, jlive, jempty = jax_survivor_weights(*args)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(live, jlive)
    assert empty == jempty == [1]


def test_robust_statistics_skip_dead_rows_and_carry_forward():
    rows = _rows(7, 6)
    rows[2]["w"][:] = np.inf                   # dead: must not enter a sort
    js, ps = _both(rows)
    gids = np.array([0, 0, 0, 1, 1, 1])
    mask = np.array([True, True, False, False, False, False])
    fb = tree_map(lambda x: x[:2] * 0 + 42.0, ps)
    agg, deg = ra.robust_aggregate_grouped(ps, np.ones(6), gids, 2, aggregator="median",
                                           survivor_mask=mask, fallback_stacked=fb)
    want, wdeg = jra.robust_aggregate_grouped(
        js, np.ones(6), gids, 2, aggregator="median", survivor_mask=mask,
        fallback_stacked=jax.tree.map(lambda x: x[:2] * 0 + 42.0, js))
    assert deg == wdeg == [1]
    _close(agg, want)
    with pytest.raises(ValueError):
        ra.robust_aggregate_grouped(ps, np.ones(6), gids, 2, aggregator="median",
                                    survivor_mask=np.zeros(6, bool))
    with pytest.raises(ValueError):
        ra.robust_aggregate_grouped(ps, np.ones(6), gids, 2, aggregator="huber")


# ------------------------------------------------- clipping and the mean
def test_clip_to_median_norm_matches_reference():
    rng = np.random.default_rng(10)
    deltas = [1.0, 1.2, 0.9, 50.0, 2.0, 0.5]
    rows = []
    for s in deltas:
        d = rng.normal(0, 1, (4, 3)).astype(np.float32)
        rows.append({"w": (s * d / np.linalg.norm(d)).astype(np.float32)})
    js, ps = _both(rows)
    gids = np.array([0, 0, 0, 0, 1, 1])
    mask = np.array([True, True, True, True, True, False])
    ref = {"w": np.random.default_rng(1).normal(0, 0.1, (2, 4, 3)).astype(np.float32)}
    want = jra.clip_to_median_norm(js, gids, 2, mask, {"w": jnp.asarray(ref["w"])}, 2.0)
    got = ra.clip_to_median_norm(ps, gids, 2, mask, {"w": torch.from_numpy(ref["w"])}, 2.0)
    _close(got, want)


def test_mean_and_unreached_clip_are_the_masked_eq2_bit_for_bit():
    rows = _rows(11, 6)
    _, ps = _both(rows)
    sizes = np.array([5, 1, 9, 3, 2, 7])
    gids = np.array([0, 1, 0, 1, 0, 1])
    mask = np.array([True, True, False, True, True, True])
    fb = tree_map(lambda x: x[:2], ps)
    want, _ = fedavg_aggregate_grouped_masked(ps, sizes, gids, 2, mask, fb)
    for clip in (None, 1e6):
        got, deg = ra.robust_aggregate_grouped(ps, sizes, gids, 2, aggregator="mean",
                                               clip_norm=clip, survivor_mask=mask,
                                               fallback_stacked=fb)
        assert deg == []
        for a, b in zip(tree_leaves(want), tree_leaves(got)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("aggregator", ra.AGGREGATORS)
def test_aggregate_permutation_invariant(aggregator):
    rows = _rows(12, 6)
    _, ps = _both(rows)
    sizes, gids = np.arange(1, 7), np.zeros(6, int)
    a, _ = ra.robust_aggregate_grouped(ps, sizes, gids, 1, aggregator=aggregator, trim_frac=0.2)
    for perm in ([5, 0, 3, 1, 4, 2], [2, 1, 0, 5, 4, 3]):
        p = np.asarray(perm)
        b, _ = ra.robust_aggregate_grouped(tree_map(lambda x: x[p], ps), sizes[p], gids[p], 1,
                                           aggregator=aggregator, trim_frac=0.2)
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-6)
