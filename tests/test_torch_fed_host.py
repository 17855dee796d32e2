"""Port vs reference: the numpy host logic of a federated round is
byte-identical — the synthetic classification data, the Dirichlet
partition, client sampling and grouping, and the per-client minibatch
schedules ``build_round_entries`` draws for a ``fedsdd`` config over
3 rounds.  numpy in both packages, so nothing but equality is allowed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jax_engine  # noqa: E402
from repro.core import grouping as jax_grouping  # noqa: E402
from repro.core.client_store import InMemoryStore as JaxStore  # noqa: E402
from repro.core.fedsdd import make_config as jax_make_config  # noqa: E402
from repro.data import partition as jax_partition  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro_torch.core import engine, grouping  # noqa: E402
from repro_torch.core.client_store import InMemoryStore  # noqa: E402
from repro_torch.core.fedsdd import make_config  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_classification_arrays_identical(seed):
    kw = dict(num_train=300, num_test=50, num_server=64, noise=0.6, seed=seed)
    mine, ref = synthetic.SyntheticClassification(**kw), jax_synthetic.SyntheticClassification(**kw)
    for a, b in zip(mine.train() + mine.test(), ref.train() + ref.test()):
        _same(a, b)
    _same(mine.server_unlabeled(), ref.server_unlabeled())
    for a, b in zip(mine.client_shard(7, 20), ref.client_shard(7, 20)):
        _same(a, b)
    x, y = mine.train()
    got = list(synthetic.batches(x, y, 64, np.random.default_rng(1)))
    want = list(jax_synthetic.batches(x, y, 64, np.random.default_rng(1)))
    assert len(got) == len(want) == 4
    for (ga, gb), (wa, wb) in zip(got, want):
        _same(ga, wa)
        _same(gb, wb)


@pytest.mark.parametrize("alpha,clients", [(0.1, 20), (0.5, 8), (1.0, 5)])
def test_dirichlet_partition_identical(alpha, clients):
    labels = np.random.default_rng(2).integers(0, 10, 2000).astype(np.int32)
    got = partition.dirichlet_partition(labels, clients, alpha, seed=17)
    want = jax_partition.dirichlet_partition(labels, clients, alpha, seed=17)
    assert len(got) == len(want) == clients
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("C,p,K", [(20, 0.4, 4), (8, 1.0, 3), (50, 0.1, 1)])
def test_sampling_and_grouping_identical(C, p, K):
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    a1 = grouping.sample_clients(C, p, r1)
    a2 = jax_grouping.sample_clients(C, p, r2)
    _same(a1, a2)
    g1, g2 = grouping.assign_groups(a1, K, r1), jax_grouping.assign_groups(a2, K, r2)
    for a, b in zip(g1, g2):
        _same(a, b)
    for a, b in zip(grouping.group_major_order(g1), jax_grouping.group_major_order(g2)):
        _same(a, b)
    with pytest.raises(ValueError, match="cannot fill"):
        grouping.assign_groups(np.arange(2), 3, np.random.default_rng(0))


class _Task:
    """Just what the stores read: ``client_data``."""

    def __init__(self, client_data):
        self.client_data = client_data


def test_round_schedules_identical_over_three_rounds():
    data = synthetic.SyntheticClassification(num_train=600, seed=0)
    x, y = data.train()
    parts = partition.dirichlet_partition(y, 10, 0.5, seed=17)
    task = _Task([(x[ix], y[ix]) for ix in parts])
    kw = dict(K=4, R=2, num_clients=10, participation=0.6, local_epochs=2,
              client_batch=16, seed=3)
    cfg, jcfg = make_config("fedsdd", **kw), jax_make_config("fedsdd", **kw)
    for t in (1, 2, 3):
        r1 = np.random.default_rng(cfg.seed * 100_000 + t)
        r2 = np.random.default_rng(jcfg.seed * 100_000 + t)
        g1 = grouping.assign_groups(grouping.sample_clients(10, 0.6, r1), 4, r1)
        g2 = jax_grouping.assign_groups(jax_grouping.sample_clients(10, 0.6, r2), 4, r2)
        got = engine.build_round_entries(task, cfg, g1, r1, store=InMemoryStore(task))
        want = jax_engine.build_round_entries(task, jcfg, g2, r2, store=JaxStore(task))
        assert len(got) == len(want) == 6
        for e, w in zip(got, want):
            assert (e.pos, e.cid, e.group, e.n, e.bs) == (w.pos, w.cid, w.group, w.n, w.bs)
            _same(e.idx, w.idx)
        _same(r1.random(4), r2.random(4))       # the streams stay in step
