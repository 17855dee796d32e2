"""The port's client stores (``repro_torch/core/client_store.py``) and the
lazy scaling task, the spec of ``tests/test_client_store.py``.

  (a) the spilling store against the dense in-memory oracle, 3 rounds with
      a cache of 2 entries (constant eviction and restore): bit for bit
      for fedavg and fedprox on both engines; SCAFFOLD within the
      reference's own 1e-4 (the running control sum adds in another order
      than ``sum(xs) / len(xs)``); FedSDD with KD rides the store unchanged;
  (b) spilled controls survive a restart (a fresh store over the same
      directory), and an evicted data row restores bit for bit; the
      store's spills load in the reference's store too;
  (c) the LRU's eviction order and pinning, ``nbytes`` flat in the client
      count on ``synthetic_scaling_task`` and growing with the dense
      store's touched controls;
  (d) ``synthetic_scaling_task``'s lazy shards and server batches are the
      reference's bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.client_store import (_LRU, InMemoryStore, SpillingStore,  # noqa: E402
                                           resolve_cache_buckets)
from repro_torch.core.fedsdd import make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task, synthetic_scaling_task  # noqa: E402
from repro_torch.fedckpt.checkpointer import save_pytree  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def task():
    return classification_task(model="mlp", num_clients=6, alpha=0.5, num_train=240,
                               num_server=256, seed=0, device="cpu")


def small(**kw):
    base = dict(num_clients=6, participation=0.5, local_epochs=1, client_lr=0.05,
                server_lr=0.05, distill_steps=3, client_batch=32, rounds=3)
    base.update(kw)
    return base


def assert_trees(a, b, exact):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if exact:
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("preset", ["fedavg", "fedprox", "scaffold"])
@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_store_parity(task, tmp_path, preset, execution):
    mem = make_runner(preset, task, device="cpu", execution=execution, **small()).run()
    spill = make_runner(preset, task, device="cpu", execution=execution,
                        client_store="spilling", client_cache_buckets=2,
                        client_store_dir=str(tmp_path), **small()).run()
    assert isinstance(spill.store, SpillingStore) and isinstance(mem.store, InMemoryStore)
    exact = preset != "scaffold"
    for a, b in zip(mem.global_models, spill.global_models):
        assert_trees(a, b, exact)
    if preset == "scaffold":
        assert_trees(mem.scaffold_c_global, spill.scaffold_c_global, exact=False)
        assert any(f.startswith("ctrl_c") for f in __import__("os").listdir(tmp_path))


def test_store_parity_fedsdd(task, tmp_path):
    kw = small(participation=1.0, rounds=2)
    mem = make_runner("fedsdd", task, device="cpu", K=2, execution="vectorized", **kw).run()
    spill = make_runner("fedsdd", task, device="cpu", K=2, execution="vectorized",
                        client_store="spilling", client_cache_buckets=2,
                        client_store_dir=str(tmp_path), **kw).run()
    for a, b in zip(mem.global_models, spill.global_models):
        assert_trees(a, b, exact=True)


# ------------------------------------------------------------------- (b)
def test_spilled_controls_survive_restart(task, tmp_path):
    r = make_runner("scaffold", task, device="cpu", client_store="spilling",
                    client_cache_buckets=1, client_store_dir=str(tmp_path),
                    **small(participation=1.0, rounds=2))
    st = r.run()
    store = st.store
    for cid in range(len(task.client_data)):       # every control to disk
        save_pytree(store._ctrl_path(cid), store.get_control(cid))
    fresh = SpillingStore(task, capacity=4, directory=str(tmp_path))
    fresh.init_controls(st.global_models[0])
    assert_trees(store.control_mean(), fresh.control_mean(), exact=False)
    for cid in range(len(task.client_data)):
        assert_trees(store.get_control(cid), fresh.get_control(cid), exact=True)
    # the reference's store over the same directory takes the port's spills
    from repro.core.client_store import SpillingStore as JaxSpillingStore
    from repro.core.tasks import classification_task as jax_task
    import jax
    jt = jax_task(model="mlp", num_clients=6, alpha=0.5, num_train=240, num_server=256, seed=0)
    jstore = JaxSpillingStore(jt, capacity=4, directory=str(tmp_path))
    jstore.init_controls(jt.init_fn(jax.random.PRNGKey(0)))
    for cid in range(len(task.client_data)):
        jc, c = jstore.get_control(cid), store.get_control(cid)
        assert jc.keys() == c.keys()
        for k in c:
            np.testing.assert_array_equal(np.asarray(jc[k]), c[k].numpy())


def test_evicted_data_row_restores_bit_exact(task, tmp_path):
    store = SpillingStore(task, capacity=1, directory=str(tmp_path))
    n = store.num_examples(0)
    row0 = tree_map(torch.clone, store.get_data(0, n))
    store.get_data(1, n)        # capacity 1: evicts and spills row 0
    assert (tmp_path / f"data_c{0:08d}_n{n}.npz").exists()
    back = store.get_data(0, n)
    assert_trees(row0, back, exact=True)
    assert all(x.dtype == y.dtype for x, y in zip(tree_leaves(row0), tree_leaves(back)))


# ------------------------------------------------------------------- (c)
def test_lru_eviction_order():
    evicted = []
    lru = _LRU(2, on_evict=lambda k, v: evicted.append(k))
    lru.put(("row", 0, 8), "a")
    lru.put(("row", 1, 8), "b")
    lru.get(("row", 0, 8))
    lru.put(("row", 2, 8), "c")
    assert evicted == [("row", 1, 8)]
    lru.put(("row", 0, 8), "a2")
    lru.put(("row", 3, 8), "d")
    assert evicted == [("row", 1, 8), ("row", 2, 8)]


def test_sampled_view_pins_rows(task):
    store = InMemoryStore(task, capacity=2)
    with store.sampled_view([0, 1, 2]) as view:
        for c in (0, 1, 2):
            view.get_data(c, store.num_examples(c))
        assert len(store._data) == 3
    store.get_data(3, store.num_examples(3))
    assert len(store._data) <= 2


def test_nbytes_flat_in_client_count(tmp_path):
    sizes = {}
    for C in (64, 4096):
        t = synthetic_scaling_task(num_clients=C, examples_per_client=16, num_server=128,
                                   device="cpu")
        r = make_runner("fedavg", t, device="cpu", execution="vectorized", num_clients=C,
                        participation=4 / C, local_epochs=1, client_batch=8,
                        client_store="spilling", client_cache_buckets=4,
                        client_store_dir=str(tmp_path / str(C)))
        sizes[C] = r.run(rounds=2).store.nbytes()
    assert 0 < sizes[4096] <= sizes[64] * 1.25, sizes


def test_dense_store_nbytes_grows_with_touched_controls(task):
    store = InMemoryStore(task)
    zeros = {"w": torch.zeros((10, 4)), "b": torch.zeros(4)}
    store.init_controls(zeros)
    base = store.nbytes()
    assert base == 44 * 4
    store.put_control(0, tree_map(lambda x: x + 1.0, zeros))
    assert store.nbytes() == 2 * base
    assert resolve_cache_buckets(None) == 64 and resolve_cache_buckets(9) == 9


# ------------------------------------------------------------------- (d)
def test_synthetic_scaling_task_matches_reference():
    from repro.core.tasks import synthetic_scaling_task as jax_scaling
    jt = jax_scaling(num_clients=1000, examples_per_client=16, num_server=256)
    t = synthetic_scaling_task(num_clients=1000, examples_per_client=16, num_server=256,
                               device="cpu")
    assert len(t.client_data) == len(jt.client_data) == 1000
    assert t.client_data.num_examples(999) == 16
    for cid in (0, 7, 999):
        for a, b in zip(t.client_data[cid], jt.client_data[cid]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(t.server_batches) == len(jt.server_batches)
    for b, jb in zip(t.server_batches, jt.server_batches):
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(jb["x"]))
    with pytest.raises(IndexError):
        t.client_data[1000]
