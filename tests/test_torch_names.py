"""Port vs reference: the public names the port gained after its modules,
each held against its JAX twin on the same seeded numpy inputs.

* ``optim.adam``: 5 steps with and without weight decay against the
  reference's ``adam`` (rtol 1e-5 / atol 1e-7: f32 both sides, the same
  order of operations), and ``update`` against the in-place ``update_``
  bit for bit, the step count an int32 device scalar.
* ``utils/pytree.py``: ``tree_add``, ``tree_axpy``, ``tree_dot``,
  ``tree_sq_dist``, ``tree_size``, ``tree_bytes``,
  ``tree_flatten_to_vector``, ``tree_unflatten_from_vector``,
  ``tree_paths``, ``tree_map_with_path`` and ``tree_all_finite``.
* ``data/partition.py::heterogeneity`` (equal) and
  ``models/layers.py::kl_divergence`` (rtol 1e-6).
* ``Model.cache_shapes`` against the reference's shapes and dtypes for
  every registered arch's ``reduced()`` config; ``paged_cache_shapes``
  equal for the all-GQA ones and raising the reference's ``ValueError``
  for MLA and recurrent schedules; ``init_cache`` built from them.
* ``ContinuousEngine.pool_utilization``, ``TeacherBank.round_stack`` (a
  copy a later push leaves as it was), ``ClientStore.has_controls``
  (``scaffold`` against ``fedavg``), ``KDPipeline.nbytes`` before and
  after a round, ``PendingKD.result`` under ``overlap="async"`` and
  ``FederatedRunner.local_train`` for one client, each against the JAX
  runner's on the tiny MLP task (rounds and training at 2e-4, the
  reference's end-to-end tolerance).
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.fedsdd import FedState as JaxFedState  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import classification_task as jax_classification_task  # noqa: E402
from repro.data.partition import heterogeneity as jax_heterogeneity  # noqa: E402
from repro.distill import TeacherBank as JaxTeacherBank  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.serve.paged_cache import BlockAllocator as JaxBlockAllocator  # noqa: E402
from repro.serve.paged_cache import blocks_needed as jax_blocks_needed  # noqa: E402
from repro.utils import pytree as jpt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.round_plan import PendingKD  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.data.partition import dirichlet_partition, heterogeneity  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.models import layers, model_zoo  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.serve import ContinuousEngine, Request  # noqa: E402
from repro_torch.utils import pytree as pt  # noqa: E402

TOL = 2e-4
TASK = dict(model="mlp", num_clients=8, alpha=0.5, num_train=320, num_server=256, seed=0)
RUN = dict(num_clients=8, participation=1.0, local_epochs=1, client_lr=0.05,
           server_lr=0.05, distill_steps=4, client_batch=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed: int, scale: float = 1.0) -> dict:
    """A small parameter-like tree: nested dicts, a list, mixed ranks."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    return {"w": f(5, 3), "blocks": [{"a": f(4), "b": f(2, 2, 3)}, {"a": f(4), "b": f(2, 2, 3)}],
            "bias": f(3)}


def _t(tree):
    return interop.params_from_numpy(tree, device="cpu")


def _close(port, ref, rtol=1e-6, atol=1e-7):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=rtol, atol=atol),
                 interop.params_to_numpy(port), jax.tree.map(np.asarray, ref))


# ------------------------------------------------------------------ adam
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_matches_reference(weight_decay):
    params = _tree(0)
    grads = [_tree(10 + i, scale=0.1) for i in range(5)]
    jo = jopt.adam(1e-2, weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    o = adam(1e-2, weight_decay=weight_decay)
    p = _t(params)
    s = o.init(p)
    assert s["t"].dtype == torch.int32 and s["t"].shape == ()
    # the in-place twin: its own params and state
    p_, s_ = pt.tree_map(torch.clone, p), o.init(p)
    for g in grads:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        u, s = o.update(_t(g), s, p)
        p = pt.tree_map(lambda a, b: a + b, p, u)
        o.update_(_t(g), s_, p_)
    _close(p, jp, rtol=1e-5, atol=1e-7)
    _close(s["m"], js["m"], rtol=1e-5, atol=1e-8)
    _close(s["v"], js["v"], rtol=1e-5, atol=1e-10)
    assert int(s["t"]) == int(js["t"]) == 5 and int(s_["t"]) == 5
    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(p), pt.tree_leaves(p_)))
    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(s), pt.tree_leaves(s_)))


# ---------------------------------------------------------------- pytree
def test_pytree_functions_match_reference():
    a, b = _tree(1), _tree(2)
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = _t(a), _t(b)
    _close(pt.tree_add(ta, tb), jpt.tree_add(ja, jb))
    _close(pt.tree_axpy(0.3, ta, tb), jpt.tree_axpy(0.3, ja, jb))
    np.testing.assert_allclose(float(pt.tree_dot(ta, tb)), float(jpt.tree_dot(ja, jb)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pt.tree_sq_dist(ta, tb)),
                               float(jpt.tree_sq_dist(ja, jb)), rtol=1e-6)
    mixed = {**a, "half": np.ones((3, 5), np.float16), "ids": np.arange(6, dtype=np.int32)}
    assert pt.tree_size(_t(mixed)) == jpt.tree_size(jax.tree.map(jnp.asarray, mixed))
    assert pt.tree_bytes(_t(mixed)) == jpt.tree_bytes(jax.tree.map(jnp.asarray, mixed))
    vec = pt.tree_flatten_to_vector(ta)
    # JAX sorts dict keys, the port keeps insertion order: a tree with its
    # keys in sorted order has one leaf order in both
    ordered = {k: a[k] for k in sorted(a)}
    np.testing.assert_array_equal(pt.tree_flatten_to_vector(_t(ordered)).numpy(),
                                  np.asarray(jpt.tree_flatten_to_vector(
                                      jax.tree.map(jnp.asarray, ordered))))
    back = pt.tree_unflatten_from_vector(vec * 2, ta)
    _close(back, jax.tree.map(lambda x: 2 * x, ja))
    tm = _t(mixed)
    again = pt.tree_unflatten_from_vector(pt.tree_flatten_to_vector(tm), tm)
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(pt.tree_leaves(again), pt.tree_leaves(tm)))
    assert sorted(pt.tree_paths(ta)) == sorted(jpt.tree_paths(ja))
    assert pt.tree_paths(_t(ordered)) == jpt.tree_paths(jax.tree.map(jnp.asarray, ordered))
    named = pt.tree_map_with_path(lambda p, x: (p, tuple(x.shape)), ta)
    jnamed = jpt.tree_map_with_path(lambda p, x: (p, tuple(x.shape)), ja)
    assert named["blocks"][1]["b"] == tuple(jnamed["blocks"][1]["b"])
    assert named["w"] == tuple(jnamed["w"])
    assert bool(pt.tree_all_finite(ta)) and bool(jpt.tree_all_finite(ja))
    bad = dict(a, w=np.full((5, 3), np.inf, np.float32))
    assert not bool(pt.tree_all_finite(_t(bad)))
    assert not bool(jpt.tree_all_finite(jax.tree.map(jnp.asarray, bad)))
    ints = {"ids": np.arange(3, dtype=np.int32)}
    assert bool(pt.tree_all_finite(_t(ints))) == bool(jpt.tree_all_finite(
        jax.tree.map(jnp.asarray, ints)))


def test_tree_paths_name_namedtuple_fields():
    from repro.optim.optimizers import ScaffoldState as JaxScaffold

    from repro_torch.optim.optimizers import ScaffoldState
    leaf = np.zeros(2, np.float32)
    tree = ScaffoldState({"mu": torch.from_numpy(leaf)}, [torch.from_numpy(leaf)],
                         {"x": torch.from_numpy(leaf)}, torch.zeros(()))
    jtree = JaxScaffold({"mu": jnp.asarray(leaf)}, [jnp.asarray(leaf)],
                        {"x": jnp.asarray(leaf)}, jnp.zeros(()))
    assert pt.tree_paths(tree) == jpt.tree_paths(jtree)


# ------------------------------------------- heterogeneity, kl_divergence
@pytest.mark.parametrize("alpha", [0.1, 1.0, 100.0])
def test_heterogeneity_matches_reference(alpha):
    labels = np.random.default_rng(0).integers(0, 10, 2_000)
    parts = dirichlet_partition(labels, 20, alpha, np.random.default_rng(1))
    assert heterogeneity(parts, labels) == jax_heterogeneity(parts, labels)


@pytest.mark.parametrize("temperature", [1.0, 4.0])
def test_kl_divergence_matches_reference(temperature):
    rng = np.random.default_rng(3)
    s = rng.normal(size=(6, 50)).astype(np.float32) * 3
    t = rng.dirichlet(np.ones(50) * 0.3, size=6).astype(np.float32)
    t[0, :5] = 0.0                      # zero teacher probabilities: the clip
    want = float(jlayers.kl_divergence(jnp.asarray(s), jnp.asarray(t), temperature))
    got = float(layers.kl_divergence(torch.from_numpy(s), torch.from_numpy(t), temperature))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --------------------------------------------------------- cache shapes
def _shapes(tree):
    """Shape pytree -> sorted [(path, shape, dtype name)]."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif node is not None:
            shape, dtype = node
            name = (str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype)
                    else np.dtype(dtype).name)
            out.append((path, tuple(shape), name))
    walk(tree, "")
    return sorted(out)


@pytest.mark.parametrize("arch", list_configs())
def test_cache_shapes_match_reference(arch):
    model = model_zoo.build_model(get_config(arch).reduced())
    jmodel = jzoo.build_model(jax_get_config(arch).reduced())
    shapes = model.cache_shapes(2, 32)
    assert _shapes(shapes) == _shapes(jmodel.cache_shapes(2, 32))
    cache = model.init_cache(2, 32, device="cpu")
    assert _shapes(shapes) == _shapes(jax.tree.map(lambda x: (tuple(x.shape), x.dtype), cache))
    assert all(float(x.abs().sum()) == 0 for x in pt.tree_leaves(cache))
    if {k.mixer for k in model.schedule} == {"gqa"}:
        assert _shapes(model.paged_cache_shapes(9, 4)) == _shapes(
            jmodel.paged_cache_shapes(9, 4))
        pool = model.init_paged_cache(9, 4, device="cpu")
        assert pt.tree_leaves(pool)[0].shape[-4:-2] == (9, 4)
    else:
        for m in (model, jmodel):
            with pytest.raises(ValueError, match="all-GQA"):
                m.paged_cache_shapes(9, 4)


# ------------------------------------------------------ serve, distill
def test_pool_utilization_follows_the_allocator():
    cfg = get_config("qwen2.5-14b").reduced()
    model = model_zoo.build_model(cfg)
    eng = ContinuousEngine(model, model.init(0, device="cpu"), max_batch=2, num_blocks=16,
                           block_size=4, max_seq_len=24, chunk_steps=2)
    ref = JaxBlockAllocator(16)
    assert eng.pool_utilization == ref.utilization == 0.0
    rng = np.random.default_rng(0)
    for rid, (L, new) in enumerate([(6, 9), (9, 7)]):
        eng.submit(Request(rid=rid, tokens=rng.integers(0, cfg.vocab_size, L).astype(np.int32),
                           max_new_tokens=new))
        ref.alloc(jax_blocks_needed(L, new, 4))
    eng.step()
    assert eng.pool_utilization == ref.utilization > 0
    eng.run([])
    assert eng.pool_utilization == 0.0


def test_round_stack_matches_reference_and_survives_a_push():
    K, R = 2, 2
    rounds = [[_tree(100 * r + k) for k in range(K)] for r in range(3)]
    bank, jbank = TeacherBank(K, R), JaxTeacherBank(K, R)
    for r in range(2):
        bank.push(r, [_t(m) for m in rounds[r]])
        jbank.push(r, [jax.tree.map(jnp.asarray, m) for m in rounds[r]])
    stacks = [bank.round_stack(s) for s in range(R)]
    for s in range(R):
        _close(stacks[s], jbank.round_stack(s), rtol=0, atol=0)
    bank.push(2, [_t(m) for m in rounds[2]])          # overwrites slot 0
    _close(stacks[0], jax.tree.map(lambda *xs: np.stack(xs), *rounds[0]), rtol=0, atol=0)
    _close(bank.round_stack(0), jax.tree.map(lambda *xs: np.stack(xs), *rounds[2]),
           rtol=0, atol=0)


@pytest.fixture(scope="module")
def task():
    return classification_task(**TASK, device="cpu")


@pytest.fixture(scope="module")
def jtask():
    return jax_classification_task(**TASK)


def _init(jtask, jrunner, K: int):
    keys = jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), K)
    return [jax.tree.map(np.asarray, jtask.init_fn(k)) for k in keys]


@pytest.mark.parametrize("preset,want", [("scaffold", True), ("fedavg", False)])
def test_has_controls(task, jtask, preset, want):
    runner = make_runner(preset, task, device="cpu", **RUN)
    jrunner = jax_make_runner(preset, jtask, **RUN)
    state = FedState(round=0, global_models=[_t(m) for m in _init(jtask, jrunner, 1)],
                     ensemble=None)
    assert runner._store(state).has_controls is want
    assert jrunner._store(jrunner.init_state()).has_controls is want


def test_kd_pipeline_nbytes_before_and_after_a_round(task, jtask):
    runner = make_runner("fedsdd", task, device="cpu", K=2, R=1, **RUN)
    jrunner = jax_make_runner("fedsdd", jtask, K=2, R=1, **RUN)
    assert runner._kd_pipeline().nbytes() == 0 == jrunner._kd_pipeline().nbytes()
    runner.run(1)
    jrunner.run(rounds=1)
    got = runner._kd_pipe.nbytes()
    batches = runner._kd_pipe._batches
    assert got == sum(x.numel() * x.element_size() for x in pt.tree_leaves(batches)) > 0
    # equal to the reference's where the leaves' dtypes agree (x f32; the
    # labels' integer width is each package's own)
    want = {k: int(np.prod(x.shape)) * x.dtype.itemsize
            for k, x in jrunner._kd_pipe._batches.items()}
    assert want["x"] == batches["x"].numel() * batches["x"].element_size()


def test_pending_kd_result_under_async(task, jtask):
    """Round 1's deferred KD, dispatched: ``result()`` gives the same
    (student, losses) as the JAX runner's within 2e-4, and the resolve
    that follows installs that student."""
    kw = dict(RUN, K=4, R=2, overlap="async")
    jrunner = jax_make_runner("fedsdd", jtask, **kw)
    init = _init(jtask, jrunner, 4)
    jstate = jrunner.run_round(JaxFedState(round=0, global_models=[
        jax.tree.map(jnp.asarray, m) for m in init], ensemble=JaxTeacherBank(4, 2)))
    jrunner._executor().dispatch(jstate.pending_kd)
    jstudent, jlosses = jstate.pending_kd.result()

    runner = make_runner("fedsdd", task, device="cpu", **kw)
    state = runner.run_round(FedState(round=0, global_models=[_t(m) for m in init],
                                      ensemble=TeacherBank(4, 2)))
    pending = state.pending_kd          # async issues it at emit already
    assert pending.dispatched is not None
    student, losses = pending.result()
    _close(student, jstudent, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=TOL, atol=TOL)
    runner._executor().resolve_pending(state)
    assert state.pending_kd is None and state.global_models[0] is student
    with pytest.raises(RuntimeError, match="not dispatched"):
        PendingKD(round_idx=1, student={}, teachers=[], record={}).result()


def test_pending_kd_does_not_keep_its_pipeline(task, jtask):
    """A state's dispatched job holds its KD pipeline weakly: once the
    runner goes, the pipeline (its step programs, its graph pool) goes
    too, and ``result()`` raises naming it."""
    kw = dict(RUN, K=4, R=2, overlap="async")
    jrunner = jax_make_runner("fedsdd", jtask, **kw)
    init = _init(jtask, jrunner, 4)
    runner = make_runner("fedsdd", task, device="cpu", **kw)
    state = runner.run_round(FedState(round=0, global_models=[_t(m) for m in init],
                                      ensemble=TeacherBank(4, 2)))
    assert state.pending_kd.dispatched is not None
    pipe = weakref.ref(runner._kd_pipeline())
    del runner
    gc.collect()
    assert pipe() is None
    with pytest.raises(RuntimeError, match="pipeline is gone"):
        state.pending_kd.result()


def test_local_train_matches_reference(task, jtask):
    runner = make_runner("fedavg", task, device="cpu", **RUN)
    jrunner = jax_make_runner("fedavg", jtask, **RUN)
    (init,) = _init(jtask, jrunner, 1)
    jstate = jrunner.init_state()
    state = FedState(round=0, global_models=[_t(init)], ensemble=None)
    for cid in (0, 5):
        jp, jn = jrunner.local_train(jax.tree.map(jnp.asarray, init), cid, jstate,
                                     np.random.default_rng(cid))
        p, n = runner.local_train(_t(init), cid, state, np.random.default_rng(cid))
        assert n == jn
        _close(p, jp, rtol=TOL, atol=TOL)
