"""Port vs reference: the vectorized client engine (the port's spec is
``tests/test_engine_parity.py``).

  (a) Round plan: for the same groups and numpy rng, ``build_round_entries``
      and ``plans_from_entries`` give the JAX engine's ``cids``, ``order``,
      ``sizes``, ``indices``, ``step_mask`` and bucket data exactly, for a
      single bucket, several buckets and ``pad_to`` hints.
  (b) Runner parity: ``execution="vectorized"`` after 2 rounds from the JAX
      init weights, against the JAX runner's ``execution="vectorized"`` and
      against the port's own sequential runner, for ``fedavg``, ``fedprox``,
      ``scaffold``, ``fedsdd`` (K=4, R=2) and ``feddf`` on the 8-client CNN
      task (uniform groups; Eq. 2 through the kernel route's reshape and
      one tree call a round with the route forced on, the wrapper running
      its plain version on the CPU), ``fedsdd`` K=2 on 7 clients (ragged groups, the segment
      reduction), partial participation in one bucket, and a tiny shard
      (several buckets).  SCAFFOLD's per-client controls are compared too.
      Tolerance 2e-4, the port's runner-parity tolerance
      (``tests/test_torch_fedsdd.py``).
  (c) The engine's vmapped gradient on a depth-8 ResNet-20 with 2 stacked
      clients against ``jax.vmap(jax.grad)`` of the reference at 1e-4.  The
      batches hold no ReLU input within 1e-6 of zero (checked in the
      test): an input within f32 noise of the kink can land on the other
      side under a reordered sum and move the gradients upstream of it.
      With ``default_rng(5)`` one input is 2.2e-8 and the gradients differ
      by 3.6e-4; batches 0-4, 6 and 7 agree within 4.8e-7 (ROADMAP §C).
  (d) ``FedConfig(execution="vectorized")`` validates, with
      ``client_sharding="shard_map"`` too (the engine then splits its
      client axis over the client mesh, ``tests/test_torch_shard_map.py``);
      a ``"scan"`` step mode,
      given or through ``REPRO_ENGINE_STEP_MODE``, builds and resolves to
      scan (its parity is ``tests/test_torch_step_mode.py``'s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.resnet_cifar import get_resnet_config as jax_get_resnet_config  # noqa: E402
from repro.core import engine as jax_eng  # noqa: E402
from repro.core.client_store import InMemoryStore as JaxStore  # noqa: E402
from repro.core.fedsdd import make_config as jax_make_config  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.grouping import assign_groups as jax_assign_groups  # noqa: E402
from repro.core.grouping import sample_clients as jax_sample_clients  # noqa: E402
from repro.core.tasks import classification_task as jax_classification_task  # noqa: E402
from repro.models import resnet as jax_resnet  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.resnet_cifar import get_resnet_config  # noqa: E402
from repro_torch.core import aggregation, engine  # noqa: E402
from repro_torch.core.client_store import InMemoryStore  # noqa: E402
from repro_torch.core.fedsdd import FedConfig, FedState, make_config, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.kernels.weight_avg import ops as wops  # noqa: E402
from repro_torch.launch.mesh import make_client_mesh  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_zeros_like  # noqa: E402

ATOL = RTOL = 2e-4
UNIFORM = dict(model="cnn", num_clients=8, alpha=0.5, num_train=400, num_server=256, seed=0)
RAGGED = dict(model="cnn", num_clients=7, alpha=0.5, num_train=400, num_server=256, seed=0)
ONE_BUCKET = dict(model="cnn", num_clients=10, alpha=0.5, num_train=500, num_server=256, seed=5)
TINY_SHARD = dict(model="cnn", num_clients=6, alpha=0.1, num_train=120, num_server=256, seed=3)


def small(**kw):
    base = dict(participation=1.0, local_epochs=1, client_lr=0.05, server_lr=0.05,
                distill_steps=3, client_batch=32, rounds=2)
    base.update(kw)
    return base


_TASKS: dict = {}


def tasks(spec: dict):
    """(JAX task, port task) built once per spec."""
    key = tuple(sorted(spec.items()))
    if key not in _TASKS:
        _TASKS[key] = (jax_classification_task(**spec),
                       classification_task(**spec, device="cpu"))
    return _TASKS[key]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, atol=ATOL, rtol=RTOL):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=atol, rtol=rtol),
                 interop.params_to_numpy(port), _np(ref))


# ------------------------------------------------------------------- (a)
def _round(spec, cfg_kw, seed):
    """The same sampled groups and the rng state after grouping, twice."""
    cfg = make_config("fedsdd", num_clients=spec["num_clients"], **cfg_kw)
    rngs = [np.random.default_rng(seed) for _ in range(2)]
    groups = []
    for rng in rngs:
        active = jax_sample_clients(cfg.num_clients, cfg.participation, rng)
        groups.append(jax_assign_groups(active, cfg.K, rng))
    return cfg, groups, rngs


PLAN_CASES = {
    "one bucket": (ONE_BUCKET, dict(K=2, participation=0.5, client_batch=32), None),
    "several buckets": (TINY_SHARD, dict(K=2, local_epochs=2, client_batch=32), None),
    "pad_to": (TINY_SHARD, dict(K=2, client_batch=32), "grow"),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_round_plan_matches_reference(case):
    spec, cfg_kw, pad = PLAN_CASES[case]
    jtask, task = tasks(spec)
    cfg, (groups, jgroups), (rng, jrng) = _round(spec, cfg_kw, seed=3)
    jcfg = jax_make_config("fedsdd", num_clients=spec["num_clients"], **cfg_kw)
    store, jstore = InMemoryStore(task), JaxStore(jtask)
    entries = engine.build_round_entries(task, cfg, groups, rng, store)
    jentries = jax_eng.build_round_entries(jtask, jcfg, jgroups, jrng, jstore)
    assert rng.bit_generator.state == jrng.bit_generator.state
    assert [(e.pos, e.cid, e.group, e.n, e.bs) for e in entries] == \
        [(e.pos, e.cid, e.group, e.n, e.bs) for e in jentries]
    hints = engine.entry_pad_hints(entries)
    assert hints == jax_eng.entry_pad_hints(jentries)
    if pad == "grow":
        hints = {bs: (s + 3, n + 5) for bs, (s, n) in hints.items()}
    plans = engine.plans_from_entries(task, entries, store, pad_to=hints if pad else None)
    jplans = jax_eng.plans_from_entries(jtask, jentries, jstore, pad_to=hints if pad else None)
    assert len(plans) == len(jplans)
    if case == "several buckets":
        assert len(plans) > 1
    if case == "one bucket":
        assert len(plans) == 1 and len(plans[0].cids) < spec["num_clients"]
    for p, jp in zip(plans, jplans):
        for field in ("cids", "group_of", "sizes", "order"):
            np.testing.assert_array_equal(getattr(p, field), getattr(jp, field))
        assert p.batch_size == jp.batch_size
        np.testing.assert_array_equal(p.indices.numpy(), np.asarray(jp.indices))
        np.testing.assert_array_equal(p.step_mask.numpy(), np.asarray(jp.step_mask))
        np.testing.assert_array_equal(p.num_steps, np.asarray(jp.step_mask).sum(1))
        for k in ("x", "y"):
            np.testing.assert_array_equal(p.data[k].numpy(), np.asarray(jp.data[k]))


def test_build_round_plan_draws_in_sequential_order():
    """Planning a round consumes the rng exactly as the sequential loop's
    per-client, per-epoch permutations do."""
    _, task = tasks(TINY_SHARD)
    cfg, (groups, _), (rng, rng_seq) = _round(TINY_SHARD, dict(K=2, local_epochs=2), seed=1)
    rplan = engine.build_round_plan(task, cfg, groups, rng)
    for g in groups:
        for cid in g:
            for _ in range(cfg.local_epochs):
                rng_seq.permutation(len(task.client_data[int(cid)][0]))
    assert rng.bit_generator.state == rng_seq.bit_generator.state
    assert rplan.num_clients == sum(len(g) for g in groups)
    assert sorted(c for p in rplan.plans for c in p.cids) == sorted(int(c) for g in groups
                                                                   for c in g)


def test_store_caches_rows_and_buckets_within_capacity():
    _, task = tasks(TINY_SHARD)
    store = InMemoryStore(task, capacity=3)
    with store.sampled_view([0, 1]):
        b = store.get_bucket([0, 1], 40)
        assert store.get_bucket([0, 1], 40) is b          # a hit, no rebuild
        store.get_data(2, 40)
        store.get_data(3, 40)
        assert ("bucket", (0, 1), 40) in store._data     # pinned rows stay
    assert len(store._data) <= 3
    n0 = store.num_examples(0)
    assert b["x"].shape[:2] == (2, 40) and not b["x"][0, n0:].any()


# ------------------------------------------------------------------- (b)
def _port_state(jrunner, task, runner):
    key = jax.random.PRNGKey(jrunner.cfg.seed)
    init = [interop.params_from_numpy(_np(jrunner.task.init_fn(k)), device="cpu")
            for k in jax.random.split(key, jrunner.cfg.K)]
    state = FedState(round=0, global_models=init,
                     ensemble=TeacherBank(runner.cfg.K, runner.cfg.R))
    if runner.cfg.local_algo == "scaffold":
        state.scaffold_c_global = tree_zeros_like(init[0])
    return state


RUNS = {
    "fedavg": (UNIFORM, "fedavg", dict()),
    "fedprox": (UNIFORM, "fedprox", dict(fedprox_mu=0.01)),
    "scaffold": (UNIFORM, "scaffold", dict()),
    "fedsdd": (UNIFORM, "fedsdd", dict(K=4, R=2)),
    "feddf": (UNIFORM, "feddf", dict()),
    "fedsdd ragged": (RAGGED, "fedsdd", dict(K=2, R=2)),
    "partial participation": (ONE_BUCKET, "fedsdd", dict(K=2, participation=0.5,
                                                          distill_steps=2)),
    "tiny shard": (TINY_SHARD, "fedsdd", dict(K=2, local_epochs=2)),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_vectorized_matches_jax_runner_and_sequential(name, monkeypatch):
    spec, preset, kw = RUNS[name]
    jtask, task = tasks(spec)
    kw = small(num_clients=spec["num_clients"], **kw)
    jrunner = jax_make_runner(preset, jtask, execution="vectorized", **kw)
    jstate = jrunner.run(rounds=2)
    kernel_calls = []
    if spec is UNIFORM:
        monkeypatch.setattr(aggregation, "_kernel_route", lambda stacked: True)
        real = wops.group_weighted_average_pytree
        monkeypatch.setattr(wops, "group_weighted_average_pytree",
                            lambda t, w: kernel_calls.append(len(tree_leaves(t))) or real(t, w))
    states = {}
    for execution in ("vectorized", "sequential"):
        runner = make_runner(preset, task, device="cpu", execution=execution, **kw)
        states[execution] = runner.run(2, state=_port_state(jrunner, task, runner))
    vec, seq = states["vectorized"], states["sequential"]
    if spec is UNIFORM:             # one launch for the 4 CNN leaves, a round
        assert kernel_calls == [4, 4]
    assert vec.round == jstate.round == 2
    for m, jm, sm in zip(vec.global_models, jstate.global_models, seq.global_models):
        _close(m, jm)
        _close(m, interop.params_to_numpy(sm))
    assert vec.ensemble.rounds_held() == jstate.ensemble.rounds_held()
    for rec, jrec in zip(vec.history, jstate.history):
        assert rec["active"] == jrec["active"]
        for k in ("kd_loss_first", "kd_loss_last"):
            if k in jrec:
                np.testing.assert_allclose(rec[k], jrec[k], rtol=RTOL, atol=ATOL)
    if preset == "scaffold":
        for cid in range(spec["num_clients"]):
            _close(vec.store.get_control(cid), jstate.store.get_control(cid))
            _close(vec.store.get_control(cid),
                   interop.params_to_numpy(seq.store.get_control(cid)))


# ------------------------------------------------------------------- (c)
MIN_RELU_MARGIN = 1e-6     # ten times the f32 noise of an O(1) pre-activation


def test_vmapped_grad_matches_jax_vmap_grad(monkeypatch):
    jcfg = jax_get_resnet_config("resnet20").reduced()
    cfg = get_resnet_config("resnet20").reduced()
    jparams = [jax_resnet.init_resnet(k, jcfg) for k in jax.random.split(jax.random.PRNGKey(4), 2)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jparams)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (2, 4)).astype(np.int32)

    # every ReLU input of both clients' forward stays clear of the kink
    relu, margins = torch.nn.functional.relu, []
    monkeypatch.setattr(torch.nn.functional, "relu",
                        lambda t: margins.append(float(t.abs().min())) or relu(t))
    for c in range(2):
        resnet.resnet_logits(interop.params_from_numpy(_np(jparams[c]), device="cpu"),
                             torch.from_numpy(x[c]), cfg)
    monkeypatch.setattr(torch.nn.functional, "relu", relu)
    assert min(margins) > MIN_RELU_MARGIN, min(margins)

    jgrads = jax.vmap(jax.grad(lambda p, b: jax_resnet.resnet_loss(p, b, jcfg)[0]))(
        jstack, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    eng = engine.VectorizedClientEngine(lambda p, b: resnet.resnet_loss(p, b, cfg), sgd(0.1))
    stack = interop.params_from_numpy(_np(jstack), device="cpu")
    grads, (loss, _) = eng.vmapped_grad()(stack, {"x": torch.from_numpy(x),
                                                  "y": torch.from_numpy(y)})
    assert tuple(loss.shape) == (2,)
    _close(grads, jgrads, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------- (d)
def test_vectorized_validates_and_unported_modes_raise(monkeypatch):
    FedConfig(execution="vectorized").validate()
    FedConfig(execution="vectorized", client_sharding="vmap").validate()
    FedConfig(execution="vectorized", client_sharding="shard_map").validate()
    sharded = engine.VectorizedClientEngine(lambda p, b: 0, sgd(0.1), mesh=make_client_mesh(),
                                            client_sharding="shard_map")
    assert sharded._use_shard_map() and not engine.VectorizedClientEngine(
        lambda p, b: 0, sgd(0.1), mesh=make_client_mesh())._use_shard_map()
    with pytest.raises(ValueError, match="client_sharding"):
        engine.VectorizedClientEngine(lambda p, b: 0, sgd(0.1), client_sharding="x")
    eng = engine.VectorizedClientEngine(lambda p, b: 0, sgd(0.1), step_mode="scan")
    assert eng.graphs.scan("cpu")
    with pytest.raises(ValueError, match="step_mode"):
        engine.VectorizedClientEngine(lambda p, b: 0, sgd(0.1), step_mode="x")
    _, task = tasks(TINY_SHARD)
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    runner = make_runner("fedavg", task, device="cpu", execution="vectorized", num_clients=6)
    assert runner._make_engine().graphs.scan("cpu")
    make_runner("fedavg", task, device="cpu", num_clients=6)   # sequential: no engine
    assert dataclasses.replace(FedConfig(), execution="vectorized").execution == "vectorized"
