"""Port vs reference: the step modes, the reference's ``step_mode="scan"``.

With ``REPRO_ENGINE_STEP_MODE=scan`` on both sides (the reference's bucket
scan and KD scan; the port's step programs, which on the CPU run their
static-buffer bodies eagerly, ``core/step_graph.py``), from the JAX
runner's init weights:

  (a) the vectorized engine for ``fedavg`` over a round of uniform groups
      (8 clients, K=1), ``fedprox`` over a round of ragged groups (7
      clients, K=2) and ``scaffold`` over two rounds of several buckets (a
      tiny shard, K=2, 2 epochs),
      against the JAX vectorized runner, SCAFFOLD's controls too; the
      port's sequential runner under scan against the same reference;
  (b) KD on the LM task for the dense cache and Flash-KD with a bf16 cache
      with ``distill_target`` main (``fedsdd``), Flash-KD with an f32 cache
      and head-fused Flash-KD with all (``fedsdd_basic_kd``), on the
      sequential engine (its client step under scan too), two rounds
      against the JAX runner.

Each preset meets one kind of round and each KD path one target: the
reference's scan programs take 2.5-10 s each to compile on the CPU, so the
full products run against the port's stepped mode bit for bit instead
(``tests/test_torch_step_graph.py``).  Tolerances are those of
``tests/test_torch_engine.py`` and ``tests/test_torch_fedsdd_lm.py``:
every global model and the KD losses within 2e-4.  Each port run under
scan is also held against the port under ``REPRO_ENGINE_STEP_MODE=stepped``
bit for bit.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import classification_task as jax_classification_task  # noqa: E402
from repro.core.tasks import lm_task as jax_lm_task  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task, lm_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_zeros_like  # noqa: E402

ATOL = RTOL = 2e-4
UNIFORM = dict(model="cnn", num_clients=8, alpha=0.5, num_train=400, num_server=256, seed=0)
RAGGED = dict(model="cnn", num_clients=7, alpha=0.5, num_train=400, num_server=256, seed=0)
TINY_SHARD = dict(model="cnn", num_clients=6, alpha=0.1, num_train=120, num_server=256, seed=3)
ROUNDS = {"uniform": (UNIFORM, dict()), "ragged": (RAGGED, dict(K=2)),
          "buckets": (TINY_SHARD, dict(K=2, local_epochs=2))}
LM_TASK = dict(num_clients=4, docs_per_client=2, seq=8, server_batches_n=2, server_batch=2)
KD_OPTIONS = {
    "dense": dict(kd_kernel="dense"),
    "flash_f32": dict(kd_kernel="flash", teacher_cache_dtype="float32"),
    "flash_bf16": dict(kd_kernel="flash"),
    "head_fused": dict(kd_kernel="flash", kd_head_fusion=True),
}
_TASKS: dict = {}


def _task_pair(kind, spec):
    key = (kind, tuple(sorted(spec.items())) if isinstance(spec, dict) else spec)
    if key not in _TASKS:
        if kind == "cnn":
            _TASKS[key] = (jax_classification_task(**spec),
                           classification_task(**spec, device="cpu"))
        else:
            _TASKS[key] = (jax_lm_task(jax_get_config(spec).reduced(), **LM_TASK),
                           lm_task(get_config(spec).reduced(), **LM_TASK, device="cpu"))
    return _TASKS[key]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side of these tiny CPU models runs faster on one thread,
    and much faster where several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL),
                 interop.params_to_numpy(port), _np(ref))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _port_runs(jrunner, task, preset, kw, monkeypatch, rounds=2):
    """The port's rounds from the JAX init weights under scan and under
    stepped: {mode: state}."""
    keys = jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), jrunner.cfg.K)
    out = {}
    for mode in ("scan", "stepped"):
        monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", mode)
        runner = make_runner(preset, task, device="cpu", **kw)
        init = [interop.params_from_numpy(_np(jrunner.task.init_fn(k)), device="cpu")
                for k in keys]
        state = FedState(round=0, global_models=init,
                         ensemble=TeacherBank(runner.cfg.K, runner.cfg.R))
        if runner.cfg.local_algo == "scaffold":
            state.scaffold_c_global = tree_zeros_like(init[0])
        out[mode] = runner.run(rounds, state=state)
    return out


def _check(jstate, runs, rounds=2, num_clients=None):
    scan, stepped = runs["scan"], runs["stepped"]
    assert scan.round == jstate.round == rounds
    for m, jm, sm in zip(scan.global_models, jstate.global_models, stepped.global_models):
        _close(m, jm)
        assert _equal(m, sm)
    for rec, jrec, srec in zip(scan.history, jstate.history, stepped.history):
        for k in ("kd_loss_first", "kd_loss_last"):
            if k in jrec:
                np.testing.assert_allclose(rec[k], jrec[k], rtol=RTOL, atol=ATOL)
                assert rec[k] == srec[k]
    if num_clients:
        for cid in range(num_clients):
            _close(scan.store.get_control(cid), jstate.store.get_control(cid))
            assert _equal(scan.store.get_control(cid), stepped.store.get_control(cid))


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("preset,rounds,n", [("fedavg", "uniform", 1), ("fedprox", "ragged", 1),
                                             ("scaffold", "buckets", 2)])
def test_engines_under_scan_match_jax_scan(preset, rounds, n, monkeypatch):
    """``n`` rounds: each round's new shapes are a new compile of the
    reference's bucket scan; SCAFFOLD's controls carry into a second."""
    spec, extra = ROUNDS[rounds]
    jtask, task = _task_pair("cnn", spec)
    kw = {**dict(num_clients=spec["num_clients"], participation=1.0, local_epochs=1,
                 client_lr=0.05, server_lr=0.05, client_batch=32, fedprox_mu=0.01), **extra}
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    jstate = jax_make_runner(preset, jtask, execution="vectorized", **kw).run(rounds=n)
    jrunner = jax_make_runner(preset, jtask, **kw)
    scaffold = spec["num_clients"] if preset == "scaffold" else None
    for execution in ("vectorized", "sequential"):
        runs = _port_runs(jrunner, task, preset, dict(kw, execution=execution), monkeypatch, n)
        _check(jstate, runs, n, scaffold)


# ------------------------------------------------------------------- (b)
@pytest.mark.parametrize("option,preset", [
    ("dense", "fedsdd"), ("flash_bf16", "fedsdd"), ("flash_f32", "fedsdd_basic_kd"),
    ("head_fused", "fedsdd_basic_kd")])
def test_kd_under_scan_matches_jax_scan(option, preset, monkeypatch):
    jtask, task = _task_pair("lm", "stablelm-3b")
    kw = dict(num_clients=4, participation=1.0, local_epochs=1, client_lr=0.02,
              client_batch=2, distill_steps=3, server_lr=0.02, K=2, R=1,
              **KD_OPTIONS[option])
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    jrunner = jax_make_runner(preset, jtask, **kw)
    jstate = jrunner.run(rounds=2)
    _check(jstate, _port_runs(jrunner, task, preset, kw, monkeypatch))
