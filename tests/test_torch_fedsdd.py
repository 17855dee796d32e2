"""Port vs reference: the FedSDD runner on the sequential engine.

  (a) ``FedConfig.validate``: every preset validates; each ``ValueError``
      of the reference is raised by the port with the same message (a
      fault plan as the port's own ``FaultPlan``); ``client_sharding=
      "shard_map"``, the last option the port once refused, validates
      in both packages and no option raises ``NotImplementedError``; FedBE
      and secure aggregation validate and run a round (their parity is in
      ``test_torch_fedbe_secagg.py``); the robustness options validate and run a
      round (their parity is in ``test_torch_faults.py``,
      ``test_torch_robust_agg.py``, ``test_torch_trust.py`` and
      ``test_torch_client_store.py``).
  (b) ``TeacherBank``: member order (newest round first) and
      ``rounds_held`` for R ∈ {1, 2} over 3 pushes, exactly.
  (c) ``KDPipeline.distill`` / ``distill_all`` against the JAX pipeline on
      one student and teacher stack.
  (d) 2 rounds from the JAX init weights on the small CNN task:
      ``global_models`` and the KD losses against the JAX runner for
      ``fedsdd`` (K=4, R=2), ``fedsdd_basic_kd``, ``feddf``, ``fedavg``,
      ``fedprox`` and ``scaffold``.
  (e) models k>0 are identical with and without KD.

(c) and (d) at 2e-4, the reference's own cross-path tolerance
(``tests/test_kd_pipeline.py``); (b) and (e) exact.  JAX runs on the CPU
through its default jnp path, as ``tests/test_fedsdd.py`` does.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.faults import FaultPlan  # noqa: E402
from repro_torch.core import faults as port_faults  # noqa: E402
from repro.core.fedsdd import PRESETS as JAX_PRESETS  # noqa: E402
from repro.core.fedsdd import FedConfig as JaxFedConfig  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import classification_task as jax_classification_task  # noqa: E402
from repro.distill import KDPipeline as JaxKDPipeline  # noqa: E402
from repro.distill import TeacherBank as JaxTeacherBank  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.fedsdd import PRESETS, FedConfig, FedState, make_config, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.distill import KDPipeline, TeacherBank  # noqa: E402
from repro_torch.utils.pytree import tree_stack, tree_zeros_like  # noqa: E402

ATOL = RTOL = 2e-4
TASK = dict(model="cnn", num_clients=8, alpha=0.5, num_train=400, num_server=256, seed=0)


def small(**kw):
    base = dict(num_clients=8, participation=1.0, local_epochs=1,
                client_lr=0.05, server_lr=0.05, distill_steps=4,
                client_batch=32, rounds=2)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def tasks():
    return jax_classification_task(**TASK), classification_task(**TASK, device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, atol=ATOL, rtol=RTOL):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=atol, rtol=rtol),
                 interop.params_to_numpy(port), _np(ref))


# ------------------------------------------------------------------- (a)
def test_presets_all_validate():
    assert PRESETS.keys() == JAX_PRESETS.keys()
    for name in PRESETS:
        make_config(name).validate()


VALUE_ERRORS = [
    dict(K=0), dict(R=0), dict(distill_target="x"), dict(ensemble_source="x"),
    dict(local_algo="x"), dict(execution="x"), dict(client_sharding="x"),
    dict(kd_pipeline="x"), dict(kd_kernel="x"), dict(kd_head_fusion=True),
    dict(teacher_cache_dtype="x"), dict(teacher_cache_dtype="bfloat16"),
    dict(teacher_cache_dtype="bfloat16", kd_kernel="flash", kd_pipeline="legacy"),
    dict(overlap="x"), dict(teacher_dtype="x"), dict(overlap="async", kd_pipeline="legacy"),
    dict(ensemble_source="clients", secure_aggregation=True), dict(client_store="x"),
    dict(client_cache_buckets=0), dict(client_store_dir="spill"),
    dict(faults=FaultPlan(dropout=0.1), secure_aggregation=True),
    dict(faults=FaultPlan(dropout=2.0)), dict(aggregator="x"), dict(trim_frac=0.5),
    dict(clip_norm=0.0), dict(aggregator="median", secure_aggregation=True),
    dict(aggregator="median", faults=FaultPlan(zero_fill=True)),
    dict(teacher_trust=True, kd_pipeline="legacy"),
    dict(teacher_trust=True, distill_target="none"),
]


def _port_kw(kw):
    """The same options with the reference's fault plan as the port's."""
    out = dict(kw)
    if isinstance(out.get("faults"), FaultPlan):
        out["faults"] = port_faults.FaultPlan(**dataclasses.asdict(out["faults"]))
    return out


@pytest.mark.parametrize("kw", VALUE_ERRORS, ids=lambda kw: ",".join(kw))
def test_value_errors_match_reference(kw):
    with pytest.raises(ValueError) as want:
        JaxFedConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        FedConfig(**_port_kw(kw)).validate()
    assert str(got.value) == str(want.value)


UNPORTED = [
    pytest.param(dict(execution="vectorized", client_sharding="shard_map"), id="execution"),
    dict(client_sharding="shard_map"),
]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: ",".join(kw))
def test_unported_options_raise_not_implemented(kw):
    """Nothing is left unported: the options the port once refused with
    ``NotImplementedError`` validate as in the reference."""
    JaxFedConfig(**kw).validate()            # valid in the reference
    FedConfig(**kw).validate()
    assert not hasattr(FedConfig, "_unported")


ROBUSTNESS = [
    dict(client_store="spilling"),
    dict(faults=FaultPlan(seed=1, dropout=0.3, corrupt=0.2, attack="sign_flip", attack_rate=0.3)),
    dict(aggregator="median"), dict(clip_norm=1.0), dict(teacher_trust=True),
]


@pytest.mark.parametrize("kw", [dict(secure_aggregation=True), dict(ensemble_extra_sampled=3)],
                         ids=lambda kw: ",".join(kw))
def test_fedbe_and_secure_options_validate_and_run(tasks, kw):
    """FedBE's posterior samples and secure aggregation validate as in the
    reference and run a round (their draws are the port's own)."""
    _, task = tasks
    JaxFedConfig(**kw).validate()
    FedConfig(**kw).validate()
    source = "clients" if "ensemble_extra_sampled" in kw else "aggregated"
    st = make_runner("fedsdd", task, device="cpu",
                     **small(K=2, rounds=1, ensemble_source=source, **kw)).run()
    assert st.round == 1 and "kd_loss_first" in st.history[0]
    assert all(torch.isfinite(x).all() for m in st.global_models for x in m.values())


@pytest.mark.parametrize("kw", ROBUSTNESS, ids=lambda kw: ",".join(kw))
def test_robustness_options_validate_and_run(tasks, kw, tmp_path):
    """The options of the robustness slice validate as in the reference and
    run a round of fedsdd (the fault plan the port's own)."""
    _, task = tasks
    JaxFedConfig(**kw).validate()
    port_kw = _port_kw(kw)
    FedConfig(**port_kw).validate()
    if "client_store" in kw:
        port_kw["client_store_dir"] = str(tmp_path)
    st = make_runner("fedsdd", task, device="cpu", **small(K=2, rounds=1, **port_kw)).run()
    assert st.round == 1 and "kd_loss_last" in st.history[0]
    assert all(torch.isfinite(x).all() for m in st.global_models for x in m.values())
    if "faults" in kw:
        assert st.history[0]["survivors"] is not None
    if kw.get("teacher_trust"):
        assert len(st.history[0]["teacher_trust"]) == st.ensemble.num_members


@pytest.mark.parametrize("kw", [dict(overlap="async"), dict(overlap="fused"),
                                dict(kd_pipeline="legacy"),
                                dict(overlap="fused", execution="vectorized")],
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_overlap_and_legacy_options_validate(kw):
    """Overlapped rounds and the legacy KD oracle run in the port (their
    parity is in tests/test_torch_overlap.py and test_torch_distillation.py)."""
    JaxFedConfig(**kw).validate()
    FedConfig(**kw).validate()


@pytest.mark.parametrize("kw", [
    dict(kd_kernel="flash"), dict(kd_kernel="flash", kd_head_fusion=True),
    dict(kd_kernel="flash", teacher_cache_dtype="bfloat16"),
    dict(kd_kernel="flash", teacher_cache_dtype="float32", execution="vectorized")],
    ids=lambda kw: ",".join(kw))
def test_flash_kd_options_validate(kw):
    """Flash-KD, head fusion and the cache dtype run in the port (the LM
    parity is in tests/test_torch_fedsdd_lm.py)."""
    JaxFedConfig(**kw).validate()
    FedConfig(**kw).validate()


def test_fedbe_preset_runs(tasks):
    """The ``fedbe`` preset (FedDF + 10 posterior samples) runs a round."""
    _, task = tasks
    st = make_runner("fedbe", task, device="cpu", **small(rounds=1)).run()
    assert st.round == 1 and st.history[0]["kd_steps"] == 4


def test_teacher_bank_spill_dir_runs(tmp_path):
    """``TeacherBank(spill_dir=...)`` spills an evicted round through
    fedckpt (the layout is held against the reference in
    ``test_torch_trust.py``)."""
    bank = TeacherBank(2, 1, spill_dir=str(tmp_path))
    for t in (1, 2):
        bank.push(t, [{"w": torch.full((3,), float(t + k))} for k in range(2)])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["r00001_g0.npz", "r00001_g1.npz"]


def test_runner_refuses_a_task_on_another_device(tasks):
    _, task = tasks
    with pytest.raises(ValueError, match="same device"):
        make_runner("fedavg", task, device="meta")


# ------------------------------------------------------------------- (b)
@pytest.mark.parametrize("R", [1, 2])
def test_teacher_bank_matches_reference(R):
    rng = np.random.default_rng(R)
    bank, jbank = TeacherBank(2, R), JaxTeacherBank(2, R)
    for t in (1, 2, 3):
        models = [{"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
                   "b": {"v": rng.normal(0, 1, (4,)).astype(np.float32)}} for _ in range(2)]
        bank.push(t, [interop.params_from_numpy(m, device="cpu") for m in models])
        jbank.push(t, [jax.tree.map(jax.numpy.asarray, m) for m in models])
        assert bank.rounds_held() == jbank.rounds_held()
        assert bank.num_members == jbank.num_members
        assert bank.nbytes() == jbank.nbytes()
        _close(bank.members_stacked(), jbank.members_stacked(), atol=0, rtol=0)
        assert len(bank.members()) == len(jbank.members())
    assert bank.rounds_held() == list(range(4 - R, 4))


def test_teacher_bank_bf16_storage():
    bank = TeacherBank(1, 1, dtype="bfloat16")
    bank.push(1, [{"w": torch.full((4,), 1.0 + 2 ** -10)}])
    (m,) = bank.members()
    assert m["w"].dtype == torch.bfloat16 and float(m["w"][0]) == 1.0
    assert bank.nbytes() == 8


# ------------------------------------------------------------------- (c)
@pytest.mark.parametrize("multi", [False, True])
def test_kd_pipeline_matches_reference(tasks, multi):
    jtask, task = tasks
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    jmodels = [jtask.init_fn(k) for k in keys]
    models = [interop.params_from_numpy(_np(m), device="cpu") for m in jmodels]
    jstack = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jmodels[1:])
    kw = dict(steps=5, lr=0.05, temperature=4.0)
    jpipe = JaxKDPipeline(jtask.logits_fn, **kw)
    pipe = KDPipeline(task.logits_fn, **kw, device="cpu")
    probs = pipe.precompute_teacher_probs(models[1:], pipe.batches_for(task.server_batches))
    jprobs = jpipe.precompute_teacher_probs(jstack, jpipe.batches_for(jtask.server_batches))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6, rtol=0)
    if multi:
        students = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jmodels[:2])
        jout, jinfo = jpipe.distill_all(students, jstack, jtask.server_batches)
        out, info = pipe.distill_all(tree_stack(models[:2]), models[1:],
                                     task.server_batches)
    else:
        jout, jinfo = jpipe.distill(jmodels[0], jstack, jtask.server_batches)
        out, info = pipe.distill(models[0], models[1:], task.server_batches)
    _close(out, jout)
    for k in ("kd_loss_first", "kd_loss_last"):
        np.testing.assert_allclose(info[k], jinfo[k], rtol=RTOL, atol=ATOL)
    assert info["kd_steps"] == jinfo["kd_steps"] == 5


# ------------------------------------------------------------------- (d)
RUNS = {
    "fedsdd": dict(K=4, R=2),
    "fedsdd_basic_kd": dict(K=4, R=2),
    "feddf": dict(),
    "fedavg": dict(),
    "fedprox": dict(fedprox_mu=0.01),
    "scaffold": dict(),
}


@pytest.mark.parametrize("preset", list(RUNS))
def test_two_rounds_match_jax_runner(tasks, preset):
    jtask, task = tasks
    kw = small(**RUNS[preset])
    jrunner = jax_make_runner(preset, jtask, **kw)
    jstate = jrunner.run(rounds=2)
    key = jax.random.PRNGKey(jrunner.cfg.seed)
    init = [interop.params_from_numpy(_np(jtask.init_fn(k)), device="cpu")
            for k in jax.random.split(key, jrunner.cfg.K)]
    runner = make_runner(preset, task, device="cpu", **kw)
    state = FedState(round=0, global_models=init,
                     ensemble=TeacherBank(runner.cfg.K, runner.cfg.R))
    if runner.cfg.local_algo == "scaffold":
        state.scaffold_c_global = tree_zeros_like(init[0])
    state = runner.run(2, state=state)
    assert state.round == jstate.round == 2
    assert len(state.global_models) == len(jstate.global_models)
    for m, jm in zip(state.global_models, jstate.global_models):
        _close(m, jm)
    assert state.ensemble.num_members == jstate.ensemble.num_members
    assert state.ensemble.rounds_held() == jstate.ensemble.rounds_held()
    for rec, jrec in zip(state.history, jstate.history):
        assert rec["round"] == jrec["round"] and rec["active"] == jrec["active"]
        assert ("kd_loss_first" in rec) == ("kd_loss_first" in jrec)
        for k in ("kd_loss_first", "kd_loss_last"):
            if k in jrec:
                np.testing.assert_allclose(rec[k], jrec[k], rtol=RTOL, atol=ATOL)
        assert abs(rec["acc_main"] - jrec["acc_main"]) <= 0.01


# ------------------------------------------------------------------- (e)
def test_distillation_updates_only_main_model(tasks):
    """The diversity mechanism (§3.1.2): models k>0 equal a run without KD
    bit for bit; the main model moves."""
    _, task = tasks
    st_kd = make_runner("fedsdd", task, device="cpu", K=3, **small(distill_steps=3)).run(1)
    st_no = make_runner("fed_ensemble", task, device="cpu", K=3, **small(distill_steps=3)).run(1)
    for k in (1, 2):
        for a, b in zip(interop.params_to_numpy(st_kd.global_models[k]).values(),
                        interop.params_to_numpy(st_no.global_models[k]).values()):
            np.testing.assert_array_equal(a, b)
    diffs = [float((a - b).abs().max()) for a, b in
             zip(st_kd.global_models[0].values(), st_no.global_models[0].values())]
    assert max(diffs) > 0
    assert "kd_loss_first" in st_kd.history[0] and "kd_loss_first" not in st_no.history[0]
