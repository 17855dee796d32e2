"""The port's fault injection, robust rounds and crash-safe resume against
the reference, the spec of ``tests/test_faults.py``.

  (a) the plan: ``client_faults``, ``io_injector``, ``apply_round_faults``
      and every ``validate`` message are the reference's exactly;
      ``poison_rows`` / ``finite_rows``; sign_flip and scale attacks equal
      the reference's arithmetic; gauss attacks are deterministic per
      (seed, round, cid) and held against ``jax.random``'s by distribution
      (their values differ by design: a CPU ``torch.Generator``);
  (b) 3 rounds from the JAX init weights on the small CNN task, each engine
      against the JAX sequential runner (module-scoped): the six fault
      fields of the history identical, the models (and SCAFFOLD's server
      control) within the port's runner-parity tolerance 2e-4, for
      dropout + stragglers + corruption under SCAFFOLD, sign_flip under the
      trimmed mean, and scale under the median with clipping;
  (c) within the port: a zero-rate plan is bit-identical to no plan; a
      faulted round builds no new step program (under ``"scan"``); an
      all-corrupt or all-dropped round carries the model forward (SCAFFOLD
      controls never committed); zero_fill shrinks the aggregate; robust
      statistics compose with the carry-forward; spill-fail chaos equals
      a clean run bit for bit (the I/O hook cleared in ``finally``);
      faulted, robust, trust-weighted rounds under ``async`` and ``fused``
      drain to ``off``'s models within 2e-4;
  (d) kill after round 2 with a KD job in flight (``overlap="async"``,
      SCAFFOLD, the spilling store), restart a fresh runner from
      ``save_state``: the finished run equals the uninterrupted one bit for
      bit on both engines with the ring in f32 and in bf16; a corrupt
      newest checkpoint falls back to the one before; an empty directory
      restores nothing;
  (e) across packages: the JAX runner's checkpoint after round 2, restored
      by the port and finished, lands within 2e-4 of the JAX uninterrupted
      run, and the port's checkpoint restored by the JAX runner too.
"""
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jfaults  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import classification_task as jax_classification_task  # noqa: E402
from repro.fedckpt.checkpointer import Checkpointer as JaxCheckpointer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import faults, step_graph  # noqa: E402
from repro_torch.core.engine import ClientEntry  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.fedckpt import checkpointer as fedckpt  # noqa: E402
from repro_torch.fedckpt.checkpointer import Checkpointer  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_zeros_like  # noqa: E402

ATOL = RTOL = 2e-4
FAULT_KEYS = ("survivors", "dropped", "stragglers", "rejected", "attacked", "degraded_groups")
TASK = dict(model="cnn", num_clients=6, alpha=0.5, num_train=384, num_server=256, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(**kw):
    base = dict(num_clients=6, participation=1.0, local_epochs=2, client_lr=0.05,
                server_lr=0.05, distill_steps=2, client_batch=16, rounds=3)
    base.update(kw)
    return base


def _trace(state):
    return [{k: r.get(k) for k in FAULT_KEYS} for r in state.history]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _close_to_jax(port, ref):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL),
                 interop.params_to_numpy(port), _np(ref))


# ------------------------------------------------------------------- (a)
PLANS = [dict(seed=11, dropout=0.3, straggler=0.4, corrupt=0.2),
         dict(seed=6, dropout=0.3, straggler=0.4, corrupt=0.2, attack="sign_flip",
              attack_rate=0.3),
         dict(seed=3, straggler=1.0, straggler_frac=0.2, attack="gauss", attack_rate=1.0,
              spill_fail=0.5)]


@pytest.mark.parametrize("kw", PLANS, ids=["pr8", "attack", "gauss"])
def test_plan_draws_match_reference(kw):
    plan, jplan = FaultPlan(**kw), jfaults.FaultPlan(**kw)
    assert plan.active == jplan.active
    for t in range(1, 5):
        for c in range(16):
            assert plan.client_faults(t, c) == jplan.client_faults(t, c)
    inj, jinj = plan.io_injector(), jplan.io_injector()
    for i in range(40):
        path = f"/d/ctrl_c{i:08d}.npz"
        for attempt in (0, 1):
            outcome = []
            for fn in (inj, jinj):
                try:
                    fn(path, attempt)
                    outcome.append(None)
                except OSError as e:
                    outcome.append(str(e))
            assert outcome[0] == outcome[1]


@pytest.mark.parametrize("kw", [dict(dropout=1.5), dict(attack="evil", attack_rate=0.1),
                                dict(attack="none", attack_rate=0.1),
                                dict(attack="sign_flip", attack_rate=1.5),
                                dict(attack="sign_flip", attack_rate=0.1, attack_scale=0.0)],
                         ids=lambda kw: ",".join(kw))
def test_plan_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan(**kw).validate()
    with pytest.raises(ValueError) as got:
        FaultPlan(**kw).validate()
    assert str(got.value) == str(want.value)
    FaultPlan(attack="sign_flip", attack_rate=0.0).validate()      # inert, not invalid
    assert faults.apply_round_faults(FaultPlan(), 1, []) is None
    assert faults.apply_round_faults(None, 1, []) is None


def test_apply_round_faults_matches_reference():
    from repro.core.engine import ClientEntry as JaxEntry
    plan_kw = dict(seed=4, dropout=0.3, straggler=0.6, straggler_frac=0.2, corrupt=0.2,
                   attack="scale", attack_rate=0.3)
    rng = np.random.default_rng(0)
    idx = [rng.integers(0, 50, (int(rng.integers(1, 12)), 4)).astype(np.int32)
           for _ in range(16)]
    ents = [ClientEntry(pos=i, cid=i, group=i % 3, n=50, bs=4, idx=idx[i]) for i in range(16)]
    jents = [JaxEntry(pos=i, cid=i, group=i % 3, n=50, bs=4, idx=idx[i]) for i in range(16)]
    rf = faults.apply_round_faults(FaultPlan(**plan_kw), 3, ents)
    jrf = jfaults.apply_round_faults(jfaults.FaultPlan(**plan_kw), 3, jents)
    for f in ("dropped", "stragglers", "corrupt", "attacked"):
        assert getattr(rf, f) == getattr(jrf, f)
    assert rf.dropped and rf.stragglers and rf.attacked
    for e, je in zip(ents, jents):
        assert e.dropped == je.dropped and np.array_equal(e.idx, je.idx)
    assert faults.fault_record(rf, [1, 2], [5], [0]) == jfaults.fault_record(jrf, [1, 2], [5], [0])


def test_poison_rows_and_finite_guard():
    stacked = {"w": torch.ones((4, 3, 2)), "step": torch.zeros((4,), dtype=torch.int32)}
    bad = faults.poison_rows(stacked, [1, 3])
    np.testing.assert_array_equal(faults.finite_rows(bad), [True, False, True, False])
    np.testing.assert_array_equal(faults.finite_rows(stacked), np.ones(4, bool))
    assert torch.equal(stacked["w"], torch.ones((4, 3, 2)))       # out of place
    assert not faults.all_finite(faults.poison_model({"w": torch.ones(2)}))


@pytest.mark.parametrize("mode", ["sign_flip", "scale"])
def test_attack_arithmetic_matches_reference(mode):
    rng = np.random.default_rng(1)
    ref = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32), "b": np.zeros(3, np.float32)}
    model = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32), "b": np.ones(3, np.float32)}
    kw = dict(seed=0, attack=mode, attack_rate=1.0, attack_scale=7.0)
    got = faults.attack_model(FaultPlan(**kw), 3, 7, interop.params_from_numpy(model, "cpu"),
                              interop.params_from_numpy(ref, "cpu"))
    want = jfaults.attack_model(jfaults.FaultPlan(**kw), 3, 7,
                                jax.tree.map(jax.numpy.asarray, model),
                                jax.tree.map(jax.numpy.asarray, ref))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6),
                 interop.params_to_numpy(got), _np(want))
    stacked = {k: torch.stack([torch.from_numpy(model[k])] * 3) for k in model}
    rows = faults.attack_rows(FaultPlan(**kw), 3, stacked, [(1, 7, 0)],
                              [interop.params_from_numpy(ref, "cpu")])
    for k in model:
        assert torch.equal(rows[k][1], got[k]) and torch.equal(rows[k][0], stacked[k][0])


def test_gauss_attack_held_by_distribution():
    """Deterministic per (seed, round, cid) in the port, and the same
    distribution as the reference's ``jax.random`` draws: mean, standard
    deviation and a two-sample Kolmogorov-Smirnov test over 2 x 30,000
    values."""
    from scipy.stats import ks_2samp
    kw = dict(seed=0, attack="gauss", attack_rate=1.0, attack_scale=2.0)
    model = {"w": np.zeros((100, 300), np.float32), "b": np.zeros((3,), np.float32)}
    pm = interop.params_from_numpy(model, "cpu")
    a = faults.attack_model(FaultPlan(**kw), 3, 7, pm, pm)
    b = faults.attack_model(FaultPlan(**kw), 3, 7, pm, pm)
    c = faults.attack_model(FaultPlan(**kw), 3, 8, pm, pm)
    _equal(a, b)
    assert not torch.equal(a["w"], c["w"])
    jm = jax.tree.map(jax.numpy.asarray, model)
    j = jfaults.attack_model(jfaults.FaultPlan(**kw), 3, 7, jm, jm)
    x, y = a["w"].numpy().ravel() / 2.0, np.asarray(j["w"]).ravel() / 2.0
    for v in (x, y):
        assert abs(v.mean()) < 0.03 and abs(v.std() - 1.0) < 0.03
    assert ks_2samp(x, y).pvalue > 1e-3
    assert not np.allclose(x, y)          # another generator: other values


# ------------------------------------------------------------------- (b)
SCENARIOS = {
    "dropout_straggler_corrupt": ("scaffold", dict(seed=7, dropout=0.3, straggler=0.5,
                                                   straggler_frac=0.2, corrupt=0.2), {}),
    "sign_flip_trimmed_mean": ("fedavg", dict(seed=1, attack="sign_flip", attack_rate=0.4,
                                              attack_scale=5.0),
                               dict(aggregator="trimmed_mean", trim_frac=0.34)),
    "scale_median_clip": ("fedavg", dict(seed=2, dropout=0.2, attack="scale", attack_rate=0.4,
                                         attack_scale=3.0),
                          dict(aggregator="median", clip_norm=2.0)),
}


@pytest.fixture(scope="module")
def tasks():
    return jax_classification_task(**TASK), classification_task(**TASK, device="cpu")


@pytest.fixture(scope="module")
def jax_runs(tasks):
    """The JAX sequential runner's 3 rounds a scenario, run once each."""
    jtask, _ = tasks
    cache = {}

    def get(name):
        if name not in cache:
            preset, plan, extra = SCENARIOS[name]
            cache[name] = jax_make_runner(preset, jtask, faults=jfaults.FaultPlan(**plan),
                                          **small(**extra)).run()
        return cache[name]
    return get


def _port_from_jax_init(task, jtask, preset, kw, rounds):
    runner = make_runner(preset, task, device="cpu", **kw)
    K = runner.cfg.K
    init = [interop.params_from_numpy(_np(jtask.init_fn(k)), device="cpu")
            for k in jax.random.split(jax.random.PRNGKey(runner.cfg.seed), K)]
    state = FedState(round=0, global_models=init, ensemble=TeacherBank(K, runner.cfg.R))
    if runner.cfg.local_algo == "scaffold":
        state.scaffold_c_global = tree_zeros_like(init[0])
    return runner.run(rounds, state=state)


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_faulted_rounds_match_jax_runner(tasks, jax_runs, name, execution):
    jtask, task = tasks
    preset, plan, extra = SCENARIOS[name]
    jst = jax_runs(name)
    st = _port_from_jax_init(task, jtask, preset, small(faults=FaultPlan(**plan),
                                                        execution=execution, **extra), 3)
    assert _trace(st) == _trace(jst)
    fired = [r for r in _trace(st) if r["dropped"] or r["rejected"] or r["stragglers"]
             or r["attacked"]]
    assert fired
    for m, jm in zip(st.global_models, jst.global_models):
        _close_to_jax(m, jm)
    if preset == "scaffold":
        _close_to_jax(st.scaffold_c_global, jst.scaffold_c_global)
        assert any(r["stragglers"] for r in _trace(st))


# ------------------------------------------------------------------- (c)
@pytest.fixture(scope="module")
def mlp_task():
    return classification_task(model="mlp", num_clients=4, num_train=256, num_server=256,
                               seed=0, device="cpu")


def mlp_cfg(**kw):
    base = dict(num_clients=4, participation=1.0, rounds=2, local_epochs=1, distill_steps=2,
                client_lr=0.05, server_lr=0.05, seed=0)
    base.update(kw)
    return base


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_zero_rate_plan_bit_identical(mlp_task, execution):
    plain = make_runner("fedsdd", mlp_task, device="cpu", K=2, execution=execution,
                        **mlp_cfg()).run()
    off = make_runner("fedsdd", mlp_task, device="cpu", K=2, execution=execution,
                      faults=FaultPlan(seed=0), **mlp_cfg()).run()
    for a, b in zip(plain.global_models, off.global_models):
        _equal(a, b)
    assert _trace(off) == [{k: None for k in FAULT_KEYS}] * 2


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_faulted_rounds_build_no_new_step_program(mlp_task, execution, monkeypatch):
    """Faults change step counts, not buffer shapes: under ``"scan"`` a
    faulted round 2 replays round 1's programs."""
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    plan = FaultPlan(seed=3, dropout=0.3, straggler=1.0, straggler_frac=0.2, corrupt=0.2)
    r = make_runner("fedsdd", mlp_task, device="cpu", K=2, execution=execution, faults=plan,
                    **mlp_cfg(local_epochs=2, client_batch=16))
    st = r.run_round(r.init_state())
    built = len(r.graphs.programs) + len(r._kd_pipeline().graphs.programs)
    before = sum(step_graph.captures.values())
    st = r.run_round(st)
    r.finalize(st)
    assert any(rec["stragglers"] or rec["dropped"] for rec in _trace(st))
    assert len(r.graphs.programs) + len(r._kd_pipeline().graphs.programs) == built
    assert sum(step_graph.captures.values()) == before


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
@pytest.mark.parametrize("kind", ["corrupt", "dropout"])
def test_emptied_round_carries_model_forward(mlp_task, execution, kind):
    r = make_runner("scaffold", mlp_task, device="cpu", execution=execution,
                    faults=FaultPlan(seed=5, **{kind: 1.0}), **mlp_cfg(rounds=1))
    s0 = r.init_state()
    init = [x.clone() for x in tree_leaves(s0.global_models[0])]
    s1 = r.run_round(s0)
    rec = s1.history[-1]
    assert rec["survivors"] == [] and rec["degraded_groups"] == [0]
    assert rec["rejected" if kind == "corrupt" else "dropped"] == [0, 1, 2, 3]
    for a, b in zip(init, tree_leaves(s1.global_models[0])):
        assert torch.equal(a, b)
    assert 1 in s1.ensemble.degraded_rounds()
    for cid in range(4):        # no control ever committed
        assert all(float(x.abs().max()) == 0.0 for x in tree_leaves(s1.store.get_control(cid)))


def test_renorm_beats_zero_fill_under_dropout(mlp_task):
    kw = mlp_cfg(execution="sequential")
    ren = make_runner("fedavg", mlp_task, device="cpu", faults=FaultPlan(seed=3, dropout=0.4),
                      **kw).run()
    zf = make_runner("fedavg", mlp_task, device="cpu",
                     faults=FaultPlan(seed=3, dropout=0.4, zero_fill=True), **kw).run()
    assert _trace(ren) == _trace(zf) and any(r["dropped"] for r in _trace(ren))
    norm = [sum(float((x.float() ** 2).sum()) for x in tree_leaves(s.global_models[0]))
            for s in (ren, zf)]
    assert norm[1] < norm[0]


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
@pytest.mark.parametrize("aggregator", ["trimmed_mean", "median", "krum", "multi_krum"])
def test_robust_composes_with_dropout_carry_forward(mlp_task, aggregator, execution):
    """Each aggregator on each engine: an all-dropped round carries the
    model forward, and a half-dropped one aggregates the survivors alike
    on both engines."""
    r = make_runner("fedavg", mlp_task, device="cpu", aggregator=aggregator,
                    execution=execution, faults=FaultPlan(seed=5, dropout=1.0),
                    **mlp_cfg(rounds=1))
    s0 = r.init_state()
    init = [x.clone() for x in tree_leaves(s0.global_models[0])]
    s1 = r.run_round(s0)
    assert s1.history[-1]["degraded_groups"] == [0]
    for a, b in zip(init, tree_leaves(s1.global_models[0])):
        assert torch.equal(a, b)
    kw = mlp_cfg(K=2, aggregator=aggregator, faults=FaultPlan(seed=5, dropout=0.3))
    seq = make_runner("fedavg", mlp_task, device="cpu", execution="sequential", **kw).run()
    other = make_runner("fedavg", mlp_task, device="cpu", execution=execution, **kw).run()
    assert _trace(seq) == _trace(other)
    for a, b in zip(seq.global_models, other.global_models):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


def test_spill_fail_chaos_equals_clean_run(mlp_task, tmp_path):
    kw = mlp_cfg(execution="sequential", client_store="spilling", client_cache_buckets=2)
    calls = []
    try:
        clean = make_runner("scaffold", mlp_task, device="cpu",
                            client_store_dir=str(tmp_path / "clean"), **kw).run()
        chaos = make_runner("scaffold", mlp_task, device="cpu",
                            client_store_dir=str(tmp_path / "chaos"),
                            faults=FaultPlan(seed=1, spill_fail=0.7), **kw)
        inject = fedckpt._io_fault_injector

        def counting(path, attempt):
            calls.append(attempt)
            inject(path, attempt)

        fedckpt.set_io_fault_injector(counting)
        chaos = chaos.run()
    finally:
        fedckpt.set_io_fault_injector(None)
    assert 0 in calls and 1 in calls           # first attempts failed and were retried
    for a, b in zip(clean.global_models, chaos.global_models):
        _equal(a, b)
    _equal(clean.scaffold_c_global, chaos.scaffold_c_global)


@pytest.mark.parametrize("overlap", ["async", "fused"])
def test_faulted_trusted_rounds_under_overlap_equal_off(mlp_task, overlap, monkeypatch):
    """Faults, the robust Eq. 2 and trust-weighted teachers under every
    overlap: the drained models at ``off``'s within 2e-4 (``fused`` under
    ``"scan"``, where its paired programs run)."""
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    kw = mlp_cfg(K=2, R=2, rounds=2, execution="vectorized", teacher_trust=True,
                 aggregator="trimmed_mean", clip_norm=2.0,
                 faults=FaultPlan(seed=2, dropout=0.2, corrupt=0.2, attack="sign_flip",
                                  attack_rate=0.3))
    off = make_runner("fedsdd", mlp_task, device="cpu", **kw).run()
    ov = make_runner("fedsdd", mlp_task, device="cpu", overlap=overlap, **kw).run()
    assert _trace(off) == _trace(ov)
    assert [r["teacher_trust"] for r in off.history] == [r["teacher_trust"] for r in ov.history]
    for a, b in zip(off.global_models, ov.global_models):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------- (d)
def resume_cfg(store_dir, **kw):
    base = dict(num_clients=4, K=2, R=1, rounds=3, local_epochs=1, distill_steps=2, seed=0,
                execution="sequential", overlap="async", local_algo="scaffold",
                client_store="spilling", client_store_dir=store_dir, client_cache_buckets=2)
    base.update(kw)
    return base


@pytest.mark.parametrize("ring", [None, "bfloat16"], ids=["ring_f32", "ring_bf16"])
@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_kill_and_restart_bit_identical(mlp_task, tmp_path, execution, ring):
    cfg = dict(execution=execution, teacher_dtype=ring, R=2)
    ra = make_runner("fedsdd", mlp_task, device="cpu",
                     **resume_cfg(str(tmp_path / "store_a"), **cfg))
    sa = ra.init_state()
    for _ in range(3):
        sa = ra.run_round(sa)
    sa = ra.finalize(sa)

    ckpt_dir = str(tmp_path / "ckpt")
    cfg_b = resume_cfg(str(tmp_path / "store_b"), **cfg)
    rb = make_runner("fedsdd", mlp_task, device="cpu", **cfg_b)
    sb = rb.init_state()
    for _ in range(2):
        sb = rb.run_round(sb)
    assert sb.pending_kd is not None and sb.pending_kd.dispatched is not None
    path = rb.save_state(Checkpointer(ckpt_dir, prefix="state"), sb)
    assert os.path.exists(os.path.join(ckpt_dir, "pending_kd_r00002.npz"))
    rb.finalize(sb)
    del rb, sb

    rc = make_runner("fedsdd", mlp_task, device="cpu", **cfg_b)
    sc = rc.restore_state(Checkpointer(ckpt_dir, prefix="state"))
    assert sc is not None and sc.round == 2 and sc.pending_kd is not None
    assert sc.pending_kd.bank is None and sc.pending_kd.dispatched is None
    sc = rc.run_round(sc)
    sc = rc.finalize(sc)
    assert len(sc.history) == len(sa.history) == 3
    assert sc.history[1]["kd_loss_last"] == sa.history[1]["kd_loss_last"]
    for a, b in zip(sa.global_models, sc.global_models):
        _equal(a, b)
    _equal(sa.scaffold_c_global, sc.scaffold_c_global)
    assert path.endswith("state_000002.npz")


def test_restore_state_skips_corrupt_latest_and_empty(mlp_task, tmp_path):
    r = make_runner("fedavg", mlp_task, device="cpu", **mlp_cfg())
    ck = Checkpointer(str(tmp_path / "c"), prefix="state")
    assert r.restore_state(ck) is None
    s = r.run_round(r.init_state())
    r.save_state(ck, s)
    s = r.run_round(s)
    r.save_state(ck, s)
    with open(tmp_path / "c" / "state_000002.npz", "r+b") as f:
        f.write(b"\x00" * 64)
    got = r.restore_state(Checkpointer(str(tmp_path / "c"), prefix="state"))
    assert got is not None and got.round == 1 and len(got.history) == 1


# ------------------------------------------------------------------- (e)
@pytest.fixture(scope="module")
def resume_tasks():
    kw = dict(model="mlp", num_clients=4, num_train=256, num_server=256, seed=0)
    return jax_classification_task(**kw), classification_task(**kw, device="cpu")


@pytest.fixture(scope="module")
def jax_uninterrupted(resume_tasks, tmp_path_factory):
    jtask, _ = resume_tasks
    d = str(tmp_path_factory.mktemp("jax_store"))
    r = jax_make_runner("fedsdd", jtask, **resume_cfg(d))
    s = r.init_state()
    for _ in range(3):
        s = r.run_round(s)
    return r.finalize(s)


def test_port_finishes_a_jax_checkpoint(resume_tasks, jax_uninterrupted, tmp_path):
    jtask, task = resume_tasks
    store, ckpt_dir = str(tmp_path / "store"), str(tmp_path / "ckpt")
    jr = jax_make_runner("fedsdd", jtask, **resume_cfg(store))
    js = jr.init_state()
    for _ in range(2):
        js = jr.run_round(js)
    jr.save_state(JaxCheckpointer(ckpt_dir, prefix="state"), js)
    assert js.pending_kd is not None
    jr.finalize(js)
    r = make_runner("fedsdd", task, device="cpu", **resume_cfg(store))
    s = r.restore_state(Checkpointer(ckpt_dir, prefix="state"))
    assert s.round == 2 and s.pending_kd is not None
    s = r.finalize(r.run_round(s))
    for m, jm in zip(s.global_models, jax_uninterrupted.global_models):
        _close_to_jax(m, jm)
    _close_to_jax(s.scaffold_c_global, jax_uninterrupted.scaffold_c_global)


def test_jax_finishes_a_port_checkpoint(resume_tasks, jax_uninterrupted, tmp_path):
    jtask, task = resume_tasks
    store, ckpt_dir = str(tmp_path / "store"), str(tmp_path / "ckpt")
    r = make_runner("fedsdd", task, device="cpu", **resume_cfg(store))
    init = [interop.params_from_numpy(_np(jtask.init_fn(k)), device="cpu")
            for k in jax.random.split(jax.random.PRNGKey(0), 2)]
    s = FedState(round=0, global_models=init, ensemble=TeacherBank(2, 1))
    s.scaffold_c_global = tree_zeros_like(init[0])
    for _ in range(2):
        s = r.run_round(s)
    r.save_state(Checkpointer(ckpt_dir, prefix="state"), s)
    r.finalize(s)
    jr = jax_make_runner("fedsdd", jtask, **resume_cfg(store))
    js = jr.restore_state(JaxCheckpointer(ckpt_dir, prefix="state"))
    assert js.round == 2 and js.pending_kd is not None
    js = jr.finalize(jr.run_round(js))
    for m, jm in zip(js.global_models, jax_uninterrupted.global_models):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL),
                     _np(m), _np(jm))
