"""Overlapped rounds (``overlap="async"|"fused"``, ``core/round_plan.py``)
against the back-to-back oracle, the spec of ``tests/test_overlap_parity.py``
without its forced ``shard_map`` and spill cases.

Round t's KD is deferred into round t+1's k>0 training, an exact
reordering: after the drain (``finalize``, called by ``run``) the state
is the ``overlap="off"`` one within 2e-4 (the reference's ATOL = RTOL).

On the CPU (the tiny MLP task, 8 clients):
  * ``async`` and ``fused`` against the port's ``off``, for ``fedsdd`` and
    ``feddf``, K in {1, 4}, both engines; the deferred-job state machine
    (pending job, drain, late-patched records); warm-up rounds; resume
    across ``run`` calls; the ``ValueError`` without the fused pipeline;
    no ``t_kd`` in overlapped rounds; the paired programs of ``fused``
    (under ``REPRO_ENGINE_STEP_MODE=scan``, where both sides are step
    programs: the reference's ``test_truly_fused_program_runs_and_matches``);
  * the ring refuses a push while a pending job holds its views, and a KD
    pipeline planted on the client programs' set raises when its job is in
    flight beside a client step;
  * the port's ``async`` against the JAX runner's ``async`` from the same
    numpy weights, one sequential and one vectorized fedsdd K=4 run from
    module-scoped fixtures.

On a card (``cuda`` marker; no JAX needed, it is imported by the fixtures
that use it): ``async`` matches ``off`` at 2e-4 on both engines and
``fused`` on the vectorized one; the KD's dispatch and the resolve's wait
run under ``torch.cuda.set_sync_debug_mode("error")``; the run's KD and
client step programs issued together on the two streams take less time
than one after the other; ``push`` raises while the pending job holds the
ring.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.core import step_graph  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.distill import KDPipeline, TeacherBank  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

ATOL = RTOL = 2e-4
TASK = dict(model="mlp", num_clients=8, alpha=0.5, num_train=320, num_server=256, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def task():
    return classification_task(**TASK, device="cpu")


def small(**kw):
    base = dict(num_clients=8, participation=1.0, local_epochs=1, client_lr=0.05,
                server_lr=0.05, distill_steps=4, client_batch=32)
    base.update(kw)
    return base


def _max_err(ms_a, ms_b) -> float:
    assert len(ms_a) == len(ms_b)
    return max(float((x - y).abs().max()) for a, b in zip(ms_a, ms_b)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def assert_models_close(ms_a, ms_b):
    assert len(ms_a) == len(ms_b)
    for a, b in zip(ms_a, ms_b):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            np.testing.assert_allclose(x.detach().cpu().numpy(), y.detach().cpu().numpy(),
                                       rtol=RTOL, atol=ATOL)


def run_overlap(task, preset, overlap, *, rounds=3, device="cpu", **kw):
    return make_runner(preset, task, device=device, overlap=overlap,
                       **small(**kw)).run(rounds=rounds)


# ----------------------------------------------------------- full matrix
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("preset", ["fedsdd", "feddf"])
@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_overlap_modes_match_off(task, preset, K, execution):
    off = run_overlap(task, preset, "off", K=K, execution=execution)
    for mode in ("async", "fused"):
        st = run_overlap(task, preset, mode, K=K, execution=execution)
        assert_models_close(off.global_models, st.global_models)
        assert st.pending_kd is None          # run() drained
        assert [h["round"] for h in st.history] == [1, 2, 3]


def test_overlap_matches_sequential_oracle(task):
    oracle = run_overlap(task, "fedsdd", "off", K=4, execution="sequential")
    both = run_overlap(task, "fedsdd", "fused", K=4, execution="vectorized")
    assert_models_close(oracle.global_models, both.global_models)


def test_paired_programs_run_and_match(task, monkeypatch):
    """Scan on both sides: each KD step runs paired with a k>0 bucket step
    (the reference's one fused program), and the state matches off."""
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    r = make_runner("fedsdd", task, device="cpu", overlap="fused", execution="vectorized",
                    **small(K=2))
    st = r.run(rounds=3)
    pairs = r._executor()._pairs
    assert pairs is not None and pairs.pairs, "fused overlap never built a paired program"
    (prog,) = {p.a for p in pairs.pairs.values()}
    assert prog.name == "kd/step" and all(p.b.name == "engine/bucket"
                                          for p in pairs.pairs.values())
    assert r._kd_pipeline().graphs.programs is not r.graphs.programs
    off = run_overlap(task, "fedsdd", "off", K=2, execution="vectorized")
    assert_models_close(off.global_models, st.global_models)


def test_fused_falls_back_to_async_by_configuration(task):
    """Where the engine's steps are not step programs (the CPU's stepped
    default) ``fused`` runs the async path: no paired program is built."""
    r = make_runner("fedsdd", task, device="cpu", overlap="fused", execution="vectorized",
                    **small(K=2))
    r.run(rounds=2)
    assert r._executor()._pairs is None


# ------------------------------------------------- deferred-KD mechanics
def test_pending_kd_defers_and_drains(task):
    off = make_runner("fedsdd", task, device="cpu", overlap="off", **small(K=2)).run(rounds=2)
    r = make_runner("fedsdd", task, device="cpu", overlap="async", **small(K=2))
    st = r.init_state()
    for _ in range(2):
        st = r.run_round(st)
    assert st.pending_kd is not None and st.pending_kd.round_idx == 2
    rec = st.history[-1]
    assert "kd_steps" not in rec          # patched only at resolve
    assert st.last_distilled is not None and st.last_distilled[0] == 1
    assert _max_err([st.global_models[0]], [off.global_models[0]]) > 0   # the raw aggregate
    st = r.finalize(st)
    assert st.pending_kd is None and st.last_distilled[0] == 2
    assert rec["kd_steps"] == 4 and "acc_main" in rec
    assert_models_close(off.global_models, st.global_models)


def test_push_raises_while_the_pending_job_holds_the_ring(task):
    r = make_runner("fedsdd", task, device="cpu", overlap="async", **small(K=2))
    st = r.run_round(r.init_state())
    assert st.ensemble.held and st.pending_kd.bank is st.ensemble
    with pytest.raises(RuntimeError, match="pending KD job"):
        st.ensemble.push(2, st.global_models)
    st = r.finalize(st)
    assert not st.ensemble.held
    st.ensemble.push(2, st.global_models)
    with pytest.raises(RuntimeError, match="without a hold"):
        st.ensemble.release()


def test_a_kd_pipeline_on_the_client_set_raises_in_flight(task, monkeypatch):
    """The misuse the separate sets prevent: a KD pipeline planted on the
    runner's own step-program set; its job is in flight on the KD lane when
    round 2's k>0 client steps run, and the first of them raises."""
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    r = make_runner("fedsdd", task, device="cpu", overlap="async", **small(K=2))
    cfg = r.cfg
    r._kd_pipe = KDPipeline(task.logits_fn, steps=cfg.distill_steps, lr=cfg.server_lr,
                            device="cpu", graphs=r.graphs)
    st = r.run_round(r.init_state())
    assert r.graphs.in_flight
    with pytest.raises(RuntimeError, match="in flight on lane 'kd'"):
        r.run_round(st)


def test_an_overlapped_runner_is_freed_without_the_cycle_collector(task, monkeypatch):
    """The runner, its KD pipeline, its step-program sets and the paired
    programs form no reference cycle: dropping the last reference frees
    them at once (a cycle would keep their graph pools until the collector
    ran, and a collection during a later capture would break it)."""
    import gc
    import weakref
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    gc.collect()
    gc.disable()
    try:
        r = make_runner("fedsdd", task, device="cpu", overlap="fused", execution="vectorized",
                        **small(K=2))
        st = r.run(rounds=3)
        pairs = r._executor()._pairs
        assert pairs.pairs
        refs = [weakref.ref(x) for x in (r, r._kd_pipeline(), r._executor(), pairs,
                                          *pairs.pairs.values(), *r.graphs.programs.values())]
        del r, pairs, st
        assert [ref() for ref in refs] == [None] * len(refs)
    finally:
        gc.enable()


def test_overlap_history_matches_off(task):
    off = run_overlap(task, "fedsdd", "off", K=2)
    ov = run_overlap(task, "fedsdd", "async", K=2)
    assert len(off.history) == len(ov.history)
    for a, b in zip(off.history, ov.history):
        assert a["round"] == b["round"] and a["active"] == b["active"]
        assert a.get("kd_steps") == b.get("kd_steps")
        assert a["acc_main"] == pytest.approx(b["acc_main"], abs=2e-3)
        assert a.get("kd_loss_last") == pytest.approx(b.get("kd_loss_last"), rel=1e-3)


def test_overlap_with_warmup_rounds(task):
    kw = dict(K=2, distill_warmup_rounds=2)
    off = run_overlap(task, "fedsdd", "off", rounds=4, **kw)
    ov = run_overlap(task, "fedsdd", "async", rounds=4, **kw)
    assert_models_close(off.global_models, ov.global_models)
    assert off.history[0].get("kd_steps") is None
    assert ov.history[0].get("kd_steps") is None
    assert ov.history[-1]["kd_steps"] == 4


def test_overlap_resume_across_run_calls(task):
    whole = run_overlap(task, "fedsdd", "async", rounds=4, K=2)
    r = make_runner("fedsdd", task, device="cpu", overlap="async", **small(K=2))
    st = r.run(rounds=2)
    st = r.run(rounds=2, state=st)
    assert_models_close(whole.global_models, st.global_models)


def test_overlap_requires_fused_pipeline(task):
    with pytest.raises(ValueError, match="overlapped rounds"):
        make_runner("fedsdd", task, device="cpu", overlap="async", kd_pipeline="legacy",
                    **small())


def test_spill_and_restore_wait_for_the_robustness_slice(task, tmp_path):
    """Since the robustness slice: the pending job's spill and restore round
    trip.  The restored job (its inputs from the npz, no ring held) drains
    to the same main model as the job left in flight, bit for bit."""
    r = make_runner("fedsdd", task, device="cpu", overlap="async", **small(K=2))
    st = r.run_round(r.init_state())
    path = r.spill_pending(st, str(tmp_path))
    assert path == str(tmp_path / "pending_kd_r00001.npz")
    assert r.spill_pending(FedState(round=0, global_models=[], ensemble=None),
                           str(tmp_path)) is None
    st2 = FedState(round=1, global_models=[dict(m) for m in st.global_models],
                   ensemble=TeacherBank(2, 1), history=[dict(st.history[0])])
    assert "kd_loss_last" not in st2.history[0]
    want = r.finalize(st).global_models[0]
    r2 = make_runner("fedsdd", task, device="cpu", overlap="async", **small(K=2))
    pending = r2.restore_pending(st2, path)
    assert pending.bank is None and pending.record is st2.history[-1]
    got = r2.finalize(st2).global_models[0]
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert st2.history[-1]["kd_loss_last"] == st.history[-1]["kd_loss_last"]


def test_overlap_records_round_walltime(task):
    t = dataclasses.replace(task, eval_fn=None)
    st = run_overlap(t, "fedsdd", "off", rounds=1, K=2)
    rec = st.history[-1]
    assert rec["t_round"] >= rec["t_local"] > 0
    assert rec["t_kd"] > 0
    st = run_overlap(t, "fedsdd", "async", rounds=2, K=2)
    assert all(r["t_round"] > 0 for r in st.history)
    assert "t_kd" not in st.history[-1] and "t_local" not in st.history[-1]


def test_run_logs_the_newest_complete_record(task, capsys):
    make_runner("fedsdd", task, device="cpu", overlap="async",
                **small(K=2)).run(rounds=3, log_every=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split("]")[0] for line in lines] == ["[round   1", "[round   2"]
    assert all("kd_loss_last=" in line and "acc_main=" in line for line in lines)


# ----------------------------------------------------------- against JAX
def _jax_run(execution):
    jax = pytest.importorskip("jax")
    from repro.core.fedsdd import make_runner as jax_make_runner
    from repro.core.tasks import classification_task as jax_classification_task
    jtask = jax_classification_task(**TASK)
    jrunner = jax_make_runner("fedsdd", jtask, overlap="async", execution=execution,
                              **small(K=4, R=2))
    init = [jax.tree.map(np.asarray, jtask.init_fn(k))
            for k in jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), 4)]
    st = jrunner.run(rounds=3)
    return ([jax.tree.map(np.asarray, m) for m in st.global_models], st.history, init)


@pytest.fixture(scope="module")
def jax_sequential():
    return _jax_run("sequential")


@pytest.fixture(scope="module")
def jax_vectorized():
    return _jax_run("vectorized")


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_async_matches_the_jax_runner(task, execution, request):
    jmodels, jhistory, init = request.getfixturevalue(f"jax_{execution}")
    runner = make_runner("fedsdd", task, device="cpu", overlap="async", execution=execution,
                         **small(K=4, R=2))
    state = FedState(round=0, global_models=[interop.params_from_numpy(m, device="cpu")
                                             for m in init], ensemble=TeacherBank(4, 2))
    state = runner.run(3, state=state)
    for m, jm in zip(state.global_models, jmodels):
        for k, v in interop.params_to_numpy(m).items():
            np.testing.assert_allclose(v, jm[k], rtol=RTOL, atol=ATOL)
    for rec, jrec in zip(state.history, jhistory):
        assert rec["round"] == jrec["round"] and rec["kd_steps"] == jrec["kd_steps"]
        for k in ("kd_loss_first", "kd_loss_last"):
            np.testing.assert_allclose(rec[k], jrec[k], rtol=RTOL, atol=ATOL)
        assert abs(rec["acc_main"] - jrec["acc_main"]) <= 0.01


# ------------------------------------------------------------- on a card
CARD_TASK = dict(model="cnn", num_clients=8, alpha=0.5, num_train=2000, num_server=1024,
                 seed=0)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the KD stream and CUDA graphs have no CPU mode")


@pytest.fixture(scope="module")
def card_task():
    _needs_card()
    return classification_task(**CARD_TASK, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("execution,mode", [("sequential", "async"), ("vectorized", "async"),
                                            ("vectorized", "fused")])
def test_overlap_matches_off_on_card(card_task, execution, mode):
    _needs_card()
    torch.backends.cudnn.deterministic = True
    try:
        off = run_overlap(card_task, "fedsdd", "off", device="cuda", K=4, R=2,
                          execution=execution)
        r = make_runner("fedsdd", card_task, device="cuda", overlap=mode, execution=execution,
                        **small(K=4, R=2))
        st = r.run(rounds=3)
    finally:
        torch.backends.cudnn.deterministic = False
    assert_models_close(off.global_models, st.global_models)
    assert r._kd_pipeline().graphs.programs is not r.graphs.programs
    assert (mode == "fused") == bool(r._executor()._pairs and r._executor()._pairs.pairs)


def _rounds_on_card(card_task, execution, n=2, **kw):
    r = make_runner("fedsdd", card_task, device="cuda", overlap="async", execution=execution,
                    **small(K=4, R=2, **kw))
    st = r.init_state()
    for _ in range(n):
        st = r.run_round(st)
    torch.cuda.synchronize()
    return r, st


@pytest.mark.cuda
@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_kd_dispatch_and_resolve_make_no_host_sync_on_card(card_task, execution):
    """After two warm rounds (every program captured), round 3's KD is issued
    and round 4 waits for it with the card's sync check raising on any
    synchronising call; the pending job's outputs are device tensors."""
    _needs_card()
    r, st = _rounds_on_card(card_task, execution)
    pipe, captures0 = r._kd_pipeline(), dict(step_graph.captures)
    issue, join = pipe.distill_async, pipe.join

    def strict(fn):
        def call(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    pipe.distill_async, pipe.join = strict(issue), strict(join)
    try:
        st = r.run_round(st)
        assert st.pending_kd.dispatched is not None and pipe.graphs.in_flight
        assert all(x.is_cuda for x in tree_leaves(st.pending_kd.dispatched))
        st = r.run_round(st)
        st = r.finalize(st)
    finally:
        del pipe.distill_async, pipe.join     # no cycle through the pipeline's own dict
    assert dict(step_graph.captures) == captures0, "a steady round captured a graph"
    assert all(np.isfinite(h["kd_loss_last"]) for h in st.history)


@pytest.mark.cuda
def test_kd_and_client_step_programs_run_at_once_on_card(card_task):
    """The run's KD step program on the KD stream and its client step
    program on the caller's stream, issued together, take less time than
    the two one after the other (CUDA events, the median of three): the
    card runs them at once.  (torch.profiler cannot show it: under its
    tracing two streams' graphs never run at the same time.)"""
    _needs_card()
    import statistics
    r, st = _rounds_on_card(card_task, "sequential", distill_steps=20)
    r.finalize(st)                      # round 2's KD resolved: the KD set is free
    pipe = r._kd_pipeline()
    kd = next(p for (n, _), p in pipe.graphs.programs.items() if n == "kd/step")
    client = next(p for (n, _), p in r.graphs.programs.items() if n == "client/step")
    lane, cur = pipe.lane(), torch.cuda.current_stream()

    def kd_steps():
        for i in range(60):
            if i % 20 == 0:
                kd.buf["s"].zero_()     # the schedule's step counter
            kd()

    def client_steps():
        for _ in range(150):
            client()

    def together():
        lane.wait_stream(cur)
        with torch.cuda.stream(lane):
            kd_steps()
        client_steps()
        cur.wait_stream(lane)

    def ms(fn):
        out = []
        for _ in range(4):
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out[1:])

    alone = ms(kd_steps) + ms(client_steps)
    assert ms(together) < alone


@pytest.mark.cuda
def test_push_raises_while_pending_holds_the_ring_on_card(card_task):
    _needs_card()
    r, st = _rounds_on_card(card_task, "vectorized", n=1)
    with pytest.raises(RuntimeError, match="pending KD job"):
        st.ensemble.push(2, st.global_models)
    r.finalize(st)
