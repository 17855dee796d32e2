"""The port's program contracts (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

Each rule and pass must catch a planted violation, give the reference's
verdict on the reference's own cases, and the port's hot paths must run
clean under the contracts: rounds of both engines under every overlap mode
after two warm rounds, and a ``ContinuousEngine`` decode chunk (the
reference's ``tests/test_analysis.py``).  The reference's passes no longer
run on the installed JAX, so their expected answers come from the cases'
construction.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.lint import lint_source as ref_lint  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    SyncViolation, TraceGuard, TraceViolation, allowed_sync, dtype_drift,
    live_intermediate_shapes, max_live_intermediate_bytes, sync_contract, trace_program,
)
from repro_torch.analysis.lint import lint_paths, lint_source  # noqa: E402
from repro_torch.core import step_graph  # noqa: E402
from repro_torch.core.step_graph import StepGraphs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

HOT = "src/repro_torch/core/engine.py"      # rule profile: hot module
COLD = "src/repro_torch/utils/pytree.py"    # rule profile: library, not hot
REF_HOT, REF_COLD = "src/repro/core/engine.py", "src/repro/utils/pytree.py"
FAULTS = "src/repro/core/faults.py"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for the module: the same arithmetic, and much
    faster where several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rules(findings):
    return [f.rule for f in findings]


# ================================================================ linter
# the reference's snippets (tests/test_analysis.py): (source, path, rules)
REFERENCE_SNIPPETS = [
    ("x = float(jnp.sum(v))\n", REF_HOT, ["RA101"]),
    ("x = float(len(vals))\ny = int(cid)\n", REF_HOT, []),
    ("a = x.item()\nb = y.tolist()\n", REF_HOT, ["RA101", "RA101"]),
    ("a = np.asarray(loss)\nb = np.asarray([1, 2, 3])\n", REF_HOT, ["RA101"]),
    ("a = jax.device_get(x)\n", REF_HOT, ["RA101"]),
    ("a = float(jnp.sum(v))\nb = x.item()\n", REF_COLD, []),
    ("with allowed_sync('one-per-round pull'):\n"
     "    a = np.asarray(loss)\n"
     "    b = float(jnp.sum(v))\n", REF_HOT, []),
    ("a = np.asarray(gids)  # lint-ok: RA101 host group map\n", REF_HOT, []),
    ("a = np.asarray(loss)  # lint-ok: RA201 wrong rule\n", REF_HOT, ["RA101"]),
    ("assert K >= 1\n", REF_COLD, ["RA201"]),
    ("assert x.shape[0] == 8\n", "src/repro/kernels/kd_loss/flash.py", []),
    ("assert x.shape[0] == 8\n", "src/repro/models/resnet.py", []),
    ("a = np.random.rand(3)\nb = np.random.randint(10)\n", REF_COLD, ["RA301", "RA301"]),
    ("r = np.random.default_rng()\n", REF_COLD, ["RA301"]),
    ("r = np.random.default_rng(seed)\n", REF_COLD, []),
    ("t = time.time()\n", REF_HOT, ["RA302"]),
    ("t = time.time()\n", REF_COLD, []),
    ("t = time.perf_counter()\n", REF_HOT, []),
    ("def client_faults(self, round_idx, cid):\n"
     "    r = np.random.default_rng((self.seed, round_idx, cid))\n", FAULTS, []),
    ("def other(self):\n    r = np.random.default_rng(self.seed)\n", FAULTS, ["RA401"]),
]


@pytest.mark.parametrize("src,path,expected", REFERENCE_SNIPPETS)
def test_both_linters_agree_on_the_reference_snippets(src, path, expected):
    ref = [(f.line, f.rule) for f in ref_lint(src, path)]
    assert [(f.line, f.rule) for f in lint_source(src, path)] == ref
    assert [r for _, r in ref] == expected
    port_path = path.replace("src/repro/", "src/repro_torch/")
    assert [(f.line, f.rule) for f in lint_source(src, port_path)] == ref


TORCH_SNIPPETS = [
    ("a = x.cpu()\nb = y.numpy()\nc = z.to('cpu')\nd = w.to(device='cpu')\n", HOT,
     ["RA101"] * 4),
    ("a = x.to(dev)\nb = y.to(torch.float32)\n", HOT, []),
    ("a = float(torch.sum(v))\nb = int(torch.argmin(s))\nc = bool(F.relu(x).any())\n", HOT,
     ["RA101"] * 3),
    ("torch.cuda.synchronize()\n", HOT, ["RA101"]),
    ("a = x.cpu().numpy()\ntorch.cuda.synchronize()\n", COLD, []),
    ("with allowed_sync('the record'):\n    a = x.cpu().tolist()\n    torch.cuda.synchronize()\n",
     HOT, []),
    ("a = torch.randn(3)\nb = torch.rand(2, 2)\nc = torch.randint(0, 9, (4,))\n", COLD,
     ["RA301"] * 3),
    ("a = torch.randperm(5)\nb = torch.normal(m, s)\nc = torch.bernoulli(p)\n"
     "d = torch.multinomial(p, 1)\ne = torch.randn_like(x)\n", COLD, ["RA301"] * 5),
    ("torch.manual_seed(0)\ntorch.cuda.manual_seed_all(0)\n", COLD, ["RA301"] * 2),
    ("g = torch.Generator().manual_seed(0)\na = torch.randn(3, generator=g)\n"
     "b = torch.randperm(5, generator=g)\nc = x.normal_(generator=g)\n", COLD, []),
]


@pytest.mark.parametrize("src,path,expected", TORCH_SNIPPETS)
def test_torch_sinks_and_draws(src, path, expected):
    assert rules(lint_source(src, path)) == expected


def test_port_is_lint_clean():
    assert lint_paths(["src/repro_torch"]) == []


def test_lint_cli_exit_codes(tmp_path, capsys):
    from repro_torch.analysis.lint import main
    bad = tmp_path / "core" / "engine.py"
    bad.parent.mkdir()
    bad.write_text("a = x.item()\n")
    assert main([str(bad)]) == 1
    assert "RA101" in capsys.readouterr().out
    assert main(["src/repro_torch"]) == 0
    assert main([]) == 2


# ========================================================= sync_contract
PULLS = {
    "item": lambda x: x.sum().item(),
    "float": lambda x: float(x.sum()),
    "tolist": lambda x: x.tolist(),
    "bool": lambda x: bool(x.any()),
    "numpy": lambda x: np.asarray(x),
    "index": lambda x: [0, 1, 2, 3][x[1].long()],
}


@pytest.mark.parametrize("kind", sorted(PULLS))
def test_funnel_catches_planted_sync_and_names_the_site(kind):
    x = torch.arange(4.0)
    with pytest.raises(SyncViolation, match="sync_contract\\[planted\\]") as e:
        with sync_contract("planted"):
            PULLS[kind](x)
    assert "test_funnel_catches_planted_sync_and_names_the_site" in str(e.value)


@pytest.mark.parametrize("kind", sorted(PULLS))
def test_allowed_sync_permits(kind):
    x = torch.arange(4.0)
    with sync_contract("annotated") as scope:
        with allowed_sync("test pull"):
            PULLS[kind](x)
    assert scope.violations == []


def test_compute_is_clean_and_no_contract_no_interference():
    with sync_contract("compute") as scope:
        y = torch.ones(16).sum() * 2
        z = (y + 1).to(torch.float64)
    assert scope.violations == []
    assert float(z) == 33.0 and torch.ones(2).tolist() == [1.0, 1.0]


def test_reason_is_mandatory():
    for reason in ("", "   "):
        with pytest.raises(ValueError, match="reason"):
            with allowed_sync(reason):
                pass


def test_swallowed_violation_reraises_at_exit():
    x = torch.ones(3)
    with pytest.raises(SyncViolation, match="swallowed"):
        with sync_contract("swallow"):
            try:
                x.sum().item()
            except SyncViolation:
                pass


def test_nested_contracts_both_see_the_violation():
    with pytest.raises(SyncViolation):
        with sync_contract("outer") as outer:
            with sync_contract("inner") as inner:
                try:
                    torch.ones(2).tolist()
                except SyncViolation:
                    pass
    assert len(outer.violations) == 1 and len(inner.violations) == 1


# ============================================================ TraceGuard
def _program(graphs: StepGraphs, n: int):
    def build():
        buf = {"x": torch.zeros(n)}
        return (lambda: buf["x"].add_(1)), buf
    return graphs.program("planted/step", (n,), build)


def test_trace_guard_names_a_planted_capture():
    graphs = StepGraphs("scan")
    prog = _program(graphs, 4)
    try:
        with TraceGuard("planted").watch_programs(graphs) as tg:
            prog()
            step_graph.captures["planted/step"] += 1     # what a card's capture bumps
            prog.captures += 1
        assert tg.compiles == 1 and tg.traces == 1
        assert tg.captured() == {"planted/step": 1}
        assert tg.cache_growth() == {"planted/step": 1}
        with pytest.raises(TraceViolation, match="planted/step"):
            tg.assert_steady_state()
    finally:
        del step_graph.captures["planted/step"]


def test_trace_guard_counts_kernel_builds():
    try:
        with TraceGuard("build") as tg:
            build.loads["kd_loss"] += 1
        assert tg.compiles == 1 and tg.traces == 0 and tg.built() == {"kd_loss": 1}
        with pytest.raises(TraceViolation, match="kd_loss"):
            tg.assert_steady_state()
    finally:
        del build.loads["kd_loss"]


def test_trace_guard_steady_state_and_labels():
    graphs = StepGraphs("scan")
    for n in (4, 8):
        _program(graphs, n)()
    assert set(graphs.jit_programs()) == {"planted/step", "planted/step[1]"}
    with TraceGuard("steady").watch_programs(graphs) as tg:
        for _ in range(3):
            _program(graphs, 4)()
    tg.assert_steady_state()
    assert tg.report() == {"label": "steady", "compiles": 0, "traces": 0, "cache_growth": {},
                           "captured": {}, "built": {}}


# ===================================================== fx program passes
def test_dtype_drift_catches_planted_upcast():
    cache = torch.zeros((2048, 1024), dtype=torch.bfloat16)
    gm = trace_program(lambda c: (c.float() * 2).sum(), cache)
    drifts = dtype_drift(gm)
    assert len(drifts) == 1
    assert drifts[0].shape == (2048, 1024) and drifts[0].elements == 2048 * 1024
    assert (drifts[0].src, drifts[0].dst) == ("bfloat16", "float32")


def test_dtype_drift_ignores_small_casts():
    gm = trace_program(lambda x: x.float().sum(), torch.zeros(8, dtype=torch.bfloat16))
    assert dtype_drift(gm) == []


def test_live_intermediate_bytes_bounds_planted_blowup():
    gm = trace_program(lambda x: (x @ x.T).sum(), torch.zeros((512, 64)))
    assert max_live_intermediate_bytes(gm) >= 512 * 512 * 4
    assert (512, 512) in live_intermediate_shapes(gm)


def test_dead_code_is_not_live():
    def f(x):
        _ = x @ x.T                     # dead: no consumer
        return x.sum()
    gm = trace_program(f, torch.zeros((512, 64)))
    assert (512, 512) not in live_intermediate_shapes(gm)
    assert max_live_intermediate_bytes(gm) == 4


# ================================================= hot paths run clean
@pytest.fixture(scope="module")
def task():
    from repro_torch.core.tasks import classification_task
    return classification_task(model="mlp", num_clients=8, alpha=0.5, num_train=320,
                               num_server=256, seed=0, device="cpu")


@pytest.mark.parametrize("step_mode", ["auto", "scan"])
@pytest.mark.parametrize("execution,overlap", [
    ("vectorized", "off"), ("vectorized", "async"), ("vectorized", "fused"),
    ("sequential", "off"), ("sequential", "async"), ("sequential", "fused"),
])
def test_smoke_round_contracts(task, execution, overlap, step_mode, monkeypatch):
    """The FedSDD hot path, both engines × overlap modes (and every loop as
    step programs): after two warm rounds a round builds nothing and makes
    no un-annotated device→host sync."""
    from repro_torch.core.fedsdd import make_runner
    if step_mode == "scan":
        monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    r = make_runner("fedsdd", task, device="cpu", num_clients=8, participation=1.0,
                    local_epochs=1, client_lr=0.05, server_lr=0.05, distill_steps=4,
                    client_batch=32, K=2, execution=execution, overlap=overlap)
    st = r.init_state()
    for _ in range(2):                       # warm every program
        st = r.run_round(st)
    tg = TraceGuard(f"round/{execution}/{overlap}")
    tg.watch_programs(r.graphs, r._kd_pipeline())
    if execution == "vectorized":
        tg.watch_programs(r._make_engine())
    pairs = r._executor()._pairs
    if pairs is not None:
        tg.watch_programs(pairs)
    if step_mode == "scan":
        assert tg.cache_growth(), "no step program to watch"
        if (execution, overlap) == ("vectorized", "fused"):
            assert pairs is not None and pairs.pairs, "fused ran no paired program"
    with tg, sync_contract(f"round/{execution}/{overlap}") as scope:
        st = r.run_round(st)
    tg.assert_steady_state()
    assert scope.violations == []
    assert st.history[-1]["round"] == 3
    r.finalize(st)


def test_continuous_engine_decode_chunk_contracts():
    """A ContinuousEngine decode chunk at steady state: no capture, no
    un-annotated sync (the per-request first-token pull and the eviction
    materialisation are allowed_sync-annotated)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_model_batch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import ContinuousEngine, Request

    cfg = get_config("qwen2.5-14b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")

    def requests(seed):
        toks = np.asarray(make_model_batch(cfg, 2, 32, seed=seed)["tokens"])
        return [Request(rid=seed * 10 + i, tokens=toks[i], max_new_tokens=8)
                for i in range(2)]

    kw = dict(max_batch=2, num_blocks=24, chunk_steps=4)
    eng = ContinuousEngine(model, params, **kw)
    eng.run(requests(seed=0))                # warms the chunk program
    for req in requests(seed=1):
        eng.submit(req)
    tg = TraceGuard("serve/decode").watch_programs(eng)
    assert list(tg.cache_growth()) == ["decode/chunk"]
    with tg, sync_contract("serve/decode") as scope:
        out = []
        while len(out) < 2:
            out.extend(eng.step())
    tg.assert_steady_state()
    assert scope.violations == []
    assert sorted(r.rid for r in out) == [10, 11]
    assert all(len(r.tokens) == 8 for r in out)
