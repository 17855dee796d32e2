"""Step programs (``core/step_graph.py``): the scan mode's one device
program per client step, bucket step, KD step and decode chunk.

Imports neither JAX nor the JAX package, so the ``cuda``-marked tests run
where there is a GPU and no JAX; they skip themselves where
``torch.cuda.is_available()`` is false.  The parity of the scan mode with
the JAX package is ``tests/test_torch_step_mode.py``'s.

On the CPU: the buffer helpers; a program runs its body at every call and
captures nothing; a program called on another lane while its set is held
in flight there raises (the planted misuse of a shared pool and buffer),
and a paired program runs its two bodies in turn and refuses two programs
of one set; ``update_`` gives ``update``'s bits for SGD (with and
without momentum and weight decay), FedProx and SCAFFOLD; and the scan
mode gives the stepped mode's bits for the vectorized engine (a padded
multi-bucket round), the sequential runner, the KD pipeline and the serve
engine.

On a card, for each captured program (engine bucket, sequential client
step, the KD step on its dense, flash and head-fused paths, the decode
chunk): the replays give the eager stepped path's bits; they stay right
when the buffers' contents change (new params, new block tables at the
same addresses); a second run of the same shapes captures nothing; no
tensor that leaves a program shares storage with a buffer of it; and a
body with a planted host sync raises at capture, naming the program,
where the stepped path runs.  The LM paths run under
``torch.use_deterministic_algorithms`` (the embedding's backward would
otherwise accumulate with atomics and differ between two runs).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# cuBLAS repeats its sums only with a fixed workspace, which
# torch.use_deterministic_algorithms asks for before the first handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import step_graph  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task, lm_task  # noqa: E402
from repro_torch.distill import KDPipeline, TeacherBank  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.optim.optimizers import (advance_steps, sgd, with_fedprox,  # noqa: E402
                                          with_scaffold)
from repro_torch.serve import ContinuousEngine, Request  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

CNN = dict(model="cnn", num_clients=6, alpha=0.1, num_train=120, num_server=256, seed=3)
LM_TASK = dict(num_clients=4, docs_per_client=2, seq=8, server_batches_n=2, server_batch=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny CPU models run faster on one thread, and much faster where
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _storages(graphs: step_graph.StepGraphs) -> set:
    """The storages of every buffer of every program ``graphs`` holds."""
    return {x.untyped_storage().data_ptr() for p in graphs.programs.values()
            for x in tree_leaves(p.buf) if isinstance(x, torch.Tensor)}


def _shares(tree, graphs) -> bool:
    own = _storages(graphs)
    return any(x.untyped_storage().data_ptr() in own for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


# ================================================================ CPU
def test_buffer_helpers_copy_into_the_leading_part():
    src = {"a": torch.arange(6.).reshape(2, 3), "n": 3, "b": [torch.ones(2)]}
    buf = step_graph.static_like(src, lambda x: (4,) * x.ndim)
    assert buf["n"] == 3 and buf["a"].shape == (4, 4) and buf["b"][0].shape == (4,)
    step_graph.copy_into(buf, src)
    assert torch.equal(buf["a"][:2, :3], src["a"]) and torch.equal(buf["b"][0][:2], src["b"][0])
    out = step_graph.clone_tensors(src)
    assert out["n"] == 3 and out["a"].data_ptr() != src["a"].data_ptr()
    assert step_graph.shape_key(src) == (((2, 3), torch.float32), int, ((2,), torch.float32))


def test_cpu_program_runs_its_body_every_call_and_captures_nothing():
    graphs = step_graph.StepGraphs()
    before = dict(step_graph.captures)

    def build():
        buf = {"x": torch.zeros(3)}
        return (lambda: buf["x"].add_(1)), buf

    prog = graphs.program("count", (3,), build)
    assert graphs.program("count", (3,), build) is prog
    for _ in range(4):
        prog()
    assert torch.equal(prog.buf["x"], torch.full((3,), 4.0))
    assert prog.graph is None and dict(step_graph.captures) == before


def test_shared_buffers_are_one_per_name_and_shapes():
    graphs = step_graph.StepGraphs()
    a = {"w": torch.ones((2, 3)), "b": torch.ones(3)}
    buf = graphs.shared("model", a)
    assert graphs.shared("model", {"w": torch.zeros((2, 3)), "b": torch.zeros(3)}) is buf
    assert graphs.shared("model", {"w": torch.zeros((2, 4)), "b": torch.zeros(4)}) is not buf
    assert graphs.shared("other", a) is not buf
    # another owner's policy over the same programs and buffers
    view = graphs.with_mode("scan", "stepped")
    assert view.shared("model", a) is buf and view.programs is graphs.programs
    # a set of its own: its own programs and buffers
    other = graphs.separate("scan", "scan")
    assert other.shared("model", a) is not buf and other.programs is not graphs.programs


def _model_programs(graphs, names):
    """Programs ``names`` of ``graphs``, each adding its index to the set's
    shared model-sized buffer (as the client and KD steps share one)."""
    model = graphs.shared("model", {"w": torch.zeros(3)})
    model["w"].zero_()                  # a static buffer starts uninitialised

    def build(i):
        return (lambda: model["w"].add_(i)), {"model": model}

    return [graphs.program(n, (), lambda i=i: build(i)) for i, n in enumerate(names, 1)]


def test_a_second_program_in_flight_on_a_shared_set_raises():
    """The planted misuse: a set is held in flight on a lane (its work
    issued there and not waited for), and a program of the same set, which
    shares its pool and model buffer, is called on another lane."""
    graphs = step_graph.StepGraphs()
    kd, client = _model_programs(graphs, ["kd/step", "client/step"])
    with step_graph.on_lane("kd", "cpu"):
        kd()
    graphs.hold("kd", "cpu")
    assert graphs.in_flight
    with pytest.raises(RuntimeError, match="'client/step'.*in flight on lane 'kd'"):
        client()
    with pytest.raises(RuntimeError, match="already in flight"):
        graphs.hold("kd", "cpu")
    with step_graph.on_lane("kd", "cpu"):
        kd()                          # the holding lane goes on
        assert step_graph.current_lane("cpu") == "kd"
    assert step_graph.current_lane("cpu") is None
    graphs.release("cpu")
    client()
    assert torch.equal(client.buf["model"]["w"], torch.full((3,), 4.0))
    # programs of a separate set run beside a held one
    other = graphs.separate()
    (mine,) = _model_programs(other, ["client/step"])
    graphs.hold("kd", "cpu")
    mine()
    graphs.release("cpu")


def test_paired_program_runs_both_bodies_and_needs_two_sets():
    graphs, pairs = step_graph.StepGraphs(), step_graph.StepGraphs()
    (kd,) = _model_programs(graphs.separate(), ["kd/step"])
    (bucket,) = _model_programs(graphs, ["engine/bucket"])
    pair = pairs.pair("fused/kd+bucket", kd, bucket)
    assert pairs.pair("fused/kd+bucket", kd, bucket) is pair
    for _ in range(3):
        pair()
    assert torch.equal(kd.buf["model"]["w"], torch.full((3,), 3.0))
    assert torch.equal(bucket.buf["model"]["w"], torch.full((3,), 3.0))
    assert pair.graph is None and list(pairs.pairs.values()) == [pair]
    (same,) = _model_programs(graphs, ["kd/step"])
    with pytest.raises(RuntimeError, match="of one set"):
        pairs.pair("fused/kd+bucket", same, bucket)
    # a pair whose program its set dropped goes with it
    graphs.drop(bucket)
    (bucket2,) = _model_programs(graphs, ["engine/bucket2"])
    pairs.pair("fused/kd+bucket", kd, bucket2)
    assert [p.b for p in pairs.pairs.values()] == [bucket2]


OPTIMIZERS = {
    "sgd": lambda: sgd(0.1),
    "momentum": lambda: sgd(0.1, momentum=0.9),
    "weight decay": lambda: sgd(0.1, momentum=0.9, weight_decay=1e-3),
    "fedprox": lambda: with_fedprox(sgd(0.1, momentum=0.9), 0.01),
    "scaffold": lambda: with_scaffold(sgd(0.1), 0.1),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_inplace_update_gives_the_out_of_place_bits(name):
    opt = OPTIMIZERS[name]()
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((5, 7), generator=gen), "b": torch.randn((7,), generator=gen)}
    state = opt.init(params)
    if name == "fedprox":
        state["anchor"] = tree_map(lambda x: x + 0.5, params)
    if name == "scaffold":
        state = state._replace(c_local=tree_map(lambda x: x * 0.3, params),
                               c_global=tree_map(lambda x: x * -0.2, params))
    p_out, s_out = params, state
    p_in, s_in = tree_map(torch.clone, params), tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)
    for i in range(3):
        grads = tree_map(lambda x, i=i: torch.sin(x * (i + 1)), p_out)
        upd, s_out = opt.update(grads, s_out, p_out)
        p_out = tree_map(torch.add, p_out, upd)
        opt.update_(tree_map(lambda x, i=i: torch.sin(x * (i + 1)), p_in), s_in, p_in)
    assert _equal(p_out, p_in)
    assert _equal(s_out, advance_steps(s_in, 3))


def _cnn():
    if "cnn" not in _TASKS:
        _TASKS["cnn"] = classification_task(**CNN, device="cpu")
    return _TASKS["cnn"]


_TASKS: dict = {}
RUN = dict(num_clients=6, participation=1.0, local_epochs=2, client_lr=0.05, server_lr=0.05,
           distill_steps=3, client_batch=32, K=2, R=2)


def _rounds(task, device, mode, monkeypatch, preset="fedsdd", **kw):
    """Two rounds from the same weights under ``REPRO_ENGINE_STEP_MODE=mode``."""
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", mode)
    runner = make_runner(preset, task, device=device, **{**RUN, **kw})
    init = make_runner(preset, task, device=device, **{**RUN, **kw}).init_state()
    state = FedState(round=0, global_models=init.global_models,
                     ensemble=TeacherBank(runner.cfg.K, runner.cfg.R))
    if runner.cfg.local_algo == "scaffold":
        state.scaffold_c_global = init.scaffold_c_global
    return runner, runner.run(2, state=state)


@pytest.mark.parametrize("preset,execution", [
    ("fedsdd", "vectorized"), ("scaffold", "vectorized"), ("fedprox", "sequential"),
    ("scaffold", "sequential"), ("fedsdd_basic_kd", "sequential")])
def test_scan_gives_the_stepped_bits_on_cpu(preset, execution, monkeypatch):
    """A round with several buckets and padded steps: every global model,
    the KD losses and SCAFFOLD's controls, scan against stepped."""
    task = _cnn()
    runs = {m: _rounds(task, "cpu", m, monkeypatch, preset, execution=execution)
            for m in ("scan", "stepped")}
    (r_scan, scan), (_, stepped) = runs["scan"], runs["stepped"]
    for a, b in zip(scan.global_models, stepped.global_models):
        assert _equal(a, b)
    assert [h.get("kd_loss_last") for h in scan.history] == \
        [h.get("kd_loss_last") for h in stepped.history]
    if preset == "scaffold":
        for cid in range(RUN["num_clients"]):
            assert _equal(scan.store.get_control(cid), stepped.store.get_control(cid))
    names = {n for n, _ in r_scan.graphs.programs}
    assert ("engine/bucket" if execution == "vectorized" else "client/step") in names


CNN_ROUNDS = {
    "uniform": (dict(CNN, num_clients=8, alpha=0.5, num_train=400, seed=0),
                dict(num_clients=8, K=1, local_epochs=1)),
    "ragged": (dict(CNN, num_clients=7, alpha=0.5, num_train=400, seed=0),
               dict(num_clients=7, K=2, local_epochs=1)),
    "buckets": (CNN, dict(K=2)),
}


@pytest.mark.parametrize("preset", ["fedavg", "fedprox", "scaffold"])
@pytest.mark.parametrize("rounds", list(CNN_ROUNDS))
def test_engine_scan_gives_the_stepped_bits_over_round_kinds(preset, rounds, monkeypatch):
    """The vectorized engine's bucket program against its stepped loop over
    uniform groups, ragged groups and several buckets."""
    spec, kw = CNN_ROUNDS[rounds]
    task = classification_task(**spec, device="cpu")
    runs = {m: _rounds(task, "cpu", m, monkeypatch, preset, execution="vectorized",
                       fedprox_mu=0.01, **kw)[1] for m in ("scan", "stepped")}
    for a, b in zip(runs["scan"].global_models, runs["stepped"].global_models):
        assert _equal(a, b)
    if preset == "scaffold":
        for cid in range(kw.get("num_clients", RUN["num_clients"])):
            assert _equal(runs["scan"].store.get_control(cid),
                          runs["stepped"].store.get_control(cid))


KD_PIPES = {
    "dense": dict(kd_kernel="dense"),
    "flash_f32": dict(kd_kernel="flash", cache_dtype="float32"),
    "flash_bf16": dict(kd_kernel="flash"),
    "head_fused": dict(kd_kernel="flash", head_fusion=True),
}


@pytest.mark.parametrize("target", ["main", "all"])
@pytest.mark.parametrize("option", list(KD_PIPES))
def test_kd_scan_gives_the_stepped_bits_over_paths(option, target):
    """The KD step program against the stepped KD loop on the LM task, for
    each KD path, one student (``distill``) and two (``distill_all``)."""
    task = lm_task(get_config("stablelm-3b").reduced(), **LM_TASK, device="cpu")
    gen = torch.Generator().manual_seed(0)
    teachers = [task.init_fn(gen) for _ in range(2)]
    students = [task.init_fn(gen) for _ in range(2)]
    outs = {}
    for mode in ("scan", "stepped"):
        pipe = KDPipeline(task.logits_fn, steps=3, lr=0.05, device="cpu", step_mode=mode,
                          features_fn=task.features_fn, head_fn=task.head_fn,
                          **KD_PIPES[option])
        if target == "main":
            outs[mode] = pipe.distill(students[0], teachers, task.server_batches)
        else:
            outs[mode] = pipe.distill_all(tree_map(lambda *x: torch.stack(x), *students),
                                          teachers, task.server_batches)
    assert _equal(outs["scan"][0], outs["stepped"][0]) and outs["scan"][1] == outs["stepped"][1]


def _served(arch="stablelm-3b"):
    cfg = get_config(arch).reduced()
    model = model_zoo.build_model(cfg)
    return cfg, model


def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, int(rng.integers(3, 12)))
                    .astype(np.int32), max_new_tokens=int(rng.integers(1, 9)))
            for i in range(n)]


def _serve(model, params, reqs, mode, monkeypatch):
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", mode)
    eng = ContinuousEngine(model, params, max_batch=2, num_blocks=24, block_size=4,
                           max_seq_len=24, chunk_steps=3)
    return eng, {r.rid: r.tokens for r in eng.run(reqs)}


def test_serve_scan_gives_the_stepped_tokens_on_cpu(monkeypatch):
    cfg, model = _served()
    params = model.init(0, device="cpu")
    reqs = _requests(cfg, 5, seed=1)
    eng, scan = _serve(model, params, reqs, "scan", monkeypatch)
    _, stepped = _serve(model, params, _requests(cfg, 5, seed=1), "stepped", monkeypatch)
    assert scan == stepped and len(scan) == 5
    assert [n for n, _ in eng.graphs.programs] == ["decode/chunk"]


def test_resolution_and_override(monkeypatch):
    resolve = step_graph.resolve_step_mode
    monkeypatch.delenv("REPRO_ENGINE_STEP_MODE", raising=False)
    assert resolve("auto", "stepped", "cpu") == "stepped"
    assert resolve("auto", "scan", "cpu") == "scan"
    assert resolve("auto", "stepped", "cuda") == "scan"
    assert resolve("stepped", "scan", "cuda") == "stepped"
    # each owner's policy: "auto" is stepped for the engines off a card,
    # scan for the KD pipeline and the serve engine
    runner = make_runner("fedsdd", _cnn(), device="cpu", execution="vectorized", **RUN)
    assert not runner.graphs.scan("cpu") and not runner._make_engine().graphs.scan("cpu")
    assert runner._kd_pipeline().graphs.scan("cpu") and runner.graphs.scan("cuda")
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "stepped")
    assert resolve("scan", "scan", "cuda") == "stepped"
    assert not runner._kd_pipeline().graphs.scan("cuda")
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "x")
    with pytest.raises(ValueError, match="step_mode"):
        resolve("auto")
    with pytest.raises(ValueError, match="step_mode"):
        KDPipeline(lambda p, b: b, steps=1, lr=0.1, device="cpu", step_mode="x")
    with pytest.raises(ValueError, match="step_mode"):
        step_graph.StepGraphs().with_mode("x")


def test_kd_scan_writes_the_cache_into_its_program():
    """Under scan the round's teacher cache is built in the KD step
    program's own buffer, so it is held once; the stepped path's cache has
    the same values."""
    task = lm_task(get_config("stablelm-3b").reduced(), **LM_TASK, device="cpu")
    gen = torch.Generator().manual_seed(0)
    teachers = [task.init_fn(gen) for _ in range(2)]
    student = task.init_fn(gen)
    for opts in KD_PIPES.values():
        pipe = KDPipeline(task.logits_fn, steps=2, lr=0.05, device="cpu", step_mode="scan",
                          features_fn=task.features_fn, head_fn=task.head_fn, **opts)
        batches = pipe.batches_for(task.server_batches)
        cache = pipe._cache(student, teachers, batches)
        (prog,) = pipe.graphs.programs.values()
        assert all(a is b for a, b in zip(tree_leaves(cache), tree_leaves(prog.buf["cache"])))
        assert _equal(cache, pipe.precompute_cache(teachers, batches))
        assert step_graph.shape_key(pipe.cache_like(teachers, batches)) == \
            step_graph.shape_key(cache)


def test_launch_counts_read_the_host_and_reset():
    """Eager launches count on the host; with no card, ``counted`` is them."""
    kernels.reset()
    kernels.count("kd_loss_fwd", "cpu")
    kernels.count("kd_loss_fwd", torch.device("cpu"))
    kernels.count("flash_kd_head_bwd", "cpu")
    assert kernels.counted() == kernels.launches == {"kd_loss_fwd": 2, "flash_kd_head_bwd": 1}
    assert not kernels.replayed()
    with pytest.raises(KeyError):
        kernels.count("no_such_kernel", "cpu")
    kernels.reset()
    assert not kernels.counted()


def test_every_wrapper_counts_under_a_known_name():
    """Each wrapper's ``kernels.count`` names a slot of the card's counter."""
    import re
    from pathlib import Path
    root = Path(kernels.__file__).parent
    names = set()
    for f in root.glob("*/ops.py"):
        for arg in re.findall(r"kernels\.count\(([^,]+),", f.read_text()):
            names |= set(re.findall(r'"(\w+)"', arg))
    assert names == set(kernels.NAMES)


# ================================================================ card
def _counted(fn):
    """``fn()`` and the launches by wrapper it ran on the card: the eager
    ones and those of replays, which the card counted (a replay runs no
    wrapper)."""
    before = kernels.counted()
    out = fn()
    return out, kernels.counted() - before


def _card_rounds(task, mode, monkeypatch, **kw):
    """Two rounds under ``mode``, then a third of the same shapes from the
    same start: the captures it adds and its state."""
    runner, state = _rounds(task, "cuda", mode, monkeypatch, **kw)
    torch.cuda.synchronize()
    return runner, state


@pytest.mark.cuda
@pytest.mark.parametrize("execution", ["vectorized", "sequential"])
def test_client_and_kd_programs_replay_the_stepped_bits_on_card(execution, monkeypatch):
    _needs_card()
    task = classification_task(**CNN, device="cuda")
    torch.backends.cudnn.deterministic = True
    try:
        runner, scan = _card_rounds(task, "scan", monkeypatch, execution=execution)
        _, stepped = _card_rounds(task, "stepped", monkeypatch, execution=execution)
        for a, b in zip(scan.global_models, stepped.global_models):
            assert _equal(a, b)
        assert [h["kd_loss_last"] for h in scan.history] == \
            [h["kd_loss_last"] for h in stepped.history]
        assert not any(_shares(m, runner.graphs) for m in scan.global_models)
        # a third round of the same shapes: nothing new is captured, and the
        # replays stay right with the buffers' new contents
        before = dict(step_graph.captures)
        monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
        scan3 = runner.run(1, state=scan)
        assert dict(step_graph.captures) == before
        monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "stepped")
        stepped3 = make_runner("fedsdd", task, device="cuda",
                               **{**RUN, "execution": execution}).run(1, state=stepped)
        for a, b in zip(scan3.global_models, stepped3.global_models):
            assert _equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = False


KD_PATHS = {
    "dense": dict(kd_kernel="dense"),
    "flash": dict(kd_kernel="flash"),
    "head-fused": dict(kd_kernel="flash", head_fusion=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(KD_PATHS))
def test_kd_step_replays_the_stepped_bits_on_card(path):
    _needs_card()
    cfg = get_config("gemma-2b").reduced()
    task = lm_task(cfg, **LM_TASK, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    teachers = [task.init_fn(gen) for _ in range(3)]
    students = [task.init_fn(gen) for _ in range(2)]
    opts = KD_PATHS[path]
    pipes = {m: KDPipeline(task.logits_fn, steps=5, lr=0.05, device="cuda", step_mode=m,
                           features_fn=task.features_fn, head_fn=task.head_fn, **opts)
             for m in ("scan", "stepped")}
    torch.use_deterministic_algorithms(True)
    try:
        outs = {m: [p.distill(st, teachers, task.server_batches) for st in students]
                for m, p in pipes.items()}
        before = dict(step_graph.captures)
        kernels.launches.clear()
        again, launches = _counted(
            lambda: pipes["scan"].distill(students[1], teachers, task.server_batches))
    finally:
        torch.use_deterministic_algorithms(False)
    assert dict(step_graph.captures) == before
    for (a, ia), (b, ib) in zip(outs["scan"], outs["stepped"]):
        assert _equal(a, b) and ia == ib
    assert _equal(again[0], outs["stepped"][1][0]) and again[1] == outs["stepped"][1][1]
    assert not _shares(again[0], pipes["scan"].graphs)
    want = {"dense": ("kd_loss_fwd", "kd_loss_bwd"), "flash": ("flash_kd_fwd", "flash_kd_bwd"),
            "head-fused": ("flash_kd_head_fwd", "flash_kd_head_bwd")}[path]
    assert all(launches.get(k) == 5 for k in want), launches
    assert not any(kernels.launches[k] for k in want), kernels.launches   # replays only


@pytest.mark.cuda
def test_decode_chunk_replays_the_stepped_tokens_on_card(monkeypatch):
    _needs_card()
    cfg, model = _served("qwen2.5-14b")
    params = model.init(0, device="cuda")
    reqs = _requests(cfg, 7, seed=2)
    eng, scan = _serve(model, params, reqs, "scan", monkeypatch)
    _, stepped = _serve(model, params, _requests(cfg, 7, seed=2), "stepped", monkeypatch)
    assert scan == stepped
    # a second run on the same engine: the block tables, seq_lens and
    # tokens change in the same buffers, nothing is captured again
    monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    before, steps0 = dict(step_graph.captures), eng.steps
    kernels.launches.clear()
    again, launches = _counted(lambda: {r.rid: r.tokens for r in eng.run(_requests(cfg, 7, seed=2))})
    assert again == scan and dict(step_graph.captures) == before
    assert launches["paged_decode"] == cfg.num_layers * (eng.steps - steps0)
    assert kernels.launches["paged_decode"] == 0            # replays only
    assert not any(isinstance(t, torch.Tensor) and _shares(t, eng.graphs)
                   for t in eng._step_toks)


@pytest.mark.cuda
def test_a_planted_host_sync_raises_at_capture_on_card(monkeypatch):
    _needs_card()
    graphs = step_graph.StepGraphs()

    def build():
        buf = {"x": torch.zeros(4, device="cuda")}

        def body():
            buf["x"].add_(1)
            float(buf["x"].sum())           # a host sync

        return body, buf

    prog = graphs.program("planted", (), build)
    with pytest.raises(RuntimeError, match="'planted'"):
        prog()
    # the same sync in a client loss: the engine's bucket program raises
    # under scan, and the stepped path runs it
    task = classification_task(**CNN, device="cuda")
    loss_fn = task.loss_fn

    def syncing(p, b):
        loss, aux = loss_fn(p, b)
        return loss * float(torch.ones((), device="cuda")), aux

    task = dataclasses.replace(task, loss_fn=syncing)
    with pytest.raises(RuntimeError, match="client/step"):
        _rounds(task, "cuda", "scan", monkeypatch, execution="sequential")
    _rounds(task, "cuda", "stepped", monkeypatch, execution="sequential")
