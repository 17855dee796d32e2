"""Port vs reference: ``generate_static``'s step modes over the five
families the port serves statically: dense GQA (qwen2.5-14b), sliding
window (starcoder2-3b), MLA + MoE (deepseek-v2-lite-16b), xLSTM
(xlstm-1.3b) and the Mamba/attention hybrid (jamba-1.5-large-398b), each
at ``reduced()`` with the reference's ``init`` weights carried across.

* Tokens under ``"scan"`` (each decode step one step program, which on
  the CPU runs its body eagerly) equal those under ``"stepped"`` and the
  JAX ``generate_static``'s (the reference's own spec is
  ``tests/test_serve.py::test_static_stepped_matches_scan``).
* Under f32, ``decode_step`` with the position a 0-d int32 tensor gives
  logits and caches bit-identical to those with an int position (which
  its entry makes that tensor once).
* Inside the scan decode body nothing is read back to the host: every
  tensor-to-host conversion raises while the body runs.
* A program serves the parameter set it was built for: a second set of
  the same shapes gets its own tokens, and the stale program is dropped.
* ``max_new_tokens`` 1 and 2; ``REPRO_ENGINE_STEP_MODE`` overrides the
  argument; the right padding enters a recurrent state under both modes.
* A model keeps one program, so one set of caches beyond a call: a call of
  another shape drops the old program, and the decode holds no second copy
  of the prefill's caches.
* A program goes with its parameters, and the model's set with the model;
  a recurrent prefill's states are no views of larger intermediates.

Every ``L + max_new_tokens`` is 32 or 16, multiples of the reduced chunk
(16) that a recurrent model's full forward needs.  MoE configs run at
capacity factor 64 (no drops), and every router table has its k-th and
(k+1)-th probabilities at least 1e-6 apart, asserted, as in
``test_torch_moe_mla.py``: ``torch.topk`` and ``jax.lax.top_k`` may break
a tie apart.
"""
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.serve import generate_static as jax_generate_static  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import make_model_batch  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve import generate_static, static  # noqa: E402

ARCHS = ["qwen2.5-14b", "starcoder2-3b", "deepseek-v2-lite-16b", "xlstm-1.3b",
         "jamba-1.5-large-398b"]
RECURRENT = ["xlstm-1.3b", "jamba-1.5-large-398b"]
NO_DROPS = 64.0
TIE_GAP = 1e-6
B, L, NEW = 2, 20, 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU models of many tiny ops: faster on one thread, and much
    faster where several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if cfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 capacity_factor=NO_DROPS))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=NO_DROPS))
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    jcfg, cfg = _cfgs(request.param)
    jmodel, model = jzoo.build_model(jcfg), zoo.build_model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return request.param, jmodel, jparams, model, params


@pytest.fixture
def router_ties(monkeypatch):
    """Every router table ``moe_ffn`` computes; the test asserts the gap."""
    seen = []
    router_probs = moe.router_probs

    def recording(p, x, cfg):
        probs = router_probs(p, x, cfg)
        seen.append((probs.detach(), cfg.moe.top_k))
        return probs

    monkeypatch.setattr(moe, "router_probs", recording)
    yield seen
    for probs, k in seen:
        top = np.sort(probs.numpy(), axis=-1)[..., ::-1]
        assert (top[..., k - 1] - top[..., k]).min() >= TIE_GAP


def _prompts(cfg, n_tok: int, seed: int):
    return make_model_batch(cfg, B, n_tok, seed=seed)["tokens"]


def _program(model):
    """The model's one static decode program."""
    (prog,) = static._sets[model].programs.values()
    return prog


def test_scan_equals_stepped_and_jax(case, router_ties):
    arch, jmodel, jparams, model, params = case
    prompts = _prompts(model.cfg, L, seed=5)
    scan = generate_static(model, params, prompts, NEW, step_mode="scan")
    stepped = generate_static(model, params, prompts, NEW, step_mode="stepped")
    want = np.asarray(jax_generate_static(jmodel, jparams, prompts, NEW))
    assert scan.dtype == torch.int32 and tuple(scan.shape) == (B, NEW)
    np.testing.assert_array_equal(scan.numpy(), want)
    np.testing.assert_array_equal(stepped.numpy(), want)
    # the output shares no storage with the program's buffers
    assert all(scan.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
               for x in _program(model).buf.values() if isinstance(x, torch.Tensor))


def test_tensor_position_is_bit_identical(case, router_ties):
    """f32: decode steps at a 0-d int32 position on the device give the
    int position's logits and caches bit for bit."""
    arch, _, _, model, params = case
    toks = torch.from_numpy(_prompts(model.cfg, 32, seed=7))
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks})
        a = jax.tree.map(torch.clone, caches)
        b = jax.tree.map(torch.clone, caches)
        for pos in range(16, 20):
            tok = toks[:, pos:pos + 1]
            la, a = model.decode_step(params, tok, a, pos)
            lb, b = model.decode_step(params, tok, b, torch.tensor(pos, dtype=torch.int32))
            assert torch.equal(la, lb), (arch, pos)
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_scan_body_reads_nothing_back(case, router_ties, monkeypatch):
    """Every tensor-to-host conversion raises while the scan decode body
    runs; the tokens still equal the stepped path's."""
    arch, _, _, model, params = case
    prompts = _prompts(model.cfg, L, seed=6)
    want = generate_static(model, params, prompts, NEW, step_mode="stepped")
    body = static._DecodeBody.__call__
    steps = []

    def guarded(self):
        def no_sync(*_a, **_k):
            raise AssertionError(f"{arch}: host sync inside the static decode body")
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                         "__int__", "__float__", "__index__"):
                m.setattr(torch.Tensor, name, no_sync)
            body(self)
        steps.append(1)

    monkeypatch.setattr(static._DecodeBody, "__call__", guarded)
    got = generate_static(model, params, prompts, NEW, step_mode="scan")
    assert len(steps) == NEW - 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v2-lite-16b", "xlstm-1.3b"])
def test_each_parameter_set_gets_its_own_tokens(arch, router_ties):
    """Two parameter sets of the same shapes, served in turns under scan:
    each gets its own stepped tokens, and the program rebuilt for the
    second set replaces (drops) the first's."""
    _, cfg = _cfgs(arch)
    model = zoo.build_model(cfg)
    sets = [model.init(seed, device="cpu") for seed in (1, 2)]
    prompts = _prompts(cfg, L, seed=8)
    want = [generate_static(model, p, prompts, NEW, step_mode="stepped") for p in sets]
    assert not torch.equal(want[0], want[1])
    progs = []
    for i in (0, 1, 0):
        got = generate_static(model, sets[i], prompts, NEW, step_mode="scan")
        assert torch.equal(got, want[i]), (arch, i)
        progs.append(_program(model))
        assert progs[-1].body.serves(sets[i])
    assert progs[0].dropped and progs[1].dropped and not progs[2].dropped


@pytest.mark.parametrize("new", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_and_two_new_tokens(arch, new, router_ties):
    """``max_new_tokens`` 1 runs no step (and builds no program); 2 runs
    one.  L + new = 16."""
    _, cfg = _cfgs(arch)
    model = zoo.build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = _prompts(cfg, 16 - new, seed=9)
    scan = generate_static(model, params, prompts, new, step_mode="scan")
    stepped = generate_static(model, params, prompts, new, step_mode="stepped")
    assert tuple(scan.shape) == (B, new) and scan.dtype == torch.int32
    assert torch.equal(scan, stepped)
    assert (model in static._sets) == (new > 1)


@pytest.mark.parametrize("env,arg,want", [("stepped", "scan", "stepped"),
                                          ("scan", "stepped", "scan"),
                                          (None, "auto", "scan"),
                                          (None, "stepped", "stepped")])
def test_step_mode_policy_and_override(env, arg, want, monkeypatch):
    """``"auto"`` is ``"scan"`` on the CPU (the reference's
    ``cpu_default="scan"``); ``REPRO_ENGINE_STEP_MODE`` overrides the
    argument."""
    if env is None:
        monkeypatch.delenv("REPRO_ENGINE_STEP_MODE", raising=False)
    else:
        monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", env)
    ran = []
    for mode in ("scan", "stepped"):
        fn = getattr(static, f"decode_{mode}")
        monkeypatch.setattr(static, f"decode_{mode}",
                            lambda *a, _m=mode, _f=fn: ran.append(_m) or _f(*a))
    cfg = get_config("qwen2.5-14b").reduced()
    model = zoo.build_model(cfg)
    params = model.init(0, device="cpu")
    generate_static(model, params, _prompts(cfg, 8, seed=1), 4, step_mode=arg)
    assert ran == [want]
    with pytest.raises(ValueError, match="step_mode"):
        monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "jit")
        generate_static(model, params, _prompts(cfg, 8, seed=1), 4)


@pytest.mark.parametrize("arch", RECURRENT)
def test_padding_enters_recurrent_state_in_both_modes(arch, router_ties):
    """The reference's caveat holds under both modes: the decode starts
    from the padded prefill's state.  The scan program's state after the
    run equals the stepped loop's from the padded prefill bit for bit, and
    parts from the state of a decode that starts from an empty one."""
    _, cfg = _cfgs(arch)
    model = zoo.build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = torch.from_numpy(_prompts(cfg, L, seed=10))
    scan = generate_static(model, params, prompts, NEW, step_mode="scan")
    stepped = generate_static(model, params, prompts, NEW, step_mode="stepped")
    assert torch.equal(scan, stepped)
    with torch.no_grad():
        padded = torch.nn.functional.pad(prompts, (0, NEW))
        _, pad_state = model.prefill(params, {"tokens": padded},
                                     last=torch.full((B,), L - 1))
        clean = model.init_cache(B, L + NEW, device="cpu")
        for t in range(L):
            _, clean = model.decode_step(params, prompts[:, t:t + 1], clean, t)
        for t in range(NEW - 1):
            tok = scan[:, t:t + 1]
            _, pad_state = model.decode_step(params, tok, pad_state, L + t)
            _, clean = model.decode_step(params, tok, clean, L + t)
    buf = _program(model).buf["caches"]
    states = [(k, x, y, z) for blk_b, blk_p, blk_c in
              zip([*buf["prefix"], *buf["blocks"].values()],
                  [*pad_state["prefix"], *pad_state["blocks"].values()],
                  [*clean["prefix"], *clean["blocks"].values()])
              for k, x in blk_b.items() if k not in ("k", "v")
              for y, z in [(blk_p[k], blk_c[k])]]
    assert states
    assert all(torch.equal(x, y) for _, x, y, _ in states)
    assert max(float((y - z).abs().max()) for _, _, y, z in states) > 1e-2


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b"])
def test_a_model_keeps_one_set_of_caches(arch, router_ties, monkeypatch):
    """Shape A, A again, then shape B under scan.  While each decode runs,
    no cache leaf of its prefill is alive beside the program's buffers (a
    first call takes them over, a warm call copies them in and frees
    them); after B, the model holds one program, and nothing of A's
    buffers stays resident."""
    _, cfg = _cfgs(arch)
    model = zoo.build_model(cfg)
    params = model.init(0, device="cpu")
    made, extra = [], []
    prefill = model.prefill

    def recording(*a, **k):
        logits, caches = prefill(*a, **k)
        made.append([weakref.ref(x) for x in jax.tree.leaves(caches)])
        return logits, caches

    body = static._DecodeBody.__call__

    def counting(self):
        mine = {id(x) for x in jax.tree.leaves(self.buf["caches"])}
        extra.append(sum(r() is not None and id(r()) not in mine for r in made[-1]))
        body(self)

    monkeypatch.setattr(model, "prefill", recording)
    monkeypatch.setattr(static._DecodeBody, "__call__", counting)
    for n_prompt, new, seed in ((L, NEW, 11), (L, NEW, 12), (10, 6, 13)):
        got = generate_static(model, params, _prompts(cfg, n_prompt, seed), new,
                              step_mode="scan")
        want = generate_static(model, params, _prompts(cfg, n_prompt, seed), new,
                               step_mode="stepped")
        assert torch.equal(got, want)
        if seed == 11:
            first = _program(model)
            adopted = {id(x) for x in jax.tree.leaves(first.buf["caches"])}
            assert any(id(r()) in adopted for r in made[0] if r() is not None)
            a_bufs = [weakref.ref(x) for x in jax.tree.leaves(first.buf["caches"])]
            del first
    assert extra and not any(extra)
    gc.collect()
    assert len(static._sets[model].programs) == 1
    assert all(r() is None for r in a_bufs)
    held = jax.tree.leaves(_program(model).buf["caches"])
    assert all(x.shape in {y.shape for y in jax.tree.leaves(
        model.init_cache(B, 16, device="cpu"))} for x in held)


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_states_hold_only_themselves(arch):
    """The prefill's states, which the static path holds (stepped) or
    copies (scan) for the whole decode, are no views of the scan's larger
    intermediates (Mamba's chunk of states, its input projection)."""
    _, cfg = _cfgs(arch)
    model = zoo.build_model(cfg)
    params = model.init(0, device="cpu")
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": torch.from_numpy(_prompts(cfg, 32, 3))})
    for x in jax.tree.leaves(caches):
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()


def test_programs_go_with_their_parameters_and_model():
    """A program is dropped once its parameters are freed; the model's
    program set goes with the model: no static program outlives either."""
    cfg = get_config("qwen2.5-14b").reduced()
    model = zoo.build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = _prompts(cfg, 8, seed=2)
    generate_static(model, params, prompts, 4, step_mode="scan")
    prog = weakref.ref(_program(model))
    buf = weakref.ref(prog().buf["caches"]["blocks"]["b0"]["k"])
    del params
    gc.collect()
    assert prog() is None and buf() is None
    assert not static._sets[model].programs
    params = model.init(1, device="cpu")
    generate_static(model, params, prompts, 4, step_mode="scan")
    graphs = weakref.ref(static._sets[model])
    prog = weakref.ref(_program(model))
    n_sets = len(static._sets)
    del model
    gc.collect()
    assert graphs() is None and prog() is None
    assert len(static._sets) == n_sets - 1
