"""Port vs reference: llama4-maverick-400b-a17b, the top-1 MoE family
(128 experts, top-1 + 1 shared expert, MoE at every other layer from layer
0, GQA 40 / 8, window 8,192, V 202,048; ``reduced()``: 2 layers, 4
experts, window 64), with the reference's weights carried across.

  (a) the full and reduced schedules (the full one a superblock of two
      layers, MoE then dense, 24 times); the parameter tree.
  (b) features, the loss with its aux term and the gradients against the
      JAX model; the top-1 gate is exactly 1, so the routed output is the
      chosen expert's, unscaled (both packages); decode from
      ``init_cache`` against the full forward within 5e-4 (no drops).
  (c) the paged ``ContinuousEngine`` against the JAX engine past the
      64-token window at ``chunk_steps`` 3 and 8 (each JAX dispatch waited
      for, as ``test_torch_starcoder2.py`` does); ``generate_static``
      against JAX's; the engine against the static path within the window.
  (d) two LM FedSDD rounds (head-fused Flash-KD) on both engines against
      the JAX runner.

Top-1 is the most tie-sensitive routing: every router table the port
computes here has its first and second probabilities at least 1e-6
apart, asserted (``router_ties``).  Tolerances: f32 both sides, summed in
other orders: features and the loss rtol 1e-5 (atol 1e-5); gradients
rtol 1e-4 / atol 1e-6; decode within 5e-4 and rounds within 2e-4, the
reference's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import lm_task as jax_lm_task  # noqa: E402
from repro.data.synthetic import make_model_batch  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.serve import ContinuousEngine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import generate_static as jax_generate_static  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import lm_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import apply_mlp  # noqa: E402
from repro_torch.optim.optimizers import value_and_grad  # noqa: E402
from repro_torch.serve import ContinuousEngine, Request, generate_static  # noqa: E402

ARCH = "llama4-maverick-400b-a17b"
TIE_GAP = 1e-6
NO_DROPS = 64.0
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU runs: faster on one thread where test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, rtol=1e-5, atol=1e-5):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=rtol, atol=atol),
                 interop.params_to_numpy(port), _np(ref))


def _cfgs(capacity=None):
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if capacity is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 capacity_factor=capacity))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=capacity))
    return jcfg, cfg


@pytest.fixture
def router_ties(monkeypatch):
    """Every router table ``moe_ffn`` computes; the test asserts the gap
    between the first and second probabilities of every token."""
    seen = []
    router_probs = moe.router_probs

    def recording(p, x, cfg):
        probs = router_probs(p, x, cfg)
        # the vectorized engine's vmapped tables and the step planner's
        # meta tensors hold no values; the sequential runs route the same
        # client batches
        wrapped = torch._C._functorch.is_functorch_wrapped_tensor(probs)
        if probs.device.type != "meta" and not wrapped:
            seen.append(probs.detach())
        return probs

    monkeypatch.setattr(moe, "router_probs", recording)
    yield seen
    assert seen
    for probs in seen:
        top = np.sort(probs.numpy(), axis=-1)[..., ::-1]
        assert (top[..., 0] - top[..., 1]).min() >= TIE_GAP


@pytest.fixture(scope="module")
def model_case():
    jcfg, cfg = _cfgs()
    jmodel, model = jzoo.build_model(jcfg), zoo.build_model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, jparams, model, interop.params_from_numpy(_np(jparams), device="cpu")


# -------------------------------------------------------------------- (a)
def test_full_schedule_is_moe_then_dense():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    kinds, jkinds = zoo.layer_schedule(cfg), jzoo.layer_schedule(jcfg)
    assert [(k.mixer, k.ffn) for k in kinds] == [(k.mixer, k.ffn) for k in jkinds]
    assert zoo.split_schedule(kinds) == jzoo.split_schedule(jkinds) == (0, 2)
    model = zoo.build_model(cfg)
    assert model.prefix_period == jzoo.build_model(jcfg).prefix_period == (0, 2)
    assert model.n_super == 24
    assert model.superblock == [zoo.BlockKind("gqa", "moe"), zoo.BlockKind("gqa", "dense")]
    assert cfg.moe.top_k == 1 and cfg.moe.num_shared_experts == 1
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.num_active_params() == jcfg.num_active_params()


def test_reduced_schedule_and_tree_match_reference(model_case):
    jmodel, jparams, model, params = model_case
    assert model.prefix_period == jmodel.prefix_period == (1, 1)
    assert model.schedule == [zoo.BlockKind("gqa", "moe"), zoo.BlockKind("gqa", "dense")]
    assert model.cfg.moe.top_k == 1 and model.cfg.sliding_window == 64
    jflat = jax.tree_util.tree_flatten_with_path(_np(jparams))[0]
    fresh = interop.params_to_numpy(model.init(0, device="cpu"))
    flat = jax.tree_util.tree_flatten_with_path(fresh)[0]
    assert [(p, a.shape, a.dtype) for p, a in flat] == [(p, a.shape, a.dtype) for p, a in jflat]
    assert "shared" in params["prefix"][0]["moe"]


# -------------------------------------------------------------------- (b)
def test_features_loss_and_grad_match_reference(model_case, router_ties):
    jmodel, jparams, model, params = model_case
    nb = make_model_batch(jmodel.cfg, B, S, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    _close(model.features(params, batch), jax.jit(jmodel.features)(jparams, nb))
    (jloss, jinfo), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, nb)
    (loss, info), grads = value_and_grad(model.loss, has_aux=True)(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(info["moe_aux"]), float(jinfo["moe_aux"]), rtol=1e-5)
    assert float(info["moe_aux"]) > 0
    _close(grads, jgrads, rtol=1e-4, atol=1e-6)
    moe_grads = grads["prefix"][0]["moe"]
    assert all(float(moe_grads[k].abs().max()) > 0 for k in ("router", "w_in"))
    assert float(moe_grads["shared"]["w_in"].abs().max()) > 0


def test_top1_gate_is_one_in_both_packages(model_case, router_ties):
    """Top-1's renormalised gate is p / p = 1: a token's routed output is
    its expert's FFN, unscaled by the router probability (so the router
    learns through the aux loss alone), plus the shared expert."""
    jmodel, jparams, model, params = model_case
    cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(model.cfg.moe,
                                                                 capacity_factor=NO_DROPS))
    jcfg = dataclasses.replace(jmodel.cfg, moe=dataclasses.replace(jmodel.cfg.moe,
                                                                   capacity_factor=NO_DROPS))
    p = params["prefix"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(24, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        out, _ = moe.moe_ffn(p, x, cfg)
        e = moe.router_probs(p, x, cfg).argmax(-1)
        want = torch.stack([apply_mlp({k: p[k][int(ei)] for k in ("w_in", "w_gate", "w_out")},
                                      x[t], cfg) for t, ei in enumerate(e)])
        want = want + apply_mlp(p["shared"], x, cfg)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    from repro.models import moe as jmoe
    jout, _ = jmoe.moe_ffn(_np(jparams)["prefix"][0]["moe"], jnp.asarray(x.numpy()), jcfg)
    np.testing.assert_allclose(np.asarray(jout), want.numpy(), rtol=1e-5, atol=1e-5)


def test_decode_matches_full_forward(router_ties):
    """Token-by-token decode against the cache == the full forward, no
    drops (capacity 64), the reference's ``test_decode_consistency``."""
    _, cfg = _cfgs(NO_DROPS)
    model = zoo.build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(make_model_batch(cfg, B, S)["tokens"])
    with torch.no_grad():
        full, _ = model.logits(params, {"tokens": toks})
        cache = model.init_cache(B, S, device="cpu")
        dec = torch.stack([model.decode_step(params, toks[:, t:t + 1], cache, t)[0]
                           for t in range(S)], dim=1)
    assert float((dec - full).abs().max()) < 5e-4 * max(1.0, float(full.abs().max()))


# -------------------------------------------------------------------- (c)
def _requests(cls, cfg, lens, news, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, L).astype(np.int32),
                max_new_tokens=n) for i, (L, n) in enumerate(zip(lens, news))]


def _tokens(results):
    return {r.rid: list(map(int, r.tokens)) for r in results}


def _jax_engine(jmodel, jparams, **kw):
    """The JAX ``ContinuousEngine`` with each decode dispatch waited for
    (its aliased host block table races with its own evictions on a loaded
    CPU: ROADMAP §C)."""
    eng = JaxEngine(jmodel, jparams, **kw)
    decode = eng._decode
    eng._decode = lambda *a: jax.block_until_ready(decode(*a))
    return eng


# prompts and generations past the 64-token window
LONG_LENS, LONG_NEWS = [80, 40, 130, 9], [30, 45, 12, 70]


@pytest.mark.parametrize("chunk_steps", [3, 8])
def test_engine_matches_reference_engine_past_the_window(model_case, router_ties,
                                                         chunk_steps):
    jmodel, jparams, model, params = model_case
    kw = dict(max_batch=3, num_blocks=80, block_size=8, max_seq_len=160,
              chunk_steps=chunk_steps)
    mine = ContinuousEngine(model, params, **kw).run(
        _requests(Request, model.cfg, LONG_LENS, LONG_NEWS, seed=1))
    ref = _jax_engine(jmodel, jparams, **kw).run(
        _requests(JaxRequest, model.cfg, LONG_LENS, LONG_NEWS, seed=1))
    got, want = _tokens(mine), _tokens(ref)
    assert got == want
    assert [len(got[i]) for i in range(len(LONG_NEWS))] == LONG_NEWS


def test_static_matches_reference_static(model_case, router_ties):
    jmodel, jparams, model, params = model_case
    prompts = make_model_batch(model.cfg, B, 20, seed=5)["tokens"]
    got = generate_static(model, params, prompts, 12).numpy()
    want = np.asarray(jax_generate_static(jmodel, jparams, prompts, 12))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_steps", [3, 8])
def test_engine_matches_static_within_the_window(model_case, router_ties, chunk_steps):
    """No drops (capacity 64): the static prefill routes all prompts as one
    group, the engine each prompt alone, so capacity drops would differ."""
    params = model_case[3]
    model = zoo.build_model(_cfgs(NO_DROPS)[1])
    reqs = _requests(Request, model.cfg, [20, 20, 20], [40, 9, 44], seed=2)
    assert all(len(r.tokens) + r.max_new_tokens <= model.cfg.sliding_window for r in reqs)
    got = _tokens(ContinuousEngine(model, params, max_batch=2, num_blocks=40, block_size=8,
                                   max_seq_len=64, chunk_steps=chunk_steps).run(reqs))
    static = generate_static(model, params, np.stack([r.tokens for r in reqs]), 44).numpy()
    assert got == {r.rid: static[i, :r.max_new_tokens].tolist() for i, r in enumerate(reqs)}


# -------------------------------------------------------------------- (d)
TASK = dict(num_clients=4, docs_per_client=2, seq=16, server_batches_n=2, server_batch=2)
ROUND = dict(num_clients=4, participation=1.0, local_epochs=1, client_lr=0.02, client_batch=2,
             distill_steps=3, server_lr=0.02, K=2, R=1, kd_kernel="flash", kd_head_fusion=True)


@pytest.fixture(scope="module")
def jax_rounds():
    """The JAX runner's two sequential rounds, shared by both of the port's
    engines (the reference's engines agree within its tolerance)."""
    jtask = jax_lm_task(jax_get_config(ARCH).reduced(), **TASK)
    jrunner = jax_make_runner("fedsdd", jtask, **ROUND)
    keys = jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), jrunner.cfg.K)
    init = [_np(jtask.init_fn(k)) for k in keys]
    return init, jrunner.run(rounds=2)


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_two_lm_rounds_match_jax_runner(jax_rounds, router_ties, execution):
    init, jstate = jax_rounds
    task = lm_task(get_config(ARCH).reduced(), **TASK, device="cpu")
    runner = make_runner("fedsdd", task, device="cpu", execution=execution, **ROUND)
    state = runner.run(2, state=FedState(
        round=0, global_models=[interop.params_from_numpy(m, device="cpu") for m in init],
        ensemble=TeacherBank(2, 1)))
    for m, jm in zip(state.global_models, jstate.global_models):
        _close(m, jm, rtol=2e-4, atol=2e-4)
    for rec, jrec in zip(state.history, jstate.history):
        for k in ("kd_loss_first", "kd_loss_last"):
            np.testing.assert_allclose(rec[k], jrec[k], rtol=2e-4, atol=2e-4)

