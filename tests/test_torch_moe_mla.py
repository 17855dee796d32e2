"""Port vs reference: the MoE + MLA family (deepseek-v2-lite-16b).

  (a) ``moe_ffn``: outputs, the router's aux loss and the gradients (input,
      router, expert banks, shared expert) against ``repro.models.moe`` on
      the same weights and inputs, at capacity 1.25 (drops at group 48) and
      64 (no drops), group sizes 8 / 16 / 48; with no drops the port's
      output does not depend on the grouping (the reference's
      ``test_regressions.py`` finding), with drops it does.
  (b) MLA: ``mla_forward`` (the expanded form, q/k head dim nope + rope, v
      its own) and ``mla_decode`` (the absorbed form over the latent cache)
      step by step against the reference; the absorbed decode against the
      expanded forward (the reference's ``test_attention_ssm.py`` check).
  (c) deepseek-v2-lite-16b ``reduced()``: the schedule (prefix 1, period 1),
      the parameter tree, features, the loss with its aux term and the
      gradient against the JAX model; decode against the full forward with
      no drops; ``generate_static`` tokens against the JAX static oracle.
  (d) two LM FedSDD rounds (head-fused Flash-KD) on both engines against
      the JAX runner.

Top-k: ``torch.topk`` and ``jax.lax.top_k`` may break ties apart, and the
two round the f32 router product apart, so every input here has its k-th
and (k+1)-th router probabilities at least 1e-6 apart, asserted.
Tolerances: f32 both sides, summed in other orders: outputs and the loss
at rtol 1e-5 (atol 1e-5 on O(1) activations); gradients at rtol 1e-4,
atol 1e-6; decode against the forward within 5e-4 and the absorbed form
within 5e-5, the reference's own; rounds at 2e-4, the reference's
end-to-end tolerance.
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve import generate_static as jax_generate_static  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import lm_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model_zoo import BlockKind, build_model  # noqa: E402
from repro_torch.optim.optimizers import value_and_grad  # noqa: E402
from repro_torch.serve import generate_static  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TIE_GAP = 1e-6


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


def _assert_no_topk_ties(probs, k: int):
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    assert (top[..., k - 1] - top[..., k]).min() >= TIE_GAP


# -------------------------------------------------------------------- (a)
@pytest.fixture(scope="module")
def moe_case():
    """Weights from the reference's ``init_moe``; expert 0's router column
    leans on the inputs' mean, so most tokens choose it and a group of 48
    overflows capacity 1.25."""
    jcfg, _ = _cfgs()
    p = jax.tree.map(np.array, jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    p["router"][:, 0] += 0.02
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(48, jcfg.d_model)) + 0.5).astype(np.float32)
    r = rng.normal(size=(48, jcfg.d_model)).astype(np.float32)
    _assert_no_topk_ties(jmoe.router_probs(p, jnp.asarray(x), jcfg), jcfg.moe.top_k)
    return p, x, r


def _port_moe(p, x, r, cfg, g):
    pt = interop.params_from_numpy(p, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    for v in jax.tree.leaves(pt):
        v.requires_grad_(True)
    out, aux = moe.moe_ffn(pt, xt, cfg, group_size=g)
    ((out * torch.from_numpy(r)).mean() + aux).backward()
    return out.detach(), aux.detach(), xt.grad, jax.tree.map(lambda v: v.grad, pt)


@pytest.mark.parametrize("group", [8, 16, 48])
@pytest.mark.parametrize("capacity", [1.25, 64.0])
def test_moe_ffn_matches_reference(moe_case, capacity, group):
    p, x, r = moe_case
    jcfg, cfg = _cfgs(capacity)
    assert moe._capacity(group, cfg) == jmoe._capacity(group, jcfg)

    def jloss(p_, x_):
        out, aux = jmoe.moe_ffn(p_, x_, jcfg, group_size=group)
        return jnp.mean(out * r) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    out, aux, gx, gp = _port_moe(p, x, r, cfg, group)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-6)
    _close(gp, jgp, rtol=1e-4, atol=1e-6)
    assert float(gp["router"].abs().max()) > 0      # through the gates and aux


def test_moe_grouping_changes_only_with_drops(moe_case):
    p, x, r = moe_case
    pt = interop.params_from_numpy(p, device="cpu")
    xt = torch.from_numpy(x)
    _, free = _cfgs(64.0)
    outs = [moe.moe_ffn(pt, xt, free, group_size=g)[0] for g in (8, 16, 48)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=1e-5)
    _, tight = _cfgs(1.25)
    dropped = moe.moe_ffn(pt, xt, tight, group_size=48)[0]
    assert float((dropped - outs[0]).abs().max()) > 1e-3     # capacity 32 of 48 dropped


def test_moe_ffn_pads_a_ragged_last_group(moe_case):
    """T = 40 in groups of 16: the padded tokens route to expert E (dropped)
    and never take a slot, as in the reference."""
    p, x, r = moe_case
    jcfg, cfg = _cfgs()
    jout, jaux = jax.jit(lambda p_, x_: jmoe.moe_ffn(p_, x_, jcfg, group_size=16))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x[:40]))
    out, aux = moe.moe_ffn(interop.params_from_numpy(p, device="cpu"),
                           torch.from_numpy(x[:40]), cfg, group_size=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# -------------------------------------------------------------------- (b)
@pytest.fixture(scope="module")
def mla_case():
    jcfg, cfg = _cfgs()
    p = _np(jattn.init_mla(jax.random.PRNGKey(2), jcfg))
    x = np.random.default_rng(3).normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, x


def test_mla_forward_matches_reference(mla_case):
    jcfg, cfg, p, x = mla_case
    jout, (jc, jk) = jax.jit(lambda p_, x_: jattn.mla_forward(p_, x_, jcfg))(p, jnp.asarray(x))
    out, (c, k) = attn.mla_forward(interop.params_from_numpy(p, device="cpu"),
                                   torch.from_numpy(x), cfg)
    m = cfg.mla
    assert out.shape == (2, 12, cfg.d_model)
    assert c.shape == (2, 12, m.kv_lora_rank) and k.shape == (2, 12, m.rope_head_dim)
    for a, b in ((out, jout), (c, jc), (k, jk)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_mla_decode_matches_reference_and_expanded_form(mla_case):
    jcfg, cfg, p, x = mla_case
    pt = interop.params_from_numpy(p, device="cpu")
    m = cfg.mla
    jcache = {"c_kv": jnp.zeros((2, 12, m.kv_lora_rank)),
              "k_rope": jnp.zeros((2, 12, m.rope_head_dim))}
    cache = {k: torch.zeros(s) for k, s in attn.mla_cache_shape(cfg, 2, 12).items()}
    outs = []
    jdecode = jax.jit(lambda p_, x_, c_, t_: jattn.mla_decode(p_, x_, c_, jcfg, t_))
    for t in range(12):
        jo, jcache = jdecode(p, jnp.asarray(x[:, t:t + 1]), jcache, t)
        o, cache = attn.mla_decode(pt, torch.from_numpy(x[:, t:t + 1]), cache, cfg, t)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
        outs.append(o)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=1e-5,
                                   atol=1e-5)
    full, _ = attn.mla_forward(pt, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=5e-5)


# -------------------------------------------------------------------- (c)
@pytest.fixture(scope="module")
def model_case():
    jcfg, cfg = _cfgs()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, jparams, model, interop.params_from_numpy(_np(jparams), device="cpu")


def test_schedule_and_tree_match_reference(model_case):
    jmodel, jparams, model, params = model_case
    assert model.prefix_period == jmodel.prefix_period == (1, 1)
    assert model.schedule == [BlockKind("mla", "dense"), BlockKind("mla", "moe")]
    assert [(k.mixer, k.ffn) for k in model.schedule] == \
        [(k.mixer, k.ffn) for k in jmodel.schedule]
    jflat = jax.tree_util.tree_flatten_with_path(_np(jparams))[0]
    flat = jax.tree_util.tree_flatten_with_path(interop.params_to_numpy(params))[0]
    assert [(p, a.shape) for p, a in flat] == [(p, a.shape) for p, a in jflat]
    # num_params counts neither the final norm nor the latent norms' scales
    m = model.cfg.mla
    assert model.cfg.num_params() == jmodel.cfg.num_params()
    assert sum(int(np.prod(a.shape)) for _, a in flat) == \
        model.cfg.num_params() + model.cfg.d_model + model.cfg.num_layers * m.kv_lora_rank
    fresh = model.init(0, device="cpu")
    assert jax.tree.map(lambda a: a.shape, interop.params_to_numpy(fresh)) == \
        jax.tree.map(lambda a: a.shape, interop.params_to_numpy(params))


def _record_router(monkeypatch) -> list:
    """Every router probability table ``moe_ffn`` computes, for the tie check."""
    seen = []

    def recording(p, x, cfg):
        probs = router_probs(p, x, cfg)
        seen.append(probs.detach())
        return probs

    router_probs = moe.router_probs
    monkeypatch.setattr(moe, "router_probs", recording)
    return seen


def test_features_loss_and_grad_match_reference(model_case, monkeypatch):
    jmodel, jparams, model, params = model_case
    seen = _record_router(monkeypatch)
    nb = make_model_batch(jmodel.cfg, 2, 16, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    _close(model.features(params, batch), jmodel.features(jparams, nb))
    _assert_no_topk_ties(seen[0], model.cfg.moe.top_k)
    (jloss, jinfo), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, nb)
    (loss, info), grads = value_and_grad(model.loss, has_aux=True)(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(info["moe_aux"]), float(jinfo["moe_aux"]), rtol=1e-5)
    assert float(info["moe_aux"]) > 0
    _close(grads, jgrads, rtol=1e-4, atol=1e-6)
    assert float(grads["blocks"]["b0"]["moe"]["router"].abs().max()) > 0


def test_decode_matches_full_forward():
    """Token-by-token decode against the cache == the full forward, no
    drops (capacity 64), the reference's ``test_decode_consistency``."""
    _, cfg = _cfgs(64.0)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(make_model_batch(cfg, 2, 32)["tokens"])
    with torch.no_grad():
        full, _ = model.logits(params, {"tokens": toks})
        cache = model.init_cache(2, 32, device="cpu")
        assert cache["prefix"][0]["c_kv"].shape == (2, 32, cfg.mla.kv_lora_rank)
        assert cache["blocks"]["b0"]["k_rope"].shape == (1, 2, 32, cfg.mla.rope_head_dim)
        dec = torch.stack([model.decode_step(params, toks[:, t:t + 1], cache, t)[0]
                           for t in range(32)], dim=1)
    assert float((dec - full).abs().max()) < 5e-4
    with pytest.raises(ValueError, match="all-GQA"):
        model.init_paged_cache(16, 8, device="cpu")


def test_generate_static_matches_jax_oracle(model_case, monkeypatch):
    jmodel, jparams, model, params = model_case
    seen = _record_router(monkeypatch)
    prompts = make_model_batch(model.cfg, 2, 10, seed=5)["tokens"]
    got = generate_static(model, params, prompts, 12).numpy()
    for probs in seen:
        _assert_no_topk_ties(probs, model.cfg.moe.top_k)
    want = np.asarray(jax_generate_static(jmodel, jparams, prompts, 12))
    np.testing.assert_array_equal(got, want)


def test_serve_cli_static_runs_and_continuous_refuses_mla(monkeypatch, capsys):
    """The serve CLI serves deepseek's ``reduced()`` through the static path;
    its continuous (paged) path raises the reference's ``ValueError``."""
    import sys

    from repro_torch.launch import serve as serve_cli
    argv = ["serve", "--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--decode-steps", "4"]
    monkeypatch.setattr(sys, "argv", argv)
    serve_cli.main()
    assert capsys.readouterr().out.startswith("static: 8 tokens")
    monkeypatch.setattr(sys, "argv", argv + ["--continuous"])
    with pytest.raises(ValueError, match="all-GQA"):
        serve_cli.main()


# -------------------------------------------------------------------- (d)
TASK = dict(num_clients=4, docs_per_client=2, seq=8, server_batches_n=2, server_batch=2)


ROUND = dict(num_clients=4, participation=1.0, local_epochs=1, client_lr=0.02, client_batch=2,
             distill_steps=3, server_lr=0.02, K=2, R=1, kd_kernel="flash", kd_head_fusion=True)


@pytest.fixture(scope="module")
def jax_rounds():
    """The JAX runner's two sequential rounds (its engines agree within the
    reference's tolerance), shared by both of the port's engines."""
    jtask = jax_lm_task(jax_get_config(ARCH).reduced(), **TASK)
    jrunner = jax_make_runner("fedsdd", jtask, **ROUND)
    keys = jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), jrunner.cfg.K)
    init = [_np(jtask.init_fn(k)) for k in keys]
    return init, jrunner.run(rounds=2)


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_two_lm_rounds_match_jax_runner(jax_rounds, execution):
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
