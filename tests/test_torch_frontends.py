"""Port vs reference: the audio and VLM frontends, hubert-xlarge (a
bidirectional encoder over precomputed frame embeddings, masked-frame
prediction over a 504-code vocabulary) and llava-next-mistral-7b (a GQA
decoder whose first positions are projected patch embeddings), at their
``reduced()`` sizes with the reference's weights carried across.

  (a) ``make_model_batch``: the audio and VLM batches byte for byte.
  (b) hubert: the tree (``frontend``: ``proj1``, ``proj2``, ``mask_embed``);
      logits with ``mask_embed`` swapped in at the masked frames; the
      masked-frame cross-entropy; gradients against ``jax.grad`` through
      ``value_and_grad`` and through the vectorized engine's
      ``vmap(grad_and_value)``, ``embed``'s a zero in both (the audio loss
      never reaches it, and ``jax.grad`` gives zeros); attention that sees
      later frames; no decode (``supports_decode`` False, the serve CLI
      refuses).
  (c) llava: the splice of the projected patch embeddings over the first
      positions; the default loss mask (positions from
      ``num_prefix_embeds`` on) and the reference's quirk it pins: a batch
      of S <= ``num_prefix_embeds`` positions scores nothing, loss 0 in
      both packages (``make_model_batch`` splices ``min(P, S // 2)``
      embeddings, the loss masks every position below P); ``prefill``
      with embeddings against JAX's; token-only decode against the forward.
  (d) two LM FedSDD rounds of each (head-fused Flash-KD) on both engines
      against the JAX runner.

Tolerances: f32 both sides, summed in other orders: logits and the loss
rtol 1e-5 (atol 1e-5); gradients rtol 1e-4 / atol 1e-6; decode against
the forward within 5e-4 of the logits' scale; rounds within 2e-4, the
reference's own.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import lm_task as jax_lm_task  # noqa: E402
from repro.data import synthetic as jax_synth  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import lm_task  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models.layers import cross_entropy  # noqa: E402
from repro_torch.optim.optimizers import value_and_grad  # noqa: E402

HUBERT, LLAVA = "hubert-xlarge", "llava-next-mistral-7b"
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


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _case(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel, model = jzoo.build_model(jcfg), zoo.build_model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, jparams, model, interop.params_from_numpy(_np(jparams), device="cpu")


@pytest.fixture(scope="module")
def hubert():
    return _case(HUBERT)


@pytest.fixture(scope="module")
def llava():
    return _case(LLAVA)


# -------------------------------------------------------------------- (a)
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("arch", [HUBERT, LLAVA])
def test_batches_are_byte_identical(arch, seed):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    for seq in (16, 32):
        got = synthetic.make_model_batch(cfg, 3, seq, seed=seed)
        want = jax_synth.make_model_batch(jcfg, 3, seq, seed=seed)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes()
    if arch == HUBERT:
        assert got["mask"].dtype == np.bool_ and got["mask"][:, 0].all()
        assert got["embeds"].shape == (3, 32, cfg.frontend_dim)
    else:
        assert got["embeds"].shape == (3, min(cfg.num_prefix_embeds, 16), cfg.frontend_dim)


# -------------------------------------------------------------------- (b)
def test_hubert_tree_matches_reference(hubert):
    jmodel, jparams, model, params = hubert
    assert model.cfg.is_encoder and not model.cfg.causal
    jflat = jax.tree_util.tree_flatten_with_path(_np(jparams))[0]
    flat = jax.tree_util.tree_flatten_with_path(
        interop.params_to_numpy(model.init(0, device="cpu")))[0]
    assert [(p, a.shape, a.dtype) for p, a in flat] == [(p, a.shape, a.dtype) for p, a in jflat]
    fe = params["frontend"]
    D = model.cfg.d_model
    assert fe["proj1"].shape == (model.cfg.frontend_dim, D) and fe["proj2"].shape == (D, D)
    assert fe["mask_embed"].shape == (D,)


def test_hubert_logits_with_mask_embed(hubert):
    jmodel, jparams, model, params = hubert
    nb = synthetic.make_model_batch(model.cfg, B, S, seed=3)
    jl, _ = jax.jit(jmodel.logits)(jparams, nb)
    pl, _ = model.logits(params, _torch(nb))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    # a masked frame's input is mask_embed, whatever its embedding
    x = model._embed_in(params, _torch(nb)).detach()
    m = torch.from_numpy(nb["mask"])
    assert bool((x[m] == params["frontend"]["mask_embed"]).all())
    assert not bool((x[~m] == params["frontend"]["mask_embed"]).all(-1).any())


def test_hubert_masked_cross_entropy(hubert):
    jmodel, jparams, model, params = hubert
    nb = synthetic.make_model_batch(model.cfg, B, S, seed=4)
    jloss, _ = jax.jit(jmodel.loss)(jparams, nb)
    with torch.no_grad():
        loss, info = model.loss(params, _torch(nb))
        logits, _ = model.logits(params, _torch(nb))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    m = nb["mask"]
    want = cross_entropy(logits[torch.from_numpy(m)],
                         torch.from_numpy(nb["labels"][m]))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert float(info["ce"]) == float(loss)


@pytest.mark.parametrize("engine", ["sequential", "vectorized"])
def test_hubert_grads_with_zero_embed(hubert, engine):
    """``embed`` is a parameter the audio loss never reaches: a zero
    gradient, as ``jax.grad`` gives, through the sequential engine's
    ``value_and_grad`` and the vectorized engine's ``vmap(grad_and_value)``
    (two clients, one stack)."""
    jmodel, jparams, model, params = hubert
    nb = synthetic.make_model_batch(model.cfg, B, S, seed=5)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, nb)
    if engine == "sequential":
        (loss, _), grads = value_and_grad(model.loss, has_aux=True)(params, _torch(nb))
    else:
        stack = jax.tree.map(lambda v: torch.stack([v, v]), params)
        batch = {k: torch.stack([v, v]) for k, v in _torch(nb).items()}
        gfn = torch.func.vmap(torch.func.grad_and_value(model.loss, has_aux=True))
        stacked, (losses, _) = gfn(stack, batch)
        assert bool((losses[0] == losses[1]).all())
        grads = jax.tree.map(lambda v: v[0], stacked)
        loss = losses[0]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert grads["embed"].shape == params["embed"].shape
    assert not bool(grads["embed"].any()) and not np.asarray(jgrads["embed"]).any()
    _close(grads, jgrads, rtol=1e-4, atol=1e-6)
    assert float(grads["frontend"]["proj1"].abs().max()) > 0
    assert float(grads["frontend"]["mask_embed"].abs().max()) > 0


def test_hubert_attention_sees_later_frames(hubert):
    """``causal=False``: changing the last frame moves the first frame's
    logits, in both packages alike."""
    jmodel, jparams, model, params = hubert
    nb = synthetic.make_model_batch(model.cfg, B, S, seed=6)
    nb["mask"][:] = False
    moved = {**nb, "embeds": nb["embeds"].copy()}
    moved["embeds"][:, -1] += 1.0
    jlog = jax.jit(jmodel.logits)
    with torch.no_grad():
        a, _ = model.logits(params, _torch(nb))
        b, _ = model.logits(params, _torch(moved))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4
    np.testing.assert_allclose(b.numpy(), np.asarray(jlog(jparams, moved)[0]),
                               rtol=1e-5, atol=1e-5)


def test_hubert_has_no_decode(hubert, monkeypatch):
    cfg = hubert[2].cfg
    assert cfg.supports_decode is False and jax_get_config(HUBERT).supports_decode is False
    from repro_torch.launch import serve as serve_cli
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", HUBERT, "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_cli.main()


# -------------------------------------------------------------------- (c)
def test_llava_splices_patch_embeddings(llava):
    jmodel, jparams, model, params = llava
    nb = synthetic.make_model_batch(model.cfg, B, S, seed=3)
    P = nb["embeds"].shape[1]
    assert P == min(model.cfg.num_prefix_embeds, S // 2) == 16
    with torch.no_grad():
        x = model._embed_in(params, _torch(nb))
        fe = params["frontend"]
        pe = torch.nn.functional.gelu(torch.from_numpy(nb["embeds"]) @ fe["proj1"],
                                      approximate="tanh") @ fe["proj2"]
        tok = params["embed"][torch.from_numpy(nb["tokens"]).long()]
    assert x.shape == (B, S, model.cfg.d_model)
    np.testing.assert_allclose(x[:, :P].numpy(), pe.numpy(), rtol=1e-6, atol=1e-6)
    assert bool((x[:, P:] == tok[:, P:]).all())
    jl, _ = jax.jit(jmodel.logits)(jparams, nb)
    pl, _ = model.logits(params, _torch(nb))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_llava_default_loss_mask_and_grads(llava):
    jmodel, jparams, model, params = llava
    nb = synthetic.make_model_batch(model.cfg, B, S, seed=4)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, nb)
    (loss, _), grads = value_and_grad(model.loss, has_aux=True)(params, _torch(nb))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    P = model.cfg.num_prefix_embeds
    with torch.no_grad():
        logits, _ = model.logits(params, _torch(nb))
    want = cross_entropy(logits[:, P:], torch.from_numpy(nb["labels"][:, P:]))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    _close(grads, jgrads, rtol=1e-4, atol=1e-6)
    assert float(grads["frontend"]["proj1"].abs().max()) > 0
    assert float(grads["embed"].abs().max()) > 0


def test_llava_scores_nothing_up_to_the_prefix_budget(llava):
    """The reference's quirk: at S <= num_prefix_embeds every position is
    masked out, so the loss is 0 / 1 = 0 in both packages and no weight
    gets a gradient."""
    jmodel, jparams, model, params = llava
    P = model.cfg.num_prefix_embeds
    nb = synthetic.make_model_batch(model.cfg, B, P, seed=5)
    assert nb["embeds"].shape[1] == P // 2
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, nb)
    (loss, _), grads = value_and_grad(model.loss, has_aux=True)(params, _torch(nb))
    assert float(loss) == float(jloss) == 0.0
    assert not any(bool(g.any()) for g in jax.tree.leaves(grads))
    assert not any(np.asarray(g).any() for g in jax.tree.leaves(jgrads))


def test_llava_prefill_with_embeddings_matches_reference(llava):
    jmodel, jparams, model, params = llava
    nb = synthetic.make_model_batch(model.cfg, B, S, seed=6)
    nb.pop("labels")
    last = np.asarray([S - 1, 20], np.int32)
    jl, jc = jax.jit(jmodel.prefill)(jparams, nb, last=jnp.asarray(last))
    with torch.no_grad():
        pl, pc = model.prefill(params, _torch(nb), last=torch.from_numpy(last))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    _close(pc, jc)


def test_llava_token_decode_matches_forward(llava):
    """The engines take tokens only, as the reference's: token-by-token
    decode from ``init_cache`` == the full token forward."""
    _, _, model, params = llava
    toks = torch.from_numpy(synthetic.make_model_batch(model.cfg, B, S)["tokens"])
    with torch.no_grad():
        full, _ = model.logits(params, {"tokens": toks})
        cache = model.init_cache(B, S, device="cpu")
        dec = torch.stack([model.decode_step(params, toks[:, t:t + 1], cache, t)[0]
                           for t in range(S)], dim=1)
    assert float((dec - full).abs().max()) < 5e-4 * max(1.0, float(full.abs().max()))


# -------------------------------------------------------------------- (d)
TASK = dict(num_clients=4, docs_per_client=2, seq=32, server_batches_n=2, server_batch=2)
ROUND = dict(num_clients=4, participation=1.0, local_epochs=1, client_lr=0.02, client_batch=2,
             distill_steps=3, server_lr=0.02, K=2, R=1, kd_kernel="flash", kd_head_fusion=True)


@pytest.fixture(scope="module", params=[HUBERT, LLAVA])
def jax_rounds(request):
    """The JAX runner's two sequential rounds, shared by both of the port's
    engines (the reference's engines agree within its tolerance)."""
    jtask = jax_lm_task(jax_get_config(request.param).reduced(), **TASK)
    jrunner = jax_make_runner("fedsdd", jtask, **ROUND)
    keys = jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), jrunner.cfg.K)
    init = [_np(jtask.init_fn(k)) for k in keys]
    return request.param, init, jrunner.run(rounds=2)


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_two_lm_rounds_match_jax_runner(jax_rounds, execution):
    arch, init, jstate = jax_rounds
    task = lm_task(get_config(arch).reduced(), **TASK, device="cpu")
    runner = make_runner("fedsdd", task, device="cpu", execution=execution, **ROUND)
    state = runner.run(2, state=FedState(
        round=0, global_models=[interop.params_from_numpy(m, device="cpu") for m in init],
        ensemble=TeacherBank(2, 1)))
    for m, jm in zip(state.global_models, jstate.global_models):
        _close(m, jm, rtol=2e-4, atol=2e-4)
    for rec, jrec in zip(state.history, jstate.history):
        for k in ("kd_loss_first", "kd_loss_last"):
            np.testing.assert_allclose(rec[k], jrec[k], rtol=2e-4, atol=2e-4)
    if arch == HUBERT:      # never reached: a zero gradient leaves it where it began
        for m, m0 in zip(state.global_models, init):
            assert bool((m["embed"] == torch.from_numpy(m0["embed"])).all())
