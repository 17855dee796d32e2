"""Port vs reference: the model zoo with the reference's weights carried
across (``jax.tree.map(np.asarray, model.init(PRNGKey(0)))`` →
``interop.params_from_numpy``), for three reduced dense archs: Qwen2.5
(GQA, QKV bias, SwiGLU), Gemma (MQA, tied embeddings, GeGLU) and StableLM
(LayerNorm).  f32; logits at 2e-4 as in ``test_serve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import make_model_batch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve import scatter_prefill as jax_scatter_prefill  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.paged_cache import build_table, scatter_prefill  # noqa: E402

ARCHS = ["qwen2.5-14b", "gemma-2b", "stablelm-3b"]
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jax_get_config(request.param).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_config(request.param).reduced())
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jmodel, jparams, model, params


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **tol)


def test_init_tree_matches_reference(pair):
    """Model.init on the device gives the reference's tree: same keys,
    shapes and dtypes (stacked ``blocks``), different random numbers."""
    _, jmodel, jparams, model, _ = pair
    mine = interop.params_to_numpy(model.init(0, device="cpu"))
    ref = jax.tree.map(np.asarray, jparams)
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_m] == [p for p, _ in flat_r]
    for (_, a), (_, b) in zip(flat_m, flat_r):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert model.n_super == jmodel.n_super == 2


def test_logits(pair):
    jcfg, jmodel, jparams, model, params = pair
    toks = make_model_batch(jcfg, 2, 12, seed=1)["tokens"]
    ref, _ = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    port, aux = model.logits(params, {"tokens": torch.from_numpy(toks)})
    _close(port, ref)
    assert float(aux) == 0.0


def test_prefill_last_and_decode_step(pair):
    """prefill(last=) over a right-padded batch, then two decode steps
    against the contiguous cache, each step vs the reference's."""
    jcfg, jmodel, jparams, model, params = pair
    toks = make_model_batch(jcfg, 2, 14, seed=2)["tokens"]
    padded = toks.copy()
    padded[:, 10:] = 0
    last = np.asarray([9, 7], np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(padded)}, last=jnp.asarray(last))
    pl, pc = model.prefill(params, {"tokens": torch.from_numpy(padded)}, last=torch.from_numpy(last))
    _close(pl, jl)
    _close(pc["blocks"]["b0"]["k"], jc["blocks"]["b0"]["k"])
    for pos in (10, 11):
        tok = toks[:, pos:pos + 1]
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc, pos)
        pl, pc = model.decode_step(params, torch.from_numpy(tok), pc, pos)
        _close(pl, jl)


def test_paged_decode_step(pair):
    """The prefill-scatter construction of test_serve.py: a shuffled pool
    plus one paged step == the reference's paged step == full forward."""
    jcfg, jmodel, jparams, model, params = pair
    B, L, bs = 2, 8, 4
    toks = make_model_batch(jcfg, B, L + 1, seed=3)["tokens"]
    full, _ = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})

    jpool = jmodel.init_paged_cache(num_blocks=2 * B * (L // bs) + 1, block_size=bs)
    pool = model.init_paged_cache(num_blocks=2 * B * (L // bs) + 1, block_size=bs,
                                  device="cpu")
    _, jctg = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :L])})
    _, ctg = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :L])})
    perm = np.random.default_rng(0).permutation(np.arange(1, 1 + B * (L // bs) + B))
    bt = np.zeros((B, (L + bs) // bs), np.int32)
    for b in range(B):
        ids = perm[b * 3:(b + 1) * 3].tolist()
        jpool = jax_scatter_prefill(
            jpool, jax.tree.map(lambda x: x[:, b:b + 1] if x.ndim == 5 else x[b:b + 1], jctg),
            ids[:L // bs])
        scatter_prefill(pool, {"prefix": [], "blocks": {"b0": {
            k: v[:, b:b + 1] for k, v in ctg["blocks"]["b0"].items()}}}, ids[:L // bs])
        bt[b] = build_table(ids, (L + bs) // bs)
    sl = np.asarray([L, L], np.int32)
    jl, _ = jmodel.paged_decode_step(jparams, jnp.asarray(toks[:, L:]), jpool,
                                     jnp.asarray(bt), jnp.asarray(sl))
    pl, _ = model.paged_decode_step(params, torch.from_numpy(toks[:, L:]), pool,
                                    torch.from_numpy(bt), torch.from_numpy(sl))
    _close(pl, jl)
    _close(pl, full[:, L])


@pytest.mark.parametrize("cast", ["float32", "bfloat16"])
def test_interop_round_trip_is_bit_exact(cast):
    jmodel = jax_build_model(jax_get_config("qwen2.5-14b").reduced())
    ref = jax.tree.map(lambda x: np.asarray(x.astype(cast)),
                       jmodel.init(jax.random.PRNGKey(1)))
    tensors = interop.params_from_numpy(ref, device="cpu")
    assert tensors["embed"].dtype == getattr(torch, cast)
    back = interop.params_to_numpy(tensors)
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_r]
    for (_, a), (_, b) in zip(flat_b, flat_r):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_interop_takes_numpy_only():
    with pytest.raises(TypeError, match="numpy"):
        interop.params_from_numpy({"w": [1.0, 2.0]}, device="cpu")


def test_unported_families_raise():
    """No family is left unported: the reduced xlstm-1.3b and the audio and
    VLM frontends build and run a forward, and the port registers the
    reference's architectures, no more and no fewer."""
    cfg = get_config("xlstm-1.3b").reduced()
    model = build_model(cfg)
    assert [k.mixer for k in model.schedule] == ["mlstm"] * 3 + ["slstm"]
    toks = torch.from_numpy(make_model_batch(cfg, 2, 16, seed=1)["tokens"])
    logits, _ = model.logits(model.init(0, device="cpu"), {"tokens": toks})
    assert logits.shape == (2, 16, cfg.vocab_size) and bool(logits.isfinite().all())
    for arch in ("hubert-xlarge", "llava-next-mistral-7b"):
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        batch = {k: torch.from_numpy(v) for k, v in make_model_batch(cfg, 2, 16, seed=1).items()}
        logits, _ = model.logits(model.init(0, device="cpu"), batch)
        assert logits.shape == (2, 16, cfg.vocab_size) and bool(logits.isfinite().all())
    from repro.configs import list_configs as jax_list_configs
    from repro_torch.configs import list_configs
    assert list_configs() == jax_list_configs()
