"""Port vs reference: the sliding-window family, StarCoder2-3B ``reduced()``
(2 layers, d_model 256, 4 heads over 2 KV heads, window 64, LayerNorm,
GeLU MLP, QKV bias, f32), with the reference's weights carried across.

* Prefill logits at S = 1,024, past 4·window, where both packages take
  the block-local ``sliding_attention``: rtol = atol = 2e-4, the model
  zoo's logits tolerance (``test_torch_model.py``).
* ``ContinuousEngine`` (windowed paged decode) emits exactly the JAX
  ``ContinuousEngine``'s greedy tokens, at ``chunk_steps`` 3 and 8, with
  prompts and generations past the window, and a 512-token prompt whose
  prefill is block-local.  Never at ``chunk_steps=1``, where the
  reference's engine disagrees with its own oracle (ROADMAP §C).  Each of
  the JAX engine's decode dispatches is waited for (``_jax_engine``).
* ``generate_static`` emits exactly the JAX ``generate_static``'s tokens.
  The static oracle prefills a cache ``L + new`` long and decodes over all
  of it without the window (``gqa_decode`` never wraps it), so engine and
  static are compared only where ``L + new`` fits in the window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve import ContinuousEngine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import generate_static as jax_generate_static  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import make_model_batch  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import ContinuousEngine, Request, generate_static  # noqa: E402

ARCH = "starcoder2-3b"


@pytest.fixture(scope="module")
def served():
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    assert cfg.sliding_window == jcfg.sliding_window == 64
    model = build_model(cfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, model, params, jmodel, jparams


def test_prefill_logits_through_sliding_attention(served, monkeypatch):
    cfg, model, params, jmodel, jparams = served
    toks = make_model_batch(cfg, 2, 1024, seed=3)["tokens"]
    last = np.asarray([1023, 700], np.int32)
    calls = []
    real = attention.sliding_attention
    monkeypatch.setattr(attention, "sliding_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, last=jnp.asarray(last))
    pl, pc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           last=torch.from_numpy(last))
    assert len(calls) == cfg.num_layers                  # 1024 > 4·64: block-local
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(pc["blocks"]["b0"]["k"].numpy(),
                               np.asarray(jc["blocks"]["b0"]["k"]), rtol=2e-4, atol=2e-4)


def _requests(cls, cfg, lens, news, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, L).astype(np.int32),
                max_new_tokens=n) for i, (L, n) in enumerate(zip(lens, news))]


def _tokens(results):
    return {r.rid: list(map(int, r.tokens)) for r in results}


def _jax_engine(jmodel, jparams, **kw):
    """The JAX ``ContinuousEngine`` with each decode dispatch waited for.
    On the CPU, ``jnp.asarray`` of the engine's host block table often
    aliases the numpy buffer, and the engine zeroes a finishing lane's row
    right after dispatching the chunk that lane finishes in.  On a loaded
    machine the chunk can run after that write, so the lane's last steps
    read and write block 0 and the tokens change from run to run (ROADMAP
    §C).  Waiting for each dispatch gives the tokens of an idle machine."""
    eng = JaxEngine(jmodel, jparams, **kw)
    decode = eng._decode
    eng._decode = lambda *a: jax.block_until_ready(decode(*a))
    return eng


# prompts past the window, generations that cross it, and one 512-token
# prompt (a multiple of 512 past 4·window: block-local prefill)
LONG_LENS, LONG_NEWS = [80, 40, 130, 512, 9], [30, 45, 12, 20, 70]


@pytest.mark.parametrize("chunk_steps", [3, 8])
def test_engine_matches_reference_engine_past_the_window(served, chunk_steps):
    cfg, model, params, jmodel, jparams = served
    kw = dict(max_batch=3, num_blocks=120, block_size=8, max_seq_len=544,
              chunk_steps=chunk_steps)
    mine = ContinuousEngine(model, params, **kw).run(
        _requests(Request, cfg, LONG_LENS, LONG_NEWS, seed=1))
    ref = _jax_engine(jmodel, jparams, **kw).run(
        _requests(JaxRequest, cfg, LONG_LENS, LONG_NEWS, seed=1))
    got, want = _tokens(mine), _tokens(ref)
    assert got == want
    assert [len(got[i]) for i in range(len(LONG_NEWS))] == LONG_NEWS


def test_static_matches_reference_static_past_the_window(served):
    cfg, model, params, jmodel, jparams = served
    prompts = make_model_batch(cfg, 2, 50, seed=4)["tokens"]
    got = generate_static(model, params, prompts, 40).numpy()
    want = np.asarray(jax_generate_static(jmodel, jparams, prompts, 40))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_steps", [3, 8])
def test_engine_matches_static_within_the_window(served, chunk_steps):
    cfg, model, params, _, _ = served
    reqs = _requests(Request, cfg, [20, 20, 20], [40, 9, 44], seed=2)
    assert all(len(r.tokens) + r.max_new_tokens <= cfg.sliding_window for r in reqs)
    got = _tokens(ContinuousEngine(model, params, max_batch=2, num_blocks=40, block_size=8,
                                   max_seq_len=64, chunk_steps=chunk_steps).run(reqs))
    static = generate_static(model, params, np.stack([r.tokens for r in reqs]), 44).numpy()
    assert got == {r.rid: static[i, :r.max_new_tokens].tolist() for i, r in enumerate(reqs)}
