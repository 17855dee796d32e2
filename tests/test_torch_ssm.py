"""Port vs reference: the recurrent mixers of ``models/ssm.py`` (Mamba,
mLSTM, sLSTM) at the reference's ``_ssm_cfg`` (``tests/test_attention_ssm.py``:
d_model 64, 4 heads, d_state 8, chunk 8), f32.

Weights are the reference's ``init_*`` output carried across with
``interop.params_from_numpy``; inputs are numpy draws from a seed.

  * forward output, final state and one decode step from that state
    against the JAX functions at rtol 1e-5 / atol 1e-5;
  * the gradients of a scalar of the output and the final state, to every
    parameter and the input, against ``jax.grad`` within 1e-4 of each
    leaf's largest;
  * the port's forward equal to its own step-by-step decode from a zero
    state (atol 5e-4 / rtol 1e-3, the reference's), Mamba's output
    independent of the chunk size (8 against 32) and mLSTM's state carried
    across two calls;
  * ``F.softplus`` / ``F.logsigmoid`` against ``jax.nn``'s to f32 rounding
    (2 ulps), across torch's softplus threshold of 20;
  * Mamba under a bf16 config: the decode's conv runs in the promotion of
    the state's dtype and the token's (f32 from a zero state, bf16 from a
    prefill), as JAX's does;
  * each mixer under ``torch.func.vmap`` over stacked weights equals a
    loop (the vectorized engine's use); the sLSTM time step's operator
    count, and no operator that reads a tensor back to the host in any
    mixer's forward and backward (a captured step would fail on one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

MIXERS = ["mamba", "mlstm", "slstm"]
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small CPU runs (the sLSTM loop is many tiny ops) are faster on
    one thread, and much faster where several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(variant, chunk=8, dtype="float32"):
    kw = dict(name="t", family="ssm", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
              d_ff=0, vocab_size=64, param_dtype=dtype, compute_dtype=dtype)
    ssm_kw = dict(variant=variant, d_state=8, chunk_size=chunk, xlstm_slstm_ratio=2)
    return (JModelConfig(**kw, ssm=JSSMConfig(**ssm_kw)),
            ModelConfig(**kw, ssm=SSMConfig(**ssm_kw)))


def _fns(mod, name):
    return tuple(getattr(mod, f"{name}_{part}") for part in ("forward", "decode",
                                                             "state_shape"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, rtol=1e-5, atol=1e-5):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=rtol, atol=atol),
                 interop.params_to_numpy(port), _np(ref))


@pytest.fixture(scope="module", params=MIXERS)
def case(request):
    name = request.param
    jcfg, cfg = _cfgs("xlstm" if name != "mamba" else "mamba")
    p = _np(getattr(jssm, f"init_{name}")(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(B, S + 1, 64)) * 0.5).astype(np.float32)
    return name, jcfg, cfg, p, x


def test_init_tree_matches_reference(case):
    name, jcfg, cfg, p, _ = case
    mine = interop.params_to_numpy(getattr(ssm, f"init_{name}")(
        torch.Generator().manual_seed(0), cfg))
    assert jax.tree.map(lambda a: (a.shape, a.dtype), mine) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), p)


def test_forward_state_and_decode_match_reference(case):
    name, jcfg, cfg, p, x = case
    jfwd, jdec, _ = _fns(jssm, name)
    fwd, dec, _ = _fns(ssm, name)
    jout, jstate = jax.jit(lambda p_, x_: jfwd(p_, x_, jcfg))(p, jnp.asarray(x[:, :S]))
    jo1, jst1 = jax.jit(lambda p_, x_, s_: jdec(p_, x_, s_, jcfg))(
        p, jnp.asarray(x[:, S:]), jstate)
    pt = interop.params_from_numpy(p, device="cpu")
    out, state = fwd(pt, torch.from_numpy(x[:, :S]), cfg)
    o1, st1 = dec(pt, torch.from_numpy(x[:, S:]), state, cfg)
    _close(out, jout)
    _close(state, jstate)
    _close(o1, jo1)
    _close(st1, jst1)
    assert all(v.dtype == torch.float32 for k, v in state.items() if k != "conv")


def test_gradients_match_reference(case):
    name, jcfg, cfg, p, x = case
    jfwd, _, _ = _fns(jssm, name)
    fwd, _, _ = _fns(ssm, name)
    rng = np.random.default_rng(2)
    r = rng.normal(size=(B, S, 64)).astype(np.float32)
    jstate_shapes = jax.eval_shape(lambda p_, x_: jfwd(p_, x_, jcfg)[1], p,
                                   jnp.asarray(x[:, :S]))
    rs = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in jstate_shapes.items()}

    def jloss(p_, x_):
        out, st = jfwd(p_, x_, jcfg)
        return jnp.mean(out * r) + sum(jnp.mean(st[k] * rs[k]) for k in sorted(rs))

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x[:, :S]))
    pt = interop.params_from_numpy(p, device="cpu")
    leaves = {k: v.requires_grad_(True) for k, v in pt.items()}
    xt = torch.from_numpy(x[:, :S]).requires_grad_(True)
    out, st = fwd(leaves, xt, cfg)
    loss = (out * torch.from_numpy(r)).mean() + sum(
        (st[k] * torch.from_numpy(rs[k])).mean() for k in sorted(rs))
    loss.backward()
    got = {k: v.grad for k, v in leaves.items()}
    for k in got:
        want = np.asarray(jgp[k])
        np.testing.assert_allclose(got[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    want = np.asarray(jgx)
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert all(float(np.abs(np.asarray(v)).max()) > 0 for v in jax.tree.leaves(jgp))


def test_forward_matches_own_stepwise_decode(case):
    """The reference's ``test_ssm_forward_matches_stepwise`` on the port."""
    name, _, cfg, p, x = case
    fwd, dec, shape = _fns(ssm, name)
    pt = interop.params_from_numpy(p, device="cpu")
    xt = torch.from_numpy(x[:, :S])
    full, _ = fwd(pt, xt, cfg)
    state = {k: torch.zeros(s) for k, s in shape(cfg, B).items()}
    outs = []
    for t in range(S):
        o, state = dec(pt, xt[:, t:t + 1], state, cfg)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=5e-4, rtol=1e-3)


def test_mamba_chunk_size_invariance():
    _, cfg8 = _cfgs("mamba", chunk=8)
    _, cfg32 = _cfgs("mamba", chunk=32)
    pt = ssm.init_mamba(torch.Generator().manual_seed(0), cfg8)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 32, 64)).astype(np.float32))
    o1, s1 = ssm.mamba_forward(pt, x, cfg8)
    o2, s2 = ssm.mamba_forward(pt, x, cfg32)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(s1["h"].numpy(), s2["h"].numpy(), atol=2e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssm.mamba_forward(pt, x[:, :12], cfg8)


def test_mlstm_state_carry_across_calls():
    _, cfg = _cfgs("xlstm")
    pt = ssm.init_mlstm(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy((np.random.default_rng(4).normal(size=(1, 16, 64)) * 0.5)
                         .astype(np.float32))
    full, _ = ssm.mlstm_forward(pt, x, cfg)
    h1, st = ssm.mlstm_forward(pt, x[:, :8], cfg)
    h2, _ = ssm.mlstm_forward(pt, x[:, 8:], cfg, state=st)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(), full.numpy(), atol=5e-4,
                               rtol=1e-3)


def test_softplus_and_log_sigmoid_match_jax():
    """Across torch's softplus threshold (20), where it returns x and JAX
    x + log1p(exp(-x)): equal to f32 rounding (2 ulps; below the smallest
    normal f32, where JAX flushes to 0 and torch keeps a denormal, 2^-126)."""
    x = np.concatenate([np.linspace(-120, 120, 20001), [19.999, 20.0, 20.001, 88.0, -88.0]])
    x = x.astype(np.float32)
    xt = torch.from_numpy(x)
    for mine, ref in ((torch.nn.functional.softplus(xt), jax.nn.softplus(x)),
                      (torch.nn.functional.logsigmoid(xt), jax.nn.log_sigmoid(x))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=2.0 ** -22, atol=2.0 ** -126)


def test_mamba_decode_dtype_promotion_bf16():
    """bf16 config: JAX's decode promotes the conv to f32 from an f32 state
    (``init_cache``) and stays bf16 from a bf16 prefill conv; the port's
    outputs and states keep the same dtypes and agree within bf16
    rounding (2^-7 of the output's scale)."""
    jcfg, cfg = _cfgs("mamba", dtype="bfloat16")
    p = _np(jssm.init_mamba(jax.random.PRNGKey(0), jcfg))
    pt = interop.params_from_numpy(p, device="cpu")
    x = (np.random.default_rng(5).normal(size=(B, 9, 64)) * 0.5).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    jout, jst = jssm.mamba_forward(p, xj[:, :8], jcfg)
    out, st = ssm.mamba_forward(pt, xt[:, :8], cfg)
    zero = {k: np.zeros(s, np.float32) for k, s in jssm.mamba_state_shape(jcfg, B).items()}
    for state_j, state_t in ((jst, st), (zero, {k: torch.from_numpy(v) for k, v in zero.items()})):
        jo, js = jssm.mamba_decode(p, xj[:, 8:], state_j, jcfg)
        o, s = ssm.mamba_decode(pt, xt[:, 8:], state_t, cfg)
        assert o.dtype == torch.bfloat16 and str(jo.dtype) == "bfloat16"
        assert {k: str(v.dtype).removeprefix("torch.") for k, v in s.items()} == \
            {k: str(v.dtype) for k, v in js.items()}
        scale = float(np.abs(np.asarray(jo, np.float32)).max())
        np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32), rtol=0,
                                   atol=2.0 ** -7 * scale)
    assert st["conv"].dtype == torch.bfloat16 and st["h"].dtype == torch.float32
    assert jout.dtype == jnp.bfloat16


@pytest.mark.parametrize("name", MIXERS)
def test_mixers_vmap_over_stacked_weights(name):
    """``torch.func.vmap`` over two clients' weights (the vectorized
    engine's use) equals a loop over them, forward and gradient."""
    _, cfg = _cfgs("xlstm" if name != "mamba" else "mamba")
    init, (fwd, _, _) = getattr(ssm, f"init_{name}"), _fns(ssm, name)
    ps = init(torch.Generator().manual_seed(0), cfg, stack=(2,))
    x = torch.from_numpy((np.random.default_rng(6).normal(size=(2, B, S, 64)) * 0.5)
                         .astype(np.float32))

    def loss(p, xb):
        out, st = fwd(p, xb, cfg)
        return out.square().mean() + sum(v.mean() for v in st.values())

    vg = torch.func.vmap(torch.func.grad_and_value(loss))(ps, x)
    for c in range(2):
        pc = {k: v[c] for k, v in ps.items()}
        g, val = torch.func.grad_and_value(loss)(pc, x[c])
        np.testing.assert_allclose(float(vg[1][c]), float(val), rtol=1e-5)
        for k in g:
            np.testing.assert_allclose(vg[0][k][c].numpy(), g[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


# operators that only re-describe a tensor's memory: no kernel runs
VIEWS = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze", "permute", "transpose",
         "t", "expand", "split", "slice", "select", "alias", "as_strided", "detach"}


class OpCount(TorchDispatchMode):
    """The operators that run, by name, views excluded."""

    def __init__(self):
        super().__init__()
        self.ops: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket.__name__)
        if name not in VIEWS:
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


# reads a tensor's value on the host: a captured step cannot hold one
HOST_READS = {"_local_scalar_dense", "item", "nonzero", "masked_select"}


@pytest.mark.parametrize("name", MIXERS)
def test_no_host_reads_and_slstm_step_ops(name):
    _, cfg = _cfgs("xlstm" if name != "mamba" else "mamba")
    fwd, _, _ = _fns(ssm, name)
    p = {k: v.requires_grad_(True) for k, v in
         getattr(ssm, f"init_{name}")(torch.Generator().manual_seed(0), cfg).items()}
    x = torch.randn(B, S, 64, generator=torch.Generator().manual_seed(1))
    counts = {}
    for steps in (8, 16):
        with OpCount() as mode:
            out, st = fwd(p, x[:, :steps], cfg)
            (out.sum() + sum(v.sum() for v in st.values())).backward()
        assert not HOST_READS & set(mode.ops), sorted(HOST_READS & set(mode.ops))
        with OpCount() as mode:
            fwd(p, x[:, :steps], cfg)
        counts[steps] = len(mode.ops)
    if name == "slstm":
        per_step = (counts[16] - counts[8]) / 8
        assert 15 <= per_step <= 22, per_step       # a kernel each in a graph
