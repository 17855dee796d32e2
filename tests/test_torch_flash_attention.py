"""Port vs reference: ``flash_attention`` and ``flash_decode`` (kernels 12
and 11) on the CPU, where the port runs their plain versions.

The plain versions follow the Pallas kernels, so they are held against the
reference's ops run in Pallas interpret mode (``REPRO_FORCE_PALLAS=1``) in
f32 and bf16: f32 at atol 2e-5 (the reference sweep's own); bf16 within
one bf16 ulp of each row's max |out| plus 2e-5 (both sides compute in f32
and round the output once, so they differ where a sum lands on the other
side of a rounding boundary).  The reference's XLA fallback (the variable
unset) scales q and rounds the probabilities in q's dtype, which moves
bf16 results by several ulps, so it is held against in f32 only.  The
dense oracles (``ref.py``) of both packages, the gradient of
``(flash_attention(q, k, v) ** 2).sum()`` (atol 1e-4, as
``tests/test_kernels.py``) and the NEG_INF corner cases (rows with no
allowed key, ``cache_len <= 0``) complete the file.  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jax_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

ATOL = 2e-5
# the reference sweep (tests/test_kernels.py) plus StableLM-3B's dh 80
FWD_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 1, 32), (2, 256, 4, 4, 128),
              (1, 256, 4, 4, 80)]
MODES = [(True, 0), (True, 64), (False, 0)]
DECODE_CASES = [(2, 1024, 4, 2, 64, 700), (1, 512, 8, 1, 32, 512), (2, 512, 4, 4, 128, 1),
                (1, 1024, 4, 4, 80, 300)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture()
def force_pallas(monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")


def _inputs(seed, shapes, dtype):
    """numpy normals, then the same values in each framework's dtype
    (both round f32 to bf16 to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(port, want, dtype):
    got = port.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        return
    row_max = np.abs(want).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(row_max, 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp + ATOL).all(), np.abs(got - want).max()


def _fwd_shapes(B, S, H, Hkv, dh):
    return [(B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_matches_pallas_interpret(shape, causal, window, dtype, force_pallas):
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape) + window, _fwd_shapes(*shape), dtype)
    want = jax_ops.flash_attention(jq, jk, jv, causal, window)
    kernels.launches.clear()
    got = ops.flash_attention(q, k, v, causal, window)
    assert got.dtype == q.dtype and kernels.launches["flash_forward"] == 0
    _close(got, want, dtype)


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", FWD_SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_matches_xla_fallback_f32(shape, causal, window, monkeypatch):
    monkeypatch.delenv("REPRO_FORCE_PALLAS", raising=False)
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape) + 1, _fwd_shapes(*shape), "float32")
    _close(ops.flash_attention(q, k, v, causal, window),
           jax_ops.flash_attention(jq, jk, jv, causal, window), "float32")


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_matches_dense_oracle(shape, causal, window):
    B, S, H, Hkv, dh = shape
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape) + 2, _fwd_shapes(*shape), "float32")
    G = H // Hkv
    bh = lambda t: t.permute(0, 2, 1, 3)                       # noqa: E731
    want = ref.attention_ref(bh(q), bh(k).repeat_interleave(G, 1),
                             bh(v).repeat_interleave(G, 1), causal=causal, window=window)
    _close(ops.flash_attention(q, k, v, causal, window), bh(want).numpy(), "float32")
    jwant = jax_ref.attention_ref(
        jq.transpose(0, 2, 1, 3), jnp.repeat(jk.transpose(0, 2, 1, 3), G, axis=1),
        jnp.repeat(jv.transpose(0, 2, 1, 3), G, axis=1), causal=causal, window=window)
    _close(want, jwant, "float32")


@pytest.mark.parametrize("Sq,Skv,causal,window", [(384, 128, True, 64), (384, 128, False, 32),
                                                  (256, 100, True, 20)])
def test_flash_attention_rows_without_a_key(Sq, Skv, causal, window, force_pallas):
    """Sq > Skv + window leaves rows with no allowed key: the Pallas kernel
    averages V over the blocks it visits for them (p = 1 under NEG_INF)
    or returns zeros where it visits none; the port does the same."""
    (jq, jk, jv), (q, k, v) = _inputs(Sq + Skv, [(1, Sq, 2, 64), (1, Skv, 1, 64),
                                                 (1, Skv, 1, 64)], "float32")
    want = jax_ops.flash_attention(jq, jk, jv, causal, window)
    _close(ops.flash_attention(q, k, v, causal, window), want, "float32")


@pytest.mark.parametrize("shape,window", [((1, 128, 2, 2, 32), 0), ((2, 256, 4, 2, 16), 0),
                                          ((2, 256, 4, 2, 16), 64)])
def test_flash_attention_grads_match_reference(shape, window, force_pallas):
    """The reference's gradient test's shape, then GQA with and without a
    window."""
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape) + window, _fwd_shapes(*shape), "float32")
    jg = jax.grad(lambda a, b, c: (jax_ops.flash_attention(a, b, c, True, window) ** 2).sum(),
                  argnums=(0, 1, 2))(jq, jk, jv)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (ops.flash_attention(*qkv, True, window) ** 2).sum().backward()
    for t, g in zip(qkv, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4)


def _decode_shapes(B, S, H, Hkv, dh):
    return [(B, 1, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_decode_matches_pallas_interpret(case, dtype, force_pallas):
    *shape, clen = case
    (jq, jk, jv), (q, k, v) = _inputs(sum(case), _decode_shapes(*shape), dtype)
    want = jax_ops.flash_decode(jq, jk, jv, jnp.int32(clen))
    kernels.launches.clear()
    for cache_len in (clen, torch.tensor(clen, dtype=torch.int32)):
        got = ops.flash_decode(q, k, v, cache_len)
        assert got.dtype == q.dtype
        _close(got, want, dtype)
    assert kernels.launches["flash_decode"] == 0


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_decode_matches_xla_fallback_and_oracle_f32(case, monkeypatch):
    monkeypatch.delenv("REPRO_FORCE_PALLAS", raising=False)
    B, S, H, Hkv, dh, clen = case
    (jq, jk, jv), (q, k, v) = _inputs(sum(case) + 1, _decode_shapes(B, S, H, Hkv, dh), "float32")
    got = ops.flash_decode(q, k, v, clen)
    _close(got, jax_ops.flash_decode(jq, jk, jv, clen), "float32")
    G = H // Hkv
    bh = lambda t: t.permute(0, 2, 1, 3).repeat_interleave(G, 1)   # noqa: E731
    want = ref.decode_attention_ref(q.reshape(B, H, dh), bh(k), bh(v), clen)
    _close(got[:, 0], want.numpy(), "float32")
    jwant = jax_ref.decode_attention_ref(
        jq.reshape(B, H, dh), jnp.repeat(jk.transpose(0, 2, 1, 3), G, axis=1),
        jnp.repeat(jv.transpose(0, 2, 1, 3), G, axis=1), clen)
    _close(want, jwant, "float32")


@pytest.mark.parametrize("clen", [0, -3])
def test_flash_decode_without_a_valid_position(clen, force_pallas):
    """cache_len <= 0 masks every score to NEG_INF: the Pallas kernel and
    the port both return the mean of V over the whole cache."""
    (jq, jk, jv), (q, k, v) = _inputs(5, _decode_shapes(2, 1024, 4, 2, 64), "float32")
    want = jax_ops.flash_decode(jq, jk, jv, jnp.int32(clen))
    got = ops.flash_decode(q, k, v, clen)
    _close(got, want, "float32")
    mean = v.mean(1).repeat_interleave(2, 1)[:, None]
    torch.testing.assert_close(got, mean, rtol=0, atol=1e-6)


def test_ops_raise_where_the_pallas_wrappers_assert():
    z = torch.zeros((1, 200, 2, 64))
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_decode(torch.zeros((1, 1, 2, 64)), torch.zeros((1, 700, 2, 64)),
                         torch.zeros((1, 700, 2, 64)), 5)
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_decode(torch.zeros((1, 1, 2, 64)), torch.zeros((1, 512, 2, 64), device="meta"),
                         torch.zeros((1, 512, 2, 64)), 3)
    with pytest.raises(TypeError):                      # cache_len is an integer
        ops.flash_decode(torch.zeros((1, 1, 2, 64)), torch.zeros((1, 512, 2, 64)),
                         torch.zeros((1, 512, 2, 64)), 3.0)


def test_decode_splits_cover_the_valid_positions():
    for rows, live in [(64, 32768), (64, 4096), (64, 700), (1, 1), (1, 4096), (528, 2048)]:
        chunk, splits = ops.decode_splits(rows, live)
        assert chunk % 32 == 0 and splits >= 1
        assert (splits - 1) * chunk < live <= splits * chunk
