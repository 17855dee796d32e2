"""Port vs reference: attention, decode attention and paged decode.

The plain ``paged_decode`` is held against the reference's Pallas kernel
run in interpret mode (``REPRO_FORCE_PALLAS=1``), which returns zeros for a
``seq_len == 0`` row; the reference's gather fallback would return a
uniform average there.  f32, rtol = atol = 1e-5 as in ``test_serve.py``.
The CUDA kernel itself is compared with the plain version on the card by
``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), **TOL)


def _qkv(rng, B, Sq, Skv, H, Hkv, dh):
    return (rng.normal(0, 1, (B, Sq, H, dh)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Hkv, dh)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("kv_block", [1024, 16])       # single / multi-block
@pytest.mark.parametrize("window", [0, 11])
@pytest.mark.parametrize("causal", [True, False])
def test_attention(kv_block, window, causal):
    q, k, v = _qkv(np.random.default_rng(0), 2, 40, 40, 6, 2, 16)
    kw = dict(causal=causal, window=window, kv_block=kv_block)
    ref = jax_attn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    port = attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    _close(port, ref)


@pytest.mark.parametrize("kv_block", [1024, 16])
@pytest.mark.parametrize("q_offset,kv_valid_start", [(24, 0), (24, 7), (0, 5)])
def test_attention_offset_and_front_padding(q_offset, kv_valid_start, kv_block):
    """A query block placed ``q_offset`` keys in, with front padding masked
    below ``kv_valid_start``: the form ``sliding_attention`` calls."""
    q, k, v = _qkv(np.random.default_rng(3), 2, 16, 40, 6, 2, 16)
    kw = dict(causal=True, window=11, q_offset=q_offset, kv_block=kv_block,
              kv_valid_start=kv_valid_start)
    ref = jax_attn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    port = attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    _close(port, ref)


@pytest.mark.parametrize("S,W,q_block", [(2048, 128, 256), (1024, 64, 512), (96, 40, 32)])
def test_sliding_attention(S, W, q_block):
    """The block-local path against the reference's, as
    ``test_attention_ssm.py::test_sliding_attention_blockwise_matches_masked``
    (S 2,048, W 128, q_block 256), and against the port's own masked
    ``attention``; the last case has span W + q_block < S only from the
    third block on."""
    q, k, v = _qkv(np.random.default_rng(4), 1, S, S, 2, 2, 32)
    ref = jax_attn.sliding_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     window=W, q_block=q_block)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    port = attention.sliding_attention(tq, tk, tv, window=W, q_block=q_block)
    _close(port, ref)
    masked = attention.attention(tq, tk, tv, causal=True, window=W, kv_block=S)
    torch.testing.assert_close(port, masked, rtol=0, atol=2e-5)


def test_sliding_attention_raises_where_the_reference_asserts():
    z = torch.zeros((1, 1000, 2, 16))
    with pytest.raises(ValueError, match="divisible"):
        attention.sliding_attention(z, z, z, window=64, q_block=512)


@pytest.mark.parametrize("window", [0, 9])
def test_decode_attention_ragged(window):
    q, k, v = _qkv(np.random.default_rng(1), 3, 1, 32, 8, 2, 16)
    lens = np.asarray([32, 17, 5], np.int32)
    ref = jax_attn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lens), window=window)
    port = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(lens),
                                      window=window)
    _close(port, ref)


def test_decode_attention_scalar_len():
    q, k, v = _qkv(np.random.default_rng(2), 2, 1, 24, 4, 4, 16)
    ref = jax_attn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 13)
    port = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), 13)
    _close(port, ref)


def _paged_case(seed=0, B=4, S=48, Hkv=2, G=3, dh=16, bs=8):
    """The shuffled-pool construction of test_serve.py, with a trailing
    ``seq_len == 0`` row: lens [S, 17, 8, 0]."""
    rng = np.random.default_rng(seed)
    nbmax = S // bs
    q = rng.normal(0, 1, (B, 1, Hkv * G, dh)).astype(np.float32)
    kc = rng.normal(0, 1, (B, S, Hkv, dh)).astype(np.float32)
    vc = rng.normal(0, 1, (B, S, Hkv, dh)).astype(np.float32)
    lens = np.asarray([S, 17, 8, 0][:B], np.int32)
    perm = rng.permutation(np.arange(1, 1 + B * nbmax)).reshape(B, nbmax).astype(np.int32)
    pool_k = np.zeros((1 + B * nbmax, bs, Hkv, dh), np.float32)
    pool_v = np.zeros_like(pool_k)
    for b in range(B):
        for j in range(nbmax):
            pool_k[perm[b, j]] = kc[b, j * bs:(j + 1) * bs]
            pool_v[perm[b, j]] = vc[b, j * bs:(j + 1) * bs]
    return q, pool_k, pool_v, perm, lens


@pytest.mark.parametrize("window", [0, 12])
def test_paged_decode_matches_pallas_interpret(window, monkeypatch):
    args = _paged_case()
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    ref = jax_ops.paged_decode(*map(jnp.asarray, args), window=window)
    assert not np.asarray(ref)[3].any()            # Pallas: zeros for len 0
    kernels.launches.clear()
    port = ops.paged_decode(*map(torch.from_numpy, args), window=window)
    _close(port, ref)
    assert kernels.launches["paged_decode"] == 0   # CPU tensors: plain version


def test_paged_decode_plain_matches_contiguous_decode():
    """Rows with seq_len > 0 equal contiguous decode attention."""
    q, pk, pv, bt, lens = _paged_case(seed=3)
    out = ops.paged_decode_ref(*map(torch.from_numpy, (q, pk, pv, bt, lens)))
    kg = torch.from_numpy(pk)[torch.from_numpy(bt).long()].reshape(4, 48, 2, 16)
    vg = torch.from_numpy(pv)[torch.from_numpy(bt).long()].reshape(4, 48, 2, 16)
    ref = attention.decode_attention(torch.from_numpy(q), kg, vg, torch.from_numpy(lens))
    torch.testing.assert_close(out[:3], ref[:3], rtol=0, atol=0)
    assert not out[3].any()


def test_paged_decode_rejects_mixed_devices():
    q, pk, pv, bt, lens = map(torch.from_numpy, _paged_case())
    with pytest.raises(ValueError, match="device"):
        ops.paged_decode(q.to("meta"), pk, pv, bt, lens)
