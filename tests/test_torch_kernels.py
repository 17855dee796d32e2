"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports neither JAX nor the JAX package, so it runs where there is a GPU
and no JAX.  Every test is marked ``cuda`` and skips itself where
``torch.cuda.is_available()`` is false: a CUDA kernel has no CPU mode.

Tolerances: f32 at rtol = atol = 1e-5 (only the order of summation
differs).  bf16 per (request, query head) row: the row's max
|kernel - plain| is at most 1.6e-2 of its max |plain|, four bf16 ulps at
that value.  The plain version rounds the scaled query and its
probabilities to bf16 before P·V, the kernel keeps both in f32, and both
round the output once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

BF16_ROW_TOL = 1.6e-2


def _paged_case(rng, *, G, dh, Hkv=2, bs=16, lens=(64, 17, 8, 0)):
    """A shuffled pool holding ``lens[b]`` tokens for request b."""
    B, nbmax = len(lens), -(-max(lens) // bs)
    nb = 1 + B * nbmax
    bt = rng.permutation(np.arange(1, nb)).reshape(B, nbmax).astype(np.int32)
    q = rng.normal(0, 1, (B, 1, Hkv * G, dh)).astype(np.float32)
    pk = rng.normal(0, 1, (nb, bs, Hkv, dh)).astype(np.float32)
    pv = rng.normal(0, 1, (nb, bs, Hkv, dh)).astype(np.float32)
    return q, pk, pv, bt, np.asarray(lens, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,dh", [(3, 64), (5, 128), (8, 256)])
def test_kernel_matches_plain_on_card(dtype, G, dh):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, pk, pv, bt, lens = (torch.from_numpy(a).cuda()
                           for a in _paged_case(np.random.default_rng(4), G=G, dh=dh))
    args = (q.to(dt), pk.to(dt), pv.to(dt), bt, lens)
    before = kernels.launches["paged_decode"]
    for window in (0, 20):
        out = ops.paged_decode(*args, window=window).float()
        ref = ops.paged_decode_ref(*args, window=window).float()
        if dtype == "float32":
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        else:
            row_err, row_scale = (out - ref).abs().amax(-1), ref.abs().amax(-1)
            assert bool((row_err <= BF16_ROW_TOL * row_scale).all()), \
                float((row_err / row_scale.clamp(min=1e-30)).max())
        assert not out[3].any()                 # seq_len 0: zeros
    assert kernels.launches["paged_decode"] == before + 2
