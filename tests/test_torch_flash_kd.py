"""Port vs reference: Flash-KD's plain versions, the CPU path of kernels 7-10.

  (a) ``flash_kd_fwd`` / ``flash_kd_bwd`` (kernels 7, 8) against the JAX
      ``flash_kd_fwd_tiled`` / ``flash_kd_bwd_ref`` at the same tile, over B,
      ragged V, V below one tile, τ ∈ {1, 2, 4}, bf16 caches and
      ``teacher_lse``; the losses and their gradients against the Pallas
      kernels in interpret mode (``REPRO_FORCE_PALLAS=1``).
  (b) ``flash_kd_head_fwd`` / ``flash_kd_head_bwd`` (kernels 9, 10) the same
      way, bias on and off, bf16 heads.
  (c) the gradients of ``flash_kd_loss`` and ``flash_kd_head_loss`` against
      autograd of a dense float64 oracle fed the same (rounded) inputs.
  (d) a hypothesis property over the same space, derandomized.
  (e) a tied head (the embedding's transposed view) gives the same ∂embed
      as the untied head holding the same numbers.
  (f) kernel 10's tensor-core arithmetic emulated in plain torch (bf16
      hi/lo halves, three products with f32 sums, the chunked split of
      ∂h's depth summed in order) against the plain version, the
      reference's tiled oracle and its Pallas kernel, within the card's
      bound (2⁻¹⁴ of the summed magnitudes); and, at the LM path's
      magnitudes, one bf16 product a GEMM outside that bound.
  (g) kernel 9's: the same three-product logits reduced into per-(row,
      tile) online states merged in the kernel's order, against the same
      three oracles within the card's forward bounds, and at the LM path's
      magnitudes against a float64 oracle, with the d that kernel 10 forms
      from its lse_s.

Tolerances.  Values: rtol 1e-5, the reference's own kernel tolerance
(``tests/test_flash_kd.py``).  The loss also gets an absolute
2⁻²²·τ²·max(|lse_s|, |lse_t|): KL = cross − lse_t + lse_s cancels terms of
size |lse| when the true KL is near 0, which costs a few f32 ulps of |lse|
in any streaming implementation (the reference's own property test fails
at 2.4e-4 for |lse| ≈ 1e4 against its atol of 1e-6), and the loss is τ²·KL.
The normalisers: rtol 1e-5 plus 2⁻²²·max|lse|.  Gradients: 1e-5 of the sum
of the magnitudes of the terms each element sums (|q| + |p| for a logit
gradient, times |h| or |W| for the head's), plus 2⁻²²·max|lse| of |q| for the
f32 normaliser that the exponent subtracts, plus 2⁻¹²⁶ of the gradient's
scale g·τ/B: an f32 probability below the smallest normal f32 underflows
where the float64 oracle keeps it (1e-276 at logits of ±1e4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.kd_loss import flash as jflash  # noqa: E402
from repro.kernels.kd_loss import ops as jops  # noqa: E402
from repro_torch.kernels.kd_loss import flash, ops  # noqa: E402

ULP_LSE = 2.0 ** -22
RTOL = 1e-5
F32_TINY = 2.0 ** -126      # the smallest normal f32: exp() underflows below it


def _pair(arr, bf16=False):
    """One numpy array as (jax, torch) tensors; bf16 rounds both the same
    way (round to nearest even)."""
    j, t = jnp.asarray(arr, jnp.float32), torch.from_numpy(np.asarray(arr, np.float32))
    if bf16:
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _check_fwd(got, want, tau):
    loss, lse_s, lse_t = (_np(x) for x in got)
    wl, ws, wt = (_np(x) for x in want)
    scale = max(np.abs(ws).max(), np.abs(wt).max())
    np.testing.assert_allclose(loss, wl, rtol=RTOL, atol=ULP_LSE * tau ** 2 * scale)
    np.testing.assert_allclose(lse_s, ws, rtol=RTOL, atol=ULP_LSE * scale)
    np.testing.assert_allclose(lse_t, wt, rtol=RTOL, atol=ULP_LSE * scale)


# -------------------------------------------------------------- (a) 7, 8
FWD_CASES = [  # B, V, tile, tau
    (4, 10, 4096, 4.0),      # V below one tile
    (8, 1000, 256, 2.0),     # ragged tail
    (4, 257, 128, 1.0),      # prime-ish V
    (1, 33, 7, 4.0),         # one row, many ragged tiles
]


@pytest.mark.parametrize("B,V,tile,tau", FWD_CASES)
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32_cache", "bf16_cache"])
def test_flash_fwd_bwd_match_reference(B, V, tile, tau, lse, bf16):
    r = np.random.default_rng(B * V + tile)
    js, s = _pair(r.normal(0, 3, (B, V)))
    jz, z = _pair(r.normal(0, 3, (B, V)), bf16)
    jl = jops.teacher_cache_lse(jz, tau) if lse else None
    tl = ops.teacher_cache_lse(z, tau) if lse else None
    if lse:
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=RTOL)
    want = jflash.flash_kd_fwd_tiled(js, jz, tau, tile, teacher_lse=jl)
    got = ops.flash_kd_fwd(s, z, tau, tile, teacher_lse=None if tl is None else torch.from_numpy(_np(jl)))
    _check_fwd(got, want, tau)
    # the backward from the same normalisers: elementwise only
    ls, lt = np.asarray(want[1]), np.asarray(want[2])
    g = 1.7
    wg = _np(jflash.flash_kd_bwd_ref(js, jz, jnp.asarray(ls), jnp.asarray(lt), g, tau))
    gg = ops.flash_kd_bwd(s, z, torch.from_numpy(ls), torch.from_numpy(lt), torch.tensor(g), tau)
    assert gg.dtype == s.dtype and gg.shape == (B, V)
    np.testing.assert_allclose(_np(gg), wg, rtol=RTOL, atol=1e-6 * g * tau / B)


@pytest.mark.parametrize("B,V,tile", [(4, 384, 128), (8, 1000, 256), (4, 130, 128)])
def test_flash_loss_and_grad_match_pallas_interpret(B, V, tile, monkeypatch):
    """The loss and its gradient against the Pallas kernels in interpret
    mode through the reference's public op (ragged V masked in kernel)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    tau = 4.0
    r = np.random.default_rng(B + V)
    js, s = _pair(r.normal(0, 3, (B, V)))
    jz, z = _pair(r.normal(0, 3, (B, V)))
    for lse in (False, True):
        jl = jops.teacher_cache_lse(jz, tau) if lse else None
        tl = torch.from_numpy(_np(jl)) if lse else None
        want = float(jops.flash_kd_loss(js, jz, tau, tile, teacher_lse=jl))
        wg = _np(jax.grad(lambda x: jops.flash_kd_loss(x, jz, tau, tile, teacher_lse=jl))(js))
        x = s.clone().requires_grad_(True)
        loss = ops.flash_kd_loss(x, z, tau, tile, teacher_lse=tl)
        loss.backward()
        np.testing.assert_allclose(float(loss), want, rtol=RTOL)
        np.testing.assert_allclose(_np(x.grad), wg, rtol=RTOL, atol=1e-6 * tau / B)


# -------------------------------------------------------------- (b) 9, 10
def _head_inputs(B, D, V, bias, seed, bf16_head=False, bf16_cache=False):
    r = np.random.default_rng(seed)
    h = _pair(r.normal(0, 1, (B, D)), bf16_head)
    w = _pair(r.normal(0, 0.5, (D, V)), bf16_head)
    b = _pair(r.normal(0, 0.5, (V,)), bf16_head) if bias else (None, None)
    z = _pair(r.normal(0, 3, (B, V)), bf16_cache)
    return h, w, b, z


HEAD_CASES = [  # B, D, V, tile, bias
    (4, 8, 512, 128, True),     # tile-aligned V
    (4, 8, 1000, 256, True),    # ragged tail
    (3, 5, 257, 128, False),    # prime-ish V, no bias
    (6, 16, 64, 4096, True),    # V below one tile
    (2, 7, 333, 13, False),     # many ragged tiles
]


@pytest.mark.parametrize("B,D,V,tile,bias", HEAD_CASES)
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
def test_head_fwd_bwd_match_reference(B, D, V, tile, bias, lse):
    tau = 4.0
    (jh, h), (jw, w), (jb, b), (jz, z) = _head_inputs(B, D, V, bias, B * V + D)
    jl = jops.teacher_cache_lse(jz, tau) if lse else None
    tl = torch.from_numpy(_np(jl)) if lse else None
    want = jflash.flash_kd_head_fwd_tiled(jh, jw, jb, jz, tau, tile, teacher_lse=jl)
    got = ops.flash_kd_head_fwd(h, w, b, z, tau, tile, teacher_lse=tl)
    _check_fwd(got, want, tau)
    _check_head_bwd(jh, jw, jb, jz, h, w, b, z, want, tau, tile)


def _check_head_bwd(jh, jw, jb, jz, h, w, b, z, want, tau, tile):
    """∂h, ∂W, ∂b from the same normalisers against the reference's, each
    within 1e-5 of the magnitudes it sums (see the module docstring)."""
    ls, lt = np.asarray(want[1]), np.asarray(want[2])
    g = 0.7
    wgh, wgw, wgb = jflash.flash_kd_head_bwd_tiled(jh, jw, jb, jz, jnp.asarray(ls),
                                                    jnp.asarray(lt), g, tau, tile)
    gh, gw, gb = ops.flash_kd_head_bwd(h, w, b, z, torch.from_numpy(ls), torch.from_numpy(lt),
                                       torch.tensor(g), tau, tile)
    assert gh.dtype == h.dtype and gw.dtype == w.dtype and gw.stride() == w.stride()
    assert (gb is None) == (b is None)
    hf, wf = h.double(), w.double()
    s = hf @ wf + (0 if b is None else b.double())
    mag = (torch.exp(s / tau - torch.from_numpy(ls).double()[:, None])
           + torch.exp(z.double() / tau - torch.from_numpy(lt).double()[:, None])) * g * tau / h.shape[0]
    np.testing.assert_allclose(_np(gh), _np(wgh), rtol=RTOL,
                               atol=RTOL * float((mag @ wf.abs().T).max()))
    np.testing.assert_allclose(_np(gw), _np(wgw), rtol=RTOL,
                               atol=RTOL * float((hf.abs().T @ mag).max()))
    if b is not None:
        np.testing.assert_allclose(_np(gb), _np(wgb), rtol=RTOL,
                                   atol=RTOL * float(mag.sum(0).max()))


def test_head_bf16_head_and_cache_match_reference():
    """bf16 head and cache: f32 tiles from the same rounded values; ∂W
    comes back bf16, within one bf16 ulp of the reference's rounding of an
    f32 sum that agrees to rtol 1e-5."""
    tau, tile = 2.0, 128
    (jh, h), (jw, w), (jb, b), (jz, z) = _head_inputs(5, 8, 500, True, 3, bf16_head=True,
                                                       bf16_cache=True)
    want = jflash.flash_kd_head_fwd_tiled(jh, jw, jb, jz, tau, tile)
    _check_fwd(ops.flash_kd_head_fwd(h, w, b, z, tau, tile), want, tau)
    ls, lt = np.asarray(want[1]), np.asarray(want[2])
    wgh, wgw, wgb = jflash.flash_kd_head_bwd_tiled(jh, jw, jb, jz, jnp.asarray(ls),
                                                    jnp.asarray(lt), 1.0, tau, tile)
    gh, gw, gb = ops.flash_kd_head_bwd(h, w, b, z, torch.from_numpy(ls), torch.from_numpy(lt),
                                       torch.tensor(1.0), tau, tile)
    assert gh.dtype == gw.dtype == gb.dtype == torch.bfloat16
    for got, ref in ((gh, wgh), (gw, wgw), (gb, wgb)):
        ref = _np(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=2 ** -8, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("B,D,V,tile,bias", [(4, 8, 512, 128, True), (4, 8, 1000, 256, False)])
def test_head_loss_and_grad_match_pallas_interpret(B, D, V, tile, bias, monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    tau = 4.0
    (jh, h), (jw, w), (jb, b), (jz, z) = _head_inputs(B, D, V, bias, 7 * B + V)
    argnums = (0, 1, 2) if bias else (0, 1)
    jargs = (jh, jw, jb) if bias else (jh, jw)

    def jloss(*a):
        return jops.flash_kd_head_loss(a[0], a[1], a[2] if bias else None, jz, tau, tile)

    want = float(jloss(*jargs))
    wgrads = jax.grad(jloss, argnums=argnums)(*jargs)
    args = [x.clone().requires_grad_(True) for x in ((h, w, b) if bias else (h, w))]
    loss = ops.flash_kd_head_loss(args[0], args[1], args[2] if bias else None, z, tau, tile)
    loss.backward()
    np.testing.assert_allclose(float(loss), want, rtol=RTOL)
    for x, wg in zip(args, wgrads):
        wg = _np(wg)
        np.testing.assert_allclose(_np(x.grad), wg, rtol=RTOL, atol=1e-5 * np.abs(wg).max())


# ------------------------------------------------------ (c) float64 oracle
def _dense_loss64(s, z, tau):
    logq = torch.log_softmax(s / tau, -1)
    p = torch.softmax(z / tau, -1)
    return (p * (torch.log(p.clamp(min=1e-300)) - logq)).sum(-1).mean() * tau ** 2


def _logit_grad_bound(s64, z64, tau, lse_scale):
    q, p = torch.softmax(s64 / tau, -1), torch.softmax(z64 / tau, -1)
    c = tau / s64.shape[0]
    return ((q + p) * c * RTOL + q * c * ULP_LSE * lse_scale + c * F32_TINY).numpy()


@pytest.mark.parametrize("B,V,tile,tau", FWD_CASES)
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
def test_flash_loss_grad_match_float64_oracle(B, V, tile, tau, lse):
    r = np.random.default_rng(3 * B + V)
    s = torch.from_numpy(r.normal(0, 3, (B, V)).astype(np.float32))
    z = torch.from_numpy(r.normal(0, 3, (B, V)).astype(np.float32)).to(torch.bfloat16)
    x = s.clone().requires_grad_(True)
    tl = ops.teacher_cache_lse(z, tau) if lse else None
    loss = ops.flash_kd_loss(x, z, tau, tile, teacher_lse=tl)
    loss.backward()
    x64 = s.double().requires_grad_(True)
    want = _dense_loss64(x64, z.double(), tau)
    want.backward()
    scale = float(torch.logsumexp(torch.cat([s, z.float()]).double().abs() / tau, -1).max())
    assert abs(float(loss) - float(want)) <= RTOL * abs(float(want)) + ULP_LSE * tau ** 2 * scale
    assert (np.abs(_np(x.grad) - x64.grad.numpy())
            <= _logit_grad_bound(s.double(), z.double(), tau, scale)).all()


@pytest.mark.parametrize("B,D,V,tile,bias", HEAD_CASES)
def test_head_loss_grad_match_float64_oracle(B, D, V, tile, bias):
    tau = 2.0
    (_, h), (_, w), (_, b), (_, z) = _head_inputs(B, D, V, bias, 11 * B + V, bf16_cache=True)
    args = [x.clone().requires_grad_(True) for x in ((h, w, b) if bias else (h, w))]
    loss = ops.flash_kd_head_loss(args[0], args[1], args[2] if bias else None, z, tau, tile,
                                  teacher_lse=ops.teacher_cache_lse(z, tau))
    loss.backward()
    a64 = [x.detach().double().requires_grad_(True) for x in args]
    s64 = a64[0] @ a64[1] + (a64[2] if bias else 0)
    want = _dense_loss64(s64, z.double(), tau)
    want.backward()
    scale = float(max(torch.logsumexp(s64.detach().abs() / tau, -1).max(),
                      torch.logsumexp(z.double().abs() / tau, -1).max()))
    assert abs(float(loss) - float(want)) <= RTOL * abs(float(want)) + ULP_LSE * tau ** 2 * scale
    mag = torch.from_numpy(_logit_grad_bound(s64.detach(), z.double(), tau, scale))
    bounds = [mag @ a64[1].detach().abs().T, a64[0].detach().abs().T @ mag, mag.sum(0)]
    for x, x64, bound in zip(args, a64, bounds):
        assert (np.abs(_np(x.grad) - x64.grad.numpy()) <= bound.numpy() + 1e-12).all()


# ------------------------------------------------------------ (d) property
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=40, deadline=None, derandomize=True)
    @given(st.data())
    def test_flash_property_matches_float64_oracle(data):
        """Random (B, V, tile, τ, logit scale, cache dtype, teacher_lse,
        head or not): the plain streaming versions against the float64
        dense oracle at the tolerances of the module docstring."""
        B = data.draw(st.integers(1, 4), label="B")
        V = data.draw(st.integers(1, 300), label="V")
        tile = data.draw(st.integers(1, 64), label="tile")
        tau = data.draw(st.sampled_from([1.0, 2.0, 4.0]), label="tau")
        scale = data.draw(st.sampled_from([1e-2, 1.0, 3.0, 1e4]), label="scale")
        bf16 = data.draw(st.booleans(), label="bf16_cache")
        lse = data.draw(st.booleans(), label="teacher_lse")
        seed = data.draw(st.integers(0, 2 ** 31 - 1), label="seed")
        r = np.random.default_rng(seed)
        s = torch.from_numpy(r.normal(0, scale, (B, V)).astype(np.float32))
        z = torch.from_numpy(r.normal(0, scale, (B, V)).astype(np.float32))
        if bf16:
            z = z.to(torch.bfloat16)
        tl = ops.teacher_cache_lse(z, tau) if lse else None
        x = s.clone().requires_grad_(True)
        loss = ops.flash_kd_loss(x, z, tau, tile, teacher_lse=tl)
        loss.backward()
        x64 = s.double().requires_grad_(True)
        want = _dense_loss64(x64, z.double(), tau)
        want.backward()
        lse_scale = float(max(torch.logsumexp(s.double() / tau, -1).abs().max(),
                              torch.logsumexp(z.double() / tau, -1).abs().max()))
        assert abs(float(loss) - float(want)) <= (RTOL * abs(float(want))
                                                  + ULP_LSE * tau ** 2 * lse_scale)
        assert (np.abs(_np(x.grad) - x64.grad.numpy())
                <= _logit_grad_bound(s.double(), z.double(), tau, lse_scale)).all()
except ImportError:     # hypothesis is a dev extra; the parametrized cases
    pass                # above cover the same ground deterministically


# -------------------------------------------------------- (e) tied heads
@pytest.mark.parametrize("bias", [False, True])
def test_tied_head_gives_the_untied_gradient(bias):
    """W = embed.T (strides (1, D)) and a row-major copy of the same
    numbers: the same loss, ∂W in W's own layout, and ∂embed equal to the
    untied ∂W transposed."""
    B, D, V, tau = 4, 8, 300, 4.0
    r = np.random.default_rng(9)
    h = torch.from_numpy(r.normal(0, 1, (B, D)).astype(np.float32))
    embed = torch.from_numpy(r.normal(0, 0.5, (V, D)).astype(np.float32)).requires_grad_(True)
    w_row = embed.detach().T.contiguous().requires_grad_(True)
    b = torch.from_numpy(r.normal(0, 0.5, (V,)).astype(np.float32)) if bias else None
    z = torch.from_numpy(r.normal(0, 3, (B, V)).astype(np.float32)).to(torch.bfloat16)
    tied = ops.flash_kd_head_loss(h, embed.T, b, z, tau, 64)
    tied.backward()
    untied = ops.flash_kd_head_loss(h, w_row, b, z, tau, 64)
    untied.backward()
    np.testing.assert_allclose(float(tied), float(untied), rtol=RTOL)
    assert embed.grad.is_contiguous()
    np.testing.assert_allclose(embed.grad.numpy(), w_row.grad.T.numpy(), rtol=RTOL,
                               atol=RTOL * float(w_row.grad.abs().max()))


def test_head_loss_refuses_a_skipped_bias_slot():
    with pytest.raises(TypeError, match="head_b"):
        ops.flash_kd_head_loss(torch.zeros(2, 3), torch.zeros(3, 5), torch.zeros(2, 5))


def test_plain_defaults_match_reference():
    assert flash.DEFAULT_TILE_V == jflash.DEFAULT_TILE_V
    assert flash.DEFAULT_TILE_V_HOST == jflash.DEFAULT_TILE_V_HOST
    assert flash.FLASH_PAD == jflash.FLASH_PAD


# ------------------------------------- (f) kernel 10's tensor-core arithmetic
# csrc/flash_kd.cu runs kernel 10's three products on bf16 tensor cores with
# each f32 operand split into hi = bf16(x) and lo = bf16(x − hi), a product
# as hi·hi + hi·lo + lo·hi with f32 sums; dh's depth is split inside each
# chunk and the partials are added in split order, chunks in order.  The
# emulation below computes that in plain torch; it is held against the
# plain version, the reference's tiled oracle and its Pallas kernel within
# the card's own bound (chip_smoke.py's SUM_TOL: 2⁻¹⁴ of the summed
# magnitudes, plus one bf16 ulp for a bf16 result).
SUM_TOL = 2.0 ** -14
K10_CHUNK = 16384         # columns per pass (k10::kChunk)


def _halves(x):
    """x as its bf16 halves (hi, lo), each held in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_product(a, b, products=3):
    """a @ b from the operands' bf16 halves, f32 sums: hi·hi + hi·lo + lo·hi
    (``products=1``: hi·hi alone).  A bf16 operand's lo half is 0."""
    (ah, al), (bh, bl) = _halves(a), _halves(b)
    out = ah @ bh
    return out + ah @ bl + al @ bh if products == 3 else out


def _k10_depth_splits(B, D, V, chunk=K10_CHUNK):
    """Pass (c)'s splits of a chunk's depth, as k10::plan picks them: about
    one wave of 132 CTAs over the (128 x 128) output tiles, at least 4
    steps of 64 a split, at most 8, whole steps each."""
    pad = lambda x: -(-x // 128) * 128                         # noqa: E731
    tiles = (pad(B) // 128) * (pad(D) // 128)
    steps = pad(min(V, chunk)) // 64
    ks = max(1, min(132 // tiles, steps // 4, 8))
    while steps % ks:
        ks -= 1
    return ks, steps // ks


def _head_bwd_emulation(h, w, b, z, lse_s, lse_t, g, tau, chunk=K10_CHUNK, products=3):
    """What kernel 10 computes, in plain torch (see the section's note)."""
    B, D = h.shape
    V = z.shape[1]
    hf, wf = h.float(), w.float()
    coef = float(g) * tau / B
    ks, per = _k10_depth_splits(B, D, V, chunk)
    gh = torch.zeros((B, D))
    gw = torch.empty((D, V))
    gb = None if b is None else torch.empty((V,))
    for v0 in range(0, V, chunk):
        n = min(chunk, V - v0)
        wc = wf[:, v0:v0 + n]
        s = _split_product(hf, wc, products) + (0 if b is None else b.float()[v0:v0 + n])
        d = coef * (torch.exp(s / tau - lse_s[:, None])
                    - torch.exp(z[:, v0:v0 + n].float() / tau - lse_t[:, None]))
        gw[:, v0:v0 + n] = _split_product(hf.T, d, products)
        for z_ in range(ks):                                   # in split order
            k0, k1 = z_ * per * 64, min((z_ + 1) * per * 64, n)
            if k0 < k1:
                gh = gh + _split_product(d[:, k0:k1], wc[:, k0:k1].T, products)
        if gb is not None:
            dh_, dl_ = _halves(d)
            gb[v0:v0 + n] = (dh_ + dl_).sum(0)
    out_b = None if gb is None else gb.to(b.dtype)
    return gh.to(h.dtype), gw.to(w.dtype), out_b


def _head_bwd_bounds(h, w, b, z, lse_s, lse_t, g, tau):
    """Each head gradient's SUM_TOL bound: 2⁻¹⁴ of the summed magnitudes of
    its products, from (|q| + |p|)·|g|·τ/B."""
    s = h.double() @ w.double() + (0 if b is None else b.double())
    mag = (torch.exp(s / tau - lse_s.double()[:, None])
           + torch.exp(z.double() / tau - lse_t.double()[:, None])) * abs(float(g)) * tau / h.shape[0]
    return [SUM_TOL * (mag @ w.double().abs().T), SUM_TOL * (h.double().abs().T @ mag),
            SUM_TOL * mag.sum(0)]


def _assert_within(got, ref, bounds):
    for x, y, bound in zip(got, ref, bounds):
        if x is None:
            continue
        y = torch.from_numpy(np.array(_np(y), np.float64))
        if x.dtype == torch.bfloat16:
            bound = bound + 2.0 ** (torch.floor(torch.log2(y.abs().clamp(min=2.0 ** -126))) - 7)
        assert bool(((x.double() - y).abs() <= bound).all()), float((x.double() - y).abs().max())


SPLIT_CASES = [  # B, D, V, chunk, bias, tied, bf16 cache, bf16 head
    (4, 8, 1000, 256, True, False, False, False),     # a ragged last chunk
    (5, 64, 1100, 512, True, True, True, False),      # tied, bias, bf16 cache
    (3, 40, 517, K10_CHUNK, False, False, True, False),   # one ragged chunk, untied
    (6, 16, 640, 128, False, True, False, False),     # whole 128-column chunks
    (70, 40, 1100, 256, True, False, True, False),    # more rows than one step
    (5, 16, 500, 128, True, False, True, True),       # bf16 head and cache
]


def _split_case(B, D, V, bias, tied, bf16_cache, bf16_head, seed):
    (jh, h), (jw, w), (jb, b), (jz, z) = _head_inputs(B, D, V, bias, seed, bf16_head,
                                                       bf16_cache)
    if tied:                      # the embedding's transposed view, as the tied LM head
        w = w.T.contiguous().T
    return (jh, h), (jw, w), (jb, b), (jz, z)


@pytest.mark.parametrize("B,D,V,chunk,bias,tied,bf16_cache,bf16_head", SPLIT_CASES)
def test_head_bwd_split_arithmetic_matches_plain_and_reference(B, D, V, chunk, bias, tied,
                                                               bf16_cache, bf16_head):
    tau, g = 4.0, 0.7
    (jh, h), (jw, w), (jb, b), (jz, z) = _split_case(B, D, V, bias, tied, bf16_cache,
                                                     bf16_head, B * V + D)
    _, lse_s, lse_t = ops.flash_kd_head_fwd(h, w, b, z, tau)
    got = _head_bwd_emulation(h, w, b, z, lse_s, lse_t, g, tau, chunk)
    bounds = _head_bwd_bounds(h, w, b, z, lse_s, lse_t, g, tau)
    _assert_within(got, ops.flash_kd_head_bwd(h, w, b, z, lse_s, lse_t, torch.tensor(g), tau),
                   bounds)
    want = jflash.flash_kd_head_bwd_tiled(jh, jw, jb, jz, jnp.asarray(lse_s.numpy()),
                                          jnp.asarray(lse_t.numpy()), g, tau, 128)
    _assert_within(got, want, bounds)


@pytest.mark.parametrize("B,D,V,chunk,bias", [(4, 8, 512, 256, True), (3, 40, 1000, 512, False)])
def test_head_bwd_split_arithmetic_matches_pallas_interpret(B, D, V, chunk, bias):
    tau, g = 4.0, 1.3
    (jh, h), (jw, w), (jb, b), (jz, z) = _split_case(B, D, V, bias, True, True, False, 5 * V)
    _, lse_s, lse_t = ops.flash_kd_head_fwd(h, w, b, z, tau)
    got = _head_bwd_emulation(h, w, b, z, lse_s, lse_t, g, tau, chunk)
    want = jflash.flash_kd_head_bwd(jh, jw, jb, jz, jnp.asarray(lse_s.numpy()),
                                    jnp.asarray(lse_t.numpy()), jnp.float32(g), tau,
                                    block_v=128, interpret=True)
    _assert_within(got, want, _head_bwd_bounds(h, w, b, z, lse_s, lse_t, g, tau))


def test_head_bwd_needs_the_split_at_the_paths_magnitudes():
    """Why kernel 10 splits its operands: at gemma-2b's KD-step magnitudes
    (512 rows of N(0, 1) features, D = 2,048, a tied head of 0.02·N(0, 1), a
    bf16 cache of 3·N(0, 1), τ = 4; a V slice of 4,096), one bf16 product
    per GEMM misses the bound on ∂W (and ∂h), while the three-product split
    holds it with a wide margin.  Errors against a float64 oracle."""
    B, D, V, tau, g = 512, 2048, 4096, 4.0, 1.5
    r = np.random.default_rng(0)
    h = torch.from_numpy(r.normal(0, 1, (B, D)).astype(np.float32))
    w = torch.from_numpy((r.normal(0, 1, (V, D)) * 0.02).astype(np.float32)).T
    z = torch.from_numpy(r.normal(0, 3, (B, V)).astype(np.float32)).to(torch.bfloat16)
    s64 = h.double() @ w.double()
    lse_s = torch.logsumexp(s64 / tau, -1).float()
    lse_t = ops.teacher_cache_lse(z, tau)
    d64 = g * tau / B * (torch.exp(s64 / tau - lse_s.double()[:, None])
                         - torch.exp(z.double() / tau - lse_t.double()[:, None]))
    oracle = (d64 @ w.double().T, h.double().T @ d64)
    bounds = _head_bwd_bounds(h, w, None, z, lse_s, lse_t, g, tau)
    ratio = {}
    for products in (1, 3):
        gh, gw, _ = _head_bwd_emulation(h, w, None, z, lse_s, lse_t, g, tau, V, products)
        ratio[products] = [float(((x.double() - y).abs() / bd).max())
                           for x, y, bd in zip((gh, gw), oracle, bounds)]
    assert max(ratio[3]) < 0.1, ratio           # the split: within a tenth of the bound
    assert max(ratio[1]) > 1.5, ratio           # one bf16 product: outside it


# ------------------------------------- (g) kernel 9's tensor-core arithmetic
# csrc/flash_kd.cu forms kernel 9's logits as kernel 10's pass (a) forms them
# (three bf16 products of each f32 operand's halves) and never stores them:
# per (row, 128-column tile) each of the row's four lanes keeps an online
# state over its 32 columns (2·lane + 8j + e), its max first; the lanes merge
# xor 1, then xor 2.  A warp per row merges the row's tile states, lane i
# taking tiles i, i + 32, ... in order, then the lanes in a tree (xor 1, 2,
# 4, 8, 16); kernel 7's combine gives lse_s, lse_t and the loss.  Held
# against the plain version, the reference's tiled oracle and its Pallas
# kernel within phase 12's forward bounds (chip_smoke.py): the loss within
# FLASH_HEAD_LOSS_RTOL·|loss| + 2⁻²²·τ²·max|lse|, the normalisers within
# FLASH_LSE_RTOL·|lse| + 2⁻²²·max|lse|.
FLASH_HEAD_LOSS_RTOL = 1e-4
FLASH_LSE_RTOL = 1e-5
K9_TILE = 128             # columns of one tile state (k9's kBN)


def _merge_states(a, b, lse):
    """Two batches of online states (ms, ls, mt, lt, x), a then b, as
    csrc/flash_kd.cu's merge; a state with ls = 0 is the identity."""
    ms = torch.maximum(a[0], b[0])
    ea, eb = torch.exp(a[0] - ms), torch.exp(b[0] - ms)
    ls = a[1] * ea + b[1] * eb
    if lse:
        mt, lt, x = torch.zeros_like(ms), torch.zeros_like(ms), a[4] + b[4]
    else:
        mt = torch.maximum(a[2], b[2])
        ta, tb = torch.exp(a[2] - mt), torch.exp(b[2] - mt)
        lt, x = a[3] * ta + b[3] * tb, a[4] * ta + b[4] * tb
    out = (ms, ls, mt, lt, x)
    return tuple(torch.where(b[1] == 0, u, torch.where(a[1] == 0, v, w))
                 for u, v, w in zip(a, b, out))


def _lane_states(s, t, lt, lse):
    """Per-lane states of a (B, tiles, 4, 32) block: the max first, then the
    sums of exponentials (and the cross term) against it."""
    ms = s.amax(-1)
    ls = torch.exp(s - ms[..., None]).sum(-1)
    if lse:
        zero = torch.zeros_like(ms)
        return ms, ls, zero, zero, (torch.exp(t - lt[:, None, None, None]) * (t - s)).sum(-1)
    mt = t.amax(-1)
    e = torch.exp(t - mt[..., None])
    return ms, ls, mt, e.sum(-1), (e * (t - s)).sum(-1)


def _head_fwd_emulation(h, w, b, z, tau, teacher_lse=None, chunk=K10_CHUNK, products=3):
    """What kernel 9 computes, in plain torch (see the section's note);
    ``products=1``: one bf16 product a logit."""
    B = h.shape[0]
    V = z.shape[1]
    lse = teacher_lse is not None
    lt = teacher_lse.float() if lse else None
    inv = 1.0 / tau
    pad = torch.tensor(flash.FLASH_PAD, dtype=torch.float32) * inv
    hf, wf = h.float(), w.float()
    tiles = []
    for v0 in range(0, V, chunk):
        n = min(chunk, V - v0)
        s = (_split_product(hf, wf[:, v0:v0 + n], products)
             + (0 if b is None else b.float()[v0:v0 + n])) * inv
        t = z[:, v0:v0 + n].float() * inv
        nt = -(-n // K9_TILE)
        s, t = (torch.cat([x, pad.expand(B, nt * K9_TILE - n)], 1) for x in (s, t))
        # column 8j + 2·lane + e of a tile -> (lane, 2j + e)
        s, t = (x.reshape(B, nt, 16, 4, 2).transpose(2, 3).reshape(B, nt, 4, 32) for x in (s, t))
        st = _lane_states(s, t, lt, lse)
        lane = [tuple(x[..., k] for x in st) for k in range(4)]
        tiles.append(_merge_states(_merge_states(lane[0], lane[1], lse),
                                   _merge_states(lane[2], lane[3], lse), lse))
    part = tuple(torch.cat([tl[k] for tl in tiles], 1) for k in range(5))   # (B, tiles)
    empty = (torch.full((B,), -float("inf")), torch.zeros(B), torch.full((B,), -float("inf")),
             torch.zeros(B), torch.zeros(B))
    lanes = []
    for i in range(32):                    # lane i: tiles i, i + 32, ... in order
        a = empty
        for k in range(i, part[0].shape[1], 32):
            a = _merge_states(a, tuple(x[:, k] for x in part), lse)
        lanes.append(a)
    while len(lanes) > 1:                  # xor 1, 2, 4, 8, 16, as lane 0 sees it
        lanes = [_merge_states(lanes[k], lanes[k + 1], lse) for k in range(0, len(lanes), 2)]
    ms, ls, mt, lt_sum, x = lanes[0]
    lse_s = ms + torch.log(ls)
    if lse:
        lse_t, kl = lt, x - lt + lse_s
    else:
        lse_t = mt + torch.log(lt_sum)
        kl = x / lt_sum - lse_t + lse_s
    return kl.sum() * (tau ** 2 / B), lse_s, lse_t


def _fwd_bound_ratios(got, want, tau, lse_raise=0.0):
    """Each of (loss, lse_s, lse_t): max |got - want| over phase 12's
    forward bound, the normalisers' magnitudes raised by ``lse_raise``."""
    loss, ls, lt = (torch.from_numpy(np.array(_np(x), np.float64)) for x in got)
    wl, ws, wt = (torch.from_numpy(np.array(_np(x), np.float64)) for x in want)
    scale = float(torch.maximum(ws.abs().max(), wt.abs().max())) + lse_raise
    out = [float((loss - wl).abs() / (FLASH_HEAD_LOSS_RTOL * wl.abs()
                                      + ULP_LSE * tau ** 2 * scale))]
    for a, c in ((ls, ws), (lt, wt)):
        out.append(float(((a - c).abs() / (FLASH_LSE_RTOL * (c.abs() + lse_raise)
                                           + ULP_LSE * scale)).max()))
    return out


@pytest.mark.parametrize("B,D,V,chunk,bias,tied,bf16_cache,bf16_head", SPLIT_CASES)
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
def test_head_fwd_split_arithmetic_matches_plain_and_reference(B, D, V, chunk, bias, tied,
                                                               bf16_cache, bf16_head, lse):
    tau = 4.0
    (jh, h), (jw, w), (jb, b), (jz, z) = _split_case(B, D, V, bias, tied, bf16_cache,
                                                     bf16_head, B * V + D + 1)
    tl = ops.teacher_cache_lse(z, tau) if lse else None
    jl = jnp.asarray(tl.numpy()) if lse else None
    got = _head_fwd_emulation(h, w, b, z, tau, tl, chunk)
    plain = ops.flash_kd_head_fwd(h, w, b, z, tau, teacher_lse=tl)
    want = jflash.flash_kd_head_fwd_tiled(jh, jw, jb, jz, tau, 128, teacher_lse=jl)
    for ref in (plain, want):
        ratios = _fwd_bound_ratios(got, ref, tau)
        assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize("B,D,V,chunk,bias", [(4, 8, 512, 256, True), (3, 40, 1000, 512, False)])
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
def test_head_fwd_split_arithmetic_matches_pallas_interpret(B, D, V, chunk, bias, lse):
    tau = 4.0
    (jh, h), (jw, w), (jb, b), (jz, z) = _split_case(B, D, V, bias, True, True, False, 7 * V)
    tl = ops.teacher_cache_lse(z, tau) if lse else None
    got = _head_fwd_emulation(h, w, b, z, tau, tl, chunk)
    want = jflash.flash_kd_head_fwd(jh, jw, jb, jz, tau, block_v=128, interpret=True,
                                    teacher_lse=jnp.asarray(tl.numpy()) if lse else None)
    ratios = _fwd_bound_ratios(got, want, tau)
    assert max(ratios) <= 1.0, ratios


_PATH_V = 4096            # a slice of gemma-2b's V = 256,000


def _path_inputs():
    """gemma-2b's KD-step magnitudes (the section (f) note's): 512 rows of
    N(0, 1) features, D = 2,048, a tied head of 0.02·N(0, 1), a bf16 cache of
    3·N(0, 1), τ = 4, a V slice of 4,096; the float64 logits."""
    r = np.random.default_rng(1)
    B, D, V = 512, 2048, _PATH_V
    h = torch.from_numpy(r.normal(0, 1, (B, D)).astype(np.float32))
    w = torch.from_numpy((r.normal(0, 1, (V, D)) * 0.02).astype(np.float32)).T
    z = torch.from_numpy(r.normal(0, 3, (B, V)).astype(np.float32)).to(torch.bfloat16)
    return h, w, z, h.double() @ w.double()


def test_head_fwd_split_at_the_paths_magnitudes():
    """Kernel 9's three products against a float64 oracle at the KD step's
    magnitudes, the normalisers' magnitudes raised by log(256,000 / 4,096)
    as at the full vocabulary: the loss and both normalisers within a
    hundredth of phase 12's bounds.  One bf16 product a logit is recorded
    beside it (within the bounds too, with less margin; for kernel 10, see
    test_head_fwd_one_product_lse_holds_kernel_10s_d)."""
    tau = 4.0
    h, w, z, s64 = _path_inputs()
    tl = ops.teacher_cache_lse(z, tau)
    lse_s64 = torch.logsumexp(s64 / tau, -1)
    p64 = torch.exp(z.double() / tau - tl.double()[:, None])
    kl64 = (p64 * (z.double() / tau - s64 / tau)).sum(-1) - tl.double() + lse_s64
    want = (kl64.mean() * tau ** 2, lse_s64, tl.double())
    raise_ = float(np.log(256000 / _PATH_V))
    ratio = {k: _fwd_bound_ratios(_head_fwd_emulation(h, w, None, z, tau, tl, products=k),
                                  want, tau, raise_) for k in (1, 3)}
    assert max(ratio[3]) < 1e-2, ratio
    assert max(ratio[1]) > max(ratio[3]), ratio


def _kernel_10s_d_ratio(lse_products):
    """Kernel 10's d = g·τ/B·(e^{s/τ − lse_s} − e^{t/τ − lse_t}) from its own
    three-product logits and kernel 9's lse_s at ``lse_products`` bf16
    products a logit, at the KD step's magnitudes: max |d − d64| over the
    magnitudes (|q| + |p|)·g·τ/B it subtracts."""
    tau, g = 4.0, 1.5
    h, w, z, s64 = _path_inputs()
    B = h.shape[0]
    tl = ops.teacher_cache_lse(z, tau)
    _, lse_s, _ = _head_fwd_emulation(h, w, None, z, tau, tl, products=lse_products)
    s = _split_product(h, w)
    p = torch.exp(z.float() / tau - tl[:, None])
    d = g * tau / B * (torch.exp(s / tau - lse_s[:, None]) - p)
    q64 = torch.softmax(s64 / tau, -1)
    p64 = torch.exp(z.double() / tau - tl.double()[:, None])
    mag = (q64 + p64) * g * tau / B
    return float(((d.double() - (q64 - p64) * g * tau / B).abs() / mag).max())


def test_head_fwd_split_lse_holds_kernel_10s_d():
    """Kernel 9's three-product lse_s keeps kernel 10's d within SUM_TOL of
    the float64 d."""
    ratio = _kernel_10s_d_ratio(3)
    assert ratio <= SUM_TOL, ratio


def test_head_fwd_one_product_lse_holds_kernel_10s_d():
    """What kernel 9's function needs: an lse_s from one bf16 product a
    logit also keeps kernel 10's d within SUM_TOL (about 0.43 of it), as it
    holds phase 12's forward bounds (test_head_fwd_split_at_the_paths_magnitudes).
    So kernel 9's bound in chip_smoke.py counts one product, not the three
    it runs; only kernel 10's own logits need three (section (f))."""
    one, three = _kernel_10s_d_ratio(1), _kernel_10s_d_ratio(3)
    assert three < one <= SUM_TOL, (one, three)
