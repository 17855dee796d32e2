"""Kernels 3 and 4 (``kd_loss_fwd`` / ``kd_loss_bwd``, ``csrc/kd_loss.cu``):
their launch plan and their arithmetic, on the CPU.

(a) ``kd_plan``: the CTAs' slices cover each row exactly once and each
    CTA's shared memory stays within the card's 227 KB, for every path.
(b) A plain-torch emulation of the kernels' order of operations: each
    slice's (max, sum) state, merged in rank order, one lse for both
    kernels, the slices' KL partials added in rank order and the one-CTA
    finish (thread i adds its rows in row order, then the shuffle tree),
    against the port's plain versions and the JAX kernels in interpret
    mode (``REPRO_FORCE_PALLAS=1``), at the reference's tolerances: the
    loss at rtol 1e-4, the gradient at atol 1e-6 (bf16 also rtol 1e-2,
    one bf16 ulp).  Within a slice the emulation sums in torch's order,
    not the kernel's threads': what it checks is the decomposition.
(c) Why the kernels keep two passes: the one-pass online form (KL = sum t
    log t - sum t z + lse sum t, as the flash kernels compute it) misses
    the loss's rtol 1e-4 against float64 for a student near its teacher at
    Qwen2.5's V = 152,064, tau 4, where the staged two-pass form holds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.kd_loss import ops as jax_ops  # noqa: E402
from repro_torch.kernels.kd_loss import ops, ref  # noqa: E402

CARD_SMEM = 232448                        # 227 KB: the most one CTA may hold
STATIC_SMEM = 1024                        # the kernels' static shared memory, at most
PLAN_VS = [1, 10, 517, 1024, 1025, 4096, 50304, 152064, 256000]


@pytest.fixture()
def force_pallas(monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("B", [1, 256, 512])
@pytest.mark.parametrize("elt", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("V", PLAN_VS)
def test_kd_plan_slices_cover_each_row_once(V, elt, B):
    p = ops.kd_plan(B, V, elt)
    covered = np.zeros(V, np.int64)
    for q, (lo, hi) in enumerate(p["slices"]):
        assert lo == min(V, q * p["slice"]) and lo <= hi <= min(V, lo + p["slice"])
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert len(p["slices"]) == p["cluster"] <= ops.KD_PORTABLE_CLUSTER
    assert 0 <= p["smem"] and p["smem"] + STATIC_SMEM <= CARD_SMEM
    if p["path"] == "staged":
        assert V > ops.KD_ROW_MAX_V and p["slice"] % ops.KD_GROUP == 0
        assert p["smem"] >= p["slice"] * elt + 16 and p["smem"] % 16 == 0
        assert p["grid"] == B * p["cluster"]
        assert p["launches_fwd"] == (1 if B == 1 else 2)
    else:
        lanes = p["row_lanes"]
        assert V <= ops.KD_ROW_MAX_V and 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
        if p["path"] == "small":
            assert B * V <= ops.KD_SMALL_ELEMS and p["grid"] == 1 and p["launches_fwd"] == 1
            assert p["smem"] >= B * V * (elt + 4) + 4 * B
            assert lanes * min(B, ops.KD_SMALL_THREADS) <= ops.KD_SMALL_THREADS
        else:
            assert p["path"] == "rows" and B * V > ops.KD_SMALL_ELEMS
            assert p["launches_fwd"] == 2


def test_kd_plan_sizes_of_the_main_paths():
    """The FedSDD round's KD step is one CTA and one launch; an LM row takes
    the fewest CTAs, up to 8, whose slices keep to the share (two CTAs an
    SM), else 8."""
    p = ops.kd_plan(256, 10, 4)
    assert (p["path"], p["launches_fwd"], p["row_lanes"]) == ("small", 1, 4)
    for (B, V, elt), cluster in {(256, 152064, 4): 6, (256, 152064, 2): 3,
                                 (512, 256000, 4): 8, (512, 256000, 2): 5,
                                 (512, 50304, 4): 2, (512, 50304, 2): 1}.items():
        p = ops.kd_plan(B, V, elt)
        assert (p["path"], p["cluster"]) == ("staged", cluster), (B, V, elt, p)
        assert p["smem"] <= ops.KD_CTA_SHARE or cluster == ops.KD_PORTABLE_CLUSTER
    assert ops.kd_plan(512, 256000, 4, cluster_max=16)["cluster"] == 10
    with pytest.raises(ValueError, match="does not fit"):
        ops.kd_plan(2, 4_000_000, 4)


# ------------------------------------------------------------------ (b)
def _merge(a, b):
    m = torch.maximum(a[0], b[0])
    return m, a[1] * torch.exp(a[0] - m) + b[1] * torch.exp(b[0] - m)


def _finish(kl: torch.Tensor, scale: float) -> torch.Tensor:
    """The one-CTA finish: thread i adds rows [i·k, i·k + k) in row order,
    then a shuffle tree within each warp and over the warps; times scale."""
    B, T = kl.numel(), ops.KD_SMALL_THREADS
    k = -(-B // T)
    part = torch.zeros(T)
    for i in range(k):
        idx = torch.arange(T) * k + i
        part = part + torch.where(idx < B, kl[idx.clamp(max=B - 1)], torch.zeros(()))

    def tree(x):
        lane = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            x = x + x[..., lane ^ o]
        return x[..., 0]

    warps = tree(part.view(T // 32, 32))
    total = tree(torch.cat([warps, torch.zeros(32 - T // 32)]))
    return total * torch.tensor(scale, dtype=torch.float32)


def _staged_rows(s, t, tau: float):
    """(z, lse, the rows' KL) as the kernels form them under ``kd_plan``:
    each slice's (max, sum) merged in rank order, the slices' KL partials
    added in rank order."""
    B, V = s.shape
    slices = ops.kd_plan(B, V, s.element_size())["slices"]
    z = s.float() * torch.tensor(1.0 / tau, dtype=torch.float32)
    state = None
    for lo, hi in slices:
        zq = z[:, lo:hi]
        m = zq.amax(-1) if hi > lo else torch.full((B,), -1e30)
        piece = (m, torch.exp(zq - m[:, None]).sum(-1))
        state = piece if state is None else _merge(state, piece)
    lse = state[0] + torch.log(state[1])
    kl = torch.zeros(B)
    for lo, hi in slices:
        tq = t[:, lo:hi]
        kl = kl + (tq * (torch.log(tq.clamp(min=1e-20)) - (z[:, lo:hi] - lse[:, None]))).sum(-1)
    return z, lse, kl


def staged_emulation(s, t, g, tau: float):
    """(loss, gradient) as kernels 3 and 4 form them: one lse for both."""
    B = s.shape[0]
    z, lse, kl = _staged_rows(s, t, tau)
    c = g.float() * torch.tensor(tau / B, dtype=torch.float32)
    return _finish(kl, tau ** 2 / B), ((torch.exp(z - lse[:, None]) - t) * c).to(s.dtype)


EMULATED = [(4, 128), (8, 1000), (4, 257), (16, 4096), (256, 10), (300, 100), (1024, 9),
            (2, 152064), (4, 256000)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,V", EMULATED, ids=[f"{b}x{v}" for b, v in EMULATED])
def test_staged_emulation_matches_plain_and_pallas(B, V, dtype, force_pallas):
    rng = np.random.default_rng(B * 7 + V)
    s32 = (rng.normal(0, 1, (B, V)) * 3).astype(np.float32)
    t = np.array(jax.nn.softmax(jnp.asarray(rng.normal(0, 1, (B, V)) * 2, jnp.float32), -1))
    tau, g = 4.0, 1.5
    js, jt = jnp.asarray(s32).astype(getattr(jnp, dtype)), jnp.asarray(t)
    ts, tt = torch.from_numpy(s32).to(getattr(torch, dtype)), torch.from_numpy(t)
    loss, grad = staged_emulation(ts, tt, torch.tensor(g), tau)
    for want in (float(ref.kd_loss_ref(ts, tt, tau)), float(jax_ops.kd_loss(js, jt, tau))):
        np.testing.assert_allclose(float(loss), want, rtol=1e-4)
    want_grads = [(ref.kd_loss_grad_ref(ts, tt, tau) * g).to(ts.dtype),
                  jax.grad(lambda x: g * jax_ops.kd_loss(x, jt, tau))(js)]
    rtol = 0 if dtype == "float32" else 1e-2
    assert grad.dtype == ts.dtype
    for want in want_grads:
        want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                          else want.astype(jnp.float32))
        np.testing.assert_allclose(grad.float().numpy(), want, atol=1e-6, rtol=rtol)


def test_finish_adds_rows_in_the_kernels_order():
    """The finish's order is fixed: the same KLs give the same bits whatever
    else runs, and it is the plain sum up to f32 rounding."""
    kl = torch.from_numpy(np.random.default_rng(3).uniform(0, 2, 1500).astype(np.float32))
    a, b = _finish(kl, 16.0 / 1500), _finish(kl.clone(), 16.0 / 1500)
    assert torch.equal(a, b)
    np.testing.assert_allclose(float(a), float(kl.double().sum()) * 16.0 / 1500, rtol=1e-6)


# ------------------------------------------------------------------ (c)
def _one_pass_rows(s, t, tau: float, tile: int = 4096) -> torch.Tensor:
    """Per-row KL·τ² by the one-pass online form over vocab tiles, in f32."""
    z = s.float() * torch.tensor(1.0 / tau, dtype=torch.float32)
    B, V = s.shape
    m, l = torch.full((B,), -1e30), torch.zeros(B)
    tlogt, tz, tsum = torch.zeros(B), torch.zeros(B), torch.zeros(B)
    for lo in range(0, V, tile):
        zq, tq = z[:, lo:lo + tile], t[:, lo:lo + tile]
        m_new = torch.maximum(m, zq.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(zq - m_new[:, None]).sum(-1)
        m = m_new
        tlogt = tlogt + (tq * torch.log(tq.clamp(min=1e-20))).sum(-1)
        tz, tsum = tz + (tq * zq).sum(-1), tsum + tq.sum(-1)
    return (tlogt - tz + (m + torch.log(l)) * tsum).double() * tau ** 2


@pytest.mark.parametrize("seed", range(5))
def test_one_pass_form_misses_the_loss_tolerance_near_the_teacher(seed):
    """32 rows at V = 152,064, tau 4: teacher logits N(0, 2²), the student
    the teacher plus N(0, 0.2²) noise (KL·τ² ≈ 0.02 a row).  Against
    float64, the staged form's loss holds rtol 1e-4 and the one-pass form's
    does not; row by row the one-pass form's error is over three times the
    staged form's (both carry f32's rounding of lse, |lse| ≈ 12: the
    one-pass form also cancels sums of that size)."""
    B, V, tau = 32, 152064, 4.0
    rng = np.random.default_rng(seed)
    zt = rng.normal(0, 2.0, (B, V))
    t = torch.softmax(torch.from_numpy(zt) / tau, -1).float()
    s = torch.from_numpy((zt + 0.2 * rng.normal(0, 1, (B, V))).astype(np.float32))
    z64 = s.double() / tau
    exact = (t.double() * (torch.log(t.double().clamp(min=1e-20))
                           - (z64 - torch.logsumexp(z64, -1, keepdim=True)))).sum(-1) * tau ** 2
    staged, one_pass = _staged_rows(s, t, tau)[2].double() * tau ** 2, _one_pass_rows(s, t, tau)
    loss = float(exact.mean())
    assert abs(float(staged.mean()) / loss - 1) <= 1e-4
    assert abs(float(one_pass.mean()) / loss - 1) > 1e-4
    rms = [float((x - exact).pow(2).mean().sqrt()) for x in (staged, one_pass)]
    assert rms[1] > 3 * rms[0], rms
