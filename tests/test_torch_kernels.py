"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports neither JAX nor the JAX package, so it runs where there is a GPU
and no JAX.  Every test is marked ``cuda`` and skips itself where
``torch.cuda.is_available()`` is false: a CUDA kernel has no CPU mode.

Tolerances, ``paged_decode``: f32 at rtol = atol = 1e-5 (only the order
of summation differs).  bf16 per (request, query head) row: the row's max
|kernel - plain| is at most 1.6e-2 of its max |plain|, four bf16 ulps at
that value.  The plain version rounds the scaled query and its
probabilities to bf16 before P·V, the kernel keeps both in f32, and both
round the output once.

Tolerances, ``flash_attention`` and ``flash_decode`` (kernels 12 and 11;
both sides compute in f32 from the same inputs and round the output once):
f32 at rtol = atol = 1e-5; bf16 within one bf16 ulp of each row's max
|plain| plus 2e-5.  The backward recomputes through the plain
``attention`` on both sides, at rtol = atol = 1e-5.

Tolerances, the KD kernels (both sides compute in f32 from the same
inputs; only the order of summation differs): f32 per row, max
|kernel - plain| at most 1e-5 of the row's max |plain|; probabilities
from bf16 teacher logits at the same 1e-5 of the row's max (both sides
compute in f32 from the same bf16 values; the reference's own atol 2e-3
is hundreds of times a probability at V 152,064); the loss at rtol 1e-4;
a bf16 gradient per row at 8e-3 of its max |plain| (two bf16 ulps: both
sides round once), plus 1e-6·|g|·τ/B absolute (f32 noise on p − t, for
rows near zero).

Tolerances, ``weight_avg`` (both sides sum the same f32 products, in
another order): f32 at rtol 1e-5, atol 1e-6, the reference's own
(``tests/test_engine_parity.py``); bf16 within one bf16 ulp of the plain
result (both round one f32 sum once) plus 2^-22 of the sum of |ŵ_n·x_n|:
the two f32 sums differ by a few f32 ulps of their terms, which a result
much smaller than its terms (cancellation) does not absorb.

Tolerances, Flash-KD (kernels 7-10; both sides compute in f32 from the
same inputs, in other orders): the loss at rtol 1e-5 (kernel 7) or 1e-4
(kernel 9, whose student logits are a length-D sum formed in the kernel)
plus 2^-22·τ²·max|lse| (KL = cross − lse_t + lse_s cancels terms of size
|lse|); the normalisers at rtol 1e-5 plus 2^-22·max|lse|; a logit gradient
within 1e-5 of (|q| + |p|)·|g|·τ/B per element, the magnitude of what it
subtracts, plus one ulp of its type when that is bf16; the head's
gradients within 2^-14 of the sum of the magnitudes of the products each
element adds up (up to 256,000 of them: u·√K for K up to a million).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.kd_loss import ops as kd_ops  # noqa: E402
from repro_torch.kernels.kd_loss import ref as kd_ref  # noqa: E402
from repro_torch.kernels.weight_avg import ops as wa_ops  # noqa: E402
from repro_torch.kernels.weight_avg import ref as wa_ref  # noqa: E402

BF16_ROW_TOL = 1.6e-2
KD_F32_ROW_TOL = 1e-5
KD_BF16_GRAD_ROW_TOL = 8e-3
# the reference sweep (tests/test_kernels.py), the FedSDD round's own
# V = 10 (M = K·R = 8 teachers over 8 server batches of 256) and an LM
# vocabulary (Qwen2.5's V = 152,064)
KD_SHAPES = [(1, 4, 128), (4, 8, 1000), (8, 4, 257), (2, 16, 4096), (8, 2048, 10),
             (4, 256, 152064)]
KD_TEMPS = [1.0, 4.0, 2.0, 4.0, 4.0, 4.0]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _rows_within(out, ref, rel, atol=0.0):
    """Every row's max |out - ref| at most ``rel`` of its max |ref| plus ``atol``."""
    out, ref = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    return bool(((out - ref).abs().amax(-1) <= rel * ref.abs().amax(-1) + atol).all())


def _row_rel_err(out, ref) -> str:
    """The largest row's max |out - ref| over its max |ref|, and the max
    |out - ref|: a failed check's reading."""
    out, ref = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    err = (out - ref).abs()
    return (f"row_rel_err {float((err.amax(-1) / ref.abs().amax(-1)).max())}, "
            f"max_abs_err {float(err.max())}")


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
@pytest.mark.parametrize("G,dh", [(3, 64), (5, 128), (8, 256), (1, 80), (3, 80)])
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


# kernel 1's split-K edges (nbmax, window, lens) at bs 16, chunk 144 or
# 128 here: seq_len 0, 1 and 16k ± 1, lengths on a split boundary, nbmax·bs
# far above every length (empty splits), windows whose lo falls inside a
# block, rows whose first blocks lie wholly before the window
PAGED_SPLIT_CASES = [
    (40, 0, (0, 1, 15, 17, 128, 256, 257, 640)),
    (40, 260, (0, 1, 15, 17, 128, 256, 300, 640)),
    (200, 0, (0, 1, 33, 129, 300, 511, 512, 513)),
    (64, 300, (0, 1, 299, 300, 301, 777, 1000, 1024)),
    (64, 272, (0, 17, 143, 144, 145, 288, 289, 1023)),
]


def _paged_split_case(rng, nbmax, lens, *, G, dh, Hkv=2, bs=16):
    q, pk, pv, bt, sl = _paged_case(rng, G=G, dh=dh, Hkv=Hkv, bs=bs, lens=lens)
    wide = np.zeros((len(lens), nbmax), np.int32)
    wide[:, :bt.shape[1]] = bt
    return q, pk, pv, wide, sl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,dh", [(12, 128), (5, 128), (16, 256), (1, 80)])
@pytest.mark.parametrize("nbmax,window,lens", PAGED_SPLIT_CASES,
                         ids=lambda x: str(x) if not isinstance(x, tuple) else "lens")
def test_paged_splitk_edges_match_plain_on_card(nbmax, window, lens, G, dh, dtype):
    """Kernel 1's split-K partition and last-arriving merge at the edges
    of its chunks, against the plain version; two launches give the same
    bits (the merge runs in split order, and the arrival counters are back
    at zero after each launch)."""
    _needs_card()
    dt = getattr(torch, dtype)
    q, pk, pv, bt, sl = (torch.from_numpy(a).cuda() for a in
                         _paged_split_case(np.random.default_rng(nbmax + G), nbmax, lens,
                                           G=G, dh=dh))
    args = (q.to(dt), pk.to(dt), pv.to(dt), bt, sl)
    assert ops.paged_plan(args[0], args[1], bt, window)["splits"] > 1
    before = kernels.launches["paged_decode"]
    out = ops.paged_decode(*args, window=window)
    again = ops.paged_decode(*args, window=window)
    ref = ops.paged_decode_ref(*args, window=window).float()
    torch.cuda.synchronize()
    assert kernels.launches["paged_decode"] == before + 2
    assert torch.equal(out, again)
    out = out.float()
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        row_err, row_scale = (out - ref).abs().amax(-1), ref.abs().amax(-1)
        assert bool((row_err <= BF16_ROW_TOL * row_scale).all()), \
            float((row_err / row_scale.clamp(min=1e-30)).max())
    assert not out[torch.tensor(lens) == 0].any()    # seq_len 0: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,tau", list(zip(KD_SHAPES, KD_TEMPS)),
                         ids=[f"{m}x{b}x{v}" for m, b, v in KD_SHAPES])
def test_ensemble_softmax_matches_plain_on_card(dtype, shape, tau):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(getattr(torch, dtype))
    before = kernels.launches["ensemble_softmax"]
    out = kd_ops.ensemble_softmax(x, tau)
    ref = kd_ref.ensemble_softmax_ref(x, tau)
    torch.cuda.synchronize()
    assert kernels.launches["ensemble_softmax"] == before + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert _rows_within(out, ref, KD_F32_ROW_TOL), _row_rel_err(out, ref)
    torch.testing.assert_close(out.sum(-1), torch.ones_like(out[:, 0]), rtol=0, atol=1e-4)


# kernel 2 on each path of ensemble_plan: small blocks of whole rows (V 1,
# 10, 517, 1,024; N not a multiple of the block) and staged rows in
# clusters of 1 to 10 CTAs (non-portable above 8: gemma-2b's row takes 10)
ENS_PLAN_SHAPES = [(3, 7, 1), (8, 300, 10), (2, 33, 517), (5, 9, 1024), (4, 3, 1025),
                   (3, 5, 28000), (2, 3, 50304), (3, 3, 70000), (4, 2, 90000),
                   (2, 2, 130000), (4, 2, 152064), (3, 2, 170000), (2, 2, 210000),
                   (2, 2, 240000), (8, 2, 256000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ENS_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ensemble_softmax_paths_match_plain_on_card(dtype, shape):
    _needs_card()
    M, N, V = shape
    x = (torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(N * V),
                     device="cuda") * 3).to(getattr(torch, dtype))
    out, ref = kd_ops.ensemble_softmax(x, 2.0), kd_ref.ensemble_softmax_ref(x, 2.0)
    torch.cuda.synchronize()
    assert _rows_within(out, ref, KD_F32_ROW_TOL), _row_rel_err(out, ref)


def test_ensemble_plan_shapes_reach_every_cluster_size():
    clusters = {kd_ops.ensemble_plan(M, N, V, elt)["cluster"] for M, N, V in ENS_PLAN_SHAPES
                for elt in (2, 4)}
    assert clusters == set(range(1, 11))
    assert {kd_ops.ensemble_plan(M, N, V, 4)["path"] for M, N, V in ENS_PLAN_SHAPES} == \
        {"small", "staged"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("shape", [(8, 2048, 10), (4, 33, 517), (3, 4, 4099), (4, 2, 152064)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ensemble_softmax_at_an_odd_storage_offset_on_card(dtype, offset, shape):
    """Teacher logits whose rows start at any 4- or 2-byte phase: plain loads
    at the head and tail, the same z and the same order of sums, so the same
    bits as at offset 0."""
    _needs_card()
    M, N, V = shape
    gen = torch.Generator(device="cuda").manual_seed(N * V + offset)
    flat = (torch.randn((M * N * V + offset,), generator=gen, device="cuda") * 3)
    x = flat.to(getattr(torch, dtype))[offset:].view(shape)
    assert x.is_contiguous() and x.storage_offset() == offset
    out = kd_ops.ensemble_softmax(x, 4.0)
    aligned = x.clone()
    assert aligned.storage_offset() == 0
    again = kd_ops.ensemble_softmax(aligned, 4.0)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(kd_ops.ensemble_softmax(aligned, 4.0), again)
    ref = kd_ref.ensemble_softmax_ref(x, 4.0)
    assert _rows_within(out, ref, KD_F32_ROW_TOL), _row_rel_err(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,tau", list(zip(KD_SHAPES, KD_TEMPS)),
                         ids=[f"{m}x{b}x{v}" for m, b, v in KD_SHAPES])
def test_kd_loss_and_grad_match_plain_on_card(dtype, shape, tau):
    """The autograd.Function: forward through kd_loss_fwd, the gradient of
    3·loss through kd_loss_bwd with g = 3 read on the device."""
    _needs_card()
    _, B, V = shape
    gen = torch.Generator(device="cuda").manual_seed(B + V)
    s = (torch.randn((B, V), generator=gen, device="cuda") * 3).to(getattr(torch, dtype))
    t = torch.softmax(torch.randn((B, V), generator=gen, device="cuda") * 2, -1)
    fwd, bwd = kernels.launches["kd_loss_fwd"], kernels.launches["kd_loss_bwd"]
    s_req = s.clone().requires_grad_(True)
    loss = kd_ops.kd_loss(s_req, t, tau)
    (3.0 * loss).backward()
    want = kd_ref.kd_loss_ref(s, t, tau)
    want_grad = (kd_ref.kd_loss_grad_ref(s, t, tau) * 3.0).to(s.dtype)
    torch.cuda.synchronize()
    assert kernels.launches["kd_loss_fwd"] == fwd + 1
    assert kernels.launches["kd_loss_bwd"] == bwd + 1
    torch.testing.assert_close(loss.detach(), want, rtol=1e-4, atol=0)
    assert s_req.grad.dtype == s.dtype
    tol = KD_F32_ROW_TOL if dtype == "float32" else KD_BF16_GRAD_ROW_TOL
    assert _rows_within(s_req.grad, want_grad, tol, 1e-6 * 3.0 * tau / B)


@pytest.mark.cuda
def test_kd_loss_zero_when_student_equals_teacher_on_card():
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    s = torch.randn((4, 100), generator=gen, device="cuda")
    assert float(kd_ops.kd_loss(s, torch.softmax(s / 4.0, -1), 4.0)) < 1e-5


# kernels 3 and 4 on each path of kd_plan: LM rows in clusters (Qwen2.5's
# and gemma-2b's vocabularies), one staged row (the loss written by the row
# kernel), one CTA, a staged row across 16-byte boundaries, and the rows
# path with a thread and a warp a row
KD_PLAN_SHAPES = [(3, 152064), (2, 256000), (512, 256000), (1, 256000), (5, 1025),
                  (9000, 1), (300, 100)]


def _kd_pair(gen, B, V, dtype, offset=0):
    """s (B, V) at ``offset`` elements into its storage (contiguous), t = softmax."""
    flat = (torch.randn((B * V + offset,), generator=gen, device="cuda") * 3).to(dtype)
    s = flat[offset:].view(B, V)
    return s, torch.softmax(torch.randn((B, V), generator=gen, device="cuda") * 2, -1)


def _kd_check(s, t, g, tau):
    """kd_loss_fwd and kd_loss_bwd (with g on the device) against their plain versions."""
    B = s.shape[0]
    loss, grad = kd_ops.kd_loss_fwd(s, t, tau), kd_ops.kd_loss_bwd(s, t, g, tau)
    want = kd_ref.kd_loss_ref(s, t, tau)
    want_grad = (kd_ref.kd_loss_grad_ref(s, t, tau) * g).to(s.dtype)
    torch.cuda.synchronize()
    assert loss.dim() == 0 and loss.device == s.device
    torch.testing.assert_close(loss, want, rtol=1e-4, atol=0)
    assert grad.dtype == s.dtype and grad.shape == s.shape and bool(grad.isfinite().all())
    tol = KD_F32_ROW_TOL if s.dtype == torch.float32 else KD_BF16_GRAD_ROW_TOL
    assert _rows_within(grad, want_grad, tol, 1e-6 * abs(float(g)) * tau / B)
    return loss, grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KD_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kd_loss_paths_match_plain_on_card(dtype, shape):
    _needs_card()
    B, V = shape
    gen = torch.Generator(device="cuda").manual_seed(B + V)
    s, t = _kd_pair(gen, B, V, getattr(torch, dtype))
    fwd, bwd = kernels.launches["kd_loss_fwd"], kernels.launches["kd_loss_bwd"]
    _kd_check(s, t, torch.tensor(1.5, device="cuda"), 4.0)
    assert (kernels.launches["kd_loss_fwd"], kernels.launches["kd_loss_bwd"]) == (fwd + 1, bwd + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("shape", [(256, 10), (7, 517), (3, 4099), (2, 152064)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kd_loss_student_at_an_odd_storage_offset_on_card(dtype, offset, shape):
    """A contiguous student whose rows start at any 4- or 2-byte phase: the
    staged copy's head and tail go by plain loads, the gradient's 16-byte
    groups follow its own alignment."""
    _needs_card()
    B, V = shape
    gen = torch.Generator(device="cuda").manual_seed(B * V + offset)
    s, t = _kd_pair(gen, B, V, getattr(torch, dtype), offset)
    assert s.is_contiguous() and s.storage_offset() == offset
    loss, grad = _kd_check(s, t, torch.tensor(0.7, device="cuda"), 2.0)
    aligned = s.clone()                         # the same values at offset 0
    assert aligned.storage_offset() == 0
    assert torch.equal(kd_ops.kd_loss_fwd(aligned, t, 2.0), loss)
    assert torch.equal(kd_ops.kd_loss_bwd(aligned, t, torch.tensor(0.7, device="cuda"), 2.0),
                       grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 10), (300, 100), (512, 256000), (4, 152064)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kd_loss_bit_stable_on_card(dtype, shape):
    """Two calls on the same inputs give the same bits: the cluster's states
    are merged in rank order and the rows' KL summed in a fixed order, with
    no atomics."""
    _needs_card()
    B, V = shape
    gen = torch.Generator(device="cuda").manual_seed(B + V + 1)
    s, t = _kd_pair(gen, B, V, getattr(torch, dtype))
    g = torch.tensor(1.5, device="cuda")
    first = (kd_ops.kd_loss_fwd(s, t, 4.0), kd_ops.kd_loss_bwd(s, t, g, 4.0))
    second = (kd_ops.kd_loss_fwd(s, t, 4.0), kd_ops.kd_loss_bwd(s, t, g, 4.0))
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,most", [((256, 10), 1), ((512, 256000), 2), ((1, 256000), 1)],
                         ids=["256x10", "512x256000", "1x256000"])
def test_kd_loss_fwd_device_kernels_per_call_on_card(shape, most):
    """torch.profiler: kd_loss_fwd is one device kernel at the FedSDD round's
    256 x 10 (the loss written in the kernel) and at most two at gemma-2b's
    vocabulary (the rows' KL, then the one-CTA sum)."""
    _needs_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, V = shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    s, t = _kd_pair(gen, B, V, torch.float32)
    kd_ops.kd_loss_fwd(s, t, 4.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kd_ops.kd_loss_fwd(s, t, 4.0)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    assert launches == 3 * most, [(e.key, e.count) for e in prof.key_averages()]


# the reference sweep, the vectorized ResNet-56 round's largest leaf
# (G = K = 4 groups of N = 2 clients) and a leaf of one element, an odd D
# across many CTAs, and N above one warp
WA_SHAPES = [(3, 5, 517), (4, 2, 36864), (4, 2, 1), (4, 8, 1_000_003), (1, 64, 4099)]


def _wa_close(out, ref, x, w):
    """``x`` (G, N, D) and ``w`` (G, N) are the inputs."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    else:
        want = ref.float()
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(min=2 ** -126))) - 7)
        w_hat = w / w.sum(-1, keepdim=True)
        terms = (x.float().abs() * w_hat[..., None]).sum(-2)
        assert bool(((out.float() - want).abs() <= ulp + 2.0 ** -22 * terms).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_group_weighted_average_matches_plain_on_card(dtype, shape):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype))
    w = torch.randint(1, 40, shape[:2], generator=gen, device="cuda").float()
    before = kernels.launches["multi_weighted_average"]
    out = wa_ops.group_weighted_average(x, w)
    ref = wa_ref.group_weighted_average_ref(x, w)
    torch.cuda.synchronize()
    assert kernels.launches["multi_weighted_average"] == before + 1
    assert out.dtype == x.dtype and out.shape == ref.shape
    _wa_close(out, ref, x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 517), (32, 100_003)], ids=lambda s: "x".join(map(str, s)))
def test_weighted_average_matches_plain_on_card(dtype, shape):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype))
    w = torch.randint(1, 40, shape[:1], generator=gen, device="cuda").float()
    before = kernels.launches["weighted_average"]
    out = wa_ops.weighted_average(x, w)
    ref = wa_ref.weighted_average_ref(x, w)
    torch.cuda.synchronize()
    assert kernels.launches["weighted_average"] == before + 1
    _wa_close(out, ref, x[None], w[None])


@pytest.mark.cuda
def test_weight_avg_pytree_wrappers_launch_once_per_tree_on_card():
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"a": torch.randn((4, 2, 3, 3, 16), generator=gen, device="cuda"),
            "b": {"c": torch.randn((4, 2, 10), generator=gen, device="cuda")}}
    w = torch.tensor([[1.0, 3.0]] * 4, device="cuda")
    before = kernels.launches["multi_weighted_average"]
    out = wa_ops.group_weighted_average_pytree(tree, w)
    assert kernels.launches["multi_weighted_average"] == before + 1
    torch.testing.assert_close(out["a"], (tree["a"][:, 0] + 3 * tree["a"][:, 1]) / 4,
                               rtol=1e-5, atol=1e-6)
    assert out["b"]["c"].shape == (4, 10)
    assert out["a"].untyped_storage().data_ptr() == out["b"]["c"].untyped_storage().data_ptr()
    before = kernels.launches["weighted_average"]
    one = wa_ops.weighted_average_pytree({"c": tree["b"]["c"][0]}, w[0])
    assert kernels.launches["weighted_average"] == before + 1
    torch.testing.assert_close(one["c"], (tree["b"]["c"][0, 0] + 3 * tree["b"]["c"][0, 1]) / 4,
                               rtol=1e-5, atol=1e-6)


def _wa_tree(gen, shapes, G, N, offsets=None):
    """Leaves (G, N, *shape) of the given dtypes, leaf i at ``offsets[i]``
    elements into its storage (contiguous)."""
    tree = []
    for i, (dtype, shape) in enumerate(shapes):
        off = offsets[i] if offsets else 0
        n = G * N * int(np.prod(shape, dtype=np.int64))
        flat = torch.randn((n + off,), generator=gen, device="cuda").to(dtype)
        tree.append(flat[off:].view((G, N) + tuple(shape)))
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "odd offsets", "split table"])
def test_weight_avg_tree_matches_plain_on_card(case):
    """Kernel 5's tree launch: f32 and bf16 leaves (a launch each), leaves
    of one element and of odd D, leaves at odd storage offsets (scalar
    loads), and a tree of more leaves than one table holds (several
    launches); each leaf against the plain version, and the launch count
    against wa_tree_plan's."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(len(case))
    f32, bf16 = torch.float32, torch.bfloat16
    G, N = 4, 2
    if case == "mixed":
        shapes = [(f32, (3, 3, 16, 16)), (bf16, (1,)), (f32, (1,)), (bf16, (517,)),
                  (f32, (10,)), (bf16, (64, 64)), (f32, (36864,)), (bf16, (3,))]
        offsets = None
    elif case == "odd offsets":
        shapes = [(f32, (1024,)), (bf16, (2048,)), (f32, (4099,)), (bf16, (7,))]
        offsets = [1, 3, 2, 5]
    else:
        G, N = 3, 5
        shapes = [(f32 if i % 3 else bf16, (1 + (i * 37) % 300,)) for i in range(2500)]
        offsets = None
    tree = _wa_tree(gen, shapes, G, N, offsets)
    w = torch.randint(1, 40, (G, N), generator=gen, device="cuda").float()
    plan = wa_ops.wa_tree_plan([(x.dtype, x[0, 0].numel()) for x in tree], G, N)
    before = kernels.launches["multi_weighted_average"]
    out = wa_ops.group_weighted_average_pytree(tree, w)
    torch.cuda.synchronize()
    assert kernels.launches["multi_weighted_average"] == before + len(plan["launches"])
    if case == "split table":
        assert len(plan["launches"]) == 3
    storage = out[0].untyped_storage().data_ptr()
    for x, o in zip(tree, out):
        assert o.dtype == x.dtype and o.shape == (G,) + x.shape[2:] and o.is_contiguous()
        assert o.untyped_storage().data_ptr() == storage and o.data_ptr() % 16 == 0
        x3 = x.reshape(G, N, -1)
        _wa_close(o.reshape(G, -1), wa_ref.group_weighted_average_ref(x3, w), x3, w)


@pytest.mark.cuda
def test_weight_avg_tree_equals_the_per_tensor_launches_on_card():
    """A leaf of a tree, the same tensor alone (a one-leaf table) and a copy
    at an odd storage offset (the scalar path) normalise the weights and sum
    the same f32 products in the same order: the same bits."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(torch.float32, (3, 3, 16, 32)), (torch.bfloat16, (999,)),
              (torch.float32, (10,)), (torch.bfloat16, (4096,))]
    tree = _wa_tree(gen, shapes, 4, 2)
    w = torch.randint(1, 7000, (4, 2), generator=gen, device="cuda").float()
    out = wa_ops.group_weighted_average_pytree(tree, w)
    for x, o in zip(tree, out):
        one = wa_ops.group_weighted_average(x.reshape(4, 2, -1), w)
        assert torch.equal(o.reshape(4, -1), one)
        flat = torch.empty((x.numel() + 1,), dtype=x.dtype, device="cuda")
        odd = flat[1:].view(4, 2, -1)
        odd.copy_(x.reshape(4, 2, -1))
        assert torch.equal(wa_ops.group_weighted_average(odd, w), one)


@pytest.mark.cuda
def test_weight_avg_refuses_what_the_kernel_does_not_take_on_card():
    _needs_card()
    x = torch.zeros((2, 3, 8), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        wa_ops.group_weighted_average(x.transpose(0, 1), torch.ones((3, 2), device="cuda"))
    with pytest.raises(ValueError, match="float16"):
        wa_ops.group_weighted_average(x.half(), torch.ones((2, 3), device="cuda"))
    with pytest.raises(ValueError, match="several devices"):
        wa_ops.group_weighted_average(x, torch.ones((2, 3)))


# ----------------------------------------------------------- Flash-KD 7-10
ULP_LSE, SUM_TOL, F32_TINY = 2.0 ** -22, 2.0 ** -14, 2.0 ** -126


def _ulp(ref):
    return 2.0 ** (torch.floor(torch.log2(ref.float().abs().clamp(min=F32_TINY))) - 7)


def _check_flash_fwd(got, want, tau, loss_rtol):
    scale = float(torch.maximum(want[1].abs().max(), want[2].abs().max()))
    assert abs(float(got[0]) - float(want[0])) <= (loss_rtol * abs(float(want[0]))
                                                   + ULP_LSE * tau ** 2 * scale)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=ULP_LSE * scale)


def _flash_case(gen, B, V, sdtype, tdtype):
    s = (torch.randn((B, V), generator=gen, device="cuda") * 3).to(sdtype)
    z = (torch.randn((B, V), generator=gen, device="cuda") * 3).to(tdtype)
    return s, z


FLASH_SHAPES = [(1, 517), (5, 50304), (64, 4096), (3, 9000)]


@pytest.mark.cuda
@pytest.mark.parametrize("sdtype,tdtype", [("float32", "float32"), ("float32", "bfloat16"),
                                           ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_kd_fwd_bwd_match_plain_on_card(sdtype, tdtype, lse, shape):
    _needs_card()
    from repro_torch.kernels.kd_loss import flash
    B, V = shape
    tau = 2.0
    gen = torch.Generator(device="cuda").manual_seed(B + V)
    s, z = _flash_case(gen, B, V, getattr(torch, sdtype), getattr(torch, tdtype))
    tl = kd_ops.teacher_cache_lse(z, tau) if lse else None
    fwd, bwd = kernels.launches["flash_kd_fwd"], kernels.launches["flash_kd_bwd"]
    got = kd_ops.flash_kd_fwd(s, z, tau, teacher_lse=tl)
    want = flash.flash_kd_fwd_tiled(s, z, tau, teacher_lse=tl)
    g = torch.tensor(1.5, device="cuda")
    gs = kd_ops.flash_kd_bwd(s, z, want[1], want[2], g, tau)
    ws = flash.flash_kd_bwd_ref(s, z, want[1], want[2], g, tau)
    torch.cuda.synchronize()
    assert kernels.launches["flash_kd_fwd"] == fwd + 1
    assert kernels.launches["flash_kd_bwd"] == bwd + 1
    _check_flash_fwd(got, want, tau, 1e-5)
    c = 1.5 * tau / B
    mag = (torch.exp(s.float() / tau - want[1][:, None])
           + torch.exp(z.float() / tau - want[2][:, None])) * c
    bound = 1e-5 * mag + c * F32_TINY + (_ulp(ws) if gs.dtype == torch.bfloat16 else 0)
    assert gs.dtype == s.dtype and bool(((gs.float() - ws.float()).abs() <= bound).all())


def _head_case(gen, B, D, V, mdtype, tdtype, bias, tied):
    h = torch.randn((B, D), generator=gen, device="cuda").to(mdtype)
    if tied:
        w = (torch.randn((V, D), generator=gen, device="cuda") * 0.05).to(mdtype).T
    else:
        w = (torch.randn((D, V), generator=gen, device="cuda") * 0.05).to(mdtype)
    b = (torch.randn((V,), generator=gen, device="cuda") * 0.5).to(mdtype) if bias else None
    z = (torch.randn((B, V), generator=gen, device="cuda") * 3).to(tdtype)
    return h, w, b, z


def _check_head_bwd(got, want, h, w, b, z, lse_s, lse_t, g, tau):
    gh, gw, gb = got
    assert gh.dtype == h.dtype and gw.dtype == w.dtype and gw.stride() == w.stride()
    assert (gb is None) == (b is None)
    s = h.float() @ w.float() + (0 if b is None else b.float())
    mag = (torch.exp(s / tau - lse_s[:, None]) + torch.exp(z.float() / tau - lse_t[:, None])) \
        * abs(float(g)) * tau / h.shape[0]
    bounds = [mag @ w.float().abs().T, h.float().abs().T @ mag, mag.sum(0)]
    for x, ref, bound in zip(got, want, bounds):
        if x is None:
            continue
        bound = SUM_TOL * bound + (_ulp(ref) if x.dtype == torch.bfloat16 else 0)
        assert bool(((x.float() - ref.float()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mdtype,tdtype", [("float32", "float32"), ("float32", "bfloat16"),
                                           ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("shape", [(1, 64, 517), (70, 40, 1100), (5, 256, 50304)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_kd_head_fwd_bwd_match_plain_on_card(mdtype, tdtype, lse, bias, tied, shape):
    _needs_card()
    from repro_torch.kernels.kd_loss import flash
    torch.backends.cuda.matmul.allow_tf32 = False
    B, D, V = shape
    tau = 4.0
    gen = torch.Generator(device="cuda").manual_seed(B + D + V)
    h, w, b, z = _head_case(gen, B, D, V, getattr(torch, mdtype), getattr(torch, tdtype),
                            bias, tied)
    tl = kd_ops.teacher_cache_lse(z, tau) if lse else None
    fwd, bwd = kernels.launches["flash_kd_head_fwd"], kernels.launches["flash_kd_head_bwd"]
    got = kd_ops.flash_kd_head_fwd(h, w, b, z, tau, teacher_lse=tl)
    want = flash.flash_kd_head_fwd_tiled(h, w, b, z, tau, teacher_lse=tl)
    g = torch.tensor(0.7, device="cuda")
    ggot = kd_ops.flash_kd_head_bwd(h, w, b, z, want[1], want[2], g, tau)
    gwant = flash.flash_kd_head_bwd_tiled(h, w, b, z, want[1], want[2], g, tau)
    torch.cuda.synchronize()
    assert kernels.launches["flash_kd_head_fwd"] == fwd + 1
    assert kernels.launches["flash_kd_head_bwd"] == bwd + 1
    _check_flash_fwd(got, want, tau, 1e-4)
    _check_head_bwd(ggot, gwant, h, w, b, z, want[1], want[2], g, tau)


@pytest.mark.cuda
def test_flash_kd_losses_backward_through_the_kernels_on_card():
    """The autograd Functions on the card: one launch of each kernel per
    forward and backward, and a tied head's gradient lands in the
    embedding without a copy."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    h, w, _, z = _head_case(gen, 8, 32, 1000, torch.float32, torch.bfloat16, False, True)
    embed = w.T.contiguous().requires_grad_(True)
    hh = h.clone().requires_grad_(True)
    before = dict(kernels.launches)
    loss = kd_ops.flash_kd_head_loss(hh, embed.T, None, z, 4.0,
                                     teacher_lse=kd_ops.teacher_cache_lse(z, 4.0))
    loss.backward()
    s = (h @ embed.detach().T).requires_grad_(True)
    kd_ops.flash_kd_loss(s, z, 4.0).backward()
    torch.cuda.synchronize()
    for name in ("flash_kd_head_fwd", "flash_kd_head_bwd", "flash_kd_fwd", "flash_kd_bwd"):
        assert kernels.launches[name] == before.get(name, 0) + 1
    assert embed.grad.is_contiguous() and hh.grad.shape == h.shape
    assert bool(loss.isfinite()) and bool(s.grad.isfinite().all())


@pytest.mark.cuda
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
def test_flash_kd_head_bwd_bit_stable_on_card(mdtype):
    """Kernel 10 twice on the same inputs gives the same bits: its split-K
    partials of dh are summed in split order and chunks in order, with no
    atomics on data."""
    _needs_card()
    from repro_torch.kernels.kd_loss import flash
    B, D, V, tau = 300, 256, 20000, 4.0
    gen = torch.Generator(device="cuda").manual_seed(17)
    h, w, b, z = _head_case(gen, B, D, V, getattr(torch, mdtype), torch.bfloat16, True, True)
    _, lse_s, lse_t = flash.flash_kd_head_fwd_tiled(h, w, b, z, tau)
    g = torch.tensor(0.7, device="cuda")
    first = kd_ops.flash_kd_head_bwd(h, w, b, z, lse_s, lse_t, g, tau)
    second = kd_ops.flash_kd_head_bwd(h, w, b, z, lse_s, lse_t, g, tau)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
def test_flash_kd_head_fwd_bit_stable_on_card(mdtype, lse):
    """Kernel 9 twice on the same inputs gives the same bits: each row's
    (row, tile) states are merged in tile order, the rows' kl in row order,
    with no atomics on data."""
    _needs_card()
    B, D, V, tau = 300, 256, 20000, 4.0
    gen = torch.Generator(device="cuda").manual_seed(19)
    h, w, b, z = _head_case(gen, B, D, V, getattr(torch, mdtype), torch.bfloat16, True, True)
    tl = kd_ops.teacher_cache_lse(z, tau) if lse else None
    first = kd_ops.flash_kd_head_fwd(h, w, b, z, tau, teacher_lse=tl)
    second = kd_ops.flash_kd_head_fwd(h, w, b, z, tau, teacher_lse=tl)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def _in_fresh_thread(fn):
    """fn() on a new host thread, whose first CUDA work it is (as an autograd
    worker's can be): its tensors come from the caching allocator, so no
    runtime call has bound the device's context to the thread."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn()
            torch.cuda.synchronize()
        except Exception as e:                 # noqa: BLE001 (re-raised below)
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.mark.cuda
def test_tensor_map_kernels_launch_from_a_fresh_thread_on_card():
    """Kernels 9, 10 and 12 (bf16) encode TMA maps with cuTensorMapEncodeTiled,
    which needs a current context: launched from a thread that has none
    they give the bits they give on the main thread."""
    _needs_card()
    from repro_torch.kernels.kd_loss import flash
    gen = torch.Generator(device="cuda").manual_seed(3)
    h, w, _, z = _head_case(gen, 8, 32, 1000, torch.float32, torch.bfloat16, False, True)
    _, lse_s, lse_t = flash.flash_kd_head_fwd_tiled(h, w, None, z, 4.0)
    g = torch.tensor(1.0, device="cuda")
    q, k, v = (_randn(gen, (1, 256, n, 64), torch.bfloat16) for n in (4, 2, 2))
    calls = [lambda: kd_ops.flash_kd_head_fwd(h, w, None, z, 4.0),
             lambda: kd_ops.flash_kd_head_bwd(h, w, None, z, lse_s, lse_t, g, 4.0)[:2],
             lambda: (ops.flash_attention(q, k, v, True, 0),)]
    for call in calls:
        want = call()
        torch.cuda.synchronize()
        got = _in_fresh_thread(call)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_flash_kd_refuses_what_the_kernels_do_not_take_on_card():
    _needs_card()
    h = torch.zeros((2, 8), device="cuda")
    w = torch.zeros((8, 16), device="cuda")
    z = torch.zeros((2, 16), device="cuda")
    with pytest.raises(ValueError, match="one dtype"):
        kd_ops.flash_kd_head_fwd(h, w.to(torch.bfloat16), None, z)
    with pytest.raises(ValueError, match="row-major"):
        kd_ops.flash_kd_head_fwd(h, torch.zeros((8, 32), device="cuda")[:, ::2], None, z)
    with pytest.raises(ValueError, match="float16"):
        kd_ops.flash_kd_fwd(z.half(), z)
    with pytest.raises(ValueError, match="several devices"):
        kd_ops.flash_kd_fwd(z, z.cpu())


# ------------------------------------------------- flash attention 11-12
# the reference sweep (tests/test_kernels.py) and StableLM-3B's dh 80, a
# ragged Sq below one Pallas block, and Gemma's dh 256
FWD_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 1, 32), (2, 256, 4, 4, 128),
              (1, 384, 4, 4, 80), (1, 100, 2, 1, 80), (1, 256, 2, 1, 256)]
DECODE_SHAPES = [(2, 1024, 4, 2, 64), (1, 512, 8, 1, 32), (2, 512, 4, 4, 128),
                 (1, 1024, 4, 4, 80), (1, 2048, 8, 1, 256)]


def _flash_close(out, ref):
    if ref.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        out, ref = out.float(), ref.float()
        bound = _ulp(ref.abs().amax(-1, keepdim=True)) + 2e-5
        assert bool(((out - ref).abs() <= bound).all()), float((out - ref).abs().max())


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0), (False, 50)])
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_forward_matches_plain_on_card(dtype, causal, window, shape):
    _needs_card()
    B, S, H, Hkv, dh = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(S + H + window)
    q, k, v = (_randn(gen, (B, S, n, dh), dt) for n in (H, Hkv, Hkv))
    before = kernels.launches["flash_forward"]
    out = ops.flash_attention(q, k, v, causal, window)
    ref = ops.flash_forward_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernels.launches["flash_forward"] == before + 1
    assert out.dtype == dt and out.shape == q.shape
    _flash_close(out, ref)


@pytest.mark.cuda
def test_flash_forward_rows_without_a_key_on_card():
    """Sq > Skv + window: rows with no allowed key get what the Pallas
    kernel gives (the mean of V over the blocks it visits, or zeros)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = _randn(gen, (1, 384, 2, 64), torch.float32)
    k, v = (_randn(gen, (1, 128, 1, 64), torch.float32) for _ in range(2))
    for causal, window in ((True, 64), (False, 32)):
        _flash_close(ops.flash_attention(q, k, v, causal, window),
                     ops.flash_forward_ref(q, k, v, causal=causal, window=window))


@pytest.mark.cuda
def test_flash_attention_grads_match_plain_on_card():
    """The backward recomputes through the plain ``attention`` (there is no
    backward kernel), so the kernel's forward enters the gradients only
    through ``g = 2·out``; this checks that path and the single launch."""
    _needs_card()
    from repro_torch.models.attention import attention
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (_randn(gen, (1, 256, n, 64), torch.float32) for n in (4, 2, 2))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = kernels.launches["flash_forward"]
    (ops.flash_attention(*qkv, True, 64) ** 2).sum().backward()
    assert kernels.launches["flash_forward"] == before + 1
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (attention(*ref, causal=True, window=64) ** 2).sum().backward()
    for a, b in zip(qkv, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_decode_matches_plain_on_card(dtype, shape):
    _needs_card()
    B, S, H, Hkv, dh = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(S + H)
    q = _randn(gen, (B, 1, H, dh), dt)
    k, v = (_randn(gen, (B, S, Hkv, dh), dt) for _ in range(2))
    for clen in (0, 1, 700, S - 1, S):
        ref = ops.flash_decode_ref(q, k, v, clen)
        for cache_len in (clen, torch.tensor(clen, device="cuda")):
            before = kernels.launches["flash_decode"]
            out = ops.flash_decode(q, k, v, cache_len)
            torch.cuda.synchronize()
            assert kernels.launches["flash_decode"] == before + 1
            _flash_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 8192, 40, 8, 128), (1, 4096, 16, 1, 256),
                                   (2, 4096, 24, 2, 128)], ids=lambda s: "x".join(map(str, s)))
def test_flash_decode_splitk_on_card(dtype, shape):
    """Kernel 11 on the split-K body: qwen2.5-14b's heads (G 5), G 16 at dh
    256 (two row groups) and starcoder2-3b's G 12, at cache lengths that
    end inside, on and past a chunk, and none (the mean of V); one launch
    a call, and two calls give the same bits (the last-arriving CTA merges
    in split order)."""
    _needs_card()
    B, S, H, Hkv, dh = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(S + H + dh)
    q = _randn(gen, (B, 1, H, dh), dt)
    k, v = (_randn(gen, (B, S, Hkv, dh), dt) for _ in range(2))
    assert ops.decode_plan(q, k, S)["splits"] > 1
    for clen in (-3, 0, 1, 129, S // 3, S - 1, S):
        before = kernels.launches["flash_decode"]
        out = ops.flash_decode(q, k, v, clen)
        again = ops.flash_decode(q, k, v, clen)
        torch.cuda.synchronize()
        assert kernels.launches["flash_decode"] == before + 2
        _flash_close(out, ops.flash_decode_ref(q, k, v, clen))
        assert torch.equal(out, again)


@pytest.mark.cuda
def test_flash_attention_refuses_what_the_kernels_do_not_take_on_card():
    _needs_card()
    z = torch.zeros((1, 256, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(z[:, :200].contiguous(), z[:, :200].contiguous(),
                            z[:, :200].contiguous())
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(z[..., :48].contiguous(), z[..., :48].contiguous(),
                            z[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(z.transpose(1, 2), z.transpose(1, 2), z.transpose(1, 2))
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_attention(z.half(), z.half(), z.half())
    q1 = torch.zeros((1, 1, 34, 64), device="cuda")
    kc = torch.zeros((1, 512, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="per KV head"):
        ops.flash_decode(q1, kc, kc, 10)
    kc700 = torch.zeros((1, 700, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_decode(q1[:, :, :2].contiguous(), kc700, kc700, 10)
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_decode(q1[:, :, :2].contiguous(), kc.cpu(), kc, 3)
    with pytest.raises(TypeError):                      # cache_len is an integer
        ops.flash_decode(q1[:, :, :2].contiguous(), kc, kc, 3.0)
