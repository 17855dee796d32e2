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
allowed key, ``cache_len <= 0``) complete that part.  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.

Three emulations in plain torch stand for what the CUDA kernels compute
differently from their plain versions.  Kernel 1 (``paged_decode``):
its host split of each row's live range into chunks and the in-order
merge of the chunks' (m, l, acc) partials, held against
``paged_decode_ref`` and the Pallas kernel at f32 rtol = atol = 1e-5
(only the order of summation differs).  Kernel 11 (``flash_decode``,
which now runs kernel 1's split-K body over a contiguous cache): the
same partition in whole 32-position tiles and merge, with
``cache_len <= 0`` as its own branch (every position scores NEG_INF),
held against ``flash_decode_ref`` and the Pallas kernel at the sweep's
f32 atol.  Kernel 12 (``flash_attention``
in bf16, the ``wgmma`` kernel): Q·Kᵀ from the unscaled bf16 inputs with
the scale after, P split into bf16 hi and lo for P·V, held against the
plain version and the Pallas kernel at the bf16 rule above.
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


# =====================================================================
# kernel 1's split-K partition and merge, emulated in plain torch
# =====================================================================
def _paged_splitk(q1, k_pool, v_pool, bt, sl, window, *, merge_empty=False):
    """What ``csrc/paged_decode.cu`` computes, in f32: the host's split of
    each row's live range [lo, hi) into ``chunk``-position partials (m, l,
    acc), merged in split order with weights exp(m_c - M).  A row with no
    live position is zeros.  ``merge_empty`` also merges the empty partials
    (m = NEG_INF, l = 0, acc = 0) of the splits past the row's end, which
    the kernel skips: they must weigh exactly 0."""
    plan = ops.paged_plan(q1, k_pool, bt, window)
    chunk, splits = plan["chunk"], plan["splits"]
    B, _, H, dh = q1.shape
    nb, bs, Hkv, _ = k_pool.shape
    nbmax, G = bt.shape[1], H // Hkv
    qg = q1.reshape(B, Hkv, G, dh).float() * dh ** -0.5
    kf, vf = k_pool.reshape(nb * bs, Hkv, dh).float(), v_pool.reshape(nb * bs, Hkv, dh).float()
    out = torch.zeros((B, Hkv, G, dh))
    for b in range(B):
        n = int(sl[b])
        lo, hi = (max(0, n - window) if window > 0 else 0), min(n, nbmax * bs)
        n_live = -(-max(0, hi - lo) // chunk)
        assert n_live <= splits
        parts = []
        for c in range(splits if merge_empty else n_live):
            p0, p1 = lo + c * chunk, min(lo + (c + 1) * chunk, hi)
            if p0 >= p1:
                parts.append((torch.full((Hkv, G), NEG_INF), torch.zeros((Hkv, G)),
                              torch.zeros((Hkv, G, dh))))
                continue
            pos = torch.arange(p0, p1)
            slots = bt[b].long()[pos // bs] * bs + pos % bs
            s = torch.einsum("hgd,nhd->hgn", qg[b], kf[slots])
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgn,nhd->hgd", p, vf[slots])))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L, A = torch.zeros((Hkv, G)), torch.zeros((Hkv, G, dh))
        for m, l_c, a in parts:
            w = torch.exp(m - M)
            L, A = L + l_c * w, A + a * w[..., None]
        out[b] = A / L.clamp(min=1e-30)[..., None]
    return out.reshape(B, 1, H, dh).to(q1.dtype)


NEG_INF = -1e30
# (nbmax, window, lens) at bs 16, B = 8, Hkv 2, G 3: seq_len 0, 1 and 16k ± 1;
# lengths on a split boundary (chunk 128 here); nbmax·bs far above every
# length (empty splits); windows (chunk 144) whose lo falls inside a block, rows whose
# first blocks lie wholly before the window (the Pallas kernel visits
# them with p = 1 until a real score resets its sum)
PAGED_SPLIT_CASES = [
    (40, 0, [0, 1, 15, 17, 128, 256, 257, 640]),
    (40, 260, [0, 1, 15, 17, 128, 256, 300, 640]),
    (200, 0, [0, 1, 33, 129, 300, 511, 512, 513]),
    (64, 300, [0, 1, 299, 300, 301, 777, 1000, 1024]),
    (64, 272, [0, 17, 143, 144, 145, 288, 289, 1023]),
]


def _paged_split_case(seed, nbmax, lens, Hkv=2, G=3, dh=32, bs=16):
    """A shuffled pool: request b's blocks are distinct pool blocks, the
    rest of its table points at block 0 (as the engine leaves it)."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    need = [-(-n // bs) for n in lens]
    nb = 1 + sum(need)
    ids = 1 + rng.permutation(nb - 1)
    bt = np.zeros((B, nbmax), np.int32)
    at = 0
    for b, n in enumerate(need):
        bt[b, :n] = ids[at:at + n]
        at += n
    q = rng.normal(0, 1, (B, 1, Hkv * G, dh)).astype(np.float32)
    pk = rng.normal(0, 1, (nb, bs, Hkv, dh)).astype(np.float32)
    pv = rng.normal(0, 1, (nb, bs, Hkv, dh)).astype(np.float32)
    return q, pk, pv, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("nbmax,window,lens", PAGED_SPLIT_CASES,
                         ids=lambda x: str(x) if not isinstance(x, list) else "lens")
def test_paged_splitk_matches_plain_and_pallas_interpret(nbmax, window, lens, force_pallas):
    args = _paged_split_case(nbmax + window, nbmax, lens)
    targs = [torch.from_numpy(a) for a in args]
    plan = ops.paged_plan(targs[0], targs[1], targs[3], window)
    assert plan["splits"] > 1                       # the merge is exercised
    got = _paged_splitk(*targs, window)
    torch.testing.assert_close(got, ops.paged_decode_ref(*targs, window=window),
                               rtol=1e-5, atol=1e-5)
    want = jax_ops.paged_decode(*map(jnp.asarray, args), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[np.asarray(lens) == 0].any()     # seq_len 0: zeros


@pytest.mark.parametrize("nbmax,window,lens", PAGED_SPLIT_CASES[:3],
                         ids=lambda x: str(x) if not isinstance(x, list) else "lens")
def test_paged_splitk_empty_partials_weigh_nothing(nbmax, window, lens):
    """Merging the empty partials (m = NEG_INF) beside the live ones changes
    no bit: exp(NEG_INF - M) is 0 beside a real score."""
    targs = [torch.from_numpy(a) for a in _paged_split_case(7, nbmax, lens)]
    torch.testing.assert_close(_paged_splitk(*targs, window, merge_empty=True),
                               _paged_splitk(*targs, window), rtol=0, atol=0)


def test_paged_split_plan_reads_only_shapes():
    """The host's choice takes shapes alone: it runs on tensors of the
    `meta` device (which hold no values) and gives the CPU tensors' plan."""
    args = [torch.from_numpy(a) for a in _paged_split_case(0, 40, [0, 1, 15, 17, 128, 256,
                                                                   257, 640])]
    for window in (0, 100, 5000):
        plan = ops.paged_plan(args[0], args[1], args[3], window)
        meta = ops.paged_plan(*(t.to("meta") for t in (args[0], args[1], args[3])), window)
        assert plan == meta


@pytest.mark.parametrize("rows,span,bs", [(16, 20512, 16), (16, 4096, 16), (64, 576, 16),
                                          (256, 2048, 16), (1, 16, 16), (64, 1, 16),
                                          (8, 1000, 8), (600, 32768, 16), (1, 65536, 16)])
def test_paged_splits_cover_the_span_in_whole_blocks(rows, span, bs):
    chunk, splits = ops.paged_splits(rows, span, bs)
    assert chunk % bs == 0 and splits >= 1
    assert (splits - 1) * chunk < max(span, 1) <= splits * chunk
    assert splits == 1 or chunk >= ops._PAGED_CHUNK_MIN
    assert splits <= ops._PAGED_MAX_SPLITS
    assert rows * splits <= max(rows, 2 * ops._PAGED_CTAS)


@pytest.mark.parametrize("G,dh,want", [(1, 80, (1, 1)), (5, 128, (8, 1)), (12, 128, (12, 1)),
                                       (8, 256, (8, 1)), (16, 256, (8, 2)), (9, 256, (8, 2)),
                                       (16, 32, (16, 1)), (3, 64, (4, 1)), (13, 128, (16, 1))])
def test_paged_groups_fit_the_kernel(G, dh, want):
    assert ops.paged_groups(G, dh) == want


# =====================================================================
# kernel 11's split-K partition and merge (kernel 1's body), emulated
# =====================================================================
def _decode_splitk(q1, k, v, cache_len, resident=4):
    """What ``csrc/flash_attention.cu`` computes for ``flash_decode`` with
    the split-K body of ``csrc/decode_splitk.cuh``, in f32: the host's plan
    (whole 32-position tiles, ``resident`` CTAs a SM), a partial (m, l, acc)
    per live chunk of [0, min(cache_len, S)), merged in split order with
    weights exp(m_c - M).  ``cache_len <= 0`` is its own branch: every
    position of the cache is live and scores NEG_INF (p = 1)."""
    plan = ops.decode_plan(q1, k, cache_len, resident)
    chunk, splits = plan["chunk"], plan["splits"]
    B, _, H, dh = q1.shape
    _, S, Hkv, _ = k.shape
    G = H // Hkv
    qg = q1.reshape(B, Hkv, G, dh).float() * dh ** -0.5
    none = cache_len <= 0
    hi = S if none else min(cache_len, S)
    n_live = -(-hi // chunk)
    assert n_live <= splits
    parts = []
    for c in range(n_live):
        p0, p1 = c * chunk, min((c + 1) * chunk, hi)
        s = torch.einsum("bhgd,bkhd->bhgk", qg, k[:, p0:p1].float())
        if none:
            s = torch.full_like(s, NEG_INF)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bhgk,bkhd->bhgd", p, v[:, p0:p1].float())))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L, A = torch.zeros_like(M), torch.zeros((B, Hkv, G, dh))
    for m, l_c, a in parts:
        w = torch.exp(m - M)
        L, A = L + l_c * w, A + a * w[..., None]
    return (A / L.clamp(min=1e-30)[..., None]).reshape(B, 1, H, dh).to(q1.dtype)


@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("clen", [-3, 0, 1, 700, 1023, 1024])
def test_decode_splitk_matches_plain_and_pallas_interpret(G, clen, force_pallas):
    """Kernel 11's split-K over a contiguous cache (G rows a KV head,
    qwen2.5-14b's 5 among them) at cache lengths with no valid position,
    one, inside a chunk, S - 1 and S: f32 at the sweep's atol against the
    plain version and the Pallas kernel."""
    B, S, Hkv, dh = 2, 1024, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(G * 31 + clen, _decode_shapes(B, S, G * Hkv, Hkv, dh),
                                      "float32")
    got = _decode_splitk(q, k, v, clen)
    if clen != 1:                                         # one live tile: no merge
        assert ops.decode_plan(q, k, clen)["splits"] > 1  # the merge is exercised
    _close(got, ops.flash_decode_ref(q, k, v, clen), "float32")
    _close(got, jax_ops.flash_decode(jq, jk, jv, jnp.int32(clen)), "float32")
    if clen <= 0:                                         # the mean of V over all S
        torch.testing.assert_close(got, v.mean(1).repeat_interleave(G, 1)[:, None],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("resident", [1, 3, 5, 8])
def test_decode_splitk_plan_fills_one_wave(resident):
    """The host's plan for kernel 11 reads shapes and the host int alone
    (it runs on `meta` tensors), covers the valid positions in whole tiles
    and launches no more CTAs than the card holds at once (``resident`` a
    SM on 132 SMs), so no second wave runs a few CTAs alone."""
    for B, S, H, Hkv, dh, clen in [(8, 32768, 40, 8, 128, 32768), (8, 4096, 8, 8, 64, 4096),
                                   (1, 2048, 16, 1, 256, 0), (2, 1024, 10, 2, 64, 700),
                                   (64, 512, 8, 8, 64, 1)]:
        q = torch.empty((B, 1, H, dh), device="meta")
        k = torch.empty((B, S, Hkv, dh), device="meta")
        plan = ops.decode_plan(q, k, clen, resident)
        live = S if clen <= 0 else min(clen, S)
        assert plan["chunk"] % 32 == 0
        assert (plan["splits"] - 1) * plan["chunk"] < live <= plan["splits"] * plan["chunk"]
        assert plan["rows"] * plan["splits"] <= max(plan["rows"], resident * 132)
        assert plan["gb"] >= min(plan["G"], 8 if dh == 256 else 16)
    assert ops.decode_plan(torch.empty((8, 1, 40, 128), device="meta"),
                           torch.empty((8, 32768, 8, 128), device="meta"), 32768, 5)["gb"] == 5


# =====================================================================
# kernel 12's bf16 arithmetic (the wgmma kernel), emulated in plain torch
# =====================================================================
def _flash_bf16_emulation(q, k, v, causal, window):
    """What the bf16 path of ``csrc/flash_attention.cu`` computes: per
    128-row query tile, the 64-key tiles of the Pallas band; S = Q·Kᵀ from
    the unscaled bf16 inputs in f32, scaled by dh^-0.5 after; the online
    (m, l) in f32; O += P_hi·V + P_lo·V with P_hi = bf16(p), P_lo =
    bf16(p - P_hi); the output rounded once."""
    qb, kb = ops._fwd_tiles(q, k, v)
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)     # (B, H, Skv, dh)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    qf = q.float().permute(0, 2, 1, 3)
    out = torch.empty((B, H, Sq, dh))
    for q0 in range(0, Sq, 128):
        rows = torch.arange(q0, min(q0 + 128, Sq))
        iq = q0 // qb
        lo_p, hi_p = 0, Skv // kb - 1
        if causal:
            hi_p = min(hi_p, (iq * qb + qb - 1) // kb)
        if window > 0 and iq * qb - window + 1 > 0:
            lo_p = (iq * qb - window + 1) // kb
        m = torch.full((B, H, len(rows)), NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), dh))
        for k0 in range(lo_p * kb, min(Skv, (hi_p + 1) * kb), 64):
            keys = torch.arange(k0, k0 + 64)
            kin = keys < Skv
            kt, vt = kf[:, :, keys.clamp(max=Skv - 1)], vf[:, :, keys.clamp(max=Skv - 1)]
            s = (qf[:, :, rows] @ kt.transpose(-1, -2)) * scale
            rel = rows[:, None] - keys[None, :]
            bad = torch.zeros_like(rel, dtype=torch.bool)
            if causal:
                bad |= rel < 0
            if window > 0:
                bad |= rel >= window
            s = torch.where(bad, NEG_INF, s)
            s = torch.where(kin, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float()
            vt = torch.where(kin[:, None], vt, 0.0)
            acc = acc * corr[..., None] + hi @ vt + lo @ vt
            m = m_new
        out[:, :, rows] = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("amp", [1.0, 3.0])
@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_bf16_kernel_arithmetic_within_the_bf16_rule(shape, causal, window, amp,
                                                           force_pallas):
    """The wgmma kernel's arithmetic against the plain version and the
    Pallas kernel in interpret mode, at the bf16 rule of phase 15's
    ``fa_close`` (one bf16 ulp of each row's max plus 2e-5)."""
    rng = np.random.default_rng(sum(shape) + window + int(amp))
    arrs = [(rng.normal(0, 1, s) * amp).astype(np.float32) for s in _fwd_shapes(*shape)]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = _flash_bf16_emulation(q, k, v, causal, window)
    assert got.dtype == torch.bfloat16
    _close(got, ops.flash_forward_ref(q, k, v, causal=causal, window=window).float().numpy(),
           "bfloat16")
    want = jax_ops.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrs),
                                   causal, window)
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("Sq,Skv,causal,window", [(384, 128, True, 64), (256, 100, True, 20)])
def test_flash_bf16_kernel_arithmetic_rows_without_a_key(Sq, Skv, causal, window):
    """Rows with no allowed key in the visited blocks: NEG_INF scores give
    p = 1, so the emulated kernel averages V over those blocks as the plain
    version does."""
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(torch.bfloat16)
               for s in [(1, Sq, 2, 64), (1, Skv, 1, 64), (1, Skv, 1, 64)])
    _close(_flash_bf16_emulation(q, k, v, causal, window),
           ops.flash_forward_ref(q, k, v, causal=causal, window=window).float().numpy(),
           "bfloat16")
