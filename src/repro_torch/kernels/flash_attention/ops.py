"""Flash attention, flash decode and paged decode: the Hopper kernels and
their plain versions (port of ``repro/kernels/flash_attention/ops.py``).

Each op keeps the reference's signature and layouts.  For CUDA tensors it
launches its kernel or raises (``csrc/flash_attention.cu`` for
``flash_attention`` / ``flash_decode``, ``csrc/paged_decode.cu`` for
``paged_decode``); for CPU tensors it runs the plain version the tests and
the on-card check hold the kernel against.

The plain versions compute what the Pallas kernels compute, which is not
quite the reference's XLA fallback: q is scaled after the cast to f32, the
probabilities stay in f32 for P·V and only the output is rounded.  Masked
scores are NEG_INF = -1e30, not -inf, so a query row with no allowed key
in the tiles the Pallas kernel visits averages V over those tiles, and
``flash_decode`` with ``cache_len <= 0`` returns the mean of V over the
whole cache; the plain versions and the kernels reproduce both.
"""
from __future__ import annotations

import ctypes
import operator

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.models.attention import NEG_INF, attention, decode_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 128, 256)
_MAX_G = 16
FWD_TILE = 128           # the Pallas kernel's q and kv blocks (kernel.py:32-33)
DECODE_TILE = 512        # the Pallas flash_decode's kv block (kernel.py:151)
_PLAIN_SCORE_ELEMS = 2 ** 27     # f32 scores one plain-forward chunk holds
_SM_COUNT = 132          # H100 SXM; the split-K launches aim at a few CTAs per SM


def _device(name: str, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


# =====================================================================
# flash attention forward (kernel 12)
# =====================================================================
def _fwd_tiles(q, k, v) -> tuple[int, int]:
    """The Pallas kernel's (qb, kb) for these shapes, raising where its
    wrapper asserts (kernel.py:91-96)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want (B,Sq,H,dh) and (B,Skv,Hkv,dh)")
    B, Sq, H, dh = q.shape
    Bk, Skv, Hkv, dhk = k.shape
    if Bk != B or dhk != dh or Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree")
    qb, kb = min(FWD_TILE, Sq), min(FWD_TILE, Skv)
    if Sq % qb or Skv % kb:
        raise ValueError(f"flash_attention: Sq {Sq} and Skv {Skv} must be at most "
                         f"{FWD_TILE} or multiples of it (the Pallas kernel's blocks)")
    return qb, kb


def flash_forward_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain version of the Pallas ``flash_forward``: q (B,Sq,H,dh), k/v
    (B,Skv,Hkv,dh) -> (B,Sq,H,dh) in q's dtype.

    Dense over the keys, in chunks of query rows.  A score the band masks
    is NEG_INF inside the (qb, kb) tiles the Pallas grid computes and
    contributes nothing outside them, which is what the kernel's online
    softmax gives: exactly the masked softmax for every row with an
    allowed key.
    """
    qb, kb = _fwd_tiles(q, k, v)
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    dev = q.device
    kf = k.float().permute(0, 2, 1, 3)                      # (B,Hkv,Skv,dh)
    vf = v.float().permute(0, 2, 1, 3)
    k_pos = torch.arange(Skv, device=dev)
    k_tile = k_pos // kb
    chunk = max(qb, _PLAIN_SCORE_ELEMS // max(1, B * H * Skv) // qb * qb)
    outs = []
    for q0 in range(0, Sq, chunk):
        n = min(chunk, Sq - q0)
        qc = (q[:, q0:q0 + n].float() * dh ** -0.5).reshape(B, n, Hkv, G, dh)
        s = torch.einsum("bqhgd,bhkd->bhgqk", qc, kf)       # (B,Hkv,G,n,Skv)
        q_pos = q0 + torch.arange(n, device=dev)
        q_tile = q_pos // qb
        rel = q_pos[:, None] - k_pos[None, :]
        ok = torch.ones((n, Skv), dtype=torch.bool, device=dev)
        visited = torch.ones((n, Skv), dtype=torch.bool, device=dev)
        if causal:
            ok &= rel >= 0
            visited &= (k_tile * kb)[None, :] <= (q_tile * qb + qb - 1)[:, None]
        if window > 0:
            ok &= rel < window
            visited &= ((k_tile + 1) * kb - 1)[None, :] > (q_tile * qb - window)[:, None]
        s = torch.where(ok, s, torch.where(visited, NEG_INF, float("-inf")))
        m = s.amax(-1, keepdim=True).clamp(min=NEG_INF)
        p = torch.exp(s - m)
        o = torch.einsum("bhgqk,bhkd->bqhgd", p, vf)
        l = p.sum(-1).permute(0, 3, 1, 2)[..., None]          # (B,n,Hkv,G,1)
        outs.append((o / l.clamp(min=1e-30)).reshape(B, n, H, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def _forward(q, k, v, causal: bool, window: int):
    dev = _device("flash_attention", q, k, v)
    if dev.type == "cpu":
        return flash_forward_ref(q, k, v, causal=causal, window=window)
    return _launch_forward(q, k, v, causal, window)


class _FlashAttention(torch.autograd.Function):
    """Forward through kernel 12 (or its plain version on the CPU);
    backward recomputes through the plain chunked ``attention``, as the
    reference's custom_vjp does (ops.py:58-69): there is no backward
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention(*qkv, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B,Sq,H,dh); k,v (B,Skv,Hkv,dh) -> (B,Sq,H,dh)."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))


# =====================================================================
# flash decode (kernel 11)
# =====================================================================
def _decode_shapes(q1, k_cache, v_cache) -> None:
    if q1.ndim != 4 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"flash_decode: q1 {tuple(q1.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    B, one, H, dh = q1.shape
    Bk, S, Hkv, dhk = k_cache.shape
    if one != 1 or Bk != B or dhk != dh or Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_decode: q1 {tuple(q1.shape)} and caches "
                         f"{tuple(k_cache.shape)} disagree")
    if S % min(DECODE_TILE, S):
        raise ValueError(f"flash_decode: cache length {S} must be at most "
                         f"{DECODE_TILE} or a multiple of it (the Pallas kernel's block)")


def flash_decode_ref(q1, k_cache, v_cache, cache_len):
    """Plain version of the Pallas ``flash_decode``: q1 (B,1,H,dh), caches
    (B,S,Hkv,dh), an int ``cache_len`` -> (B,1,H,dh).  Positions at or
    past ``cache_len`` score NEG_INF, so ``cache_len <= 0`` gives the mean
    of V over all S, as the kernel does."""
    _decode_shapes(q1, k_cache, v_cache)
    B, _, H, dh = q1.shape
    _, S, Hkv, _ = k_cache.shape
    qg = q1.reshape(B, Hkv, H // Hkv, dh).float() * dh ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    valid = torch.arange(S, device=q1.device) < cache_len
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, dh).to(q1.dtype)


def flash_decode(q1, k_cache, v_cache, cache_len):
    """q1 (B,1,H,dh); caches (B,S,Hkv,dh); cache_len an int -> (B,1,H,dh).
    A one-element integer tensor is read to the host as its int."""
    cache_len = operator.index(cache_len)
    if _device("flash_decode", q1, k_cache, v_cache).type == "cpu":
        return flash_decode_ref(q1, k_cache, v_cache, cache_len)
    return _launch_decode(q1, k_cache, v_cache, cache_len)


# =====================================================================
# paged decode (kernel 1)
# =====================================================================


def paged_decode_ref(q1, k_pool, v_pool, block_tables, seq_lens, *,
                     window: int = 0):
    """Plain version: gather each request's blocks into a contiguous view
    and run ``decode_attention``.  Rows with ``seq_lens == 0`` return
    zeros, as the kernel (and the reference's Pallas kernel) does; the
    reference's own gather fallback would return a uniform average there.
    """
    B, _, H, dh = q1.shape
    nb, bs, Hkv, _ = k_pool.shape
    nbmax = block_tables.shape[1]
    bt = block_tables.long()
    kg = k_pool[bt].reshape(B, nbmax * bs, Hkv, dh)
    vg = v_pool[bt].reshape(B, nbmax * bs, Hkv, dh)
    out = decode_attention(q1, kg, vg, seq_lens, window=window)
    return torch.where((seq_lens > 0)[:, None, None, None], out, 0)


def paged_decode(q1, k_pool, v_pool, block_tables, seq_lens, *,
                 window: int = 0):
    """Decode attention through a paged KV pool.

    q1 (B,1,H,dh); pools (nb,bs,Hkv,dh) — ONE pool shared by all requests;
    block_tables (B,nbmax) int32 maps request-local block j to pool block
    ``block_tables[b, j]``; seq_lens (B,) int32 valid lengths (0 = inactive
    slot: its row is zeros).  Returns (B,1,H,dh) in q1's dtype.
    """
    dev = _device("paged_decode", q1, k_pool, v_pool, block_tables, seq_lens)
    if dev.type == "cpu":
        return paged_decode_ref(q1, k_pool, v_pool, block_tables, seq_lens,
                                window=window)
    return _launch(q1, k_pool, v_pool, block_tables, seq_lens, window)


_PAGED_CTAS = 4 * _SM_COUNT  # the split aims at four CTAs per SM in all
_PAGED_CHUNK_MIN = 128       # positions per split-K CTA at least (four tiles of 32)
_PAGED_MAX_SPLITS = 128      # the kernel's kMaxSplits
_PAGED_GB = (1, 2, 4, 8, 12, 16)   # query rows per CTA the kernel is built for


def paged_groups(G: int, dh: int, sizes: tuple = _PAGED_GB) -> tuple[int, int]:
    """(gb, ng): the kernel's query rows per CTA (the smallest of ``sizes``
    that holds G, since rows past G are computed all the same; at most 8 at
    dh 256, where the accumulators of more rows would not fit the
    registers) and the CTAs ``ng = ceil(G / gb)`` that share one (request,
    KV head) and split."""
    cap = 8 if dh == 256 else 16
    gb = next((g for g in sizes if g >= min(G, cap)), cap)
    return gb, -(-G // gb)


def paged_splits(rows: int, span: int, bs: int) -> tuple[int, int]:
    """(chunk, splits) of kernel 1's split-K, from shapes alone: ``rows``
    CTAs' worth of (request, KV head, row group) triples, each walking at
    most ``span`` positions (``nbmax·bs``, or the window when it is
    shorter), in chunks of whole pool blocks of ``bs`` positions, aiming at
    ``_PAGED_CTAS`` CTAs in all with at least ``_PAGED_CHUNK_MIN``
    positions each.  Never reads ``seq_lens``: a CTA whose chunk starts past
    its row's end exits."""
    blocks = max(1, -(-span // bs))
    want = min(_PAGED_MAX_SPLITS, max(1, -(-_PAGED_CTAS // rows)))
    splits = max(1, min(want, blocks // max(1, _PAGED_CHUNK_MIN // bs)))
    chunk_blocks = -(-blocks // splits)
    return chunk_blocks * bs, -(-blocks // chunk_blocks)


def paged_plan(q1, k_pool, block_tables, window: int) -> dict:
    """Kernel 1's launch shape for these inputs: the row groups, the split
    and the workspace, from the tensors' shapes only (no device read)."""
    B, _, H, dh = q1.shape
    _, bs, Hkv, _ = k_pool.shape
    nbmax = block_tables.shape[1]
    G = H // Hkv
    gb, ng = paged_groups(G, dh)
    span = min(window, nbmax * bs) if window > 0 else nbmax * bs
    rows = B * Hkv * ng
    chunk, splits = paged_splits(rows, span, bs)
    return {"G": G, "gb": gb, "ng": ng, "rows": rows, "chunk": chunk, "splits": splits,
            "part_floats": rows * splits * gb * (dh + 2) if splits > 1 else 0}


_COUNTERS: dict = {}


def _arrival_counters(device, stream: int, rows: int) -> torch.Tensor:
    """The split-K decode's per-row arrival counters on this device and
    stream (kernels 1 and 11 share them): zeroed once here, and reset to 0
    by the CTA that merges each row, so they stay zero between launches."""
    key = (device, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < rows:
        cnt = _COUNTERS[key] = torch.zeros(rows, dtype=torch.int32, device=device)
    return cnt


def _launch(q1, k_pool, v_pool, block_tables, seq_lens, window):
    B, one, H, dh = q1.shape
    nb, bs, Hkv, dh_pool = k_pool.shape
    if one != 1 or dh_pool != dh or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"paged_decode: q1 {tuple(q1.shape)} and pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} disagree")
    if H % Hkv or not 1 <= H // Hkv <= _MAX_G:
        raise ValueError(f"paged_decode: {H} query heads over {Hkv} KV heads "
                         f"(the kernel takes 1..{_MAX_G} per KV head)")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {dh} not in {_HEAD_DIMS}")
    if q1.dtype not in _DTYPES or k_pool.dtype != q1.dtype or v_pool.dtype != q1.dtype:
        raise ValueError(f"paged_decode: dtypes {q1.dtype}/{k_pool.dtype}/"
                         f"{v_pool.dtype}; the kernel takes one of f32, bf16")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged_decode: block_tables and seq_lens must be int32")
    if block_tables.ndim != 2 or block_tables.shape[0] != B or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_decode: block_tables {tuple(block_tables.shape)}"
                         f" / seq_lens {tuple(seq_lens.shape)} for batch {B}")
    for name, t in (("q1", q1), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode: pools must be 16-byte aligned "
                         "(the kernel stages K/V rows with 16-byte copies)")
    plan = paged_plan(q1, k_pool, block_tables, int(window))
    if plan["rows"] > 65535:
        raise ValueError(f"paged_decode: {plan['rows']} (request, KV head, row group) "
                         f"triples exceed the grid's 65,535")
    lib = _lib()
    out = torch.empty_like(q1)
    stream = torch.cuda.current_stream(q1.device).cuda_stream
    part = cnt = None
    if plan["splits"] > 1:
        part = torch.empty((plan["part_floats"],), dtype=torch.float32, device=q1.device)
        cnt = _arrival_counters(q1.device, stream, plan["rows"])
    code = lib.paged_decode(
        q1.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), None if cnt is None else cnt.data_ptr(),
        B, Hkv, plan["G"], dh, plan["gb"], bs, block_tables.shape[1], int(window),
        plan["chunk"], plan["splits"], _DTYPES[q1.dtype], stream)
    build.check(lib, code, "paged_decode")
    kernels.count("paged_decode", q1.device)
    return out


def _lib():
    lib = build.load("paged_decode")
    if lib.paged_decode.argtypes is None:
        lib.paged_decode.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                                     + [ctypes.c_void_p])
        lib.paged_decode.restype = ctypes.c_int
    return lib


# =====================================================================
# launches of csrc/flash_attention.cu
# =====================================================================
def _check_common(name: str, tensors: dict, dh: int) -> None:
    first = next(iter(tensors.values()))
    if dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {_HEAD_DIMS}")
    if first.dtype not in _DTYPES or any(t.dtype != first.dtype for t in tensors.values()):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors.values()]}; "
                         f"the kernel takes one of f32, bf16 for all inputs")
    for label, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def _launch_forward(q, k, v, causal: bool, window: int):
    qb, kb = _fwd_tiles(q, k, v)
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    _check_common("flash_attention", {"q": q, "k": k, "v": v}, dh)
    lib = _flash_lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             B, Sq, Skv, H, Hkv, dh, int(causal), int(window), qb, kb,
                             _DTYPES[q.dtype], stream)
    build.check(lib, code, "flash_forward")
    kernels.count("flash_forward", q.device)
    return out


_DECODE_TILE = 32        # the split-K body's positions per pipeline stage
_DECODE_GB = (1, 2, 4, 5, 8, 12, 16)   # kernel 11's query rows per CTA (5: qwen2.5-14b)


def decode_splits(rows: int, live: int, resident: int = 4) -> tuple[int, int]:
    """(chunk, splits) of kernel 11's split-K over the ``live`` >= 1 leading
    cache positions for ``rows`` = B·Hkv·ng CTA rows: as many CTAs as the
    card holds at once (``resident`` a SM, from the instance's occupancy),
    so that no second wave runs a few CTAs alone; whole 32-position tiles,
    at least ``_PAGED_CHUNK_MIN`` positions a split when split."""
    tiles = max(1, -(-live // _DECODE_TILE))
    want = max(1, min(_PAGED_MAX_SPLITS, resident * _SM_COUNT // rows))
    splits = max(1, min(want, tiles // max(1, _PAGED_CHUNK_MIN // _DECODE_TILE)))
    chunk_tiles = -(-tiles // splits)
    return chunk_tiles * _DECODE_TILE, -(-tiles // chunk_tiles)


def decode_plan(q1, k_cache, cache_len: int, resident: int = 4) -> dict:
    """Kernel 11's launch shape: kernel 1's row groups (with 5 rows a CTA
    too) and the split over the valid positions (all S when ``cache_len <=
    0``), from the shapes, the host int ``cache_len`` and the instance's
    ``resident`` CTAs a SM alone."""
    B, _, H, dh = q1.shape
    _, S, Hkv, _ = k_cache.shape
    G = H // Hkv
    gb, ng = paged_groups(G, dh, _DECODE_GB)
    rows = B * Hkv * ng
    live = S if cache_len <= 0 else min(cache_len, S)
    chunk, splits = decode_splits(rows, live, resident)
    return {"G": G, "gb": gb, "ng": ng, "rows": rows, "chunk": chunk, "splits": splits,
            "part_floats": rows * splits * gb * (dh + 2) if splits > 1 else 0}


_RESIDENT: dict = {}


def _resident(lib, dtype: int, dh: int, gb: int) -> int:
    """CTAs of kernel 11's instance one SM holds (the occupancy API, asked
    once per instance)."""
    key = (dtype, dh, gb)
    if key not in _RESIDENT:
        n = lib.flash_decode_resident(dtype, dh, gb)
        if n < 1:
            raise RuntimeError(f"flash_decode: no resident CTA for {key} ({n})")
        _RESIDENT[key] = n
    return _RESIDENT[key]


def _launch_decode(q1, k_cache, v_cache, cache_len):
    _decode_shapes(q1, k_cache, v_cache)
    B, _, H, dh = q1.shape
    _, S, Hkv, _ = k_cache.shape
    if H // Hkv > _MAX_G:
        raise ValueError(f"flash_decode: {H // Hkv} query heads per KV head "
                         f"(the kernel takes 1..{_MAX_G})")
    _check_common("flash_decode", {"q1": q1, "k_cache": k_cache, "v_cache": v_cache}, dh)
    lib = _flash_lib()
    gb = paged_groups(H // Hkv, dh, _DECODE_GB)[0]
    plan = decode_plan(q1, k_cache, cache_len, _resident(lib, _DTYPES[q1.dtype], dh, gb))
    if plan["rows"] > 65535:
        raise ValueError(f"flash_decode: {plan['rows']} (request, KV head, row group) "
                         f"triples exceed the grid's 65,535")
    out = torch.empty_like(q1)
    stream = torch.cuda.current_stream(q1.device).cuda_stream
    part = cnt = None
    if plan["splits"] > 1:
        part = torch.empty((plan["part_floats"],), dtype=torch.float32, device=q1.device)
        cnt = _arrival_counters(q1.device, stream, plan["rows"])
    code = lib.flash_decode(q1.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                            out.data_ptr(), None if part is None else part.data_ptr(),
                            None if cnt is None else cnt.data_ptr(), cache_len,
                            B, S, Hkv, plan["G"], dh, plan["gb"], plan["chunk"],
                            plan["splits"], _DTYPES[q1.dtype], stream)
    build.check(lib, code, "flash_decode")
    kernels.count("flash_decode", q1.device)
    return out


def _flash_lib():
    lib = build.load("flash_attention")
    if lib.flash_forward.argtypes is None:
        lib.flash_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.flash_forward.restype = ctypes.c_int
        lib.flash_decode.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                                     + [ctypes.c_void_p])
        lib.flash_decode.restype = ctypes.c_int
        lib.flash_decode_resident.argtypes = [ctypes.c_int] * 3
        lib.flash_decode_resident.restype = ctypes.c_int
    return lib
