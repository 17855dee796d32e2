"""Paged decode attention: the Hopper kernel and its plain version
(port of ``repro/kernels/flash_attention/ops.py::paged_decode``).

``paged_decode`` keeps the reference's signature and layouts.  For CUDA
tensors it launches ``csrc/paged_decode.cu`` or raises; for CPU tensors it
runs ``paged_decode_ref``, the plain version the tests and the on-card
check hold the kernel against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.models.attention import decode_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_MAX_G = 16


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
    devices = {t.device for t in (q1, k_pool, v_pool, block_tables, seq_lens)}
    if len(devices) != 1:
        raise ValueError(f"paged_decode: tensors on several devices {devices}")
    (dev,) = devices
    if dev.type == "cpu":
        return paged_decode_ref(q1, k_pool, v_pool, block_tables, seq_lens,
                                window=window)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode: no kernel for device {dev}")
    return _launch(q1, k_pool, v_pool, block_tables, seq_lens, window)


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
                         "(the kernel stages K/V rows with 16-byte loads)")
    lib = _lib()
    out = torch.empty_like(q1)
    stream = torch.cuda.current_stream(q1.device).cuda_stream
    code = lib.paged_decode(
        q1.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, Hkv, H // Hkv, dh, bs, block_tables.shape[1], int(window),
        _DTYPES[q1.dtype], stream)
    build.check(lib, code, "paged_decode")
    kernels.launches["paged_decode"] += 1
    return out


def _lib():
    lib = build.load("paged_decode")
    if lib.paged_decode.argtypes is None:
        lib.paged_decode.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                                     + [ctypes.c_void_p])
        lib.paged_decode.restype = ctypes.c_int
    return lib
