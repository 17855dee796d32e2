"""GQA and MLA attention and KV caches (port of ``repro/models/attention.py``).

Prefill attention is plain PyTorch (matmul + softmax), as the reference
leaves it to XLA: ``attention`` and, for sliding-window configs past
4·window, the block-local ``sliding_attention``.  The one kernel on this
path is the paged decode attention of the serving engine, reached through
``kernels.flash_attention.ops.paged_decode``.  MLA (DeepSeek-V2) runs its
expanded form through ``attention`` (q/k head dim 192, v 128 at full width)
and decodes in the absorbed form over its latent cache, plain PyTorch as
in the reference; it serves through the static path only.

Scores are formed in f32 from the inputs upcast (the reference's
``preferred_element_type=f32``); probabilities go back to the input dtype
before P·V where the reference does so.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.sharding.local import (ROWS, decode_local, heads_local, is_dtensor,
                                        merge_heads, split_heads, write_row)

NEG_INF = -1e30


# =====================================================================
# parameter init
# =====================================================================
def init_gqa(gen, cfg, *, stack: tuple = ()):
    D, H, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, D, H * dh, cfg.pdtype, stack=stack),
        "wk": dense_init(gen, D, Hkv * dh, cfg.pdtype, stack=stack),
        "wv": dense_init(gen, D, Hkv * dh, cfg.pdtype, stack=stack),
        "wo": dense_init(gen, H * dh, D, cfg.pdtype,
                         scale=1.0 / math.sqrt(H * dh), stack=stack),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * dh), ("bk", Hkv * dh), ("bv", Hkv * dh)):
            p[name] = torch.zeros((*stack, n), dtype=cfg.pdtype, device=gen.device)
    return p


# =====================================================================
# core softmax-attention primitives
# =====================================================================
def _scale(q):
    # the reference multiplies by a weakly typed Python scalar, which
    # JAX rounds to q's dtype first; made on the device (no host copy, so
    # a captured step can hold it)
    return q * torch.full((), q.shape[-1] ** -0.5, dtype=q.dtype, device=q.device)


def _band_mask(q_pos, k_pos, *, causal: bool, window: int):
    """True where attention is allowed. q_pos (Sq,), k_pos (Skv,)."""
    rel = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        ok &= rel >= 0
    if window > 0:
        ok &= rel < window
    return ok


@heads_local(2, 2, 2)
def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, kv_block: int = 1024, kv_valid_start: int = 0):
    """Chunked online-softmax attention.

    q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh); GQA via H = Hkv * G.
    ``q_offset``: absolute position of q[0] relative to k[0] (prefill=0).
    ``window``>0: sliding window (queries see the last `window` keys).
    ``kv_valid_start``: keys before this index are masked (front padding).
    Returns (B, Sq, H, dh) in q.dtype.
    """
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    dv = v.shape[-1]
    G = H // Hkv
    dev = q.device
    qg = _scale(q.reshape(B, Sq, Hkv, G, dh)).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)

    nblk = max(1, math.ceil(Skv / kv_block))
    if nblk == 1:
        k_pos = torch.arange(Skv, device=dev)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
        mask = _band_mask(q_pos, k_pos, causal=causal, window=window)
        mask &= (k_pos >= kv_valid_start)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(q.dtype), v)
        return out.reshape(B, Sq, H, dv)

    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, dv), dtype=torch.float32, device=dev)
    for i in range(nblk):
        k_pos = i * kv_block + torch.arange(kv_block, device=dev)
        kblk = k[:, i * kv_block:(i + 1) * kv_block].float()
        vblk = v[:, i * kv_block:(i + 1) * kv_block].float()
        pad = kv_block - kblk.shape[1]          # ragged last block: pad with
        if pad:                                 # zeros, masked below
            kblk = torch.nn.functional.pad(kblk, (0, 0, 0, 0, 0, pad))
            vblk = torch.nn.functional.pad(vblk, (0, 0, 0, 0, 0, pad))
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kblk)
        mask = _band_mask(q_pos, k_pos, causal=causal, window=window)
        mask &= ((k_pos < Skv) & (k_pos >= kv_valid_start))[None, :]
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(q.dtype)


@heads_local(2, 2, 2)
def sliding_attention(q, k, v, *, window: int, q_block: int = 512):
    """Causal sliding-window attention with O(S·window) FLOPs.

    Each query block of length qb attends only the KV slice
    [blk_start - window, blk_end): one slice per block instead of a full
    S×S score matrix.  Requires Sq == Skv (prefill self-attention) and,
    past the short-sequence path, S divisible by ``q_block``.
    """
    B, S, H, dh = q.shape
    if S <= q_block or S <= window:
        return attention(q, k, v, causal=True, window=window)
    qb = q_block
    if S % qb:
        raise ValueError(f"sliding_attention requires seq {S} divisible by "
                         f"q_block {qb}")
    span = min(window + qb, S)               # kv context visible to one block
    outs = []
    for i in range(S // qb):
        # the kv slice ends at the block's end; slots before key 0 are the
        # reference's front padding, masked by kv_valid_start
        end = (i + 1) * qb
        lo = max(0, end - span)
        pad = span - (end - lo)
        ki, vi = k[:, lo:end], v[:, lo:end]
        if pad:
            ki = torch.nn.functional.pad(ki, (0, 0, 0, 0, pad, 0))
            vi = torch.nn.functional.pad(vi, (0, 0, 0, 0, pad, 0))
        outs.append(attention(q[:, i * qb:end], ki, vi, causal=True, window=window,
                              q_offset=span - qb, kv_block=span, kv_valid_start=pad))
    return torch.cat(outs, dim=1)


@decode_local
def decode_attention(q1, k_cache, v_cache, cache_len=None, *, window: int = 0):
    """One-token attention.  q1 (B,1,H,dh); caches (B,S,Hkv,dh).

    ``cache_len``: number of valid cache entries — an int, or a (B,)
    tensor for ragged batches (the paged serving path); None = all.
    ``window``>0 additionally masks keys older than the last ``window``
    positions.
    """
    B, _, H, dh = q1.shape
    _, S, Hkv, _ = k_cache.shape
    G = H // Hkv
    qg = _scale(q1.reshape(B, Hkv, G, dh))
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    if cache_len is not None:
        cl = torch.as_tensor(cache_len, device=q1.device)
        cl = cl[:, None] if cl.ndim == 1 else cl.reshape(1, 1)
        pos = torch.arange(S, device=q1.device)[None, :]
        valid = pos < cl
        if window > 0:
            valid &= pos >= cl - window
        scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(q1.dtype), v_cache)
    return out.reshape(B, 1, H, dh)


# =====================================================================
# GQA block forward (prefill / decode)
# =====================================================================
def _project_qkv(p, x, cfg):
    B, S, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (split_heads(q, B, S, H, dh), split_heads(k, B, S, Hkv, dh),
            split_heads(v, B, S, Hkv, dh))


def gqa_forward(p, x, cfg):
    """Full-sequence self-attention (prefill compute).  Returns
    (out (B,S,D), (k, v)) with k/v after RoPE, for the caches."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if cfg.attn_variant == "sliding" else 0
    if window and cfg.causal and S > 4 * window:
        out = sliding_attention(q, k, v, window=window)
    else:
        out = attention(q, k, v, causal=cfg.causal, window=window)
    return merge_heads(out, B, S, -1) @ p["wo"].to(x.dtype), (k, v)


def device_position(pos, device) -> torch.Tensor:
    """A decode position as the 0-d int32 tensor on ``device`` that the
    decode mixers take: a tensor is passed through, an int filled once."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((), pos, dtype=torch.int32, device=device)


def gqa_decode(p, x1, cache, cfg, pos):
    """x1 (B,1,D); cache {'k','v'} (B,S,Hkv,dh); pos: the write index, a
    0-d int tensor on the device (an int is converted by
    ``device_position``), never read back to the host.

    Writes the new token's K/V into ``cache`` IN PLACE (the reference
    returns an updated copy; its jitted callers donate the buffer, so no
    caller ever reads the old cache) and returns (out (B,1,D), cache).
    For sliding-window configs the cache is a ring buffer and pos wraps.
    """
    B = x1.shape[0]
    pos = device_position(pos, x1.device)
    q, k, v = _project_qkv(p, x1, cfg)
    S = cache["k"].shape[1]
    abs_pos = pos.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, abs_pos, cfg.rope_theta)
    k = apply_rope(k, abs_pos, cfg.rope_theta)
    slot = pos % S if cfg.attn_variant == "sliding" else pos
    _write_row(cache["k"], slot, k)
    _write_row(cache["v"], slot, v)
    out = decode_attention(q, cache["k"], cache["v"], cache_len=torch.clamp(pos + 1, max=S))
    return out.reshape(B, 1, -1) @ p["wo"].to(x1.dtype), cache


def _write_row(cache, slot, row) -> None:
    """``cache[:, slot] = row[:, 0]`` in place, the 0-d ``slot`` kept on the
    device (``index_copy_`` along the sequence axis)."""
    if is_dtensor(cache):       # the dry run's placed cache
        write_row(cache, slot, row)
        return
    cache.index_copy_(1, slot.reshape(1).long(), row)


def gqa_paged_decode(p, x1, cache, cfg, pos_info):
    """Paged-pool GQA decode.  x1 (B,1,D); cache {'k','v'} leaves are
    (nb, bs, Hkv, dh) block POOLS shared by every in-flight request —
    token t of request b lives at pool slot ``[bt[b, t//bs], t % bs]``.

    ``pos_info = (block_tables (B, nbmax) int32, seq_lens (B,) int32)``.
    The new token's K/V is scattered at position ``seq_lens[b]`` IN PLACE
    with ``index_put_`` — the reference's engine donates the pool to its
    jitted step, so the pool it replaces is never read again; the port
    writes where it would have copied.  Inactive slots (seq_len 0, all-null
    block table) scatter into the reserved null block 0.  Attention then
    covers ``seq_lens + 1`` tokens, the new one included.
    """
    bt, sl = pos_info
    B = x1.shape[0]
    q, k, v = _project_qkv(p, x1, cfg)
    abs_pos = sl[:, None]                                  # (B, 1)
    q = apply_rope(q, abs_pos, cfg.rope_theta)
    k = apply_rope(k, abs_pos, cfg.rope_theta)
    bs = cache["k"].shape[1]
    blk = torch.gather(bt, 1, (sl // bs)[:, None].to(bt.dtype))[:, 0].long()
    off = (sl % bs).long()
    cache["k"].index_put_((blk, off), k[:, 0])
    cache["v"].index_put_((blk, off), v[:, 0])
    window = cfg.sliding_window if cfg.attn_variant == "sliding" else 0
    from repro_torch.kernels.flash_attention import ops as flash_ops
    out = flash_ops.paged_decode(q, cache["k"], cache["v"], bt, sl + 1,
                                 window=window)
    return out.reshape(B, 1, -1) @ p["wo"].to(x1.dtype), cache


def gqa_paged_cache_shape(cfg, num_blocks: int, block_size: int):
    return {
        "k": (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim),
        "v": (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim),
    }


def gqa_cache_shape(cfg, batch: int, seq_len: int):
    S = min(seq_len, cfg.sliding_window) if cfg.attn_variant == "sliding" else seq_len
    return {
        "k": (batch, S, cfg.num_kv_heads, cfg.head_dim),
        "v": (batch, S, cfg.num_kv_heads, cfg.head_dim),
    }


# =====================================================================
# MLA (DeepSeek-V2 multi-head latent attention)
# =====================================================================
def init_mla(gen, cfg, *, stack: tuple = ()):
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        "wq": dense_init(gen, D, H * qd, cfg.pdtype, stack=stack),
        "w_dkv": dense_init(gen, D, m.kv_lora_rank + m.rope_head_dim, cfg.pdtype, stack=stack),
        "kv_norm_scale": torch.ones((*stack, m.kv_lora_rank), dtype=cfg.pdtype,
                                    device=gen.device),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.nope_head_dim, cfg.pdtype, stack=stack),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, cfg.pdtype, stack=stack),
        "wo": dense_init(gen, H * m.v_head_dim, D, cfg.pdtype,
                         scale=1.0 / math.sqrt(H * m.v_head_dim), stack=stack),
    }


def _mla_q(p, x, cfg):
    B, S, _ = x.shape
    m, H = cfg.mla, cfg.num_heads
    q = split_heads(x @ p["wq"].to(x.dtype), B, S, H, m.nope_head_dim + m.rope_head_dim)
    return q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]      # q_nope, q_rope


def _mla_compress(p, x, cfg):
    """The RMS-normed latent c_kv (B,S,rank) and the shared key's rope part
    (B,S,rope), before RoPE."""
    m = cfg.mla
    ckr = x @ p["w_dkv"].to(x.dtype)                     # (B,S,rank+rope)
    c_kv, k_rope = ckr[..., :m.kv_lora_rank], ckr[..., m.kv_lora_rank:]
    cf = c_kv.float()
    c_kv = (cf * torch.rsqrt(cf.square().mean(-1, keepdim=True) + cfg.norm_eps)
            * p["kv_norm_scale"].float()).to(x.dtype)
    return c_kv, k_rope


def mla_forward(p, x, cfg):
    """Expanded (train/prefill) MLA: decompress K/V and run the GQA math
    with q/k head dim nope + rope and v head dim ``v_head_dim``.  Returns
    (out (B,S,D), (c_kv, k_rope)) with k_rope after RoPE, for the caches."""
    B, S, _ = x.shape
    m, H = cfg.mla, cfg.num_heads
    q_nope, q_rope = _mla_q(p, x, cfg)
    c_kv, k_rope = _mla_compress(p, x, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta)   # (B,S,1,rd)
    k_nope = split_heads(c_kv @ p["w_uk"].to(x.dtype), B, S, H, m.nope_head_dim)
    v = split_heads(c_kv @ p["w_uv"].to(x.dtype), B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.rope_head_dim)], dim=-1)
    out = attention(q, k, v, causal=cfg.causal)
    return merge_heads(out, B, S, -1) @ p["wo"].to(x.dtype), (c_kv, k_rope[..., 0, :])


@heads_local(1, 1, ROWS, ROWS, None, out=1)
def _latent_attention(q_abs, q_rope, c_kv, k_rope, pos, scale: float):
    """MLA decode's attention in the latent space: the context (B, H, rank)
    over the first ``pos + 1`` cache rows; per batch row and head."""
    S = c_kv.shape[1]
    scores = (torch.einsum("bhr,bsr->bhs", q_abs.float(), c_kv.float())
              + torch.einsum("bhd,bsd->bhs", q_rope.float(), k_rope.float())) * scale
    valid = torch.arange(S, device=q_abs.device) < pos + 1
    scores = torch.where(valid[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_abs.dtype)
    return torch.einsum("bhs,bsr->bhr", probs, c_kv)    # latent-space context


def mla_decode(p, x1, cache, cfg, pos):
    """Absorbed-form MLA decode: attention runs in the latent space over the
    compressed cache {'c_kv' (B,S,rank), 'k_rope' (B,S,rope)}, written IN
    PLACE at ``pos``, a 0-d device tensor or an int (as ``gqa_decode``).
    ``w_uk`` is absorbed into the query and ``w_uv`` applied to the latent
    context, each viewed as (rank, H, d): its columns are head-major, as
    the expanded form reshapes them."""
    B = x1.shape[0]
    m, H = cfg.mla, cfg.num_heads
    pos = device_position(pos, x1.device)
    q_nope, q_rope = _mla_q(p, x1, cfg)                  # (B,1,H,*)
    abs_pos = pos.reshape(1, 1).expand(B, 1)
    q_rope = apply_rope(q_rope, abs_pos, cfg.rope_theta)
    c_new, kr_new = _mla_compress(p, x1, cfg)
    kr_new = apply_rope(kr_new[..., None, :], abs_pos, cfg.rope_theta)[..., 0, :]
    _write_row(cache["c_kv"], pos, c_new)
    _write_row(cache["k_rope"], pos, kr_new)
    w_uk = split_heads(p["w_uk"].to(x1.dtype), m.kv_lora_rank, H, m.nope_head_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    ctx = _latent_attention(q_abs, q_rope[:, 0], cache["c_kv"], cache["k_rope"], pos, scale)
    w_uv = split_heads(p["w_uv"].to(x1.dtype), m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bhr,rhd->bhd", ctx, w_uv).reshape(B, 1, H * m.v_head_dim)
    return o @ p["wo"].to(x1.dtype), cache


def mla_cache_shape(cfg, batch: int, seq_len: int):
    m = cfg.mla
    return {
        "c_kv": (batch, seq_len, m.kv_lora_rank),
        "k_rope": (batch, seq_len, m.rope_head_dim),
    }
