"""Dense-softmax oracles for the flash attention kernels (port of
``repro/kernels/flash_attention/ref.py``): the whole score matrix in f32,
one softmax, no tiling."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,H,Sq,dh), k/v (B,H,Skv,dh) (kv heads pre-broadcast), Sq==Skv."""
    B, H, S, dh = q.shape
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dh ** -0.5)
    pos = torch.arange(S, device=q.device)
    rel = pos[:, None] - pos[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= rel >= 0
    if window > 0:
        ok &= rel < window
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, cache_len):
    """q (B,H,dh), k/v (B,H,S,dh) -> (B,H,dh); entries ≥ cache_len masked."""
    B, H, S, dh = k.shape
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * (dh ** -0.5)
    valid = torch.arange(S, device=q.device) < cache_len
    scores = torch.where(valid[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, v.float()).to(q.dtype)
