"""Flash-KD's plain versions: vocab-tiled streaming KD with an online
logsumexp (port of the pure-jnp half of ``repro/kernels/kd_loss/flash.py``).

The teacher is consumed as its mean logit row z̄ (storable in bf16) and
the τ-softmax of the teacher, the student log-softmax and the KL reduce
in ONE streaming pass over ``V``-tiles.  With s = z_s/τ and t = z̄/τ, per
row::

    KL(p‖q) = Σ_v p_v (t_v − s_v) − lse(t) + lse(s)
            = A / l_t − (m_t + log l_t) + (m_s + log l_s)

with (m_x, l_x) the running max and rescaled sum of exp, and
A = Σ_v e^{t_v − m_t}(t_v − s_v) rescaled whenever m_t advances.  The
forward returns ``(loss, lse_s, lse_t)``; the backward needs only those
normalisers:  ∂loss/∂z_s = g·(τ/B)·(e^{s − lse_s} − e^{t − lse_t}).

The head-fused variants take the pre-head features ``h`` (B, D) and the
head ``W`` (D, V) (+ bias) and form ``h @ W[:, tile]`` inside each tile, so
neither the student logit row nor its gradient ever exists wider than one
``(B, tile)`` block: ∂h accumulates ``d @ W[:, tile]ᵀ`` over the tiles,
``∂W[:, tile] = hᵀ @ d`` and ``∂b[tile] = Σ_b d`` are written once each.

These loops are what the CPU path runs and what the card holds the
kernels of ``csrc/flash_kd.cu`` against.  Every tile is cast to f32 on its
own, so no full ``(B, V)`` temporary appears in the head-fused pair; the
ragged tail is the last, narrower tile (no padding anywhere).  ``tile_v``
fixes the tile; the tests pin small tiles to exercise the accumulator.
"""
from __future__ import annotations

import torch

DEFAULT_TILE_V = 4096
# the host path has no on-chip budget: a wide default tile keeps the CPU
# sweep at full vector width; an explicit tile_v always wins
DEFAULT_TILE_V_HOST = 32768
# masked-lane fill for both the student logits and the mean-logit cache:
# representable in bf16, exp() -> 0 exactly, and (t - s) = 0 on masked lanes
FLASH_PAD = -1e30


# ----------------------------------------------------------- accumulators
def _acc_tile(carry, s, t):
    """One online update over a (B, tile) pair of scaled tiles."""
    m_s, l_s, m_t, l_t, acc = carry
    m_s2 = torch.maximum(m_s, s.amax(-1))
    l_s = l_s * torch.exp(m_s - m_s2) + torch.exp(s - m_s2[:, None]).sum(-1)
    m_t2 = torch.maximum(m_t, t.amax(-1))
    e_t = torch.exp(t - m_t2[:, None])
    scale = torch.exp(m_t - m_t2)
    l_t = l_t * scale + e_t.sum(-1)
    acc = acc * scale + (e_t * (t - s)).sum(-1)
    return m_s2, l_s, m_t2, l_t, acc


def _acc_tile_lse(carry, s, t, lse_t):
    """The update when the teacher normaliser is known (computed once at
    cache build): p = e^{t − lse_t} needs no running max, so only the
    student stays online."""
    m_s, l_s, cross = carry
    m_s2 = torch.maximum(m_s, s.amax(-1))
    l_s = l_s * torch.exp(m_s - m_s2) + torch.exp(s - m_s2[:, None]).sum(-1)
    cross = cross + (torch.exp(t - lse_t[:, None]) * (t - s)).sum(-1)
    return m_s2, l_s, cross


def _tiles(V: int, tile_v: int):
    tile = max(1, min(int(tile_v), V))
    return [(i0, min(i0 + tile, V)) for i0 in range(0, V, tile)]


def _finish(carry, teacher_lse, temperature: float):
    """(loss, lse_s, lse_t) from the swept accumulators."""
    if teacher_lse is not None:
        m_s, l_s, cross = carry
        lse_t = teacher_lse.float()
        lse_s = m_s + torch.log(l_s)
        kl = cross - lse_t + lse_s
    else:
        m_s, l_s, m_t, l_t, acc = carry
        lse_s = m_s + torch.log(l_s)
        lse_t = m_t + torch.log(l_t)
        kl = acc / l_t - lse_t + lse_s
    return kl.mean() * float(temperature) ** 2, lse_s, lse_t


def _sweep(B: int, V: int, device, tile_v: int, teacher_lse, tiles_fn):
    """Drive the accumulator over the vocab tiles; ``tiles_fn(i0, i1)``
    returns the tile's scaled (s, t) pair."""
    neg_inf = torch.full((B,), float("-inf"), dtype=torch.float32, device=device)
    zero = torch.zeros((B,), dtype=torch.float32, device=device)
    if teacher_lse is not None:
        lse_t = teacher_lse.float()
        carry = (neg_inf, zero, zero)
        for i0, i1 in _tiles(V, tile_v):
            carry = _acc_tile_lse(carry, *tiles_fn(i0, i1), lse_t)
    else:
        carry = (neg_inf, zero, neg_inf, zero, zero)
        for i0, i1 in _tiles(V, tile_v):
            carry = _acc_tile(carry, *tiles_fn(i0, i1))
    return carry


# --------------------------------------------------------- unfused (7, 8)
def flash_kd_fwd_tiled(student_logits: torch.Tensor, teacher_mean_logits: torch.Tensor,
                       temperature: float = 1.0, tile_v: int = DEFAULT_TILE_V,
                       teacher_lse: torch.Tensor | None = None):
    """Streaming fused KD forward; returns ``(loss, lse_s, lse_t)``, the
    normalisers of the scaled logits z/τ.  With ``teacher_lse`` (the
    pipeline computes it once at cache build) the teacher's max/sum chain
    drops out and only the student stays online."""
    B, V = student_logits.shape
    inv_temp = 1.0 / float(temperature)

    def tiles(i0, i1):
        return (student_logits[:, i0:i1].float() * inv_temp,
                teacher_mean_logits[:, i0:i1].float() * inv_temp)

    carry = _sweep(B, V, student_logits.device, tile_v, teacher_lse, tiles)
    return _finish(carry, teacher_lse, temperature)


def flash_kd_bwd_ref(student_logits: torch.Tensor, teacher_mean_logits: torch.Tensor,
                     lse_s: torch.Tensor, lse_t: torch.Tensor, g,
                     temperature: float = 1.0) -> torch.Tensor:
    """Residual-fed backward, one elementwise pass with no reductions:
    ``exp(s − lse_s)`` is the student softmax, ``exp(t − lse_t)`` the
    teacher's; the result takes the student logits' dtype."""
    B = student_logits.shape[0]
    inv_temp = 1.0 / float(temperature)
    q = torch.exp(student_logits.float() * inv_temp - lse_s[:, None])
    p = torch.exp(teacher_mean_logits.float() * inv_temp - lse_t[:, None])
    coef = torch.as_tensor(g, dtype=torch.float32, device=q.device) * (float(temperature) / B)
    return ((q - p) * coef).to(student_logits.dtype)


# ------------------------------------------------------- head-fused (9, 10)
def _head_tile(h32, head_w, head_b, i0: int, i1: int):
    """(B, tile) student tile ``h @ W[:, tile] (+ b[tile])`` in f32."""
    s = h32 @ head_w[:, i0:i1].float()
    if head_b is not None:
        s = s + head_b[i0:i1].float()[None, :]
    return s


def flash_kd_head_fwd_tiled(features: torch.Tensor, head_w: torch.Tensor, head_b,
                            teacher_mean_logits: torch.Tensor, temperature: float = 1.0,
                            tile_v: int = DEFAULT_TILE_V_HOST,
                            teacher_lse: torch.Tensor | None = None):
    """Head-fused streaming KD forward: ``(loss, lse_s, lse_t)`` from the
    pre-head features (B, D), the head (D, V) and an optional (V,) bias;
    the student logits exist one (B, tile) block at a time."""
    B = features.shape[0]
    V = teacher_mean_logits.shape[-1]
    inv_temp = 1.0 / float(temperature)
    h32 = features.float()

    def tiles(i0, i1):
        return (_head_tile(h32, head_w, head_b, i0, i1) * inv_temp,
                teacher_mean_logits[:, i0:i1].float() * inv_temp)

    carry = _sweep(B, V, features.device, tile_v, teacher_lse, tiles)
    return _finish(carry, teacher_lse, temperature)


def flash_kd_head_bwd_tiled(features: torch.Tensor, head_w: torch.Tensor, head_b,
                            teacher_mean_logits: torch.Tensor, lse_s: torch.Tensor,
                            lse_t: torch.Tensor, g, temperature: float = 1.0,
                            tile_v: int = DEFAULT_TILE_V_HOST):
    """Head-fused residual backward: ``(∂h, ∂W, ∂b)`` in one streaming
    pass.  d = g·(τ/B)·(q − p) exists only at (B, tile) width; ∂h
    accumulates ``d @ W_tileᵀ`` in f32 across the tiles, ``∂W[:, tile]`` and
    ``∂b[tile]`` are disjoint write-once slices.  ∂W takes the head's own
    layout (a tied head's transposed view stays one), so autograd hands it
    back to the embedding without a copy."""
    B, D = features.shape
    V = teacher_mean_logits.shape[-1]
    inv_temp = 1.0 / float(temperature)
    h32 = features.float()
    coef = torch.as_tensor(g, dtype=torch.float32, device=h32.device) * (float(temperature) / B)
    lse_s, lse_t = lse_s.float(), lse_t.float()
    gh = torch.zeros((B, D), dtype=torch.float32, device=h32.device)
    gw = torch.zeros_like(head_w, dtype=torch.float32)
    gb = None if head_b is None else torch.zeros((V,), dtype=torch.float32,
                                                 device=h32.device)
    for i0, i1 in _tiles(V, tile_v):
        s = _head_tile(h32, head_w, head_b, i0, i1)
        q = torch.exp(s * inv_temp - lse_s[:, None])
        p = torch.exp(teacher_mean_logits[:, i0:i1].float() * inv_temp - lse_t[:, None])
        d = (q - p) * coef                 # (B, tile): the only width it has
        gh = gh + d @ head_w[:, i0:i1].float().T
        gw[:, i0:i1] = h32.T @ d
        if gb is not None:
            gb[i0:i1] = d.sum(0)
    return (gh.to(features.dtype), gw.to(head_w.dtype),
            None if gb is None else gb.to(head_b.dtype))
