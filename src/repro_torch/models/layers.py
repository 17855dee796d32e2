"""Shared building blocks (port of ``repro/models/layers.py``).

Plain functions on tensors and nested-dict params, as in the reference.
Norm and RoPE compute in f32 and cast back; matmuls run in the input's
dtype.  Two defaults differ between the frameworks and are pinned here:
``jax.nn.gelu`` is the tanh approximation (torch's default is erf), and
``jnp.var`` is the population variance (``correction=0``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.local import is_dtensor, vocab_nll


# -------------------------------------------------------------- initializers
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: float | None = None, *, stack: tuple = ()):
    """N(0, scale²) weights, scale defaulting to 1/sqrt(in_dim).  ``stack``
    prepends leading axes (the stacked layer axis) without a host copy."""
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    w = torch.empty((*stack, in_dim, out_dim), dtype=dtype, device=gen.device)
    return w.normal_(0.0, float(scale), generator=gen)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype):
    w = torch.empty((vocab, dim), dtype=dtype, device=gen.device)
    return w.normal_(0.0, 0.02, generator=gen)


# --------------------------------------------------------------------- norms
def init_norm(cfg, device, d: int | None = None, *, stack: tuple = ()):
    d = d or cfg.d_model
    p = {"scale": torch.ones((*stack, d), dtype=cfg.pdtype, device=device)}
    if cfg.norm_variant == "layernorm":
        p["bias"] = torch.zeros((*stack, d), dtype=cfg.pdtype, device=device)
    return p


def apply_norm(p, x, cfg):
    xf = x.float()
    if cfg.norm_variant == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


_FREQS: dict = {}


def _device_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` on ``device``, copied there once: a captured step
    cannot hold the host copy."""
    key = (head_dim, theta, device)
    if key not in _FREQS:
        _FREQS[key] = torch.from_numpy(rope_freqs(head_dim, theta)).to(device)
    return _FREQS[key]


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, dh); positions: broadcastable to (..., S).  Split-halves
    layout (the first dh/2 lanes pair with the last dh/2), not interleaved."""
    dh = x.shape[-1]
    freqs = _device_freqs(dh, theta, x.device)                    # (dh/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, dh/2)
    angles = angles[..., None, :]                                 # (..., S, 1, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- MLP
def init_mlp(gen, cfg, d_in: int | None = None, d_ff: int | None = None, *,
             stack: tuple = ()):
    """``d_in`` / ``d_ff`` override the config's widths (the MoE's shared
    experts are one MLP of ``d_ff_expert · num_shared_experts``)."""
    d_in = d_in or cfg.d_model
    d_ff = d_ff or cfg.d_ff
    p = {"w_out": dense_init(gen, d_ff, d_in, cfg.pdtype, stack=stack),
         "w_in": dense_init(gen, d_in, d_ff, cfg.pdtype, stack=stack)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d_in, d_ff, cfg.pdtype, stack=stack)
    return p


def apply_mlp(p, x, cfg):
    h = x @ p["w_in"].to(x.dtype)
    if cfg.mlp_variant == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    elif cfg.mlp_variant == "geglu":
        h = F.gelu(x @ p["w_gate"].to(x.dtype), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_out"].to(x.dtype)


# -------------------------------------------------------------------- losses
def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in f32.  logits (..., V), labels (...); with
    ``mask`` the mean over the masked-in positions (at least one)."""
    logits = logits.float()
    if is_dtensor(logits):      # the dry run's vocab-sharded logits
        nll = vocab_nll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def kl_divergence(student_logits, teacher_probs, temperature: float = 1.0):
    """KL(teacher || student) at temperature τ (Hinton KD) in f32, the mean
    over the batch times τ²."""
    s = torch.log_softmax(student_logits.float() / temperature, dim=-1)
    t = teacher_probs.float()
    loss = (t * (torch.log(t.clamp(min=1e-20)) - s)).sum(-1)
    return loss.mean() * temperature ** 2
