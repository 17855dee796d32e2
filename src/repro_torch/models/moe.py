"""Mixture-of-Experts FFN with capacity dispatch (port of ``repro/models/moe.py``).

The reference's group-wise dispatch: tokens are cut into groups of
``GROUP_SIZE``; within a group every (token, choice) pair is stably sorted
by expert, takes its rank within the expert as its slot, and is dropped
(weight 0) past the capacity ``C``; each expert bank runs one batched
product over its ``(G, E, C, D)`` buffer, and the results are gathered
back, weighted by the renormalized top-k gates.  The same group size and
capacity rule drop the same tokens as the reference.

Every step is a static-shape tensor op with no host read (the capacity is
a Python int of the shapes, counts go through ``scatter_add`` into a fixed
``E + 1`` buffer), so a captured client step can hold it, and all of them
are out of place with batching rules, so the vectorized engine can vmap
it.  The dispatch buffer is filled by a gather (slot ``(e, c)`` reads the
c-th token sorted to expert e), which equals the reference's scatter-add
into zeros since every slot receives at most one token.  The expert
products are plain ``torch`` matmuls: the reference has no kernel here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp
from repro_torch.sharding.local import experts_local, is_dtensor

# tokens per routing group: capacity and overflow drops are per group
GROUP_SIZE = 4096


def init_moe(gen, cfg, *, stack: tuple = ()):
    m = cfg.moe
    D, E = cfg.d_model, m.num_experts
    p = {
        "router": dense_init(gen, D, E, cfg.pdtype, scale=0.02, stack=stack),
        "w_in": dense_init(gen, D, m.d_ff_expert, cfg.pdtype, stack=(*stack, E)),
        "w_out": dense_init(gen, m.d_ff_expert, D, cfg.pdtype, stack=(*stack, E)),
    }
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, D, m.d_ff_expert, cfg.pdtype, stack=(*stack, E))
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_in=D, d_ff=m.d_ff_expert * m.num_shared_experts,
                               stack=stack)
    return p


def router_probs(p, x, cfg):
    """x (T, D) -> router softmax probs (T, E) in f32."""
    return torch.softmax(x.float() @ p["router"].float(), dim=-1)


def load_balance_loss(probs, expert_idx, cfg):
    """Switch-style aux loss: E * Σ_e f_e · p_e / top_k."""
    E = cfg.moe.num_experts
    onehot = (expert_idx[..., None] == torch.arange(E, device=probs.device)).float()
    frac_tokens = onehot.sum(1).mean(0)                         # (E,)
    frac_probs = probs.mean(0)                                  # (E,)
    return E * (frac_tokens * frac_probs).sum() / cfg.moe.top_k


def _capacity(tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(math.ceil(m.capacity_factor * tokens * m.top_k / m.num_experts))
    return max(8, -(-c // 8) * 8)      # round up to multiple of 8


def moe_ffn(p, x, cfg, group_size: int = GROUP_SIZE):
    """x (T, D) -> (out (T, D), aux_loss scalar)."""
    bank = {k: p[k] for k in ("router", "w_in", "w_gate", "w_out") if k in p}
    if is_dtensor(x):           # the dry run: expert-parallel over "model"
        out, aux = experts_local(_routed, bank, x, cfg, group_size)
    else:
        out, aux = _routed(bank, x, cfg, group_size)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, cfg)
    return out, aux


def _routed(p, x, cfg, group_size: int, expert0: int = 0):
    """The routed experts of ``moe_ffn``: (out (T, D), aux).  ``p``'s bank
    may hold the experts from ``expert0`` on only (one rank's under the dry
    run): the tokens routed elsewhere get 0 here."""
    m = cfg.moe
    T, D = x.shape
    E, K = m.num_experts, m.top_k
    dev = x.device

    probs = router_probs(p, x, cfg)                             # (T, E) f32
    gate, eidx = torch.topk(probs, K, dim=-1)                   # (T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    aux = load_balance_loss(probs, eidx, cfg)

    gs = min(group_size, T)
    G = -(-T // gs)
    pad = G * gs - T
    if pad:                            # padded tokens route to E: dropped
        x = F.pad(x, (0, 0, 0, pad))
        eidx = F.pad(eidx, (0, 0, 0, pad), value=E)
        gate = F.pad(gate, (0, 0, 0, pad))
    C = _capacity(gs, cfg)
    n = gs * K

    xg = x.reshape(G, gs, D)
    flat_e = eidx.reshape(G, n)                                 # (G, gs*K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((G, E + 1), dtype=torch.int64, device=dev).scatter_add(
        1, flat_e, torch.ones_like(flat_e))[:, :E]              # (G, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    safe_e = flat_e.clamp(max=E - 1)
    pos_sorted = (torch.arange(n, device=dev)
                  - torch.gather(starts, 1, torch.gather(safe_e, 1, order)))
    pos = torch.zeros_like(pos_sorted).scatter(1, order, pos_sorted)
    keep = (pos < C) & (flat_e < E)                             # (G, n)

    # slot (e, c) holds the c-th (token, choice) sorted to expert e
    c_idx = torch.arange(C, device=dev)
    filled = c_idx < counts[..., None]                          # (G, E, C)
    src = torch.where(filled, starts[..., None] + c_idx, 0).reshape(G, E * C)
    tok = torch.gather(order, 1, src) // K                      # (G, E*C)
    buf = torch.gather(xg, 1, tok[..., None].expand(G, E * C, D))
    buf = torch.where(filled.reshape(G, E * C, 1), buf, 0).reshape(G, E, C, D)

    local = p["w_in"].shape[0]
    if local != E:
        buf = buf[:, expert0:expert0 + local]
    h = torch.einsum("gecd,edf->gecf", buf, p["w_in"].to(x.dtype))
    if "w_gate" in p:
        g = torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(x.dtype))
        act = F.silu(g) if cfg.mlp_variant == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    out_buf = torch.einsum("gecf,efd->gecd", h, p["w_out"].to(x.dtype))
    if local != E:
        out_buf = F.pad(out_buf, (0, 0, 0, 0, expert0, E - expert0 - local))

    slot = torch.where(keep, flat_e * C + pos, 0)               # (G, n)
    tok_out = torch.gather(out_buf.reshape(G, E * C, D), 1,
                           slot[..., None].expand(G, n, D))
    tok_out = torch.where(keep[..., None], tok_out, 0)
    tok_out = tok_out.reshape(G * gs, K, D) * gate.reshape(-1, K, 1).to(x.dtype)
    return tok_out.sum(1)[:T], aux
