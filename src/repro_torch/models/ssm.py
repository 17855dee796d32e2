"""State-space / recurrent blocks: Mamba (S6) and xLSTM (mLSTM + sLSTM)
(port of ``repro/models/ssm.py``).

Each mixer has ``init_*``, ``*_forward`` (full sequence; returns the final
state), ``*_decode`` (one token against a state) and ``*_state_shape``,
with the reference's parameter trees, gating and f32 state arithmetic:

  * Mamba's selective scan runs chunkwise: a Python loop over chunks
    carries the (B, d_inner, d_state) state, and inside a chunk a
    log-step (Hillis-Steele) prefix scan computes every prefix state at
    once (the reference's ``lax.associative_scan``; the two sum in other
    orders, so they agree to f32 rounding).  Each chunk's output is
    contracted with C at once, so the (B, S, d_inner, d_state) prefix
    states never exist for the whole sequence.  The reference checkpoints
    the chunk body (``jax.checkpoint``), which changes memory, not values;
    the port does not: autograd keeps each chunk's prefix states.
  * mLSTM is the chunkwise linear-attention form: intra-chunk decayed
    attention plus the inter-chunk (B, nh, dh, dh) matrix state, with the
    reference's sigmoid-bounded gates.  The decayed weights keep the
    reference's ``where(mask, exp(decay)·i, 0)``: the masked-out entries
    are ``exp`` of positive decays, and a product with a mask would carry
    their gradient.
  * sLSTM is a time-step loop carrying (c, n, h, m) with the exponential
    gating and stabiliser; ``m`` starts at 0, so a zero decode state
    equals a fresh forward.

Every op is out of place with a batching rule and reads nothing back to
the host (chunk counts and split sizes are Python ints of the shapes), so
the vectorized engine vmaps these blocks and a client or KD step captures
them in a CUDA graph.  A full forward needs ``S % min(chunk_size, S) ==
0``, as in the reference.  The reference has no Pallas kernel here: the
scans are plain torch on every device.

``softplus`` / ``log_sigmoid`` are ``torch.nn.functional``'s: above its
threshold of 20 torch's softplus returns ``x`` where ``jax.nn.softplus``
returns ``x + log1p(exp(-x))``, which is ``x`` to f32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.sharding.local import (ROWS, column_blocks, heads_local, is_dtensor, rows_only,
                                        split_heads)


def _check_chunks(S: int, chunk_size: int) -> int:
    ch = min(chunk_size, S)
    if S % ch:
        raise ValueError(f"seq {S} not divisible by chunk {ch}")
    return ch


# ======================================================================
# Mamba (S6)
# ======================================================================
def _mamba_dims(cfg):
    di = cfg.ssm.expand * cfg.d_model
    ds = cfg.ssm.d_state
    dt_rank = max(1, cfg.d_model // 16)
    return di, ds, dt_rank


def init_mamba(gen, cfg, *, stack: tuple = ()):
    D = cfg.d_model
    di, ds, dt_rank = _mamba_dims(cfg)
    dc = cfg.ssm.d_conv
    dev, pd = gen.device, cfg.pdtype
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(*stack, di, ds)
    conv_w = torch.empty((*stack, dc, di), device=dev).normal_(0.0, 0.2, generator=gen)
    return {
        "in_proj": dense_init(gen, D, 2 * di, pd, stack=stack),
        "conv_w": conv_w.to(pd),
        "conv_b": torch.zeros((*stack, di), dtype=pd, device=dev),
        "x_proj": dense_init(gen, di, dt_rank + 2 * ds, pd, stack=stack),
        "dt_proj": dense_init(gen, dt_rank, di, pd, stack=stack),
        "dt_bias": torch.full((*stack, di), -4.6, dtype=pd, device=dev),   # softplus^-1(0.01)
        "A_log": torch.log(A).to(pd),
        "D_skip": torch.ones((*stack, di), dtype=pd, device=dev),
        "out_proj": dense_init(gen, di, D, pd, stack=stack),
    }


@heads_local(2, (None, 1), (None, 0), out=2)
def _causal_conv(x, w, b):
    """Depthwise causal conv.  x (B,S,di), w (dc,di) -> (B,S,di)."""
    dc, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    out = 0
    for j in range(dc):
        out = out + xp[:, j:j + S] * w[j]
    return out + b


def _mamba_gates(p, x, cfg):
    """Common pre-scan computation.  x (B,S,D) -> (a, b, Cc, x_conv, z, x_in)."""
    di, ds, dt_rank = _mamba_dims(cfg)
    w = p["in_proj"].to(x.dtype)
    if is_dtensor(w):           # the dry run: each half split over "model"
        x_in, z = (x @ h for h in column_blocks(w, di, di))
    else:
        xz = x @ w
        x_in, z = xz[..., :di], xz[..., di:]
    x_conv = F.silu(_causal_conv(x_in, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)))
    dbc = rows_only(x_conv @ p["x_proj"].to(x.dtype))     # whole over "model"
    dt, Bc, Cc = dbc[..., :dt_rank], dbc[..., dt_rank:dt_rank + ds], dbc[..., dt_rank + ds:]
    dt = F.softplus(dt.float() @ p["dt_proj"].float() + p["dt_bias"].float())    # (B,S,di)
    A = -torch.exp(p["A_log"].float())                                           # (di,ds)
    a = torch.exp(dt[..., None] * A)                                             # (B,S,di,ds)
    b = dt[..., None] * Bc[:, :, None, :].float() * x_conv[..., None].float()    # (B,S,di,ds)
    return a, b, Cc, x_conv, z, x_in


def _prefix_scan(a, b):
    """Inclusive prefix of h_t = a_t·h_{t-1} + b_t along axis 1, in
    log2(ch) out-of-place steps: (A_t, B_t) with h_t = A_t·h_0 + B_t."""
    ch = a.shape[1]
    d = 1
    while d < ch:
        pad = (0, 0, 0, 0, d, 0)
        b = a * F.pad(b[:, :-d], pad) + b
        a = a * F.pad(a[:, :-d], pad, value=1.0)
        d *= 2
    return a, b


@heads_local(2, 2, ROWS, 1, out=(2, 1))
def _mamba_chunks(a, b, Cf, h, ch: int):
    """The chunked scan over (B, S, di, ds) gates from the state h (B, di,
    ds): (y (B, S, di) f32, the last h); per batch row and channel."""
    ys = []
    for c in range(a.shape[1] // ch):
        sl = slice(c * ch, (c + 1) * ch)
        Ac, Bc_ = _prefix_scan(a[:, sl], b[:, sl])
        hs = Ac * h[:, None] + Bc_                                  # prefix states
        h = hs[:, -1]
        # y_t = Σ_n h_t[..., n] · C_t[..., n]
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, Cf[:, sl]))
    return torch.cat(ys, dim=1), h


def mamba_forward(p, x, cfg, state=None):
    """x (B,S,D) -> (out (B,S,D), final state {'h': (B,di,ds) f32,
    'conv': (B,dc-1,di) the last pre-conv inputs, x's dtype})."""
    B, S, _ = x.shape
    di, ds, _ = _mamba_dims(cfg)
    ch = _check_chunks(S, cfg.ssm.chunk_size)
    a, b, Cc, x_conv, z, x_in = _mamba_gates(p, x, cfg)
    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
         if state is None else state["h"])
    y, h = _mamba_chunks(a, b, Cc.float(), h, ch)
    y = y + p["D_skip"].float() * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"].to(x.dtype)
    # the last dc-1 pre-conv inputs, so decode can continue the conv; both
    # copied, as views they would pin the last chunk's (B, ch, di, ds)
    # states and the whole (B, S, 2·di) projection as long as the cache
    return out, {"h": h.clone(), "conv": x_in[:, -(cfg.ssm.d_conv - 1):].clone()}


@heads_local(2, (None, 1), (None, 0), out=1)
def _conv_step(hist, w, b):
    """The conv's one step over the last dc inputs hist (B, dc, di):
    silu(Σ_c hist·w + b), (B, di)."""
    return F.silu(torch.einsum("bcd,cd->bd", hist, w) + b)


def mamba_decode(p, x1, state, cfg):
    """Single-token step.  x1 (B,1,D); state {'h': (B,di,ds), 'conv':
    (B,dc-1,di)}.  As in the reference, the conv and ``x_proj`` run in the
    promotion of x1's dtype and the conv state's (f32 from ``init_cache``,
    x1's dtype from a prefill)."""
    di, ds, dt_rank = _mamba_dims(cfg)
    dc = cfg.ssm.d_conv
    xz = x1 @ p["in_proj"].to(x1.dtype)
    x_in, z = xz[..., :di], xz[..., di:]                                 # (B,1,di)
    hd = torch.promote_types(state["conv"].dtype, x1.dtype)
    hist = torch.cat([state["conv"].to(hd), x_in.to(hd)], dim=1)         # (B,dc,di)
    x_conv = _conv_step(hist[:, -dc:], p["conv_w"].to(x1.dtype).to(hd),
                        p["conv_b"].to(x1.dtype).to(hd))[:, None]        # (B,1,di)
    dbc = rows_only(x_conv @ p["x_proj"].to(x1.dtype).to(hd))
    dt, Bc, Cc = dbc[..., :dt_rank], dbc[..., dt_rank:dt_rank + ds], dbc[..., dt_rank + ds:]
    dt = F.softplus(dt.float() @ p["dt_proj"].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[:, 0, :, None] * A)                                 # (B,di,ds)
    b = dt[:, 0, :, None] * Bc[:, 0, None, :].float() * x_conv[:, 0, :, None].float()
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0].float())
    y = y + p["D_skip"].float() * x_conv[:, 0].float()
    y = (y * F.silu(z[:, 0].float())).to(x1.dtype)[:, None]
    out = y @ p["out_proj"].to(x1.dtype)
    return out, {"h": h, "conv": hist[:, 1:]}


def mamba_state_shape(cfg, batch: int):
    di, ds, _ = _mamba_dims(cfg)
    return {"h": (batch, di, ds), "conv": (batch, cfg.ssm.d_conv - 1, di)}


# ======================================================================
# mLSTM (chunkwise linear attention with matrix memory)
# ======================================================================
def init_mlstm(gen, cfg, *, stack: tuple = ()):
    D, nh, pd = cfg.d_model, cfg.num_heads, cfg.pdtype
    return {
        "wq": dense_init(gen, D, D, pd, stack=stack),
        "wk": dense_init(gen, D, D, pd, stack=stack),
        "wv": dense_init(gen, D, D, pd, stack=stack),
        "w_i": dense_init(gen, D, nh, pd, scale=0.02, stack=stack),
        "w_f": dense_init(gen, D, nh, pd, scale=0.02, stack=stack),
        "b_f": torch.full((*stack, nh), 3.0, dtype=pd, device=gen.device),   # long memory
        "w_z": dense_init(gen, D, D, pd, stack=stack),
        "out_proj": dense_init(gen, D, D, pd, stack=stack),
    }


def _mlstm_qkvif(p, x, cfg):
    B, S, D = x.shape
    nh = cfg.num_heads
    dh = D // nh
    q = split_heads(x @ p["wq"].to(x.dtype), B, S, nh, dh)
    k = split_heads(x @ p["wk"].to(x.dtype), B, S, nh, dh) * (dh ** -0.5)
    v = split_heads(x @ p["wv"].to(x.dtype), B, S, nh, dh)
    i = torch.sigmoid((x @ p["w_i"].to(x.dtype)).float())
    logf = F.logsigmoid((x @ p["w_f"].to(x.dtype)).float() + p["b_f"].float())
    return q, k, v, i, logf


@heads_local(2, 2, 2, 2, 2, 1, 1, out=(2, 1, 1))
def _mlstm_chunks(q, k, v, i, logf, C, n, ch: int):
    """The chunkwise recurrence over (B, S, nh, ·) gates and projections
    from the state (C, n): (h (B, S, nh·dh) f32, C, n); per batch row and
    head."""
    mask = torch.ones((ch, ch), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(q.shape[1] // ch):
        sl = slice(c * ch, (c + 1) * ch)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ib = i[:, sl]
        Fc = torch.cumsum(logf[:, sl], dim=1)                        # (B,ch,nh) ≤ 0
        # intra-chunk decayed attention: att[t,s] = (q_t k_s) e^{F_t - F_s} i_s
        scores = torch.einsum("bthd,bshd->bhts", qf, kf)
        Ft = Fc.transpose(1, 2)                                      # (B,nh,ch)
        decay = Ft[..., :, None] - Ft[..., None, :]
        att = torch.where(mask, torch.exp(decay) * ib.transpose(1, 2)[:, :, None, :], 0.0)
        att = att * scores
        num_intra = torch.einsum("bhts,bshd->bthd", att, vf)
        den_intra = att.sum(-1).transpose(1, 2)                      # (B,ch,nh)
        # inter-chunk
        ef = torch.exp(Fc)
        num_inter = torch.einsum("bthd,bhde->bthe", qf, C) * ef[..., None]
        den_inter = torch.einsum("bthd,bhd->bth", qf, n) * ef
        num = num_intra + num_inter
        den = (den_intra + den_inter).abs().clamp(min=1.0)
        hs.append(num / den[..., None])
        # state update: C' = e^{F_ch} C + Σ_s e^{F_ch - F_s} i_s k_s v_s^T
        w_s = torch.exp(Fc[:, -1:, :] - Fc) * ib                     # (B,ch,nh)
        f_last = torch.exp(Fc[:, -1])                                # (B,nh)
        C = C * f_last[:, :, None, None] + torch.einsum("bshd,bshe,bsh->bhde", kf, vf, w_s)
        n = n * f_last[..., None] + torch.einsum("bshd,bsh->bhd", kf, w_s)
    h = torch.cat(hs, dim=1)
    return h.reshape(*h.shape[:2], -1), C, n


def mlstm_forward(p, x, cfg, state=None):
    """x (B,S,D) -> (out, final state {'C': (B,nh,dh,dh), 'n': (B,nh,dh)})."""
    B, S, D = x.shape
    nh = cfg.num_heads
    dh = D // nh
    ch = _check_chunks(S, cfg.ssm.chunk_size)
    q, k, v, i, logf = _mlstm_qkvif(p, x, cfg)
    if state is None:
        C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
    else:
        C, n = state["C"], state["n"]
    h, C, n = _mlstm_chunks(q, k, v, i, logf, C, n, ch)
    h = h.reshape(B, S, D).to(x.dtype)
    z = x @ p["w_z"].to(x.dtype)
    out = (h * F.silu(z)) @ p["out_proj"].to(x.dtype)
    return out, {"C": C, "n": n}


@heads_local(1, 1, 1, 1, 1, 1, 1, out=(1, 1, 1))
def _mlstm_step(q, k, v, i0, logf, C, n):
    """One token's recurrence over (B, nh, ·): (h (B, nh, dh) f32, C, n);
    per batch row and head."""
    f = torch.exp(logf)                                              # (B,nh)
    kf, vf, qf = k.float(), v.float(), q.float()
    C = C * f[..., None, None] + i0[..., None, None] * torch.einsum("bhd,bhe->bhde", kf, vf)
    n = n * f[..., None] + i0[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.einsum("bhd,bhd->bh", qf, n).abs().clamp(min=1.0)
    return num / den[..., None], C, n


def mlstm_decode(p, x1, state, cfg):
    B = x1.shape[0]
    q, k, v, i, logf = _mlstm_qkvif(p, x1, cfg)                      # (B,1,...)
    h, C, n = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], i[:, 0], logf[:, 0],
                          state["C"], state["n"])
    h = h.reshape(B, 1, cfg.d_model).to(x1.dtype)
    z = x1 @ p["w_z"].to(x1.dtype)
    out = (h * F.silu(z)) @ p["out_proj"].to(x1.dtype)
    return out, {"C": C, "n": n}


def mlstm_state_shape(cfg, batch: int):
    nh = cfg.num_heads
    dh = cfg.d_model // nh
    return {"C": (batch, nh, dh, dh), "n": (batch, nh, dh)}


# ======================================================================
# sLSTM (sequential, exponential gating with stabilizer)
# ======================================================================
def init_slstm(gen, cfg, *, stack: tuple = ()):
    D, nh, pd = cfg.d_model, cfg.num_heads, cfg.pdtype
    dh = D // nh
    r = torch.empty((*stack, nh, dh, 4 * dh), device=gen.device).normal_(
        0.0, float(1.0 / np.sqrt(dh)), generator=gen)
    return {
        "w_in": dense_init(gen, D, 4 * D, pd, stack=stack),          # z,i,f,o stacked
        "r": r.to(pd),
        "b": torch.zeros((*stack, 4 * D), dtype=pd, device=gen.device),
        "out_proj": dense_init(gen, D, D, pd, stack=stack),
    }


def _slstm_step(p, xw, carry, cfg):
    """xw: the input projection for one step (B, 4D)."""
    B = xw.shape[0]
    nh = cfg.num_heads
    dh = cfg.d_model // nh
    c, n, h, m = carry                                               # each (B,nh,dh)
    rec = torch.einsum("bhd,hde->bhe", h, p["r"].to(h.dtype))        # (B,nh,4dh)
    pre = xw.reshape(B, nh, 4 * dh).float() + rec.float()
    z_, i_, f_, o_ = pre.split(dh, dim=-1)
    z = torch.tanh(z_)
    o = torch.sigmoid(o_)
    log_fm = F.logsigmoid(f_) + m                                    # sigmoid forget
    m_new = torch.maximum(log_fm, i_)
    i_g = torch.exp(i_ - m_new)
    f_g = torch.exp(log_fm - m_new)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    h_new = o * c_new / n_new.abs().clamp(min=1.0)
    return c_new, n_new, h_new, m_new


@heads_local(None, 0, 0, 0, 0, 0, out=(0, 0, 0, 0, 0), keep_heads=True)
def _slstm_scan(r, xw, c, n, h, m, cfg):
    """The time loop over xw (B, S, 4D) from the carry (c, n, h, m): (h
    (B, S, D) of every step, the last carry); per batch row."""
    hs = []
    carry = (c, n, h, m)
    for t in range(xw.shape[1]):
        carry = _slstm_step({"r": r}, xw[:, t], carry, cfg)
        hs.append(carry[2])
    h = torch.stack(hs, dim=1)
    return (h.reshape(*h.shape[:2], -1), *carry)


def slstm_forward(p, x, cfg, state=None):
    B, S, D = x.shape
    nh = cfg.num_heads
    dh = D // nh
    xw = x @ p["w_in"].to(x.dtype) + p["b"].to(x.dtype)             # (B,S,4D)
    if state is None:
        # m starts at 0 (not -inf), so a zero decode state equals a fresh forward
        zeros = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, zeros, zeros)
    else:
        carry = (state["c"], state["n"], state["h"], state["m"])
    h, c, n, hh, m = _slstm_scan(p["r"], xw, *carry, cfg)
    h = h.reshape(B, S, D).to(x.dtype)
    out = h @ p["out_proj"].to(x.dtype)
    return out, {"c": c, "n": n, "h": hh, "m": m}


@heads_local(None, 0, 0, 0, 0, 0, out=(0, 0, 0, 0), keep_heads=True)
def _slstm_decode_step(r, xw, c, n, h, m, cfg):
    """One time step of the recurrence: the new (c, n, h, m); per batch
    row."""
    return _slstm_step({"r": r}, xw, (c, n, h, m), cfg)


def slstm_decode(p, x1, state, cfg):
    xw = (x1 @ p["w_in"].to(x1.dtype) + p["b"].to(x1.dtype))[:, 0]
    c, n, h, m = _slstm_decode_step(p["r"], xw, state["c"], state["n"], state["h"],
                                    state["m"], cfg)
    B = x1.shape[0]
    out = h.reshape(B, 1, cfg.d_model).to(x1.dtype) @ p["out_proj"].to(x1.dtype)
    return out, {"c": c, "n": n, "h": h, "m": m}


def slstm_state_shape(cfg, batch: int):
    nh = cfg.num_heads
    s = (batch, nh, cfg.d_model // nh)
    return {"c": s, "n": s, "h": s, "m": s}
