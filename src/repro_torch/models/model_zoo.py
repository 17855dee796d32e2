"""Model zoo: dense GQA, MLA + MoE, xLSTM and hybrid Mamba decoders, and
the audio encoder and VLM decoder behind their stubbed frontends (port of
``repro/models/model_zoo.py``).

The parameter tree is the reference's: ``embed``, ``final_norm``,
``lm_head`` (unless tied), an optional unrolled ``prefix`` list and
``blocks``, whose leaves are stacked on a leading ``n_super`` axis (48 for
Qwen2.5-14B; DeepSeek-V2-Lite's dense layer 0 is the prefix and its 26
MLA + MoE layers the stack, period 1; xLSTM-1.3B's 12 superblocks of three
mLSTM and one sLSTM block; Jamba's superblocks of 8, the 8th attention).
The reference scans that axis; the port loops over it in Python and
indexes layer ``i``, so one layer's paged pool ``pool[i]`` is a contiguous
``(nb, bs, Hkv, dh)`` tensor the decode kernel reads directly.  Each block
returns the router's aux loss (zero for a dense FFN); ``loss`` adds
``router_aux_coef · aux / #MoE layers``.

The frontends take precomputed embeddings, as the reference's do: a
``frontend`` subtree (``proj1`` (frontend_dim, D), ``proj2`` (D, D), and
for audio a ``mask_embed`` (D,)) maps them through ``gelu(e @ proj1) @
proj2``.  HuBERT (audio, ``causal=False``) reads only frames, swaps in
``mask_embed`` where ``batch["mask"]`` is set and scores the cross-entropy
at those frames; its ``embed`` is a parameter the loss never reaches.
LLaVA (VLM) splices the projected patch embeddings over its first P token
positions and, with no ``loss_mask``, scores the positions from
``num_prefix_embeds`` on.

Decode caches and paged pools are updated in place (the reference's
jitted callers donate them): an attention decode writes its row, and a
recurrent mixer copies its new state into its layer's view of the cache.
Prefill returns fresh caches.  Recurrent states stay f32 under any
compute dtype, as the reference's ``_cache_dtype`` keeps them.  Paged
serving is all-GQA only, as in the reference: MLA's latent cache and the
recurrent states serve through the static path.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.sharding.local import (embed_rows, fsdp_gather, is_dtensor, rows_only,
                                        vocab_product)
from repro_torch.models.layers import (apply_mlp, apply_norm, cross_entropy, dense_init,
                                       embed_init, init_mlp, init_norm)


# ======================================================================
# layer schedule
# ======================================================================
@dataclass(frozen=True)
class BlockKind:
    mixer: str   # gqa | mla | mamba | mlstm | slstm
    ffn: str     # dense | moe | none


def layer_schedule(cfg: ModelConfig) -> list[BlockKind]:
    """Per-layer (mixer, ffn) kinds, the reference's: xLSTM puts an sLSTM
    at every ``xlstm_slstm_ratio``-th block and has no FFN; a hybrid puts
    attention where ``attn_layer_flags`` says and its SSM variant
    elsewhere."""
    attn_flags = cfg.attn_layer_flags()
    moe_flags = cfg.moe_layer_flags()
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm" and cfg.ssm.variant == "xlstm":
            r = cfg.ssm.xlstm_slstm_ratio
            mixer = "slstm" if (r and i % r == r - 1) else "mlstm"
            ffn = "none"
        elif attn_flags[i]:
            mixer = "mla" if cfg.mla is not None else "gqa"
            ffn = "moe" if moe_flags[i] else "dense"
        else:  # hybrid non-attention layer
            mixer = cfg.ssm.variant
            ffn = "moe" if moe_flags[i] else "dense"
        if cfg.d_ff == 0 and ffn == "dense":
            ffn = "none"
        kinds.append(BlockKind(mixer, ffn))
    return kinds


def split_schedule(kinds: list[BlockKind]) -> tuple[int, int]:
    """Return (prefix_len, period): repeating superblock period covering
    everything after a small unrolled prefix.  SMALLEST PERIOD wins, then
    smallest prefix (the reference's rule, kept so the trees match)."""
    L = len(kinds)
    for p in range(1, L + 1):
        for q in range(0, min(4, L - p) + 1):
            rest = kinds[q:]
            n = len(rest)
            if n % p == 0 and all(rest[i] == rest[i % p] for i in range(n)):
                return q, p
    return 0, L


# products with no batch dims: what the reference's
# ``dots_with_no_batch_dims_saveable`` policy saves under ``remat="dots"``
_SAVED_DOTS = ("mm", "addmm")


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op.overloadpacket.__name__ in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_context(remat: bool | str):
    """``checkpoint``'s ``context_fn`` for a ``remat`` setting: the default
    (save nothing inside) for ``True``, the selective policy for
    ``"dots"``."""
    from torch.utils.checkpoint import (create_selective_checkpoint_contexts,
                                        noop_context_fn)
    if remat == "dots":
        return lambda: create_selective_checkpoint_contexts(_save_dots)
    if remat is True:
        return noop_context_fn
    raise ValueError(f"remat={remat!r}: False, True or 'dots'")


def _layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree (views, no copies), split by one
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would give each layer's gradient as a
    zero tensor of the whole stack and sum ``n`` of them."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ======================================================================
# single block
# ======================================================================
def init_block(gen, cfg: ModelConfig, kind: BlockKind, *, stack: tuple = ()):
    p: dict[str, Any] = {"norm1": init_norm(cfg, gen.device, stack=stack)}
    if kind.mixer == "mla":
        p["attn"] = attn.init_mla(gen, cfg, stack=stack)
    elif kind.mixer == "gqa":
        p["attn"] = attn.init_gqa(gen, cfg, stack=stack)
    else:
        p["ssm"] = getattr(ssm_lib, f"init_{kind.mixer}")(gen, cfg, stack=stack)
    if kind.ffn != "none":
        p["norm2"] = init_norm(cfg, gen.device, stack=stack)
        if kind.ffn == "moe":
            p["moe"] = moe_lib.init_moe(gen, cfg, stack=stack)
        else:
            p["mlp"] = init_mlp(gen, cfg, stack=stack)
    return p


def apply_block(p, x, cfg: ModelConfig, kind: BlockKind, *, mode: str,
                cache=None, pos=None):
    """Returns (x, cache, aux): the new prefill cache, the (in-place
    updated) decode cache, or None in ``train`` mode; the router's aux loss
    (0 for a dense FFN)."""
    aux = torch.zeros((), device=x.device)
    x, p = rows_only(x), fsdp_gather(p)
    h = apply_norm(p["norm1"], x, cfg)
    if kind.mixer in ("mamba", "mlstm", "slstm"):
        # looked up at call time, so a caller can wrap a mixer's function
        if mode == "decode":
            a, state = getattr(ssm_lib, f"{kind.mixer}_decode")(p["ssm"], h, cache, cfg)
            for k, v in state.items():
                cache[k].copy_(v)
            new_cache = cache
        else:
            a, state = getattr(ssm_lib, f"{kind.mixer}_forward")(p["ssm"], h, cfg)
            new_cache = state if mode == "prefill" else None
    elif mode == "paged":
        # init_paged_cache refuses non-GQA schedules up front
        assert kind.mixer == "gqa", kind.mixer
        a, new_cache = attn.gqa_paged_decode(p["attn"], h, cache, cfg, pos)
    elif mode == "decode":
        fwd = attn.mla_decode if kind.mixer == "mla" else attn.gqa_decode
        a, new_cache = fwd(p["attn"], h, cache, cfg, pos)
    else:
        fwd = attn.mla_forward if kind.mixer == "mla" else attn.gqa_forward
        a, kv = fwd(p["attn"], h, cfg)
        new_cache = None
        if mode == "prefill":
            new_cache = ({"c_kv": kv[0], "k_rope": kv[1]} if kind.mixer == "mla"
                         else {"k": kv[0], "v": kv[1]})
    x = x + rows_only(a)
    if kind.ffn != "none":
        h = apply_norm(p["norm2"], x, cfg)
        if kind.ffn == "moe":
            out, aux = moe_lib.moe_ffn(p["moe"], h.reshape(-1, h.shape[-1]), cfg)
            out = out.reshape(h.shape)
        else:
            out = apply_mlp(p["mlp"], h, cfg)
        x = x + rows_only(out)
    return x, new_cache, aux


def block_cache_shapes(cfg: ModelConfig, kind: BlockKind, batch: int, seq_len: int):
    if kind.mixer == "gqa":
        return attn.gqa_cache_shape(cfg, batch, seq_len)
    if kind.mixer == "mla":
        return attn.mla_cache_shape(cfg, batch, seq_len)
    if kind.mixer in ("mamba", "mlstm", "slstm"):
        return getattr(ssm_lib, f"{kind.mixer}_state_shape")(cfg, batch)
    raise ValueError(kind.mixer)


def _cache_dtype(cfg: ModelConfig, kind: BlockKind):
    """Recurrent states stay f32; KV caches follow the compute dtype."""
    if kind.mixer in ("mamba", "mlstm", "slstm"):
        return torch.float32
    return cfg.cdtype


# ======================================================================
# Model
# ======================================================================
class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---- structure ---------------------------------------------------
    @cached_property
    def schedule(self) -> list[BlockKind]:
        return layer_schedule(self.cfg)

    @cached_property
    def prefix_period(self) -> tuple[int, int]:
        return split_schedule(self.schedule)

    @property
    def superblock(self) -> list[BlockKind]:
        q, p = self.prefix_period
        return self.schedule[q:q + p]

    @property
    def n_super(self) -> int:
        q, p = self.prefix_period
        return (len(self.schedule) - q) // p if p else 0

    # ---- init ---------------------------------------------------------
    def init(self, seed: int, device=None) -> dict:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        the device itself (no host init + copy).  The numbers differ from
        ``jax.random``'s; tests carry the reference's weights across with
        ``interop.params_from_numpy`` instead."""
        gen = torch.Generator(device=device_lib.resolve(device))
        gen.manual_seed(seed)
        return self.init_from(gen)

    def init_from(self, gen: torch.Generator) -> dict:
        """Random weights drawn from ``gen`` on its own device (the form a
        ``FedTask.init_fn`` takes)."""
        cfg, dev = self.cfg, gen.device
        q, _ = self.prefix_period
        params: dict[str, Any] = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype),
            "final_norm": init_norm(cfg, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                           cfg.pdtype, scale=0.02)
        if cfg.frontend_dim:
            params["frontend"] = {
                "proj1": dense_init(gen, cfg.frontend_dim, cfg.d_model, cfg.pdtype),
                "proj2": dense_init(gen, cfg.d_model, cfg.d_model, cfg.pdtype),
            }
            if cfg.family == "audio":
                params["frontend"]["mask_embed"] = (
                    torch.randn(cfg.d_model, generator=gen, device=dev) * 0.02
                ).to(cfg.pdtype)
        if q:
            params["prefix"] = [init_block(gen, cfg, self.schedule[i])
                                for i in range(q)]
        if self.n_super:
            params["blocks"] = {
                f"b{j}": init_block(gen, cfg, kind, stack=(self.n_super,))
                for j, kind in enumerate(self.superblock)}
        return params

    # ---- embedding in / logits out ------------------------------------
    def _frontend(self, params, embeds):
        """``gelu(embeds @ proj1) @ proj2`` in the compute dtype (the tanh
        gelu, ``jax.nn.gelu``'s)."""
        cd, fe = self.cfg.cdtype, fsdp_gather(params["frontend"])
        x = embeds.to(cd) @ fe["proj1"].to(cd)
        return rows_only(F.gelu(x, approximate="tanh") @ fe["proj2"].to(cd))

    def _embed_in(self, params, batch):
        cfg = self.cfg
        if cfg.family == "audio":
            x = self._frontend(params, batch["embeds"])
            if "mask" in batch:
                me = fsdp_gather(params["frontend"]["mask_embed"]).to(cfg.cdtype)
                x = torch.where(batch["mask"][..., None], me, x)
            return x
        table = fsdp_gather(params["embed"])
        x = (rows_only(embed_rows(table, batch["tokens"])) if is_dtensor(table)
             else table[batch["tokens"].long()]).to(cfg.cdtype)
        if cfg.tie_embeddings:
            x = x * torch.full((), float(np.sqrt(cfg.d_model)), dtype=cfg.cdtype,
                               device=x.device)
        if cfg.family == "vlm" and "embeds" in batch:
            pe = self._frontend(params, batch["embeds"])
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return x

    def head(self, params):
        """(D, V) LM-head matrix: the tied-embedding transpose or ``lm_head``."""
        return fsdp_gather(params["embed"].T if self.cfg.tie_embeddings
                           else params["lm_head"])

    def _logits_out(self, params, x):
        x = apply_norm(params["final_norm"], rows_only(x), self.cfg)
        head = self.head(params).to(x.dtype)
        return vocab_product(x, head) if is_dtensor(x) else x @ head

    def features(self, params, batch, *, remat: bool | str = False):
        """(B, S, D) post-final-norm hidden states, the LM-head input:
        ``logits == features @ head``.  The head-fused KD path consumes this
        instead of ``logits``, so the (B·S, V) student row never exists."""
        x = self._embed_in(params, batch)
        x, _, _ = self._stack_forward(params, x, mode="train", remat=remat)
        return apply_norm(params["final_norm"], rows_only(x), self.cfg)

    # ---- the layer stack ----------------------------------------------
    def _stack_forward(self, params, x, *, mode: str, caches=None, pos=None,
                       remat: bool | str = False):
        """Returns (x, caches, aux summed over the layers).

        ``remat`` (the reference's ``jax.checkpoint`` of its scan body) wraps
        each superblock, in ``train`` mode: ``True`` keeps only its input and
        recomputes the rest in the backward; ``"dots"`` also keeps the
        outputs of products with no batch dims (``_save_dots``).  The
        prefix layers and the head stay outside, as in the reference."""
        cfg = self.cfg
        q, _ = self.prefix_period
        aux_total = torch.zeros((), device=x.device)
        new_prefix = []
        for i in range(q):
            c = caches["prefix"][i] if caches else None
            x, nc, aux = apply_block(params["prefix"][i], x, cfg, self.schedule[i],
                                     mode=mode, cache=c, pos=pos)
            new_prefix.append(nc)
            aux_total = aux_total + aux
        new_blocks = None
        if self.n_super:
            per_layer = []
            layer_params = _layers(params["blocks"], self.n_super)
            layer_caches = _layers(caches["blocks"], self.n_super) if caches else None
            for i in range(self.n_super):
                bp = layer_params[i]
                if remat and mode == "train":
                    x, aux_total = checkpoint(self._superblock_train, bp, x, aux_total,
                                              use_reentrant=False,
                                              context_fn=remat_context(remat))
                    continue
                bc = layer_caches[i] if caches else None
                ncs = {}
                for j, kind in enumerate(self.superblock):
                    x, ncs[f"b{j}"], aux = apply_block(
                        bp[f"b{j}"], x, cfg, kind, mode=mode,
                        cache=bc[f"b{j}"] if bc else None, pos=pos)
                    aux_total = aux_total + aux
                per_layer.append(ncs)
            if mode == "prefill":
                new_blocks = _stack(per_layer)
            elif caches:
                new_blocks = caches["blocks"]       # updated in place
        out_caches = None
        if mode in ("prefill", "decode", "paged"):
            out_caches = {"prefix": new_prefix, "blocks": new_blocks}
        return x, out_caches, aux_total

    def _superblock_train(self, bp, x, aux_total):
        """One superblock's layers in ``train`` mode (the unit ``remat``
        recomputes): (x, aux_total)."""
        for j, kind in enumerate(self.superblock):
            x, _, aux = apply_block(bp[f"b{j}"], x, self.cfg, kind, mode="train")
            aux_total = aux_total + aux
        return x, aux_total

    # ---- public API ------------------------------------------------------
    def logits(self, params, batch, *, remat: bool | str = False):
        """Full-sequence forward: (logits (B,S,V), the router aux loss
        summed over the MoE layers; 0 with dense FFNs)."""
        x = self._embed_in(params, batch)
        x, _, aux = self._stack_forward(params, x, mode="train", remat=remat)
        return self._logits_out(params, x), aux

    def loss(self, params, batch, *, remat: bool | str = False):
        """Next-token cross-entropy over the batch, masked by the optional
        ``loss_mask`` (a VLM's default: the positions from
        ``num_prefix_embeds`` on), or for audio the cross-entropy at the
        frames ``batch["mask"]`` sets; plus ``router_aux_coef · aux / #MoE
        layers`` for a MoE config; returns (loss, {"ce", "moe_aux"}) — "ce"
        is the total, as in the reference."""
        cfg = self.cfg
        logits, aux = self.logits(params, batch, remat=remat)
        labels = batch["labels"]
        if cfg.family == "audio":
            mask = batch.get("mask")
        else:
            mask = batch.get("loss_mask")
            if cfg.family == "vlm" and mask is None:
                S = labels.shape[1]
                mask = (torch.arange(S, device=labels.device)
                        >= cfg.num_prefix_embeds).expand(labels.shape)
        loss = cross_entropy(logits, labels, mask)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_coef * aux / max(1, sum(cfg.moe_layer_flags()))
        return loss, {"ce": loss, "moe_aux": aux}

    def prefill(self, params, batch, *, last=None):
        """Returns (last-token logits (B,V), caches).

        ``last`` (B,) — per-request index of the true final prompt token,
        for right-padded ragged batches.  Default reads position S-1.
        """
        x = self._embed_in(params, batch)
        x, caches, _ = self._stack_forward(params, x, mode="prefill")
        if last is None:
            x_last = x[:, -1:]
        else:
            last = device_lib.to_device(torch.as_tensor(last), x.device).long()
            x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return self._logits_out(params, x_last)[:, 0], caches

    def paged_decode_step(self, params, tokens, caches, block_tables,
                          seq_lens):
        """ONE token against a paged pool shared across requests.

        tokens (B,1) int; block_tables (B,nbmax) int32; seq_lens (B,) int32
        tokens already in the cache (0 = inactive slot).  The new token's
        K/V is written into ``caches`` in place at
        ``[block_tables[b, seq_lens[b]//bs], seq_lens[b]%bs]``.
        -> (logits (B,V), caches).
        """
        x = self._embed_in(params, {"tokens": tokens})
        x, caches, _ = self._stack_forward(params, x, mode="paged", caches=caches,
                                           pos=(block_tables, seq_lens))
        return self._logits_out(params, x)[:, 0], caches

    def decode_step(self, params, tokens, caches, pos):
        """tokens (B,1) int; pos a 0-d int tensor on the device (a step
        program's position, never read back to the host) or an int, made
        that tensor once here.  -> (logits (B,V), caches), the caches
        written in place at ``pos``."""
        pos = attn.device_position(pos, tokens.device)
        x = self._embed_in(params, {"tokens": tokens})
        x, caches, _ = self._stack_forward(params, x, mode="decode",
                                           caches=caches, pos=pos)
        return self._logits_out(params, x)[:, 0], caches

    # ---- caches ----------------------------------------------------------
    def _shape_tree(self, shape_of):
        """{"prefix": [...], "blocks": {...}} of (shape, dtype) leaves:
        ``shape_of(kind)`` is one layer's {name: shape}, stacked
        (n_super, ...) for the superblock's layers."""
        cfg = self.cfg
        q, _ = self.prefix_period
        prefix = [{k: (s, _cache_dtype(cfg, self.schedule[i]))
                   for k, s in shape_of(self.schedule[i]).items()} for i in range(q)]
        blocks = None
        if self.n_super:
            blocks = {f"b{j}": {k: ((self.n_super, *s), _cache_dtype(cfg, kind))
                                for k, s in shape_of(kind).items()}
                      for j, kind in enumerate(self.superblock)}
        return {"prefix": prefix, "blocks": blocks}

    def cache_shapes(self, batch: int, seq_len: int):
        """Shape pytree of the contiguous caches, each leaf (shape, torch
        dtype): GQA leaves (B, S, Hkv, dh), MLA's latent ``c_kv`` (B, S,
        rank) and ``k_rope`` (B, S, rope), the recurrent states (f32, no
        sequence axis); stacked (n_super, ...)."""
        return self._shape_tree(
            lambda kind: block_cache_shapes(self.cfg, kind, batch, seq_len))

    def paged_cache_shapes(self, num_blocks: int, block_size: int):
        """Shape pytree of ONE paged pool shared by all in-flight requests:
        every layer's k/v lives in ``(num_blocks, block_size, Hkv, dh)``
        blocks addressed through per-request block tables.  Paged serving
        is attention-only: MLA latent caches have no per-head K/V to page
        and recurrent states no sequence axis, so a schedule that is not
        all GQA raises the reference's ``ValueError``."""
        bad = {k.mixer for k in self.schedule if k.mixer != "gqa"}
        if bad:
            raise ValueError(
                f"paged serving supports all-GQA schedules only, got "
                f"mixer(s) {sorted(bad)} — use the contiguous static path")
        shape = attn.gqa_paged_cache_shape(self.cfg, num_blocks, block_size)
        return self._shape_tree(lambda kind: shape)

    @staticmethod
    def _zeros(shapes, device):
        """Zero tensors for a shape pytree of ``_shape_tree``'s form."""
        dev = device_lib.resolve(device)

        def layer(blk):
            return {k: torch.zeros(s, dtype=dt, device=dev) for k, (s, dt) in blk.items()}
        blocks = shapes["blocks"]
        return {"prefix": [layer(blk) for blk in shapes["prefix"]],
                "blocks": None if blocks is None else {j: layer(b) for j, b in blocks.items()}}

    def init_cache(self, batch: int, seq_len: int, device=None):
        """Zero contiguous caches of ``cache_shapes``."""
        return self._zeros(self.cache_shapes(batch, seq_len), device)

    def init_paged_cache(self, num_blocks: int, block_size: int, device=None):
        """The zero paged pool of ``paged_cache_shapes``."""
        return self._zeros(self.paged_cache_shapes(num_blocks, block_size), device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
