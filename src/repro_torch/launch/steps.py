"""The three step functions and per-(arch × shape) input specs (port of
``repro/launch/steps.py``).

``input_specs`` returns ``device="meta"`` tensors for every model input:
the shapes and dtypes a step consumes, with nothing allocated (the
parameters come from an init traced under ``FakeTensorMode``), which is
what a dry run over the full-size configurations needs.

Shape kind → step:
  train_4k    → train_step   loss + grad + SGD update (the FedSDD client step)
  prefill_32k → prefill_step forward + cache build
  decode_32k / long_500k → serve_step: ONE token against a seq_len cache

Dense and VLM architectures get ``attn_variant='sliding'`` for long_500k
(the sub-quadratic requirement); starcoder2 and llama4 are natively
sliding already.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.utils.pytree import tree_map


# ---------------------------------------------------------------- overrides
def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    if (shape.name == "long_500k" and cfg.family in ("dense", "vlm")
            and cfg.attn_variant != "sliding"):
        cfg = dataclasses.replace(cfg, attn_variant="sliding", sliding_window=4096)
    return cfg


def supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason-if-not): the skip matrix."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k":
        eff = config_for_shape(cfg, shape)
        if not eff.supports_long_context():
            return False, "full attention is quadratic at 500k"
    return True, ""


# ---------------------------------------------------------------- steps
def make_train_step(model: Model, lr: float = 0.1, remat: bool | str = True):
    """Client local-training step: loss → grad → plain SGD (paper §4.1),
    each superblock recomputed in the backward by default (``remat``), as
    the reference's step does."""
    grad_fn = value_and_grad(lambda p, b: model.loss(p, b, remat=remat)[0])

    def train_step(params, batch):
        loss, grads = grad_fn(params, batch)
        new_params = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return loss, new_params

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, tokens, caches, pos):
        return model.decode_step(params, tokens, caches, pos)
    return serve_step


# ---------------------------------------------------------------- specs
def _sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a ``meta`` tensor (no storage)."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, Any]:
    """Meta tensors for the data batch of train/prefill steps."""
    B = shape.global_batch
    S = shape.seq_len
    if cfg.family == "audio":
        d = {"embeds": _sds((B, S, cfg.frontend_dim), cfg.cdtype)}
        if shape.kind == "train":
            d["labels"] = _sds((B, S), torch.int32)
            d["mask"] = _sds((B, S), torch.bool)
        return d
    d = {"tokens": _sds((B, S), torch.int32)}
    if shape.kind == "train":
        d["labels"] = _sds((B, S), torch.int32)
    if cfg.family == "vlm":
        P = min(cfg.num_prefix_embeds, S // 2)
        d["embeds"] = _sds((B, P, cfg.frontend_dim), cfg.cdtype)
    return d


def cache_specs(model: Model, shape: InputShape) -> Any:
    shapes = model.cache_shapes(shape.global_batch, shape.seq_len)

    def layer(blk):
        return {k: _sds(s, dt) for k, (s, dt) in blk.items()}
    blocks = shapes["blocks"]
    return {"prefix": [layer(blk) for blk in shapes["prefix"]],
            "blocks": None if blocks is None else {j: layer(b) for j, b in blocks.items()}}


def param_specs(model: Model) -> Any:
    """Meta tensors of the parameter tree: the init runs under
    ``FakeTensorMode``, so no weight is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = model.init(0, device="cpu")
    return tree_map(lambda x: _sds(x.shape, x.dtype), params)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, Any]:
    """Everything the step consumes, as meta tensors:
      train/prefill: {params, batch}
      decode:        {params, tokens, caches, pos}
    """
    cfg = config_for_shape(cfg, shape)
    model = build_model(cfg)
    out: dict[str, Any] = {"params": param_specs(model)}
    if shape.kind in ("train", "prefill"):
        out["batch"] = batch_specs(cfg, shape)
    else:
        out["tokens"] = _sds((shape.global_batch, 1), torch.int32)
        out["caches"] = cache_specs(model, shape)
        out["pos"] = _sds((), torch.int32)
    return out


# ------------------------------------------------- FedSDD round specs
def fedsdd_round_specs(cfg: ModelConfig, shape: InputShape, *,
                       K: int = 2, clients_per_group: int = 16,
                       client_batch: int | None = None,
                       server_batch: int = 8,
                       local_steps: int = 1,
                       period_mult: int = 1) -> dict[str, Any]:
    """Specs of a FedSDD round's arguments, stacked over K groups × N
    clients.  The port's models stack one period of layers
    (``period_mult`` 1); the reference's longer scan periods come with the
    mesh (ROADMAP.md §A, torch.distributed)."""
    if period_mult != 1:
        raise ValueError("the port's models stack one period of layers: period_mult=1")
    model = build_model(cfg)
    p = param_specs(model)
    B = client_batch or max(local_steps, shape.global_batch // (K * clients_per_group))
    B = max(B, local_steps)
    S = shape.seq_len
    stacked = tree_map(lambda x: _sds((K,) + tuple(x.shape), x.dtype), p)

    def per_client(spec_dict):
        return {k: _sds((K, clients_per_group) + tuple(v.shape), v.dtype)
                for k, v in spec_dict.items()}

    tb = InputShape("t", S, B, "train")
    return {
        "stacked_globals": stacked,
        "client_batches": per_client(batch_specs(cfg, tb)),
        "client_weights": _sds((K, clients_per_group), torch.float32),
        "server_batch": batch_specs(cfg, InputShape("s", S, server_batch, "prefill")),
    }
