"""PartitionSpec policies per architecture family × input shape (port of
``repro/sharding/specs.py``).

Conventions on the production mesh:
  axis "data"  — batch / clients / (for long_500k) the KV-cache sequence
  axis "model" — tensor parallel: attention projections are sharded on the
                 flattened H·dh dim, FFN on the hidden dim, MoE expert banks
                 on the expert dim, SSM blocks on the inner/state channels
  axis "pod"   — K FedSDD groups (core/distributed.py) or extra data
                 parallelism for plain scale-out

FSDP configs (≥10 B params) additionally shard the non-'model' weight dim
over "data".  A dim is only sharded when divisible by the axis size —
otherwise the leaf falls back to replication on that dim.

The trees are the port's (``interop.py``: the reference's keys and stacked
axes), walked by key path.  A spec is the port's own ``PartitionSpec``: a
tuple holding, for each leading dim, an axis name, a tuple of names, or
``None``; dims past its end are replicated.  ``to_shardings`` turns specs
into DTensor placements over a ``torch.distributed`` ``DeviceMesh``.  A
mesh here is anything whose ``.shape`` maps each axis name to its size, as
the reference's does (``launch.mesh.Mesh``, or a shape-only stand-in).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape

# The vectorized client engine's stacking axis (launch.mesh.make_client_mesh)
CLIENT_AXIS = "clients"


class PartitionSpec(tuple):
    """For each leading dim of a leaf: an axis name, a tuple of axis names
    (the dim split over their product, the first the outermost), or
    ``None`` (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples; a ``PartitionSpec`` is a leaf, ``None`` stays ``None``."""
    if isinstance(tree, PartitionSpec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def client_stack_pspec(stacked_tree):
    """P('clients', None, ...) for every leaf of a client-stacked tree
    (params, optimizer state, or per-step batch stacks): the leading axis
    is the stacked-client dim, everything else replicated."""
    return _map_path(lambda _, x: P(CLIENT_AXIS, *([None] * (x.ndim - 1))), stacked_tree)


# ---------------------------------------------------------------- helpers
def _keystr(path) -> str:
    """'/'-joined key path (dict keys, list indices, NamedTuple fields)."""
    return "/".join(str(p) for p in path)


def _axis_size(mesh, name: Optional[str]) -> int:
    if name is None:
        return 1
    return mesh.shape[name]


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    size = math.prod(_axis_size(mesh, a) for a in
                     (axis if isinstance(axis, tuple) else (axis,)))
    return dim % size == 0


def _maybe(dim: int, mesh, axis):
    return axis if _fits(dim, mesh, axis) else None


# ---------------------------------------------------------------- params
# (regex on the '/'-joined path, logical spec for the TRAILING dims;
#  leading stacked axes are padded with None)
def _param_rules(fsdp: Optional[str], tp: str):
    d = fsdp  # data-axis shard for fsdp configs, else None
    return [
        (r"embed$",                   (tp, d)),
        (r"lm_head$",                 (d, tp)),
        (r"frontend/proj1$",          (None, tp)),
        (r"frontend/proj2$",          (tp, None)),
        (r"frontend/mask_embed$",     (None,)),
        # attention (gqa + mla)
        (r"attn/w[qkv]$",             (d, tp)),
        (r"attn/b[qkv]$",             (tp,)),
        (r"attn/wo$",                 (tp, d)),
        (r"attn/w_dkv$",              (d, None)),
        (r"attn/kv_norm_scale$",      (None,)),
        (r"attn/w_u[kv]$",            (None, tp)),
        # moe
        (r"moe/router$",              (d, None)),
        (r"moe/w_(in|gate)$",         (tp, d, None)),
        (r"moe/w_out$",               (tp, None, d)),
        (r"moe/shared/w_(in|gate)$",  (d, tp)),
        (r"moe/shared/w_out$",        (tp, d)),
        # dense mlp
        (r"mlp/w_(in|gate)$",         (d, tp)),
        (r"mlp/w_out$",               (tp, d)),
        # mamba
        (r"ssm/in_proj$",             (d, tp)),
        (r"ssm/conv_[wb]$",           None),        # tiny; replicate
        (r"ssm/x_proj$",              (tp, None)),
        (r"ssm/dt_proj$",             (None, tp)),
        (r"ssm/dt_bias$",             (tp,)),
        (r"ssm/A_log$",               (tp, None)),
        (r"ssm/D_skip$",              (tp,)),
        (r"ssm/out_proj$",            (tp, d)),
        # mlstm
        (r"ssm/w[qkvz]$",             (d, tp)),
        (r"ssm/w_[if]$",              (d, None)),
        (r"ssm/b_f$",                 (None,)),
        # slstm (small; replicate)
        (r"ssm/w_in$",                (d, None)),
        (r"ssm/r$",                   None),
        (r"ssm/b$",                   (None,)),
        (r"ssm/out_proj$",            (tp, d)),
        # norms / everything 1-D
        (r"(norm|scale|bias)",        None),
    ]


def param_pspec(params_shapes, cfg: ModelConfig, mesh,
                tp_axis: str = "model",
                fsdp_axis: Optional[str] = None):
    """PartitionSpec tree mirroring the params tree (of tensors or ``meta``
    stand-ins)."""
    fsdp = fsdp_axis if cfg.fsdp else None
    rules = [(re.compile(pat), spec) for pat, spec in _param_rules(fsdp, tp_axis)]

    def assign(path, leaf):
        pstr = _keystr(path)
        shape = tuple(leaf.shape)
        for pat, logical in rules:
            if pat.search(pstr):
                if logical is None:
                    return P()
                nlead = len(shape) - len(logical)
                if nlead < 0:   # e.g. 1-D bias matched a 2-D rule: replicate
                    return P()
                full = (None,) * nlead + tuple(logical)
                return P(*(_maybe(shape[i], mesh, a) for i, a in enumerate(full)))
        return P()  # default: replicate

    return _map_path(assign, params_shapes)


# ---------------------------------------------------------------- batches
def batch_pspec(batch_shapes, shape: InputShape, mesh, batch_axis="data"):
    """Shard the leading (batch) dim of every input leaf over `batch_axis`
    (falls back to replication when batch < axis size, e.g. long_500k)."""

    def assign(_, leaf):
        ax = _maybe(leaf.shape[0], mesh, batch_axis)
        return P(ax, *([None] * (len(leaf.shape) - 1)))

    return _map_path(assign, batch_shapes)


# ---------------------------------------------------------------- caches
def cache_pspec(cache_shapes, cfg: ModelConfig, mesh, *,
                batch_axis="data", tp_axis="model", seq_on_data: bool = False,
                seq_axis: Optional[str] = None):
    """KV caches / SSM states for serve_step.

    Layouts handled:
      (n_super, B, S, Hkv, dh)  attn k/v      → B@data, (Hkv|dh)@model
      (n_super, B, S, rank)     mla latents   → B@data, rank@model
      (n_super, B, di, ds)      mamba h       → B@data, di@model
      (n_super, B, nh, dk, dv)  mlstm C       → B@data, (nh|dk)@model
      (n_super, B, x, di)       conv state    → B@data, di@model

    ``seq_on_data``: long_500k (B=1) — shard the cache SEQUENCE over data.
    ``seq_axis``: explicit axis for the cache sequence dim (the split-K
    layout: batch@data + seq@model instead of heads/dh@model).  ``"auto"``
    applies it exactly to attention caches whose Hkv does NOT divide the
    tensor-parallel axis.
    """

    def assign(path, leaf):
        pstr = _keystr(path)
        shape = tuple(leaf.shape)
        # the batch dim: the first after the stacked prefix of 'blocks' leaves
        lead = 1 if "blocks" in pstr else 0
        spec = [None] * len(shape)
        bdim = lead
        if not seq_on_data:
            spec[bdim] = _maybe(shape[bdim], mesh, batch_axis)
        is_attn_kv = re.search(r"/(k|v)$", pstr) is not None
        is_mla = re.search(r"/(c_kv|k_rope)$", pstr) is not None
        s_ax = seq_axis or (batch_axis if seq_on_data else None)
        if s_ax == "auto":
            hkv_fits = is_attn_kv and _fits(shape[lead + 2], mesh, tp_axis)
            s_ax = None if (not is_attn_kv or hkv_fits) else tp_axis
        if is_attn_kv:
            sdim, hdim, ddim = lead + 1, lead + 2, lead + 3
            if s_ax is not None:
                spec[sdim] = _maybe(shape[sdim], mesh, s_ax)
            if s_ax != tp_axis:
                if _fits(shape[hdim], mesh, tp_axis):
                    spec[hdim] = tp_axis
                else:
                    spec[ddim] = _maybe(shape[ddim], mesh, tp_axis)
        elif is_mla:
            sdim = lead + 1
            if s_ax is not None:
                spec[sdim] = _maybe(shape[sdim], mesh, s_ax)
            if s_ax != tp_axis:
                spec[-1] = _maybe(shape[-1], mesh, tp_axis)
        else:
            # ssm states: shard the widest non-batch dim over model
            dims = list(range(lead + 1, len(shape)))
            if dims:
                widest = max(dims, key=lambda i: shape[i])
                spec[widest] = _maybe(shape[widest], mesh, tp_axis)
        return P(*spec)

    return _map_path(assign, cache_shapes)


# ---------------------------------------------------------------- DTensor
@dataclass(frozen=True)
class NamedSharding:
    """A spec over a ``DeviceMesh``: ``placements`` holds, for each mesh
    dim, ``Shard(d)`` where the spec names it for tensor dim ``d`` and
    ``Replicate()`` elsewhere."""
    mesh: Any
    spec: PartitionSpec
    placements: tuple

    def distribute(self, tensor):
        """``tensor`` (the same on every rank) as a DTensor of this sharding."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh, list(self.placements))


def to_shardings(pspec_tree, mesh):
    """Each spec of ``pspec_tree`` as a ``NamedSharding`` over ``mesh`` (a
    ``DeviceMesh``, or a ``launch.mesh.Mesh`` with a process group, whose
    ``device_mesh()`` it takes)."""
    from torch.distributed.tensor import Replicate, Shard
    if not hasattr(mesh, "mesh_dim_names"):
        mesh = mesh.device_mesh()
    names = list(mesh.mesh_dim_names)

    def one(_, spec):
        placements = [Replicate()] * len(names)
        for d, axis in enumerate(spec):
            for name in (axis if isinstance(axis, tuple) else (axis,)):
                if name is not None:
                    placements[names.index(name)] = Shard(d)
        return NamedSharding(mesh, spec, tuple(placements))

    return _map_path(one, pspec_tree)
