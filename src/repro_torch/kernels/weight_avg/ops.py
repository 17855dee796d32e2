"""Weighted model averaging: the Hopper kernel and its plain version (port
of ``repro/kernels/weight_avg/ops.py``).

  * ``group_weighted_average`` — (G, N, D), (G, N) -> (G, D): Eq. 2 for
    all G groups in one launch (kernel 5);
  * ``weighted_average`` — (N, D), (N,) -> (D,): the G = 1 case (kernel 6);
  * the ``*_pytree`` forms apply either to every leaf of a stacked tree in
    ONE launch over a table of leaves (``wa_tree_plan``; one launch per
    dtype and per ``WA_MAX_LEAVES`` leaves), where the reference's
    ``jax.tree.map`` makes a ``pallas_call`` per leaf.  Their results are
    views of one allocation, each leaf's slice on a 16-byte boundary, on
    the CPU too.  A single tensor is the table's one-leaf case: every
    form launches the same kernel, ``multi_weighted_average_tree``.

For CUDA tensors each op launches its kernel in ``csrc/weight_avg.cu`` or
raises; the plain versions in ``ref.py`` run only for CPU tensors.  No
padding: the Pallas wrapper pads D to its block for the TPU's grid, the
CUDA kernel masks any D itself.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.weight_avg import ref
from repro_torch.utils.pytree import tree_leaves, tree_unflatten

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WA_THREADS = 256              # threads a CTA; each takes 16 bytes of columns a tile
WA_MAX_LEAVES = 1024          # leaves a launch (csrc/weight_avg.cu, kMaxLeaves)
WA_ALIGN = 16                 # each leaf's output slice starts on this boundary


def _lib():
    lib = build.load("weight_avg")
    if lib.multi_weighted_average_tree.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.multi_weighted_average_tree.argtypes = [vp, vp, vp, vp, i, vp, vp, i, i, i, vp]
        lib.multi_weighted_average_tree.restype = ctypes.c_int
    return lib


def _on_cpu(name: str, stacked: torch.Tensor, weights: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version); raises for anything the
    kernel does not take."""
    devices = {stacked.device, weights.device}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if stacked.dtype not in _DTYPES:
        raise ValueError(f"{name}: stacked is {stacked.dtype}; the kernel takes "
                         f"{tuple(_DTYPES)}")
    if not stacked.is_contiguous():
        raise ValueError(f"{name}: stacked must be contiguous")
    return False


def weighted_average(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked (N, D), weights (N,) -> (D,) in stacked's dtype."""
    if _on_cpu("weighted_average", stacked, weights):
        return ref.weighted_average_ref(stacked, weights)
    if stacked.ndim != 2 or weights.shape != stacked.shape[:1] or stacked.shape[1] < 1:
        raise ValueError(f"weighted_average: stacked {tuple(stacked.shape)}, weights "
                         f"{tuple(weights.shape)}; need (N, D) and (N,)")
    return _tree_average("weighted_average", [stacked], weights, grouped=False)[0]


def group_weighted_average(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked (G, N, D), weights (G, N) -> (G, D): every group's normalised
    weighted mean in one launch."""
    if _on_cpu("group_weighted_average", stacked, weights):
        return ref.group_weighted_average_ref(stacked, weights)
    if stacked.ndim != 3 or weights.shape != stacked.shape[:2] or stacked.shape[2] < 1:
        raise ValueError(f"group_weighted_average: stacked {tuple(stacked.shape)}, weights "
                         f"{tuple(weights.shape)}; need (G, N, D) and (G, N)")
    return _tree_average("group_weighted_average", [stacked], weights, grouped=True)[0]


# ------------------------------------------------------------ the tree form
def wa_tree_plan(leaves, G: int, N: int) -> dict:
    """Kernel 5's launches for a tree: ``leaves`` is ``[(dtype, D), ...]`` in
    the tree's order, each leaf a (G, N, D) stack averaged to (G, D).

    * ``offsets``: each leaf's output slice in bytes from the start of one
      allocation of ``nbytes``, in the tree's order, each on a 16-byte
      boundary;
    * ``launches``: the f32 leaves, then the bf16 ones, in the tree's order,
      at most ``WA_MAX_LEAVES`` a launch; each has the leaves' indices, D,
      their output offsets in 16-byte units (``out16``), the first tile of
      each (``tile0``, its last entry the grid) and the dtype.  A tile is 16
      bytes of columns for each of ``WA_THREADS`` threads.  Leaves with no
      element get a slice and no tile.
    Raises for a dtype the kernel does not take."""
    if G < 1 or N < 1:
        raise ValueError(f"wa_tree_plan: G {G}, N {N}")
    offsets, nbytes = [], 0
    for dtype, D in leaves:
        if dtype not in _DTYPES:
            raise ValueError(f"weight_avg: a leaf is {dtype}; the kernel takes {tuple(_DTYPES)}")
        nbytes = -(-nbytes // WA_ALIGN) * WA_ALIGN
        offsets.append(nbytes)
        nbytes += G * D * dtype.itemsize
    launches = []
    for dtype in _DTYPES:
        idx = [i for i, (dt, D) in enumerate(leaves) if dt == dtype and D > 0]
        cols = WA_THREADS * (16 // dtype.itemsize)
        for k in range(0, len(idx), WA_MAX_LEAVES):
            part = idx[k:k + WA_MAX_LEAVES]
            D = np.array([leaves[i][1] for i in part], np.int64)
            tile0 = np.concatenate([[0], np.cumsum(-(-D // cols))])
            out16 = np.array([offsets[i] // WA_ALIGN for i in part], np.int64)
            if tile0[-1] > 0x7fffffff or D.max() > 0xffffffff or out16.max() > 0xffffffff:
                raise ValueError(f"weight_avg: a launch of {tile0[-1]} tiles, D up to "
                                 f"{D.max()}, {nbytes} bytes of output is too large")
            launches.append({"dtype": dtype, "leaves": part, "D": D.astype(np.uint32),
                             "out16": out16.astype(np.uint32),
                             "tile0": tile0.astype(np.int32), "grid": int(tile0[-1])})
    return {"offsets": offsets, "nbytes": -(-nbytes // WA_ALIGN) * WA_ALIGN,
            "launches": launches}


def _contiguous_strides(shape) -> tuple:
    strides, s = [], 1
    for d in reversed(shape):
        strides.append(s)
        s *= d
    return tuple(reversed(strides))


@functools.lru_cache(maxsize=64)
def _tree_layout(key: tuple, lead: tuple, out_lead: tuple):
    """The plan for leaves ``key = ((dtype, shape), ...)`` whose leading
    ``lead`` dims are (G, N) (or (N,)), each output's (dtype, shape,
    strides, element offset) in the one allocation, and the outputs' dtypes."""
    G, N = lead if len(lead) == 2 else (1, lead[0])
    for dtype, shape in key:
        if tuple(shape[:len(lead)]) != lead:
            raise ValueError(f"weight_avg: a leaf of shape {tuple(shape)} does not start "
                             f"with the weights' {lead}")
    plan = wa_tree_plan([(dt, math.prod(shp[len(lead):])) for dt, shp in key], G, N)
    views = []
    for (dtype, shape), off in zip(key, plan["offsets"]):
        oshape = out_lead + tuple(shape[len(lead):])
        views.append((dtype, oshape, _contiguous_strides(oshape), off // dtype.itemsize))
    return plan, views, frozenset(v[0] for v in views)


def _tree_average(name: str, leaves: list, weights: torch.Tensor, grouped: bool) -> list:
    """Every leaf's normalised weighted mean over its leading (G, N) dims
    (kernel 5), or (N,) when not ``grouped`` (kernel 6's G = 1 case), as
    views of one allocation."""
    if not leaves:
        return []
    dev = weights.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    if {x.get_device() for x in leaves} != {-1 if dev.type == "cpu" else dev.index}:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{ {x.device for x in leaves} | {dev} }")
    lead = tuple(weights.shape)
    if len(lead) != (2 if grouped else 1):
        raise ValueError(f"{name}: weights {lead}")
    plan, views, dtypes = _tree_layout(tuple([(x.dtype, x.shape) for x in leaves]), lead,
                                       lead[:1] if grouped else ())
    buf = torch.empty((plan["nbytes"],), dtype=torch.uint8, device=dev)
    typed = {dt: buf.view(dt) for dt in dtypes}
    outs = [typed[dt].as_strided(shape, strides, off) for dt, shape, strides, off in views]
    w = weights.to(torch.float32).reshape(-1, lead[-1]).contiguous()
    if dev.type == "cpu":
        plain = ref.group_weighted_average_ref
        for x, o in zip(leaves, outs):
            o.copy_(plain(x.reshape(w.shape[0], w.shape[1], -1), w).reshape(o.shape))
        return outs
    if not all(x.is_contiguous() for x in leaves):
        raise ValueError(f"{name}: every leaf must be contiguous")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    G, N = w.shape
    for p in plan["launches"]:
        x = np.fromiter([leaves[i].data_ptr() for i in p["leaves"]], np.int64, len(p["leaves"]))
        code = lib.multi_weighted_average_tree(
            x.ctypes.data, p["out16"].ctypes.data, p["D"].ctypes.data, p["tile0"].ctypes.data,
            len(p["leaves"]), buf.data_ptr(), w.data_ptr(), G, N, _DTYPES[p["dtype"]], stream)
        build.check(lib, code, "multi_weighted_average_tree")
        kernels.count("multi_weighted_average" if grouped else "weighted_average", dev)
    return outs


def weighted_average_pytree(stacked_tree, weights: torch.Tensor):
    """Leaves (N, ...) -> averaged leaves (...), one launch for the tree."""
    return tree_unflatten(stacked_tree, _tree_average(
        "weighted_average_pytree", tree_leaves(stacked_tree), weights, grouped=False))


def group_weighted_average_pytree(stacked_tree, weights: torch.Tensor):
    """Leaves (G, N, ...) -> averaged leaves (G, ...), one launch for the tree."""
    return tree_unflatten(stacked_tree, _tree_average(
        "group_weighted_average_pytree", tree_leaves(stacked_tree), weights, grouped=True))
