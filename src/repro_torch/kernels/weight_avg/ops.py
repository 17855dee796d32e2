"""Weighted model averaging: the Hopper kernel and its plain version (port
of ``repro/kernels/weight_avg/ops.py``).

  * ``group_weighted_average`` — (G, N, D), (G, N) -> (G, D): Eq. 2 for
    all G groups in one launch of ``multi_weighted_average``;
  * ``weighted_average`` — (N, D), (N,) -> (D,): the G = 1 case;
  * the ``*_pytree`` forms apply either to every leaf of a stacked tree,
    one launch per leaf, as the reference's ``jax.tree.map`` does.

For CUDA tensors each op launches its kernel in ``csrc/weight_avg.cu`` or
raises; the plain versions in ``ref.py`` run only for CPU tensors.  No
padding: the Pallas wrapper pads D to its block for the TPU's grid, the
CUDA kernel masks any D itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.weight_avg import ref
from repro_torch.utils.pytree import tree_map

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("weight_avg")
    if lib.multi_weighted_average.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.multi_weighted_average.argtypes = [vp, vp, vp, i, i, ll, i, vp]
        lib.weighted_average.argtypes = [vp, vp, vp, i, ll, i, vp]
        for fn in (lib.multi_weighted_average, lib.weighted_average):
            fn.restype = ctypes.c_int
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
    N, D = stacked.shape
    w = weights.to(torch.float32).contiguous()
    out = torch.empty((D,), dtype=stacked.dtype, device=stacked.device)
    lib = _lib()
    code = lib.weighted_average(stacked.data_ptr(), w.data_ptr(), out.data_ptr(), N, D,
                                _DTYPES[stacked.dtype],
                                torch.cuda.current_stream(stacked.device).cuda_stream)
    build.check(lib, code, "weighted_average")
    kernels.launches["weighted_average"] += 1
    return out


def group_weighted_average(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked (G, N, D), weights (G, N) -> (G, D): every group's normalised
    weighted mean in one launch."""
    if _on_cpu("group_weighted_average", stacked, weights):
        return ref.group_weighted_average_ref(stacked, weights)
    if stacked.ndim != 3 or weights.shape != stacked.shape[:2] or stacked.shape[2] < 1:
        raise ValueError(f"group_weighted_average: stacked {tuple(stacked.shape)}, weights "
                         f"{tuple(weights.shape)}; need (G, N, D) and (G, N)")
    G, N, D = stacked.shape
    w = weights.to(torch.float32).contiguous()
    out = torch.empty((G, D), dtype=stacked.dtype, device=stacked.device)
    lib = _lib()
    code = lib.multi_weighted_average(stacked.data_ptr(), w.data_ptr(), out.data_ptr(),
                                      G, N, D, _DTYPES[stacked.dtype],
                                      torch.cuda.current_stream(stacked.device).cuda_stream)
    build.check(lib, code, "multi_weighted_average")
    kernels.launches["multi_weighted_average"] += 1
    return out


def weighted_average_pytree(stacked_tree, weights: torch.Tensor):
    """Leaves (N, ...) -> averaged leaves (...)."""
    def leaf(x):
        return weighted_average(x.reshape(x.shape[0], -1), weights).reshape(x.shape[1:])

    return tree_map(leaf, stacked_tree)


def group_weighted_average_pytree(stacked_tree, weights: torch.Tensor):
    """Leaves (G, N, ...) -> averaged leaves (G, ...)."""
    def leaf(x):
        G, N = x.shape[:2]
        return group_weighted_average(x.reshape(G, N, -1), weights).reshape((G,) + x.shape[2:])

    return tree_map(leaf, stacked_tree)
