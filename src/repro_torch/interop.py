"""Weights across the two packages, through numpy.

``params_from_numpy`` turns the JAX package's parameter tree, taken as
numpy arrays (``jax.tree.map(np.asarray, params)``), into the port's tree:
the same nested dicts and lists, the same keys, stacked ``blocks`` as they
are (a MoE layer's expert banks keep their (n_super, E, ...) axes, its
router and shared experts and an MLA layer's projections their
(n_super, ...) one; deepseek-v2-lite-16b's dense layer 0 is the ``prefix``
list; a recurrent block's weights sit under ``ssm``: Mamba's ``in_proj``,
``conv_w``, ``A_log``, ...; mLSTM's ``wq``/``wk``/``wv``, gates and
``w_z``; sLSTM's ``w_in``, its recurrent ``r`` (n_super, nh, dh, 4·dh) and
``b``; the audio and VLM families' ``frontend``: ``proj1``, ``proj2`` and
HuBERT's ``mask_embed``).  ``params_to_numpy`` goes the other way.  This module accepts numpy
only and imports nothing of JAX.

bfloat16: numpy holds it as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects, so its bits travel as uint16 / int16 views.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib


def _to_tensor(arr, dev):
    if not isinstance(arr, (np.ndarray, np.generic)):
        raise TypeError(f"params_from_numpy takes numpy leaves, got {type(arr).__name__}")
    arr = np.array(arr)        # a writable, contiguous copy torch can own
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(dev, copy=True)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    if tree is None:
        return None
    return fn(tree)


def params_from_numpy(tree, device=None):
    """numpy parameter tree → torch tensors on ``device`` (default cuda)."""
    dev = device_lib.resolve(device)
    return _map(tree, lambda a: _to_tensor(a, dev))


def params_to_numpy(tree):
    """torch parameter tree → numpy arrays (bf16 as ``ml_dtypes.bfloat16``)."""
    return _map(tree, _to_numpy)
