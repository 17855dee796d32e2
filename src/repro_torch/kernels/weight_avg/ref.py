"""Plain PyTorch versions of the streaming weighted-average kernels (paper
Eq. 2), mirroring ``repro/kernels/weight_avg/ref.py``.  The CPU path runs
these, and the on-card check holds ``csrc/weight_avg.cu`` against them."""
from __future__ import annotations

import torch


def weighted_average_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked (N, D), weights (N,) -> sum_i ŵ_i x_i with ŵ normalised in f32,
    summed in f32 and cast to the input dtype."""
    w = weights.to(torch.float32)
    w = w / w.sum()
    return (stacked.to(torch.float32) * w[:, None]).sum(0).to(stacked.dtype)


def group_weighted_average_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Batched multi-model Eq. 2: stacked (G, N, D), weights (G, N) -> (G, D),
    the weights normalised per group."""
    w = weights.to(torch.float32)
    w = w / w.sum(1, keepdim=True)
    return (stacked.to(torch.float32) * w[:, :, None]).sum(1).to(stacked.dtype)
