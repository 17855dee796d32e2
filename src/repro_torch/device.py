"""Where the port runs: ``cuda`` by default, the CPU only on request.

Every entry point takes a ``device`` argument and resolves it here.  With no
argument the port runs on the GPU; with no GPU it raises instead of carrying
on quietly on the CPU.  The tests pass ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on (``None`` means ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


def to_device(x: np.ndarray | torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host array or tensor on ``dev`` (a tensor already there as it is).
    To a card a host value goes through pinned memory as a copy queued on
    the current stream: a blocking copy from pageable memory would make the
    host wait for the stream to drain first (a sync that
    ``analysis.sync_contract`` rejects)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(dev).type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
