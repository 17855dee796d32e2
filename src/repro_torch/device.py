"""Where the port runs: ``cuda`` by default, the CPU only on request.

Every entry point takes a ``device`` argument and resolves it here.  With no
argument the port runs on the GPU; with no GPU it raises instead of carrying
on quietly on the CPU.  The tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on (``None`` means ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev
