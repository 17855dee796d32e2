"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
takes its plain version only for CPU tensors.  Where it launches its
kernel, and nowhere else, it calls ``count``, so a run can show that its
main path went through the kernels.  An eager launch adds one to
``launches`` on the host.  A launch that a step program's CUDA graph
records (``core/step_graph.py``) runs again at every replay, with no
wrapper running; so while a capture records it, ``count`` records beside
it an increment of the wrapper's slot in the card's own counter, which
every replay runs with the kernel.  ``counted()`` reads both: the eager
launches and those the card ran from graphs; a ``Snapshot`` takes them
without a host wait, for a scope that must not sync.
"""
from collections import Counter

import torch

NAMES = ("paged_decode", "flash_forward", "flash_decode", "ensemble_softmax", "kd_loss_fwd",
         "kd_loss_bwd", "weighted_average", "multi_weighted_average", "flash_kd_fwd",
         "flash_kd_bwd", "flash_kd_head_fwd", "flash_kd_head_bwd")
_SLOT = {name: i for i, name in enumerate(NAMES)}

launches: Counter = Counter()
_on_card: dict = {}          # device -> (len(NAMES),) int64 launches run from graphs


def count(name: str, device) -> None:
    """One launch of wrapper ``name``'s kernel on ``device``, issued just now
    on its current stream: on the host if eager, on the card if a capture
    records it."""
    dev = torch.device(device)
    slot = _SLOT[name]
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            capturing = torch.cuda.is_current_stream_capturing()
        if capturing:
            slots = _on_card.get(dev)
            if slots is None:
                raise RuntimeError(f"{name}: a capture records the first launch on {dev}; "
                                   f"a step program's warm-up launches it eagerly first")
            slots[slot].add_(1)
            return
        if dev not in _on_card:
            # a normal tensor even when the first launch is a server's under
            # inference_mode: captures outside it add to the counter in place
            with torch.inference_mode(False):
                _on_card[dev] = torch.zeros(len(NAMES), dtype=torch.int64, device=dev)
    launches[name] += 1


def replayed() -> Counter:
    """Launches by wrapper that the cards ran from captured graphs (waits
    for each card)."""
    out: Counter = Counter()
    for slots in _on_card.values():
        out.update(dict(zip(NAMES, slots.tolist())))
    return +out


def counted() -> Counter:
    """Every launch so far by wrapper: the eager ones and the replayed ones."""
    return launches + replayed()


class Snapshot:
    """``counted()`` as of its making, taken without a host wait: the eager
    launches then, and a copy of each card's counter made on a side stream
    once ``streams`` (each card's current stream if none) have run what was
    issued to them before.  ``read()`` waits for the copies."""

    def __init__(self, *streams):
        self.host = Counter(launches)
        self.card = {}
        for dev, slots in _on_card.items():
            waits = [s for s in streams if s.device == dev] or [torch.cuda.current_stream(dev)]
            side = torch.cuda.Stream(dev)
            for s in waits:
                side.wait_stream(s)
            with torch.cuda.stream(side):
                self.card[dev] = slots.clone()
            self.card[dev].record_stream(torch.cuda.current_stream(dev))

    def read(self) -> Counter:
        out = Counter(self.host)
        for slots in self.card.values():
            out.update(dict(zip(NAMES, slots.tolist())))
        return +out


def reset() -> None:
    """Every count to 0."""
    launches.clear()
    for slots in _on_card.values():
        slots.zero_()
