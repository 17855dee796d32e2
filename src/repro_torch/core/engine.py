"""The host half of the client engine (port of ``repro/core/engine.py``:
``ClientEntry``, ``build_round_entries``, ``unstack_models``).

``build_round_entries`` draws every sampled client's minibatch schedule
from the round's numpy rng in the sequential oracle's order (group-major,
then epoch), so the port and the reference train on identical batches.
The stacked vectorized engine arrives with its own slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from repro_torch.core.grouping import group_major_order
from repro_torch.utils.pytree import tree_unstack

PyTree = Any


@dataclass
class ClientEntry:
    """One sampled client's fully-drawn local schedule (host side)."""
    pos: int                # position in the group-major round order
    cid: int
    group: int
    n: int                  # dataset size |X_i|
    bs: int                 # local batch size min(client_batch, n)
    idx: np.ndarray         # (S_c, bs) int32 minibatch index rows


def build_round_entries(task, cfg, groups: Sequence[np.ndarray],
                        rng: np.random.Generator, store) -> list[ClientEntry]:
    """Draw every sampled client's epoch schedule, in the exact order the
    sequential runner draws it (for k in groups: for cid in group: for
    epoch: ...)."""
    entries: list[ClientEntry] = []
    cids, gids = group_major_order(groups)
    for pos, (cid, k) in enumerate(zip(cids, gids)):
        n = store.num_examples(int(cid))
        bs = min(cfg.client_batch, n)
        steps = []
        for _ in range(cfg.local_epochs):
            perm = rng.permutation(n)
            for i in range(0, n - bs + 1, bs):
                steps.append(perm[i:i + bs])
        entries.append(ClientEntry(
            pos=pos, cid=int(cid), group=int(k), n=n, bs=bs,
            idx=np.asarray(steps, np.int32)))  # lint-ok: RA101 host rng schedule
    return entries


def unstack_models(stacked: PyTree) -> list[PyTree]:
    return tree_unstack(stacked)
