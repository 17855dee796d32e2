"""Client sampling and group assignment (paper §3.1.1, Remark 1; port of
``repro/core/grouping.py``, numpy only and byte-identical).

Every round: participating clients are sampled, then "randomly but evenly
distributed into K groups"; membership is reshuffled each round so every
global model sees every client's data distribution over time.
"""
from __future__ import annotations

import numpy as np


def sample_clients(num_clients: int, participation: float, rng: np.random.Generator,
                   at_least: int = 1) -> np.ndarray:
    n = max(at_least, int(round(num_clients * participation)))
    return rng.choice(num_clients, size=min(n, num_clients), replace=False)


def group_major_order(groups) -> tuple[np.ndarray, np.ndarray]:
    """Flatten K groups into the round's canonical client order: group 0's
    clients first, then group 1's, ...  Returns ``(client_ids (C,),
    group_ids (C,))``."""
    cids = np.concatenate([np.asarray(g) for g in groups])
    gids = np.concatenate([np.full(len(g), k, dtype=np.int32)
                           for k, g in enumerate(groups)])
    return cids, gids


def assign_groups(active_clients: np.ndarray, K: int,
                  rng: np.random.Generator,
                  extra_to_main: bool = True) -> list[np.ndarray]:
    """Shuffle then deal round-robin into K groups (sizes differ by ≤1);
    leftovers go to the lowest group indices, so the main model (group 0)
    gets the extra client, as in the paper's K=3 appendix experiment."""
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    a = np.array(active_clients, copy=True)
    rng.shuffle(a)
    groups = [a[k::K] for k in range(K)]
    if not extra_to_main:
        groups = groups[::-1]
    # never return an empty group: K > #clients is a config error
    if any(len(g) == 0 for g in groups):
        raise ValueError(f"{len(a)} active clients cannot fill K={K} groups")
    return groups
