"""Non-IID client partitioning via the Dirichlet distribution (port of
``repro/data/partition.py``; numpy only, byte-identical to the reference).

Follows Hsu, Qi & Brown (arXiv:1909.06335): for every class,
class-membership proportions over clients are drawn from Dir(α); α=1.0 is
mild heterogeneity, α=0.1 the paper's "high degree of data heterogeneity".
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        seed: int, min_size: int = 2) -> list[np.ndarray]:
    """Return per-client index arrays covering ``labels`` exactly once."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    while True:
        idx_per_client: list[list[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[cid].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
    out = []
    for ix in idx_per_client:
        arr = np.asarray(ix, dtype=np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def heterogeneity(partitions: list[np.ndarray], labels: np.ndarray) -> float:
    """Mean total-variation distance between the client label histograms
    and the global one: 0 for IID, towards 1 for fully skewed shards
    (empty shards skipped)."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    glob = np.array([(labels == c).mean() for c in classes])
    tvs = []
    for ix in partitions:
        if len(ix) == 0:
            continue
        loc = np.array([(labels[ix] == c).mean() for c in classes])
        tvs.append(0.5 * np.abs(loc - glob).sum())
    return float(np.mean(tvs))
