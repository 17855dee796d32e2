"""Per-client state and data access (port of ``repro/core/client_store.py``,
``InMemoryStore`` only).

The store owns every per-client access of a round: the raw host shard,
its size, the SCAFFOLD control variates as a dense list over all C
clients, and the device tier the vectorized engine reads through — a
bounded LRU (``FedConfig.client_cache_buckets`` entries) of per-client
device rows, each a client's full shard padded to the bucket's length,
and of the ``(Cb, n_pad, ...)`` bucket stacks assembled from them.  A
round pins its sampled clients (``sampled_view``) so its own rows are
never evicted under it.  The spilling store arrives with the robustness
slice.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map, tree_zeros_like

PyTree = Any

DEFAULT_CACHE_BUCKETS = 64


def resolve_cache_buckets(configured: Optional[int] = None) -> int:
    """The store's LRU capacity: ``FedConfig(client_cache_buckets=...)``,
    defaulted."""
    return DEFAULT_CACHE_BUCKETS if configured is None else int(configured)


def _num_examples(ds) -> int:
    """Rows of a shard: an (x, y) tuple, a dict of equal-length arrays (the
    LM task's tokens and labels) or one array."""
    if isinstance(ds, tuple):
        return len(ds[0])
    if isinstance(ds, dict):
        return len(next(iter(ds.values())))
    return len(ds)


class _LRU:
    """Insertion-ordered dict LRU with per-client pinning.

    Keys are ``(kind, cid_or_cids, n_pad)`` tuples; eviction skips entries
    whose client(s) are pinned by an open ``SampledView``.  When every entry
    is pinned the cache grows past its capacity rather than evict live
    state.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: dict = {}
        self._pins: dict[int, int] = {}     # cid -> pin count

    def get(self, key):
        if key in self._d:
            self._d[key] = self._d.pop(key)      # move to newest
            return self._d[key]
        return None

    def put(self, key, value):
        self._d.pop(key, None)
        self._d[key] = value
        self._shrink()
        return value

    def _pinned(self, key) -> bool:
        cids = key[1] if isinstance(key[1], tuple) else (key[1],)
        return any(c in self._pins for c in cids)

    def _shrink(self) -> None:
        while len(self._d) > self.capacity:
            victim = next((k for k in self._d if not self._pinned(k)), None)
            if victim is None:
                return                            # everything pinned: grow
            del self._d[victim]

    def pin(self, cids) -> None:
        for c in cids:
            self._pins[int(c)] = self._pins.get(int(c), 0) + 1

    def unpin(self, cids) -> None:
        for c in cids:
            c = int(c)
            n = self._pins.get(c, 0) - 1
            if n <= 0:
                self._pins.pop(c, None)
            else:
                self._pins[c] = n
        self._shrink()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d


class SampledView:
    """A round-scoped window onto the store: the sampled cids' rows are
    pinned in the device tier for the view's lifetime.  Use as a context
    manager around the round's use of its bucket stacks."""

    def __init__(self, store: "InMemoryStore", cids):
        self.store = store
        self.cids = [int(c) for c in cids]
        self._open = True
        store._data.pin(self.cids)

    def controls(self, cids=None) -> list[PyTree]:
        return [self.store.get_control(int(c))
                for c in (self.cids if cids is None else cids)]

    def close(self) -> None:
        if self._open:
            self._open = False
            self.store._data.unpin(self.cids)

    def __enter__(self) -> "SampledView":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class InMemoryStore:
    """Dense control list over all C clients; ``control_mean`` is the
    reference's ``sum(xs) / len(xs)`` in client order."""

    def __init__(self, task, capacity: Optional[int] = None):
        self.task = task
        self.capacity = resolve_cache_buckets(capacity)
        self._data = _LRU(self.capacity)
        self._controls: Optional[list[PyTree]] = None

    # ------------------------------------------------------- data tier
    @property
    def num_clients(self) -> int:
        return len(self.task.client_data)

    def client_shard(self, cid: int):
        """The raw host-side shard."""
        return self.task.client_data[int(cid)]

    def num_examples(self, cid: int) -> int:
        """|X_i|, without building the shard when the task's ``client_data``
        knows its sizes (``num_examples``)."""
        data = self.task.client_data
        if hasattr(data, "num_examples"):
            return int(data.num_examples(int(cid)))
        return _num_examples(data[int(cid)])

    def _build_row(self, cid: int, n_pad: int) -> PyTree:
        """The client's whole shard through the task's ``make_batch`` (onto
        the task's device), zero-padded on the device to ``n_pad`` rows."""
        ds = self.client_shard(cid)
        n = _num_examples(ds)
        full = self.task.make_batch(ds, np.arange(n))
        if n == n_pad:
            return full
        return tree_map(lambda x: torch.cat([x, x.new_zeros((n_pad - n,) + tuple(x.shape[1:]))]),
                        full)

    def get_data(self, cid: int, n_pad: int) -> PyTree:
        """One client's full shard as a device-resident (n_pad, ...) row,
        cached per (cid, n_pad): a client's padded row outlives the bucket
        compositions it takes part in, so it is uploaded once."""
        key = ("row", int(cid), int(n_pad))
        hit = self._data.get(key)
        if hit is not None:
            return hit
        return self._data.put(key, self._build_row(int(cid), int(n_pad)))

    def get_bucket(self, cids: Sequence[int], n_pad: int) -> PyTree:
        """Device-resident (Cb, n_pad, ...) stack of full client shards.  A
        bucket miss stacks the cached per-client rows: a device-side copy,
        not a host upload."""
        key = ("bucket", tuple(int(c) for c in cids), int(n_pad))
        hit = self._data.get(key)
        if hit is not None:
            return hit
        rows = [self.get_data(int(c), int(n_pad)) for c in cids]
        return self._data.put(key, tree_map(lambda *xs: torch.stack(xs), *rows))

    def sampled_view(self, cids) -> SampledView:
        """Pin this round's sampled clients resident and hand back a
        round-scoped accessor."""
        return SampledView(self, cids)

    # ---------------------------------------------------- control tier
    def init_controls(self, like: PyTree) -> None:
        """SCAFFOLD c_i ≡ 0 at init: one shared zero tree (never written in
        place) until a client's first ``put_control``."""
        zero = tree_zeros_like(like)
        self._controls = [zero for _ in range(self.num_clients)]

    def get_control(self, cid: int) -> PyTree:
        return self._controls[int(cid)]

    def put_control(self, cid: int, c: PyTree) -> None:
        self._controls[int(cid)] = c

    def control_mean(self) -> PyTree:
        """The server control c = mean_i c_i over ALL clients."""
        cs = self._controls
        return tree_map(lambda *xs: sum(xs) / len(xs), *cs)


def make_client_store(cfg, task) -> InMemoryStore:
    """The configured store (``FedConfig.client_store``; validation has
    already refused the unported ``"spilling"``)."""
    return InMemoryStore(task, cfg.client_cache_buckets)
