"""Per-client state and data access (port of ``repro/core/client_store.py``).

The store owns every per-client access of a round: the raw host shard,
its size, the SCAFFOLD control variates, and the device tier the
vectorized engine reads through — a bounded LRU
(``FedConfig.client_cache_buckets`` entries) of per-client device rows,
each a client's full shard padded to the bucket's length, and of the
``(Cb, n_pad, ...)`` bucket stacks assembled from them.  A round pins its
sampled clients (``sampled_view``) so its own rows are never evicted under
it.  Two stores:

  * ``InMemoryStore``, the oracle: a dense control list over all C clients
    and ``control_mean`` as ``sum(xs) / len(xs)``; O(C) memory.
  * ``SpillingStore``: only touched clients are resident.  Controls live in
    an LRU whose evictions spill through ``fedckpt`` (one npz a client,
    restorable by a fresh process over the same directory); an untouched
    client's control is zero.  Evicted data rows spill once and reload
    bit for bit.  The server control is a running f32 sum (``sum += c_new −
    c_old`` at each ``put_control``), so ``control_mean`` is O(1) in C.

``flush`` and ``control_sum`` / ``set_control_sum`` are the full-state
checkpoint's hooks; ``nbytes`` counts the resident client bytes, flat in
C for the spilling store.
"""
from __future__ import annotations

import os
import tempfile
import weakref
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.fedckpt.checkpointer import (client_state_path, load_pytree, save_pytree,
                                              spilled_client_ids)
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_zeros_like

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


def _tree_nbytes(tree: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


class _LRU:
    """Insertion-ordered dict LRU with per-client pinning.

    Keys are ``(kind, cid_or_cids, n_pad)`` tuples; eviction skips entries
    whose client(s) are pinned by an open ``SampledView``.  When every entry
    is pinned the cache grows past its capacity rather than evict live
    state.  ``on_evict(key, value)`` sees each victim.
    """

    def __init__(self, capacity: int,
                 on_evict: Optional[Callable[[tuple, Any], None]] = None):
        self.capacity = int(capacity)
        self.on_evict = on_evict
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
            value = self._d.pop(victim)
            if self.on_evict is not None:
                self.on_evict(victim, value)

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

    def keys(self):
        return list(self._d)

    def values(self):
        return list(self._d.values())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d


class SampledView:
    """A round-scoped window onto the store: the sampled cids' rows are
    pinned in the device tier for the view's lifetime.  Use as a context
    manager around the round's use of its bucket stacks."""

    def __init__(self, store: "ClientStore", cids):
        self.store = store
        self.cids = [int(c) for c in cids]
        self._open = True
        store._data.pin(self.cids)

    def get_data(self, cid: int, n_pad: int) -> PyTree:
        return self.store.get_data(cid, n_pad)

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


class ClientStore:
    """Per-client state and data access.  Subclasses keep the control tier
    (``init_controls`` / ``get_control`` / ``put_control`` /
    ``control_mean``); the device data tier is shared."""

    def __init__(self, task, capacity: Optional[int] = None):
        self.task = task
        self.capacity = resolve_cache_buckets(capacity)
        me = weakref.proxy(self)    # the LRU's hook: no cycle through the store
        self._data = _LRU(self.capacity, on_evict=lambda k, v: me._on_data_evict(k, v))
        self._zero: Optional[PyTree] = None     # the zero control

    @property
    def has_controls(self) -> bool:
        """Whether the control tier holds SCAFFOLD controls (``init_controls``
        has run)."""
        return self._zero is not None

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
        row = self._restore_row(int(cid), int(n_pad))
        if row is None:
            row = self._build_row(int(cid), int(n_pad))
        return self._data.put(key, row)

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

    # hooks the spilling store overrides ------------------------------------
    def _on_data_evict(self, key: tuple, value: PyTree) -> None:
        pass                                    # in memory: dropped

    def _restore_row(self, cid: int, n_pad: int) -> Optional[PyTree]:
        return None

    # ---------------------------------------------------- control tier
    def init_controls(self, like: PyTree) -> None:
        raise NotImplementedError

    def get_control(self, cid: int) -> PyTree:
        raise NotImplementedError

    def put_control(self, cid: int, c: PyTree) -> None:
        raise NotImplementedError

    def control_mean(self) -> PyTree:
        """The server control c = mean_i c_i over ALL clients (an untouched
        client counts as zero)."""
        raise NotImplementedError

    # ------------------------------------------- crash-safe resume hooks
    def flush(self) -> None:
        """Persist the volatile tiers, so that a fresh store over the same
        backing rebuilds this one (nothing, where there is no backing)."""

    @property
    def control_sum(self) -> Optional[PyTree]:
        """The running f32 Σ_i c_i where the store keeps one: checkpointed
        as it is, because a sum kept up step by step rounds otherwise than
        one rebuilt file by file."""
        return None

    def set_control_sum(self, csum: PyTree) -> None:
        """Adopt a checkpointed running control sum (no-op without one)."""

    # ------------------------------------------------------- accounting
    def nbytes(self) -> int:
        """Resident client-state bytes: the cached rows and buckets and the
        controls held: flat in C for the spilling store, O(C) for the
        dense one."""
        return sum(_tree_nbytes(v) for v in self._data.values()) + self._control_nbytes()

    def _control_nbytes(self) -> int:
        return 0


class InMemoryStore(ClientStore):
    """Dense control list over all C clients; ``control_mean`` is the
    reference's ``sum(xs) / len(xs)`` in client order."""

    def __init__(self, task, capacity: Optional[int] = None):
        super().__init__(task, capacity)
        self._controls: Optional[list[PyTree]] = None

    def init_controls(self, like: PyTree) -> None:
        """SCAFFOLD c_i ≡ 0 at init: one shared zero tree (never written in
        place) until a client's first ``put_control``."""
        self._zero = tree_zeros_like(like)
        self._controls = [self._zero for _ in range(self.num_clients)]

    def get_control(self, cid: int) -> PyTree:
        return self._controls[int(cid)]

    def put_control(self, cid: int, c: PyTree) -> None:
        self._controls[int(cid)] = c

    def control_mean(self) -> PyTree:
        cs = self._controls
        return tree_map(lambda *xs: sum(xs) / len(xs), *cs)

    def _control_nbytes(self) -> int:
        if self._controls is None:
            return 0
        # the shared zero tree counts once
        seen, total = set(), 0
        for c in self._controls:
            if id(c) not in seen:
                seen.add(id(c))
                total += _tree_nbytes(c)
        return total


class SpillingStore(ClientStore):
    """O(sampled) residency: touched clients in LRU hot sets, spills through
    ``fedckpt`` (one ``.npz`` a client), untouched clients zero.  A new
    store over the same directory restores every spilled control; a data
    row restores from its spill or is rebuilt from the task."""

    DATA_KIND = "data"
    CTRL_KIND = "ctrl"

    def __init__(self, task, capacity: Optional[int] = None,
                 directory: Optional[str] = None):
        super().__init__(task, capacity)
        self.directory = directory or tempfile.mkdtemp(prefix="repro-client-store-")
        os.makedirs(self.directory, exist_ok=True)
        me = weakref.proxy(self)
        self._ctrl_hot = _LRU(self.capacity, on_evict=lambda k, v: me._on_ctrl_evict(k, v))
        self._ctrl_sum: Optional[PyTree] = None   # running Σ_i c_i (f32)
        self._row_like: dict[tuple, tuple] = {}   # (cid, n_pad) -> (meta tree, device)

    # ------------------------------------------------------- data spill
    def _data_path(self, cid: int, n_pad: int) -> str:
        return client_state_path(self.directory, self.DATA_KIND, cid, suffix=f"_n{n_pad}")

    def _on_data_evict(self, key: tuple, value: PyTree) -> None:
        if key[0] != "row":
            return                               # bucket stacks: rebuilt from rows
        cid, n_pad = key[1], key[2]
        path = self._data_path(cid, n_pad)
        self._row_like[(cid, n_pad)] = (tree_map(lambda x: x.to("meta"), value),
                                        tree_leaves(value)[0].device)
        if not os.path.exists(path):             # spilled once: rows never change
            save_pytree(path, value)

    def _restore_row(self, cid: int, n_pad: int) -> Optional[PyTree]:
        like = self._row_like.get((cid, n_pad))
        path = self._data_path(cid, n_pad)
        if like is None or not os.path.exists(path):
            return None                          # rebuilt from the task
        return load_pytree(path, like[0], device=like[1])

    # ---------------------------------------------------- control spill
    def _ctrl_path(self, cid: int) -> str:
        return client_state_path(self.directory, self.CTRL_KIND, cid)

    def _on_ctrl_evict(self, key: tuple, value: PyTree) -> None:
        save_pytree(self._ctrl_path(key[1]), value)

    def init_controls(self, like: PyTree) -> None:
        """The zero control and a zero f32 running sum, into which every
        control a previous process spilled over this directory re-enters."""
        self._zero = tree_zeros_like(like)
        self._ctrl_sum = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), like)
        for cid in spilled_client_ids(self.directory, self.CTRL_KIND):
            c = load_pytree(self._ctrl_path(cid), self._zero)
            self._ctrl_sum = tree_map(lambda s, x: s + x.float(), self._ctrl_sum, c)

    def get_control(self, cid: int) -> PyTree:
        cid = int(cid)
        hit = self._ctrl_hot.get(("ctrl", cid))
        if hit is not None:
            return hit
        path = self._ctrl_path(cid)
        if os.path.exists(path):
            return self._ctrl_hot.put(("ctrl", cid), load_pytree(path, self._zero))
        return self._zero                        # never touched

    def put_control(self, cid: int, c: PyTree) -> None:
        cid = int(cid)
        old = self.get_control(cid)
        self._ctrl_sum = tree_map(lambda s, new, prev: s + new.float() - prev.float(),
                                  self._ctrl_sum, c, old)
        self._ctrl_hot.put(("ctrl", cid), c)

    def control_mean(self) -> PyTree:
        n = self.num_clients
        return tree_map(lambda s, z: (s / n).to(z.dtype), self._ctrl_sum, self._zero)

    # ------------------------------------------- crash-safe resume hooks
    def flush(self) -> None:
        """Spill every hot control without evicting it: a fresh store over
        the same directory then sees the control set this one holds."""
        for key in self._ctrl_hot.keys():
            save_pytree(self._ctrl_path(key[1]), self._ctrl_hot.get(key))

    @property
    def control_sum(self) -> Optional[PyTree]:
        return self._ctrl_sum

    def set_control_sum(self, csum: PyTree) -> None:
        self._ctrl_sum = csum

    def _control_nbytes(self) -> int:
        total = sum(_tree_nbytes(v) for v in self._ctrl_hot.values())
        if self._ctrl_sum is not None:
            total += _tree_nbytes(self._ctrl_sum)
        return total


def make_client_store(cfg, task) -> ClientStore:
    """The configured store (``FedConfig.client_store``)."""
    if cfg.client_store == "spilling":
        return SpillingStore(task, capacity=cfg.client_cache_buckets,
                             directory=cfg.client_store_dir)
    return InMemoryStore(task, cfg.client_cache_buckets)
