"""Tree checkpointing through numpy's ``.npz`` (port of
``repro/fedckpt/checkpointer.py``).

Each tree goes into one ``.npz`` whose names are its leaves' paths, and
the layout is the reference's byte for byte, so either package loads the
other's files:

  * a path is its keys joined by ``§``: a dict key as it is, a list or
    tuple index as its number, a NamedTuple field as ``.name`` (JAX's
    ``str(GetAttrKey)``);
  * each leaf goes to disk through ``.detach().cpu().numpy()`` of the
    tensor itself, so a view of a larger allocation (the vectorized
    engine's aggregated leaves share one) writes its own elements only;
  * bf16 leaves go to disk as f32 containers (numpy's npz has no bf16) and
    load back through ``like``'s dtype; ``None`` is no leaf.

The order of the names in the archive does not matter: the port walks
dicts in insertion order, JAX in sorted order, and a load looks each name
up.

Durability, as in the reference:

  * every npz and json write is atomic: the bytes go to ``path + ".tmp"``
    and are published with ``os.replace``, so a crash mid-write leaves the
    previous file and at worst a stale ``.tmp`` (which readers clean up);
  * writes and reads go through a bounded retry with backoff
    (``_IO_ATTEMPTS`` tries); ``set_io_fault_injector`` installs a hook
    that may fail an attempt, which is how ``FaultPlan.io_injector`` drives
    the loop;
  * ``Checkpointer.save`` records the npz's crc32 in its ``.json`` meta,
    and ``restore_latest`` falls back past steps that fail it.
"""
from __future__ import annotations

import json
import os
import re
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

PyTree = Any
_SEP = "§"   # unlikely in key names

# ---------------------------------------------------------------------
# bounded retry with backoff around every fedckpt I/O operation
# ---------------------------------------------------------------------
_IO_ATTEMPTS = 4
_IO_BACKOFF_S = 0.01        # 10 ms, 20 ms, 40 ms between attempts

_io_fault_injector: Optional[Callable[[str, int], None]] = None


def set_io_fault_injector(fn: Optional[Callable[[str, int], None]]) -> None:
    """Install (or clear, with None) an I/O failure hook, called as
    ``fn(path, attempt)`` before each attempt and free to raise ``OSError``.
    It is global to the process: whoever installs it clears it."""
    global _io_fault_injector
    _io_fault_injector = fn


def _io_call(op: Callable[[], Any], path: str):
    """One I/O operation under the bounded retry with exponential backoff."""
    for attempt in range(_IO_ATTEMPTS):
        try:
            if _io_fault_injector is not None:
                _io_fault_injector(path, attempt)
            return op()
        except OSError:
            if attempt == _IO_ATTEMPTS - 1:
                raise
            time.sleep(_IO_BACKOFF_S * (2 ** attempt))


# ---------------------------------------------------------------------
# leaf paths
# ---------------------------------------------------------------------
def _walk(tree: PyTree, fn: Callable, path: tuple = ()) -> PyTree:
    """``fn(path, leaf)`` over the leaves, the containers rebuilt; a path is
    the tuple of its keys' names."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):      # NamedTuple
        return type(tree)(*(_walk(v, fn, path + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def leaf_to_numpy(leaf) -> np.ndarray:
    """A leaf as fedckpt writes it: the tensor's own elements on the host,
    bf16 in an f32 container."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # f32 is a lossless container for bf16 (a load casts back via `like`)
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _flatten(tree: PyTree) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}

    def put(path, leaf):
        out[_SEP.join(path)] = leaf_to_numpy(leaf)

    _walk(tree, put)
    return out


def save_pytree(path: str, tree: PyTree) -> None:
    """Atomic npz write: tmp file + ``os.replace``, under the retry loop.
    ``np.savez`` appends ``.npz`` to string paths, so the bytes go through
    an open file object and the published name is exactly ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    tmp = path + ".tmp"

    def write():
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    _io_call(write, path)


def save_json(path: str, obj: dict) -> None:
    """Atomic json sidecar write (the same tmp + replace + retry)."""
    tmp = path + ".tmp"

    def write():
        try:
            with open(tmp, "w") as f:
                json.dump(obj, f, default=float)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    _io_call(write, path)


def file_crc32(path: str) -> int:
    """crc32 of a file's bytes: the integrity stamp ``Checkpointer`` keeps
    in the meta sidecar and checks before a restore."""
    def read():
        crc = 0
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                crc = zlib.crc32(chunk, crc)
        return crc & 0xFFFFFFFF

    return _io_call(read, path)


def spill_members(directory: str, round_idx: int, stacked: PyTree) -> list[str]:
    """Persist one evicted teacher-bank round: member k of the (K, ...)
    stacked tree goes to ``r{round:05d}_g{k}.npz`` (one ``save_pytree``
    each, the form ``load_pytree`` restores)."""
    leaves: list = []
    _walk(stacked, lambda _, x: leaves.append(x))
    paths = []
    for k in range(leaves[0].shape[0]):
        p = os.path.join(directory, f"r{round_idx:05d}_g{k}.npz")
        save_pytree(p, _walk(stacked, lambda _, x, k=k: x[k]))
        paths.append(p)
    return paths


# ---------------------------------------------------------------------
# per-client state spills (the ClientStore's disk tier): one npz per
# (kind, client), which a fresh process over the same directory restores
# ---------------------------------------------------------------------
_CLIENT_RE = re.compile(r"^(?P<kind>[a-z]+)_c(?P<cid>\d{8})(?P<suffix>.*)\.npz$")


def client_state_path(directory: str, kind: str, cid: int, suffix: str = "") -> str:
    """The spill path of one client's state of a kind (``ctrl`` a SCAFFOLD
    control, ``data`` a padded shard row): ``{kind}_c{cid:08d}{suffix}.npz``."""
    return os.path.join(directory, f"{kind}_c{cid:08d}{suffix}.npz")


def spilled_client_ids(directory: str, kind: str) -> list[int]:
    """Client ids with a spilled ``kind`` file in ``directory``: how a
    restarted ``SpillingStore`` finds the clients ever touched.  Stale
    ``.tmp`` files of a crashed writer were never published and are
    removed on the way."""
    out = []
    if not os.path.isdir(directory):
        return out
    for fn in os.listdir(directory):
        if fn.endswith(".tmp"):
            try:
                os.remove(os.path.join(directory, fn))
            except OSError:
                pass
            continue
        m = _CLIENT_RE.match(fn)
        if m and m.group("kind") == kind:
            out.append(int(m.group("cid")))
    return sorted(set(out))


def load_pytree(path: str, like: PyTree, device=None) -> PyTree:
    """Restore into ``like``'s structure: each leaf takes ``like``'s shape
    (which must match), dtype and device (``device`` overrides the last,
    for a ``like`` of meta tensors)."""
    p = path if path.endswith(".npz") else path + ".npz"

    def read():
        with np.load(p) as data:
            return {k: data[k] for k in data.files}

    data = _io_call(read, p)

    def leaf(keys, x):
        key = _SEP.join(keys)
        arr = data[key]
        if tuple(arr.shape) != tuple(x.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(x.shape)}")
        return torch.from_numpy(arr).to(device=device or x.device, dtype=x.dtype)

    return _walk(like, leaf)


class Checkpointer:
    """Step-indexed checkpoints with retention: ``{prefix}_000042.npz`` and
    its meta.  ``prefix`` separates families in one directory (the training
    CLI keeps ``ckpt_*`` model snapshots beside ``state_*`` full-state
    resume checkpoints)."""

    def __init__(self, directory: str, keep: int = 4, prefix: str = "ckpt"):
        self.dir = directory
        self.keep = keep
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)
        # a crash mid-write leaves `.tmp` orphans, never published
        for fn in os.listdir(directory):
            if fn.endswith(".tmp"):
                try:
                    os.remove(os.path.join(directory, fn))
                except OSError:
                    pass

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}_{step:06d}.npz")

    def save(self, step: int, tree: PyTree, meta: dict | None = None) -> str:
        p = self._path(step)
        save_pytree(p, tree)
        # the meta always exists: it carries the npz checksum
        meta = dict(meta or {})
        meta["crc32"] = file_crc32(p)
        save_json(p.replace(".npz", ".json"), meta)
        self._gc()
        return p

    def load_meta(self, step: int) -> dict | None:
        mp = self._path(step).replace(".npz", ".json")
        if not os.path.exists(mp):
            return None
        with open(mp) as f:
            return json.load(f)

    def verify(self, step: int) -> bool:
        """True iff the step's npz matches its recorded checksum (a step
        with no meta or no crc passes unverified)."""
        p = self._path(step)
        if not os.path.exists(p):
            return False
        meta = self.load_meta(step)
        if meta is None or "crc32" not in meta:
            return True
        return file_crc32(p) == int(meta["crc32"])

    def restore(self, step: int, like: PyTree) -> PyTree:
        return load_pytree(self._path(step), like)

    def steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            m = re.fullmatch(rf"{re.escape(self.prefix)}_(\d+)\.npz", fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore_latest(self, like: PyTree) -> tuple[int, PyTree] | None:
        """The newest step that verifies and loads: a corrupt or truncated
        newer one is skipped, not raised."""
        for s in reversed(self.steps()):
            try:
                if not self.verify(s):
                    continue
                return s, self.restore(s, like)
            except Exception:
                continue
        return None

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            for ext in (".npz", ".json"):
                fp = self._path(s).replace(".npz", ext)
                if os.path.exists(fp):
                    os.remove(fp)
