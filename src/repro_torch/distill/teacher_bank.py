"""Device-resident teacher bank, paper §3.1.3 Eq. 5 (port of
``repro/distill/teacher_bank.py``).

The teacher ensemble is the checkpoints of all K global models over the
last R rounds, held as ONE stacked tree on the device (leaves
``(R, K, ...)``).  ``push`` copies a round's K models into the oldest
slot: a copy, never a reference, since the round goes on to distil its
own main model and must not change the teacher it just pushed.
``members`` lists the teachers newest round first as gathered copies
that survive a later ``push``, as the reference's do;
``member_views`` lists the same members as views into the ring for the KD
pipeline, which reads them before the next ``push``; ``members_stacked``
gathers them into one ``(M, ...)`` copy.  An overlapped round's pending KD
job reads the views after its round has ended: it ``hold``s the ring until
its resolve ``release``s it, and a ``push`` meanwhile raises instead of
overwriting what the job still reads.

With ``spill_dir`` a round evicted from the ring is first persisted
through ``fedckpt`` (one ``.npz`` a member, ``r{round:05d}_g{k}.npz``).
``degraded_mask_stacked`` marks the members that carried a group's model
forward (the trust weights' input); ``export_state`` / ``import_state`` /
``bank_like`` carry the ring, its slot map, cursor and degraded log
through a full-state checkpoint.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.fedckpt.checkpointer import spill_members
from repro_torch.device import to_device
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unstack

PyTree = Any
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TeacherBank:
    """Ring buffer of the last R rounds' K aggregated checkpoints.

    ``dtype`` (None, ``"float32"`` or ``"bfloat16"``) is the storage
    precision of floating leaves; the KD pipeline upcasts teachers to f32
    before their forward, so only the stored weights are rounded.
    """

    def __init__(self, K: int, R: int, spill_dir: str | None = None, dtype=None):
        if K < 1 or R < 1:
            raise ValueError(f"K and R must be >= 1, got K={K}, R={R}")
        self.K, self.R = K, R
        self.spill_dir = spill_dir
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self._bank: PyTree | None = None           # leaves (R, K, ...)
        self._slot_rounds: list[int | None] = [None] * R
        self._cursor = 0
        self._degraded: dict[int, tuple] = {}
        self._holds = 0

    def _store_dtype(self, leaf: torch.Tensor) -> torch.dtype:
        if self.dtype is not None and leaf.is_floating_point():
            return self.dtype
        return leaf.dtype

    # ------------------------------------------------------------- write
    def push(self, round_idx: int, global_models: Sequence[PyTree] | PyTree,
             degraded: Sequence[int] = ()) -> None:
        """Copy one round's K models into the oldest slot.

        ``global_models``: a list of K trees, or one tree whose leaves carry
        the leading (K, ...) model axis.  ``degraded`` names the groups whose
        model is a carry-forward this round.  Raises while a pending KD job
        holds the ring's views (``hold``).
        """
        if self._holds:
            raise RuntimeError(
                f"TeacherBank.push(round {round_idx}): a pending KD job still reads "
                f"the ring through member_views(); resolve it before the push")
        if degraded:
            self._degraded[int(round_idx)] = tuple(sorted(int(k) for k in degraded))
        if isinstance(global_models, (list, tuple)):
            if len(global_models) != self.K:
                raise ValueError(f"expected {self.K} group models, got {len(global_models)}")
            models = list(global_models)
        else:
            lead = tree_leaves(global_models)[0].shape[0]
            if lead != self.K:
                raise ValueError(f"stacked model axis {lead} != K={self.K}")
            models = tree_unstack(global_models)
        if self._bank is None:
            self._bank = tree_map(
                lambda m: torch.zeros((self.R, self.K) + tuple(m.shape),
                                      dtype=self._store_dtype(m), device=m.device),
                models[0])
        slot = self._cursor
        evicted = self._slot_rounds[slot]
        if evicted is not None and self.spill_dir:
            spill_members(self.spill_dir, evicted, tree_map(lambda b: b[slot], self._bank))
        with torch.no_grad():
            for k, model in enumerate(models):
                tree_map(lambda b, m: b[slot, k].copy_(m), self._bank, model)
        self._slot_rounds[slot] = round_idx
        self._cursor = (slot + 1) % self.R

    # ------------------------------------------------------------- read
    def round_stack(self, slot: int) -> PyTree:
        """(K, ...) stack of one ring slot, copied: a later ``push`` leaves
        it as it was."""
        return tree_map(lambda b: b[slot].clone(), self._bank)

    def _slots_newest_first(self) -> list[int]:
        held = [(r, s) for s, r in enumerate(self._slot_rounds) if r is not None]
        held.sort(reverse=True)
        return [s for _, s in held]

    def members_stacked(self) -> PyTree | None:
        """(M, ...) stacked teachers, newest round first (a fresh gather, not
        a view of the ring); None if empty."""
        order = self._slots_newest_first()
        if not order:
            return None
        index = to_device(torch.tensor(order), tree_leaves(self._bank)[0].device)
        return tree_map(lambda b: b.index_select(0, index).flatten(0, 1), self._bank)

    def members(self) -> list[PyTree]:
        """Flat teacher list {w_{t-r,k}}, newest round first, as gathered
        copies: holding them across a later ``push`` is safe."""
        stacked = self.members_stacked()
        return [] if stacked is None else tree_unstack(stacked)

    def member_views(self) -> list[PyTree]:
        """The members of ``members()`` as views into the ring: no copy,
        valid only until the next ``push``.  The KD pipeline reads them a
        member at a time before that push, because a model-zoo ring of 8 is
        tens of GB and a gathered copy would double it."""
        if self._bank is None:
            return []
        return [tree_map(lambda b, s=s, k=k: b[s, k], self._bank)
                for s in self._slots_newest_first() for k in range(self.K)]

    def hold(self) -> None:
        """A pending KD job reads ``member_views()`` until ``release``."""
        self._holds += 1

    def release(self) -> None:
        if self._holds == 0:
            raise RuntimeError("TeacherBank.release without a hold")
        self._holds -= 1

    @property
    def held(self) -> bool:
        return self._holds > 0

    @property
    def num_members(self) -> int:
        return self.K * sum(r is not None for r in self._slot_rounds)

    def nbytes(self) -> int:
        """Device bytes held by the ring."""
        if self._bank is None:
            return 0
        return sum(x.numel() * x.element_size() for x in tree_leaves(self._bank))

    def rounds_held(self) -> list[int]:
        return sorted(r for r in self._slot_rounds if r is not None)

    def degraded_rounds(self) -> dict[int, tuple]:
        """round -> groups that carried forward that round (see ``push``)."""
        return dict(self._degraded)

    def degraded_mask_stacked(self) -> np.ndarray | None:
        """(M,) bool in ``members()`` order: True where member m is a group
        model that carried forward in its slot's round (the bank's input to
        the KD trust weights: a stale global that agreement alone may not
        tell from a fresh one)."""
        order = self._slots_newest_first()
        if not order:
            return None
        mask = []
        for s in order:
            bad = set(self._degraded.get(int(self._slot_rounds[s]), ()))
            mask.extend(k in bad for k in range(self.K))
        return np.asarray(mask, bool)  # lint-ok: RA101 host list

    # -------------------------------------------- crash-safe resume hooks
    def bank_like(self, member_like: PyTree) -> PyTree:
        """Zeros with the ring's (R, K, ...) shapes and storage dtypes: the
        ``like`` a checkpoint restore loads into."""
        return tree_map(lambda m: torch.zeros((self.R, self.K) + tuple(m.shape),
                                              dtype=self._store_dtype(m), device=m.device),
                        member_like)

    def export_state(self) -> tuple[PyTree | None, dict]:
        """(the ring, a JSON-able meta): what a fresh bank needs to resume
        this one (slot map, cursor, degraded log; an empty slot is round
        −1)."""
        meta = {
            "slot_rounds": [-1 if r is None else int(r) for r in self._slot_rounds],
            "cursor": int(self._cursor),
            "degraded": {str(r): list(v) for r, v in self._degraded.items()},
        }
        return self._bank, meta

    def import_state(self, bank: PyTree | None, meta: dict) -> None:
        """Adopt a checkpointed ring and meta (``export_state``'s inverse)."""
        self._bank = bank
        self._slot_rounds = [None if int(r) < 0 else int(r) for r in meta["slot_rounds"]]
        self._cursor = int(meta["cursor"])
        self._degraded = {int(r): tuple(int(k) for k in v)
                          for r, v in meta.get("degraded", {}).items()}
