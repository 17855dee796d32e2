"""Seeded fault injection for federated rounds (port of
``repro/core/faults.py``).

A deployed federation never sees the clean world the engines assume:
clients drop out, stragglers miss the deadline, uploads arrive non-finite,
adversaries upload finite malicious updates, and spill or checkpoint I/O
fails.  This module makes each of these a seeded, replayable input to the
round loop:

  * ``FaultPlan``: per-round fault rates.  Every per-client decision is a
    function of ``(plan.seed, round, cid)`` alone (its own
    ``np.random.default_rng`` stream, the reference's, so both packages
    draw the same trace), so a plan replays the same trace on both engines
    and across a kill and restart.
  * ``apply_round_faults``: folds the round's decisions into the pre-drawn
    ``ClientEntry`` schedules.  The vectorized engine takes its pad
    targets (``entry_pad_hints``) before, so a degraded round reuses the
    buffers and CUDA graphs of a clean one: faults never recapture.
  * ``poison_model`` / ``poison_rows``: non-finite uploads (list form,
    stacked-row form).
  * ``attack_model`` / ``attack_rows``: Byzantine uploads, finite by
    construction (sign-flipped, rescaled or Gaussian-noised around the
    round's start model), which pass the isfinite guard and exercise the
    robust Eq. 2 (``core/robust_agg.py``) and the trust-weighted teachers.
    The Gaussian noise is drawn from a CPU ``torch.Generator`` seeded from
    (seed, round, cid, leaf) and copied to the device, so both engines, a
    restart, the CPU and the card draw the same values.  The reference
    draws it with ``jax.random``: the two agree in distribution, not in
    value.
  * ``finite_rows``: the per-client isfinite guard over a stacked update.
  * ``FaultPlan.io_injector``: selected paths fail their first I/O attempt
    in fedckpt's retry loop and succeed on the next.

Injection sits between the phases of a round (schedule, train, finish,
aggregate), never inside a step, so a zero-rate plan is bit-identical to
no plan.
"""
from __future__ import annotations

import math
import os
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.sync import allowed_sync
from repro_torch.utils.pytree import seeded_normal, tree_leaves, tree_map, tree_unflatten

PyTree = Any

ATTACK_MODES = ("none", "sign_flip", "scale", "gauss")


@dataclass(frozen=True)
class FaultPlan:
    """Seeded per-round fault rates; every decision replays from the seed.

    ``dropout``      P(a client vanishes for the round): zero weight in
                     Eq. 2, its controls never committed.
    ``straggler``    P(a surviving client misses the deadline): its schedule
                     keeps the fraction drawn per client from
                     ``[straggler_frac, 1)``, at least one step.
    ``corrupt``      P(a surviving client uploads a non-finite update).
    ``attack``       Byzantine mode: ``"none"``, ``"sign_flip"`` (upload
                     ``ref − attack_scale·Δ``), ``"scale"`` (``ref +
                     attack_scale·Δ``) or ``"gauss"`` (add
                     ``attack_scale``-std noise).
    ``attack_rate``  P(a surviving, uncorrupted client is adversarial).
    ``attack_scale`` the three modes' magnitude.
    ``spill_fail``   P(a spill or checkpoint path fails its first attempt).
    ``zero_fill``    ablation: dropped clients weigh zero WITHOUT the
                     renormalisation over survivors.
    """
    seed: int = 0
    dropout: float = 0.0
    straggler: float = 0.0
    straggler_frac: float = 0.5
    corrupt: float = 0.0
    attack: str = "none"
    attack_rate: float = 0.0
    attack_scale: float = 10.0
    spill_fail: float = 0.0
    zero_fill: bool = False

    def validate(self) -> None:
        for name in ("dropout", "straggler", "straggler_frac", "corrupt",
                     "attack_rate", "spill_fail"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"invalid FaultPlan: {name}={v} must be a "
                                 "probability in [0, 1]")
        if self.attack not in ATTACK_MODES:
            raise ValueError(f"invalid FaultPlan: attack={self.attack!r} "
                             f"not in {ATTACK_MODES}")
        if self.attack_rate > 0 and self.attack == "none":
            raise ValueError(
                "invalid FaultPlan: attack_rate="
                f"{self.attack_rate} with attack='none' would silently do "
                "nothing — pick an attack mode (sign_flip|scale|gauss) or "
                "zero the rate")
        if not self.attack_scale > 0:
            raise ValueError(f"invalid FaultPlan: attack_scale="
                             f"{self.attack_scale} must be > 0")

    @property
    def active(self) -> bool:
        """True when a per-client fault can fire (``spill_fail`` acts on
        I/O only)."""
        return (self.dropout > 0 or self.straggler > 0 or self.corrupt > 0
                or (self.attack != "none" and self.attack_rate > 0))

    def client_faults(self, round_idx: int, cid: int) -> tuple[bool, bool, bool, bool, float]:
        """(dropped, straggled, corrupt, attacked, straggler_severity) of one
        client in one round, from five uniforms of the client's own stream
        ``default_rng((seed, round, cid))``.  ``attacked`` excludes dropped
        and corrupt clients; the severity is the kept fraction of the
        schedule."""
        u = np.random.default_rng((self.seed, int(round_idx), int(cid))).random(5)
        dropped = bool(u[0] < self.dropout)
        straggled = bool((not dropped) and u[1] < self.straggler)
        corrupt = bool((not dropped) and u[2] < self.corrupt)
        attacked = bool((not dropped) and (not corrupt) and self.attack != "none"
                        and u[3] < self.attack_rate)
        severity = float(self.straggler_frac + (1.0 - self.straggler_frac) * u[4])
        return dropped, straggled, corrupt, attacked, severity

    def io_injector(self) -> Callable[[str, int], None]:
        """A hook for ``fedckpt.set_io_fault_injector``: a path whose
        (seed, basename) crc32 falls under ``spill_fail`` raises ``OSError``
        on attempt 0 and succeeds from attempt 1, within the retry budget,
        so the results never change."""
        seed, rate = self.seed, self.spill_fail

        def inject(path: str, attempt: int) -> None:
            if attempt > 0 or rate <= 0:
                return
            h = zlib.crc32(f"{seed}:{os.path.basename(path)}".encode())
            if h / 2 ** 32 < rate:
                raise OSError(f"injected I/O failure (attempt 0): {path}")

        return inject


@dataclass
class RoundFaults:
    """One round's resolved fault trace (host ints)."""
    plan: FaultPlan
    round_idx: int
    dropped: set = field(default_factory=set)       # cids
    stragglers: dict = field(default_factory=dict)  # cid -> kept steps
    corrupt: set = field(default_factory=set)       # cids poisoned at upload
    attacked: set = field(default_factory=set)      # cids uploading attacks


def apply_round_faults(plan: Optional[FaultPlan], round_idx: int,
                       entries: Sequence[Any]) -> Optional[RoundFaults]:
    """Fold the plan's round-t decisions into the pre-drawn ``ClientEntry``s
    in place: a dropped client keeps a 1-step schedule (the vectorized
    engine trains it as a wasted lane; the sequential one skips it) and
    ``dropped=True``; a straggler keeps the first ``ceil(severity·S)``
    steps.  None when the plan is absent or cannot fire: the caller then
    runs the unmodified path."""
    if plan is None or not plan.active:
        return None
    rf = RoundFaults(plan=plan, round_idx=round_idx)
    for e in entries:
        dropped, straggled, corrupt, attacked, severity = plan.client_faults(round_idx, e.cid)
        if dropped:
            e.dropped = True
            e.idx = e.idx[:1]
            rf.dropped.add(e.cid)
            continue
        if straggled:
            keep = max(1, math.ceil(severity * len(e.idx)))
            if keep < len(e.idx):
                e.idx = e.idx[:keep]
                rf.stragglers[e.cid] = keep
        if corrupt:
            rf.corrupt.add(e.cid)
        if attacked:
            rf.attacked.add(e.cid)
    return rf


# ---------------------------------------------------------------------
# corruption and the isfinite guard
# ---------------------------------------------------------------------
def poison_model(model: PyTree) -> PyTree:
    """A corrupted upload: every floating leaf NaN."""
    return tree_map(lambda x: torch.full_like(x, float("nan"))
                    if x.is_floating_point() else x, model)


def poison_rows(stacked: PyTree, rows: Sequence[int]) -> PyTree:
    """Client rows of a (C, ...) stacked update set to NaN (out of place)."""
    if not len(rows):
        return stacked
    idx = torch.tensor(list(rows), dtype=torch.int64,
                       device=tree_leaves(stacked)[0].device)
    return tree_map(lambda x: x.index_fill(0, idx, float("nan"))
                    if x.is_floating_point() else x, stacked)


def all_finite(tree: PyTree) -> bool:
    """Whether every floating leaf is finite (one host read)."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree) if x.is_floating_point()]
    if not flags:
        return True
    with allowed_sync("isfinite upload guard ruling: one bool pull per client "
                      "per degraded round (sequential oracle)"):
        return bool(torch.stack(flags).all())


def finite_rows(stacked: PyTree) -> np.ndarray:
    """(C,) host bool: row c is True iff every floating leaf of client c is
    finite: the upload guard in front of Eq. 2 and the control commits."""
    leaves = [x for x in tree_leaves(stacked) if x.is_floating_point()]
    if not leaves:
        return np.ones((tree_leaves(stacked)[0].shape[0],), bool)
    m = None
    for x in leaves:
        f = torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=1)
        m = f if m is None else m & f
    with allowed_sync("isfinite upload guard: one (C,) bool pull per degraded round"):
        return m.cpu().numpy()


# ---------------------------------------------------------------------
# Byzantine attacks (finite, guard-passing uploads)
# ---------------------------------------------------------------------
def gauss_noise(plan: FaultPlan, round_idx: int, cid: int, leaf: int, shape,
                device) -> torch.Tensor:
    """The gauss attack's standard normal draws for one leaf of one client:
    a CPU generator seeded from (seed, round, cid, leaf), then a copy to
    ``device``, so every engine, device and restart draws the same."""
    return seeded_normal([int(plan.seed) & 0xFFFFFFFF, int(round_idx) & 0x7FFFFFFF,
                          int(cid) & 0x7FFFFFFF, int(leaf)], shape, device)


def _attack_leaf(plan: FaultPlan, x: torch.Tensor, ref: torch.Tensor, noise) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    xf, rf = x.float(), ref.float()
    scale = plan.attack_scale
    if plan.attack == "sign_flip":
        out = rf - scale * (xf - rf)
    elif plan.attack == "scale":
        out = rf + scale * (xf - rf)
    else:  # gauss
        out = xf + scale * noise()
    return out.to(x.dtype)


def attack_model(plan: FaultPlan, round_idx: int, cid: int, model: PyTree,
                 ref: PyTree) -> PyTree:
    """The adversarial upload of one attacked client.  ``ref`` is its
    group's round-start model and Δ = model − ref its honest update:
    sign_flip uploads ``ref − scale·Δ``, scale ``ref + scale·Δ``, gauss the
    model plus ``scale``-std noise (``gauss_noise``, leaf i of the model's
    leaf order).  Every output is finite."""
    leaves_m, leaves_r = tree_leaves(model), tree_leaves(ref)
    out = [_attack_leaf(plan, x, r, lambda i=i, x=x: gauss_noise(
        plan, round_idx, cid, i, x.shape, x.device))
        for i, (x, r) in enumerate(zip(leaves_m, leaves_r))]
    return tree_unflatten(model, out)


def attack_rows(plan: FaultPlan, round_idx: int, stacked: PyTree,
                rows: Sequence[tuple], ref_models: Sequence[PyTree]) -> PyTree:
    """``attack_model`` on rows of a (C, ...) stacked update (out of place).
    ``rows`` is ``[(row_index, cid, group), ...]``; ``ref_models`` the
    per-group round-start globals.  The same arithmetic as the sequential
    engine's, one row at a time."""
    if not len(rows):
        return stacked
    out = tree_map(lambda x: x.clone() if x.is_floating_point() else x, stacked)
    for row, cid, gid in rows:
        m = attack_model(plan, round_idx, cid, tree_map(lambda x: x[row], out),
                         ref_models[gid])
        tree_map(lambda s, v: s[row].copy_(v) if s.is_floating_point() else None, out, m)
    return out


def fault_record(rf: RoundFaults, survivors: Sequence[int], rejected: Sequence[int],
                 degraded_groups: Sequence[int]) -> dict:
    """The history fields of a degraded round, plain Python ints, so the
    history survives the checkpoint's json meta."""
    return {
        "survivors": sorted(int(c) for c in survivors),
        "dropped": sorted(int(c) for c in rf.dropped),
        "stragglers": sorted(int(c) for c in rf.stragglers),
        "rejected": sorted(int(c) for c in rejected),
        "attacked": sorted(int(c) for c in rf.attacked),
        "degraded_groups": sorted(int(k) for k in degraded_groups),
    }
