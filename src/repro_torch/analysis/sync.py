"""sync_contract(): zero implicit device→host syncs, enforced (port of
``repro/analysis/sync.py``).

The round loop's performance model assumes every phase is an asynchronous
launch; one stray ``float(loss)`` stalls the host once per client and the
server cost is per-client again.  This module makes the invariant
executable::

    with sync_contract("round"):
        state = runner.run_round(state)      # any implicit sync raises

    with allowed_sync("one-per-round KD loss pull"):
        losses = losses.cpu().numpy()        # annotated, allowed

Two enforcement layers compose:

* ``torch.cuda.set_sync_debug_mode("error")`` on a card: every operation
  that makes the host wait for a stream (``.item()``, a blocking copy
  between the host and the card in either direction, ``nonzero``,
  ``torch.cuda.synchronize()``, a stream's ``synchronize``) raises inside
  the contract.  The mode is process-wide; the contract restores the outer
  mode on exit, and ``allowed_sync`` turns it off for its scope and then
  restores it.  An error of this layer that leaves the contract is raised
  again as ``SyncViolation``.
* a portable funnel over ``torch.Tensor``'s materialisations: ``item``,
  ``tolist``, ``numpy``, ``__array__``, ``__float__``, ``__int__``,
  ``__index__``, ``__bool__``, and ``cpu`` / ``to`` from a CUDA tensor to
  the host.  It fires on the CPU too, where nothing is a transfer, so the
  CPU tests see every site the card would stall at.  It is installed on the
  first contract's entry, once, and costs one global check when no contract
  is active.

``np.asarray(tensor)`` goes through ``__array__`` and is caught; the AST
linter (``repro_torch.analysis.lint``, rule RA101) flags the sinks on the
hot paths at review time as well.

``allowed_sync`` scopes are thread-local (for the funnel); the contract
stack is process-global, so a violation on another thread is caught too,
and a violation that something swallowed re-raises at contract exit.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import traceback
from dataclasses import dataclass
from typing import Iterator

import torch

__all__ = ["SyncViolation", "SyncRecord", "SyncScope", "allowed_sync", "sync_contract"]

# what the card layer's error says (c10::cuda::warn_or_error_on_sync)
_CARD_ERROR = "called a synchronizing CUDA operation"


class SyncViolation(RuntimeError):
    """An un-annotated device→host sync inside a contract."""


_TLS = threading.local()            # per-thread allowed_sync depth
_LOCK = threading.Lock()
_ACTIVE: list["SyncScope"] = []     # process-global contract stack
_INSTALLED = False


@dataclass
class SyncRecord:
    kind: str
    thread: str
    stack: str


class SyncScope:
    """Handle yielded by ``sync_contract``: carries observed violations."""

    def __init__(self, label: str) -> None:
        self.label = label
        self.violations: list[SyncRecord] = []


def _allow_depth() -> int:
    return getattr(_TLS, "depth", 0)


def _check(kind: str) -> None:
    """Called from the materialisation funnel; raises on a violation."""
    if not _ACTIVE:                      # the one global check
        return
    with _LOCK:
        scopes = list(_ACTIVE)
    if not scopes or _allow_depth() > 0:
        return
    # drop the funnel's two frames; keep the caller frames that name the site
    stack = "".join(traceback.format_stack(limit=12)[:-2])
    rec = SyncRecord(kind=kind, thread=threading.current_thread().name, stack=stack)
    with _LOCK:
        for scope in scopes:
            scope.violations.append(rec)
    raise SyncViolation(
        f"implicit device->host sync ({kind}) inside sync_contract[{scopes[-1].label}] on "
        f"thread {rec.thread!r}: wrap the site in allowed_sync(\"reason\") if it is "
        f"legitimate.\n{stack}")


def _guard(name: str, orig):
    @functools.wraps(orig)
    def guarded(self, *args, **kwargs):
        _check(name)
        return orig(self, *args, **kwargs)
    return guarded


def _to_host(self: torch.Tensor, args, kwargs) -> bool:
    """Whether ``self.to(*args, **kwargs)`` is a blocking copy from a card
    to the host."""
    if not self.is_cuda:
        return False
    device, _, non_blocking, _ = torch._C._nn._parse_to(*args, **kwargs)
    return device is not None and device.type == "cpu" and not non_blocking


def _install() -> None:
    """Patch ``torch.Tensor``'s materialisation funnel (once)."""
    global _INSTALLED
    with _LOCK:
        if _INSTALLED:
            return
        _INSTALLED = True
    cls = torch.Tensor
    for name in ("item", "tolist", "numpy", "__array__", "__float__", "__int__",
                 "__index__", "__bool__"):
        setattr(cls, name, _guard(name, getattr(cls, name)))
    orig_cpu, orig_to = cls.cpu, cls.to

    def guarded_cpu(self, *args, **kwargs):
        if _ACTIVE and self.is_cuda:
            _check("cpu")
        return orig_cpu(self, *args, **kwargs)

    def guarded_to(self, *args, **kwargs):
        if _ACTIVE and _to_host(self, args, kwargs):
            _check("to cpu")
        return orig_to(self, *args, **kwargs)

    cls.cpu, cls.to = guarded_cpu, guarded_to


def _card_mode(mode: int | str) -> int | None:
    """Set the card layer's mode; return the outer one (None without CUDA)."""
    if not torch.cuda.is_available():
        return None
    outer = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    return outer


@contextlib.contextmanager
def allowed_sync(reason: str) -> Iterator[None]:
    """Annotate a legitimate device→host sync; ``reason`` is mandatory.

    Inside the scope the funnel stands down (this thread only) and the
    card's sync debug mode is off (process-wide), then both are restored.
    The linter treats the lexical scope as exempt from RA101, so the
    one-line justification lives exactly where the sync happens.
    """
    if not reason or not reason.strip():
        raise ValueError("allowed_sync requires a non-empty reason string")
    _TLS.depth = _allow_depth() + 1
    outer = _card_mode(0) if _ACTIVE else None
    try:
        yield
    finally:
        if outer is not None:
            torch.cuda.set_sync_debug_mode(outer)
        _TLS.depth = _allow_depth() - 1


@contextlib.contextmanager
def sync_contract(label: str = "round") -> Iterator[SyncScope]:
    """Scope asserting zero un-annotated implicit device→host syncs.

    Violations raise at the offending site on the thread that synced (the
    card layer's error is raised again as ``SyncViolation`` when it leaves
    the scope); violations swallowed en route re-raise at contract exit.
    """
    _install()
    scope = SyncScope(label)
    with _LOCK:
        _ACTIVE.append(scope)
    outer = _card_mode("error")
    try:
        yield scope
    except RuntimeError as e:
        if isinstance(e, SyncViolation) or _CARD_ERROR not in str(e):
            raise
        stack = "".join(traceback.format_exception(e)[-12:])
        scope.violations.append(SyncRecord("card", threading.current_thread().name, stack))
        raise SyncViolation(f"implicit device->host sync (card layer: {e}) inside "
                            f"sync_contract[{label}]: wrap the site in "
                            f"allowed_sync(\"reason\") if it is legitimate.\n{stack}") from e
    finally:
        if outer is not None:
            torch.cuda.set_sync_debug_mode(outer)
        with _LOCK:
            _ACTIVE.remove(scope)
    if scope.violations:                 # clean exit but swallowed records
        first = scope.violations[0]
        raise SyncViolation(
            f"sync_contract[{label}]: {len(scope.violations)} implicit device->host "
            f"sync(s) were caught but swallowed (first: {first.kind} on thread "
            f"{first.thread!r}).\n{first.stack}")
