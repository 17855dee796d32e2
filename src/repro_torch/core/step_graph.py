"""One device program per step: the port's counterpart of ``jax.jit`` over a
loop body, the reference's ``step_mode="scan"``.

A *step program* is a body that reads and writes only its static buffers:
tensors allocated once per static shape, which the caller fills with
``copy_`` before the first step and reads, as copies, after the last.  A
step index the body needs lives in a buffer too and the body advances it,
so every step is the same program.

On a card the first call runs the body eagerly on the owner's side stream,
a real step that warms everything up: each kernel library's module is
loaded and its function attributes set, cuBLAS makes its workspace for the
stream, kernels 1 and 11 make their arrival counters for it, and the
kernels' launch counter is made (``repro_torch.kernels``).  Then the
body is captured on the same stream into a ``torch.cuda.CUDAGraph`` in the
owner's graph memory pool, so capture allocates nothing outside the pool.
Every later call replays the graph: one launch from the host where the
body has hundreds.  A capture that fails raises, naming the program;
nothing falls back to the stepped path.

On the CPU the same body runs eagerly at every call, so the CPU tests hold
the scan path's arithmetic against the reference's scan and against the
port's stepped path bit for bit.

The step-mode policy is the reference's: ``REPRO_ENGINE_STEP_MODE``
overrides the owner's mode, and ``"auto"`` is ``"scan"`` on a CUDA device
(where the reference's is on the TPU) and the owner's ``cpu_default``
elsewhere: ``"stepped"`` for the client engines, ``"scan"`` for the KD
pipeline and the serve engine.  Each owner holds a ``StepGraphs`` with its
mode and asks it ``scan(device)`` at each loop.

A program's body is fixed at its first call: programs are keyed on the
shapes and dtypes of their inputs alone, so an owner whose functions change
(a kernel swapped for its plain version) is built anew.

Launch counts: a kernel wrapper called eagerly counts its launch in
``kernels.launches``; one called while a capture records it records beside
its kernel an increment of its slot in the card's counter, so each replay
counts the launches it runs on the card (``kernels.counted``).  The warm-up
makes that counter before any capture.  ``captures`` counts the captures by
program name: a steady state, where the shapes repeat, captures nothing (the
counterpart of the reference's ``TraceGuard``, no steady-state compile).
"""
from __future__ import annotations

import os
from collections import Counter
from types import SimpleNamespace
from typing import Any, Callable

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

PyTree = Any

STEP_MODES = ("auto", "scan", "stepped")

captures: Counter = Counter()


def resolve_step_mode(mode: str = "auto", cpu_default: str = "stepped",
                      device="cpu") -> str:
    """``"scan"`` or ``"stepped"`` for a loop on ``device`` (the policy in
    the module docstring).  ``"scan"``: each step is one step program.
    ``"stepped"``: each step's ops launched from Python."""
    mode = os.environ.get("REPRO_ENGINE_STEP_MODE", mode)
    if mode not in STEP_MODES:
        raise ValueError(f"step_mode={mode!r} not in {STEP_MODES}")
    if mode != "auto":
        return mode
    return "scan" if torch.device(device).type == "cuda" else cpu_default


def shape_key(*trees: PyTree) -> tuple:
    """The static part of a set of input trees: each leaf's shape and dtype
    (a non-tensor leaf, a host counter, by its type)."""
    return tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else type(x)
                 for t in trees for x in tree_leaves(t))


def static_like(tree: PyTree, shape: Callable = None, device=None) -> PyTree:
    """A static buffer per tensor leaf of ``tree`` (``shape(x)`` overrides a
    leaf's shape, ``device`` its device), uninitialised; other leaves are
    kept as they are."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.empty(tuple(x.shape) if shape is None else shape(x),
                           dtype=x.dtype, device=x.device if device is None else device)
    return tree_map(leaf, tree)


def copy_into(dst: PyTree, src: PyTree) -> None:
    """``dst``'s tensor leaves take ``src``'s values in place (each source
    leaf into the leading part of its buffer along every axis); a leaf that
    is the same object on both sides is skipped."""
    pairs = [(d, s) for d, s in zip(tree_leaves(dst), tree_leaves(src))
             if isinstance(d, torch.Tensor) and d is not s]
    if not pairs:
        return
    dsts = [d if d.shape == s.shape else d[tuple(slice(0, n) for n in s.shape)]
            for d, s in pairs]
    torch._foreach_copy_(dsts, [s for _, s in pairs])


def clone_tensors(tree: PyTree) -> PyTree:
    """Copies of ``tree``'s tensor leaves: what leaves a step program never
    shares storage with its buffers."""
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


class StepProgram:
    """One step body over its static buffers ``buf``; calling it runs one
    step (see the module docstring)."""

    def __init__(self, name: str, body: Callable[[], None], buf: dict, device: torch.device,
                 stream: torch.cuda.Stream | None, pool):
        self.name, self.body, self.buf = name, body, buf
        self.device, self.stream, self.pool = device, stream, pool
        self.graph: torch.cuda.CUDAGraph | None = None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.body()
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()

    def _capture(self) -> None:
        dev, stream = self.device, self.stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.body()                         # the warm-up: a real step
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                self.body()
        except Exception as e:
            raise RuntimeError(f"step program {self.name!r}: CUDA graph capture "
                               f"failed: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = graph
        captures[self.name] += 1


class StepGraphs:
    """The step programs of one runner or serve engine, cached by name and
    the static shapes and dtypes of their inputs; on a card they share one
    graph memory pool and one side stream.  ``mode`` and ``cpu_default``
    are the owner's step-mode policy; ``with_mode`` gives another owner's
    policy over the same programs, pool and buffers."""

    def __init__(self, mode: str = "auto", cpu_default: str = "stepped"):
        if mode not in STEP_MODES:
            raise ValueError(f"step_mode={mode!r} not in {STEP_MODES}")
        self.mode, self.cpu_default = mode, cpu_default
        self._store = SimpleNamespace(programs={}, shared={}, stream=None, pool=None)

    def with_mode(self, mode: str = "auto", cpu_default: str = "stepped") -> "StepGraphs":
        view = StepGraphs(mode, cpu_default)
        view._store = self._store
        return view

    def scan(self, device) -> bool:
        """Whether a loop on ``device`` runs as step programs now."""
        return resolve_step_mode(self.mode, self.cpu_default, device) == "scan"

    @property
    def programs(self) -> dict:
        return self._store.programs

    def program(self, name: str, key: tuple,
                build: Callable[[], tuple[Callable[[], None], dict]]) -> StepProgram:
        """The program cached under ``(name, key)``; ``build()`` returns its
        ``(body, buffers)`` the first time."""
        prog = self.programs.get((name, key))
        if prog is None:
            body, buf = build()
            dev = next(x.device for x in tree_leaves(buf) if isinstance(x, torch.Tensor))
            st = self._store
            if dev.type == "cuda" and st.stream is None:
                st.stream, st.pool = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle()
            prog = self.programs[(name, key)] = StepProgram(name, body, buf, dev, st.stream,
                                                            st.pool)
        return prog

    def shared(self, name: str, like: PyTree) -> PyTree:
        """A static buffer tree like ``like``, one per ``name`` and shapes,
        handed to every program that asks: programs of one owner run one at
        a time and each fills its inputs before it runs, so a sequential
        client step and a KD step can share one model-sized buffer."""
        key = (name, shape_key(like))
        if key not in self._store.shared:
            self._store.shared[key] = static_like(like)
        return self._store.shared[key]

    def drop(self, prog: StepProgram) -> None:
        for k in [k for k, p in self.programs.items() if p is prog]:
            del self.programs[k]
