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

Sets, and what may share.  The programs of one ``StepGraphs`` set share one
graph memory pool, one capture stream and the buffers ``shared`` hands out
(a sequential client step and a KD step use one model-sized buffer).  That
is safe only while they run one at a time, in the order they are called, on
one stream.  So a set is the unit of that contract: a program that may be in
flight while another runs belongs to another set, with its own pool, stream
and buffers (``separate``).  Under ``overlap="async"`` the KD pipeline owns
such a set; its whole KD goes onto a KD stream (a *lane*, ``on_lane``) and
the set is *held* there (``hold``) until the resolve waits for it
(``release``).  A program called on another lane while its set is held
raises, naming both: a second program in flight on a shared pool or buffer
is an error, never a race.  On the CPU a lane is a label and a hold a flag,
so the CPU tests see the same error.

A *paired program* (``pair``, for ``overlap="fused"``) runs one step of a
program of one set and one step of a program of another as one CUDA graph
captured with two branches: the first body on a side stream forked inside
the capture, the second on the capture stream, joined at the end.  Each body
keeps its own buffers; the pair has its own pool.  On the CPU a pair runs
the two bodies in turn.
"""
from __future__ import annotations

import contextvars
import os
from collections import Counter
from contextlib import contextmanager
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


_cpu_lane: contextvars.ContextVar = contextvars.ContextVar("step_graph_cpu_lane",
                                                             default=None)


def current_lane(device):
    """Where work issued now on ``device`` goes: the current stream on a
    card; on the CPU the label ``on_lane`` set (``None`` outside it)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.current_stream(dev)
    return _cpu_lane.get()


@contextmanager
def on_lane(lane, device):
    """Issue the block's work on ``lane``: a ``torch.cuda.Stream`` on a card
    (its current stream for the block), a label on the CPU."""
    if torch.device(device).type == "cuda":
        with torch.cuda.stream(lane):
            yield
        return
    token = _cpu_lane.set(lane)
    try:
        yield
    finally:
        _cpu_lane.reset(token)


class _InFlight:
    """A set's in-flight state, ``(lane, event)`` or ``None``: held by the
    set and by each of its programs (the programs hold no reference to the
    set itself, so that a set and its programs form no cycle, which would
    keep their graph pools until the cyclic collector ran)."""
    __slots__ = ("flight",)

    def __init__(self):
        self.flight = None


def _check_lane(name: str, state: _InFlight, device) -> None:
    """Raise if the set of ``state`` is in flight on a lane other than the
    current one."""
    held = state.flight
    if held is not None and held[0] != current_lane(device):
        raise RuntimeError(
            f"step program {name!r}: its set (graph pool, stream and shared "
            f"buffers) is in flight on lane {held[0]!r} and this call is on "
            f"{current_lane(device)!r}; programs that may run at once need "
            f"separate sets (StepGraphs.separate)")


class StepProgram:
    """One step body over its static buffers ``buf``; calling it runs one
    step (see the module docstring)."""

    def __init__(self, name: str, body: Callable[[], None], buf: dict, device: torch.device,
                 stream: torch.cuda.Stream | None, pool, state: _InFlight):
        self.name, self.body, self.buf = name, body, buf
        self.device, self.stream, self.pool, self.state = device, stream, pool, state
        self.graph: torch.cuda.CUDAGraph | None = None
        self.dropped = False
        self.captures = 0                       # this program's own (TraceGuard.watch)

    def __call__(self) -> None:
        _check_lane(self.name, self.state, self.device)
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
        self.captures += 1
        captures[self.name] += 1


class PairedProgram:
    """One step of program ``a`` and one of program ``b``, of two sets, as
    one program: on a card a CUDA graph with ``a``'s body on a side branch
    and ``b``'s on the capture stream (see the module docstring)."""

    def __init__(self, name: str, a: StepProgram, b: StepProgram, stream, side, pool):
        if a.state is b.state:
            raise RuntimeError(
                f"paired program {name!r}: {a.name!r} and {b.name!r} are of one set "
                f"(one graph pool and shared buffers); their branches would run at "
                f"once, so they need separate sets (StepGraphs.separate)")
        self.name, self.a, self.b = name, a, b
        self.device, self.stream, self.side, self.pool = a.device, stream, side, pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.captures = 0

    def __call__(self) -> None:
        for prog in (self.a, self.b):
            _check_lane(prog.name, prog.state, prog.device)
        if self.device.type != "cuda":
            self.a.body()
            self.b.body()
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()

    def _branches(self, cap, side) -> None:
        side.wait_stream(cap)                   # fork
        with torch.cuda.stream(side):
            self.a.body()
        self.b.body()
        cap.wait_stream(side)                   # join

    def _capture(self) -> None:
        dev, cap, side = self.device, self.stream, self.side
        cur = torch.cuda.current_stream(dev)
        cap.wait_stream(cur)
        with torch.cuda.stream(cap):
            self._branches(cap, side)           # the warm-up: a real step of each
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=cap):
                self._branches(cap, side)
        except Exception as e:
            raise RuntimeError(f"paired program {self.name!r}: CUDA graph capture "
                               f"failed: {e}") from e
        cur.wait_stream(cap)
        self.graph = graph
        self.captures += 1
        captures[self.name] += 1


def _new_store():
    return SimpleNamespace(programs={}, shared={}, pairs={}, stream=None, side=None,
                           pool=None, state=_InFlight())


class StepGraphs:
    """A set of step programs, of one runner, KD pipeline or serve engine,
    cached by name and the static shapes and dtypes of their inputs; on a
    card they share one graph memory pool and one capture stream and run
    one at a time (the module docstring).  ``mode`` and ``cpu_default`` are
    the owner's step-mode policy; ``with_mode`` gives another owner's policy
    over the same set, ``separate`` over a set of its own."""

    def __init__(self, mode: str = "auto", cpu_default: str = "stepped"):
        if mode not in STEP_MODES:
            raise ValueError(f"step_mode={mode!r} not in {STEP_MODES}")
        self.mode, self.cpu_default = mode, cpu_default
        self._store = _new_store()

    def with_mode(self, mode: str = "auto", cpu_default: str = "stepped") -> "StepGraphs":
        view = StepGraphs(mode, cpu_default)
        view._store = self._store
        return view

    def separate(self, mode: str = "auto", cpu_default: str = "stepped") -> "StepGraphs":
        """A set of its own (pool, stream, shared buffers) under this
        policy: for programs that may be in flight beside this set's."""
        return StepGraphs(mode, cpu_default)

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
            self._card_resources(dev)
            st = self._store
            prog = self.programs[(name, key)] = StepProgram(name, body, buf, dev, st.stream,
                                                            st.pool, st.state)
        return prog

    def _card_resources(self, dev: torch.device) -> None:
        st = self._store
        if dev.type == "cuda" and st.stream is None:
            st.stream, st.pool = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle()

    def pair(self, name: str, a: StepProgram, b: StepProgram) -> PairedProgram:
        """The paired program of ``a`` (the side branch) and ``b``, cached in
        this set, which holds neither: its pool is the pair's alone.  A pair
        whose program its set has since dropped is dropped too."""
        st = self._store
        for k in [k for k, p in st.pairs.items() if p.a.dropped or p.b.dropped]:
            del st.pairs[k]
        key = (name, id(a), id(b))
        prog = st.pairs.get(key)
        if prog is None:
            self._card_resources(a.device)
            if a.device.type == "cuda" and st.side is None:
                st.side = torch.cuda.Stream(a.device)
            prog = st.pairs[key] = PairedProgram(name, a, b, st.stream, st.side, st.pool)
        return prog

    @property
    def pairs(self) -> dict:
        return self._store.pairs

    def jit_programs(self, prefix: str = "") -> dict:
        """The set's step programs and paired programs whose names start
        with ``prefix``, by label (the name, with ``[i]`` after the second
        and later of one name, which differ in shapes): what
        ``analysis.TraceGuard.watch_programs`` watches."""
        out: dict = {}
        for prog in [*self.programs.values(), *self.pairs.values()]:
            if not prog.name.startswith(prefix):
                continue
            label, i = prog.name, 1
            while label in out:
                label, i = f"{prog.name}[{i}]", i + 1
            out[label] = prog
        return out

    def shared(self, name: str, like: PyTree) -> PyTree:
        """A static buffer tree like ``like``, one per ``name`` and shapes,
        handed to every program of the set that asks: they run one at a
        time and each fills its inputs before it runs, so a sequential
        client step and a KD step of one set can share one model-sized
        buffer.  Programs that may be in flight at once are of separate
        sets and never share one."""
        key = (name, shape_key(like))
        if key not in self._store.shared:
            self._store.shared[key] = static_like(like)
        return self._store.shared[key]

    def drop(self, prog: StepProgram) -> None:
        prog.dropped = True
        for k in [k for k, p in self.programs.items() if p is prog]:
            del self.programs[k]

    # ---- in flight on a lane -----------------------------------------
    def hold(self, lane, device) -> None:
        """The set is in flight on ``lane`` from now until ``release``: its
        work was issued there and the issuer does not wait for it.  A
        program of the set called on another lane meanwhile raises."""
        state = self._store.state
        if state.flight is not None:
            raise RuntimeError(f"step program set already in flight on lane "
                               f"{state.flight[0]!r}")
        event = None
        if torch.device(device).type == "cuda":
            event = torch.cuda.Event()
            event.record(lane)
        state.flight = (lane, event)

    def release(self, device) -> None:
        """The current lane waits for the set's work (an event wait on a
        card: no host sync) and the set is free again."""
        state = self._store.state
        if state.flight is None:
            return
        _, event = state.flight
        if event is not None:
            torch.cuda.current_stream(torch.device(device)).wait_event(event)
        state.flight = None

    @property
    def in_flight(self) -> bool:
        return self._store.state.flight is not None
