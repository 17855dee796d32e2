"""TraceGuard: runtime proof that the hot paths build nothing in the steady
state (port of ``repro/analysis/trace_guard.py``).

The engine's whole scalability story rests on shape-stable programs:
padded bucket plans, chunked decode, static step buffers.  A regression
that specialises per round (a shape leak through a fault path, a buffer
keyed on a changing size) is invisible to correctness tests: results stay
right, and the cost quietly becomes a CUDA-graph capture per round.

The port's counterpart of an XLA compile is a step program's capture
(``core/step_graph.py``: its ``captures`` Counter, by program name) or a
kernel library's build or load (``kernels/build.py``: ``builds`` and
``loads``, by source).  A guard snapshots those process-wide counters on
entry and exposes the delta::

    with TraceGuard("round") as tg:
        state = runner.run_round(state)
    tg.assert_steady_state()        # raises TraceViolation, naming the program

``compiles`` counts captures, builds and loads; ``traces`` counts captures.
``watch(label, program)`` tracks one ``StepProgram`` or ``PairedProgram``'s
own capture count; the hot-path owners (``VectorizedClientEngine``,
``KDPipeline``, ``ContinuousEngine``, and any ``StepGraphs`` set, whose
paired programs are the fused overlap's) expose ``jit_programs()`` with
their step programs by label, so a guard watches them all in one call.
On the CPU a step program runs its body eagerly and captures nothing.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Mapping

__all__ = ["TraceGuard", "TraceViolation"]


class TraceViolation(RuntimeError):
    """A scope that promised steady state captured or built something."""


def _counters() -> tuple[Counter, Counter]:
    """(captures by program name, kernel builds and loads by source)."""
    from repro_torch.core import step_graph
    from repro_torch.kernels import build
    return Counter(step_graph.captures), build.builds + build.loads


def _capture_count(program: Any) -> int:
    """Captures of one step program (0 for anything that has none)."""
    return int(getattr(program, "captures", 0))


class TraceGuard:
    """Scope asserting zero captures and kernel builds (steady state).

    Counters are process-global, so a capture issued from anywhere inside
    the scope counts against it.  Guards may nest; each sees its own delta.
    """

    def __init__(self, label: str = "trace-guard",
                 watch: Mapping[str, Any] | None = None) -> None:
        self.label = label
        self._watch: dict[str, Any] = {}
        self._watch_enter: dict[str, int] = {}
        self._enter: tuple[Counter, Counter] | None = None
        self._exit: tuple[Counter, Counter] | None = None
        if watch:
            for name, prog in watch.items():
                self.watch(name, prog)

    # ------------------------------------------------------- watching
    def watch(self, label: str, program: Any) -> "TraceGuard":
        """Track one step program's capture count by label."""
        self._watch[label] = program
        self._watch_enter[label] = _capture_count(program)
        return self

    def watch_programs(self, *owners: Any) -> "TraceGuard":
        """Watch every program of objects exposing ``jit_programs()``."""
        for owner in owners:
            for label, prog in owner.jit_programs().items():
                self.watch(label, prog)
        return self

    # ----------------------------------------------------------- scope
    def __enter__(self) -> "TraceGuard":
        self._enter = _counters()
        self._exit = None
        return self

    def __exit__(self, *exc: Any) -> None:
        self._exit = _counters()

    def _delta(self, idx: int) -> Counter:
        if self._enter is None:
            return Counter()
        now = self._exit if self._exit is not None else _counters()
        return now[idx] - self._enter[idx]

    def captured(self) -> dict[str, int]:
        """Captures in the scope by program name (live until exit)."""
        return dict(self._delta(0))

    def built(self) -> dict[str, int]:
        """Kernel library builds and loads in the scope by source."""
        return dict(self._delta(1))

    @property
    def compiles(self) -> int:
        """Captures, kernel builds and loads observed in the scope."""
        return sum(self._delta(0).values()) + sum(self._delta(1).values())

    @property
    def traces(self) -> int:
        """Step-program captures observed in the scope."""
        return sum(self._delta(0).values())

    def cache_growth(self) -> dict[str, int]:
        """Per-watched-program capture growth since ``watch()``."""
        return {label: _capture_count(p) - self._watch_enter[label]
                for label, p in self._watch.items()}

    # --------------------------------------------------------- verdict
    def report(self) -> dict:
        """JSON-able telemetry row (``compiles`` per round)."""
        grown = {k: v for k, v in self.cache_growth().items() if v}
        return {"label": self.label, "compiles": self.compiles, "traces": self.traces,
                "cache_growth": grown, "captured": self.captured(), "built": self.built()}

    def assert_steady_state(self) -> None:
        """Raise ``TraceViolation`` unless the scope captured and built
        nothing; the message names each program or source whose count grew."""
        grown = {k: v for k, v in self.cache_growth().items() if v}
        if self.compiles == 0 and not grown:
            return
        names = "".join(f"; {what}: {d}" for what, d in
                        (("captured step programs", self.captured()),
                         ("grown watched programs", grown),
                         ("kernel libraries built or loaded", self.built())) if d)
        raise TraceViolation(
            f"TraceGuard[{self.label}]: {self.compiles} capture(s) or kernel build(s) in "
            f"a scope that promised steady state{names}. A shape or dtype changed "
            "between calls: fix the leak or warm the program up before entering the "
            "guard.")
