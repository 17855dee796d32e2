"""Invariant passes over traced programs (port of
``repro/analysis/passes.py``).

A program here is a ``torch.fx`` graph from ``make_fx(fn,
tracing_mode="fake")`` (``trace_program``): the operators PyTorch runs,
forward and, where ``fn`` calls ``backward`` or ``torch.autograd.grad``,
backward, on fake tensors (nothing is allocated).  Dead code is eliminated
first, so the nodes left are what a run executes: the counterpart of the
reference's DCE-aware jaxpr walk.

``live_intermediates`` / ``live_intermediate_shapes`` /
``max_live_intermediate_bytes``
    every operator output that owns new memory (views are not counted),
    for "never materialises X" claims: the head-fused Flash-KD loss never
    forms the (B, V) student row.
``dtype_drift``
    live ``aten._to_copy`` / ``aten.to`` nodes lifting a narrow dtype to a
    wide one above an element-count threshold: the regression it exists
    for is the bf16 teacher cache silently upcast to f32 in the KD
    program, doubling the O(server-set) cache residency.  Small per-tile
    upcasts sit below the threshold and stay legal.
``collective_stats``
    the bytes each collective kind moves in a scope, as the collectives
    are issued (``launch/mesh.py``'s all-gather and all-reduce), where the
    reference scans a compiled module's HLO: FedSDD's scalability claim
    is that the cross-group bytes (the teacher all-reduce) do not grow
    with the number of clients or teachers.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

__all__ = ["trace_program", "live_intermediates", "live_intermediate_shapes",
           "max_live_intermediate_bytes", "DtypeDrift", "dtype_drift", "COLLECTIVE_KINDS",
           "CollectiveStats", "collective_stats", "record_collective"]

# XLA's names for the collectives, which the port's records use too
COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast",
)

_CASTS = ("aten._to_copy", "aten.to", "prims.convert_element_type")


def trace_program(fn: Callable, *args: Any) -> torch.fx.GraphModule:
    """``fn(*args)`` traced on fake tensors into an fx graph, dead code
    eliminated: the program the passes below walk."""
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(fn, tracing_mode="fake")(*args)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm


def _graphs(program) -> list:
    """The graph of ``program`` (a GraphModule or a Graph) and those of the
    GraphModules it holds (the bodies of higher-order operators)."""
    if isinstance(program, torch.fx.Graph):
        return [program]
    out = [program.graph]
    for sub in program.children():
        if isinstance(sub, torch.fx.GraphModule):
            out += _graphs(sub)
    return out


def _is_view(target) -> bool:
    schema = getattr(target, "_schema", None)
    return schema is not None and any(r.alias_info is not None for r in schema.returns)


def _op_name(target) -> str:
    name = getattr(target, "_schema", None)
    return str(name.name).replace("::", ".") if name is not None else str(target)


def _walk(program, visit) -> None:
    """Call ``visit(node, out)`` for every live operator output ``out`` (a
    fake tensor) that owns new memory: views of other tensors are skipped."""
    for graph in _graphs(program):
        for node in graph.nodes:
            if node.op != "call_function" or _is_view(node.target):
                continue
            val = node.meta.get("val")
            for out in (val if isinstance(val, (list, tuple)) else [val]):
                if isinstance(out, torch.Tensor):
                    visit(node, out)


def live_intermediates(program) -> list:
    """Every live intermediate as ``(shape, dtype)`` tuples (with
    duplicates: one entry per operator output that owns its buffer)."""
    out = []
    _walk(program, lambda node, t: out.append((tuple(t.shape), t.dtype)))
    return out


def live_intermediate_shapes(program) -> set:
    """Every live intermediate (operator output) shape in a program."""
    return {shape for shape, _ in live_intermediates(program)}


def max_live_intermediate_bytes(program) -> int:
    """Size of the single largest live intermediate buffer: a lower bound
    on peak memory and the gate for "never materialises X" claims."""
    best = 0
    for shape, dtype in live_intermediates(program):
        n = 1
        for d in shape:
            n *= int(d)
        best = max(best, n * dtype.itemsize)
    return best


@dataclass(frozen=True)
class DtypeDrift:
    """One wide upcast: a live cast node above threshold."""
    shape: tuple
    src: str
    dst: str

    @property
    def elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


def _dtype(d) -> torch.dtype:
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def dtype_drift(program, src="bfloat16", dst="float32",
                min_elements: int = 1 << 20) -> list:
    """Live cast nodes lifting ``src``→``dst`` whose output holds at least
    ``min_elements`` elements.

    The default threshold (1 Mi elements) is far above any per-tile or
    per-batch boundary cast and far below a full compressed teacher cache,
    so hits mean exactly the regression the pass exists for: a cache-width
    tensor silently living at double width.
    """
    src_dt, dst_dt = _dtype(src), _dtype(dst)
    hits = []

    def visit(node, out):
        if not _op_name(node.target).startswith(_CASTS):
            return
        inp = node.args[0].meta.get("val") if node.args else None
        if not isinstance(inp, torch.Tensor) or inp.dtype != src_dt or out.dtype != dst_dt:
            return
        drift = DtypeDrift(tuple(out.shape), str(src_dt).removeprefix("torch."),
                           str(dst_dt).removeprefix("torch."))
        if drift.elements >= min_elements:
            hits.append(drift)

    _walk(program, visit)
    return hits


@dataclass
class CollectiveStats:
    """Bytes moved by each collective kind in one scope."""
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def summary(self) -> str:
        parts = [
            f"{k}: {self.count_by_kind[k]} ops, "
            f"{self.bytes_by_kind[k] / 1e9:.4f} GB"
            for k in sorted(self.bytes_by_kind)
        ]
        return "; ".join(parts) if parts else "(no collectives)"


_ACTIVE: list[CollectiveStats] = []      # the open collective_stats scopes


@contextmanager
def collective_stats() -> Iterator[CollectiveStats]:
    """A scope whose collectives are counted: every collective the port
    issues inside it (``launch/mesh.py``) adds its kind and its bytes to
    the yielded ``CollectiveStats``.  Bytes follow the reference's
    result-shape convention (the gathered tensor of an all-gather, the
    reduced one of an all-reduce), counted from shapes: no host sync.  A
    one-rank mesh with no process group issues no collective, so it
    counts none.  Scopes nest; each counts what its body issued."""
    stats = CollectiveStats()
    _ACTIVE.append(stats)
    try:
        yield stats
    finally:
        _ACTIVE.remove(stats)


def record_collective(kind: str, nbytes: int) -> None:
    """One collective of ``kind`` whose result holds ``nbytes``, issued just
    now: counted in every open ``collective_stats`` scope."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"collective kind {kind!r} not in {COLLECTIVE_KINDS}")
    for stats in _ACTIVE:
        stats.add(kind, int(nbytes))
