"""Program-contract analyzer (port of ``repro.analysis``): mechanical proofs
for the claims the CHANGES log states in prose.

FedSDD's headline scalability, server cost decoupled from the client count,
survives only while three invariants hold on the hot paths: no
steady-state recompilation (for the port: no step-program capture and no
kernel build), no implicit device→host sync inside round execution, and
bounded live-intermediate memory.  One stray ``float(loss)`` or a
shape-driven capture silently reverts the server to FedDF-style
per-client cost.  This package turns those invariants into contracts:

``trace_guard.TraceGuard``
    counts step-program captures and kernel builds over a scope, and each
    watched program's own captures: rounds 2..N must build nothing.
``sync.sync_contract`` / ``sync.allowed_sync``
    a scope that turns every implicit device→host sync into an error: the
    card's sync debug mode plus a portable funnel over ``torch.Tensor``'s
    materialisations that also fires on the CPU.  The few legitimate syncs
    are annotated in place with ``allowed_sync("reason")``.
``passes``
    walks of ``torch.fx`` programs: live intermediates (memory bounds) and
    dtype drift (a bf16 teacher cache silently upcast to f32); and
    ``collective_stats``, the bytes each collective kind moves in a scope
    (the teacher all-reduce's must not grow with the client count).
``lint``
    the repo's AST linter (``python -m repro_torch.analysis.lint
    src/repro_torch``).

Contract tests live in ``tests/test_torch_analysis.py``; ``chip_smoke.py``
holds the contracts around a steady-state round or decode chunk on a card.
"""
from repro_torch.analysis.passes import (  # noqa: F401
    COLLECTIVE_KINDS,
    CollectiveStats,
    DtypeDrift,
    collective_stats,
    dtype_drift,
    live_intermediate_shapes,
    live_intermediates,
    max_live_intermediate_bytes,
    trace_program,
)
from repro_torch.analysis.sync import (  # noqa: F401
    SyncViolation,
    allowed_sync,
    sync_contract,
)
from repro_torch.analysis.trace_guard import (  # noqa: F401
    TraceGuard,
    TraceViolation,
)
