"""The port's public surface against the reference's, read from both source
trees with ``ast`` (nothing is imported).

For each module of ``src/repro`` that has a twin at the same path in
``src/repro_torch``, every public top-level name of the reference (a
function, class or assignment; in a package's ``__init__.py`` also what it
re-exports) and every public method of its public classes exists in the
port.  The port may provide a name by import, ``__all__`` or inheritance
from a class of the same module.  Every exception stands in ``NOT_PORTED``
with its reason: Pallas or JAX program plumbing that the port replaces, or
the ``ROADMAP.md`` §A item that ports it.  The same holds for whole modules
without a twin (``MODULES_NOT_PORTED``).  Both tables are checked in turn:
an entry the port has since gained, or one the reference does not have,
fails, so the tables stay exact.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent / "src"
REF, PORT = ROOT / "repro", ROOT / "repro_torch"

JAX_PLUMBING = "JAX program plumbing: the port's programs are core/step_graph.py's StepGraphs"
PALLAS = "the Pallas kernel; the port's kernel is CUDA under kernels/csrc/, its wrapper in ops.py"
NO_DONATION = ("no port program declares inputs it updates in place: a step program's body "
               "writes its own static buffers (core/step_graph.py), so there is no request "
               "to audit")

NOT_PORTED = {
    "core/engine.py": {
        "resolve_step_mode": "the step-mode policy lives in core/step_graph.py",
        "VectorizedClientEngine.scan_fn": JAX_PLUMBING,
    },
    "core/round_plan.py": {
        "FusedKDLocalProgram": JAX_PLUMBING + " (overlap='fused' is StepGraphs.pair)",
        "FusedKDLocalProgram.jit_programs": JAX_PLUMBING,
    },
    "analysis/__init__.py": {
        "duplicate_fusion_count": JAX_PLUMBING,
        "DonationReport": NO_DONATION, "donation_audit": NO_DONATION,
    },
    "analysis/passes.py": {
        "duplicate_fusion_count": JAX_PLUMBING + " (counts XLA's fusion bodies)",
        "DonationReport": NO_DONATION, "DonationReport.copied": NO_DONATION,
        "DonationReport.ok": NO_DONATION, "donation_audit": NO_DONATION,
    },
    "utils/hlo.py": {"TPUv5eSpec": "the TPU's constants; the port's card is H100Spec's"},
    "kernels/kd_loss/flash.py": {
        "DEFAULT_BB": "the Pallas kernels' row block",
        "flash_kd_fwd": PALLAS, "flash_kd_bwd": PALLAS,
        "flash_kd_head_fwd": PALLAS, "flash_kd_head_bwd": PALLAS,
    },
    "kernels/kd_loss/ops.py": {"pallas_active": "a probe of the Pallas dispatch"},
    "kernels/kd_loss/__init__.py": {"kernel": PALLAS},
    "kernels/weight_avg/__init__.py": {"kernel": PALLAS},
    "kernels/flash_attention/__init__.py": {"kernel": PALLAS},
}

MODULES_NOT_PORTED = {
    "kernels/flash_attention/kernel.py": PALLAS,
    "kernels/kd_loss/kernel.py": PALLAS,
    "kernels/weight_avg/kernel.py": PALLAS,
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _methods(cls: ast.ClassDef) -> set:
    return {f.name for f in cls.body
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(f.name)}


def _assigned(node) -> list:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def reference_names(path: Path) -> set:
    """The public names a reference module defines (and, for a package's
    ``__init__``, re-exports), methods as ``Class.method``."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if _public(node.name):
                out.add(node.name)
                if isinstance(node, ast.ClassDef):
                    out |= {f"{node.name}.{m}" for m in _methods(node)}
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out |= {a.asname or a.name for a in node.names if _public(a.asname or a.name)}
        else:
            out |= {n for n in _assigned(node) if _public(n)}
    return out


def port_names(path: Path) -> set:
    """What a port module offers: definitions, imports, ``__all__``, and
    each class's methods with those of its bases in the same module."""
    tree = ast.parse(path.read_text())
    out, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                classes[node.name] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        else:
            out |= set(_assigned(node))
            if "__all__" in _assigned(node):
                out |= set(ast.literal_eval(node.value))

    def methods(name: str) -> set:
        cls = classes[name]
        own = _methods(cls)
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes:
                own |= methods(base.id)
        return own

    for name in classes:
        out |= {f"{name}.{m}" for m in methods(name)}
    return out


TWINS = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
               if (PORT / p.relative_to(REF)).exists())


@pytest.mark.parametrize("rel", TWINS)
def test_port_module_has_the_reference_names(rel):
    ref, port = reference_names(REF / rel), port_names(PORT / rel)
    exempt = NOT_PORTED.get(rel, {})
    missing = sorted(ref - port - set(exempt))
    assert not missing, f"{rel}: the port lacks {missing} (port them or add them to NOT_PORTED)"
    stale = sorted(n for n in exempt if n in port or n not in ref)
    assert not stale, f"{rel}: NOT_PORTED lists {stale}, which the port has or the reference lacks"
    assert all(reason.strip() for reason in exempt.values())


def test_modules_without_a_twin_are_listed():
    untwinned = {str(p.relative_to(REF)) for p in REF.rglob("*.py")
                 if not (PORT / p.relative_to(REF)).exists()}
    assert untwinned == set(MODULES_NOT_PORTED)
    assert set(NOT_PORTED) <= set(TWINS)
    assert all(reason.strip() for reason in MODULES_NOT_PORTED.values())
