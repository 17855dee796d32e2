"""Repo-specific AST linter (port of ``repro/analysis/lint.py``, with the
port's own copy of the rules: it imports nothing of the JAX package).

Rules (``python -m repro_torch.analysis.lint src/repro_torch``):

RA101  device→host sync in a HOT module outside an
       ``allowed_sync("reason")`` scope: ``float()/int()/bool()`` on a
       tensor computation, ``.item()``, ``.tolist()``, ``.cpu()``,
       ``.numpy()``, ``.to("cpu")``, ``np.asarray``/``np.array`` of a
       non-literal, ``torch.cuda.synchronize()`` (and the reference's
       ``jax.device_get``).  The static half of the sync contract.
RA201  bare ``assert`` outside ``kernels/``/``models/``: asserts vanish
       under ``python -O``; configuration is checked with ``ValueError``.
RA301  global-state draw: ``np.random.*`` (anything but ``default_rng``/
       ``SeedSequence``/``Generator``), a seedless ``default_rng()``,
       ``torch.manual_seed``, or a ``torch.rand*``/``randn``/``randint``/
       ``randperm``/``normal``/``bernoulli``/``multinomial`` draw without
       ``generator=``: every stream is derived from an explicit seed.
RA302  ``time.time()`` in a hot module: timing is
       ``time.perf_counter()``; calendar time is a determinism leak.
RA401  ``np.random.default_rng`` in ``core/faults.py`` outside the keyed
       ``client_faults`` helper: every fault decision must be a pure
       function of ``(seed, round, cid)`` or replay breaks.

Suppression: a trailing ``# lint-ok: RA101 <reason>`` comment exempts its
line (reason mandatory); RA101 is also exempt anywhere lexically inside a
``with allowed_sync("...")`` block, so runtime annotation and static
exemption are the same act.
"""
from __future__ import annotations

import ast
import re
import sys
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Finding", "lint_source", "lint_paths", "main"]

# modules on the round/serve hot path: a stray sync here is a stall per
# client (or per request), not a one-off
HOT_MODULES = (
    "core/engine.py",
    "core/round_plan.py",
    "core/robust_agg.py",
    "core/fedsdd.py",
    "core/aggregation.py",
    "core/faults.py",
    "distill/pipeline.py",
    "distill/teacher_bank.py",
    "serve/engine.py",
)

# directories whose asserts are shape checks on static values
ASSERT_EXEMPT_DIRS = ("kernels/", "models/")

SYNC_CALLS = {"float", "int", "bool"}
SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
SYNC_NP = {"asarray", "array"}
GLOBAL_NP_RANDOM_OK = {"default_rng", "SeedSequence", "Generator",
                       "BitGenerator", "PCG64", "Philox"}
# torch draws that take the global generator unless given ``generator=``
TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
               "randperm", "normal", "bernoulli", "multinomial"}
TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                      "torch.cuda.manual_seed_all"}
# host-producing callees whose result float()/int() may always wrap
HOST_PRODUCERS = {"len", "round", "min", "max", "sum", "abs", "ord",
                  "perf_counter", "time", "getattr"}

_PRAGMA_RE = re.compile(r"#\s*lint-ok:\s*(RA\d+)\s+(\S.*)$")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _pragmas(source: str) -> dict[int, str]:
    """line -> rule exempted by a ``# lint-ok: RAxxx reason`` comment."""
    out: dict[int, str] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            out[i] = m.group(1)
    return out


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('np.asarray', 'x.item')."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_constantish(node: ast.AST) -> bool:
    """Arguments that cannot be device values: literals, literal
    containers, comprehensions over host iterables, f-strings."""
    if isinstance(node, (ast.Constant, ast.JoinedStr, ast.ListComp,
                         ast.SetComp, ast.DictComp, ast.GeneratorExp,
                         ast.List, ast.Tuple, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.UnaryOp):
        return _is_constantish(node.operand)
    if isinstance(node, ast.Call):
        callee = _dotted(node.func)
        return callee.split(".")[-1] in HOST_PRODUCERS
    return False


# roots of a device computation: the port's torch and, so that both linters
# agree on the reference's sources, JAX's
DEVICE_ROOTS = {"torch", "F", "jnp", "jax", "lax"}


def _has_device_call(node: ast.AST) -> bool:
    """True when the expression syntactically computes on the device: any
    call rooted at torch (or jnp/jax/lax) or a ``tree_*`` pytree helper."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        dotted = _dotted(sub.func)
        root = dotted.split(".")[0]
        if root in DEVICE_ROOTS or dotted.split(".")[-1].startswith("tree_"):
            return True
    return False


def _to_host(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    args = list(node.args) + [k.value for k in node.keywords if k.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu" for a in args)


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, *, hot: bool,
                 assert_exempt: bool, faults_module: bool) -> None:
        self.path = path
        self.hot = hot
        self.assert_exempt = assert_exempt
        self.faults_module = faults_module
        self.pragmas = _pragmas(source)
        self.findings: list[Finding] = []
        self._allowed_sync_depth = 0
        self._func_stack: list[str] = []

    # ------------------------------------------------------------ utils
    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if self.pragmas.get(line) == rule:
            return
        self.findings.append(Finding(self.path, line, rule, message))

    # ------------------------------------------------------- structure
    def visit_With(self, node: ast.With) -> None:
        opens_allowed = any(
            isinstance(item.context_expr, ast.Call)
            and _dotted(item.context_expr.func).split(".")[-1] == "allowed_sync"
            for item in node.items)
        if opens_allowed:
            self._allowed_sync_depth += 1
        self.generic_visit(node)
        if opens_allowed:
            self._allowed_sync_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    # ----------------------------------------------------------- rules
    def visit_Assert(self, node: ast.Assert) -> None:
        if not self.assert_exempt:
            self._emit(node, "RA201",
                       "bare assert in library code: raise ValueError "
                       "(config) or RuntimeError (invariant); asserts "
                       "vanish under python -O")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        callee = _dotted(node.func)
        leaf = callee.split(".")[-1]
        self._check_sync(node, callee, leaf)
        self._check_random(node, callee, leaf)
        self.generic_visit(node)

    def _check_sync(self, node: ast.Call, callee: str, leaf: str) -> None:
        if not self.hot or self._allowed_sync_depth:
            return
        if leaf in SYNC_CALLS and callee == leaf:
            if len(node.args) == 1 and _has_device_call(node.args[0]):
                self._emit(node, "RA101",
                           f"{leaf}() on a device computation in a hot "
                           "module: a hidden host sync; wrap in "
                           "allowed_sync(\"reason\") or keep it on device")
        elif isinstance(node.func, ast.Attribute) and (
                node.func.attr in SYNC_ATTRS
                or (node.func.attr == "to" and _to_host(node))):
            self._emit(node, "RA101",
                       f".{node.func.attr}() in a hot module: a hidden "
                       "host sync; wrap in allowed_sync(\"reason\")")
        elif callee in ("np.asarray", "np.array", "numpy.asarray", "numpy.array"):
            if node.args and _is_constantish(node.args[0]):
                return
            self._emit(node, "RA101",
                       f"{callee}() in a hot module materializes a tensor "
                       "on the host; wrap in allowed_sync(\"reason\") or "
                       "mark the host-only value with a lint-ok pragma")
        elif callee == "torch.cuda.synchronize":
            self._emit(node, "RA101",
                       "torch.cuda.synchronize() in a hot module: the host "
                       "waits for the card; wrap in allowed_sync(\"reason\")")
        elif leaf == "device_get":
            self._emit(node, "RA101",
                       "device_get in a hot module: a host sync; wrap in "
                       "allowed_sync(\"reason\")")

    def _check_random(self, node: ast.Call, callee: str, leaf: str) -> None:
        if callee.startswith(("np.random.", "numpy.random.")):
            if leaf not in GLOBAL_NP_RANDOM_OK:
                self._emit(node, "RA301",
                           f"global-state np.random.{leaf}(): derive a "
                           "Generator from an explicit seed instead")
            elif leaf == "default_rng" and not node.args:
                self._emit(node, "RA301",
                           "seedless default_rng(): OS entropy breaks "
                           "replay; pass the run's seed")
            if (leaf == "default_rng" and self.faults_module
                    and "client_faults" not in self._func_stack):
                self._emit(node, "RA401",
                           "fault rng outside the keyed client_faults "
                           "helper: every fault decision must be a pure "
                           "function of (seed, round, cid)")
        elif callee in TORCH_GLOBAL_SEEDS:
            self._emit(node, "RA301",
                       f"{callee}() seeds the global generator: pass a "
                       "torch.Generator seeded from the run's seed")
        elif (callee == f"torch.{leaf}" and leaf in TORCH_DRAWS
              and not any(k.arg == "generator" for k in node.keywords)):
            self._emit(node, "RA301",
                       f"torch.{leaf}() without generator= draws from the "
                       "global generator; pass one seeded from the run's seed")
        elif callee in ("time.time", "time.time_ns") and self.hot:
            self._emit(node, "RA302",
                       f"{callee}() in a hot module: use "
                       "time.perf_counter() (monotonic) for timing; "
                       "calendar time is a determinism leak")


def lint_source(source: str, path: str) -> list[Finding]:
    """Lint one module's source; ``path`` selects the rule profile."""
    norm = path.replace("\\", "/")
    hot = any(norm.endswith(m) for m in HOT_MODULES)
    assert_exempt = any(f"/{d}" in norm or norm.startswith(d)
                        for d in ASSERT_EXEMPT_DIRS)
    faults = norm.endswith("core/faults.py")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "RA000", f"syntax error: {e.msg}")]
    linter = _Linter(path, source, hot=hot, assert_exempt=assert_exempt,
                     faults_module=faults)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.line, f.rule))


def lint_paths(paths: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    for root in paths:
        p = Path(root)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_source(f.read_text(), str(f)))
    return findings


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("usage: python -m repro_torch.analysis.lint <path> [path ...]")
        return 0 if argv else 2
    findings = lint_paths(argv)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} finding(s)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
