"""repro-lint for the PyTorch port: an AST linter with the repository's
rules, re-targeted at torch (counterpart of ``repro/analysis/lint.py``).

The reference's jit-traced bodies become the port's CUDA-graph captures:
a ``with torch.cuda.graph(...)`` block runs its Python once, at capture,
and every replay repeats the recorded kernels without it.  A host sync in
there fails the capture (or records a stale value), an env read is baked
into the graph, and a branch on a tensor is taken once for every replay.

Rules (each finding carries file:line:col, a rule id and a fix hint):

* **RPR001** — deprecated pre-engine entry points (``fleet_fit``,
  ``sharded_fleet_fit``, ``federated_fit``, ``fit_on_mesh``) called
  anywhere outside their deprecation shims.  New code goes through
  ``repro_torch.engine.DAEFEngine`` / ``ExecutionPlan``.
* **RPR002** — ``os.environ`` / ``os.getenv`` read lexically inside a
  ``with torch.cuda.graph(...)`` block (the value is baked into the
  captured graph and every replay keeps it), or at import time of a
  library module (the process can never flip it again).  Resolve at call
  time, before the capture — the ``DAEFConfig.stats_backend`` /
  ``resolved()`` idiom.
* **RPR003** — a host sync on a tensor inside a capture block:
  ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, ``float/int/bool``
  of a tensor-valued expression, or a host ``np.*`` call on one.  A sync
  is illegal while a graph captures; keep the host step out of the block.
* **RPR004** — Python ``if``/``while`` on a tensor-valued expression
  inside a capture block: the branch is taken once, at capture, for every
  replay.  Branch with ``torch.where`` or decide before the capture.
  Static attributes (``.shape``/``.ndim``/``.dtype``/``.device``, ``len()``,
  ``isinstance()`` ...) are recognised and allowed.
* **RPR005** — blanket ``warnings.filterwarnings("ignore")`` /
  ``warnings.simplefilter("ignore")`` without a ``message=``/
  ``category=``/``module=`` filter: swallows every future warning in the
  process.
* **RPR006** — ``time.time()``/``time.perf_counter()`` or the stdlib
  ``random`` module in library code (``src/repro_torch`` outside
  ``launch/``): library results must be deterministic; wall-clock and
  host RNG belong in drivers and benchmarks.
* **RPR007** — a literal seed in privacy code (``src/repro_torch/privacy/``):
  ``torch.manual_seed(<literal>)``, ``Generator.manual_seed(<literal>)``, a
  literal threefry key (``threefry.PRNGKey(<literal>)``), or the stdlib
  ``random`` module.  A hard-coded seed makes every DP noise draw
  predictable and reused across releases; release keys derive per (site,
  round) from the config seed (``fold_in``, the
  ``FederationSession._dp_key`` idiom) and are passed in.

The reference's RPR008 (a hard-coded Pallas ``interpret=True``) has no
torch meaning and is not ported: the port's kernels pick their host or
card version by the tensors' device.

A tensor-valued expression is one that reads a parameter of the enclosing
function (other than ``self``/``cls``), a ``torch.*`` result, or a name
assigned from one (two forward passes over the function body, as the
reference's taint walk).

Escapes, shared with the reference's linter so one comment serves both:
append ``# repro-lint: disable=RPR001`` (comma-separate several ids) to a
line to suppress findings on it, or grandfather existing findings in a
baseline file of ``path RULE count`` lines (see ``--write-baseline``).  A
file whose first lines contain ``# repro-lint: library`` opts into the
library-scoped rules regardless of its path; ``# repro-lint: privacy``
does the same for the privacy-scoped rule.

CLI::

    python -m repro_torch.analysis [lint] [--baseline FILE] [--write-baseline FILE] paths...

Directories are walked recursively for ``*.py``, skipping the linters'
fixture directories and hidden dirs; explicitly named files are always
linted.  Exit code 1 iff findings remain after disables and baseline
subtraction.
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

DEPRECATED_ENTRY_POINTS = {
    "fleet_fit": "DAEFEngine(config, ExecutionPlan(mode='vmap', tenants=k)).fit",
    "sharded_fleet_fit": "DAEFEngine(config, ExecutionPlan(mode='mesh', tenants=k)).fit",
    "federated_fit": "DAEFEngine(config, plan).session().round(parts)",
    "fit_on_mesh": "DAEFEngine(config, ExecutionPlan(mode='mesh', mesh_axes=...)).fit",
}

#: Attributes and methods of a tensor whose value is static (python-level
#: metadata): reading them never syncs with the card.
STATIC_TENSOR_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                       "requires_grad", "size", "numel", "dim", "stride",
                       "element_size", "is_contiguous", "data_ptr"}
#: Builtins whose result on a tensor is static.
STATIC_CALLS = {"len", "isinstance", "type", "id", "repr", "str", "hash"}
#: Tensor methods that copy to the host and wait for the card.
HOST_SYNC_METHODS = {"item", "cpu", "numpy", "tolist"}
#: Builtins that turn a one-element tensor into a Python scalar (a sync).
HOST_SYNC_BUILTINS = {"float", "int", "bool"}

DISABLE_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Z0-9,\s]+)")
LIBRARY_MARK_RE = re.compile(r"#\s*repro-lint:\s*library\b")
PRIVACY_MARK_RE = re.compile(r"#\s*repro-lint:\s*privacy\b")

RULES = {
    "RPR001": "deprecated pre-engine entry point",
    "RPR002": "env read at import/capture time",
    "RPR003": "host sync on a tensor in a CUDA-graph capture",
    "RPR004": "python control flow on a tensor in a CUDA-graph capture",
    "RPR005": "blanket warnings filter",
    "RPR006": "wall-clock/stdlib random in library code",
    "RPR007": "literal seed / host randomness in privacy code",
}


@dataclass(frozen=True)
class Finding:
    """One lint finding: location, rule id, message and a fix hint."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    hint: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message} (hint: {self.hint})")


# ---------------------------------------------------------------------------
# Helpers: name resolution on the AST
# ---------------------------------------------------------------------------

def _dotted(node: ast.expr) -> str | None:
    """'a.b.c' for nested Attribute/Name chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Imports(ast.NodeVisitor):
    """Track what local names the interesting modules are bound to."""

    def __init__(self) -> None:
        self.numpy: set[str] = set()        # `import numpy as np` -> {"np"}
        self.torch: set[str] = set()        # `import torch` -> {"torch"}
        self.graph_names: set[str] = set()  # `from torch.cuda import graph`
        self.stdlib_random = False          # `import random`
        self.stdlib_time: set[str] = set()  # names bound to stdlib time

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            bound = alias.asname or alias.name.split(".")[0]
            if alias.name == "numpy" or alias.name.startswith("numpy."):
                self.numpy.add(bound)
            if alias.name == "torch" or (alias.name.startswith("torch.") and not alias.asname):
                self.torch.add(bound)
            if alias.name == "random":
                self.stdlib_random = True
            if alias.name == "time":
                self.stdlib_time.add(bound)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "torch.cuda":
            for alias in node.names:
                if alias.name == "graph":
                    self.graph_names.add(alias.asname or "graph")

    def is_capture(self, node: ast.expr) -> bool:
        """Is ``node`` a ``torch.cuda.graph(...)`` context manager?"""
        if not isinstance(node, ast.Call):
            return False
        name = _dotted(node.func)
        return name in self.graph_names or name in {f"{t}.cuda.graph" for t in self.torch}


def _param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)] + (
        [a.vararg.arg] if a.vararg else []
    ) + ([a.kwarg.arg] if a.kwarg else [])


# ---------------------------------------------------------------------------
# Taint: which names (can) hold tensors around a capture block
# ---------------------------------------------------------------------------

class _TaintWalker:
    """Forward-propagates "tensor-valued" through the assignments of a
    function body (or a module).  Two passes so names assigned late but
    used early in loops still taint."""

    def __init__(self, tainted: set[str]):
        self.tainted = set(tainted)

    def references_tainted(self, node: ast.expr) -> bool:
        """Does ``node`` read a tainted name *as a tensor value*?  Static
        attributes (``x.shape`` ...) and ``len(x)``/``isinstance(x, ...)``
        are skipped."""
        return self._walk(node)

    def _walk(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in STATIC_TENSOR_ATTRS:
            return False
        if isinstance(node, ast.Call):
            callee = _dotted(node.func)
            if callee in STATIC_CALLS:
                return False
        if isinstance(node, ast.Name):
            return isinstance(node.ctx, ast.Load) and node.id in self.tainted
        return any(self._walk(child) for child in ast.iter_child_nodes(node))

    def _taint_target(self, target: ast.expr) -> None:
        """Taint the names a target binds; ``obj.attr = t`` and
        ``obj[i] = t`` bind no name (``self`` stays untainted)."""
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._taint_target(elt)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value)

    def propagate(self, body: list[ast.stmt]) -> None:
        for _ in range(2):
            for stmt in body:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Assign):
                        if self._walk(node.value):
                            for t in node.targets:
                                self._taint_target(t)
                    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                        if node.value is not None and self._walk(node.value):
                            self._taint_target(node.target)
                    elif isinstance(node, ast.For):
                        if self._walk(node.iter):
                            self._taint_target(node.target)
                    elif isinstance(node, ast.withitem):
                        if node.optional_vars is not None and \
                                self._walk(node.context_expr):
                            self._taint_target(node.optional_vars)


# ---------------------------------------------------------------------------
# The per-file checker
# ---------------------------------------------------------------------------

class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, source: str, *, library: bool,
                 privacy: bool = False):
        self.path = path
        self.library = library
        self.privacy = privacy
        self.findings: list[Finding] = []
        self.imports = _Imports()
        self._scopes: list[ast.AST] = []          # enclosing functions (or the module)
        self._capture_stack: list[_TaintWalker] = []
        self._disables: dict[int, set[str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = DISABLE_RE.search(line)
            if m:
                self._disables[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }

    # -- plumbing ----------------------------------------------------------

    def add(self, node: ast.AST, rule: str, message: str, hint: str) -> None:
        line = getattr(node, "lineno", 0)
        if rule in self._disables.get(line, ()):
            return
        self.findings.append(Finding(
            path=self.path, line=line, col=getattr(node, "col_offset", 0) + 1,
            rule=rule, message=message, hint=hint,
        ))

    @property
    def _taint(self) -> _TaintWalker | None:
        return self._capture_stack[-1] if self._capture_stack else None

    def _at_module_level(self) -> bool:
        return len(self._scopes) == 1

    def visit_Module(self, node: ast.Module) -> None:
        self._scopes.append(node)
        self.generic_visit(node)
        self._scopes.pop()

    # -- imports -----------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        self.imports.visit_Import(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        self.imports.visit_ImportFrom(node)

    # -- function scoping / capture detection ------------------------------

    def _visit_fn(self, node: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        self._scopes.append(node)
        self.generic_visit(node)
        self._scopes.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _scope_walker(self) -> _TaintWalker:
        """The tensor-valued names of the innermost function (or module)."""
        scope = self._scopes[-1]
        params = set(_param_names(scope)) - {"self", "cls"} \
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)) else set()
        walker = _TaintWalker(params | self.imports.torch)
        walker.propagate(scope.body)
        return walker

    def _visit_with(self, node: ast.With | ast.AsyncWith) -> None:
        for item in node.items:
            self.visit(item)
        capture = any(self.imports.is_capture(item.context_expr) for item in node.items)
        if capture:
            self._capture_stack.append(self._scope_walker())
        for stmt in node.body:
            self.visit(stmt)
        if capture:
            self._capture_stack.pop()

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    # -- RPR002: env reads -------------------------------------------------

    def _check_env_read(self, node: ast.AST, what: str) -> None:
        if self._capture_stack:
            self.add(
                node, "RPR002",
                f"{what} inside a CUDA-graph capture: the value is baked into "
                "the graph and every replay keeps it when the env flips",
                "resolve before the capture and pass the value in (the "
                "stats_backend resolved() idiom)",
            )
        elif self.library and self._at_module_level():
            self.add(
                node, "RPR002",
                f"{what} at import time of a library module: the process "
                "can never flip it again (tests/serving cannot override "
                "per-call)",
                "move the read into the function that consumes it, "
                "resolved at call time",
            )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if _dotted(node) == "os.environ":
            self._check_env_read(node, "os.environ read")
        self.generic_visit(node)

    # -- calls: RPR001 / RPR002(getenv) / RPR003 / RPR005 / RPR006 / RPR007

    def _check_host_sync(self, node: ast.Call, callee: str) -> None:
        taint = self._taint
        if taint is None:
            return
        sync = None
        if isinstance(node.func, ast.Attribute) and node.func.attr in HOST_SYNC_METHODS:
            sync = f".{node.func.attr}()"
        elif callee in HOST_SYNC_BUILTINS and node.args and \
                taint.references_tainted(node.args[0]):
            sync = f"{callee}() of a tensor"
        else:
            root = callee.split(".", 1)[0]
            if root in self.imports.numpy and callee != root and (
                    any(taint.references_tainted(a) for a in node.args)
                    or any(taint.references_tainted(kw.value) for kw in node.keywords)):
                sync = f"host {callee}() on a tensor"
        if sync is not None:
            self.add(
                node, "RPR003",
                f"{sync} inside a CUDA-graph capture: a host sync is illegal "
                "while a graph captures (or records a stale value)",
                "keep the host step outside the capture block; read the "
                "graph's output buffers after a replay",
            )

    def visit_Call(self, node: ast.Call) -> None:
        callee = _dotted(node.func) or ""
        leaf = callee.rsplit(".", 1)[-1] if callee else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")

        if leaf in DEPRECATED_ENTRY_POINTS:
            self.add(
                node, "RPR001",
                f"deprecated pre-engine entry point {leaf}() — placement is "
                "an ExecutionPlan field, not a module choice",
                f"use {DEPRECATED_ENTRY_POINTS[leaf]}",
            )

        if callee == "os.getenv":
            self._check_env_read(node, "os.getenv()")

        self._check_host_sync(node, callee)

        if callee in ("warnings.filterwarnings", "warnings.simplefilter"):
            action = node.args[0].value if node.args and isinstance(
                node.args[0], ast.Constant) else next(
                (kw.value.value for kw in node.keywords
                 if kw.arg == "action" and isinstance(kw.value, ast.Constant)),
                None,
            )
            narrowing = {kw.arg for kw in node.keywords} & \
                {"message", "category", "module"}
            if callee == "warnings.simplefilter" and len(node.args) > 1:
                narrowing.add("category")
            if action == "ignore" and not narrowing:
                self.add(
                    node, "RPR005",
                    "blanket warnings ignore without a message/category/"
                    "module filter swallows every future diagnostic in the "
                    "process",
                    "narrow with message=... / category=...",
                )

        if self.library:
            if callee in ("time.time", "time.perf_counter", "time.monotonic") \
                    and callee.split(".", 1)[0] in self.imports.stdlib_time:
                self.add(
                    node, "RPR006",
                    f"{callee}() in library code: wall-clock makes library "
                    "results nondeterministic",
                    "time in drivers/benchmarks; pass timestamps in as data",
                )
            if self.imports.stdlib_random and callee.startswith("random."):
                self.add(
                    node, "RPR006",
                    f"stdlib {callee}() in library code: unseeded host RNG "
                    "breaks reproducibility",
                    "use core.threefry with an explicit key or a seeded "
                    "torch.Generator (numpy default_rng in drivers)",
                )

        if self.privacy:
            literal = bool(node.args) and isinstance(node.args[0], ast.Constant)
            if leaf in ("manual_seed", "PRNGKey") and literal:
                self.add(
                    node, "RPR007",
                    f"hard-coded {callee or leaf}({node.args[0].value!r}) in "
                    "privacy code: a fixed seed makes every DP noise draw "
                    "predictable and REUSED across releases",
                    "derive the release key per (site, round) from the "
                    "config seed via threefry.fold_in and pass it in "
                    "(FederationSession._dp_key)",
                )
            if self.imports.stdlib_random and callee.startswith("random."):
                self.add(
                    node, "RPR007",
                    f"stdlib {callee}() in privacy code: host RNG is "
                    "unauditable — noise calibration cannot be verified or "
                    "reproduced",
                    "draw noise from core.threefry with a keyed, per-release "
                    "key (or a hash-seeded numpy Generator for secagg masks)",
                )
        self.generic_visit(node)

    # -- RPR004: control flow on tensors -----------------------------------

    def _check_branch(self, node: ast.If | ast.While, kind: str) -> None:
        if self._taint is not None and \
                self._taint.references_tainted(node.test):
            self.add(
                node, "RPR004",
                f"python `{kind}` on a tensor-valued expression inside a "
                "CUDA-graph capture: the branch is taken once, at capture, "
                "for every replay",
                "use torch.where, or decide before the capture and capture "
                "one graph per case",
            )
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, "if")

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, "while")


# ---------------------------------------------------------------------------
# File / path drivers
# ---------------------------------------------------------------------------

def _port_subpath(path: Path) -> tuple[str, ...] | None:
    parts = path.resolve().parts
    if "repro_torch" in parts and "src" in parts:
        return parts[parts.index("repro_torch") + 1:]
    return None


def _is_library_path(path: Path) -> bool:
    sub = _port_subpath(path)
    return bool(sub) and sub[0] != "launch"


def _is_privacy_path(path: Path) -> bool:
    sub = _port_subpath(path)
    return bool(sub) and sub[0] == "privacy"


def check_source(source: str, path: str = "<string>",
                 *, library: bool | None = None,
                 privacy: bool | None = None) -> list[Finding]:
    """Lint one source string; ``library``/``privacy`` force the scoped
    rules on or off (default: from the path / the ``# repro-lint:
    library`` / ``# repro-lint: privacy`` marks)."""
    head = "\n".join(source.splitlines()[:10])
    if library is None:
        library = bool(LIBRARY_MARK_RE.search(head)) or \
            _is_library_path(Path(path))
    if privacy is None:
        privacy = bool(PRIVACY_MARK_RE.search(head)) or \
            _is_privacy_path(Path(path))
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path=path, line=e.lineno or 0, col=e.offset or 0,
                        rule="RPR000", message=f"syntax error: {e.msg}",
                        hint="fix the file before linting")]
    checker = _Checker(path, source, library=library, privacy=privacy)
    checker.visit(tree)
    return sorted(checker.findings, key=lambda f: (f.line, f.col, f.rule))


def check_path(path: str | Path, *, library: bool | None = None,
               privacy: bool | None = None) -> list[Finding]:
    """Lint one file on disk."""
    p = Path(path)
    return check_source(p.read_text(), str(p), library=library,
                        privacy=privacy)


SKIP_DIRS = {"lint_fixtures", "torch_lint_fixtures", "__pycache__", ".git",
             ".ruff_cache", "node_modules", ".venv"}


def collect_files(paths: list[str]) -> list[Path]:
    """Expand the CLI path arguments: directories are walked for ``*.py``
    (skipping fixture/hidden dirs); explicit files are always included."""
    out: list[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not SKIP_DIRS.intersection(f.parts):
                    out.append(f)
        else:
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# Baseline: grandfathered findings as `path RULE count` lines
# ---------------------------------------------------------------------------

def load_baseline(path: Path) -> Counter:
    """Baseline counts keyed ``(path, rule)``.  Count-based (not
    line-based) so unrelated edits to a grandfathered file don't churn
    the baseline; *new* findings of a baselined rule still fail because
    they exceed the recorded count."""
    counts: Counter = Counter()
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        try:
            file_part, rule, count = line.split()
            counts[(file_part, rule)] += int(count)
        except ValueError as e:
            raise SystemExit(
                f"{path}:{i}: bad baseline line {line!r} "
                "(want: <path> <RULE> <count>)"
            ) from e
    return counts


def apply_baseline(findings: list[Finding], baseline: Counter,
                   root: Path | None = None
                   ) -> tuple[list[Finding], Counter]:
    """(kept findings, stale entries).  Earliest findings are the ones
    grandfathered; stale = baselined counts no longer reached.

    Baseline keys are repo-relative; ``root`` (normally the baseline
    file's directory) lets absolute finding paths match them.
    """
    remaining = Counter(baseline)
    kept = []
    for f in findings:
        p = Path(f.path)
        if root is not None and p.is_absolute():
            try:
                p = p.resolve().relative_to(root)
            except ValueError:
                pass
        key = (p.as_posix(), f.rule)
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
        else:
            kept.append(f)
    stale = Counter({k: v for k, v in remaining.items() if v > 0})
    return kept, stale


def write_baseline(findings: list[Finding], path: Path) -> None:
    counts: Counter = Counter(
        (str(Path(f.path).as_posix()), f.rule) for f in findings
    )
    lines = [
        "# repro-lint baseline: grandfathered findings as `path RULE count`.",
        "# Regenerate with: python -m repro_torch.analysis --write-baseline "
        f"{path.name} <paths>",
    ]
    lines += [f"{p} {rule} {n}" for (p, rule), n in sorted(counts.items())]
    path.write_text("\n".join(lines) + "\n")


DEFAULT_BASELINE = "repro-lint.baseline"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint for the PyTorch port: repo-specific static "
                    "analysis (CUDA-graph capture hygiene)",
    )
    parser.add_argument("paths", nargs="+", help="files or directories")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline file (default: ./{DEFAULT_BASELINE} "
                             "when present)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline file")
    parser.add_argument("--write-baseline", metavar="FILE",
                        help="write current findings as the new baseline "
                             "and exit 0")
    args = parser.parse_args(argv)

    findings: list[Finding] = []
    files = collect_files(args.paths)
    for f in files:
        findings.extend(check_path(f))

    if args.write_baseline:
        write_baseline(findings, Path(args.write_baseline))
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return 0

    stale: Counter = Counter()
    if not args.no_baseline:
        baseline_path = Path(args.baseline) if args.baseline else \
            Path(DEFAULT_BASELINE)
        if args.baseline and not baseline_path.exists():
            raise SystemExit(f"baseline file not found: {baseline_path}")
        if baseline_path.exists():
            findings, stale = apply_baseline(
                findings, load_baseline(baseline_path),
                root=baseline_path.resolve().parent,
            )

    for f in findings:
        print(f.format())
    for (p, rule), n in sorted(stale.items()):
        print(f"note: stale baseline entry {p} {rule} x{n} "
              "(finding fixed? shrink the baseline)")
    n_files = len(files)
    if findings:
        print(f"\nrepro-lint: {len(findings)} finding(s) in {n_files} files")
        return 1
    print(f"repro-lint: clean ({n_files} files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
