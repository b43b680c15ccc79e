"""Invariant linter: AST rules over the port's own idioms.

The counterpart of ``repro.check.lint``: the same pragma, the same ``RULES``
catalog structure, and the reference's rules where the port shares the
invariant, keyed on the port's idioms where it does not:

* ``cuda-outside-kernels`` (the reference's ``pallas-outside-kernels``):
  CUDA sources only under ``src/repro_torch/csrc/``, and their bindings --
  ``ctypes.CDLL`` / ``ctypes.cdll.*`` / ``_build.library(...)`` -- only
  under ``src/repro_torch/kernels/``.  The file walk sees ``*.cu`` /
  ``*.cuh`` files for the first half.
* ``hardcoded-dtype-bytes``, ``pos-mask-update``, ``span-scope``: the
  reference's rules over the port's tree (the exempt table is
  ``repro_torch/core/hw.py``).
* ``jit-impurity``: the port has no ``jax.jit``; the rule is keyed on its
  tracing entry points (``torch.compile``, ``torch.jit.script`` / ``trace``
  decorators).
* ``ungated-obs-record``: also accepts the kernel wrappers' gate, a read of
  ``metrics._enabled``, and counts ``attribution.record_launch`` as a
  recorder (it does not gate itself; ``record_gemm`` does).

The linter is stdlib-only (``ast``) and purely lexical: it never imports the
code under analysis, so it runs on broken trees and injected fixtures alike.

Suppression: a finding can be silenced inline with

    # repro-check: allow[rule-id] reason...

on the offending line or the line directly above it -- the mechanism for
*intentional* exceptions (e.g. the scheduler's engine-wide warmup span, which
serves no single request).  Everything else goes through the baseline file
(``repro_torch.check.baseline``); the shipped baseline is empty and stays so.

The default paths are the port's own: ``src/repro_torch`` and
``tests/test_torch_*.py``.  ``tools/`` stays outside them: its A/B and fp8
tools load the binaries of two trees on purpose.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import re
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.check.findings import LINT, Finding

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_PATHS = (ROOT / "src" / "repro_torch", ROOT / "tests" / "test_torch_*.py")
CUDA_SUFFIXES = (".cu", ".cuh")

# ---------------------------------------------------------------------------
# Rule catalog: id -> (one-line contract, the regression it guards against).
# ---------------------------------------------------------------------------

RULES: dict[str, tuple[str, str]] = {
    "cuda-outside-kernels": (
        "CUDA sources (*.cu, *.cuh) only under src/repro_torch/csrc/; "
        "ctypes.CDLL / ctypes.cdll.* / _build.library(...) only under "
        "src/repro_torch/kernels/",
        "keeps every kernel behind a binding that checks its operands, "
        "counts its launches and records it (obs.attribution), and every "
        "source inside the content-hashed build (kernels/_build.py); a "
        "library loaded elsewhere launches uncounted and unaudited",
    ),
    "hardcoded-dtype-bytes": (
        "no integer literal in a *_dtype_bytes= call argument; derive from "
        "hw.dtype_bytes",
        "hardcoded in_dtype_bytes=2 sites silently price int8 plans with "
        "bf16 stream widths; the hw.DTYPE_BYTES table is the single source "
        "of truth",
    ),
    "pos-mask-update": (
        "a serving function that stores to a pool's .cache/.phys must also "
        "touch the pos validity mask (store to positions, or route through "
        "a mask-preserving primitive)",
        "the reference's reset_slots bug: cleared slots got pos=0, a VALID "
        "position, leaving stale keys attendable; freeing is a masking "
        "operation",
    ),
    "span-scope": (
        "scheduler spans/instants must run under request_scope(...) or "
        "carry an explicit rid=/rids= argument",
        "request timelines reconstruct admission->first-token->evict per "
        "rid from the trace; an untagged span silently falls out of every "
        "timeline and SLO postmortem",
    ),
    "jit-impurity": (
        "no wall-clock or stateful-RNG calls (time.time, random.*, "
        "np.random.*) inside torch.compile / torch.jit-decorated functions",
        "trace-time impurity bakes one host value into the compiled "
        "program; torch.Generator draws and host-side timing around the "
        "call are the sanctioned forms",
    ),
    "ungated-obs-record": (
        "recording on instruments fetched from the default obs registry, or "
        "through attribution.record_launch, must sit behind a "
        "metrics.enabled()/disabled() check or a read of metrics._enabled",
        "raw Counter.inc/Gauge.set/Histogram.observe and record_launch "
        "bypass the REPRO_OBS gate the host-cost budget of a decode step "
        "depends on; private scheduler registries are exempt (their "
        "bookkeeping must survive REPRO_OBS=0)",
    ),
}

_PRAGMA = re.compile(r"#\s*repro-check:\s*allow\[([a-zA-Z0-9_,\- ]+)\]")

_IMPURE_TIME = {
    "time",
    "time_ns",
    "perf_counter",
    "perf_counter_ns",
    "monotonic",
    "monotonic_ns",
}
_IMPURE_DATETIME = {"now", "utcnow", "today"}
_DTYPE_BYTES_KWARGS = {
    "in_dtype_bytes",
    "out_dtype_bytes",
    "scale_dtype_bytes",
    "acc_dtype_bytes",
    "dtype_bytes",
}
# The port's pool primitives that preserve the pos-mask invariant by
# construction: clear_slots writes -1 into integer leaves, the page/slot
# scatters move whole trees (pos travels with its group), advance/free/
# write_* manage positions themselves.
_MASK_PRESERVING = {
    "clear_slots",
    "_scatter_slot",
    "_scatter_pages",
    "_copy_page",
    "advance",
    "write_slot",
    "write_prefill",
    "free",
}
_RECORDERS = {"inc", "set", "observe", "set_gauge"}
_INSTRUMENT_GETTERS = {"counter", "gauge", "histogram"}
_UNGATED_RECORDERS = {"record_launch"}  # recorders that read no gate of their own


def _dotted(node: ast.AST) -> tuple[str, ...]:
    """('np', 'random', 'rand') for np.random.rand; () if not a name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _contains_int_literal(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Constant)
            and isinstance(sub.value, int)
            and not isinstance(sub.value, bool)
        ):
            return True
    return False


def _is_traced_entry(chain: tuple[str, ...]) -> bool:
    """torch.compile (any alias chain through torch) or torch.jit.script /
    torch.jit.trace (also as jit.script / jit.trace)."""
    if not chain:
        return False
    if chain[-1] == "compile" and "torch" in chain[:-1]:
        return True
    return chain[-2:] in (("jit", "script"), ("jit", "trace"))


def _is_jit_decorated(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    return any(_is_traced_entry(_dotted(sub)) for deco in fn.decorator_list for sub in ast.walk(deco))


@dataclasses.dataclass
class _FileContext:
    path: str  # normalized posix, repo-relative when possible
    tree: ast.Module
    pragmas: dict[int, set[str]]
    metrics_aliases: set[str]
    obs_aliases: set[str]

    def in_kernels(self) -> bool:
        return "repro_torch/kernels/" in self.path

    def in_serving(self) -> bool:
        return "serving/" in self.path

    def is_scheduler(self) -> bool:
        return "serving/" in self.path and "scheduler" in Path(self.path).name

    def is_hw_table(self) -> bool:
        return self.path.endswith("core/hw.py")


def _collect_pragmas(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out[i] = rules
    return out


def _collect_aliases(tree: ast.Module) -> tuple[set[str], set[str]]:
    """Names bound to the obs metrics module and to the obs package."""
    metrics_aliases: set[str] = set()
    obs_aliases: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                bound = alias.asname or alias.name
                if node.module.endswith("obs") and alias.name == "metrics":
                    metrics_aliases.add(bound)
                elif node.module.endswith("obs.metrics"):
                    pass  # from repro_torch.obs.metrics import inc -- helpers are gated
                elif alias.name == "obs" and node.module == "repro_torch":
                    obs_aliases.add(bound)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith("obs.metrics"):
                    metrics_aliases.add(alias.asname or alias.name.split(".")[-1])
                elif alias.name.endswith(".obs"):
                    obs_aliases.add(alias.asname or "obs")
    return metrics_aliases, obs_aliases


class _Visitor(ast.NodeVisitor):
    """Single traversal driving every rule; findings collect in ``found``."""

    def __init__(self, ctx: _FileContext):
        self.ctx = ctx
        self.found: list[Finding] = []
        self._fn_stack: list[ast.FunctionDef | ast.AsyncFunctionDef] = []
        self._qual: list[str] = []
        self._jit_depth = 0
        self._scope_depth = 0  # enclosing `with ... request_scope(...)` count
        self._registry_names: list[set[str]] = []  # per-function get_registry vars

    # -- bookkeeping ---------------------------------------------------------

    @property
    def symbol(self) -> str:
        return ".".join(self._qual) or "<module>"

    def _suppressed(self, rule: str, line: int) -> bool:
        return any(rule in self.ctx.pragmas.get(ln, ()) for ln in (line, line - 1))

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if self._suppressed(rule, line):
            return
        self.found.append(
            Finding(engine=LINT, rule=rule, path=self.ctx.path, line=line, symbol=self.symbol, message=message)
        )

    # -- structural visits ---------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()

    def _visit_function(self, node) -> None:
        self._qual.append(node.name)
        self._fn_stack.append(node)
        self._registry_names.append(set())
        jit = _is_jit_decorated(node)
        if jit:
            self._jit_depth += 1
        self._check_pos_mask(node)
        self.generic_visit(node)
        if jit:
            self._jit_depth -= 1
        self._registry_names.pop()
        self._fn_stack.pop()
        self._qual.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_With(self, node: ast.With) -> None:
        scoped = any(
            isinstance(item.context_expr, ast.Call)
            and _dotted(item.context_expr.func)[-1:] == ("request_scope",)
            for item in node.items
        )
        if scoped:
            self._scope_depth += 1
        self.generic_visit(node)
        if scoped:
            self._scope_depth -= 1

    def visit_Assign(self, node: ast.Assign) -> None:
        # Track `reg = metrics.get_registry()` so chains on `reg` are seen
        # as default-registry recording in this function.
        if (
            self._registry_names
            and isinstance(node.value, ast.Call)
            and _dotted(node.value.func)[-1:] == ("get_registry",)
        ):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._registry_names[-1].add(tgt.id)
        self.generic_visit(node)

    # -- rules ---------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        chain = _dotted(node.func)

        # cuda-outside-kernels (the binding half)
        loads = (
            chain[-1:] == ("CDLL",)
            or chain[:2] == ("ctypes", "cdll")
            or (len(chain) > 1 and chain[0] == "cdll")
            or chain[-2:] == ("_build", "library")
        )
        if loads and not self.ctx.in_kernels():
            self._emit(
                "cuda-outside-kernels",
                node,
                f"{'.'.join(chain)}() outside src/repro_torch/kernels/ -- load a "
                "kernel library only through a kernels/ binding (operand "
                "checks, launch counts, obs records)",
            )

        # hardcoded-dtype-bytes
        if not self.ctx.is_hw_table():
            for kw in node.keywords:
                if kw.arg in _DTYPE_BYTES_KWARGS and _contains_int_literal(kw.value):
                    self._emit(
                        "hardcoded-dtype-bytes",
                        kw.value,
                        f"integer literal in {kw.arg}=; derive element sizes "
                        "via hw.dtype_bytes(...) so quantized dtypes cannot "
                        "inherit bf16 sizing",
                    )

        # span-scope
        if self.ctx.is_scheduler() and chain[-1:] in (("span",), ("instant",)) and self._scope_depth == 0:
            kwargs = {kw.arg for kw in node.keywords}
            if not kwargs & {"rid", "rids"}:
                self._emit(
                    "span-scope",
                    node,
                    f"scheduler {chain[-1]}() outside request_scope(...) and "
                    "without rid=/rids= -- it will be missing from every "
                    "request timeline",
                )

        # jit-impurity
        if self._jit_depth and chain:
            impure = (
                (chain[0] == "time" and chain[-1] in _IMPURE_TIME)
                or (chain[0] == "datetime" and chain[-1] in _IMPURE_DATETIME)
                or (chain[0] == "random" and len(chain) > 1)
                or (len(chain) >= 3 and chain[0] in ("np", "numpy") and chain[1] == "random")
            )
            if impure:
                self._emit(
                    "jit-impurity",
                    node,
                    f"{'.'.join(chain)}() under torch.compile / torch.jit runs "
                    "at trace time and bakes one host value into the compiled "
                    "program; draw from a torch.Generator / time the call from "
                    "outside",
                )

        # ungated-obs-record
        ungated = (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _RECORDERS
            and self._default_registry_chain(node.func.value)
        ) or (bool(chain) and chain[-1] in _UNGATED_RECORDERS)
        if ungated and not self._function_checks_enabled():
            self._emit(
                "ungated-obs-record",
                node,
                "raw recording on the default obs registry (or record_launch) "
                "without an enabled()/disabled() gate or a metrics._enabled "
                "read in the function -- this bypasses REPRO_OBS=0 (use the "
                "gated metrics.inc/observe helpers, or check the gate first)",
            )

        self.generic_visit(node)

    def _default_registry_chain(self, receiver: ast.AST) -> bool:
        """Is ``receiver`` an instrument fetched from the *default* registry?

        Matches ``get_registry().counter(...)``, ``metrics.counter(...)``
        chains on a metrics-module alias, and ``reg.counter(...)`` where
        ``reg`` was assigned from get_registry() in this function.  Private
        registries (``self.registry``, locals built from Registry()) pass.
        """
        if not (
            isinstance(receiver, ast.Call)
            and isinstance(receiver.func, ast.Attribute)
            and receiver.func.attr in _INSTRUMENT_GETTERS
        ):
            return False
        root = receiver.func.value
        if isinstance(root, ast.Call) and _dotted(root.func)[-1:] == ("get_registry",):
            return True
        chain = _dotted(root)
        if len(chain) == 1 and chain[0] in self.ctx.metrics_aliases:
            return True
        if len(chain) == 2 and chain[0] in self.ctx.obs_aliases and chain[1] == "metrics":
            return True
        return bool(self._registry_names and len(chain) == 1 and chain[0] in self._registry_names[-1])

    def _function_checks_enabled(self) -> bool:
        """The enclosing function calls enabled()/disabled() or reads
        ``metrics._enabled`` (the kernel wrappers' one-boolean gate)."""
        if not self._fn_stack:
            return False
        for sub in ast.walk(self._fn_stack[-1]):
            if isinstance(sub, ast.Call) and _dotted(sub.func)[-1:] in (("enabled",), ("disabled",)):
                return True
            if isinstance(sub, ast.Attribute) and sub.attr == "_enabled" and isinstance(sub.ctx, ast.Load):
                return True
        return False

    def _check_pos_mask(self, fn) -> None:
        """pos-mask-update: runs per function, over its whole subtree."""
        if not self.ctx.in_serving():
            return
        cache_store: ast.AST | None = None
        touches_pos = False
        preserving = False
        for sub in ast.walk(fn):
            targets: list[ast.AST] = []
            if isinstance(sub, ast.Assign):
                targets = list(sub.targets)
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                targets = [sub.target]
            for tgt in targets:
                for el in ast.walk(tgt):
                    if isinstance(el, ast.Attribute) and el.attr in ("cache", "phys"):
                        cache_store = cache_store or sub
                    # Validity state is ``positions`` (per-slot pools) or the
                    # synchronized engine's scalar ``pos``.
                    if isinstance(el, ast.Attribute) and el.attr in ("positions", "pos"):
                        touches_pos = True
                    if (
                        isinstance(el, ast.Subscript)
                        and isinstance(el.value, ast.Attribute)
                        and el.value.attr in ("positions", "pos")
                    ):
                        touches_pos = True
            if isinstance(sub, ast.Call):
                name = _dotted(sub.func)[-1:]
                if name and name[0] in _MASK_PRESERVING:
                    preserving = True
        if cache_store is not None and not (touches_pos or preserving):
            self._emit(
                "pos-mask-update",
                cache_store,
                "stores a pool cache (.cache/.phys) without touching the "
                "pos validity mask or routing through a mask-preserving "
                "primitive -- freed/overwritten slots must end at pos=-1, "
                "not 0 (the reference's reset_slots bug)",
            )


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def _normalize(path: Path) -> str:
    """Posix path relative to the repo root (else the working directory,
    else absolute): the scope rules read it, the fingerprint holds it."""
    p = path.resolve()
    for base in (ROOT, Path.cwd()):
        try:
            return p.relative_to(base).as_posix()
        except ValueError:
            pass
    return p.as_posix()


def _cuda_source_findings(path: str) -> list[Finding]:
    """cuda-outside-kernels (the source half): a CUDA source outside csrc/."""
    if "repro_torch/csrc/" in path:
        return []
    return [
        Finding(
            engine=LINT,
            rule="cuda-outside-kernels",
            path=path,
            line=0,
            symbol="<module>",
            message="CUDA source outside src/repro_torch/csrc/ -- it is not built by kernels/_build.py "
            "and no binding checks, counts or records its launches",
        )
    ]


def lint_source(source: str, path: str) -> list[Finding]:
    """Lint one file's source text (``path`` only determines rule scope)."""
    if path.endswith(CUDA_SUFFIXES):
        return _cuda_source_findings(path)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [
            Finding(
                engine=LINT,
                rule="syntax-error",
                path=path,
                line=e.lineno or 0,
                symbol="<module>",
                message=f"file does not parse: {e.msg}",
            )
        ]
    metrics_aliases, obs_aliases = _collect_aliases(tree)
    ctx = _FileContext(
        path=path,
        tree=tree,
        pragmas=_collect_pragmas(source),
        metrics_aliases=metrics_aliases,
        obs_aliases=obs_aliases,
    )
    visitor = _Visitor(ctx)
    visitor.visit(tree)
    return visitor.found


def _wanted(f: Path) -> bool:
    return f.suffix == ".py" or f.suffix in CUDA_SUFFIXES


def iter_source_files(paths: Iterable[str | Path]) -> Iterator[Path]:
    """Python and CUDA sources under ``paths`` (directories walked, glob
    patterns expanded), skipping hidden directories."""
    for p in paths:
        matches = sorted(Path(m) for m in glob.glob(str(p))) if glob.has_magic(str(p)) else [Path(p)]
        for q in matches:
            if q.is_dir():
                yield from sorted(
                    f for f in q.rglob("*") if f.is_file() and _wanted(f)
                    and not any(part.startswith(".") for part in f.relative_to(q).parts)
                )
            elif _wanted(q):
                yield q


def lint_paths(paths: Iterable[str | Path] = DEFAULT_PATHS) -> list[Finding]:
    findings: list[Finding] = []
    for f in iter_source_files(paths):
        findings.extend(lint_source(f.read_text(), _normalize(f)))
    return findings
