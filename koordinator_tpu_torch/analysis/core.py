"""koordlint core: findings, rule registry, suppressions, baseline, engine.

The analyzer is a plain-AST framework (no imports of the analyzed code, no
jax dependency): each rule receives a parsed module plus shared lexical
context and yields findings. The engine layers three noise controls on top:

  * inline suppressions — ``# koordlint: disable=<rule>[,<rule>...]`` on the
    offending line (or alone on the line above) silences those rules there;
    ``disable=all`` silences every rule for that line;
  * a JSON baseline of grandfathered findings (keyed path:rule:line) so a
    new rule can land strict for NEW code while existing debt is burned
    down incrementally (ROADMAP tracks the burn-down);
  * per-rule severity (error/warning) — informational only; the exit-code
    contract fails on ANY non-baselined, non-suppressed finding so CI
    stays binary.

Rules register themselves via the ``@register`` decorator at import time of
``koordinator_tpu_torch.analysis.rules``; the registry is the single source the
CLI, the tests, and the README rule catalog all enumerate.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import tokenize
from io import StringIO
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

SEVERITIES = ("error", "warning")

# generated protobuf modules are not hand-maintained; linting them is noise
_SKIP_FILE_RE = re.compile(r"(_pb2\.py|_pb2_grpc\.py)$")

_SUPPRESS_RE = re.compile(
    r"#\s*koordlint:\s*disable=([A-Za-z0-9_,\-\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    severity: str
    path: str          # as given to the engine (posix-normalized)
    line: int          # 1-based
    message: str

    @property
    def key(self) -> str:
        """Stable identity used by baseline matching (message excluded so
        rewording a diagnostic does not churn the baseline)."""
        return f"{self.path}:{self.rule}:{self.line}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity}: "
                f"[{self.rule}] {self.message}")


class ModuleContext:
    """Everything a rule may consult about one source file."""

    def __init__(self, path: str, source: str, tree: ast.Module) -> None:
        self.path = path.replace("\\", "/")
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self._traced: Optional[Set[ast.AST]] = None
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    # ---- shared lexical helpers ------------------------------------
    def parent_map(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def traced_functions(self) -> Set[ast.AST]:
        """Function defs reachable from a jax tracing entry point — see
        rules/jaxtrace.py for the discovery algorithm."""
        if self._traced is None:
            from koordinator_tpu_torch.analysis.rules.jaxtrace import (
                find_traced_functions,
            )
            self._traced = find_traced_functions(self.tree)
        return self._traced


class Rule:
    """Base class; subclasses set name/severity/description and implement
    check()."""

    name: str = ""
    severity: str = "error"
    description: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(rule=self.name, severity=self.severity,
                       path=ctx.path, line=getattr(node, "lineno", 1),
                       message=message)


class ProgramContext:
    """Everything a whole-program rule may consult: the concurrency
    facts of every scanned module (see analysis/guards.py) plus the
    guard map and lock graph derived from them, built lazily and shared
    across the program rules."""

    def __init__(self, facts_list) -> None:
        self.facts_list = list(facts_list)
        self._guard_map = None
        self._lock_graph = None
        self._caller_held: Dict[str, Dict] = {}

    @property
    def guard_map(self):
        if self._guard_map is None:
            from koordinator_tpu_torch.analysis.guards import build_guard_map
            self._guard_map = build_guard_map(self.facts_list)
        return self._guard_map

    @property
    def lock_graph(self):
        if self._lock_graph is None:
            from koordinator_tpu_torch.analysis.guards import LockGraph
            self._lock_graph = LockGraph(self.guard_map)
        return self._lock_graph

    def caller_held(self, path: str) -> Dict:
        """(owner, method) -> locks provably held by every caller, for
        the module at `path` (see guards.caller_held_locks)."""
        if path not in self._caller_held:
            from koordinator_tpu_torch.analysis.guards import caller_held_locks
            facts = next((f for f in self.facts_list if f.path == path),
                         None)
            self._caller_held[path] = (
                caller_held_locks(facts) if facts is not None else {})
        return self._caller_held[path]


class ProgramRule(Rule):
    """A rule that needs the whole program: it sees every module's facts
    at once instead of one ModuleContext. Per-module check() is a no-op;
    the engine calls check_program() after the per-file pass."""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        return iter(())

    def check_program(self, program: ProgramContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding_at(self, path: str, line: int, message: str) -> Finding:
        return Finding(rule=self.name, severity=self.severity,
                       path=path, line=line, message=message)


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and add to the global registry."""
    rule = cls()
    if not rule.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if rule.severity not in SEVERITIES:
        raise ValueError(f"rule {rule.name}: bad severity {rule.severity!r}")
    if rule.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    _REGISTRY[rule.name] = rule
    return cls


def all_rules() -> Dict[str, Rule]:
    """name -> rule, importing the rule modules on first use."""
    import koordinator_tpu_torch.analysis.rules  # noqa: F401  (registration)

    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def suppressed_lines(source: str) -> Dict[int, Set[str]]:
    """line number -> set of rule names disabled there ('all' wildcard).

    A ``# koordlint: disable=...`` trailing a statement applies to its own
    line; a comment ALONE on a line applies to the next line (so long
    statements can carry the pragma above themselves).
    """
    out: Dict[int, Set[str]] = {}
    try:
        tokens = list(tokenize.generate_tokens(StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        tokens = []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        line = tok.start[0]
        standalone = tok.string.strip() == tok.line.strip()
        target = line + 1 if standalone else line
        out.setdefault(target, set()).update(rules)
    return out


def is_suppressed(finding: Finding,
                  suppress: Dict[int, Set[str]]) -> bool:
    rules = suppress.get(finding.line)
    if not rules:
        return False
    return "all" in rules or finding.rule in rules


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path) -> Set[str]:
    """Baseline file -> set of finding keys. Missing file == empty."""
    p = Path(path)
    if not p.exists():
        return set()
    data = json.loads(p.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {p}: unsupported version {data.get('version')!r}")
    return {
        f"{e['path']}:{e['rule']}:{e['line']}" for e in data["findings"]
    }


def write_baseline(path, findings: Sequence[Finding]) -> None:
    entries = [
        {"path": f.path, "rule": f.rule, "line": f.line,
         "message": f.message}
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    ]
    Path(path).write_text(json.dumps(
        {"version": BASELINE_VERSION, "findings": entries}, indent=2)
        + "\n")


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def iter_python_files(paths: Iterable[str]) -> Iterator[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not _SKIP_FILE_RE.search(f.name):
                    yield f
        elif p.suffix == ".py":
            yield p


def _module_findings(ctx: ModuleContext, suppress: Dict[int, Set[str]],
                     rules: Dict[str, Rule]) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Finding] = set()
    for rule in rules.values():
        for f in rule.check(ctx):
            # dedup identical reports (e.g. a jit call inside two nested
            # loops is one site, not two findings)
            if not is_suppressed(f, suppress) and f not in seen:
                seen.add(f)
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def program_findings(facts_list,
                     suppress_by_path: Dict[str, Dict[int, Set[str]]],
                     rules: Optional[Dict[str, Rule]] = None
                     ) -> List[Finding]:
    """Run the whole-program rules over the collected facts; the
    per-file suppression maps apply at whatever line a program finding
    lands on."""
    rules = all_rules() if rules is None else rules
    program = ProgramContext([f for f in facts_list if f is not None])
    out: List[Finding] = []
    seen: Set[Finding] = set()
    for rule in rules.values():
        if not isinstance(rule, ProgramRule):
            continue
        for f in rule.check_program(program):
            sup = suppress_by_path.get(f.path, {})
            if not is_suppressed(f, sup) and f not in seen:
                seen.add(f)
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def analyze_source(source: str, path: str = "<memory>",
                   rules: Optional[Dict[str, Rule]] = None) -> List[Finding]:
    """Run the rule set over one source text (suppressions applied,
    baseline NOT applied — that is the caller's policy layer). The
    whole-program rules run over this single module, so a snippet test
    exercises them without a directory walk."""
    rules = all_rules() if rules is None else rules
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(rule="parse-error", severity="error",
                        path=path.replace("\\", "/"),
                        line=e.lineno or 1,
                        message=f"could not parse: {e.msg}")]
    ctx = ModuleContext(path, source, tree)
    suppress = suppressed_lines(source)
    out = _module_findings(ctx, suppress, rules)
    from koordinator_tpu_torch.analysis.guards import collect_module_facts

    facts = collect_module_facts(ctx.path, source, tree)
    out.extend(program_findings([facts], {ctx.path: suppress}, rules))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def _canonical_path(p: Path) -> str:
    """CWD-relative posix path when the file lives under CWD, else the
    path as given. Baseline keys embed this string, so `koordinator_tpu_torch/
    foo.py`, `./koordinator_tpu_torch/foo.py` and the absolute spelling must
    all produce the same key or grandfathered findings resurface."""
    try:
        rel = p.resolve().relative_to(Path.cwd())
        return rel.as_posix()
    except (ValueError, OSError):
        return p.as_posix()


def _scan_file(path_str: str):
    """Worker unit: per-file findings + concurrency facts + suppression
    map. Top-level (and returning only picklable dataclasses/dicts) so a
    ProcessPoolExecutor can run it; the whole-program passes consume the
    facts back in the parent."""
    from koordinator_tpu_torch.analysis.guards import collect_module_facts

    rules = all_rules()
    p = Path(path_str)
    source = p.read_text()
    cpath = _canonical_path(p)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        f = Finding(rule="parse-error", severity="error", path=cpath,
                    line=e.lineno or 1, message=f"could not parse: {e.msg}")
        return [f], None, {}
    ctx = ModuleContext(cpath, source, tree)
    suppress = suppressed_lines(source)
    findings = _module_findings(ctx, suppress, rules)
    facts = collect_module_facts(cpath, source, tree)
    return findings, facts, suppress


def default_jobs(n_files: int) -> int:
    """Worker count for the per-file pass: KOORDLINT_JOBS wins, else
    scale with the machine but keep small scans serial (pool startup
    costs more than it saves under ~2 dozen files)."""
    import os

    env = os.environ.get("KOORDLINT_JOBS", "")
    if env.strip():
        try:
            return max(1, int(env))
        except ValueError:
            pass
    if n_files < 24:
        return 1
    return max(1, min(8, os.cpu_count() or 1))


def analyze_paths(paths: Iterable[str],
                  baseline: Optional[Set[str]] = None,
                  jobs: Optional[int] = None) -> List[Finding]:
    """Analyze files/directories; findings present in `baseline` are
    dropped. The per-file pass fans out to `jobs` worker processes
    (default: scale with the machine; finding order is identical to the
    serial run — workers return results in input order and the
    whole-program passes always run once, in the parent)."""
    all_rules()  # fail fast on registration errors before forking
    baseline = baseline or set()
    files = [str(f) for f in iter_python_files(paths)]
    jobs = default_jobs(len(files)) if jobs is None else max(1, jobs)
    results = None
    if jobs > 1 and len(files) > 1:
        try:
            from concurrent.futures import ProcessPoolExecutor
            from concurrent.futures.process import BrokenProcessPool

            with ProcessPoolExecutor(max_workers=jobs) as pool:
                results = list(pool.map(_scan_file, files, chunksize=4))
        except (OSError, ImportError, BrokenProcessPool):
            # sandboxes without working process pools fall back to the
            # serial path rather than failing the lint run
            results = None
    if results is None:
        results = [_scan_file(f) for f in files]

    out: List[Finding] = []
    facts_list = []
    suppress_by_path: Dict[str, Dict[int, Set[str]]] = {}
    for (findings, facts, suppress) in results:
        for finding in findings:
            if finding.key not in baseline:
                out.append(finding)
        if facts is not None:
            facts_list.append(facts)
            suppress_by_path[facts.path] = suppress
    for finding in program_findings(facts_list, suppress_by_path):
        if finding.key not in baseline:
            out.append(finding)
    return out
