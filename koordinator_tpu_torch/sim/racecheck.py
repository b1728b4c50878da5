"""koordrace, dynamic half: a deterministic thread-interleaving race
harness over the seeded sim, on ``device`` ("cuda" by default, or "cpu").

The static half (analysis/guards.py + analysis/rules/race.py) learns
which shared fields are guarded by which locks and flags violations
without running anything. This module EXECUTES the smoke scenario with
every concurrency feature armed — pipeline overlap, a (never-firing)
dispatch watchdog, background warm-up — and checks the same discipline
at runtime:

  * every ``threading.Lock``/``RLock`` constructed during the run, plus
    the module-level locks and singleton instance locks that already
    exist at install time, is wrapped in an ownership-tracking proxy
    (:class:`_TracedLock`); the proxy knows which thread holds it, which
    a raw ``_thread.lock`` cannot say;
  * a trace function (``sys.settrace``/``threading.settrace``, on
    Python 3.12; ``sys.monitoring`` would trace other events) fires at
    every guarded-field touchpoint FROM THE STATIC GUARD MAP, forcing
    seeded thread preemption there and recording a WITNESS whenever the
    guarding lock is not held by the touching thread;
  * acquisitions of canonically-ordered locks (obs/lockorder.py) are
    checked against the declared order as they happen — a runtime
    inversion is recorded even if no deadlock materializes;
  * scraper threads hammer ``/metrics`` and ``/debug/timeline`` through
    ``ObsServer.handle`` for the whole run, validating every response
    parses cleanly (the torn-exposition check).

Determinism contract: the binding log must be BYTE-IDENTICAL across two
different preemption seeds — the harness shakes the schedule, never the
decisions. :func:`check_races` (``python -m
koordinator_tpu_torch.sim.racecheck``) gates on that plus zero
witnesses, zero order inversions, zero scrape errors, and static/dynamic
agreement (a runtime witness the analyzer did not flag is reported as
its own failure class).

On the card the threads are real in a way the CPU run cannot show: the
warm-up ladder launches on its own CUDA stream, the watchdog's readback
thread waits on the card, and the waves launch the hand-written kernels.

Tests pin SPECIFIC interleavings with :meth:`RaceCheck.add_hook`: a
predicate over the touchpoint spec selects where, the callback runs on
the touching thread at that point — no sleeps, no polling.

Preemption wrinkle (why yields, not a scheduler): CPython's thread
scheduler is not scriptable from pure Python; what IS deterministic
here is WHICH touchpoints yield (a crc32 of seed, site, and a
per-thread counter — no process-randomized ``hash()``), so two runs at
one seed exercise the same yield set, and two seeds exercise different
ones. The assertion is outcome determinism, not schedule determinism.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import sys
import tempfile
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

MODULE_OWNER = "<module>"

# armed-but-never-firing: the watchdog spawns its worker and waits, but
# 30s per device window cannot overrun a CPU sim cycle — overruns would
# make the binding log wall-clock-dependent and break the byte-identity
# contract
RACECHECK_DEADLINE_MS = 30_000.0

# ~1/16 of touchpoint hits yield the GIL (one in three of those sleeps
# a real millisecond to widen the window) — enough schedule shaking to
# expose ordering bugs at sim scale without drowning the run in sleeps
_DEFAULT_PREEMPT_PERMILLE = 62

# the raw lock types, captured before any factory patching
_LOCK_TYPE = type(threading.Lock())
_RLOCK_TYPE = type(threading.RLock())
_RAW_LOCK_TYPES = (_LOCK_TYPE, _RLOCK_TYPE)


# ---------------------------------------------------------------------------
# the ownership-tracking lock proxy
# ---------------------------------------------------------------------------

class _TracedLock:
    """Wraps a real ``Lock``/``RLock``; tracks per-thread ownership and
    reports canonical-order acquisitions to the active RaceCheck.

    Defines ``_is_owned``/``_release_save``/``_acquire_restore`` so a
    ``threading.Condition`` built over the proxy (``threading.Event``
    does this internally) keeps exact wait semantics AND keeps the
    ownership books balanced across the wait's release/reacquire. A lock
    built during a run stays wrapped after ``uninstall()``, so the proxy
    also answers the rest of Python 3.12's lock surface:
    ``_at_fork_reinit``, which a forked child calls on the ``threading``
    and ``logging`` locks, and an RLock's ``_recursion_count``."""

    __slots__ = ("_inner", "kind", "label", "_owners")

    def __init__(self, inner, kind: str, label: str = "") -> None:
        self._inner = inner
        self.kind = kind            # "Lock" | "RLock"
        self.label = label          # "Owner.attr" | "path::attr" | ""
        self._owners: Dict[int, int] = {}

    # -- core protocol ------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            me = threading.get_ident()
            self._owners[me] = self._owners.get(me, 0) + 1
            rc = _ACTIVE
            if rc is not None:
                rc._note_acquire(self)
        return ok

    def release(self) -> None:
        me = threading.get_ident()
        n = self._owners.get(me, 0)
        if n <= 1:
            self._owners.pop(me, None)
        else:
            self._owners[me] = n - 1
        rc = _ACTIVE
        if rc is not None:
            rc._note_release(self)
        self._inner.release()

    def __enter__(self) -> "_TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def held_by_me(self) -> bool:
        return threading.get_ident() in self._owners

    # -- Condition integration ----------------------------------------
    def _is_owned(self) -> bool:
        return self.held_by_me()

    def _release_save(self):
        me = threading.get_ident()
        count = self._owners.pop(me, 1)
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return (count, inner._release_save())
        inner.release()
        return (count, None)

    def _acquire_restore(self, state) -> None:
        count, inner_state = state
        inner = self._inner
        if inner_state is not None and hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(inner_state)
        else:
            inner.acquire()
        self._owners[threading.get_ident()] = count

    # -- the rest of Python 3.12's lock surface ------------------------
    def _at_fork_reinit(self) -> None:
        # the child has one thread and every lock released
        self._inner._at_fork_reinit()
        self._owners.clear()

    def _recursion_count(self) -> int:
        # an RLock's (multiprocessing's resource tracker reads it); a
        # plain Lock has none, wrapped or not
        return self._inner._recursion_count()

    def __repr__(self) -> str:
        return (f"<_TracedLock {self.kind} {self.label or '?'} "
                f"owners={list(self._owners)}>")


@dataclasses.dataclass(frozen=True)
class TouchSpec:
    """One guarded-field touchpoint from the static map: the trace
    function fires here."""

    path: str       # repo-relative, as the guard map keys it
    line: int
    owner: str      # class name or MODULE_OWNER
    field: str
    guard: str      # lock attribute / module lock name
    write: bool


@dataclasses.dataclass
class RaceReport:
    """What one instrumented run observed."""

    preempt_seed: int
    bindings: int = 0
    binding_log_sha256: str = ""
    touches: int = 0
    preemptions: int = 0
    scrapes: int = 0
    unchecked: int = 0  # touches whose guard was a raw (pre-wrap) lock
    witnesses: List[dict] = dataclasses.field(default_factory=list)
    order_violations: List[dict] = dataclasses.field(default_factory=list)
    scrape_errors: List[str] = dataclasses.field(default_factory=list)
    # the background warm-up ladder's stats (rungs, warmed, ...): the
    # port's own; a run with an empty rung index replays nothing
    warmup: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not (self.witnesses or self.order_violations
                    or self.scrape_errors)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


# the currently-installed harness; _TracedLock reports through this
_ACTIVE: Optional["RaceCheck"] = None

_PACKAGE = "koordinator_tpu_torch"


def _is_port_module(name: str) -> bool:
    """The port's own modules, and not the JAX package's when both share a
    process."""
    return name == _PACKAGE or name.startswith(_PACKAGE + ".")


def _repo_root() -> str:
    import koordinator_tpu_torch

    return os.path.dirname(os.path.dirname(
        os.path.abspath(koordinator_tpu_torch.__file__)))


class RaceCheck:
    """Install/uninstall the instrumentation; collect the observations.

    Usage::

        rc = RaceCheck(preempt_seed=7)
        rc.install()
        try:
            ...build + run threads...
        finally:
            rc.uninstall()
        report = rc.report(...)
    """

    def __init__(self, preempt_seed: int = 0,
                 preempt_permille: int = _DEFAULT_PREEMPT_PERMILLE,
                 scan_paths: Tuple[str, ...] = (_PACKAGE,)) -> None:
        self.preempt_seed = int(preempt_seed)
        self.preempt_permille = int(preempt_permille)
        self.witnesses: List[dict] = []
        self.order_violations: List[dict] = []
        self.touches = 0
        self.preemptions = 0
        self.unchecked = 0
        self._hooks: List[Tuple[Callable[[TouchSpec], bool],
                                Callable[..., None]]] = []
        self._tls = threading.local()
        # raw (never-wrapped) lock for the counters: list.append is
        # atomic under the GIL but ``+=`` on an int attribute is not
        import _thread

        self._stats_lock = _thread.allocate_lock()
        self._installed = False
        self._restores: List[Tuple[object, str, object]] = []
        self._build_static_index(scan_paths)

    # static index keyed by (root, scan_paths): fact extraction walks +
    # parses the whole tree (~seconds); sources cannot change under a
    # running process, so the gate's second seed and every harness test
    # reuse the first build
    _STATIC_CACHE: Dict[Tuple[str, Tuple[str, ...]], tuple] = {}

    # -- static-map plumbing ------------------------------------------
    def _build_static_index(self, scan_paths: Tuple[str, ...]) -> None:
        from koordinator_tpu_torch.analysis.core import suppressed_lines
        from koordinator_tpu_torch.analysis.guards import (
            build_guard_map,
            collect_facts_for_paths,
        )

        root = _repo_root()
        cached = self._STATIC_CACHE.get((root, scan_paths))
        if cached is not None:
            (self.guard_map, self.canonical_order, self._canon_index,
             self._touch_files, self._lockdef_labels) = cached
            return
        facts_list = collect_facts_for_paths(
            [os.path.join(root, p) for p in scan_paths])
        self.guard_map = build_guard_map(facts_list)
        self.canonical_order: Tuple[str, ...] = tuple(
            self.guard_map.canonical_order)
        self._canon_index = {name: i
                             for i, name in enumerate(self.canonical_order)}

        # suppressed unguarded-shared-field lines are NOT touchpoints:
        # the pragma'd exceptions (documented at the site) hold for the
        # dynamic half exactly as for the static one
        suppress: Dict[str, Dict[int, set]] = {}
        for facts in facts_list:
            try:
                with open(os.path.join(root, facts.path)) as f:
                    suppress[facts.path] = suppressed_lines(f.read())
            except OSError:
                suppress[facts.path] = {}

        self._touch_files: Dict[str, Dict[int, TouchSpec]] = {}
        for facts, t, gf in self.guard_map.guarded_touchpoints():
            rules = suppress.get(facts.path, {}).get(t.line, set())
            if "all" in rules or "unguarded-shared-field" in rules:
                continue
            spec = TouchSpec(path=facts.path, line=t.line, owner=t.owner,
                             field=t.field, guard=gf.guard, write=t.write)
            for key in (os.path.join(root, facts.path), facts.path):
                self._touch_files.setdefault(key, {})[t.line] = spec

        # lock-definition sites -> canonical-style labels, so a lock
        # constructed DURING the run self-identifies from its creation
        # frame (``self._lock = threading.Lock()`` in DeviceSnapshot
        # lands on the LockDef line the static map already knows)
        self._lockdef_labels: Dict[Tuple[str, int], str] = {}
        for facts in facts_list:
            for d in facts.locks:
                label = (f"{facts.path}::{d.attr}"
                         if d.owner == MODULE_OWNER
                         else f"{d.owner}.{d.attr}")
                for key in (os.path.join(root, facts.path), facts.path):
                    self._lockdef_labels[(key, d.line)] = label
        self._STATIC_CACHE[(root, scan_paths)] = (
            self.guard_map, self.canonical_order, self._canon_index,
            self._touch_files, self._lockdef_labels)

    # -- install / uninstall ------------------------------------------
    def install(self) -> None:
        global _ACTIVE
        if self._installed:
            return
        if _ACTIVE is not None:
            raise RuntimeError("another RaceCheck is installed")
        _ACTIVE = self
        self._installed = True
        orig_lock, orig_rlock = threading.Lock, threading.RLock
        self._saved_factories = (orig_lock, orig_rlock)
        threading.Lock = self._make_factory(orig_lock, "Lock")
        threading.RLock = self._make_factory(orig_rlock, "RLock")
        self._sweep_existing()
        self._saved_switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        threading.settrace(self._global_trace)
        sys.settrace(self._global_trace)

    def uninstall(self) -> None:
        global _ACTIVE
        if not self._installed:
            return
        sys.settrace(None)
        threading.settrace(None)  # type: ignore[arg-type]
        sys.setswitchinterval(self._saved_switch)
        threading.Lock, threading.RLock = self._saved_factories
        # put the raw locks back where the sweep wrapped them in place
        for holder, attr, original in reversed(self._restores):
            try:
                setattr(holder, attr, original)
            except (AttributeError, TypeError):
                pass
        self._restores.clear()
        self._installed = False
        _ACTIVE = None

    def _make_factory(self, orig, kind: str):
        labels = self._lockdef_labels

        def factory():
            fr = sys._getframe(1)
            label = labels.get((fr.f_code.co_filename, fr.f_lineno), "")
            return _TracedLock(orig(), kind, label)

        return factory

    def _sweep_existing(self) -> None:
        """Wrap locks that predate install(): module-level locks and the
        instance locks of import-time singletons (the metrics
        registries and their metric children) across the port's modules.
        New locks route through the patched factories."""
        root = _repo_root()
        seen: set = set()
        for name, mod in list(sys.modules.items()):
            if not _is_port_module(name) or mod is None:
                continue
            mod_file = getattr(mod, "__file__", None)
            rel = (os.path.relpath(mod_file, root).replace("\\", "/")
                   if mod_file else name)
            for attr, val in list(vars(mod).items()):
                if isinstance(val, _RAW_LOCK_TYPES):
                    self._swap(mod, attr, val, f"{rel}::{attr}")
                elif _is_port_module(type(val).__module__ or ""):
                    self._wrap_instance(val, seen, depth=0)

    def _wrap_instance(self, obj, seen: set, depth: int) -> None:
        if id(obj) in seen:
            return
        seen.add(id(obj))
        d = getattr(obj, "__dict__", None)
        if not isinstance(d, dict):
            return
        qual = type(obj).__qualname__
        for attr, val in list(d.items()):
            if isinstance(val, _RAW_LOCK_TYPES):
                self._swap(obj, attr, val, f"{qual}.{attr}")
            elif depth == 0 and isinstance(val, dict):
                # one container level: Registry._metrics maps names to
                # _Metric instances, each holding its own import-time
                # lock — the /metrics scrape path under test
                for v in list(val.values()):
                    if _is_port_module(type(v).__module__ or ""):
                        self._wrap_instance(v, seen, depth + 1)

    def _swap(self, holder, attr: str, raw, label: str) -> None:
        kind = "RLock" if isinstance(raw, _RLOCK_TYPE) else "Lock"
        try:
            setattr(holder, attr, _TracedLock(raw, kind, label))
        except (AttributeError, TypeError):
            return
        self._restores.append((holder, attr, raw))

    # -- runtime order tracking ---------------------------------------
    def _note_acquire(self, lk: _TracedLock) -> None:
        idx = self._canon_index.get(lk.label)
        if idx is None:
            return
        stack = getattr(self._tls, "canon", None)
        if stack is None:
            stack = self._tls.canon = []
        if stack and self._canon_index[stack[-1]] > idx:
            self.order_violations.append({
                "held": stack[-1], "acquired": lk.label,
                "thread": threading.current_thread().name,
            })
        stack.append(lk.label)

    def _note_release(self, lk: _TracedLock) -> None:
        if lk.label not in self._canon_index:
            return
        stack = getattr(self._tls, "canon", None)
        if stack and lk.label in stack:
            # remove the innermost occurrence (RLock re-entry pops one)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == lk.label:
                    del stack[i]
                    break

    # -- the trace function -------------------------------------------
    def _global_trace(self, frame, event, arg):
        if event == "call" and frame.f_code.co_filename in self._touch_files:
            return self._local_trace
        return None

    def _local_trace(self, frame, event, arg):
        if event == "line":
            spec = self._touch_files[frame.f_code.co_filename].get(
                frame.f_lineno)
            if spec is not None:
                self._on_touch(spec, frame)
        return self._local_trace

    def _on_touch(self, spec: TouchSpec, frame) -> None:
        with self._stats_lock:
            self.touches += 1
        # 1) witness check: is the statically-assigned guard actually
        # held by the thread touching the field right now?
        if spec.owner == MODULE_OWNER:
            guard_obj = frame.f_globals.get(spec.guard)
        else:
            slf = frame.f_locals.get("self")
            guard_obj = getattr(slf, spec.guard, None) \
                if slf is not None else None
        if isinstance(guard_obj, _TracedLock):
            if not guard_obj.held_by_me():
                self.witnesses.append({
                    "path": spec.path, "line": spec.line,
                    "owner": spec.owner, "field": spec.field,
                    "guard": spec.guard, "write": spec.write,
                    "thread": threading.current_thread().name,
                })
        elif guard_obj is not None:
            with self._stats_lock:
                self.unchecked += 1
        # 2) pinned-interleaving hooks (tests)
        for pred, fn in self._hooks:
            if pred(spec):
                fn(spec, frame)
        # 3) seeded preemption: crc32 (stable across processes, unlike
        # str hash) of seed + site + per-thread counter picks the yield
        # points — same seed, same yield set, every run
        tls = self._tls
        n = getattr(tls, "n", 0) + 1
        tls.n = n
        h = zlib.crc32(
            f"{self.preempt_seed}:{spec.path}:{spec.line}:{n}".encode())
        if h % 1000 < self.preempt_permille:
            with self._stats_lock:
                self.preemptions += 1
            time.sleep(0.001 if h % 3 == 0 else 0)

    # -- test API ------------------------------------------------------
    def add_hook(self, pred: Callable[[TouchSpec], bool],
                 fn: Callable[..., None]) -> None:
        """Run ``fn(spec, frame)`` on the touching thread at every
        touchpoint where ``pred(spec)`` — the no-sleeps way for a test
        to pin an interleaving."""
        self._hooks.append((pred, fn))

    def report(self, sim_report=None, preempt_seed: Optional[int] = None,
               scrapes: int = 0,
               scrape_errors: Optional[List[str]] = None) -> RaceReport:
        rep = RaceReport(
            preempt_seed=(self.preempt_seed if preempt_seed is None
                          else preempt_seed),
            touches=self.touches,
            preemptions=self.preemptions,
            unchecked=self.unchecked,
            witnesses=list(self.witnesses),
            order_violations=list(self.order_violations),
            scrapes=scrapes,
            scrape_errors=list(scrape_errors or []),
        )
        if sim_report is not None:
            rep.bindings = len(sim_report.binding_log)
            rep.binding_log_sha256 = sim_report.binding_log_sha256
        return rep


# ---------------------------------------------------------------------------
# the scrape validators (torn-exposition check)
# ---------------------------------------------------------------------------

def validate_metrics_body(body: str) -> None:
    """Every sample line of a Prometheus exposition must parse — a torn
    scrape shows up as a half-written line or a non-numeric value."""
    for ln in body.splitlines():
        if not ln or ln.startswith("#"):
            continue
        name, _, value = ln.rpartition(" ")
        if not name:
            raise ValueError(f"torn metrics line: {ln!r}")
        float(value)  # ValueError on a torn value


def validate_timeline_body(body: str) -> None:
    from koordinator_tpu_torch.obs.timeline import load_bundle

    _header, _records, errors = load_bundle(body.splitlines())
    if errors:
        raise ValueError(f"timeline bundle errors: {errors[:3]}")


# ---------------------------------------------------------------------------
# the scenario runner
# ---------------------------------------------------------------------------

def racecheck_scenario(cycles: int = 24):
    """The smoke scenario with the concurrency features armed: pipeline
    overlap on, the dispatch watchdog armed (but un-fireable — see
    RACECHECK_DEADLINE_MS). Background warm-up and the compile cache
    come from the env, set by :func:`run_racecheck`."""
    from koordinator_tpu_torch.sim.scenarios import SCENARIOS

    sc = SCENARIOS["smoke"].resolved(cycles=cycles)
    return dataclasses.replace(
        sc, pipeline=True, dispatch_deadline_ms=RACECHECK_DEADLINE_MS)


def run_racecheck(preempt_seed: int = 0, cycles: int = 24,
                  scrape: bool = True, hooks=(),
                  scenario=None, device: str = "cuda") -> RaceReport:
    """Build + run one instrumented sim on ``device``; returns the
    :class:`RaceReport`.

    Env during the run: ``KOORD_TPU_WARMUP=background`` (the warm-up
    ladder races the first cycles for real) and a throwaway
    ``KOORD_TPU_COMPILE_CACHE_DIR`` (so the background ladder has an
    index to record into); both restored after, and so is the rung
    index's directory: the port's is not first-wins, and a later
    Scheduler in this process must not find the throwaway one."""
    with _throwaway_index() as cache_dir:
        return _run_instrumented(preempt_seed, cycles, scrape, hooks,
                                 scenario, device, cache_dir)


@contextlib.contextmanager
def _throwaway_index():
    cache_dir = tempfile.mkdtemp(prefix="koordrace-cache-")
    try:
        yield cache_dir
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def _run_instrumented(preempt_seed, cycles, scrape, hooks, scenario,
                      device, cache_dir) -> RaceReport:
    """One instrumented sim whose rung index lives in ``cache_dir``: a
    run over an index an earlier run recorded into has a background
    ladder that replays those rungs (on the card: kernel launches on the
    ladder's own CUDA stream) while its first cycles dispatch."""
    rc = RaceCheck(preempt_seed=preempt_seed)
    for pred, fn in hooks:
        rc.add_hook(pred, fn)
    sc = scenario if scenario is not None else racecheck_scenario(cycles)

    from koordinator_tpu_torch.scheduler import warmup as warmup_mod

    saved_env = {k: os.environ.get(k)
                 for k in ("KOORD_TPU_WARMUP", "KOORD_TPU_COMPILE_CACHE_DIR")}
    saved_index_dir = warmup_mod._configured_dir
    os.environ["KOORD_TPU_WARMUP"] = "background"
    os.environ["KOORD_TPU_COMPILE_CACHE_DIR"] = cache_dir

    scrape_errors: List[str] = []
    scrape_count = [0]
    stop = threading.Event()
    scrapers: List[threading.Thread] = []
    sim_report = None
    sim = None

    # imported before install: a module first imported under the harness
    # builds its import-time locks through the patched factories, and
    # they would stay proxies for the rest of the process; imported here,
    # the sweep wraps them for the run and uninstall() restores them
    from koordinator_tpu_torch.obs.server import ObsServer
    from koordinator_tpu_torch.ops import kernel_common  # noqa: F401
    from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
    from koordinator_tpu_torch.sim.harness import ChurnSimulator

    rc.install()
    try:
        sim = ChurnSimulator(sc, device=device)
        srv = ObsServer(scheduler_metrics.REGISTRY, sim.sched.tracer,
                        health_provider=sim.sched.health_snapshot,
                        flight=sim.sched.flight,
                        timeline=sim.sched.timeline, slo=sim.slo)

        def scraper(path: str, validate) -> None:
            while not stop.is_set():
                try:
                    status, _ctype, body = srv.handle(path)
                    if status != 200:
                        raise ValueError(f"{path} -> {status}")
                    validate(body)
                    scrape_count[0] += 1
                except Exception as exc:  # any tear is a failure
                    scrape_errors.append(f"{path}: {exc!r}")
                    return
                time.sleep(0.0005)

        if scrape:
            for path, validate in (("/metrics", validate_metrics_body),
                                   ("/debug/timeline",
                                    validate_timeline_body)):
                t = threading.Thread(target=scraper, args=(path, validate),
                                     name=f"koordrace-scrape{path}",
                                     daemon=True)
                scrapers.append(t)
                t.start()

        sim_report = sim.run()
    finally:
        stop.set()
        for t in scrapers:
            t.join(timeout=10.0)
        try:
            # the background ladder may still be recording rungs into
            # the throwaway cache dir — join it before the caller's
            # rmtree yanks the directory out from under its index writes
            warmup_mod._join_live_ladders()
        except Exception as e:
            # cleanup is best-effort: a ladder that refuses to join only
            # risks a benign FileNotFoundError from the caller's rmtree
            print(f"racecheck: warm-up join skipped: {e!r}",
                  file=sys.stderr)
        rc.uninstall()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        warmup_mod._configured_dir = saved_index_dir

    rep = rc.report(sim_report=sim_report, scrapes=scrape_count[0],
                    scrape_errors=scrape_errors)
    if sim is not None and sim.sched.warmup is not None:
        rep.warmup = dict(sim.sched.warmup.stats)
    return rep


# ---------------------------------------------------------------------------
# the gate: two preemption seeds plus the static/dynamic agreement check
# ---------------------------------------------------------------------------

RACE_RULES = ("unguarded-shared-field", "lock-order-inversion",
              "blocking-call-under-lock")


def static_race_findings():
    """The static half, in-process: the three race rules over the port's
    tree, no baseline. One process (``jobs=1``): the gate never forks a
    worker pool while the card's context, the watchdog's worker or the
    warm-up thread may still be live."""
    from koordinator_tpu_torch.analysis.core import analyze_paths

    findings = analyze_paths([os.path.join(_repo_root(), _PACKAGE)], jobs=1)
    return [f for f in findings if f.rule in RACE_RULES]


@dataclasses.dataclass
class RaceGate:
    """The gate's verdict: one :class:`RaceReport` per seed, the static
    race findings, and every failure as a line of text."""

    reports: List[RaceReport]
    static: list
    failures: List[str]

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> dict:
        return {"ok": self.ok,
                "reports": [r.to_dict() for r in self.reports],
                "static": [{"path": f.path, "line": f.line,
                            "rule": f.rule, "message": f.message}
                           for f in self.static],
                "failures": list(self.failures)}


def gate_failures(reports: List[RaceReport], static) -> List[str]:
    """Every failure class of the gate: a witness, an order inversion, a
    torn scrape, zero touches, binding logs that differ between seeds, a
    static race finding, and a witness the static map did not flag."""
    failures: List[str] = []
    for rep in reports:
        seed = rep.preempt_seed
        for w in rep.witnesses[:10]:
            failures.append(
                f"seed {seed}: unguarded touch {w['path']}:{w['line']} "
                f"{w['owner']}.{w['field']} (guard {w['guard']}, "
                f"thread {w['thread']})")
        for v in rep.order_violations[:10]:
            failures.append(
                f"seed {seed}: lock-order inversion: acquired "
                f"{v['acquired']} while holding {v['held']} "
                f"(thread {v['thread']})")
        for e in rep.scrape_errors[:10]:
            failures.append(f"seed {seed}: torn scrape: {e}")
        if rep.touches == 0:
            failures.append(
                f"seed {seed}: zero touchpoints observed — the harness "
                f"is not instrumenting (guard map empty or trace dead)")

    shas = {r.binding_log_sha256 for r in reports}
    if len(shas) > 1:
        failures.append(
            "binding log diverged across preemption seeds: "
            + ", ".join(f"seed {r.preempt_seed}={r.binding_log_sha256[:12]}"
                        for r in reports))

    for f in static[:10]:
        failures.append(
            f"static race finding (must be empty): {f.path}:{f.line} "
            f"[{f.rule}] {f.message}")
    static_sites = {(f.path, f.line) for f in static}
    for rep in reports:
        for w in rep.witnesses:
            if (w["path"], w["line"]) not in static_sites:
                failures.append(
                    f"DYNAMIC-ONLY witness (analyzer blind spot): "
                    f"{w['path']}:{w['line']} {w['owner']}.{w['field']}")
    return failures


def check_races(seeds: Tuple[int, ...] = (101, 202), cycles: int = 24,
                device: str = "cuda",
                waves: Optional[int] = None) -> RaceGate:
    """Run the instrumented smoke scenario once per preemption seed on
    ``device``, then the static half; the verdict is ``.ok`` and
    ``.failures``. The seeds share one throwaway rung index, so every
    seed after the first has a background ladder that replays the rungs
    recorded before it. ``waves`` sets the scenario's fused waves (None:
    the catalog's serial dispatch; at 2 or more the chained dispatch and
    the replay kernel run)."""
    sc = racecheck_scenario(cycles)
    if waves is not None:
        sc = dataclasses.replace(sc, waves=waves)
    with _throwaway_index() as cache_dir:
        reports = [_run_instrumented(seed, cycles, True, (), sc, device,
                                     cache_dir)
                   for seed in seeds]
    static = static_race_findings()
    return RaceGate(reports=reports, static=static,
                    failures=gate_failures(reports, static))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.sim.racecheck",
        description="deterministic interleaving race gate")
    ap.add_argument("--device", default="cuda",
                    help="the sim's device: cuda (default) or cpu")
    ap.add_argument("--cycles", type=int, default=24)
    ap.add_argument("--seeds", default="101,202",
                    help="comma-separated preemption seeds")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the gate's verdict as JSON")
    args = ap.parse_args(argv)
    seeds = tuple(int(s) for s in args.seeds.split(",") if s.strip())

    gate = check_races(seeds=seeds, cycles=args.cycles, device=args.device)
    for rep in gate.reports:
        print(f"check_races: seed={rep.preempt_seed} "
              f"bindings={rep.bindings} "
              f"sha={rep.binding_log_sha256[:12]} touches={rep.touches} "
              f"preemptions={rep.preemptions} scrapes={rep.scrapes} "
              f"unchecked={rep.unchecked} witnesses={len(rep.witnesses)} "
              f"order_violations={len(rep.order_violations)} "
              f"scrape_errors={len(rep.scrape_errors)}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(gate.to_dict(), f, indent=2, sort_keys=True)
    if not gate.ok:
        print("check_races: FAIL", file=sys.stderr)
        for msg in gate.failures:
            print(f"  {msg}", file=sys.stderr)
        return 1
    print(f"check_races: OK ({len(seeds)} seeds, binding log "
          f"{gate.reports[0].binding_log_sha256[:12]} byte-stable)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
