"""The warm-up ladder for cold start, and its persistent rung index.

Cold start is a production outage in miniature: a restarted scheduler pays
every first-call cost before its first bind. On the card those costs are
the kernel library's load (``ctypes`` over the nvcc build, whose output
directory is already persistent and keyed by source digest:
ops/kernel_common.py), each kernel's shared-memory and cluster attributes,
the first launch of every torch operation the steps run, and the caching
allocator's growth to the round's working set. The first kernel call of a
process takes most of a second, against tens of milliseconds warm.

  1. **The rung index** — ``KOORD_TPU_COMPILE_CACHE_DIR`` names a directory
     in which every step build the Scheduler (and the rebalance and
     colo passes) performs is recorded in a small JSON index: the step
     metadata (padded-shape signature, explain mode, wave depth, side
     tags) plus the call arguments' shape/dtype spec and the **program
     fingerprint**. There is no compiled program to keep, so
     :func:`configure_compile_cache` only validates and creates the
     directory. The index file has the port's own name
     (``INDEX_NAME``): the JAX package keeps its own index in the same
     directory and purges entries of other fingerprints on each write, so
     the two must never share a file.

  2. **The warm-up ladder** (:class:`WarmupRunner`) — a restarted
     scheduler replays the index at startup: it rebuilds each rung
     through the SAME keyed step caches (``Scheduler._get_step`` /
     ``_get_fused_step`` / ``_get_chain_step``) and calls it once on
     zero-filled, bucket-shaped tensors on the scheduler's device, so the
     first real cycle's step lookup is an in-memory HIT and the first-call
     costs above were paid off the first pod's path (synchronously in
     construction, or in the background on its own CUDA stream). A zero
     call touches no DeviceSnapshot and no carried state: its inputs are
     its own, and padding rows are inert in every step.

Fingerprint discipline: entries are keyed by :func:`program_fingerprint`
(a hash over the port's kernel and model sources;
``KOORD_TPU_PROGRAM_FINGERPRINT`` overrides it). A fingerprint change
invalidates every recorded rung — warm-up skips them (counted
``invalidated``) and the next write purges them. A corrupted or truncated
index loads as empty; warm-up never crashes the scheduler: a rung that
fails is counted ``failed`` and the on-demand build takes over.

Observability: ``koord_scheduler_warmup_*`` metrics (rungs by outcome,
wall seconds, the completion gauge) and a ``warmup`` span tree with one
``rung`` child per replayed entry. After warm-up completes the owner flips
into *steady state*: any further step-cache miss in the hot path is
flagged (``koord_scheduler_steady_state_compiles_total`` and the owner's
``compile_miss_hook``).

A copy of the JAX package's scheduler/warmup.py in PyTorch idiom. Warm-up
never moves a decision: bindings with warm-up on and off are identical
(tests/test_torch_warmup.py).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

INDEX_VERSION = 1
# the port's own index file: the JAX package's koord_warmup_index.json may
# sit in the same directory, and each package purges the other
# fingerprints' entries from its own index on every write
INDEX_NAME = "koord_torch_warmup_index.json"

# warm-up replay call-arg reconstruction: the namedtuple classes a recorded
# spec may reference (lazy import targets)
_NT_REGISTRY = {
    "FullChainInputs": ("koordinator_tpu_torch.models.full_chain",
                        "FullChainInputs"),
    "ScheduleInputs": ("koordinator_tpu_torch.models.scheduler_model",
                       "ScheduleInputs"),
    "WaveSideInputs": ("koordinator_tpu_torch.models.fused_waves",
                       "WaveSideInputs"),
    "ProdSides": ("koordinator_tpu_torch.models.fused_waves", "ProdSides"),
    "ClaimSides": ("koordinator_tpu_torch.models.fused_waves", "ClaimSides"),
    "ResSides": ("koordinator_tpu_torch.models.fused_waves", "ResSides"),
}

# sources the default fingerprint hashes: what the steps run is determined
# by these (kernel sources, wave state layout, the passes' bodies) plus the
# shape metadata the index records
_FINGERPRINT_PACKAGES = ("csrc", "ops", "models", "balance", "colo")
_FINGERPRINT_SUFFIXES = (".py", ".cu", ".cuh")


def compile_cache_dir_from_env() -> Optional[str]:
    """KOORD_TPU_COMPILE_CACHE_DIR=<dir> arms the rung index; unset or
    empty keeps it off (the deterministic default for tests)."""
    raw = os.environ.get("KOORD_TPU_COMPILE_CACHE_DIR", "").strip()
    return raw or None


def warmup_mode_from_env() -> str:
    """KOORD_TPU_WARMUP=off|sync|background ("auto" = background when a
    cache dir is configured, else off). sync runs the ladder inside
    Scheduler construction — what the restart gates use, so
    restart-to-first-bind includes the whole warm-up and the steady-state
    guard arms deterministically."""
    raw = os.environ.get("KOORD_TPU_WARMUP", "auto").strip().lower()
    if raw in ("auto", ""):
        return "auto"
    if raw in ("0", "off", "false", "no"):
        return "off"
    if raw in ("sync", "1", "on", "true"):
        return "sync" if raw == "sync" else "background"
    if raw == "background":
        return "background"
    logger.warning("KOORD_TPU_WARMUP=%r unknown; warm-up stays off", raw)
    return "off"


_configured_dir: Optional[str] = None


def configure_compile_cache(dir_path: Optional[str] = None) -> Optional[str]:
    """Arm the rung index at ``dir_path`` (default: the env knob): the
    directory is created if missing and must be a writable directory.
    There is no compiled-program cache to point anywhere, so nothing else
    is process-global; the most recent directory is the one the rebalance
    and colo passes record into. Returns the effective dir, or None when
    the index stays off."""
    global _configured_dir
    want = dir_path if dir_path is not None else compile_cache_dir_from_env()
    if want is None:
        return _configured_dir
    want = os.path.abspath(want)
    os.makedirs(want, exist_ok=True)
    if not os.access(want, os.W_OK):
        raise PermissionError(f"compile cache dir {want} is not writable")
    _configured_dir = want
    return want


_fingerprint_cache: Optional[str] = None


def program_fingerprint() -> str:
    """The code-version key for index entries.
    ``KOORD_TPU_PROGRAM_FINGERPRINT`` pins it (deploy pipelines, and the
    invalidation tests' simulated version bump); the default hashes the
    port's kernel, op and model sources, so editing a kernel or a wave body
    invalidates every recorded rung without any manual bump."""
    env = os.environ.get("KOORD_TPU_PROGRAM_FINGERPRINT", "").strip()
    if env:
        return env
    global _fingerprint_cache
    if _fingerprint_cache is not None:
        return _fingerprint_cache
    h = hashlib.sha256()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for pkg in _FINGERPRINT_PACKAGES:
        pkg_dir = os.path.join(root, pkg)
        if not os.path.isdir(pkg_dir):
            continue
        for name in sorted(os.listdir(pkg_dir)):
            if not name.endswith(_FINGERPRINT_SUFFIXES):
                continue
            h.update(f"{pkg}/{name}".encode())
            try:
                with open(os.path.join(pkg_dir, name), "rb") as f:
                    h.update(f.read())
            except OSError:
                continue
    _fingerprint_cache = h.hexdigest()[:32]
    return _fingerprint_cache


# ---------------------------------------------------------------------------
# call-argument shape specs (recorded at build time, replayed as zeros)
# ---------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    """'float32' for torch.float32 and for numpy's float32 alike."""
    return str(dtype).rsplit(".", 1)[-1]


def aval_spec(obj):
    """JSON-able (shape, dtype) tree of one call argument. Handles what
    the dispatch sites pass: namedtuples (registered in ``_NT_REGISTRY``),
    plain tuples/lists (the wave carry), ``None`` slots (feature-absent
    subtrees), tensors and arrays, and scalars. Python and numpy scalars
    are recorded BY VALUE (the ``n_real`` operand must replay with a
    concrete value)."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, bool):
        return {"t": "v", "v": bool(obj)}
    if isinstance(obj, (int, float)):
        return {"t": "v", "v": obj}
    if isinstance(obj, np.generic):
        return {"t": "np", "v": obj.item(), "d": str(obj.dtype)}
    fields = getattr(obj, "_fields", None)
    if fields is not None:
        # a subclass (the uploaded round's PackedInputs) replays as the
        # registered namedtuple it extends: its extras are per-cycle data
        name = next((c.__name__ for c in type(obj).__mro__
                     if c.__name__ in _NT_REGISTRY), type(obj).__name__)
        if name not in _NT_REGISTRY:
            raise TypeError(f"unregistered namedtuple {name!r} in aval spec")
        return {"t": "nt", "c": name,
                "f": [aval_spec(getattr(obj, f)) for f in fields]}
    if isinstance(obj, (tuple, list)):
        return {"t": "tuple", "i": [aval_spec(v) for v in obj]}
    shape = getattr(obj, "shape", None)
    dtype = getattr(obj, "dtype", None)
    if shape is not None and dtype is not None:
        return {"t": "a", "s": [int(d) for d in shape],
                "d": _dtype_name(dtype)}
    raise TypeError(f"unsupported aval-spec value {type(obj).__name__}")


def zeros_from_spec(spec, device="cpu"):
    """Rebuild one call argument from its spec as zero-filled tensors on
    ``device`` (padding-row semantics: every step masks invalid rows, so a
    zero world runs the same launches and converges at once)."""
    import torch

    t = spec["t"]
    if t == "none":
        return None
    if t == "v":
        return spec["v"]
    if t == "np":
        return np.dtype(spec["d"]).type(spec["v"])
    if t == "a":
        return torch.zeros(tuple(spec["s"]), dtype=getattr(torch, spec["d"]),
                           device=device)
    if t == "tuple":
        return tuple(zeros_from_spec(s, device) for s in spec["i"])
    if t == "nt":
        import importlib

        mod_name, cls_name = _NT_REGISTRY[spec["c"]]
        cls = getattr(importlib.import_module(mod_name), cls_name)
        return cls(*(zeros_from_spec(s, device) for s in spec["f"]))
    raise ValueError(f"bad aval spec {t!r}")


# ---------------------------------------------------------------------------
# the persistent rung index
# ---------------------------------------------------------------------------

# process-wide: CompileCacheIndex instances are constructed per record
# call, so a per-instance lock would never exclude anyone — recorders in
# one process serialize here (cross-process writers are last-writer-wins
# on the atomic rename, which can drop a concurrent rung but can never
# corrupt the file: every writer renames its OWN unique tmp)
_index_lock = threading.Lock()  # koordlint: guards(rung-index-file)


class CompileCacheIndex:
    """The warm-up rung index in the cache directory.

    One JSON file, atomically rewritten (unique tmp + rename) on every
    ``record``; entries dedupe on (kind, meta) and carry the recording
    fingerprint. A corrupted, truncated or absent file loads as EMPTY."""

    def __init__(self, dir_path: str) -> None:
        # immutable after construction; only the index FILE needs the lock
        self.path = os.path.join(dir_path, INDEX_NAME)  # koordlint: guarded-by(none)
        self._lock = _index_lock

    def load(self) -> Dict[str, dict]:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(data, dict) or data.get("v") != INDEX_VERSION:
            return {}
        entries = data.get("entries")
        return entries if isinstance(entries, dict) else {}

    @staticmethod
    def entry_key(kind: str, meta: dict) -> str:
        return hashlib.sha256(
            json.dumps([kind, meta], sort_keys=True).encode()
        ).hexdigest()[:24]

    def record(self, kind: str, meta: dict, args_spec: List[dict]) -> None:
        """Merge one rung; stale-fingerprint entries are purged on the
        same write (a version bump leaves no replayable residue)."""
        fp = program_fingerprint()
        with self._lock:
            entries = self.load()
            entries = {k: e for k, e in entries.items()
                       if isinstance(e, dict) and e.get("fp") == fp}
            entries[self.entry_key(kind, meta)] = {
                "kind": kind, "meta": meta, "args": args_spec, "fp": fp,
            }
            import tempfile

            fd, tmp = tempfile.mkstemp(
                prefix=INDEX_NAME + ".", suffix=".tmp",
                dir=os.path.dirname(self.path))
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump({"v": INDEX_VERSION, "entries": entries},
                              f, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise


def record_step_compile(kind: str, meta: dict, args: Tuple,
                        dir_path: Optional[str] = None) -> bool:
    """Record one freshly built step rung into ``dir_path``'s index
    (default: the configured dir; a no-op when none is). Never raises:
    recording is for the NEXT process — a bad entry must not cost this
    one its dispatch."""
    dir_path = dir_path if dir_path is not None else _configured_dir
    if dir_path is None:
        return False
    try:
        CompileCacheIndex(dir_path).record(
            kind, meta, [aval_spec(a) for a in args])
        return True
    except Exception:
        logger.exception("compile-cache index record failed (kind=%s)",
                         kind)
        return False


# ---------------------------------------------------------------------------
# the warm-up ladder
# ---------------------------------------------------------------------------

# ladders serialize process-wide: two schedulers warming at once would only
# contend for the same card, and the atexit join below must have a bounded
# set to wait on
_ladder_lock = threading.Lock()
# koordlint: guarded-by(_ladder_lock)
_live_threads: List[threading.Thread] = []
_atexit_registered = False


def _join_live_ladders() -> None:
    """Interpreter-exit guard: give outstanding background ladders a
    bounded window to finish their zero calls before the runtime unwinds
    (a daemon thread killed inside a CUDA launch can abort the process in
    native teardown). The ladder lock is held for a whole run(), so taking
    it here would turn the bounded join into an unbounded wait — the bare
    snapshot is a list() copy (atomic under the GIL) of threads only ever
    appended before start; the pragma records that deliberate exception."""
    for t in list(_live_threads):  # koordlint: disable=unguarded-shared-field
        t.join(timeout=30.0)


class WarmupRunner:
    """Replay the recorded rung index against a fresh Scheduler.

    Scheduler rungs (serial/fused/chain) rebuild through the SAME keyed
    ``_get_*step`` chokepoints — populating the in-memory step cache under
    the exact production keys — then call the step once on zero-filled
    tensors of the recorded shapes on the scheduler's device. Rebalance
    and colo rungs replay through their build functions (those passes own
    separate step caches, so the value there is the first-call costs paid).

    Every rung runs inside try/except — a corrupted entry or a failed zero
    call counts as ``failed`` and warm-up continues.

    Mesh discipline: a rung recorded under a mesh shard-id tuple replays
    only when the scheduler's CURRENT placement matches (two same-size
    submeshes never share a step); mismatches count as ``skipped``. Mesh
    rungs are build-only (``built``): the build through the keyed
    chokepoint pre-populates the step cache, and the first dispatch on
    the mesh pays its kernels' first calls, as the JAX package's mesh
    rungs leave their compile to the first dispatch."""

    def __init__(self, scheduler, background: bool = False) -> None:
        from koordinator_tpu_torch.obs import Tracer

        self.scheduler = scheduler
        self.background = background
        # own tracer: the background ladder must not interleave spans into
        # the cycle thread's ring mid-cycle
        self.tracer = Tracer()
        self.stats = {"rungs": 0, "warmed": 0, "built": 0, "skipped": 0,
                      "failed": 0, "invalidated": 0, "seconds": 0.0,
                      "complete": False}
        self._thread: Optional[threading.Thread] = None

    # -- rung replay ----------------------------------------------------
    def _replay_scheduler_rung(self, entry: dict):
        sched = self.scheduler
        meta = entry["meta"]
        if tuple(meta.get("mesh_tag", ())) != sched._mesh_tag():
            return "skipped"
        # config the step structure bakes in must match THIS scheduler, or
        # the recorded specs describe a different carry (a co-resident
        # scheduler with another prod/transformer config recorded the
        # rung): skip, never trip
        if "prod" in meta and meta["prod"] != bool(
                sched.args.score_according_prod_usage):
            return "skipped"
        if "score_tag" in meta and [
                [name, int(epoch)]
                for name, epoch in sched._score_pass_tag()
        ] != meta["score_tag"]:
            return "skipped"
        kind = entry["kind"]
        signature = tuple(meta["signature"])
        active = list(meta["active"])
        explain = meta.get("explain")
        if kind == "serial":
            step = sched._get_step(signature, meta["ng"], meta["ngroups"],
                                   active, explain=explain)
        elif kind == "fused":
            step = sched._get_fused_step(
                signature, meta["ng"], meta["ngroups"], active,
                meta["waves"], explain=explain,
                sides_tag=tuple(meta["sides_tag"]))
        elif kind == "chain":
            step = sched._get_chain_step(
                signature, meta["ng"], meta["ngroups"], active,
                explain=explain, sides_tag=tuple(meta["sides_tag"]))
        else:
            return "skipped"
        if meta.get("mesh_tag"):
            return "built"
        self._zero_call(step, entry)
        return "warmed"

    def _replay_standalone_rung(self, entry: dict):
        """Rebalance/colo rungs, through their build functions on the
        scheduler's device; single-device only (a mesh build needs the
        live mesh of the process that recorded it)."""
        meta = entry["meta"]
        if tuple(meta.get("mesh_tag", ())):
            return "skipped"
        device = self.scheduler.device
        kwargs = {}
        if entry["kind"] == "rebalance":
            from koordinator_tpu_torch.balance.step import (
                build_rebalance_step,
            )

            step = build_rebalance_step(meta["cap"], device=device)
        elif entry["kind"] == "colo":
            from koordinator_tpu_torch.colo.step import build_colo_step

            step = build_colo_step(meta["policies"][0], meta["policies"][1],
                                   device=device)
            kwargs["plan"] = tuple(meta["plan"])
        else:
            return "skipped"
        self._zero_call(step, entry, **kwargs)
        return "warmed"

    def _zero_call(self, step, entry: dict, **kwargs) -> None:
        import torch

        device = self.scheduler.device
        t0 = time.perf_counter()
        if device.type == "cuda":
            # its own stream: a background ladder's launches never queue
            # behind (or in front of) a cycle's on the current stream
            if device.index is not None:
                torch.cuda.set_device(device)
            stream = torch.cuda.Stream(device)
            with torch.cuda.stream(stream):
                args = tuple(zeros_from_spec(s, device)
                             for s in entry["args"])
                step(*args, **kwargs)
            # startup-time ladder, not a dispatch window: a hung card
            # surfaces at process start instead of wedging a cycle, and
            # the background mode keeps it off the bind path entirely
            # koordlint: disable=naked-device-sync-without-deadline
            stream.synchronize()
        else:
            args = tuple(zeros_from_spec(s, device) for s in entry["args"])
            step(*args, **kwargs)
        # the ladder's first calls are compile wall: the restart report's
        # compile/pack split attributes warm-up to compile
        self.scheduler._add_compile_wall(time.perf_counter() - t0)

    # -- the ladder -----------------------------------------------------
    def run(self) -> dict:
        from koordinator_tpu_torch.scheduler import (
            metrics as scheduler_metrics,
        )

        sched = self.scheduler
        t0 = time.perf_counter()
        fp = program_fingerprint()
        entries: Dict[str, dict] = {}
        if sched.compile_cache_dir is not None:
            entries = CompileCacheIndex(sched.compile_cache_dir).load()
        with self.tracer.span("warmup", rungs=str(len(entries))):
            for key in sorted(entries):
                entry = entries[key]
                self.stats["rungs"] += 1
                if not isinstance(entry, dict) or entry.get("fp") != fp:
                    # another code version's shapes: never replay them; the
                    # next record purges them
                    self.stats["invalidated"] += 1
                    scheduler_metrics.WARMUP_RUNGS.inc(outcome="invalidated")
                    continue
                kind = entry.get("kind", "")
                with self.tracer.span("rung", kind=kind, key=key):
                    try:
                        if kind in ("serial", "fused", "chain"):
                            outcome = self._replay_scheduler_rung(entry)
                        else:
                            outcome = self._replay_standalone_rung(entry)
                    except Exception:
                        # a wrecked rung (stale spec, a step that refuses
                        # zeros) falls back to the on-demand build —
                        # warm-up NEVER crashes the scheduler
                        logger.exception("warm-up rung failed (%s)", kind)
                        outcome = "failed"
                self.stats[outcome] += 1
                scheduler_metrics.WARMUP_RUNGS.inc(outcome=outcome)
        self.stats["seconds"] = time.perf_counter() - t0
        self.stats["complete"] = True
        scheduler_metrics.WARMUP_SECONDS.set(self.stats["seconds"])
        sched.note_warmup_complete(self.stats)
        return self.stats

    def start(self) -> None:
        if not self.background:
            with _ladder_lock:
                self.run()
            return
        global _atexit_registered
        if not _atexit_registered:
            import atexit

            atexit.register(_join_live_ladders)
            _atexit_registered = True
        self._thread = threading.Thread(
            target=self._run_guarded, name="koord-warmup", daemon=True)
        with _ladder_lock:
            _live_threads.append(self._thread)
        self._thread.start()

    def _run_guarded(self) -> None:
        try:
            with _ladder_lock:
                self.run()
        except Exception:  # the ladder is best-effort by contract
            logger.exception("warm-up ladder failed")
        finally:
            try:
                with _ladder_lock:
                    _live_threads.remove(self._thread)
            except ValueError:  # pragma: no cover - defensive
                pass

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
