"""koordwatch device timeline: the cross-consumer device-window record.

Three consumers serialize around one device — the scheduler's dispatch
kernels, the koordbalance rebalance pass, and the koordcolo control-plane
pass all upload through the same DeviceSnapshot — but until now nothing
recorded HOW they shared it: the idle gaps between consecutive windows
are exactly what the ROADMAP's host-tail and koordbalance-overlap items
promise to close, and without a timeline those items cannot be measured
before or after.

The :class:`DeviceTimeline` keeps a bounded, lock-guarded ring of
device-window records — consumer (scheduler/rebalance/colo), path
(serial/fused/chained/mesh), dispatch->last-sync wall interval, outcome
(clean/retried/demoted/deadline) — written from ``scheduler/cycle.py``'s
dispatch windows, ``balance/rebalancer.py`` and ``colo/reconciler.py``.
Each window mints a ``decision_id`` (``<consumer>-<seq>``, deterministic:
no wall clock or randomness in the id, so seeded runs stay byte-stable)
that the owners stamp through their closed loops — kernel spans, flight
records, migration-job -> Reservation annotations — so records can be
joined across the scheduler, descheduler and manager.

Exported surfaces:

  * ``koord_device_window_seconds{consumer,path}`` histogram +
    ``koord_device_idle_fraction`` gauge (gap time between consecutive
    windows over wall) — injected by the owner, the flight-recorder
    ``dump_counter`` pattern: this module never imports a registry;
  * ``/debug/timeline`` on every ObsServer serves the ring as a JSONL
    bundle (header line + one line per window, oldest first);
  * ``load_bundle`` reads and validates a bundle; the schema is the JAX
    package's, exactly like the trace and flight schemas.

Thread discipline (koordlint's concurrency rules gate this package): the
ring and the idle accumulators are lock-guarded — consumers record from
their own threads while the ObsServer thread exports.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

TIMELINE_SCHEMA_VERSION = 1
TIMELINE_SCHEMA_NAME = "koordwatch-timeline"

WINDOW_OUTCOMES = ("clean", "retried", "demoted", "deadline")
WINDOW_PATHS = ("serial", "fused", "chained", "mesh")


def watch_from_env() -> bool:
    """KOORD_TPU_WATCH=0 turns koordwatch off: the device-timeline ring
    stops recording and the demotion chokepoint stops accounting (ids
    keep minting so decision correlation stays wired). Default on — the
    bench A/B pair (koordwatch_overhead_pct) pins the cost ≤ ~2%. THE
    canonical read: the scheduler, the standalone rebalancer and the
    standalone colo reconciler all consult this one helper, so the kill
    switch covers every consumer's ring."""
    import os

    return os.environ.get("KOORD_TPU_WATCH", "1") != "0"


class DeviceWindow:
    """One in-flight device window: minted at ``open()``, stamped at the
    actual dispatch (``mark_dispatch``, re-stamped by ladder retries so
    the recorded interval is the SUCCESSFUL attempt's dispatch->sync
    wall), appended to the ring at ``close()``. A window that never
    completes (ladder exhausted, cycle exception) is simply dropped —
    the flight recorder owns failure records."""

    __slots__ = ("decision_id", "consumer", "path", "ts", "start_mono")

    def __init__(self, decision_id: str, consumer: str, path: str) -> None:
        self.decision_id = decision_id
        self.consumer = consumer
        self.path = path
        self.ts = time.time()
        self.start_mono = time.perf_counter()

    def mark_dispatch(self, path: Optional[str] = None) -> None:
        """Stamp the dispatch instant (and the effective path — a ladder
        demotion mid-pass can move mesh -> serial between attempts)."""
        if path is not None:
            self.path = path
        self.ts = time.time()
        self.start_mono = time.perf_counter()


class DeviceTimeline:
    """Bounded ring of device-window records + the idle accounting.

    ``window_histogram`` (labels consumer, path) and ``idle_gauge`` are
    optional injected metrics. ``enabled=False`` (the koordwatch kill
    switch / bench A/B off-world) turns ``close()`` into a no-op while
    ``mint()``/``open()`` keep handing out deterministic ids, so the
    decision-correlation plumbing never goes None-shaped."""

    def __init__(self, capacity: int = 512, window_histogram=None,
                 idle_gauge=None, enabled: bool = True) -> None:
        self._lock = threading.Lock()
        self._ring = deque(maxlen=capacity)
        self._seq = 0            # decision ids minted
        self._windows_total = 0  # windows ever closed (wraparound-visible)
        self.enabled = enabled
        self.window_histogram = window_histogram
        self.idle_gauge = idle_gauge
        # idle accounting: gap time between consecutive windows over the
        # wall interval first-start .. last-end (all monotonic)
        self._first_start: Optional[float] = None
        self._last_end: Optional[float] = None
        self._gap_total = 0.0

    # -- write side ------------------------------------------------------
    def mint(self, consumer: str) -> str:
        """A fresh decision id (``<consumer>-<seq>``). Deterministic per
        process history — seeded sim runs mint identical id sequences."""
        with self._lock:
            self._seq += 1
            return f"{consumer}-{self._seq}"

    def open(self, consumer: str, path: str) -> DeviceWindow:
        return DeviceWindow(self.mint(consumer), consumer, path)

    def close(self, window: DeviceWindow, outcome: str,
              end_mono: Optional[float] = None) -> Optional[dict]:
        """Complete a window: append the record, feed the histogram and
        the idle-fraction gauge. Returns the record (None when
        disabled)."""
        if not self.enabled:
            return None
        end = time.perf_counter() if end_mono is None else end_mono
        duration = max(0.0, end - window.start_mono)
        with self._lock:
            if self._first_start is None:
                self._first_start = window.start_mono
                gap = 0.0
            else:
                gap = max(0.0, window.start_mono - self._last_end)
                self._gap_total += gap
            self._last_end = (end if self._last_end is None
                              else max(self._last_end, end))
            wall = self._last_end - self._first_start
            idle = self._gap_total / wall if wall > 0 else 0.0
            self._windows_total += 1
            record = {
                "v": TIMELINE_SCHEMA_VERSION,
                "kind": "window",
                "seq": self._windows_total,
                "decision_id": window.decision_id,
                "consumer": window.consumer,
                "path": window.path,
                "outcome": outcome,
                "ts": float(window.ts),
                "duration_ms": duration * 1000.0,
                "gap_ms": gap * 1000.0,
            }
            self._ring.append(record)
        if self.window_histogram is not None:
            self.window_histogram.observe(
                duration, consumer=window.consumer, path=window.path)
        if self.idle_gauge is not None:
            self.idle_gauge.set(idle)
        return record

    # -- read side -------------------------------------------------------
    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def idle_fraction(self) -> float:
        with self._lock:
            if self._first_start is None or self._last_end is None:
                return 0.0
            wall = self._last_end - self._first_start
            return self._gap_total / wall if wall > 0 else 0.0

    def export_jsonl(self) -> str:
        """The ``/debug/timeline`` body: header line + one line per
        window, oldest first — the bundle shape ``load_bundle`` below
        (and the ``obs timeline`` CLI) validates."""
        records = self.snapshot()
        header = {
            "v": TIMELINE_SCHEMA_VERSION,
            "kind": "header",
            "schema": TIMELINE_SCHEMA_NAME,
            "dumped_at": time.time(),
            "windows": len(records),
            "idle_fraction": self.idle_fraction(),
        }
        lines = [json.dumps(header, sort_keys=True)]
        lines.extend(json.dumps(r, sort_keys=True) for r in records)
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# bundle schema (the hack/lint.sh golden-fixture contract)
# ---------------------------------------------------------------------------


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_header(obj) -> List[str]:
    """Schema check for the bundle's first line."""
    if not isinstance(obj, dict):
        return ["header is not a JSON object"]
    errs: List[str] = []
    if obj.get("v") != TIMELINE_SCHEMA_VERSION:
        errs.append(f"v must be {TIMELINE_SCHEMA_VERSION}, "
                    f"got {obj.get('v')!r}")
    if obj.get("kind") != "header":
        errs.append(f"kind must be 'header', got {obj.get('kind')!r}")
    if obj.get("schema") != TIMELINE_SCHEMA_NAME:
        errs.append(f"schema must be {TIMELINE_SCHEMA_NAME!r}, "
                    f"got {obj.get('schema')!r}")
    if not _is_num(obj.get("dumped_at")) or obj.get("dumped_at") < 0:
        errs.append(f"dumped_at must be a non-negative number, "
                    f"got {obj.get('dumped_at')!r}")
    if not isinstance(obj.get("windows"), int) or isinstance(
            obj.get("windows"), bool) or obj.get("windows") < 0:
        errs.append(f"windows must be a non-negative int, "
                    f"got {obj.get('windows')!r}")
    idle = obj.get("idle_fraction")
    if not _is_num(idle) or idle < 0:
        errs.append(f"idle_fraction must be a non-negative number, "
                    f"got {idle!r}")
    return errs


def validate_window_record(obj) -> List[str]:
    """Schema check for one window line."""
    if not isinstance(obj, dict):
        return ["record is not a JSON object"]
    errs: List[str] = []
    if obj.get("v") != TIMELINE_SCHEMA_VERSION:
        errs.append(f"v must be {TIMELINE_SCHEMA_VERSION}, "
                    f"got {obj.get('v')!r}")
    if obj.get("kind") != "window":
        errs.append(f"kind must be 'window', got {obj.get('kind')!r}")
    if not isinstance(obj.get("seq"), int) or isinstance(
            obj.get("seq"), bool) or obj.get("seq") < 0:
        errs.append(f"seq must be a non-negative int, got {obj.get('seq')!r}")
    for key in ("decision_id", "consumer"):
        if not isinstance(obj.get(key), str) or not obj.get(key):
            errs.append(f"{key} must be a non-empty string, "
                        f"got {obj.get(key)!r}")
    if obj.get("path") not in WINDOW_PATHS:
        errs.append(f"path must be one of {WINDOW_PATHS}, "
                    f"got {obj.get('path')!r}")
    if obj.get("outcome") not in WINDOW_OUTCOMES:
        errs.append(f"outcome must be one of {WINDOW_OUTCOMES}, "
                    f"got {obj.get('outcome')!r}")
    for key in ("ts", "duration_ms", "gap_ms"):
        if not _is_num(obj.get(key)) or obj.get(key) < 0:
            errs.append(f"{key} must be a non-negative number, "
                        f"got {obj.get(key)!r}")
    return errs


def load_bundle(lines) -> Tuple[Optional[dict], List[dict], List[str]]:
    """Parse + validate a timeline bundle; returns (header, windows,
    errors). The contract ``hack/lint.sh`` pins against the golden
    fixture: any error-list growth is schema drift and must be a
    conscious version bump."""
    from koordinator_tpu_torch.obs import load_jsonl_bundle

    return load_jsonl_bundle(lines, validate_header=validate_header,
                             validate_record=validate_window_record,
                             count_key="windows")
