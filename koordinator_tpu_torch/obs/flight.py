"""koordexplain cycle flight recorder: the last N scheduling cycles, dumpable.

A bad cycle — a parity mismatch, a deadline overrun, an unhandled
exception — used to leave nothing behind to debug from: the tracer ring
has timings but no decisions, the store has outcomes but no attribution.
The flight recorder keeps a bounded, lock-guarded ring of per-cycle
DECISION records (bind/fail/reject lists with koordexplain attribution,
the cycle's span tree, metric deltas, wave count) and serializes it as a
schema-validated JSONL bundle on trigger:

  * cycle deadline overrun (``KOORD_TPU_CYCLE_DEADLINE_MS``)
  * unhandled cycle exception (the driver records the wreck, dumps, re-raises)
  * pipeline/fused-wave parity mismatch (scheduler/pipeline_parity.py)
  * on demand: ``POST /debug/flightrecorder`` on the ObsServer, or
    ``FlightRecorder.dump()`` directly

Bundle format: line 1 is a header record, every further line one cycle
record, newest last; ``load_bundle`` reads and validates one. The schema
is the JAX package's, so its tools render the port's bundles unchanged.

Thread discipline (koordlint's concurrency rules gate this package): the
ring and dump counters are lock-guarded — the scheduler thread records
while the ObsServer thread dumps.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.obs import validate_record as validate_span_record

FLIGHT_SCHEMA_VERSION = 1
FLIGHT_SCHEMA_NAME = "koordexplain-flight"

# cycle-record list fields whose entries must be {"pod": str, ...} objects
_POD_LIST_FIELDS = ("bound", "failed", "rejected")


class FlightRecorder:
    """Bounded ring of cycle decision records + triggered bundle dumps.

    ``dump_dir`` (default: the ``KOORD_TPU_FLIGHT_DIR`` env var) makes
    every dump also land as a file; without it the bundle is returned to
    the caller only (the HTTP surface ships it as the response body).
    ``dump_counter`` is an optional metrics Counter with a ``reason``
    label — the recorder never imports a metrics registry itself, the
    owner injects one (scheduler/metrics.FLIGHT_DUMPS).
    """

    def __init__(self, capacity: int = 16, dump_dir: Optional[str] = None,
                 dump_counter=None):
        self._lock = threading.Lock()
        self._ring = deque(maxlen=capacity)
        self._dumps = 0
        self.dump_dir = (dump_dir if dump_dir is not None
                         else os.environ.get("KOORD_TPU_FLIGHT_DIR") or None)
        self.dump_counter = dump_counter
        self._last_dump_path: Optional[str] = None  # _lock-guarded

    def record_cycle(self, record: Dict) -> None:
        with self._lock:
            self._ring.append(record)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dumps(self) -> int:
        with self._lock:
            return self._dumps

    @property
    def last_dump_path(self) -> Optional[str]:
        with self._lock:
            return self._last_dump_path

    def status(self) -> Dict[str, object]:
        """One consistent snapshot for the HTTP status surface."""
        with self._lock:
            return {
                "cycles": len(self._ring),
                "dumps": self._dumps,
                "last_dump_path": self._last_dump_path,
            }

    def dump(self, reason: str, path: Optional[str] = None) -> str:
        """Serialize the ring as a JSONL bundle (header line + one line per
        cycle, oldest first); returns the bundle body. Writes a file when
        ``path`` or ``dump_dir`` is set. Never raises on ring content —
        a dump fired from a failing cycle must not add its own failure."""
        records = self.snapshot()
        header = {
            "v": FLIGHT_SCHEMA_VERSION,
            "kind": "header",
            "schema": FLIGHT_SCHEMA_NAME,
            "reason": str(reason),
            "dumped_at": time.time(),
            "cycles": len(records),
        }
        lines = [json.dumps(header, sort_keys=True)]
        lines.extend(json.dumps(r, sort_keys=True, default=str)
                     for r in records)
        body = "\n".join(lines) + "\n"
        target = path
        if target is None and self.dump_dir:
            target = os.path.join(
                self.dump_dir,
                f"flight_{reason}_{int(header['dumped_at'])}.jsonl")
        written = None
        if target:
            try:
                with open(target, "w") as f:
                    f.write(body)
                written = target
            except OSError:
                # an unwritable dump dir must not wedge the trigger path;
                # the caller still gets the bundle body
                written = None
        with self._lock:
            self._dumps += 1
            if target:
                self._last_dump_path = written
        if self.dump_counter is not None:
            self.dump_counter.inc(reason=str(reason))
        return body


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
    if obj.get("v") != FLIGHT_SCHEMA_VERSION:
        errs.append(f"v must be {FLIGHT_SCHEMA_VERSION}, got {obj.get('v')!r}")
    if obj.get("kind") != "header":
        errs.append(f"kind must be 'header', got {obj.get('kind')!r}")
    if obj.get("schema") != FLIGHT_SCHEMA_NAME:
        errs.append(f"schema must be {FLIGHT_SCHEMA_NAME!r}, "
                    f"got {obj.get('schema')!r}")
    if not isinstance(obj.get("reason"), str) or not obj.get("reason"):
        errs.append(f"reason must be a non-empty string, "
                    f"got {obj.get('reason')!r}")
    if not _is_num(obj.get("dumped_at")) or obj.get("dumped_at") < 0:
        errs.append(f"dumped_at must be a non-negative number, "
                    f"got {obj.get('dumped_at')!r}")
    if not isinstance(obj.get("cycles"), int) or isinstance(
            obj.get("cycles"), bool) or obj.get("cycles") < 0:
        errs.append(f"cycles must be a non-negative int, "
                    f"got {obj.get('cycles')!r}")
    return errs


def validate_cycle_record(obj) -> List[str]:
    """Schema check for one cycle record line."""
    if not isinstance(obj, dict):
        return ["record is not a JSON object"]
    errs: List[str] = []
    if obj.get("v") != FLIGHT_SCHEMA_VERSION:
        errs.append(f"v must be {FLIGHT_SCHEMA_VERSION}, got {obj.get('v')!r}")
    if obj.get("kind") != "cycle":
        errs.append(f"kind must be 'cycle', got {obj.get('kind')!r}")
    if not isinstance(obj.get("seq"), int) or isinstance(obj.get("seq"), bool):
        errs.append(f"seq must be an int, got {obj.get('seq')!r}")
    for key in ("ts", "duration_ms"):
        if not _is_num(obj.get(key)) or obj.get(key) < 0:
            errs.append(f"{key} must be a non-negative number, "
                        f"got {obj.get(key)!r}")
    waves = obj.get("waves")
    if not isinstance(waves, int) or isinstance(waves, bool) or waves < 0:
        errs.append(f"waves must be a non-negative int, got {waves!r}")
    for field in _POD_LIST_FIELDS:
        entries = obj.get(field)
        if not isinstance(entries, list):
            errs.append(f"{field} must be a list, got {entries!r}")
            continue
        for e in entries:
            if not isinstance(e, dict) or not isinstance(e.get("pod"), str):
                errs.append(f"{field} entries must be objects with a "
                            f"string 'pod', got {e!r}")
                continue
            if field == "bound" and not isinstance(e.get("node"), str):
                errs.append(f"bound entry for {e['pod']} needs a string "
                            f"'node', got {e.get('node')!r}")
            stages = e.get("stages")
            if stages is not None:
                if not isinstance(stages, dict) or not all(
                        isinstance(k, str) and isinstance(v, int)
                        and not isinstance(v, bool)
                        for k, v in stages.items()):
                    errs.append(f"stages of {e['pod']} must map stage "
                                f"name -> int count, got {stages!r}")
            terms = e.get("terms")
            if terms is not None:
                if not isinstance(terms, dict) or not all(
                        isinstance(k, str) and _is_num(v)
                        for k, v in terms.items()):
                    errs.append(f"terms of {e['pod']} must map term "
                                f"name -> number, got {terms!r}")
    preempted = obj.get("preempted")
    if not isinstance(preempted, list) or any(
            not isinstance(k, str) for k in preempted):
        errs.append(f"preempted must be a list of strings, got {preempted!r}")
    # koordwatch (optional, so older bundles keep validating): the
    # cycle's structured demotion reasons and device-window decision ids
    for key in ("demotions", "decision_ids"):
        val = obj.get(key)
        if val is not None and (not isinstance(val, list) or any(
                not isinstance(k, str) for k in val)):
            errs.append(f"{key} must be a list of strings when present, "
                        f"got {val!r}")
    decision_id = obj.get("decision_id")
    if decision_id is not None and not isinstance(decision_id, str):
        errs.append(f"decision_id must be a string when present, "
                    f"got {decision_id!r}")
    metrics = obj.get("metrics")
    if not isinstance(metrics, dict) or not all(
            isinstance(k, str) and _is_num(v)
            for k, v in (metrics or {}).items()):
        errs.append(f"metrics must map name -> number, got {metrics!r}")
    spans = obj.get("spans")
    if not isinstance(spans, list):
        errs.append(f"spans must be a list, got {spans!r}")
    else:
        for s in spans:
            errs.extend(f"span: {e}" for e in validate_span_record(s))
    error = obj.get("error")
    if error is not None and not isinstance(error, str):
        errs.append(f"error must be a string when present, got {error!r}")
    return errs


def load_bundle(lines) -> Tuple[Optional[dict], List[dict], List[str]]:
    """Parse + validate a bundle; returns (header, cycle_records, errors).
    The contract ``hack/lint.sh`` pins: any error list growth against the
    golden fixture is schema drift and must be a conscious version bump."""
    from koordinator_tpu_torch.obs import load_jsonl_bundle

    return load_jsonl_bundle(lines, validate_header=validate_header,
                             validate_record=validate_cycle_record,
                             count_key="cycles")
