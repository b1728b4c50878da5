"""koordtrace: span-based cycle tracing for every koordinator binary.

Analog of the reference's `k8s.io/utils/trace` plumbing in
`pkg/scheduler/frameworkext/debug.go` plus the client_golang histogram
vectors the Go components hang off every hot loop: a `Tracer` produces
nested `Span`s (wall-clock start + monotonic duration), finished root
spans land in a bounded in-memory ring (the `koordlet/audit.py` ring
discipline), and the whole ring exports as JSONL — one line per span,
parent-linked — so an operator can dump `/traces` from a live binary and
replay the latency waterfall from the JSONL bundle.

Why spans and not just timers: the batched-tensor design introduces one
pathology the reference cannot have — a step build on a shape-signature
cache miss — and a flat cycle timer cannot distinguish "kernel was slow"
from "we recompiled" from "the store patch loop dragged". The span tree
makes the per-stage split (snapshot build, tensor encode, compile vs
execute, host-side bind work) first-class.

Thread discipline: the span stack is thread-local (each thread traces its
own tree); the finished-root ring is shared and lock-guarded. koordlint's
concurrency rules gate this package — no unlocked shared mutation.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

TRACE_SCHEMA_VERSION = 1


@dataclass
class Span:
    """One timed operation. `start_unix` is wall clock (for cross-host
    correlation), `start_mono`/`duration_seconds` are monotonic (immune to
    clock steps — offsets inside a trace always use these)."""

    name: str
    trace_id: int
    span_id: int
    parent_id: Optional[int]
    start_unix: float
    start_mono: float
    duration_seconds: float = 0.0
    attributes: Dict[str, str] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    def walk(self) -> Iterator["Span"]:
        """This span and every descendant, depth-first in start order."""
        yield self
        for child in self.children:
            yield from child.walk()

    def find(self, name: str) -> Optional["Span"]:
        """First descendant (or self) with the given name."""
        for span in self.walk():
            if span.name == name:
                return span
        return None

    def find_all(self, name: str) -> List["Span"]:
        return [s for s in self.walk() if s.name == name]

    def to_record(self) -> Dict[str, object]:
        """The JSONL wire record for this single span (children are their
        own lines, linked by `parent`)."""
        return {
            "v": TRACE_SCHEMA_VERSION,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "start_unix": self.start_unix,
            "start_mono": self.start_mono,
            "duration_ms": self.duration_seconds * 1000.0,
            "attrs": dict(self.attributes),
        }


def validate_record(obj: object) -> List[str]:
    """Schema check for one decoded JSONL line; returns human-readable
    errors (empty = valid). This is the contract `hack/lint.sh` pins with
    the golden fixture: drift here must be a conscious version bump."""
    if not isinstance(obj, dict):
        return ["record is not a JSON object"]
    errs: List[str] = []
    if obj.get("v") != TRACE_SCHEMA_VERSION:
        errs.append(f"v must be {TRACE_SCHEMA_VERSION}, got {obj.get('v')!r}")
    for key in ("trace", "span"):
        v = obj.get(key)
        if not isinstance(v, int) or isinstance(v, bool):
            errs.append(f"{key} must be an int, got {v!r}")
    parent = obj.get("parent", "MISSING")
    if parent is not None and (not isinstance(parent, int)
                               or isinstance(parent, bool)):
        errs.append(f"parent must be an int or null, got {parent!r}")
    if not (isinstance(obj.get("name"), str) and obj["name"]):
        errs.append(f"name must be a non-empty string, got {obj.get('name')!r}")
    for key in ("start_unix", "start_mono", "duration_ms"):
        v = obj.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            errs.append(f"{key} must be a non-negative number, got {v!r}")
    attrs = obj.get("attrs")
    if not isinstance(attrs, dict):
        errs.append(f"attrs must be an object, got {attrs!r}")
    else:
        for k, v in attrs.items():
            if not isinstance(k, str) or not isinstance(v, str):
                errs.append(f"attrs entries must be string->string, "
                            f"got {k!r}: {v!r}")
    return errs


def load_jsonl_bundle(lines, *, validate_header, validate_record,
                      count_key: str):
    """Shared bundle parser for every JSONL dump format in this package
    (flight, timeline, slo): line 1 validates as the header, every
    further line as a record, and the header's ``count_key`` field must
    match the record count. Returns (header, records, errors) — the
    golden-fixture contract each format's ``load_bundle`` pins."""
    header = None
    records: List[dict] = []
    errors: List[str] = []
    seen_any = False
    for lineno, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as exc:
            errors.append(f"line {lineno}: invalid JSON ({exc})")
            continue
        if not seen_any:
            seen_any = True
            errs = validate_header(obj)
            if errs:
                errors.extend(f"line {lineno}: {e}" for e in errs)
            else:
                header = obj
            continue
        errs = validate_record(obj)
        if errs:
            errors.extend(f"line {lineno}: {e}" for e in errs)
        else:
            records.append(obj)
    if not seen_any:
        errors.append("empty bundle: missing header line")
    elif header is not None and header[count_key] != len(records) and (
            not errors):
        errors.append(
            f"header says {header[count_key]} {count_key}, "
            f"found {len(records)}")
    return header, records, errors


class Tracer:
    """Nested-span tracer with a bounded finished-root ring.

    `span(...)` is a context manager; nesting follows the thread-local
    stack, so `with tracer.span("cycle"): with tracer.span("kernel"): ...`
    yields kernel as a child of cycle with zero plumbing at call sites.
    A root span (no parent on this thread) is committed to the ring when
    it closes; children travel inside their root.

    Memory is bounded on BOTH axes (audit.py discipline): the ring keeps
    at most `capacity` roots, and each trace retains at most
    `max_spans_per_trace` spans. Only spans at depth >= 2 (per-item work:
    `bind_pod` and below on a 10k-pod cycle) count against the budget —
    the root and its direct children are the per-stage skeleton, bounded
    by instrumentation sites rather than cluster size, and must survive
    even when a huge pre-pass burns the budget first. Spans beyond the
    budget are timed but not retained; the root reports how many via a
    `dropped_spans` attribute.
    """

    def __init__(self, capacity: int = 256, max_spans_per_trace: int = 512):
        from collections import deque

        self._lock = threading.Lock()
        self._ring = deque(maxlen=capacity)  # of root Spans
        self._max_spans = max_spans_per_trace
        self._seq = 0  # total roots ever committed (wraparound-visible)
        self._ids = itertools.count(1)  # atomic under the GIL
        self._local = threading.local()

    @contextmanager
    def span(self, name: str, **attributes: str):
        stack: List[Span] = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1] if stack else None
        if parent is None:
            self._local.retained = 0
            self._local.dropped = 0
        # depth 0/1 = the per-stage skeleton, always retained; the budget
        # gates only per-item depth (>= 2), so a huge pre-pass can never
        # evict the snapshot/encode/kernel/bind split
        over_budget = (len(stack) >= 2
                       and self._local.retained >= self._max_spans)
        if over_budget:
            self._local.dropped += 1
        elif len(stack) >= 2:
            self._local.retained += 1  # skeleton spans don't consume budget
        span_id = next(self._ids)
        sp = Span(
            name=name,
            trace_id=parent.trace_id if parent is not None else span_id,
            span_id=span_id,
            parent_id=parent.span_id if parent is not None else None,
            start_unix=time.time(),
            start_mono=time.perf_counter(),
            attributes={k: str(v) for k, v in attributes.items()},
        )
        stack.append(sp)
        try:
            yield sp
        except BaseException as exc:
            sp.attributes.setdefault("error", type(exc).__name__)
            raise
        finally:
            sp.duration_seconds = time.perf_counter() - sp.start_mono
            stack.pop()
            if parent is not None:
                if not over_budget:
                    parent.children.append(sp)
            else:
                if self._local.dropped:
                    sp.attributes["dropped_spans"] = str(self._local.dropped)
                self._commit_root(sp)

    def _commit_root(self, root: Span) -> None:
        with self._lock:
            self._seq += 1
            self._ring.append(root)  # deque maxlen evicts the oldest

    # -- read side -------------------------------------------------------
    @property
    def seq(self) -> int:
        """Total root spans ever committed (> len(ring) after wraparound)."""
        with self._lock:
            return self._seq

    def roots(self, limit: Optional[int] = None) -> List[Span]:
        """Finished root spans, oldest first. `limit` keeps the newest N;
        an explicit 0 means zero roots, None means everything."""
        with self._lock:
            ring = list(self._ring)
        if limit is None:
            return ring
        return ring[-limit:] if limit > 0 else []

    def export_jsonl(self, limit: Optional[int] = None) -> str:
        """The ring flattened to JSONL: one line per span, depth-first per
        trace — the `/traces` body and the CLI's input format."""
        lines = []
        for root in self.roots(limit=limit):
            for span in root.walk():
                lines.append(json.dumps(span.to_record(), sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
