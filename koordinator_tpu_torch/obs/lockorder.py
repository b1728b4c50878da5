"""The canonical lock order for the co-located device consumers.

Three consumers share one device view: the scheduler's dispatch path,
the balance rebalancer, and the colo reconciler all touch the
DeviceSnapshot mirror, record their kernel windows on the DeviceTimeline
ring, and feed the metrics registry. Any code path that needs more than
one of those locks MUST acquire them in the order declared below —
outer first — and release before re-acquiring an earlier one. koordlint
(`lock-order-inversion` in analysis/rules/race.py) enforces the order AS
DECLARED HERE: it parses this tuple from source and errors on any
acquisition edge that contradicts it, so the order cannot silently
drift to whatever the newest caller happened to nest. The JAX
package's racecheck harness (its sim/racecheck.py) imports its copy at
runtime; the port has no such harness yet.

Entries are ``ClassName.attr`` lock names:

1. ``DeviceSnapshot._lock`` — the device mirror's dispatch-window
   ledger (scheduler/snapshot_cache.py). Outermost because the mirror
   brackets whole kernel windows: while it is held the holder may still
   mint/close timeline windows and bump metrics.
2. ``DeviceTimeline._lock`` — the koordwatch window ring
   (obs/timeline.py). Feeds gauges/histograms, so it precedes the
   registry locks; timeline.close() deliberately observes its
   histograms AFTER releasing the ring lock, which trivially satisfies
   the order and keeps the ring lock narrow.
3. ``Registry._lock`` — the metrics registry's family table
   (scheduler/metrics.py).
4. ``_Metric._lock`` — a single metric family's series map. Innermost:
   never call out of a metric while holding it.

Locks NOT listed here (tracer ring, SLO registry, flight ring, store,
warm-up ladder…) are intentionally unordered against each other; the
analyzer still rejects cycles among them.
"""

from __future__ import annotations

CANONICAL_LOCK_ORDER = (
    "DeviceSnapshot._lock",
    "DeviceTimeline._lock",
    "Registry._lock",
    "_Metric._lock",
)
