"""Scheduler metrics registry (analog of reference pkg/scheduler/metrics/).

A copy of the Prometheus-style ``Registry`` (with its gauge, counter and
histogram kinds) and the JAX package's scheduler metric catalog, names
unchanged so one scrape config reads both. The encoding-overflow signals
make conservative batch-encoding cuts first-class observables; the cycle
driver (scheduler/cycle.py) bumps the rest, the mesh gauges
(``koord_scheduler_mesh_*``) included since the port runs its mesh
(parallel/).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _lk(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted(labels.items()))


def _escape_label(value: str) -> str:
    """Prometheus exposition: label values escape backslash, double-quote and
    line-feed (exposition_formats spec; client_golang expfmt.go)."""
    return (str(value).replace("\\", "\\\\")
            .replace('"', '\\"').replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP lines escape backslash and line-feed only (quote is label-only)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(value: float) -> str:
    """Full-precision exposition value. %g keeps only 6 significant digits,
    which silently rounds ever-growing counters/bucket counts once they
    pass ~1e6 (increments smaller than the rounding granule vanish between
    scrapes); integral values render as exact integers instead. Non-finite
    values render as Prometheus' +Inf/-Inf/NaN spellings — one bad sample
    must never poison the whole exposition."""
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 2**53:
        return str(int(value))
    return repr(value)


def _render_sample(name: str, labels: Dict[str, str], value: float) -> str:
    """One exposition sample line with sorted, escaped labels."""
    if labels:
        body = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


class _Metric:
    def __init__(self, name: str, help_text: str, kind: str):
        self.name = name
        self.help = help_text
        self.kind = kind
        self._lock = threading.Lock()
        self._values: Dict[_LabelKey, float] = {}

    def _set(self, labels: Dict[str, str], value: float) -> None:
        with self._lock:
            self._values[_lk(labels)] = value

    def _add(self, labels: Dict[str, str], delta: float) -> None:
        key = _lk(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def get(self, **labels: str) -> Optional[float]:
        with self._lock:
            return self._values.get(_lk(labels))

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]

    def clear(self, **labels: str) -> None:
        with self._lock:
            self._values.pop(_lk(labels), None)

    def sample_lines(self) -> List[str]:
        """Exposition body lines (after HELP/TYPE); kind-specific."""
        return [_render_sample(self.name, labels, value)
                for labels, value in self.samples()]


class Gauge(_Metric):
    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text, "gauge")

    def set(self, value: float, **labels: str) -> None:
        self._set(labels, value)


class Counter(_Metric):
    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text, "counter")

    def inc(self, delta: float = 1.0, **labels: str) -> None:
        self._add(labels, delta)


# latency-shaped default buckets (client_golang prometheus.DefBuckets):
# most cycle/stage latencies here land between 1ms and 10s
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt_le(bound: float) -> str:
    return f"{bound:g}"


class Histogram(_Metric):
    """Prometheus histogram: per label-set bucket counts + sum + count,
    exposed as cumulative `_bucket{le=...}` series ending in `le="+Inf"`.
    Storage is per-bucket (non-cumulative) under the shared `_Metric` lock
    discipline; cumulation happens at exposition time."""

    def __init__(self, name: str, help_text: str = "",
                 buckets: Optional[Tuple[float, ...]] = None):
        super().__init__(name, help_text, "histogram")
        # an explicit +Inf bound would duplicate the synthesized le="+Inf"
        # series and fail the whole scrape; strip it like client_golang
        upper = tuple(sorted({float(b) for b in (buckets or DEFAULT_BUCKETS)
                              if math.isfinite(float(b))}))
        if not upper:
            raise ValueError(
                f"histogram {name} needs at least one finite bucket")
        self._upper = upper
        # label-set -> [per-bucket counts..., sum, count]
        self._series: Dict[_LabelKey, List[float]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _lk(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = [0.0] * (len(self._upper) + 2)
            for i, bound in enumerate(self._upper):
                if value <= bound:
                    state[i] += 1.0
                    break
            state[-2] += value
            state[-1] += 1.0

    def snapshot(self, **labels: str):
        """(upper_bounds, cumulative_bucket_counts, sum, count) for one
        label set, or None if never observed. The cumulative counts align
        with `upper_bounds`; `count` is the implicit +Inf bucket."""
        with self._lock:
            state = self._series.get(_lk(labels))
            if state is None:
                return None
            state = list(state)
        cumulative: List[float] = []
        running = 0.0
        for c in state[:-2]:
            running += c
            cumulative.append(running)
        return self._upper, cumulative, state[-2], state[-1]

    def count(self, **labels: str) -> float:
        snap = self.snapshot(**labels)
        return snap[3] if snap is not None else 0.0

    def sum(self, **labels: str) -> float:
        snap = self.snapshot(**labels)
        return snap[2] if snap is not None else 0.0

    # the scalar `_Metric` API targets `_values`, which a histogram never
    # uses — rebind it to `_series` (get/clear) or refuse it (set/add), so
    # a caller following the gauge/counter idiom can't silently no-op
    def get(self, **labels: str) -> Optional[float]:
        """Observation count for the label set (None if never observed)."""
        with self._lock:
            state = self._series.get(_lk(labels))
            return state[-1] if state is not None else None

    def clear(self, **labels: str) -> None:
        with self._lock:
            self._series.pop(_lk(labels), None)

    def _set(self, labels: Dict[str, str], value: float) -> None:
        raise TypeError(f"histogram {self.name} only supports observe()")

    def _add(self, labels: Dict[str, str], delta: float) -> None:
        raise TypeError(f"histogram {self.name} only supports observe()")

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        """(labels, count) per series — the scalar view for generic
        consumers; the full bucket layout comes from sample_lines()."""
        with self._lock:
            return [(dict(k), v[-1]) for k, v in sorted(self._series.items())]

    def sample_lines(self) -> List[str]:
        with self._lock:
            series = [(dict(k), list(v))
                      for k, v in sorted(self._series.items())]
        lines: List[str] = []
        for labels, state in series:
            running = 0.0
            for bound, c in zip(self._upper, state[:-2]):
                running += c
                lines.append(_render_sample(
                    f"{self.name}_bucket",
                    {**labels, "le": _fmt_le(bound)}, running))
            lines.append(_render_sample(
                f"{self.name}_bucket", {**labels, "le": "+Inf"}, state[-1]))
            lines.append(_render_sample(f"{self.name}_sum", labels, state[-2]))
            lines.append(_render_sample(
                f"{self.name}_count", labels, state[-1]))
        return lines


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(Gauge(name, help_text))

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(Counter(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._register(Histogram(name, help_text, buckets=buckets))

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if existing.kind != metric.kind:
                    raise ValueError(
                        f"metric {metric.name} re-registered as {metric.kind}, "
                        f"was {existing.kind}")
                # histograms carry per-metric config: silently handing back
                # an instance with DIFFERENT buckets would drop the
                # caller's spec and skew every quantile it computes
                if (getattr(existing, "_upper", None)
                        != getattr(metric, "_upper", None)):
                    raise ValueError(
                        f"histogram {metric.name} re-registered with "
                        f"different buckets")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.sample_lines())
        return "\n".join(lines) + "\n"


# the agent-wide default registry and its well-known metrics
# (pkg/koordlet/metrics/{common,resource_summary,qos}.go)


REGISTRY = Registry()

# pods marked unschedulable this round because an encoding budget
# overflowed; kind = affinity_terms | port_slots
ENCODING_OVERFLOW_PODS = REGISTRY.counter(
    "koord_scheduler_encoding_overflow_unschedulable_total",
    "Pods marked unschedulable by a batch-encoding budget overflow",
)

# nodes degraded to their label-unknown admission bucket in the last
# snapshot (selector-carrying pods cannot schedule there)
ADMISSION_DEGRADED_NODES = REGISTRY.gauge(
    "koord_scheduler_admission_signature_degraded_nodes",
    "Nodes in a label-unknown admission bucket in the last snapshot",
)

# nodes whose attached-claim volume group overflowed MAX_VOL_GROUPS in the
# last snapshot: pods pay the full (unexempted) attachment count there
VOL_GROUP_DEGRADED_NODES = REGISTRY.gauge(
    "koord_scheduler_volume_group_degraded_nodes",
    "Nodes degraded to the conservative volume group in the last snapshot",
)


# cycle-latency histograms (koordtrace spans carry the per-stage split;
# these carry the distribution a scraper can alert on)
CYCLE_SECONDS = REGISTRY.histogram(
    "koord_scheduler_cycle_seconds",
    "End-to-end scheduling cycle latency",
)
KERNEL_SECONDS = REGISTRY.histogram(
    "koord_scheduler_kernel_seconds",
    "Batched kernel pass latency (compile+execute on a cache miss)",
)

# shape-signature step-cache traffic: a steady-state cluster should be
# all hits; a miss builds a new step (on the card, a kernel library
# load and first launch on the step's first call)
COMPILE_CACHE_HITS = REGISTRY.counter(
    "koord_scheduler_compile_cache_hits_total",
    "Kernel launches served by the shape-signature step cache",
)
COMPILE_CACHE_MISSES = REGISTRY.counter(
    "koord_scheduler_compile_cache_misses_total",
    "Kernel step builds forced by a shape-signature cache miss",
)

PODS_BOUND_TOTAL = REGISTRY.counter(
    "koord_scheduler_pods_bound_total",
    "Pods bound across all cycles",
)

# fused multi-wave dispatch (models/fused_waves.py): how many dependent
# scheduling rounds each device dispatch actually executed (early exit
# stops at the first zero-commit wave), and how many bytes every kernel
# readback shipped — the compacted binding buffer is the whole point, so
# a regression back to full-matrix readbacks must be visible
WAVES_PER_DISPATCH = REGISTRY.histogram(
    "koord_scheduler_waves_per_dispatch",
    "Scheduling waves executed per device dispatch",
    buckets=(1.0, 2.0, 4.0, 8.0),
)
READBACK_BYTES = REGISTRY.counter(
    "koord_scheduler_readback_bytes_total",
    "Bytes read back from the device across all kernel dispatches",
)

# pipeline occupancy: fraction of the last cycle's wall time the device
# had work in flight (device_busy_seconds / cycle duration). The whole
# point of the batched-tensor re-expression is that the DEVICE sets the
# cycle rate — this gauge makes the next host-side bottleneck visible in
# /metrics instead of only in bench JSON. Overlapped wave replay
# (KOORD_TPU_REPLAY_OVERLAP) raises it by draining the replay queue
# while later waves execute.
PIPELINE_OCCUPANCY = REGISTRY.gauge(
    "koord_scheduler_pipeline_occupancy",
    "Device-busy fraction of the last scheduling cycle's wall time",
)

# incremental-pack row traffic: steady state should be nearly all reused;
# a repack surge means the store is churning (or a cache regression)
PACK_ROWS_REUSED = REGISTRY.counter(
    "koord_scheduler_pack_rows_reused_total",
    "Packed pod rows gathered unchanged from the previous build",
)
PACK_ROWS_REPACKED = REGISTRY.counter(
    "koord_scheduler_pack_rows_repacked_total",
    "Packed pod rows rebuilt from the object (new/changed pods)",
)

# DeviceSnapshot upload traffic (scheduler/snapshot_cache.DeviceSnapshot
# stats, fed as per-cycle counter deltas by the cycle driver): an upload
# regression — reuse collapsing into full puts — shows up in /metrics,
# not just bench runs. Counters, so rate()/increase() behave across
# process restarts.
UPLOAD_FIELDS_REUSED = REGISTRY.counter(
    "koord_scheduler_upload_fields_reused_total",
    "Device-snapshot fields reused without any transfer",
)
UPLOAD_FIELDS_SCATTERED = REGISTRY.counter(
    "koord_scheduler_upload_fields_scattered_total",
    "Device-snapshot fields updated by donated row scatters",
)
UPLOAD_FIELDS_PUT = REGISTRY.counter(
    "koord_scheduler_upload_fields_put_total",
    "Device-snapshot fields re-uploaded in full",
)
UPLOAD_BYTES_SCATTERED = REGISTRY.counter(
    "koord_scheduler_upload_bytes_scattered_total",
    "Bytes shipped by device-snapshot row scatters",
)
UPLOAD_BYTES_PUT = REGISTRY.counter(
    "koord_scheduler_upload_bytes_put_total",
    "Bytes shipped by full device-snapshot puts",
)

# koordexplain: per-stage filter rejections, attributed on device by
# the scheduling dispatch itself (models/full_chain.explain_stage_counts).
# Labeled by stage key (EXPLAIN_STAGE_KEYS); counted once per pod ending a
# logical cycle unbound, over the nodes each stage rejected — the
# aggregate view of what /explain answers per pod. Only populated when
# KOORD_TPU_EXPLAIN is on (the legacy host recompute does not feed it).
FILTER_REJECTIONS = REGISTRY.counter(
    "koord_scheduler_filter_rejections_total",
    "Node rejections per filter stage for pods left unbound, "
    "labeled by stage",
)
# explain attribution rides the kernel readback; its extra bytes must be
# visible so the counts-level overhead stays an explicit trade
EXPLAIN_READBACK_BYTES = REGISTRY.counter(
    "koord_scheduler_explain_readback_bytes_total",
    "Bytes of koordexplain attribution read back from the device",
)
# cycle flight recorder (obs/flight.py): every bundle dump, labeled by the
# trigger (deadline_overrun | cycle_exception | parity_mismatch |
# degradation | invariant_breach | slo_overrun | http)
FLIGHT_DUMPS = REGISTRY.counter(
    "koord_flight_recorder_dumps_total",
    "Flight-recorder bundle dumps, labeled by trigger reason",
)

# dispatch degradation ladder (scheduler/degrade.py): the current rung
# (0=full, 1=partial-mesh, 2=no-mesh, 3=serial-waves, 4=no-explain,
# 5=host-fallback) and every failed dispatch attempt the ladder absorbed
# instead of letting it kill the scheduler, labeled by the dispatch
# stage that failed
DEGRADED_LEVEL = REGISTRY.gauge(
    "koord_scheduler_degraded_level",
    "Dispatch degradation-ladder level "
    "(0=full 1=partial-mesh 2=no-mesh 3=serial-waves 4=no-explain "
    "5=host-fallback)",
)
DISPATCH_RETRIES = REGISTRY.counter(
    "koord_scheduler_dispatch_retries_total",
    "Failed device-dispatch attempts absorbed by the degradation "
    "ladder, labeled by stage",
)

# koordguard dispatch deadline (scheduler/deadline.py,
# KOORD_TPU_DISPATCH_DEADLINE_MS): monitored device syncs that overran
# and were abandoned — a slow-not-dead device demoting the ladder
# instead of wedging the cycle. Labeled by the dispatch path
# (serial | fused | rebalance).
DISPATCH_DEADLINE_OVERRUNS = REGISTRY.counter(
    "koord_scheduler_dispatch_deadline_overruns_total",
    "Device syncs abandoned after overrunning the dispatch deadline, "
    "labeled by path",
)

# mesh-backed dispatch (KOORD_TPU_MESH, parallel/mesh.py): how many
# devices the production cycle shards over (0 = single-device path), how
# the node rows and the compacted readback split across shards. The
# imbalance gauge is max/mean REAL (unpadded) rows per shard — 1.0 is a
# perfectly level mesh; trailing shards holding only pad rows push it up
# and that capacity is simply wasted.
MESH_DEVICES = REGISTRY.gauge(
    "koord_scheduler_mesh_devices",
    "Devices in the production dispatch mesh (0 = single-device)",
)
MESH_SHARD_READBACK_BYTES = REGISTRY.gauge(
    "koord_scheduler_mesh_readback_bytes",
    "Bytes of the last kernel readback held per mesh shard, "
    "labeled by shard",
)
MESH_SHARD_IMBALANCE = REGISTRY.gauge(
    "koord_scheduler_mesh_shard_imbalance",
    "Max/mean real node rows per mesh shard in the last dispatch",
)

# koordwatch demotion accounting: every silent fused-wave /
# explain / mesh demotion routes through the Scheduler._note_demotion
# chokepoint and lands here, labeled by the structured reason
# (ladder-serial-waves | sidecar | pending-reservations |
# prod-usage-score | claim-pods | score-transformer | explain-sidecar |
# explain-ladder | mesh-off | partial-mesh). Counted once per cycle per
# reason, so the counter reads as "cycles demoted for this reason" —
# the real-traffic data the ROADMAP demotion burn-down starts from.
WAVE_DEMOTIONS = REGISTRY.counter(
    "koord_scheduler_wave_demotions_total",
    "Scheduling cycles demoted below their configured wave/explain/mesh "
    "level, labeled by structured reason",
)

# SURVEY 7 step 6 sidecar path: kernel passes that fell back to the
# in-process step after a sidecar RPC failure (previously a loose
# Scheduler attribute invisible to /metrics)
SIDECAR_FALLBACKS = REGISTRY.counter(
    "koord_scheduler_sidecar_fallbacks_total",
    "Kernel passes served by the in-process step after a sidecar "
    "RPC transport failure",
)

# pending-queue visibility (pre-work for the ROADMAP admission/queueing
# item): the queue depth each cycle drained and the enqueue-to-dispatch
# age of every pod observed in it — the front-door latency signal the
# device-resident queueing work will have to improve
PENDING_QUEUE_DEPTH = REGISTRY.gauge(
    "koord_scheduler_pending_queue_depth",
    "Pods (and pending reservations) in the queue at cycle start",
)
QUEUE_WAIT_SECONDS = REGISTRY.histogram(
    "koord_scheduler_queue_wait_seconds",
    "Enqueue-to-dispatch age of each queued pod, observed per cycle",
    buckets=(1.0, 5.0, 15.0, 60.0, 300.0, 1800.0, 7200.0),
)

# koordwatch device timeline (obs/timeline.py): every device window —
# scheduler dispatch, koordbalance rebalance pass, koordcolo pass —
# records its dispatch->last-sync interval and the idle gap before it.
# The idle fraction is THE number the host-tail / rebalance-overlap
# ROADMAP items must drive down.
DEVICE_WINDOW_SECONDS = REGISTRY.histogram(
    "koord_device_window_seconds",
    "Device-window dispatch-to-last-sync interval, labeled by consumer "
    "(scheduler|rebalance|colo) and path (serial|fused|chained|mesh)",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0),
)
DEVICE_IDLE_FRACTION = REGISTRY.gauge(
    "koord_device_idle_fraction",
    "Gap time between consecutive device windows over wall time",
)

# koordwatch SLO engine (obs/slo.py): per-objective burn rate
# (observed/target at the gating percentile; 1.0 = exactly on budget)
# and the met verdict, labeled by objective name
SLO_BURN_RATE = REGISTRY.gauge(
    "koord_slo_burn_rate",
    "SLO burn rate (observed/target at the gating percentile), "
    "labeled by objective",
)
SLO_MET = REGISTRY.gauge(
    "koord_slo_met",
    "Whether the SLO is currently met (1) or blown (0), "
    "labeled by objective",
)

# host-tail pack overlap: pod rows pre-packed into the pack memo
# INSIDE a device window (serial/fused pipeline windows, the chained
# dispatch) — host work that used to run in the inter-window gap. A
# steady soak should show this tracking the repack counter; zero with
# KOORD_TPU_PACK_OVERLAP=0.
PREPACK_ROWS = REGISTRY.counter(
    "koord_scheduler_prepack_rows_total",
    "Pod rows pre-packed into the pack memo inside a device window",
)

# AOT warm-up ladder (scheduler/warmup.py, a later slice): rungs replayed from
# the persistent compile-cache index at startup, labeled by outcome
# (warmed | skipped | failed | invalidated — the last is the
# program-fingerprint discipline), the last ladder's wall seconds, and
# the completion gauge the steady-state compile guard arms on
WARMUP_RUNGS = REGISTRY.counter(
    "koord_scheduler_warmup_rungs_total",
    "Warm-up ladder rungs replayed from the persistent compile-cache "
    "index, labeled by outcome",
)
WARMUP_SECONDS = REGISTRY.gauge(
    "koord_scheduler_warmup_seconds",
    "Wall seconds the last warm-up ladder took",
)
WARMUP_COMPLETE = REGISTRY.gauge(
    "koord_scheduler_warmup_complete",
    "Whether the warm-up ladder has completed (1) for this scheduler",
)
# koordlint rule 20 (compile-in-steady-state), the runtime half: a
# step-cache MISS in the hot path AFTER warm-up completed — outside the
# warmup/ladder-transition/restart contexts every legitimate compile
# belongs to. A warm-cache restart must keep this flat through its
# first bind (the crash-restart coldstart gate asserts it).
STEADY_STATE_COMPILES = REGISTRY.counter(
    "koord_scheduler_steady_state_compiles_total",
    "Step-cache misses flagged in steady state (after warm-up, outside "
    "ladder transitions)",
)

# pipeline deferred-diagnose backlog: depth of the queue carrying cycle
# N's unschedulability writes into cycle N+1's kernel window, plus the
# total items ever deferred — a growing depth means kernel windows (or
# flush()) are not draining the backlog
DIAGNOSE_DEFERRED_TOTAL = REGISTRY.counter(
    "koord_scheduler_diagnose_deferred_total",
    "Unschedulability diagnose/condition writes deferred by the pipeline",
)
DIAGNOSE_DEFERRED_DEPTH = REGISTRY.gauge(
    "koord_scheduler_diagnose_deferred_depth",
    "Deferred diagnose entries currently queued",
)
