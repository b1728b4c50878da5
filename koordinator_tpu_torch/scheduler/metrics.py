"""Scheduler metrics: the three counters the snapshot pack bumps.

A copy of the Prometheus-style ``Registry`` (with its gauge, counter and
histogram kinds) and the pack's encoding-overflow signals: nodes degraded
to a label-unknown admission bucket, pods cut by an encoding budget, and
nodes degraded to the conservative volume group. The rest of the
scheduler's metric catalog comes with the cycle driver.
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
