"""Metric cache: the node-local TSDB + static-info KV store.

Analog of reference `pkg/koordlet/metriccache/` (embedded Prometheus tsdb + gob
KV, metric_cache.go:56-79, tsdb_storage.go:32-46): time-series keyed by
(metric, labels) with windowed aggregate queries
(avg/p50/p90/p95/p99/latest/count), bounded retention. Numpy-backed percentile
math so the NodeMetric reporter's aggregated usages are consistent with the
scheduler's percentile semantics.

Persistence: the reference's TSDB lives on disk and survives agent restarts;
here an atomic pickle snapshot (tmp + rename) is written every
flush_interval_seconds and restored on construction, so the NodeMetric
aggregation window (and the static-info KV) carries across restarts. A
snapshot written by the JAX package's koordlet restores here too: its KV
holds classes pickled under ``koordinator_tpu.<module>``, which
:class:`_SnapshotUnpickler` maps onto this package's copies without
importing the JAX package.
"""

from __future__ import annotations

import bisect
import os
import pickle
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np

# canonical metric names (metric_resources.go)
NODE_CPU_USAGE = "node_cpu_usage"            # cores
NODE_MEMORY_USAGE = "node_memory_usage"      # bytes
POD_CPU_USAGE = "pod_cpu_usage"
POD_MEMORY_USAGE = "pod_memory_usage"
CONTAINER_CPU_USAGE = "container_cpu_usage"
CONTAINER_MEMORY_USAGE = "container_memory_usage"
BE_CPU_USAGE = "be_cpu_usage"
SYS_CPU_USAGE = "sys_cpu_usage"
NODE_CPU_PSI_FULL_AVG10 = "node_cpu_psi_full_avg10"
NODE_MEM_PSI_FULL_AVG10 = "node_mem_psi_full_avg10"
POD_CPI = "pod_cpi"
HOST_APP_CPU_USAGE = "host_app_cpu_usage"
HOST_APP_MEMORY_USAGE = "host_app_memory_usage"
POD_PAGECACHE = "pod_pagecache"              # bytes of page cache per pod
POD_COLD_MEMORY = "pod_cold_memory"          # kidled cold bytes per pod
POD_CPU_THROTTLED_RATIO = "pod_cpu_throttled_ratio"  # nr_throttled/nr_periods
NODE_FS_USED_BYTES = "node_fs_used_bytes"
NODE_FS_TOTAL_BYTES = "node_fs_total_bytes"
NODE_DISK_IO_TICKS = "node_disk_io_ticks"    # per-device busy-ms counter delta
NODE_GPU_CORE_USAGE = "node_gpu_core_usage"  # per-accelerator compute %
NODE_GPU_MEM_USAGE = "node_gpu_mem_usage"    # per-accelerator HBM bytes in use

NODE_CPU_INFO_KEY = "node_cpu_info"
NODE_NUMA_INFO_KEY = "node_numa_info"
NODE_STORAGE_INFO_KEY = "node_storage_info"


# the JAX package's modules whose classes a snapshot's KV can hold (the
# nodeinfo collector's CPUTopology of CPUInfo, and its NUMAMemInfo map)
_REF_PACKAGE = "koordinator_tpu"
_CARRIED_MODULES = frozenset((
    "koordinator_tpu.api.objects",
    "koordinator_tpu.koordlet.util.machineinfo",
    "koordinator_tpu.scheduler.cpu_topology",
))


class _SnapshotUnpickler(pickle.Unpickler):
    """Loads a snapshot of either package: a global of the JAX package
    that a snapshot can hold resolves to this package's copy of its
    module; any other global of the JAX package is refused, so a restore
    never imports it."""

    def find_class(self, module: str, name: str):
        if module == _REF_PACKAGE or module.startswith(_REF_PACKAGE + "."):
            if module not in _CARRIED_MODULES:
                raise pickle.UnpicklingError(
                    f"snapshot global {module}.{name} is not one a metric "
                    f"cache holds")
            module = "koordinator_tpu_torch" + module[len(_REF_PACKAGE):]
        return super().find_class(module, name)


@dataclass(frozen=True)
class SeriesKey:
    metric: str
    labels: Tuple[Tuple[str, str], ...] = ()

    @staticmethod
    def of(metric: str, **labels: str) -> "SeriesKey":
        return SeriesKey(metric, tuple(sorted(labels.items())))


class MetricCache:
    def __init__(self, retention_seconds: float = 1800.0,
                 storage_path: Optional[str] = None,
                 flush_interval_seconds: float = 60.0):
        self.retention = retention_seconds
        self.storage_path = storage_path
        self.flush_interval = flush_interval_seconds
        self._last_flush = 0.0
        self._lock = threading.RLock()
        self._series: Dict[SeriesKey, Deque[Tuple[float, float]]] = {}
        self._kv: Dict[str, Any] = {}
        if storage_path:
            self._restore()

    # -- persistence (tsdb_storage.go analog) --------------------------------
    def _restore(self) -> None:
        # a bad snapshot must never crash-loop agent startup: ANY failure
        # (unpickling, moved classes -> AttributeError, malformed keys ->
        # TypeError) degrades to an empty cache, as the reference does when
        # the TSDB dir is unusable
        try:
            with open(self.storage_path, "rb") as f:
                snap = _SnapshotUnpickler(f).load()
            series = snap.get("series", {})
            # retention anchored to the newest persisted sample, not wall
            # clock: keeps the window intact across clock skew and makes
            # restore deterministic for replayed timelines; add_sample prunes
            # from there
            latest = max(
                (pts[-1][0] for pts in series.values() if pts), default=0.0
            )
            cutoff = latest - self.retention
            restored = {}
            for key_parts, points in series.items():
                kept = [(ts, v) for ts, v in points if ts >= cutoff]
                if kept:
                    restored[SeriesKey(*key_parts)] = deque(kept)
            kv = dict(snap.get("kv", {}))
        except Exception:
            return
        with self._lock:
            self._series.update(restored)
            self._kv.update(kv)

    def flush(self, now: Optional[float] = None) -> bool:
        """Atomic snapshot to disk (tmp + rename): a crash mid-write never
        corrupts the previous snapshot. I/O failures (disk full, unwritable
        dir) are swallowed — persistence is best-effort and must never kill
        the agent loop; _last_flush still advances so a bad disk isn't
        retried every tick."""
        if not self.storage_path:
            return False
        now = time.time() if now is None else now
        with self._lock:
            snap = {
                "series": {
                    (k.metric, k.labels): list(q)
                    for k, q in self._series.items()
                },
                "kv": dict(self._kv),
            }
            self._last_flush = now
        tmp = self.storage_path + ".tmp"
        try:
            os.makedirs(os.path.dirname(self.storage_path) or ".", exist_ok=True)
            with open(tmp, "wb") as f:
                pickle.dump(snap, f)
            os.replace(tmp, self.storage_path)
        except OSError:
            return False
        return True

    def maybe_flush(self, now: Optional[float] = None) -> bool:
        """Periodic flush hook for the daemon loop."""
        now = time.time() if now is None else now
        if not self.storage_path or now - self._last_flush < self.flush_interval:
            return False
        self.flush(now)
        return True

    # -- samples -------------------------------------------------------------
    def add_sample(self, metric: str, value: float,
                   timestamp: Optional[float] = None, **labels: str) -> None:
        ts = time.time() if timestamp is None else timestamp
        key = SeriesKey.of(metric, **labels)
        with self._lock:
            q = self._series.setdefault(key, deque())
            q.append((ts, float(value)))
            cutoff = ts - self.retention
            while q and q[0][0] < cutoff:
                q.popleft()

    def _values(self, metric: str, window: Optional[float], now: Optional[float],
                **labels: str) -> List[float]:
        key = SeriesKey.of(metric, **labels)
        with self._lock:
            q = self._series.get(key)
            if not q:
                return []
            if window is None:
                return [v for _, v in q]
            now = time.time() if now is None else now
            cutoff = now - window
            return [v for ts, v in q if ts >= cutoff]

    def query(self, metric: str, agg: str = "latest",
              window: Optional[float] = None, now: Optional[float] = None,
              **labels: str) -> Optional[float]:
        vals = self._values(metric, window, now, **labels)
        if not vals:
            return None
        if agg == "latest":
            return vals[-1]
        if agg == "avg":
            return float(np.mean(vals))
        if agg == "count":
            return float(len(vals))
        if agg.startswith("p") and agg[1:].isdigit():
            return float(np.percentile(vals, int(agg[1:])))
        raise ValueError(f"unknown aggregation {agg!r}")

    def series_labels(self, metric: str) -> List[Dict[str, str]]:
        with self._lock:
            return [
                dict(k.labels) for k in self._series if k.metric == metric
            ]

    # -- KV (static info) ------------------------------------------------------
    def set_kv(self, key: str, value: Any) -> None:
        with self._lock:
            self._kv[key] = value

    def get_kv(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._kv.get(key)
