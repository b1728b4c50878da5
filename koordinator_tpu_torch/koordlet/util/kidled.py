"""kidled cold-memory accounting (Anolis kernel idle-page scanner).

Analog of reference `pkg/koordlet/util/system/kidled_util.go`: the kidled
kernel thread ages idle pages into exponential buckets; per-cgroup
`memory.idle_page_stats` reports bytes per (page kind x age bucket). The
coldmemoryresource collector sums buckets older than `coldBoundary` scan
periods to compute reclaimable "cold" memory, which feeds the batch-memory
calculation (cold pages are effectively free capacity).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from koordinator_tpu_torch.koordlet.util import system as sysutil

KIDLED_SCAN_PERIOD = "kernel/mm/kidled/scan_period_in_seconds"
KIDLED_USE_HIERARCHY = "kernel/mm/kidled/use_hierarchy"
IDLE_PAGE_STATS = "memory.idle_page_stats"

# idle_page_stats rows: csei/dsei/cfei/dfei/csui/dsui/cfui/dfui/csea/dsea/...
# (clean/dirty x swappable/file x evictable/unevictable x inactive/active);
# columns are age buckets [1,2,5,15,30,60,120,240] scan periods.
_STATS_ROW = re.compile(r"^\s*([a-z]{4})\s+((?:\d+\s*)+)$")
DEFAULT_BUCKETS = [1, 2, 5, 15, 30, 60, 120, 240]


@dataclass
class IdlePageStats:
    version: str = ""
    scans: int = 0
    scan_period_s: int = 0
    buckets: List[int] = field(default_factory=lambda: list(DEFAULT_BUCKETS))
    rows: Dict[str, List[int]] = field(default_factory=dict)

    def cold_bytes(self, cold_boundary_s: int) -> int:
        """Sum of all pages idle for >= cold_boundary_s seconds."""
        if not self.rows or self.scan_period_s <= 0:
            return 0
        start = 0
        for i, periods in enumerate(self.buckets):
            if periods * self.scan_period_s >= cold_boundary_s:
                start = i
                break
        else:
            return 0
        return sum(sum(vals[start:]) for vals in self.rows.values())


def parse_idle_page_stats(content: str) -> IdlePageStats:
    out = IdlePageStats()
    for line in content.splitlines():
        if line.startswith("# version:"):
            out.version = line.split(":", 1)[1].strip()
        elif line.startswith("# scans:"):
            out.scans = int(line.split(":", 1)[1])
        elif line.startswith("# scan_period_in_seconds:"):
            out.scan_period_s = int(line.split(":", 1)[1])
        elif line.startswith("# buckets:"):
            out.buckets = [int(x) for x in
                           line.split(":", 1)[1].replace(",", " ").split()]
        else:
            m = _STATS_ROW.match(line)
            if m:
                out.rows[m.group(1)] = [int(x) for x in m.group(2).split()]
    return out


class KidledInterface:
    def __init__(self, config: Optional[sysutil.SystemConfig] = None):
        self.config = config or sysutil.CONFIG

    def _sys(self, rel: str) -> str:
        return os.path.join(self.config.sys_root_dir, rel)

    def supported(self) -> bool:
        return sysutil.read_file(self._sys(KIDLED_SCAN_PERIOD)) is not None

    def scan_period_s(self) -> int:
        raw = sysutil.read_file(self._sys(KIDLED_SCAN_PERIOD))
        return int(raw) if raw and raw.lstrip("-").isdigit() else 0

    def enabled(self) -> bool:
        return self.scan_period_s() > 0

    def enable(self, scan_period_s: int = 120, use_hierarchy: bool = True) -> bool:
        ok = sysutil.write_file(self._sys(KIDLED_SCAN_PERIOD), str(scan_period_s))
        ok = sysutil.write_file(
            self._sys(KIDLED_USE_HIERARCHY), "1" if use_hierarchy else "0") and ok
        return ok

    def read_pod_stats(self, relative_dir: str) -> Optional[IdlePageStats]:
        raw = sysutil.read_cgroup(relative_dir, IDLE_PAGE_STATS, self.config)
        return parse_idle_page_stats(raw) if raw is not None else None

    def pod_cold_bytes(self, relative_dir: str, cold_boundary_s: int = 300) -> int:
        stats = self.read_pod_stats(relative_dir)
        return stats.cold_bytes(cold_boundary_s) if stats else 0
