"""Resource executor: serialized, cached, audited cgroup/resctrl writer.

Analog of reference `pkg/koordlet/resourceexecutor/`:
  * last-written-value cache suppresses redundant writes (executor.go:203-264)
  * leveled batch updates apply parent dirs before children for limit increases
    and children first for decreases (LeveledUpdateBatch, executor.go:114) —
    order matters for cgroup hierarchies (a child limit can't exceed its parent)
  * merge-update semantics for guarded files (e.g. cpuset shrink keeps union
    until children release cpus) are approximated by the cache comparison
  * every mutation lands in the audit ring.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.koordlet.audit import Auditor
from koordinator_tpu_torch.koordlet.util import system as sysutil


@dataclass(frozen=True)
class ResourceUpdater:
    relative_dir: str
    resource: str
    value: str
    level: int = 0  # depth in the cgroup tree (0=qos root, 1=pod, 2=container)


class ResourceUpdateExecutor:
    def __init__(self, config: Optional[sysutil.SystemConfig] = None,
                 auditor: Optional[Auditor] = None):
        self.config = config if config is not None else sysutil.CONFIG
        # explicit None check: an empty Auditor is falsy via __len__, and `or`
        # would silently swap in a fresh one, detaching the daemon's audit ring
        self.auditor = auditor if auditor is not None else Auditor()
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[str, str], str] = {}

    def update(self, updater: ResourceUpdater, force: bool = False) -> bool:
        """Write unless cached value matches; returns whether a write happened."""
        key = (updater.relative_dir, updater.resource)
        with self._lock:
            if not force and self._cache.get(key) == updater.value:
                return False
            ok = sysutil.write_cgroup(
                updater.relative_dir, updater.resource, updater.value, self.config
            )
            if ok:
                self._cache[key] = updater.value
                self.auditor.record(
                    "info",
                    updater.relative_dir or "node",
                    "cgroup_write",
                    resource=updater.resource,
                    value=updater.value,
                )
            return ok

    def leveled_update_batch(self, updaters: List[ResourceUpdater],
                             increase: bool = True) -> int:
        """Apply a batch ordered by tree level: top-down when limits grow,
        bottom-up when they shrink (executor.go LeveledUpdateBatch)."""
        ordered = sorted(updaters, key=lambda u: u.level, reverse=not increase)
        wrote = 0
        for u in ordered:
            if self.update(u):
                wrote += 1
        return wrote

    def read(self, relative_dir: str, resource: str) -> Optional[str]:
        return sysutil.read_cgroup(relative_dir, resource, self.config)

    def cached_value(self, relative_dir: str, resource: str) -> Optional[str]:
        with self._lock:
            return self._cache.get((relative_dir, resource))
