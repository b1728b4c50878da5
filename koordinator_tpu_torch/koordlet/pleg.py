"""PLEG: pod lifecycle event generator.

Analog of reference `pkg/koordlet/pleg/pleg.go:75-246`: the reference inotify-
watches cgroup directories; here a portable polling scan of the kubepods tree
diffs pod/container dirs between ticks and emits events to handlers (drives the
pod-informer resync)."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Set

from koordinator_tpu_torch.koordlet.util import system as sysutil

# pod cgroup dirs: "pod<uid>" (cgroupfs) or "kubepods[-<qos>]-pod<uid>.slice"
# (systemd driver)
_POD_DIR = re.compile(r"^(pod|kubepods(-[a-z]+)?-pod)")


@dataclass(frozen=True)
class PodLifecycleEvent:
    event_type: str  # "pod_added" | "pod_deleted"
    pod_dir: str


Handler = Callable[[PodLifecycleEvent], None]


class Pleg:
    def __init__(self, config: Optional[sysutil.SystemConfig] = None):
        self.config = config or sysutil.CONFIG
        self.handlers: List[Handler] = []
        self._known: Optional[Set[str]] = None

    def add_handler(self, handler: Handler) -> None:
        self.handlers.append(handler)

    def _scan(self) -> Set[str]:
        found: Set[str] = set()
        root = self.config.cgroup_root_dir
        if not self.config.use_cgroup_v2:
            root = os.path.join(root, "cpu")
        for qos in ("", sysutil.QOS_BESTEFFORT, sysutil.QOS_BURSTABLE):
            qos_dir = os.path.join(root, self.config.qos_relative_path(qos))
            try:
                for entry in os.listdir(qos_dir):
                    if _POD_DIR.match(entry):
                        found.add(os.path.join(self.config.qos_relative_path(qos), entry))
            except OSError:
                continue
        return found

    def tick(self) -> List[PodLifecycleEvent]:
        """Diff the cgroup tree; emit + return events."""
        current = self._scan()
        events: List[PodLifecycleEvent] = []
        if self._known is not None:
            for added in sorted(current - self._known):
                events.append(PodLifecycleEvent("pod_added", added))
            for removed in sorted(self._known - current):
                events.append(PodLifecycleEvent("pod_deleted", removed))
        self._known = current
        for ev in events:
            for h in self.handlers:
                h(ev)
        return events
