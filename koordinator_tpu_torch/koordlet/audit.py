"""Audit: ring buffer of node mutations with token-paged queries.

Analog of reference `pkg/koordlet/audit/auditor.go:38-247`: every cgroup/resctrl
write is recorded (wired through the resource executor); consumers page through
events with an opaque token.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class AuditEvent:
    seq: int
    timestamp: float
    level: str
    group: str          # e.g. "node", "pod/<uid>"
    operation: str      # e.g. "cgroup_write"
    detail: Dict[str, str] = field(default_factory=dict)


class Auditor:
    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._buf: List[AuditEvent] = []
        self._capacity = capacity
        self._seq = 0

    def record(self, level: str, group: str, operation: str, **detail: str) -> None:
        with self._lock:
            self._seq += 1
            self._buf.append(
                AuditEvent(self._seq, time.time(), level, group, operation,
                           {k: str(v) for k, v in detail.items()})
            )
            if len(self._buf) > self._capacity:
                self._buf = self._buf[-self._capacity:]

    def query(self, token: Optional[int] = None, limit: int = 100) -> Tuple[List[AuditEvent], int]:
        """Events with seq > token (oldest first); returns (events, next_token)."""
        with self._lock:
            start = token or 0
            out = [e for e in self._buf if e.seq > start][:limit]
            next_token = out[-1].seq if out else start
            return out, next_token

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)
