"""QoS classes.

Semantics from reference `apis/extension/qos.go:22-39`: five classes
LSE/LSR/LS/BE/SYSTEM plus the empty "none"; unknown strings resolve to none.

The integer values double as the on-device encoding used by the packed pod tensors
(`ops/packing.py`); ordering is chosen so that comparisons "is latency sensitive"
(< BE) are single vectorized compares.
"""

from __future__ import annotations

import enum


class QoSClass(enum.IntEnum):
    """Koordinator QoS class, int-encoded for device tensors."""

    LSE = 0  # latency-sensitive exclusive: pinned cpus, no sharing
    LSR = 1  # latency-sensitive reserved: pinned cpus, sharable with BE suppression
    LS = 2   # latency-sensitive (shared pool)
    BE = 3   # best-effort (colocated batch; runs on batch-* resources)
    SYSTEM = 4
    NONE = 5

    @property
    def label(self) -> str:
        return "" if self is QoSClass.NONE else self.name

    @property
    def is_latency_sensitive(self) -> bool:
        return self in (QoSClass.LSE, QoSClass.LSR, QoSClass.LS)

    @property
    def is_best_effort(self) -> bool:
        return self is QoSClass.BE


_BY_NAME = {c.name: c for c in QoSClass if c is not QoSClass.NONE}


def qos_class_by_name(name: str) -> QoSClass:
    """Resolve a QoS label value; unknown -> NONE (qos.go:31-39)."""
    return _BY_NAME.get(name, QoSClass.NONE)
