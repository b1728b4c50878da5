"""Priority bands.

Semantics from reference `apis/extension/priority.go:29-48`: four koordinator
priority classes mapped onto disjoint integer priority ranges:

    koord-prod  [9000, 9999]
    koord-mid   [7000, 7999]
    koord-batch [5000, 5999]
    koord-free  [3000, 3999]

A pod's priority class is resolved from (a) the `koordinator.sh/priority-class`
label, else (b) its numeric `spec.priority` mapped through the bands
(priority.go:74-104). Sub-priority within a band comes from the
`koordinator.sh/priority` label (priority.go:107-116).
"""

from __future__ import annotations

import enum
from typing import Optional


class PriorityClass(enum.IntEnum):
    """Int-encoded priority band (order: PROD highest)."""

    PROD = 0
    MID = 1
    BATCH = 2
    FREE = 3
    NONE = 4

    @property
    def label(self) -> str:
        return "" if self is PriorityClass.NONE else f"koord-{self.name.lower()}"


# Band boundaries (min, max), reference priority.go:38-48. Kept as module-level
# variables (not enum payload) because the reference allows customizing ranges.
PRIORITY_BANDS = {
    PriorityClass.PROD: (9000, 9999),
    PriorityClass.MID: (7000, 7999),
    PriorityClass.BATCH: (5000, 5999),
    PriorityClass.FREE: (3000, 3999),
}

# Default numeric priority assigned when only the class is known (the webhook picks
# the band max, mirroring ClusterColocationProfile defaulting).
DEFAULT_PRIORITY_BY_CLASS = {cls: hi for cls, (_, hi) in PRIORITY_BANDS.items()}

_BY_LABEL = {c.label: c for c in PriorityClass if c is not PriorityClass.NONE}


def priority_class_by_name(label: str) -> PriorityClass:
    """Resolve a priority-class label; unknown -> NONE (priority.go:60-69)."""
    return _BY_LABEL.get(label, PriorityClass.NONE)


def priority_class_by_value(priority: Optional[int]) -> PriorityClass:
    """Map a numeric pod priority into its band; outside all bands -> NONE
    (priority.go:86-104)."""
    if priority is None:
        return PriorityClass.NONE
    for cls, (lo, hi) in PRIORITY_BANDS.items():
        if lo <= priority <= hi:
            return cls
    return PriorityClass.NONE
