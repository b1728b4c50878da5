"""CPU set algebra: analog of reference `pkg/util/cpuset/cpuset.go`.

Parses/serializes the Linux list format ("0-3,7,9-11") and provides set operations
used by the NUMA-resource plugin's cpu accumulator and koordlet's cpuset hooks.
Immutable, backed by frozenset.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, Iterator, List


class CPUSet:
    __slots__ = ("_cpus",)

    def __init__(self, cpus: Iterable[int] = ()):  # noqa: D107
        self._cpus: FrozenSet[int] = frozenset(int(c) for c in cpus)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def parse(s: str) -> "CPUSet":
        """Parse Linux cpu list format; empty string -> empty set."""
        s = s.strip()
        if not s:
            return CPUSet()
        out: List[int] = []
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "-" in part:
                lo_s, hi_s = part.split("-", 1)
                lo, hi = int(lo_s), int(hi_s)
                if hi < lo:
                    raise ValueError(f"invalid cpu range {part!r}")
                out.extend(range(lo, hi + 1))
            else:
                out.append(int(part))
        return CPUSet(out)

    # -- set algebra --------------------------------------------------------
    def union(self, other: "CPUSet") -> "CPUSet":
        return CPUSet(self._cpus | other._cpus)

    def intersection(self, other: "CPUSet") -> "CPUSet":
        return CPUSet(self._cpus & other._cpus)

    def difference(self, other: "CPUSet") -> "CPUSet":
        return CPUSet(self._cpus - other._cpus)

    def is_subset_of(self, other: "CPUSet") -> bool:
        return self._cpus <= other._cpus

    def contains(self, cpu: int) -> bool:
        return cpu in self._cpus

    # -- views --------------------------------------------------------------
    def to_list(self) -> List[int]:
        return sorted(self._cpus)

    def __len__(self) -> int:
        return len(self._cpus)

    def __iter__(self) -> Iterator[int]:
        return iter(sorted(self._cpus))

    def __bool__(self) -> bool:
        return bool(self._cpus)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, CPUSet) and self._cpus == other._cpus

    def __hash__(self) -> int:
        return hash(self._cpus)

    def __repr__(self) -> str:
        return f"CPUSet({self.format()!r})"

    def format(self) -> str:
        """Serialize to Linux list format with collapsed ranges."""
        cpus = self.to_list()
        if not cpus:
            return ""
        parts: List[str] = []
        start = prev = cpus[0]
        for c in cpus[1:] + [None]:  # type: ignore[list-item]
            if c is not None and c == prev + 1:
                prev = c
                continue
            parts.append(str(start) if start == prev else f"{start}-{prev}")
            if c is not None:
                start = prev = c
        return ",".join(parts)
