"""NUMA-affinity bitmasks: analog of reference `pkg/util/bitmask/bitmask.go`.

Used by the topology manager (frameworkext/topologymanager) to merge per-plugin NUMA
hints: masks are AND-ed across providers and the "narrowest" preferred mask wins.
Backed by a plain int; NUMA node count is small (K <= 8) so this is cheap on host,
and `ops/numa.py` enumerates all 2^K masks statically for the device-side admit.
"""

from __future__ import annotations

from typing import Iterable, List


class BitMask:
    __slots__ = ("_bits",)

    def __init__(self, bits: Iterable[int] = ()):  # noqa: D107
        v = 0
        for b in bits:
            if b < 0 or b >= 64:
                raise ValueError(f"bit {b} out of range")
            v |= 1 << b
        self._bits = v

    @staticmethod
    def from_int(v: int) -> "BitMask":
        m = BitMask()
        m._bits = v
        return m

    @staticmethod
    def fill(count: int) -> "BitMask":
        return BitMask(range(count))

    def and_(self, *others: "BitMask") -> "BitMask":
        v = self._bits
        for o in others:
            v &= o._bits
        return BitMask.from_int(v)

    def or_(self, *others: "BitMask") -> "BitMask":
        v = self._bits
        for o in others:
            v |= o._bits
        return BitMask.from_int(v)

    def count(self) -> int:
        return bin(self._bits).count("1")

    def is_set(self, bit: int) -> bool:
        return bool(self._bits >> bit & 1)

    def is_empty(self) -> bool:
        return self._bits == 0

    def is_narrower_than(self, other: "BitMask") -> bool:
        """Fewer set bits wins; tie broken by lower numeric value (reference
        bitmask.IsNarrowerThan: prefers masks with lower-numbered bits)."""
        if self.count() == other.count():
            return self._bits < other._bits
        return self.count() < other.count()

    def get_bits(self) -> List[int]:
        return [i for i in range(64) if self.is_set(i)]

    def to_int(self) -> int:
        return self._bits

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BitMask) and self._bits == other._bits

    def __hash__(self) -> int:
        return hash(self._bits)

    def __repr__(self) -> str:
        return f"BitMask({self.get_bits()})"
