"""Decaying histogram: analog of reference `pkg/util/histogram/` (VPA-style).

Used by koordlet's peak-usage predictor (pkg/koordlet/prediction/peak_predictor.go):
samples are added with exponentially-decaying weight (half-life), percentiles are read
from bucket boundaries. Exponential bucket scheme mirrors the reference's
NewExponentialHistogramOptions(maxValue, firstBucketSize, ratio, epsilon).

Histograms stay on the host — they are tiny (O(100) buckets per UID) and feed
the Mid-tier resource calculation; the batched math consumes only their percentile
outputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class HistogramOptions:
    num_buckets: int
    bucket_start: List[float]  # lower bound of each bucket, ascending
    epsilon: float = 1e-4

    @staticmethod
    def exponential(
        max_value: float, first_bucket_size: float, ratio: float, epsilon: float = 1e-4
    ) -> "HistogramOptions":
        if max_value <= 0 or first_bucket_size <= 0 or ratio <= 1:
            raise ValueError("invalid exponential histogram options")
        num = 1 + int(
            math.ceil(
                math.log(max_value * (ratio - 1) / first_bucket_size + 1)
                / math.log(ratio)
            )
        )
        starts = [0.0]
        for i in range(1, num):
            starts.append(first_bucket_size * (ratio**i - 1) / (ratio - 1))
        return HistogramOptions(num_buckets=num, bucket_start=starts, epsilon=epsilon)

    @staticmethod
    def linear(max_value: float, bucket_size: float, epsilon: float = 1e-4) -> "HistogramOptions":
        num = 1 + int(math.ceil(max_value / bucket_size))
        return HistogramOptions(
            num_buckets=num,
            bucket_start=[i * bucket_size for i in range(num)],
            epsilon=epsilon,
        )

    def find_bucket(self, value: float) -> int:
        if value < self.bucket_start[0]:
            return 0
        lo, hi = 0, self.num_buckets - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.bucket_start[mid] <= value:
                lo = mid
            else:
                hi = mid - 1
        return lo


class DecayingHistogram:
    """Histogram whose sample weights decay with half-life anchored at a reference
    time, matching the reference's decayingHistogram: weight(t) = 2^((t-t0)/halflife).
    """

    def __init__(self, options: HistogramOptions, half_life_seconds: float = 86400.0):
        self.options = options
        self.half_life = half_life_seconds
        self.weights = [0.0] * options.num_buckets
        self.total_weight = 0.0
        self.reference_time = 0.0

    def _decay_factor(self, timestamp: float) -> float:
        return 2.0 ** ((timestamp - self.reference_time) / self.half_life)

    def _shift_reference(self, timestamp: float) -> None:
        # keep exponents small by re-anchoring when drifting > half_life
        if timestamp - self.reference_time < self.half_life:
            return
        shift = 2.0 ** ((self.reference_time - timestamp) / self.half_life)
        self.weights = [w * shift for w in self.weights]
        self.total_weight *= shift
        self.reference_time = timestamp

    def add_sample(self, value: float, weight: float, timestamp: float) -> None:
        self._shift_reference(timestamp)
        w = weight * self._decay_factor(timestamp)
        b = self.options.find_bucket(value)
        self.weights[b] += w
        self.total_weight += w

    def percentile(self, p: float) -> float:
        """Return the upper bound of the bucket at cumulative fraction p (0..1);
        empty histogram -> 0 (matching reference Percentile)."""
        if self.is_empty():
            return 0.0
        threshold = p * self.total_weight
        acc = 0.0
        b = 0
        for i, w in enumerate(self.weights):
            acc += w
            b = i
            if acc >= threshold:
                break
        if b < self.options.num_buckets - 1:
            return self.options.bucket_start[b + 1]
        return self.options.bucket_start[b]

    def is_empty(self) -> bool:
        return self.total_weight < self.options.epsilon

    # -- checkpointing (prediction/checkpoint.go:36-95) ---------------------
    def to_checkpoint(self) -> dict:
        return {
            "weights": list(self.weights),
            "total_weight": self.total_weight,
            "reference_time": self.reference_time,
            "half_life": self.half_life,
        }

    @staticmethod
    def from_checkpoint(options: HistogramOptions, data: dict) -> "DecayingHistogram":
        weights = data.get("weights", [])
        if len(weights) != options.num_buckets:
            raise ValueError(
                f"checkpoint has {len(weights)} buckets, options expect "
                f"{options.num_buckets}; refusing to restore"
            )
        h = DecayingHistogram(options, data.get("half_life", 86400.0))
        h.weights = [float(w) for w in weights]
        h.total_weight = float(data.get("total_weight", 0.0))
        h.reference_time = float(data.get("reference_time", 0.0))
        return h
