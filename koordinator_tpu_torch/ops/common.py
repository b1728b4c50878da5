"""Shared helpers reproducing Go arithmetic semantics, in torch.

The reference computes scores with int64 arithmetic (floor division) and
percent ratios with math.Round (half away from zero). Binding parity with the
JAX package requires the same f32 operations in the same order; the plain
round and the CUDA kernel (csrc/kernel_common.cuh) both follow these forms.
"""

from __future__ import annotations

import numpy as np
import torch

# kube-scheduler framework.MaxNodeScore
MAX_NODE_SCORE = 100.0


def go_round(x: torch.Tensor) -> torch.Tensor:
    """math.Round for non-negative values: half away from zero (torch.round
    is round-half-to-even, which would flip threshold crossings)."""
    return torch.floor(x + 0.5)


def go_round_np(x):
    """Host-numpy twin of go_round (same half-away-from-zero semantics)."""
    return np.floor(x + 0.5)


def least_requested_score(requested: torch.Tensor,
                          capacity: torch.Tensor) -> torch.Tensor:
    """kube-scheduler leastRequestedScore (load_aware.go:389-397): 0 when
    capacity is 0 or requested > capacity, else
    floor((capacity - requested) * 100 / capacity)."""
    safe_cap = torch.where(capacity > 0, capacity, 1.0)
    raw = torch.floor((capacity - requested) * MAX_NODE_SCORE / safe_cap)
    return torch.where((capacity > 0) & (requested <= capacity), raw, 0.0)


def most_requested_score(requested: torch.Tensor,
                         capacity: torch.Tensor) -> torch.Tensor:
    """mostAllocated scorer (nodenumaresource/most_allocated.go): 0 when
    capacity is 0 or requested > capacity, else
    floor(requested * 100 / capacity)."""
    safe_cap = torch.where(capacity > 0, capacity, 1.0)
    raw = torch.floor(requested * MAX_NODE_SCORE / safe_cap)
    return torch.where((capacity > 0) & (requested <= capacity), raw, 0.0)


def weighted_mean_floor(scores: torch.Tensor, weights: torch.Tensor,
                        dim: int = -1) -> torch.Tensor:
    """floor(sum(score * w) / sum(w)) — Go integer division of int64 sums."""
    wsum = weights.sum()
    safe = torch.where(wsum > 0, wsum, 1.0)
    out = torch.floor((scores * weights).sum(dim=dim) / safe)
    return torch.where(wsum > 0, out, 0.0)
