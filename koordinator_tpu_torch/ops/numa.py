"""NodeNUMAResource: NUMA-aware fit + topology-policy admit + scoring rows.

Reference: `pkg/scheduler/plugins/nodenumaresource/` (see the JAX package's
ops/numa.py for the batched formulation). With K NUMA zones per node the fit
check per policy reduces to
  single-numa-node : exists k with req <= free[k] (choose lowest such k)
  restricted       : total fit
  best-effort/none : total fit
so no 2^K mask enumeration is needed on the device.

In-round state: numa_free[N, K, R] (zone free), bind_free[N] (bindable cpu
count). A placement subtracts from the chosen zone (single-numa) or fills the
lowest zones first (every other policy).
"""

from __future__ import annotations

from typing import Tuple

import torch

MAX_NUMA = 8

POLICY_NONE = 0
POLICY_SINGLE_NUMA_NODE = 1
POLICY_RESTRICTED = 2
POLICY_BEST_EFFORT = 3

POLICY_BY_NAME = {
    "": POLICY_NONE,
    "None": POLICY_NONE,
    "none": POLICY_NONE,
    "SingleNUMANode": POLICY_SINGLE_NUMA_NODE,
    "single-numa-node": POLICY_SINGLE_NUMA_NODE,
    "Restricted": POLICY_RESTRICTED,
    "restricted": POLICY_RESTRICTED,
    "BestEffort": POLICY_BEST_EFFORT,
    "best-effort": POLICY_BEST_EFFORT,
}


def zone_total(numa_free: torch.Tensor) -> torch.Tensor:
    """[N, R] free summed over zones in ascending zone order (the order every
    implementation of the round uses)."""
    total = numa_free[:, 0]
    for k in range(1, numa_free.shape[1]):
        total = total + numa_free[:, k]
    return total


def numa_admit_row(
    request: torch.Tensor,      # [R] pod request (packed units)
    needs_numa: torch.Tensor,   # 0-d bool: pod subject to NUMA admission
    numa_free: torch.Tensor,    # [N, K, R]
    policy: torch.Tensor,       # [N] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ok[N], zone[N]): admit + chosen zone (-1 when not single-numa).
    Zero-request axes never constrain (k8s semantics)."""
    req = request[None, None, :]
    fits_zone = ((req <= 0) | (req <= numa_free)).all(dim=-1)          # [N, K]
    total_free = zone_total(numa_free)                                  # [N, R]
    fits_total = ((request[None, :] <= 0)
                  | (request[None, :] <= total_free)).all(dim=-1)
    any_zone = fits_zone.any(dim=-1)
    # argmax returns the first maximal index: the lowest fitting zone
    first_zone = fits_zone.to(torch.int32).argmax(dim=-1).to(torch.int32)
    single = policy == POLICY_SINGLE_NUMA_NODE
    ok = torch.where(single, any_zone, fits_total)
    ok = ok | (policy == POLICY_NONE)
    ok = ok | ~needs_numa
    zone = torch.where(single & any_zone & needs_numa, first_zone, -1)
    return ok, zone


def cpuset_filter_row(
    needs_bind: torch.Tensor,    # 0-d bool: pod requires cpuset binding
    cores_needed: torch.Tensor,  # 0-d f32: whole cpus requested
    full_pcpus: torch.Tensor,    # 0-d bool: FullPCPUs policy resolved
    has_topology: torch.Tensor,  # [N] bool
    bind_free: torch.Tensor,     # [N] bindable cpus available
    cpus_per_core: torch.Tensor,  # [N]
) -> torch.Tensor:
    """[N] bool: cpuset feasibility (plugin.go:303-338 —
    ErrInvalidCPUTopology, ErrSMTAlignmentError, capacity)."""
    rem = torch.remainder(cores_needed, torch.clamp_min(cpus_per_core, 1.0))
    smt_ok = ~full_pcpus | (rem.abs() < 0.5)
    ok = has_topology & smt_ok & (cores_needed <= bind_free)
    return ok | ~needs_bind


def numa_spread_fill(
    numa_free_n: torch.Tensor,  # [K, R] free of the chosen node
    request: torch.Tensor,      # [R]
    zone: torch.Tensor,         # 0-d int32 (-1 = spread fill)
) -> torch.Tensor:
    """New [K, R] after subtracting the request: all from `zone` when
    single-numa, else the lowest-zones-first waterfall. Both branches are
    computed and selected on the device, so the round never syncs here."""
    K = numa_free_n.shape[0]
    ks = torch.arange(K, dtype=torch.int32, device=numa_free_n.device)
    onehot = (ks == zone).to(numa_free_n.dtype)
    single = numa_free_n - onehot[:, None] * request[None, :]
    remaining = request
    rows = []
    for k in range(K):
        take = torch.minimum(numa_free_n[k], remaining)
        rows.append(numa_free_n[k] - take)
        remaining = remaining - take
    spread = torch.stack(rows)
    return torch.where(zone >= 0, single, spread)


def numa_score_row(
    request: torch.Tensor,         # [R]
    node_requested: torch.Tensor,  # [N, R]
    allocatable: torch.Tensor,     # [N, R]
    weights: torch.Tensor,         # [R]
    weight_idx: Tuple[int, ...],
) -> torch.Tensor:
    """[N] NodeNUMAResource least-allocated score over requested + request
    vs allocatable (scoring.go, v1beta2 default strategy cpu=1, memory=1)."""
    from koordinator_tpu_torch.ops.common import least_requested_score

    acc = torch.zeros(allocatable.shape[0], dtype=torch.float32,
                      device=allocatable.device)
    wsum = weights.sum()
    for r in weight_idx:
        used = node_requested[:, r] + request[r]
        acc = acc + weights[r] * least_requested_score(used, allocatable[:, r])
    return torch.floor(acc / torch.clamp_min(wsum, 1.0))
