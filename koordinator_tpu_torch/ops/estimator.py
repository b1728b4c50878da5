"""Pod/node usage estimator.

Faithful reimplementation of the LoadAware default estimator
(`pkg/scheduler/plugins/loadaware/estimator/default_estimator.go:56-108`):

  for each weighted resource (native name, e.g. cpu/memory):
    real = translate by priority class (cpu -> batch-cpu for koord-batch pods, ...)
    if limit > request: quantity = limit, scalingFactor = 100
    else:               quantity = request, scalingFactor = args factor
    if quantity == 0:   cpu-like -> 250 milli, memory-like -> 200 MiB, else 0
    estimated = round(quantity * scalingFactor / 100), capped at limit when set

Estimates are keyed by the NATIVE resource axis (the scorer compares against native
node allocatable even for batch/mid pods). Units are packed units (milli-cpu / MiB),
applied identically in the serial parity emulator.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from koordinator_tpu_torch.api.objects import Node, Pod
from koordinator_tpu_torch.api.resources import (
    NUM_RESOURCES,
    RESOURCE_INDEX,
    ResourceName,
    translate_resource_by_priority_class,
)

# default_estimator.go:35-38 (packed units)
DEFAULT_MILLI_CPU_REQUEST = 250.0
DEFAULT_MEMORY_REQUEST_MIB = 200.0

_CPU_LIKE = {ResourceName.CPU, ResourceName.BATCH_CPU, ResourceName.MID_CPU}
_MEMORY_LIKE = {ResourceName.MEMORY, ResourceName.BATCH_MEMORY, ResourceName.MID_MEMORY}


def estimate_pod_used(
    pod: Pod,
    resource_weights: Dict[str, int],
    scaling_factors: Dict[str, int],
) -> np.ndarray:
    """Return the [R] float32 estimated-usage vector (native axes only)."""
    req = pod.spec.requests.to_vector().astype(np.float64)
    lim = pod.spec.limits.to_vector().astype(np.float64)
    prio_class = pod.priority_class
    out = np.zeros(NUM_RESOURCES, dtype=np.float64)
    for native in resource_weights:
        real = translate_resource_by_priority_class(prio_class, native)
        if real is None:
            continue
        i_real = RESOURCE_INDEX[real]
        limit_q, request_q = lim[i_real], req[i_real]
        if limit_q > request_q:
            quantity, factor = limit_q, 100.0
        else:
            quantity, factor = request_q, float(scaling_factors.get(native, 100))
        if quantity == 0:
            if real in _CPU_LIKE:
                est = DEFAULT_MILLI_CPU_REQUEST
            elif real in _MEMORY_LIKE:
                est = DEFAULT_MEMORY_REQUEST_MIB
            else:
                est = 0.0
        else:
            est = np.floor(quantity * factor / 100.0 + 0.5)  # go_round
            if limit_q > 0:
                est = min(est, limit_q)
        out[RESOURCE_INDEX[native]] = est
    return out.astype(np.float32)


def estimate_pods_used_batch(
    req_packed: np.ndarray,      # [n, R] packed requests (to_vector units)
    lim_packed: np.ndarray,      # [n, R] packed limits
    prio_class: np.ndarray,      # [n] int PriorityClass values
    resource_weights: Dict[str, int],
    scaling_factors: Dict[str, int],
) -> np.ndarray:
    """Vectorized estimate_pod_used over a whole batch: identical math, one
    set of numpy ops per (priority class, weighted axis) pair instead of a
    python loop per pod — the host-side packing hot path at 10k pods."""
    from koordinator_tpu_torch.api.priority import PriorityClass

    n = req_packed.shape[0]
    req = req_packed.astype(np.float64)
    lim = lim_packed.astype(np.float64)
    out = np.zeros((n, NUM_RESOURCES), np.float64)
    classes = np.unique(prio_class)
    for native in resource_weights:
        i_native = RESOURCE_INDEX[native]
        if native in _CPU_LIKE:
            default = DEFAULT_MILLI_CPU_REQUEST
        elif native in _MEMORY_LIKE:
            default = DEFAULT_MEMORY_REQUEST_MIB
        else:
            default = 0.0
        factor_cfg = float(scaling_factors.get(native, 100))
        for cls_value in classes:
            real = translate_resource_by_priority_class(
                PriorityClass(int(cls_value)), native
            )
            if real is None:
                continue
            rows = prio_class == cls_value
            i_real = RESOURCE_INDEX[real]
            limit_q = lim[rows, i_real]
            request_q = req[rows, i_real]
            over = limit_q > request_q
            quantity = np.where(over, limit_q, request_q)
            factor = np.where(over, 100.0, factor_cfg)
            est = np.floor(quantity * factor / 100.0 + 0.5)  # go_round
            est = np.where(limit_q > 0, np.minimum(est, limit_q), est)
            est = np.where(quantity == 0, default, est)
            out[rows, i_native] = est
    return out.astype(np.float32)


def estimate_node_allocatable(node: Node) -> np.ndarray:
    """EstimateNode (default_estimator.go:110+): raw-allocatable annotation wins
    over status.allocatable when present (resource amplification); we model the
    amplified value directly on Node.allocatable. The node-reservation
    annotation (applyPolicy Default) trims schedulable allocatable — except
    the batch-* axes, which koord-manager already reserved-adjusted
    (pkg/util/node.go TrimNodeAllocatableByNodeReservation)."""
    vec = node.allocatable.to_vector()
    reserved, _cpus, trims = node.node_reservation()
    if trims and reserved.quantities:
        from koordinator_tpu_torch.api.resources import BATCH_AXES

        rvec = reserved.to_vector()
        rvec[list(BATCH_AXES)] = 0.0
        vec = np.maximum(vec - rvec, 0.0)
    return vec
