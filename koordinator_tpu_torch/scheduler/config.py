"""Scheduler componentconfig: versioned plugin args, defaulting, validation.

Analog of reference `pkg/scheduler/apis/config/` (types.go:30-214, v1beta2
defaults, validation/): each plugin's knobs are a dataclass with the v1beta2
defaults baked in; `from_dict` decodes a config-file mapping with unknown-key
rejection (strict decoding, as the reference's scheme does); `validate()`
raises `ConfigValidationError` aggregating every violation.

`LoadAwareArgs` lives in ops/loadaware.py (device kernel + host share it);
it is re-exported and validated here so `SchedulerConfiguration` covers all
seven plugins.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.cpu_topology import (
    FULL_PCPUS,
    NUMA_LEAST_ALLOCATED,
    NUMA_MOST_ALLOCATED,
    SPREAD_BY_PCPUS,
)


class ConfigValidationError(ValueError):
    def __init__(self, errors: List[str]):
        super().__init__("; ".join(errors))
        self.errors = errors


@dataclass
class NodeNUMAResourceArgs:
    """types.go NodeNUMAResourceArgs. (The reference's scoringStrategy field
    has no analog here: node scoring happens in the batched kernel, not the
    host plugin — only knobs with real consumers are exposed.)"""

    default_cpu_bind_policy: str = FULL_PCPUS
    numa_allocate_strategy: str = NUMA_MOST_ALLOCATED
    max_ref_count: int = 1

    def validate(self) -> List[str]:
        errs = []
        if self.default_cpu_bind_policy not in (FULL_PCPUS, SPREAD_BY_PCPUS):
            errs.append(
                f"defaultCPUBindPolicy: unknown {self.default_cpu_bind_policy!r}")
        if self.numa_allocate_strategy not in (
                NUMA_MOST_ALLOCATED, NUMA_LEAST_ALLOCATED):
            errs.append(
                f"numaAllocateStrategy: unknown {self.numa_allocate_strategy!r}")
        if self.max_ref_count < 1:
            errs.append("maxRefCount: must be >= 1")
        return errs


@dataclass
class ReservationArgs:
    """types.go ReservationArgs. (Candidate-node sampling knobs from the
    reference don't apply — the batched kernel evaluates every node.)"""

    gc_duration_seconds: float = 24 * 3600.0

    def validate(self) -> List[str]:
        if self.gc_duration_seconds <= 0:
            return ["gcDurationSeconds: must be > 0"]
        return []


@dataclass
class ElasticQuotaArgs:
    """types.go ElasticQuotaArgs."""

    delay_evict_time_seconds: float = 300.0
    revoke_pod_interval_seconds: float = 60.0
    monitor_all_quotas: bool = False

    def validate(self) -> List[str]:
        errs = []
        if self.delay_evict_time_seconds < 0:
            errs.append("delayEvictTime: must be >= 0")
        if self.revoke_pod_interval_seconds <= 0:
            errs.append("revokePodInterval: must be > 0")
        return errs


@dataclass
class CoschedulingArgs:
    """types.go CoschedulingArgs."""

    default_timeout_seconds: float = 600.0
    controller_workers: int = 1

    def validate(self) -> List[str]:
        errs = []
        if self.default_timeout_seconds <= 0:
            errs.append("defaultTimeout: must be > 0")
        if self.controller_workers < 1:
            errs.append("controllerWorkers: must be >= 1")
        return errs


@dataclass
class DeviceShareArgs:
    """types.go DeviceShareArgs."""

    # MostAllocated packs fractional GPU requests (the reference allocator's
    # default preference); LeastAllocated spreads them
    scoring_strategy: str = "MostAllocated"

    def validate(self) -> List[str]:
        if self.scoring_strategy not in ("LeastAllocated", "MostAllocated"):
            return [f"scoringStrategy: unknown {self.scoring_strategy!r}"]
        return []


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _validate_loadaware(args: LoadAwareArgs) -> List[str]:
    errs = []
    if args.node_metric_expiration_seconds <= 0:
        errs.append("nodeMetricExpirationSeconds: must be > 0")
    for name, w in args.resource_weights.items():
        if not _num(w) or w < 0:
            errs.append(f"resourceWeights[{name}]: must be a number >= 0")
    for name, pct in {**args.usage_thresholds,
                      **args.prod_usage_thresholds}.items():
        if not _num(pct) or not (0 <= pct <= 100):
            errs.append(f"usageThresholds[{name}]: must be in [0,100]")
    for name, pct in args.estimated_scaling_factors.items():
        if not _num(pct) or not (0 < pct <= 100):
            errs.append(f"estimatedScalingFactors[{name}]: must be in (0,100]")
    if args.agg_usage_aggregation_type not in (
            "", "avg", "p50", "p90", "p95", "p99"):
        errs.append(
            f"aggregated.usageAggregationType: unknown "
            f"{args.agg_usage_aggregation_type!r}")
    return errs


@dataclass
class SchedulerConfiguration:
    """All plugin args under their registered plugin names."""

    load_aware: LoadAwareArgs = field(default_factory=LoadAwareArgs)
    node_numa_resource: NodeNUMAResourceArgs = field(
        default_factory=NodeNUMAResourceArgs)
    reservation: ReservationArgs = field(default_factory=ReservationArgs)
    elastic_quota: ElasticQuotaArgs = field(default_factory=ElasticQuotaArgs)
    coscheduling: CoschedulingArgs = field(default_factory=CoschedulingArgs)
    device_share: DeviceShareArgs = field(default_factory=DeviceShareArgs)

    def validate(self) -> None:
        errs = _validate_loadaware(self.load_aware)
        for section in (self.node_numa_resource, self.reservation,
                        self.elastic_quota, self.coscheduling,
                        self.device_share):
            errs.extend(section.validate())
        if errs:
            raise ConfigValidationError(errs)


_SECTION_TYPES = {
    "LoadAwareScheduling": ("load_aware", LoadAwareArgs),
    "NodeNUMAResource": ("node_numa_resource", NodeNUMAResourceArgs),
    "Reservation": ("reservation", ReservationArgs),
    "ElasticQuota": ("elastic_quota", ElasticQuotaArgs),
    "Coscheduling": ("coscheduling", CoschedulingArgs),
    "DeviceShare": ("device_share", DeviceShareArgs),
}


def from_dict(raw: Dict[str, Any],
              validate: bool = True) -> SchedulerConfiguration:
    """Decode {pluginName: {field: value}} strictly: unknown plugin or field
    names are errors (the reference's scheme decoding posture), missing fields
    take the v1beta2 defaults."""
    cfg = SchedulerConfiguration()
    errs: List[str] = []
    for section_name, fields in raw.items():
        if section_name not in _SECTION_TYPES:
            errs.append(f"unknown plugin config section {section_name!r}")
            continue
        attr, cls = _SECTION_TYPES[section_name]
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in (fields or {}).items():
            if key not in known:
                errs.append(f"{section_name}: unknown field {key!r}")
                continue
            kwargs[key] = value
        try:
            setattr(cfg, attr, cls(**kwargs))
        except TypeError as e:
            errs.append(f"{section_name}: {e}")
    if errs:
        raise ConfigValidationError(errs)
    if validate:
        cfg.validate()
    return cfg
