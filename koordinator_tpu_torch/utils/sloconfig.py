"""Cluster colocation strategy config: analog of `pkg/util/sloconfig/` +
`apis/configuration/`.

The slo-controller-config ConfigMap carries a cluster-wide ColocationStrategy
plus per-nodepool (node-selector) overrides; the nodeslo controller renders
per-node NodeSLO CRs from it and the noderesource controller reads the
thresholds/policies for the batch/mid calculations."""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

CONFIG_MAP_NAME = "slo-controller-config"
COLOCATION_CONFIG_KEY = "colocation-config"

# per-node colocation strategy metadata (apis/extension/node_colocation.go)
ANNOTATION_NODE_COLOCATION_STRATEGY = (
    "node.koordinator.sh/colocation-strategy")
LABEL_CPU_RECLAIM_RATIO = "node.koordinator.sh/cpu-reclaim-ratio"
LABEL_MEMORY_RECLAIM_RATIO = "node.koordinator.sh/memory-reclaim-ratio"

POLICY_USAGE = "usage"
POLICY_REQUEST = "request"
POLICY_MAX_USAGE_REQUEST = "maxUsageRequest"


@dataclass
class ColocationStrategy:
    """Defaults mirror sloconfig defaults (colocation_config.go)."""

    enable: bool = False
    cpu_reclaim_threshold_percent: int = 60
    memory_reclaim_threshold_percent: int = 65
    mid_cpu_threshold_percent: int = 10
    mid_memory_threshold_percent: int = 10
    degrade_time_minutes: int = 15
    update_time_threshold_seconds: int = 300
    resource_disk_reclaim_ratio: float = 0.0
    cpu_calculate_policy: str = POLICY_USAGE
    memory_calculate_policy: str = POLICY_USAGE
    metric_aggregate_duration_seconds: int = 300

    @staticmethod
    def from_dict(data: Dict) -> "ColocationStrategy":
        s = ColocationStrategy()
        mapping = {
            "enable": "enable",
            "cpuReclaimThresholdPercent": "cpu_reclaim_threshold_percent",
            "memoryReclaimThresholdPercent": "memory_reclaim_threshold_percent",
            "midCPUThresholdPercent": "mid_cpu_threshold_percent",
            "midMemoryThresholdPercent": "mid_memory_threshold_percent",
            "degradeTimeMinutes": "degrade_time_minutes",
            "updateTimeThresholdSeconds": "update_time_threshold_seconds",
            "cpuCalculatePolicy": "cpu_calculate_policy",
            "memoryCalculatePolicy": "memory_calculate_policy",
        }
        for k, attr in mapping.items():
            if k in data:
                setattr(s, attr, data[k])
        return s


@dataclass
class NodeStrategy:
    """Per-nodepool override: node label selector + strategy patch."""

    node_selector: Dict[str, str] = field(default_factory=dict)
    strategy: Dict = field(default_factory=dict)


@dataclass
class ColocationConfig:
    cluster_strategy: ColocationStrategy = field(default_factory=ColocationStrategy)
    node_strategies: List[NodeStrategy] = field(default_factory=list)

    _STRATEGY_KEYS = {
        "enable": "enable",
        "cpuReclaimThresholdPercent": "cpu_reclaim_threshold_percent",
        "memoryReclaimThresholdPercent": "memory_reclaim_threshold_percent",
        "midCPUThresholdPercent": "mid_cpu_threshold_percent",
        "midMemoryThresholdPercent": "mid_memory_threshold_percent",
        "degradeTimeMinutes": "degrade_time_minutes",
        "updateTimeThresholdSeconds": "update_time_threshold_seconds",
        "cpuCalculatePolicy": "cpu_calculate_policy",
        "memoryCalculatePolicy": "memory_calculate_policy",
    }

    def _merge_keys(self, merged: "ColocationStrategy",
                    data: Dict) -> "ColocationStrategy":
        patched = ColocationStrategy.from_dict(data)
        for k in data:
            attr = self._STRATEGY_KEYS.get(k)
            if attr:
                setattr(merged, attr, getattr(patched, attr))
        return merged

    def strategy_for_node(
        self, node_labels: Dict[str, str],
        node_annotations: Optional[Dict[str, str]] = None,
    ) -> ColocationStrategy:
        """Cluster strategy patched by the first matching node-pool
        strategy, then by per-node METADATA (sloconfig
        GetNodeColocationStrategy): the node colocation-strategy annotation
        merges the same keys, and the cpu/memory reclaim-ratio labels
        (float ratios) override the reclaim threshold percents last."""
        merged = self.cluster_strategy
        for ns in self.node_strategies:
            if all(node_labels.get(k) == v for k, v in ns.node_selector.items()):
                merged = replace(merged)
                merged = self._merge_keys(merged, ns.strategy)
                break
        # per-node metadata layer (node_colocation.go):
        ann = node_annotations or {}
        raw = ann.get(ANNOTATION_NODE_COLOCATION_STRATEGY)
        if raw:
            try:
                data = json.loads(raw)
                if isinstance(data, dict):
                    merged = self._merge_keys(replace(merged), data)
            except (ValueError, TypeError):
                pass
        for label, attr in (
            (LABEL_CPU_RECLAIM_RATIO, "cpu_reclaim_threshold_percent"),
            (LABEL_MEMORY_RECLAIM_RATIO, "memory_reclaim_threshold_percent"),
        ):
            raw = node_labels.get(label)
            if raw is None:
                continue
            try:
                ratio = float(raw)
            except (TypeError, ValueError):
                continue
            if 0 <= ratio <= 1:  # getNodeReclaimPercent bounds
                merged = replace(merged)
                setattr(merged, attr, ratio * 100.0)
        return merged


def parse_colocation_config(config_map_data: Dict[str, str]) -> Tuple[ColocationConfig, Optional[str]]:
    """Parse + validate the configmap payload; returns (config, error)."""
    raw = config_map_data.get(COLOCATION_CONFIG_KEY)
    if not raw:
        return ColocationConfig(), None
    try:
        data = json.loads(raw)
    except (ValueError, TypeError) as e:
        return ColocationConfig(), f"invalid colocation-config json: {e}"
    cfg = ColocationConfig(cluster_strategy=ColocationStrategy.from_dict(data))
    node_cfgs = data.get("nodeConfigs", [])
    if not isinstance(node_cfgs, list):
        return ColocationConfig(), (
            f"invalid colocation-config json: nodeConfigs must be a list, "
            f"got {type(node_cfgs).__name__}")
    for ns in node_cfgs:
        if not isinstance(ns, dict):
            return ColocationConfig(), (
                f"invalid colocation-config json: nodeConfigs entry must "
                f"be an object, got {type(ns).__name__}")
        cfg.node_strategies.append(
            NodeStrategy(
                node_selector=ns.get("nodeSelector", {}),
                strategy={k: v for k, v in ns.items() if k != "nodeSelector"},
            )
        )
    err = validate_colocation_config(cfg)
    return cfg, err


def validate_colocation_config(cfg: ColocationConfig) -> Optional[str]:
    """ConfigMap webhook validation analog (pkg/webhook/cm/)."""
    s = cfg.cluster_strategy
    for name, v in (
        ("cpuReclaimThresholdPercent", s.cpu_reclaim_threshold_percent),
        ("memoryReclaimThresholdPercent", s.memory_reclaim_threshold_percent),
        ("midCPUThresholdPercent", s.mid_cpu_threshold_percent),
        ("midMemoryThresholdPercent", s.mid_memory_threshold_percent),
    ):
        if not 0 <= v <= 100:
            return f"{name} must be in [0, 100], got {v}"
    if s.degrade_time_minutes <= 0:
        return "degradeTimeMinutes must be positive"
    return None


class ColocationConfigSource:
    """Hot-reloadable ColocationConfig: the slo-controller-config
    ConfigMap's colocation-config section, memoized on the ConfigMap's
    resourceVersion, falling back to the constructor-provided base when
    the map (or the key) is absent or fails validation — the reference
    controllers keep their last good config on a bad update.

    Shared by the NodeResourceController host oracle AND the colo pack
    (colo/pack.py), so a config hot-reload reaches the device pass's
    policy scalars through the SAME parsed object the oracle sees.
    ``epoch`` bumps whenever the effective config object changes — the
    pack keys its per-node strategy rows on it."""

    def __init__(self, store, base: Optional[ColocationConfig] = None):
        self.store = store
        self.base = base or ColocationConfig()
        self.epoch = 0
        self._rv_key: object = object()  # never matches the first get()
        self._effective = self.base

    def get(self) -> ColocationConfig:
        from koordinator_tpu_torch.client.store import KIND_CONFIG_MAP

        cm = self.store.get(
            KIND_CONFIG_MAP, f"koordinator-system/{CONFIG_MAP_NAME}")
        key = (cm.meta.resource_version if cm is not None else None)
        if key == self._rv_key:
            return self._effective
        self._rv_key = key
        raw = cm.data.get(COLOCATION_CONFIG_KEY) if cm is not None else None
        if not raw:
            # the key (or the map) being ABSENT means "no cluster
            # config" — back to the constructor base, not an error
            effective = self.base
        else:
            cfg, err = parse_colocation_config(cm.data)
            # a malformed/invalid update keeps the LAST GOOD config: a
            # typo in the ConfigMap must not rewrite every node's batch
            # allocatable with defaults
            effective = self._effective if err else cfg
        if effective is not self._effective:
            self.epoch += 1
            self._effective = effective
        return self._effective
