"""NodeSLO controller: render per-node QoS strategies from the cluster config.

Analog of `pkg/slo-controller/nodeslo/` (controller + resource_strategy.go
merge): the slo-controller-config ConfigMap (thresholds, resource-qos, cpu
burst, system tuning) merged with per-nodepool overrides becomes one NodeSLO CR
per node, consumed by koordlet's qosmanager via the statesinformer."""

from __future__ import annotations

import json
from typing import Dict, Optional

from koordinator_tpu_torch.api.objects import (
    CPUBurstStrategy,
    NodeSLO,
    ObjectMeta,
    ResourceQOSStrategy,
    ResourceThresholdStrategy,
    SystemStrategy,
)
from koordinator_tpu_torch.client.store import (
    KIND_CONFIG_MAP,
    KIND_NODE,
    KIND_NODE_SLO,
    ObjectStore,
)
from koordinator_tpu_torch.utils.sloconfig import CONFIG_MAP_NAME

THRESHOLD_CONFIG_KEY = "resource-threshold-config"
QOS_CONFIG_KEY = "resource-qos-config"
CPU_BURST_CONFIG_KEY = "cpu-burst-config"
SYSTEM_CONFIG_KEY = "system-config"
HOST_APP_CONFIG_KEY = "host-application-config"


def _merge_threshold(data: Dict) -> ResourceThresholdStrategy:
    s = ResourceThresholdStrategy()
    s.enable = data.get("enable", s.enable)
    s.cpu_suppress_threshold_percent = data.get(
        "cpuSuppressThresholdPercent", s.cpu_suppress_threshold_percent
    )
    s.cpu_suppress_policy = data.get("cpuSuppressPolicy", s.cpu_suppress_policy)
    s.memory_evict_threshold_percent = data.get(
        "memoryEvictThresholdPercent", s.memory_evict_threshold_percent
    )
    s.memory_evict_lower_percent = data.get(
        "memoryEvictLowerPercent", s.memory_evict_lower_percent
    )
    s.cpu_evict_be_usage_threshold_percent = data.get(
        "cpuEvictBEUsageThresholdPercent", s.cpu_evict_be_usage_threshold_percent
    )
    return s


class NodeSLOController:
    def __init__(self, store: ObjectStore):
        self.store = store

    def _config_section(self, key: str) -> Dict:
        cm = self.store.get(KIND_CONFIG_MAP, f"koordinator-system/{CONFIG_MAP_NAME}")
        if cm is None:
            return {}
        raw = getattr(cm, "data", {}).get(key)
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except (ValueError, TypeError):
            return {}

    def _node_override(self, section: Dict, node_labels: Dict[str, str]) -> Dict:
        """clusterStrategy + first matching nodeStrategies entry."""
        merged = dict(section.get("clusterStrategy", {}))
        for ns in section.get("nodeStrategies", []):
            selector = ns.get("nodeSelector", {})
            if all(node_labels.get(k) == v for k, v in selector.items()):
                merged.update(
                    {k: v for k, v in ns.items() if k != "nodeSelector"}
                )
                break
        return merged

    def reconcile(self) -> int:
        changes = 0
        threshold_cfg = self._config_section(THRESHOLD_CONFIG_KEY)
        qos_cfg = self._config_section(QOS_CONFIG_KEY)
        burst_cfg = self._config_section(CPU_BURST_CONFIG_KEY)
        system_cfg = self._config_section(SYSTEM_CONFIG_KEY)
        host_app_cfg = self._config_section(HOST_APP_CONFIG_KEY)
        for node in self.store.list(KIND_NODE):
            labels = node.meta.labels
            slo = NodeSLO(
                meta=ObjectMeta(name=node.meta.name, namespace=""),
                resource_used_threshold_with_be=_merge_threshold(
                    self._node_override(threshold_cfg, labels)
                ),
            )
            qos = self._node_override(qos_cfg, labels)
            slo.resource_qos_strategy = ResourceQOSStrategy(
                ls_enable=qos.get("lsEnable", False),
                be_enable=qos.get("beEnable", False),
                ls_group_identity=qos.get("lsGroupIdentity", 2),
                be_group_identity=qos.get("beGroupIdentity", -1),
                llc_be_percent=qos.get("llcBEPercent", 100),
                mba_be_percent=qos.get("mbaBEPercent", 100),
                blkio_enable=qos.get("blkioEnable", False),
                ls_blkio_weight=qos.get("lsBlkioWeight", 500),
                be_blkio_weight=qos.get("beBlkioWeight", 100),
                core_sched_enable=qos.get("coreSchedEnable", False),
                net_qos_policy=qos.get("netQOSPolicy", ""),
                net_hw_tx_bps=qos.get("netHwTxBps", 0),
                net_hw_rx_bps=qos.get("netHwRxBps", 0),
            )
            burst = self._node_override(burst_cfg, labels)
            slo.cpu_burst_strategy = CPUBurstStrategy(
                policy=burst.get("policy", "none"),
                cpu_burst_percent=burst.get("cpuBurstPercent", 1000),
                cfs_quota_burst_percent=burst.get("cfsQuotaBurstPercent", 300),
            )
            system = self._node_override(system_cfg, labels)
            slo.system_strategy = SystemStrategy(
                min_free_kbytes_factor=system.get("minFreeKbytesFactor", 100),
                watermark_scale_factor=system.get("watermarkScaleFactor", 150),
            )
            # host applications (HostApplicationConfigKey /
            # apis/configuration HostApplicationCfg): cluster list, with the
            # first matching nodeConfigs entry replacing it, rendered into
            # the NodeSLO extension the koordlet consumes
            # (nodeslo_controller.go:110 getHostApplicationConfig)
            host_apps = host_app_cfg.get("applications")
            for ncfg in host_app_cfg.get("nodeConfigs", []):
                selector = ncfg.get("nodeSelector", {})
                if isinstance(selector, dict) and all(
                        labels.get(k) == v for k, v in selector.items()):
                    host_apps = ncfg.get("applications", host_apps)
                    break
            if host_apps:
                slo.extensions = dict(slo.extensions or {})
                slo.extensions["hostApplications"] = host_apps
            existing = self.store.get(KIND_NODE_SLO, f"/{node.meta.name}")
            if existing is None:
                self.store.add(KIND_NODE_SLO, slo)
                changes += 1
            elif (
                existing.resource_used_threshold_with_be
                != slo.resource_used_threshold_with_be
                or existing.resource_qos_strategy != slo.resource_qos_strategy
                or existing.cpu_burst_strategy != slo.cpu_burst_strategy
                or existing.system_strategy != slo.system_strategy
            ):
                slo.meta = existing.meta
                self.store.update(KIND_NODE_SLO, slo)
                changes += 1
        return changes
