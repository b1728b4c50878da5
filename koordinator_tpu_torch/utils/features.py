"""Feature gates: analog of reference `pkg/features/`.

Three gate sets, as in the reference: manager/webhook gates (features.go:28-86),
koordlet gates (koordlet_features.go:33-129), and scheduler gates. Each gate has a
default and can be flipped via `set_from_map` (the flag-parsing entry point).
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping


class FeatureGate:
    def __init__(self, defaults: Mapping[str, bool]):
        self._lock = threading.Lock()
        self._defaults = dict(defaults)
        self._overrides: Dict[str, bool] = {}

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
            return self._defaults.get(name, False)

    def known(self, name: str) -> bool:
        return name in self._defaults

    def set_from_map(self, values: Mapping[str, bool]) -> None:
        with self._lock:
            for k, v in values.items():
                if k not in self._defaults:
                    raise ValueError(f"unknown feature gate {k!r}")
                self._overrides[k] = bool(v)

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()


# Manager/webhook gates (reference pkg/features/features.go:28-52)
MANAGER_GATES = FeatureGate(
    {
        "PodMutatingWebhook": True,
        "PodValidatingWebhook": True,
        "ElasticQuotaMutatingWebhook": True,
        "ElasticQuotaValidatingWebhook": True,
        "NodeMutatingWebhook": False,
        "NodeValidatingWebhook": False,
        "ConfigMapValidatingWebhook": False,
        "WebhookFramework": True,
        "ColocationProfileSkipMutatingResources": False,
        "MultiQuotaTree": True,
        "ElasticQuotaIgnorePodOverhead": False,
        "ElasticQuotaImmutableAnnotations": False,
    }
)

# koordlet gates (reference pkg/features/koordlet_features.go:33-129)
KOORDLET_GATES = FeatureGate(
    {
        "AuditEvents": False,
        "AuditEventsHTTPHandler": False,
        "BECPUSuppress": True,
        "BECPUEvict": False,
        "BEMemoryEvict": False,
        "CPUBurst": False,
        "SystemConfig": False,
        "RdtResctrl": True,
        "CgroupReconcile": False,
        "NodeMetricControl": True,
        "NodeTopologyReport": True,
        "Libpfm4": False,
        "CPICollector": False,
        "PSICollector": True,
        "CPUSuppress": True,
        "CgroupV2": True,
        "ColdPageCollector": False,
        "PageCacheCollector": True,
        "CoreSched": False,
        "BlkIOReconcile": False,
        "TerwayQoS": False,
        # off by default: the TPU sampler initializes the JAX runtime, which
        # takes exclusive chip ownership the workload pods need
        "TPUDeviceCollector": False,
    }
)

# scheduler-side gates
SCHEDULER_GATES = FeatureGate(
    {
        "BatchedTPUKernel": True,       # offload filter/score to the device kernel
        "CompiledSerialParity": True,   # exact serial-parity selection loop on device
        "ResizePod": False,
        "DisableDefaultQuota": False,
        # event-driven incremental snapshot packing + device-resident
        # arrays (scheduler/snapshot_cache.py); off = full rebuild per cycle
        "IncrementalSnapshot": True,
    }
)
