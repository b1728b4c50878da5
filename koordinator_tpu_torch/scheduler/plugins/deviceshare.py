"""DeviceShare plugin host side: device cache + concrete allocation.

Reference `plugins/deviceshare/` (device_allocator.go:1-522, numa_topology.go,
topology_hint.go:33-130, devicehandler_gpu.go): Device CRs describe per-node
GPU/RDMA/FPGA inventory with per-device NUMA affinity; fractional GPU requests
(gpu-core percent, gpu-memory[-ratio], device_share.go:38-46); Filter checks
aggregate device capacity (covered by the GPU/RDMA/FPGA resource axes in the
batched Fit); Reserve picks concrete device minors (device_allocator.go)
honoring the topologymanager's merged NUMA affinity; PreBind writes the
allocation annotation (plugin.go:475).

Redesign notes vs the reference:
  * The reference walks PCIe switches inside a NUMA node
    (deviceTopologyGuide); the Device CR here reports per-device numa_node, so
    joint allocation (GPU+RDMA, jointAllocate in device_allocator.go:278-331)
    prefers secondary devices on the SAME NUMA nodes as the primary GPUs —
    the NUMA level of the same preference ladder.
  * RDMA/FPGA are whole-device grants (the reference's VF selection collapses
    to device granularity; the device minor is the grant unit).
  * NUMA hints (topology_hint.go GetPodTopologyHints) are generated per device
    type and merged by the shared TopologyManager with the CPU hints from
    NodeNUMAResource — the scheduling-time kubelet-style admit.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.objects import (
    ANNOTATION_DEVICE_ALLOCATED,
    Device,
    DeviceInfo,
    Pod,
)
from koordinator_tpu_torch.api.resources import ResourceName
from koordinator_tpu_torch.client.store import KIND_DEVICE, EventType, ObjectStore
from koordinator_tpu_torch.scheduler.frameworkext import CycleContext, Plugin
from koordinator_tpu_torch.scheduler.topologymanager import (
    BitMask,
    NUMATopologyHint,
)

# secondary (whole-device) types allocated after the primary GPU pick
SECONDARY_TYPES = ("rdma", "fpga")


def pod_gpu_request(pod: Pod) -> Dict[str, int]:
    """Normalize the GPU request forms (apis/extension/device_share.go):
    nvidia.com/gpu: N  ->  core N*100, memory-ratio N*100
    gpu-core/gpu-memory-ratio/gpu-memory given directly otherwise."""
    req = pod.spec.requests
    whole = req[ResourceName.GPU]
    if whole:
        return {"core": int(whole) * 100, "memory_ratio": int(whole) * 100}
    out: Dict[str, int] = {}
    if req[ResourceName.GPU_CORE]:
        out["core"] = int(req[ResourceName.GPU_CORE])
    if req[ResourceName.GPU_MEMORY_RATIO]:
        out["memory_ratio"] = int(req[ResourceName.GPU_MEMORY_RATIO])
    if req[ResourceName.GPU_MEMORY]:
        out["memory"] = int(req[ResourceName.GPU_MEMORY])
    return out


def pod_device_requests(pod: Pod) -> Dict[str, dict]:
    """Per-type device demand: {"gpu": {...}, "rdma": {"count": n}, ...}."""
    out: Dict[str, dict] = {}
    gpu = pod_gpu_request(pod)
    if gpu:
        out["gpu"] = gpu
    rdma = pod.spec.requests[ResourceName.RDMA]
    if rdma:
        out["rdma"] = {"count": int(rdma)}
    fpga = pod.spec.requests[ResourceName.FPGA]
    if fpga:
        out["fpga"] = {"count": int(fpga)}
    return out


def _gpu_device_need(want: dict) -> int:
    """How many distinct GPUs the request spans (1 for fractional/memory-only,
    core//100 for whole-GPU)."""
    core = want.get("core", 0)
    if core > 100:
        return core // 100
    return 1


class DeviceSharePlugin(Plugin):
    name = "DeviceShare"

    def __init__(self, scoring_strategy: str = "MostAllocated") -> None:
        self.devices: Dict[str, Device] = {}          # node -> Device CR
        # node -> type -> minor -> {"core": used, "memory_ratio": ..., ...}
        self.allocated: Dict[str, Dict[str, Dict[int, Dict[str, int]]]] = {}
        self.by_pod: Dict[str, Dict[str, List[dict]]] = {}
        self.scoring_strategy = scoring_strategy
        # keyed by (pod key, node name): the merged affinity is node-specific,
        # and a leaked entry from a vetoed attempt on another node must never
        # mask a later node's devices
        self._pending_affinity: Dict[tuple, NUMATopologyHint] = {}

    def register(self, store: ObjectStore) -> None:
        store.subscribe(KIND_DEVICE, self._on_device)

    def _on_device(self, ev: EventType, dev: Device, old) -> None:
        if ev is EventType.DELETED:
            self.devices.pop(dev.meta.name, None)
        else:
            self.devices[dev.meta.name] = dev

    # -- inventory helpers ---------------------------------------------
    def _infos(self, node: str, dtype: str) -> List[DeviceInfo]:
        dev = self.devices.get(node)
        if dev is None:
            return []
        return [d for d in dev.devices if d.type == dtype and d.health]

    def _used(self, node: str, dtype: str, minor: int) -> Dict[str, int]:
        return (
            self.allocated.setdefault(node, {})
            .setdefault(dtype, {})
            .setdefault(minor, {"core": 0, "memory_ratio": 0, "memory": 0,
                                "count": 0})
        )

    def _gpu_free(self, node: str, g: DeviceInfo) -> Dict[str, int]:
        used = self._used(node, "gpu", g.minor)
        cap_mem = int(g.resources[ResourceName.GPU_MEMORY]) or 0
        return {
            "core": 100 - used["core"],
            "memory_ratio": 100 - used["memory_ratio"],
            "memory": (cap_mem - used["memory"]) if cap_mem else -1,  # -1 = unreported
        }

    @staticmethod
    def _gpu_demand(g: DeviceInfo, want: dict, core: int) -> Dict[str, int]:
        """Per-device demand with the memory<->ratio axes kept in sync: ratio
        and bytes are two views of one capacity
        (apis/extension/device_share.go memoryRatio conversion), so a grant on
        either axis books BOTH — otherwise a memory-only pod and a ratio pod
        double-book the same HBM."""
        cap_mem = int(g.resources[ResourceName.GPU_MEMORY]) or 0
        ratio = want.get("memory_ratio", core)
        mem = want.get("memory", 0)
        if cap_mem:
            if mem and not want.get("memory_ratio"):
                ratio = max(ratio, -(-mem * 100 // cap_mem))  # ceil
            if ratio and not mem:
                mem = ratio * cap_mem // 100
        return {"core": core, "memory_ratio": ratio, "memory": mem}

    def _gpu_can_serve(self, node: str, g: DeviceInfo, want: dict) -> bool:
        """One device can serve one slice of the request, every axis checked.
        Shared between hint counting and the reserve chooser so the hints the
        topologymanager admits are exactly what reserve can satisfy."""
        core = want.get("core", 0)
        per_dev_core = 100 if core > 100 else core
        if per_dev_core == 100:
            # whole-GPU slices need an untouched device (any fractional
            # core/ratio/memory grant disqualifies it)
            used = self._used(node, "gpu", g.minor)
            return used["core"] == 0 and used["memory_ratio"] == 0 and \
                used["memory"] == 0
        need = self._gpu_demand(g, want, per_dev_core)
        free = self._gpu_free(node, g)
        if free["core"] < need["core"]:
            return False
        if free["memory_ratio"] < need["memory_ratio"]:
            return False
        if need["memory"] and free["memory"] >= 0 and \
                free["memory"] < need["memory"]:
            return False
        return True

    # -- NUMA topology hints (topology_hint.go) ------------------------
    def _restrict(self, infos: List[DeviceInfo],
                  affinity: Optional[NUMATopologyHint]) -> List[DeviceInfo]:
        """Devices usable under an affinity mask; numa_node -1 (unreported)
        devices are never excluded (calcTotalDevicesByNUMA counts them
        everywhere)."""
        if affinity is None or affinity.affinity is None:
            return infos
        allowed = set(affinity.affinity.get_bits())
        return [d for d in infos if d.numa_node < 0 or d.numa_node in allowed]

    def get_pod_topology_hints(self, pod: Pod, node_name: str):
        """Per-device-type hints: every NUMA-node subset whose free devices
        cover the request is a candidate; preferred iff minimal width
        (generateTopologyHints, topology_hint.go:108-214)."""
        import itertools

        wants = pod_device_requests(pod)
        if not wants:
            return None
        hints: Dict[str, Optional[List[NUMATopologyHint]]] = {}
        for dtype, want in wants.items():
            infos = self._infos(node_name, dtype)
            numa_ids = sorted({d.numa_node for d in infos if d.numa_node >= 0})
            if not numa_ids:
                hints[f"device/{dtype}"] = None  # no topology -> don't care
                continue
            need = (_gpu_device_need(want) if dtype == "gpu"
                    else want.get("count", 1))
            fitting: List[BitMask] = []
            min_width = len(numa_ids) + 1
            for width in range(1, len(numa_ids) + 1):
                for combo in itertools.combinations(numa_ids, width):
                    mask = BitMask(combo)
                    usable = self._restrict(
                        infos, NUMATopologyHint(mask, True))
                    if self._count_allocatable(
                            node_name, dtype, want, usable) >= need:
                        fitting.append(mask)
                        min_width = min(min_width, width)
            hints[f"device/{dtype}"] = [
                NUMATopologyHint(m, m.count() == min_width)
                for m in fitting
            ]
        return hints

    def _count_allocatable(self, node: str, dtype: str, want: dict,
                           infos: List[DeviceInfo]) -> int:
        """How many of `infos` could serve one slice of the request."""
        n = 0
        for d in infos:
            if dtype == "gpu":
                if self._gpu_can_serve(node, d, want):
                    n += 1
            else:
                if self._used(node, dtype, d.minor)["count"] == 0:
                    n += 1
        return n

    def allocate(self, pod: Pod, node_name: str,
                 affinity: NUMATopologyHint) -> Optional[str]:
        """TopologyManager fan-out: remember the merged affinity for reserve."""
        self._pending_affinity[(pod.meta.key, node_name)] = affinity
        return None

    # -- Reserve (device_allocator.go) ---------------------------------
    def reserve(self, pod: Pod, node_name: str, ctx: CycleContext) -> Optional[str]:
        wants = pod_device_requests(pod)
        if not wants:
            return None
        affinity = self._pending_affinity.pop((pod.meta.key, node_name), None)
        allocations: Dict[str, List[dict]] = {}

        err = None
        if "gpu" in wants:
            err = self._reserve_gpu(pod, node_name, wants["gpu"], affinity,
                                    allocations)
        if err is None:
            # joint allocation: secondary devices prefer the primary GPUs'
            # NUMA nodes (jointAllocate, device_allocator.go:278-331)
            gpu_numas = self._numas_of(node_name, "gpu",
                                       allocations.get("gpu", []))
            for dtype in SECONDARY_TYPES:
                if dtype in wants:
                    err = self._reserve_count(
                        pod, node_name, dtype, wants[dtype]["count"],
                        affinity, gpu_numas, allocations)
                    if err:
                        break
        if err:
            self._rollback(node_name, allocations)
            return err
        self.by_pod[pod.meta.key] = allocations
        return None

    def _numas_of(self, node: str, dtype: str, picks: List[dict]) -> set:
        by_minor = {d.minor: d for d in self._infos(node, dtype)}
        return {
            by_minor[p["minor"]].numa_node
            for p in picks
            if p["minor"] in by_minor and by_minor[p["minor"]].numa_node >= 0
        }

    def _reserve_gpu(self, pod: Pod, node: str, want: dict,
                     affinity: Optional[NUMATopologyHint],
                     allocations: Dict[str, List[dict]]) -> Optional[str]:
        gpus = self._restrict(self._infos(node, "gpu"), affinity)
        if not gpus:
            return "no healthy gpu on node"
        core = want.get("core", 0)
        if core > 100 and core % 100 != 0:
            # multi-GPU requests must be whole GPUs (validation in
            # apis/extension/device_share.go ValidatePercentageResource)
            return "gpu-core above 100 must be a multiple of 100"

        # DeviceShareArgs.scoringStrategy: MostAllocated packs fractional
        # requests onto fuller GPUs (keeps whole GPUs free for whole-GPU
        # pods); LeastAllocated spreads
        sign = -1 if self.scoring_strategy == "MostAllocated" else 1
        order = sorted(
            gpus,
            key=lambda g: (sign * self._used(node, "gpu", g.minor)["core"],
                           g.minor),
        )
        picks: List[dict] = []
        if core > 100:
            n = core // 100
            free_gpus = [g for g in order if self._gpu_can_serve(node, g, want)]
            if len(free_gpus) < n:
                return "insufficient whole gpus"
            per_dev = {**want, "core": 100}
            if "memory_ratio" in want:
                per_dev["memory_ratio"] = want["memory_ratio"] // n
            if "memory" in want:
                per_dev["memory"] = want["memory"] // n
            for g in free_gpus[:n]:
                picks.append({"minor": g.minor,
                              **self._gpu_demand(g, per_dev, 100)})
        else:
            # fractional or memory-only: one GPU that covers every dimension
            chosen = None
            for g in order:
                if self._gpu_can_serve(node, g, want):
                    chosen = g
                    break
            if chosen is None:
                return "insufficient gpu capacity"
            picks.append({"minor": chosen.minor,
                          **self._gpu_demand(chosen, want, core)})
        for p in picks:
            used = self._used(node, "gpu", p["minor"])
            used["core"] += p["core"]
            used["memory_ratio"] += p["memory_ratio"]
            used["memory"] += p["memory"]
        allocations["gpu"] = picks
        return None

    def _reserve_count(self, pod: Pod, node: str, dtype: str, count: int,
                       affinity: Optional[NUMATopologyHint],
                       preferred_numas: set,
                       allocations: Dict[str, List[dict]]) -> Optional[str]:
        infos = self._restrict(self._infos(node, dtype), affinity)
        free = [d for d in infos if self._used(node, dtype, d.minor)["count"] == 0]
        if len(free) < count:
            return f"insufficient {dtype} devices"
        # joint preference: same NUMA node as the primary GPUs first
        free.sort(key=lambda d: (
            0 if (preferred_numas and d.numa_node in preferred_numas) else 1,
            d.minor,
        ))
        picks = []
        for d in free[:count]:
            self._used(node, dtype, d.minor)["count"] = 1
            picks.append({"minor": d.minor})
        allocations[dtype] = picks
        return None

    # -- rollback / unreserve ------------------------------------------
    def _rollback(self, node: str, allocations: Dict[str, List[dict]]) -> None:
        for dtype, picks in allocations.items():
            for p in picks:
                used = self._used(node, dtype, p["minor"])
                if dtype == "gpu":
                    used["core"] -= p["core"]
                    used["memory_ratio"] -= p["memory_ratio"]
                    used["memory"] -= p["memory"]
                else:
                    used["count"] = 0

    def unreserve(self, pod: Pod, node_name: str, ctx: CycleContext) -> None:
        allocations = self.by_pod.pop(pod.meta.key, None)
        if allocations:
            self._rollback(node_name, allocations)
        self._pending_affinity.pop((pod.meta.key, node_name), None)

    def pre_bind(self, pod: Pod, node_name: str, ctx: CycleContext,
                 annotations: Dict[str, str]) -> None:
        allocations = self.by_pod.get(pod.meta.key)
        if allocations:
            annotations[ANNOTATION_DEVICE_ALLOCATED] = json.dumps(allocations)
