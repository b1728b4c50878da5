"""NodeNUMAResource plugin host side: topology options + cpuset allocation.

Reference `plugins/nodenumaresource/`: TopologyOptionsManager ingests
NodeResourceTopology CRs (reported by koordlet); Reserve allocates concrete cpus
via the accumulator; PreBind writes the allocation into the pod annotation
(`scheduling.koordinator.sh/resource-status`, plugin.go:431-479) which koordlet's
cpuset runtime hook applies to the container cgroup."""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.api.objects import (
    ANNOTATION_RESOURCE_STATUS,
    NodeResourceTopology,
    Pod,
)
from koordinator_tpu_torch.api.resources import NUM_RESOURCES
from koordinator_tpu_torch.client.store import (
    KIND_NODE_TOPOLOGY,
    KIND_POD,
    EventType,
    ObjectStore,
)
from koordinator_tpu_torch.scheduler.cpu_topology import (
    EXCLUSIVE_NONE,
    FULL_PCPUS,
    SPREAD_BY_PCPUS,
    CPUAllocationState,
    CPUTopology,
    take_cpus,
)
from koordinator_tpu_torch.scheduler.frameworkext import CycleContext, Plugin
from koordinator_tpu_torch.scheduler.snapshot import _pod_cpuset_flags
from koordinator_tpu_torch.scheduler.topologymanager import (
    POLICY_NONE,
    NUMATopologyHint,
    TopologyManager,
    generate_fit_hints,
    resolve_numa_policy,
)


class NodeNUMAResourcePlugin(Plugin):
    name = "NodeNUMAResource"

    def __init__(self, max_ref_count: int = 1,
                 default_cpu_bind_policy: str = FULL_PCPUS,
                 numa_allocate_strategy: str = "MostAllocated") -> None:
        self.max_ref_count = max_ref_count
        self.default_cpu_bind_policy = default_cpu_bind_policy
        self.numa_allocate_strategy = numa_allocate_strategy
        self.cpu_states: Dict[str, CPUAllocationState] = {}
        self.topologies: Dict[str, NodeResourceTopology] = {}
        self.numa_allocated: Dict[str, np.ndarray] = {}
        self.store: Optional[ObjectStore] = None
        # the plugin is itself a hint provider (resource_manager.go:418-532);
        # DeviceShare registers alongside it in the scheduler wiring
        self.topology_manager = TopologyManager([self])
        self._pending_affinity: Dict[str, NUMATopologyHint] = {}
        # exact per-pod zone placement, so release reverses what add placed
        self._pod_zone_alloc: Dict[Tuple[str, str], np.ndarray] = {}
        # per-node change counter over (topologies, cpu_states,
        # numa_allocated) — keys the incremental snapshot builder's NUMA rows
        self.node_epoch: Dict[str, int] = {}
        # names bumped since the snapshot cache last drained (see
        # scheduler/snapshot_cache.py numa_arrays)
        self.epoch_dirty: set = set()

    def _bump(self, node_name: str) -> None:
        self.node_epoch[node_name] = self.node_epoch.get(node_name, 0) + 1
        self.epoch_dirty.add(node_name)

    def register(self, store: ObjectStore) -> None:
        self.store = store
        store.subscribe(KIND_NODE_TOPOLOGY, self._on_topology)
        store.subscribe(KIND_POD, self._on_pod)
        from koordinator_tpu_torch.client.store import KIND_NODE

        store.subscribe(KIND_NODE, self._on_node)

    def _on_pod(self, ev: EventType, pod: Pod, old) -> None:
        """Release zone + cpuset accounting when an assigned pod dies (the
        reference frees allocations on pod delete events via its resource
        manager cache)."""
        if ev is EventType.DELETED or pod.is_terminated:
            node = pod.spec.node_name
            if node:
                self._release_zone_alloc(node, pod.meta.key)
                state = self.cpu_states.get(node)
                if state is not None:
                    state.remove(pod.meta.key)
                    self._bump(node)

    def _on_topology(self, ev: EventType, cr: NodeResourceTopology, old) -> None:
        name = cr.meta.name
        self._bump(name)
        if ev is EventType.DELETED:
            self.topologies.pop(name, None)
            self.cpu_states.pop(name, None)
            return
        self.topologies[name] = cr
        if name not in self.cpu_states and cr.cpus:
            topo = CPUTopology(cr.cpus)
            state = CPUAllocationState(topo, self.max_ref_count)
            self.cpu_states[name] = state
            if cr.kubelet_reserved_cpus:
                # kubelet static cpu-manager claims are unavailable to koordinator
                from koordinator_tpu_torch.utils.cpuset import CPUSet

                state.add(
                    "kubelet-reserved",
                    CPUSet(cr.kubelet_reserved_cpus),
                    EXCLUSIVE_NONE,
                )
            self._sync_node_reservation(name)

    def _on_node(self, ev: EventType, node, old) -> None:
        """Re-sync the node-reservation cpuset claim whenever the Node object
        changes — the annotation may appear, change, or vanish after the
        topology CR created the allocation state (or arrive before the Node
        existed at all)."""
        if ev is not EventType.DELETED and node.meta.name in self.cpu_states:
            self._sync_node_reservation(node.meta.name)

    def _sync_node_reservation(self, name: str) -> None:
        """node-reservation reservedCPUs (both apply policies) and EXCLUSIVE
        system-QoS cores are unavailable to cpuset allocation
        (nodenumaresource/reservation.go + topology_options.go via
        apis/extension)."""
        state = self.cpu_states.get(name)
        if state is None or self.store is None:
            return
        self._bump(name)
        from koordinator_tpu_torch.client.store import KIND_NODE
        from koordinator_tpu_torch.utils.cpuset import CPUSet

        node = self.store.get(KIND_NODE, f"/{name}")
        cpus = node.node_reservation()[1] if node is not None else ""
        state.remove("node-reservation")
        if cpus:
            state.add("node-reservation", CPUSet.parse(cpus), EXCLUSIVE_NONE)
        sys_cpus, exclusive = (node.system_qos_resource()
                               if node is not None else ("", True))
        state.remove("system-qos")
        if sys_cpus and exclusive:
            state.add("system-qos", CPUSet.parse(sys_cpus), EXCLUSIVE_NONE)

    # -- NUMATopologyHintProvider (topologymanager.py) -----------------
    def node_policy(self, node_name: str) -> str:
        """Policy from the node label, falling back to the reported kubelet
        cpu-manager policy (shared precedence helper with the snapshot packer)."""
        topo = self.topologies.get(node_name)
        labels = {}
        if self.store is not None:
            from koordinator_tpu_torch.client.store import KIND_NODE

            node = self.store.get(KIND_NODE, f"/{node_name}")
            if node is not None:
                labels = node.meta.labels
        kubelet_policy = topo.kubelet_cpu_manager_policy if topo else ""
        return resolve_numa_policy(labels, kubelet_policy)

    def _numa_ids(self, topo: NodeResourceTopology) -> list:
        # zones beyond MAX_NUMA are dropped, matching the snapshot packer
        return sorted(z.numa_id for z in topo.zones if 0 <= z.numa_id < 8)

    def _zone_free(self, node_name: str) -> Optional[np.ndarray]:
        """[8, R] free per numa_id row (rows without a zone stay zero)."""
        topo = self.topologies.get(node_name)
        if topo is None or not topo.zones:
            return None
        cap = np.zeros((8, NUM_RESOURCES), np.float32)
        for z in topo.zones:
            if 0 <= z.numa_id < 8:
                cap[z.numa_id] = z.allocatable.to_vector()
        alloc = self.numa_allocated.get(node_name)
        if alloc is not None:
            cap = cap - alloc
        return cap

    def get_pod_topology_hints(self, pod: Pod, node_name: str):
        zone_free = self._zone_free(node_name)
        if zone_free is None:
            return None
        numa_ids = self._numa_ids(self.topologies[node_name])
        if not numa_ids:
            return None
        req = pod.spec.requests.to_vector()
        # row i of the slice corresponds to numa_ids[i]
        return {"resources": generate_fit_hints(req, zone_free[numa_ids], numa_ids)}

    def allocate(self, pod: Pod, node_name: str,
                 affinity: NUMATopologyHint) -> Optional[str]:
        self._pending_affinity[pod.meta.key] = affinity
        return None

    # ------------------------------------------------------------------
    def reserve(self, pod: Pod, node_name: str, ctx: CycleContext) -> Optional[str]:
        topo = self.topologies.get(node_name)
        # the device coarse cut (snapshot.py) only arms numa_policy for nodes
        # reporting a CPU list; the host admit must gate identically or the
        # kernel keeps proposing nodes the host always vetoes
        if topo is not None and topo.cpus and topo.zones:
            policy = self.node_policy(node_name)
            if policy != POLICY_NONE:
                numa_ids = self._numa_ids(topo)
                if numa_ids:
                    err = self.topology_manager.admit(
                        pod, node_name, numa_ids, policy
                    )
                    if err:
                        self._pending_affinity.pop(pod.meta.key, None)
                        return err
        needs_bind, cores, full_pcpus = _pod_cpuset_flags(
            pod, self.default_cpu_bind_policy)
        if not needs_bind:
            self._track_numa(pod, node_name, add=True)
            return None
        state = self.cpu_states.get(node_name)
        if state is None:
            self._pending_affinity.pop(pod.meta.key, None)
            return "node has no CPU topology"
        got = take_cpus(
            state,
            int(cores),
            bind_policy=FULL_PCPUS if full_pcpus else SPREAD_BY_PCPUS,
            numa_strategy=self.numa_allocate_strategy,
        )
        if got is None:
            self._pending_affinity.pop(pod.meta.key, None)
            return "insufficient bindable cpus"
        state.add(pod.meta.key, got, EXCLUSIVE_NONE)
        ctx.data.setdefault("cpusets", {})[pod.meta.key] = got
        self._track_numa(pod, node_name, add=True)
        return None

    def unreserve(self, pod: Pod, node_name: str, ctx: CycleContext) -> None:
        state = self.cpu_states.get(node_name)
        if state is not None:
            state.remove(pod.meta.key)
        ctx.data.get("cpusets", {}).pop(pod.meta.key, None)
        self._track_numa(pod, node_name, add=False)
        self._pending_affinity.pop(pod.meta.key, None)

    def _affinity_zones(self, pod: Pod, node_name: str) -> Optional[list]:
        hint = self._pending_affinity.get(pod.meta.key)
        if hint is not None and hint.affinity is not None:
            return hint.affinity.get_bits()
        return None

    def _release_zone_alloc(self, node_name: str, pod_key: str) -> None:
        placed = self._pod_zone_alloc.pop((node_name, pod_key), None)
        if placed is None:
            return
        self._bump(node_name)
        alloc = self.numa_allocated.get(node_name)
        if alloc is not None:
            np.maximum(alloc - placed, 0.0, out=alloc)

    def _track_numa(self, pod: Pod, node_name: str, add: bool) -> None:
        """Zone-level accounting feeding snapshot numa_free. Allocation follows
        the merged topology hint when one was admitted (all into a single zone
        for width-1 affinities, waterfall lowest-zone-first inside wider ones);
        without a hint it waterfalls over all zones. Waterfall take and
        dropped-overflow semantics match the kernel's numa_spread_fill
        (ops/numa.py) so host accounting and in-batch kernel state agree.
        The per-pod placement is recorded so release reverses it exactly."""
        if node_name not in self.topologies:
            return
        self._bump(node_name)
        if not add:
            self._release_zone_alloc(node_name, pod.meta.key)
            return
        vec = pod.spec.requests.to_vector()
        alloc = self.numa_allocated.setdefault(
            node_name,
            np.zeros((8, NUM_RESOURCES), np.float32),
        )
        zones = self._affinity_zones(pod, node_name)
        if zones is None:
            zones = list(range(alloc.shape[0]))
        zones = [z for z in zones if z < alloc.shape[0]]
        placed = np.zeros_like(alloc)
        if len(zones) == 1:
            # width-1 affinity: the whole request lands in the chosen zone,
            # as the kernel's single_case subtracts it wholesale
            placed[zones[0]] = vec
        else:
            free = self._zone_free(node_name)
            remaining = vec.astype(np.float32).copy()
            for z in zones:
                headroom = (
                    np.maximum(free[z], 0.0)
                    if free is not None
                    else remaining
                )
                take = np.minimum(headroom, remaining)
                placed[z] = take
                remaining = remaining - take
            # unplaceable remainder is dropped, as numa_spread_fill drops it
        alloc += placed
        self._pod_zone_alloc[(node_name, pod.meta.key)] = placed

    def pre_bind(self, pod: Pod, node_name: str, ctx: CycleContext,
                 annotations: Dict[str, str]) -> None:
        status: Dict[str, object] = {}
        got = ctx.data.get("cpusets", {}).get(pod.meta.key)
        if got is not None:
            status["cpuset"] = got.format()
        hint = self._pending_affinity.pop(pod.meta.key, None)
        if hint is not None and hint.affinity is not None:
            status["numaNodeResources"] = [
                {"node": z} for z in hint.affinity.get_bits()
            ]
        if status:
            annotations[ANNOTATION_RESOURCE_STATUS] = json.dumps(status)
