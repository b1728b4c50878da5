"""CPU topology model + cpuset accumulator.

Analog of reference `pkg/scheduler/plugins/nodenumaresource/cpu_topology.go:25-270`
and the sorted free-core take algorithm of `cpu_accumulator.go:234-810`. This is
deliberately HOST code (SURVEY.md section 7 hard parts: "cpuset/bitmask
combinatorics on accelerator vs host: keep exact semantics ... candidate for host
callback"): it runs once per actual assignment (Reserve), not per pod x node, so it
is off the hot path. The device-side NUMA *fit* check lives in ops/numa.py.

Semantics kept from the reference:
  * FullPCPUs: allocate whole physical cores (SMT siblings together); request must
    be a multiple of cpus-per-core (SMT alignment, plugin.go Filter).
  * SpreadByPCPUs: allocate one logical cpu per core, spreading across cores.
  * Exclusivity: PCPULevel (no sharing a core with other exclusive pods) and
    NUMANodeLevel (no sharing a NUMA node); previously allocated exclusive
    cores/nodes are avoided.
  * maxRefCount: logical cpus may be shared by up to maxRefCount LSR pods.
  * NUMA allocate strategy: MostAllocated prefers fuller NUMA nodes (bin-packing),
    LeastAllocated prefers emptier ones.
  * Deterministic ordering: candidates sorted by (free-cpus-in-unit, ref-count,
    id) so repeated runs bind identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from koordinator_tpu_torch.api.objects import CPUInfo
from koordinator_tpu_torch.utils.cpuset import CPUSet

FULL_PCPUS = "FullPCPUs"
SPREAD_BY_PCPUS = "SpreadByPCPUs"
EXCLUSIVE_NONE = ""
EXCLUSIVE_PCPU = "PCPULevel"
EXCLUSIVE_NUMA = "NUMANodeLevel"
NUMA_MOST_ALLOCATED = "MostAllocated"
NUMA_LEAST_ALLOCATED = "LeastAllocated"


@dataclass
class CPUTopology:
    """cpu -> (core, socket, numa node) maps (cpu_topology.go CPUTopology)."""

    cpus: List[CPUInfo] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.by_id: Dict[int, CPUInfo] = {c.cpu_id: c for c in self.cpus}
        self._cores: Dict[int, List[int]] = {}
        self._numa_of_core: Dict[int, int] = {}
        for c in self.cpus:
            self._cores.setdefault(c.core_id, []).append(c.cpu_id)
            self._numa_of_core[c.core_id] = c.numa_node_id
        for lst in self._cores.values():
            lst.sort()

    @staticmethod
    def build(num_sockets: int, nodes_per_socket: int, cores_per_node: int,
              threads_per_core: int = 2) -> "CPUTopology":
        """Synthesize a regular topology (test/report helper)."""
        cpus = []
        num_nodes = num_sockets * nodes_per_socket
        num_cores = num_nodes * cores_per_node
        cpu_id = 0
        for t in range(threads_per_core):
            for core in range(num_cores):
                node = core // cores_per_node
                socket = node // nodes_per_socket
                cpus.append(
                    CPUInfo(cpu_id=cpu_id, core_id=core, socket_id=socket,
                            numa_node_id=node)
                )
                cpu_id += 1
        return CPUTopology(cpus)

    @property
    def num_cpus(self) -> int:
        return len(self.cpus)

    @property
    def cpus_per_core(self) -> int:
        return max((len(v) for v in self._cores.values()), default=1)

    @property
    def num_numa_nodes(self) -> int:
        return len({c.numa_node_id for c in self.cpus}) or 1

    def is_valid(self) -> bool:
        return self.num_cpus > 0

    def cpus_in_numa(self, numa_id: int) -> CPUSet:
        return CPUSet(c.cpu_id for c in self.cpus if c.numa_node_id == numa_id)

    def cores(self) -> Dict[int, List[int]]:
        return self._cores

    def numa_of_core(self, core_id: int) -> int:
        return self._numa_of_core[core_id]


@dataclass
class AllocatedCPUInfo:
    ref_count: int = 0
    exclusive_policy: str = EXCLUSIVE_NONE


class CPUAllocationState:
    """Per-node allocation book-keeping (resource_manager's allocation cache)."""

    def __init__(self, topology: CPUTopology, max_ref_count: int = 1):
        self.topology = topology
        self.max_ref_count = max_ref_count
        self.allocated: Dict[int, AllocatedCPUInfo] = {}
        self.by_pod: Dict[str, CPUSet] = {}

    def available_cpus(self) -> CPUSet:
        """CPUs with ref count below maxRefCount."""
        return CPUSet(
            c.cpu_id
            for c in self.topology.cpus
            if self.allocated.get(c.cpu_id, AllocatedCPUInfo()).ref_count
            < self.max_ref_count
        )

    def num_available(self) -> int:
        """len(available_cpus()) without materializing the set: O(allocated)
        instead of O(all cpus) — the snapshot builder calls this per node per
        cycle. Only cpu ids actually IN the topology count as saturated, so
        an inconsistent CR (reserved id outside cr.cpus) cannot undercount."""
        topo_ids = self.topology.by_id
        saturated = sum(
            1 for cpu_id, info in self.allocated.items()
            if info.ref_count >= self.max_ref_count and cpu_id in topo_ids
        )
        return len(self.topology.cpus) - saturated

    def add(self, pod_key: str, cpus: CPUSet, exclusive_policy: str) -> None:
        self.by_pod[pod_key] = cpus
        for cpu in cpus:
            info = self.allocated.setdefault(cpu, AllocatedCPUInfo())
            info.ref_count += 1
            if exclusive_policy != EXCLUSIVE_NONE:
                info.exclusive_policy = exclusive_policy

    def remove(self, pod_key: str) -> None:
        cpus = self.by_pod.pop(pod_key, None)
        if cpus is None:
            return
        for cpu in cpus:
            info = self.allocated.get(cpu)
            if info is None:
                continue
            info.ref_count -= 1
            if info.ref_count <= 0:
                del self.allocated[cpu]

    def exclusive_cores(self) -> set:
        return {
            self.topology.by_id[cpu].core_id
            for cpu, info in self.allocated.items()
            if info.exclusive_policy == EXCLUSIVE_PCPU
        }

    def exclusive_numa_nodes(self) -> set:
        return {
            self.topology.by_id[cpu].numa_node_id
            for cpu, info in self.allocated.items()
            if info.exclusive_policy == EXCLUSIVE_NUMA
        }


def take_cpus(
    state: CPUAllocationState,
    num_cpus: int,
    bind_policy: str = FULL_PCPUS,
    exclusive_policy: str = EXCLUSIVE_NONE,
    numa_strategy: str = NUMA_MOST_ALLOCATED,
    numa_affinity: Optional[Sequence[int]] = None,
) -> Optional[CPUSet]:
    """Pick num_cpus logical cpus honoring policy/exclusivity; None if impossible.

    The take order mirrors the accumulator: group free cpus by NUMA node (restricted
    to numa_affinity when the topology manager chose one), order NUMA nodes by the
    allocate strategy, within a node order cores by (free cpus desc, ref count asc,
    core id asc), then take full cores (FullPCPUs) or round-robin single cpus
    (SpreadByPCPUs).
    """
    topo = state.topology
    if num_cpus <= 0:
        return CPUSet()
    available = state.available_cpus()
    excl_cores = state.exclusive_cores() if exclusive_policy == EXCLUSIVE_PCPU else set()
    excl_nodes = (
        state.exclusive_numa_nodes() if exclusive_policy == EXCLUSIVE_NUMA else set()
    )

    # free cpus per core, filtered
    free_in_core: Dict[int, List[int]] = {}
    for cpu in available:
        info = topo.by_id[cpu]
        if info.core_id in excl_cores:
            continue
        if info.numa_node_id in excl_nodes:
            continue
        if numa_affinity is not None and info.numa_node_id not in numa_affinity:
            continue
        free_in_core.setdefault(info.core_id, []).append(cpu)

    # group cores by numa node
    cores_in_numa: Dict[int, List[int]] = {}
    for core_id in free_in_core:
        cores_in_numa.setdefault(topo.numa_of_core(core_id), []).append(core_id)

    def core_ref(core_id: int) -> int:
        return sum(
            state.allocated.get(c, AllocatedCPUInfo()).ref_count
            for c in topo.cores()[core_id]
        )

    def numa_free(numa_id: int) -> int:
        return sum(len(free_in_core[c]) for c in cores_in_numa[numa_id])

    numa_ids = sorted(
        cores_in_numa,
        key=lambda nid: (
            numa_free(nid) if numa_strategy == NUMA_MOST_ALLOCATED else -numa_free(nid),
            nid,
        ),
    )

    result: List[int] = []
    needed = num_cpus
    for nid in numa_ids:
        cores = sorted(
            cores_in_numa[nid],
            key=lambda c: (-len(free_in_core[c]), core_ref(c), c),
        )
        if bind_policy == FULL_PCPUS:
            taken_cores = set()
            # phase 1: whole free cores while a full core still fits
            for core_id in cores:
                cpus = free_in_core[core_id]
                if len(cpus) == topo.cpus_per_core and needed >= len(cpus):
                    result.extend(sorted(cpus))
                    taken_cores.add(core_id)
                    needed -= len(cpus)
                if needed <= 0:
                    break
            if needed > 0:
                # phase 2: leftover single cpus (reference falls back to takeCPUs),
                # partial cores first, then remaining full cores
                leftovers = [c for c in cores if c not in taken_cores]
                leftovers.sort(
                    key=lambda c: (len(free_in_core[c]) == topo.cpus_per_core, cores.index(c))
                )
                for core_id in leftovers:
                    for cpu in sorted(free_in_core[core_id]):
                        if needed <= 0:
                            break
                        result.append(cpu)
                        needed -= 1
                    if needed <= 0:
                        break
        else:  # SpreadByPCPUs: one cpu per core, round-robin
            round_idx = 0
            while needed > 0:
                progress = False
                for core_id in cores:
                    cpus = sorted(free_in_core[core_id])
                    if round_idx < len(cpus):
                        result.append(cpus[round_idx])
                        needed -= 1
                        progress = True
                        if needed <= 0:
                            break
                if not progress:
                    break
                round_idx += 1
        if needed <= 0:
            break

    if needed > 0:
        return None
    return CPUSet(result[:num_cpus])
