"""Machine topology discovery from /sys + /proc.

Analog of reference `pkg/koordlet/util/system`'s lscpu/NUMA parsing
(machine info feeding the nodeTopo statesinformer, which reports the
NodeResourceTopology CR the NodeNUMAResource scheduler plugin consumes):

  * per-cpu topology from /sys/devices/system/cpu/cpu<i>/topology/
    {core_id, physical_package_id}
  * NUMA membership from /sys/devices/system/node/node<j>/cpulist
  * online cpu list from /sys/devices/system/cpu/online
  * per-NUMA memory from /sys/devices/system/node/node<j>/meminfo

Everything resolves through a SystemConfig so FakeFS trees work.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.objects import CPUInfo
from koordinator_tpu_torch.koordlet.util import system as sysutil
from koordinator_tpu_torch.scheduler.cpu_topology import CPUTopology
from koordinator_tpu_torch.utils.cpuset import CPUSet


@dataclass
class NUMAMemInfo:
    numa_id: int
    total_bytes: int = 0
    free_bytes: int = 0


@dataclass
class MachineInfo:
    topology: CPUTopology
    numa_mem: Dict[int, NUMAMemInfo] = field(default_factory=dict)

    @property
    def num_cpus(self) -> int:
        return self.topology.num_cpus


def _sys_path(config: sysutil.SystemConfig, *parts: str) -> str:
    return os.path.join(config.sys_root_dir, *parts)


def read_online_cpus(config: Optional[sysutil.SystemConfig] = None) -> CPUSet:
    cfg = config or sysutil.CONFIG
    raw = sysutil.read_file(_sys_path(cfg, "devices/system/cpu/online"))
    return CPUSet.parse(raw) if raw else CPUSet()


def read_numa_cpulists(config: Optional[sysutil.SystemConfig] = None) -> Dict[int, CPUSet]:
    cfg = config or sysutil.CONFIG
    node_root = _sys_path(cfg, "devices/system/node")
    out: Dict[int, CPUSet] = {}
    try:
        entries = os.listdir(node_root)
    except OSError:
        return out
    for name in sorted(entries):
        m = re.fullmatch(r"node(\d+)", name)
        if not m:
            continue
        raw = sysutil.read_file(os.path.join(node_root, name, "cpulist"))
        if raw:
            out[int(m.group(1))] = CPUSet.parse(raw)
    return out


_MEMINFO_LINE = re.compile(r"Node \d+ (\w+):\s+(\d+)(?:\s+kB)?")


def read_numa_meminfo(numa_id: int,
                      config: Optional[sysutil.SystemConfig] = None) -> Optional[NUMAMemInfo]:
    cfg = config or sysutil.CONFIG
    raw = sysutil.read_file(
        _sys_path(cfg, "devices/system/node", f"node{numa_id}", "meminfo"))
    if raw is None:
        return None
    info = NUMAMemInfo(numa_id=numa_id)
    for line in raw.splitlines():
        m = _MEMINFO_LINE.search(line)
        if not m:
            continue
        key, val = m.group(1), int(m.group(2)) * 1024
        if key == "MemTotal":
            info.total_bytes = val
        elif key == "MemFree":
            info.free_bytes = val
    return info


def discover(config: Optional[sysutil.SystemConfig] = None) -> Optional[MachineInfo]:
    """Build MachineInfo from the /sys tree; None if topology files absent."""
    cfg = config or sysutil.CONFIG
    online = read_online_cpus(cfg)
    if len(online) == 0:
        return None
    numa_of_cpu: Dict[int, int] = {}
    for numa_id, cpus in read_numa_cpulists(cfg).items():
        for cpu in cpus.to_list():
            numa_of_cpu[cpu] = numa_id

    infos: List[CPUInfo] = []
    for cpu in online.to_list():
        topo_dir = _sys_path(cfg, "devices/system/cpu", f"cpu{cpu}", "topology")
        core_raw = sysutil.read_file(os.path.join(topo_dir, "core_id"))
        pkg_raw = sysutil.read_file(os.path.join(topo_dir, "physical_package_id"))
        if core_raw is None or pkg_raw is None:
            return None
        socket_id = int(pkg_raw)
        # core_id is only unique within a package; globalize like lscpu does
        core_id = socket_id * 10_000 + int(core_raw)
        infos.append(CPUInfo(
            cpu_id=cpu, core_id=core_id, socket_id=socket_id,
            numa_node_id=numa_of_cpu.get(cpu, socket_id)))

    mem = {}
    for numa_id in sorted({c.numa_node_id for c in infos}):
        mi = read_numa_meminfo(numa_id, cfg)
        if mi is not None:
            mem[numa_id] = mi
    return MachineInfo(topology=CPUTopology(cpus=infos), numa_mem=mem)


def write_fake_machine(fs, num_sockets: int = 1, nodes_per_socket: int = 2,
                       cores_per_node: int = 4, threads_per_core: int = 2,
                       mem_per_numa_gb: int = 32) -> None:
    """Populate a FakeFS with a regular machine's /sys topology tree."""
    topo = CPUTopology.build(num_sockets, nodes_per_socket, cores_per_node,
                             threads_per_core)
    all_cpus = sorted(c.cpu_id for c in topo.cpus)
    fs.set_file(os.path.join(
        "sys", "devices/system/cpu/online"), CPUSet(all_cpus).format())
    by_numa: Dict[int, List[int]] = {}
    for c in topo.cpus:
        by_numa.setdefault(c.numa_node_id, []).append(c.cpu_id)
        base = os.path.join("sys", "devices/system/cpu", f"cpu{c.cpu_id}",
                            "topology")
        fs.set_file(os.path.join(base, "core_id"), str(c.core_id % 10_000))
        fs.set_file(os.path.join(base, "physical_package_id"), str(c.socket_id))
    for numa_id, cpus in by_numa.items():
        node_dir = os.path.join("sys", "devices/system/node", f"node{numa_id}")
        fs.set_file(os.path.join(node_dir, "cpulist"), CPUSet(cpus).format())
        kb = mem_per_numa_gb * 1024 * 1024
        fs.set_file(
            os.path.join(node_dir, "meminfo"),
            f"Node {numa_id} MemTotal:       {kb} kB\n"
            f"Node {numa_id} MemFree:        {kb * 3 // 4} kB\n")
