"""Kernel interface layer: cgroups v1/v2, /proc, PSI, resctrl.

Analog of reference `pkg/koordlet/util/system/`:
  * resource file registry for both cgroup drivers (cgroup_resource.go)
  * path resolution per QoS class / pod / container (the koordinator cgroup
    hierarchy: kubepods/{besteffort|burstable}/pod<uid>/<container>)
  * PSI parsing (psi.go), /proc/stat + /proc/meminfo parsing
  * `SystemConfig` root-dir redirection + `FakeFS` builder — the testability
    seam (config.go:38-82, util_test_tool.go:56-69): every read/write goes
    through the config roots, so tests (and the whole qosmanager/runtimehooks
    stack) run against a temp tree without root privileges.
"""

from __future__ import annotations

import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# cgroup resource kinds (names match the reference's ResourceType strings)
CPU_SHARES = "cpu.shares"
CPU_CFS_QUOTA = "cpu.cfs_quota_us"
CPU_CFS_PERIOD = "cpu.cfs_period_us"
CPU_CFS_BURST = "cpu.cfs_burst_us"
CPU_MAX = "cpu.max"                      # v2: "<quota> <period>"
CPU_WEIGHT = "cpu.weight"
CPU_BVT_WARP_NS = "cpu.bvt_warp_ns"      # group identity (Anolis bvt)
CPU_IDLE = "cpu.idle"
CPUSET_CPUS = "cpuset.cpus"
CPUSET_CPUS_EFFECTIVE = "cpuset.cpus.effective"
MEMORY_LIMIT = "memory.limit_in_bytes"
MEMORY_MAX = "memory.max"                # v2
MEMORY_HIGH = "memory.high"
MEMORY_MIN = "memory.min"
MEMORY_LOW = "memory.low"
MEMORY_WMARK_RATIO = "memory.wmark_ratio"
MEMORY_USAGE = "memory.usage_in_bytes"
MEMORY_CURRENT = "memory.current"        # v2
MEMORY_STAT = "memory.stat"
CPU_STAT = "cpu.stat"
CPUACCT_USAGE = "cpuacct.usage"          # v1 ns counter
CGROUP_PROCS = "cgroup.procs"            # PIDs attached to the cgroup
CPU_PRESSURE = "cpu.pressure"
MEMORY_PRESSURE = "memory.pressure"
IO_PRESSURE = "io.pressure"
BLKIO_WEIGHT = "blkio.bfq.weight"
IO_WEIGHT = "io.weight"                  # v2
IO_MAX = "io.max"                        # v2 "<maj:min> rbps=N wbps=N riops=N wiops=N"

# v1 files live under a subsystem directory; v2 files under the unified dir
_V1_SUBSYSTEM = {
    CPU_SHARES: "cpu", CPU_CFS_QUOTA: "cpu", CPU_CFS_PERIOD: "cpu",
    CPU_CFS_BURST: "cpu", CPU_BVT_WARP_NS: "cpu", CPU_STAT: "cpu",
    CPU_IDLE: "cpu",
    CPUSET_CPUS: "cpuset", CPUSET_CPUS_EFFECTIVE: "cpuset",
    MEMORY_LIMIT: "memory", MEMORY_USAGE: "memory", MEMORY_STAT: "memory",
    MEMORY_WMARK_RATIO: "memory", MEMORY_MIN: "memory", MEMORY_LOW: "memory",
    MEMORY_HIGH: "memory",
    CPUACCT_USAGE: "cpuacct",
    CPU_PRESSURE: "cpu", MEMORY_PRESSURE: "memory", IO_PRESSURE: "io",
    BLKIO_WEIGHT: "blkio",
    CGROUP_PROCS: "cpu",  # v1: any subsystem lists the same tasks; use cpu
}

# v1 name <-> v2 name translations where they differ
V1_TO_V2 = {
    MEMORY_LIMIT: MEMORY_MAX,
    MEMORY_USAGE: MEMORY_CURRENT,
    CPUACCT_USAGE: CPU_STAT,  # usage_usec field
    CPU_CFS_QUOTA: CPU_MAX,
    CPU_CFS_PERIOD: CPU_MAX,
    CPU_SHARES: CPU_WEIGHT,
    BLKIO_WEIGHT: IO_WEIGHT,
}

QOS_BESTEFFORT = "besteffort"
QOS_BURSTABLE = "burstable"
QOS_GUARANTEED = ""  # guaranteed pods sit directly under kubepods

# cgroup drivers (cgroup_driver.go): kubelet either lays pods out as plain
# dirs (cgroupfs) or as systemd slices/scopes (systemd)
DRIVER_CGROUPFS = "cgroupfs"
DRIVER_SYSTEMD = "systemd"


@dataclass
class SystemConfig:
    """Root-dir redirection (reference system.Conf)."""

    cgroup_root_dir: str = "/sys/fs/cgroup"
    proc_root_dir: str = "/proc"
    sys_root_dir: str = "/sys"
    fs_root_dir: str = "/"  # root volume for storage usage metrics
    use_cgroup_v2: bool = True
    cgroup_kube_root: str = "kubepods"
    cgroup_driver: str = DRIVER_CGROUPFS

    def qos_relative_path(self, qos_class: str) -> str:
        """kubepods[.slice]/<qos> relative dir for a k8s QoS class."""
        if self.cgroup_driver == DRIVER_SYSTEMD:
            root = f"{self.cgroup_kube_root}.slice"
            if qos_class in ("", QOS_GUARANTEED):
                return root
            return os.path.join(
                root, f"{self.cgroup_kube_root}-{qos_class}.slice")
        if qos_class in ("", QOS_GUARANTEED):
            return self.cgroup_kube_root
        return os.path.join(self.cgroup_kube_root, qos_class)

    def pod_relative_path(self, qos_class: str, pod_uid: str) -> str:
        if self.cgroup_driver == DRIVER_SYSTEMD:
            uid = pod_uid.replace("-", "_")
            prefix = self.cgroup_kube_root
            if qos_class not in ("", QOS_GUARANTEED):
                prefix = f"{prefix}-{qos_class}"
            return os.path.join(
                self.qos_relative_path(qos_class), f"{prefix}-pod{uid}.slice")
        return os.path.join(self.qos_relative_path(qos_class), f"pod{pod_uid}")

    def container_relative_path(self, qos_class: str, pod_uid: str,
                                container_id: str) -> str:
        if self.cgroup_driver == DRIVER_SYSTEMD:
            return os.path.join(
                self.pod_relative_path(qos_class, pod_uid),
                f"cri-containerd-{container_id}.scope")
        return os.path.join(self.pod_relative_path(qos_class, pod_uid), container_id)

    def cgroup_file_path(self, relative_dir: str, resource: str) -> str:
        if self.use_cgroup_v2:
            name = V1_TO_V2.get(resource, resource)
            return os.path.join(self.cgroup_root_dir, relative_dir, name)
        subsystem = _V1_SUBSYSTEM.get(resource, "cpu")
        return os.path.join(self.cgroup_root_dir, subsystem, relative_dir, resource)

    def proc_path(self, *parts: str) -> str:
        return os.path.join(self.proc_root_dir, *parts)

    def resctrl_root(self) -> str:
        return os.path.join(self.sys_root_dir, "fs", "resctrl")


def detect_cgroup_driver(config: "SystemConfig") -> str:
    """Probe the cgroup tree for kubepods.slice vs kubepods
    (cgroup_driver.go GetCgroupDriver semantics: look at which layout the
    kubelet actually created)."""
    roots = ([config.cgroup_root_dir] if config.use_cgroup_v2 else
             [os.path.join(config.cgroup_root_dir, sub)
              for sub in ("cpu", "memory", "cpuset")])
    for root in roots:
        if os.path.isdir(os.path.join(root, f"{config.cgroup_kube_root}.slice")):
            return DRIVER_SYSTEMD
        if os.path.isdir(os.path.join(root, config.cgroup_kube_root)):
            return DRIVER_CGROUPFS
    return DRIVER_CGROUPFS


def detect_cgroup_version(config: "SystemConfig") -> bool:
    """True if the unified (v2) hierarchy is mounted at the cgroup root."""
    return os.path.isfile(os.path.join(config.cgroup_root_dir,
                                       "cgroup.controllers"))


# module-level active config (reference's system.Conf global)
CONFIG = SystemConfig()


def read_file(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def write_file(path: str, value: str) -> bool:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(value)
        return True
    except OSError:
        return False


def read_cgroup(relative_dir: str, resource: str,
                config: Optional[SystemConfig] = None) -> Optional[str]:
    cfg = config or CONFIG
    return read_file(cfg.cgroup_file_path(relative_dir, resource))


def write_cgroup(relative_dir: str, resource: str, value: str,
                 config: Optional[SystemConfig] = None) -> bool:
    cfg = config or CONFIG
    return write_file(cfg.cgroup_file_path(relative_dir, resource), value)


def read_cpu_usage_ns(relative_dir: str, config: Optional[SystemConfig] = None) -> Optional[int]:
    """Cumulative cpu usage in nanoseconds (cpuacct.usage v1 / cpu.stat v2)."""
    cfg = config or CONFIG
    if cfg.use_cgroup_v2:
        raw = read_cgroup(relative_dir, CPU_STAT, cfg)
        if raw is None:
            return None
        m = re.search(r"usage_usec (\d+)", raw)
        return int(m.group(1)) * 1000 if m else None
    raw = read_cgroup(relative_dir, CPUACCT_USAGE, cfg)
    return int(raw) if raw and raw.isdigit() else None


def read_memory_usage_bytes(relative_dir: str, config: Optional[SystemConfig] = None) -> Optional[int]:
    raw = read_cgroup(relative_dir, MEMORY_USAGE, config)
    return int(raw) if raw and raw.isdigit() else None


# ---------------------------------------------------------------------------
# PSI (psi.go)
# ---------------------------------------------------------------------------


@dataclass
class PSIStats:
    some_avg10: float = 0.0
    some_avg60: float = 0.0
    some_avg300: float = 0.0
    some_total_us: int = 0
    full_avg10: float = 0.0
    full_avg60: float = 0.0
    full_avg300: float = 0.0
    full_total_us: int = 0


_PSI_LINE = re.compile(
    r"^(some|full) avg10=([\d.]+) avg60=([\d.]+) avg300=([\d.]+) total=(\d+)"
)


def parse_psi(content: str) -> PSIStats:
    out = PSIStats()
    for line in content.splitlines():
        m = _PSI_LINE.match(line.strip())
        if not m:
            continue
        kind, a10, a60, a300, total = m.groups()
        if kind == "some":
            out.some_avg10, out.some_avg60, out.some_avg300 = (
                float(a10), float(a60), float(a300))
            out.some_total_us = int(total)
        else:
            out.full_avg10, out.full_avg60, out.full_avg300 = (
                float(a10), float(a60), float(a300))
            out.full_total_us = int(total)
    return out


def read_psi(relative_dir: str, resource: str = CPU_PRESSURE,
             config: Optional[SystemConfig] = None) -> Optional[PSIStats]:
    raw = read_cgroup(relative_dir, resource, config)
    return parse_psi(raw) if raw is not None else None


# ---------------------------------------------------------------------------
# /proc parsing
# ---------------------------------------------------------------------------


def read_proc_stat_cpu(config: Optional[SystemConfig] = None) -> Optional[Tuple[int, int]]:
    """(total_jiffies, idle_jiffies) from /proc/stat's aggregate cpu line."""
    cfg = config or CONFIG
    raw = read_file(cfg.proc_path("stat"))
    if not raw:
        return None
    for line in raw.splitlines():
        if line.startswith("cpu "):
            fields = [int(x) for x in line.split()[1:]]
            total = sum(fields)
            idle = fields[3] + (fields[4] if len(fields) > 4 else 0)
            return total, idle
    return None


def read_meminfo(config: Optional[SystemConfig] = None) -> Dict[str, int]:
    """/proc/meminfo in bytes."""
    cfg = config or CONFIG
    raw = read_file(cfg.proc_path("meminfo"))
    out: Dict[str, int] = {}
    if not raw:
        return out
    for line in raw.splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[0].endswith(":"):
            val = int(parts[1])
            if len(parts) >= 3 and parts[2] == "kB":
                val *= 1024
            out[parts[0][:-1]] = val
    return out


# ---------------------------------------------------------------------------
# FakeFS (util_test_tool.go FileTestUtil)
# ---------------------------------------------------------------------------


class FakeFS:
    """Builds a temp /sys + /proc + cgroup tree and repoints a SystemConfig at
    it; all koordlet modules taking a config then run hermetically."""

    def __init__(self, use_cgroup_v2: bool = True):
        self.root = tempfile.mkdtemp(prefix="koordlet-fakefs-")
        self.config = SystemConfig(
            cgroup_root_dir=os.path.join(self.root, "cgroup"),
            proc_root_dir=os.path.join(self.root, "proc"),
            sys_root_dir=os.path.join(self.root, "sys"),
            fs_root_dir=self.root,
            use_cgroup_v2=use_cgroup_v2,
        )

    def set_cgroup(self, relative_dir: str, resource: str, value: str) -> str:
        path = self.config.cgroup_file_path(relative_dir, resource)
        assert write_file(path, value)
        return path

    def get_cgroup(self, relative_dir: str, resource: str) -> Optional[str]:
        return read_cgroup(relative_dir, resource, self.config)

    def set_proc(self, name: str, content: str) -> None:
        write_file(self.config.proc_path(name), content)

    def set_file(self, path: str, content: str) -> None:
        write_file(os.path.join(self.root, path), content)

    def cleanup(self) -> None:
        import shutil

        shutil.rmtree(self.root, ignore_errors=True)
