"""Metrics advisor: the collector framework.

Analog of reference `pkg/koordlet/metricsadvisor/` (framework/plugin.go:25-48 +
collectors, plugins_profile.go registry): each collector owns a tick;
`collect_once(now)` drives the registered profile in order, so the whole
advisor is drivable from tests and the Daemon loop alike. Rate metrics (cpu)
are derived from cumulative counters between ticks, exactly like the cgroup
cpuacct/proc-stat based collectors in the reference.

Collector profile (reference collectors in parens): noderesource, nodeinfo
(static CPU/NUMA -> KV), nodestorageinfo, podresource, beresource,
sysresource, pagecache, coldmemoryresource (kidled), hostapplication,
podthrottled, psi, performance (CPI via the native perf binding). Container
granularity is folded into the pod collectors (the pod model here carries no
container statuses; every consumer reads pod-level series).
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

from koordinator_tpu_torch.api.qos import QoSClass
from koordinator_tpu_torch.koordlet import metriccache as mc
from koordinator_tpu_torch.koordlet import metrics as koordlet_metrics
from koordinator_tpu_torch.koordlet.statesinformer import (
    StatesInformer,
    _device_probe_error,
    cuda_device_count,
    cuda_device_uuid,
)
from koordinator_tpu_torch.koordlet.util import kidled as kidled_util
from koordinator_tpu_torch.koordlet.util import machineinfo
from koordinator_tpu_torch.koordlet.util import system as sysutil
from koordinator_tpu_torch.utils.features import KOORDLET_GATES


def pod_qos_dir(pod) -> str:
    """k8s cgroup QoS class dir for a pod (guaranteed pods sit under kubepods)."""
    qos = pod.qos_class
    if qos == QoSClass.BE:
        return sysutil.QOS_BESTEFFORT
    if not pod.spec.requests or pod.spec.requests != pod.spec.limits:
        return sysutil.QOS_BURSTABLE
    return sysutil.QOS_GUARANTEED


class MetricsAdvisor:
    def __init__(self, informer: StatesInformer, cache: mc.MetricCache,
                 config: Optional[sysutil.SystemConfig] = None):
        self.informer = informer
        self.cache = cache
        self.config = config or sysutil.CONFIG
        self._last_cpu: Dict[str, tuple] = {}  # key -> (ts, cumulative_ns)
        self._last_proc: Optional[tuple] = None  # (ts, total, idle)
        self._last_throttled: Dict[str, Tuple[int, int]] = {}  # (periods, throttled)
        self.perf_reader = None  # set by Daemon when CPICollector enabled
        self.kidled = kidled_util.KidledInterface(self.config)
        self._node_info_collected = False
        # the collector profile (plugins_profile.go): (name, gate-or-None, fn);
        # gated entries are skipped when their feature gate is off
        self.profile: List[Tuple[str, Optional[str], Callable[[float], None]]] = [
            ("noderesource", None, self.collect_node_resource),
            ("nodeinfo", None, self.collect_node_info),
            ("nodestorageinfo", None, self.collect_node_storage_info),
            ("podresource", None, self.collect_pod_resource),
            ("beresource", None, self.collect_be_resource),
            ("sysresource", None, self.collect_sys_resource),
            ("pagecache", "PageCacheCollector", self.collect_pagecache),
            ("coldmemoryresource", "ColdPageCollector", self.collect_cold_memory),
            ("hostapplication", None, self.collect_host_application),
            ("podthrottled", None, self.collect_pod_throttled),
            ("psi", "PSICollector", self.collect_psi),
            ("performance", "CPICollector", self.collect_performance),
            # gated OFF by default: the default sampler opens a CUDA context
            # on every card, which costs each card memory that workload pods
            # would otherwise get
            ("gpudevice", "TPUDeviceCollector", self.collect_device_usage),
        ]
        # device sampler seam (reference devices/gpu NVML walk; here the
        # node's CUDA devices via torch.cuda):
        # () -> [{minor, uuid, core_pct, mem_bytes}]
        self.device_sampler = sample_gpu_devices

    # -- helpers -------------------------------------------------------------
    def _cpu_rate(self, key: str, now: float, cumulative_ns: Optional[int]) -> Optional[float]:
        if cumulative_ns is None:
            return None
        prev = self._last_cpu.get(key)
        self._last_cpu[key] = (now, cumulative_ns)
        if prev is None or now <= prev[0]:
            return None
        return max(0.0, (cumulative_ns - prev[1]) / 1e9 / (now - prev[0]))

    # -- collectors ----------------------------------------------------------
    def collect_node_resource(self, now: float) -> None:
        stat = sysutil.read_proc_stat_cpu(self.config)
        if stat is not None:
            total, idle = stat
            prev = self._last_proc
            self._last_proc = (now, total, idle)
            if prev is not None and total > prev[1]:
                busy_frac = 1.0 - (idle - prev[2]) / (total - prev[1])
                node = self.informer.get_node()
                cores = (
                    node.allocatable.get("cpu", 0) / 1000.0 if node else 1.0
                ) or 1.0
                self.cache.add_sample(
                    mc.NODE_CPU_USAGE, busy_frac * cores, now
                )
        mem = sysutil.read_meminfo(self.config)
        if mem:
            total_b = mem.get("MemTotal", 0)
            avail = mem.get("MemAvailable", mem.get("MemFree", 0))
            if total_b:
                self.cache.add_sample(mc.NODE_MEMORY_USAGE, total_b - avail, now)

    def collect_pod_resource(self, now: float) -> None:
        for pod in self.informer.get_all_pods():
            rel = self.config.pod_relative_path(pod_qos_dir(pod), pod.meta.uid or pod.meta.name)
            cpu_ns = sysutil.read_cpu_usage_ns(rel, self.config)
            rate = self._cpu_rate(f"pod/{pod.meta.key}", now, cpu_ns)
            if rate is not None:
                self.cache.add_sample(mc.POD_CPU_USAGE, rate, now, pod=pod.meta.key)
            mem_b = sysutil.read_memory_usage_bytes(rel, self.config)
            if mem_b is not None:
                self.cache.add_sample(mc.POD_MEMORY_USAGE, mem_b, now, pod=pod.meta.key)

    def collect_be_resource(self, now: float) -> None:
        rel = self.config.qos_relative_path(sysutil.QOS_BESTEFFORT)
        cpu_ns = sysutil.read_cpu_usage_ns(rel, self.config)
        rate = self._cpu_rate("be_root", now, cpu_ns)
        if rate is not None:
            self.cache.add_sample(mc.BE_CPU_USAGE, rate, now)

    def collect_sys_resource(self, now: float) -> None:
        """system usage = node usage - sum(pod usage) (sysresource collector)."""
        node = self.cache.query(mc.NODE_CPU_USAGE, "latest", now=now)
        if node is None:
            return
        pod_sum = 0.0
        for labels in self.cache.series_labels(mc.POD_CPU_USAGE):
            v = self.cache.query(mc.POD_CPU_USAGE, "latest", now=now, **labels)
            pod_sum += v or 0.0
        self.cache.add_sample(mc.SYS_CPU_USAGE, max(0.0, node - pod_sum), now)

    def collect_node_info(self, now: float) -> None:
        """Static CPU/NUMA topology -> KV store (nodeinfo collector; feeds the
        statesinformer nodeTopo reporter). Collected once — topology is
        immutable while the agent runs."""
        if self._node_info_collected:
            return
        info = machineinfo.discover(self.config)
        if info is None:
            return
        self.cache.set_kv(mc.NODE_CPU_INFO_KEY, info.topology)
        self.cache.set_kv(mc.NODE_NUMA_INFO_KEY, info.numa_mem)
        self._node_info_collected = True

    def collect_node_storage_info(self, now: float) -> None:
        """Filesystem usage of the root volume + disk busy-ticks from
        /proc/diskstats (nodestorageinfo collector)."""
        raw = sysutil.read_file(self.config.proc_path("diskstats"))
        if raw:
            devices = {}
            for line in raw.splitlines():
                f = line.split()
                # field 13 = ms spent doing I/O (io_ticks)
                if len(f) >= 13:
                    devices[f[2]] = int(f[12])
            for dev, ticks in devices.items():
                rate = self._cpu_rate(f"disk/{dev}", now, ticks * 10**6)
                if rate is not None:
                    self.cache.add_sample(
                        mc.NODE_DISK_IO_TICKS, rate, now, device=dev)
        try:
            st = os.statvfs(self.config.fs_root_dir)
            total = st.f_frsize * st.f_blocks
            used = total - st.f_frsize * st.f_bavail
            self.cache.add_sample(mc.NODE_FS_TOTAL_BYTES, total, now)
            self.cache.add_sample(mc.NODE_FS_USED_BYTES, used, now)
        except OSError:
            pass

    def collect_pagecache(self, now: float) -> None:
        """Per-pod page cache from memory.stat (pagecache collector): the
        'file' (v2) / 'cache' (v1) field — reclaimable, so the batch-memory
        calculation can credit it back."""
        field_name = "file" if self.config.use_cgroup_v2 else "cache"
        pat = re.compile(rf"^{field_name} (\d+)", re.M)
        for pod in self.informer.get_all_pods():
            rel = self.config.pod_relative_path(
                pod_qos_dir(pod), pod.meta.uid or pod.meta.name)
            raw = sysutil.read_cgroup(rel, sysutil.MEMORY_STAT, self.config)
            if raw is None:
                continue
            m = pat.search(raw)
            if m:
                self.cache.add_sample(
                    mc.POD_PAGECACHE, int(m.group(1)), now, pod=pod.meta.key)

    def collect_cold_memory(self, now: float) -> None:
        """Per-pod kidled cold bytes (coldmemoryresource collector)."""
        if not self.kidled.enabled():
            return
        for pod in self.informer.get_all_pods():
            rel = self.config.pod_relative_path(
                pod_qos_dir(pod), pod.meta.uid or pod.meta.name)
            stats = self.kidled.read_pod_stats(rel)
            if stats is not None:
                self.cache.add_sample(
                    mc.POD_COLD_MEMORY, stats.cold_bytes(300), now,
                    pod=pod.meta.key)

    def collect_host_application(self, now: float) -> None:
        """Usage of non-k8s host services declared in NodeSLO extensions
        (hostapplication collector): entries {name, cgroupPath} under the
        'hostApplications' extension key."""
        from koordinator_tpu_torch.api.objects import host_applications

        for app in host_applications(self.informer.get_node_slo()):
            name, rel = app.get("name"), app.get("cgroupPath")
            if not name or not rel:
                continue
            cpu_ns = sysutil.read_cpu_usage_ns(rel, self.config)
            rate = self._cpu_rate(f"hostapp/{name}", now, cpu_ns)
            if rate is not None:
                self.cache.add_sample(mc.HOST_APP_CPU_USAGE, rate, now, app=name)
            mem_b = sysutil.read_memory_usage_bytes(rel, self.config)
            if mem_b is not None:
                self.cache.add_sample(
                    mc.HOST_APP_MEMORY_USAGE, mem_b, now, app=name)

    def collect_pod_throttled(self, now: float) -> None:
        """cfs throttling ratio per pod from cpu.stat (podthrottled collector):
        delta(nr_throttled)/delta(nr_periods) between ticks."""
        for pod in self.informer.get_all_pods():
            rel = self.config.pod_relative_path(
                pod_qos_dir(pod), pod.meta.uid or pod.meta.name)
            raw = sysutil.read_cgroup(rel, sysutil.CPU_STAT, self.config)
            if raw is None:
                continue
            periods = re.search(r"nr_periods (\d+)", raw)
            throttled = re.search(r"nr_throttled (\d+)", raw)
            if not periods or not throttled:
                continue
            cur = (int(periods.group(1)), int(throttled.group(1)))
            prev = self._last_throttled.get(pod.meta.key)
            self._last_throttled[pod.meta.key] = cur
            if prev is None:
                continue
            dp = cur[0] - prev[0]
            dt = cur[1] - prev[1]
            if dp > 0:
                self.cache.add_sample(
                    mc.POD_CPU_THROTTLED_RATIO, dt / dp, now, pod=pod.meta.key)

    def collect_psi(self, now: float) -> None:
        psi = sysutil.read_psi("", sysutil.CPU_PRESSURE, self.config)
        if psi is not None:
            self.cache.add_sample(mc.NODE_CPU_PSI_FULL_AVG10, psi.full_avg10, now)
            koordlet_metrics.NODE_CPU_PSI_FULL_AVG10.set(psi.full_avg10)
        psi = sysutil.read_psi("", sysutil.MEMORY_PRESSURE, self.config)
        if psi is not None:
            self.cache.add_sample(mc.NODE_MEM_PSI_FULL_AVG10, psi.full_avg10, now)
            koordlet_metrics.NODE_MEM_PSI_FULL_AVG10.set(psi.full_avg10)

    def collect_performance(self, now: float) -> None:
        """CPI per pod via the native perf_event binding (performance collector,
        performance_collector_linux.go:46-101; gated like Libpfm4/CPICollector)."""
        if self.perf_reader is None:
            return
        pods = self.informer.get_all_pods()
        for pod in pods:
            sample = self.perf_reader(pod)
            if sample is None:
                continue
            cycles, instructions = sample
            if instructions > 0:
                cpi = cycles / instructions
                self.cache.add_sample(mc.POD_CPI, cpi, now, pod=pod.meta.key)
                koordlet_metrics.CONTAINER_CPI.set(cpi, pod=pod.meta.key)
        gc = getattr(self.perf_reader, "gc", None)
        if gc is not None:
            gc(p.meta.key for p in pods)

    def collect_device_usage(self, now: float) -> None:
        """Per-accelerator utilization series (reference devices/gpu
        collector_gpu_linux.go:164-201 walks NVML; the default sampler
        reads each card's memory occupancy through torch.cuda). Pod-level
        attribution is not collected: node-level per-card series carry the
        whole card, as the reference's device-wide NVML walk does."""
        for dev in self.device_sampler():
            labels = {"minor": str(dev["minor"]), "uuid": dev["uuid"]}
            self.cache.add_sample(
                mc.NODE_GPU_CORE_USAGE, float(dev.get("core_pct", 0.0)), now,
                **labels,
            )
            self.cache.add_sample(
                mc.NODE_GPU_MEM_USAGE, float(dev.get("mem_bytes", 0)), now,
                **labels,
            )

    def collect_once(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for _name, gate, fn in self.profile:
            if gate is not None and not KOORDLET_GATES.enabled(gate):
                continue
            fn(now)


def sample_gpu_devices() -> List[Dict]:
    """Default device sampler: each CUDA card's memory occupancy through
    torch.cuda (the JAX package's ``sample_tpu_devices`` reads a TPU chip's
    bytes_in_use / bytes_limit). A node agent reports the whole card, as
    the reference's NVML walk does, so the bytes in use are device-wide:
    total less ``torch.cuda.mem_get_info``'s free bytes, whoever holds
    them. ``mem_get_info`` opens a CUDA context on the card in the agent's
    process. The formula is the JAX one: core_pct = 100 * in_use / limit,
    mem_bytes = in_use. Returns [] with no CUDA device; a probe that raises
    returns [] (counted once per stage, never a made-up reading)."""
    import torch

    try:
        count = cuda_device_count()
    except Exception as exc:
        _device_probe_error("cuda_devices", exc)
        return []
    out = []
    for minor in range(count):
        try:
            uuid = cuda_device_uuid(torch.cuda.get_device_properties(minor))
            free, limit = torch.cuda.mem_get_info(minor)
        except Exception as exc:
            _device_probe_error("mem_get_info", exc)
            return []
        in_use = int(limit) - int(free)
        out.append({
            "minor": minor,
            "uuid": uuid,
            # unknown capacity -> no occupancy claim, not a nonsense ratio
            "core_pct": 100.0 * in_use / limit if limit > 0 else 0.0,
            "mem_bytes": in_use,
        })
    return out
