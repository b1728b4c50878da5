"""QoS manager: runtime enforcement strategy plugins.

Analog of reference `pkg/koordlet/qosmanager/` (registry plugins/register.go:36-46):
each strategy reads statesinformer + metriccache and enforces through the
resource executor. Implemented strategies:

  * cpusuppress  (plugins/cpusuppress/cpu_suppress.go:240-321, formula :138-164):
      suppress(BE) = capacity * thresholdPercent - podNonBEUsed - systemUsed
      applied as the BE root cpuset size (paired HT cores, spread over NUMA) or
      as cfs quota, with recovery when the policy flips.
  * cpuevict     (BE eviction when BE cpu satisfaction is below threshold)
  * memoryevict  (BE eviction when node memory utilization crosses threshold)
  * cpuburst     (cfs burst for LS containers, plugins/cpuburst/)
  * resctrl      (LLC ways / MBA percent per QoS class via resctrl fs)
  * cgreconcile  (cpu.shares / memory guarantees per QoS cgroup)

An `Evictor` mirrors the shared eviction helper (framework/context.go:42-90):
victims sorted BE-first by priority then usage.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.objects import NodeSLO, Pod
from koordinator_tpu_torch.api.qos import QoSClass
from koordinator_tpu_torch.client.store import KIND_POD, ObjectStore
from koordinator_tpu_torch.koordlet import metriccache as mc
from koordinator_tpu_torch.koordlet import metrics as koordlet_metrics
from koordinator_tpu_torch.koordlet.metricsadvisor import pod_qos_dir
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    ResourceUpdateExecutor,
    ResourceUpdater,
)
from koordinator_tpu_torch.koordlet.statesinformer import StatesInformer
from koordinator_tpu_torch.koordlet.util import resctrl as resctrl_util
from koordinator_tpu_torch.koordlet.util import system as sysutil
from koordinator_tpu_torch.utils.cpuset import CPUSet
from koordinator_tpu_torch.utils.features import KOORDLET_GATES


class Evictor:
    """Shared BE eviction helper (qosmanager/framework/context.go:42-90)."""

    def __init__(self, store: ObjectStore, informer: StatesInformer,
                 cache: mc.MetricCache):
        self.store = store
        self.informer = informer
        self.cache = cache
        self.evicted: List[str] = []

    def be_victims_by_usage(self) -> List[Pod]:
        pods = [
            p for p in self.informer.get_all_pods()
            if p.qos_class == QoSClass.BE
        ]

        def usage(p: Pod) -> float:
            return self.cache.query(mc.POD_CPU_USAGE, "latest", pod=p.meta.key) or 0.0

        # lowest priority first, then highest usage (framework helper sort)
        return sorted(pods, key=lambda p: ((p.spec.priority or 0), -usage(p)))

    def evict(self, pod: Pod, reason: str) -> None:
        pod.phase = "Failed"
        pod.meta.annotations["koordinator.sh/evicted"] = reason
        self.store.update(KIND_POD, pod)
        self.evicted.append(pod.meta.key)
        koordlet_metrics.POD_EVICTION_TOTAL.inc(reason=reason)


@dataclass
class QOSStrategyContext:
    informer: StatesInformer
    cache: mc.MetricCache
    executor: ResourceUpdateExecutor
    evictor: Evictor
    metric_collect_interval: float = 60.0


class CPUSuppress:
    """BE cpu suppression (cpusuppress plugin)."""

    name = "cpusuppress"
    MIN_SUPPRESS_CPUS = 2  # reference beMinCPU

    def __init__(self, ctx: QOSStrategyContext):
        self.ctx = ctx
        self.policy_in_use: Optional[str] = None

    def _suppress_cpus(self, slo: NodeSLO, now: float) -> Optional[float]:
        node = self.ctx.informer.get_node()
        if node is None:
            return None
        threshold = slo.resource_used_threshold_with_be.cpu_suppress_threshold_percent
        capacity = node.allocatable.get("cpu", 0) / 1000.0
        node_usage = self.ctx.cache.query(
            mc.NODE_CPU_USAGE, "latest", self.ctx.metric_collect_interval, now
        )
        if node_usage is None:
            return None
        # podNonBEUsed + hostAppNonBEUsed + systemUsed = nodeUsage - BE usage.
        # Host applications declared BE in NodeSLO must not shrink the BE
        # share either (helpers/calculator.go:30-66 NonBEHostAppFilter +
        # cpu_suppress.go:139-161): their usage comes out of the non-BE side.
        be_usage = self.ctx.cache.query(
            mc.BE_CPU_USAGE, "latest", self.ctx.metric_collect_interval, now
        ) or 0.0
        from koordinator_tpu_torch.api.objects import host_applications

        for app in host_applications(slo):
            if app.get("qos", "") != "BE" or not app.get("name"):
                continue
            be_usage += self.ctx.cache.query(
                mc.HOST_APP_CPU_USAGE, "latest",
                self.ctx.metric_collect_interval, now, app=app["name"],
            ) or 0.0
        non_be_used = max(0.0, node_usage - be_usage)
        suppress = capacity * threshold / 100.0 - non_be_used
        return max(suppress, float(self.MIN_SUPPRESS_CPUS))

    def run(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        slo = self.ctx.informer.get_node_slo()
        be_rel = self.ctx.executor.config.qos_relative_path(sysutil.QOS_BESTEFFORT)
        if not (KOORDLET_GATES.enabled("BECPUSuppress")
                and slo.resource_used_threshold_with_be.enable):
            self._recover(be_rel)
            return
        suppress = self._suppress_cpus(slo, now)
        if suppress is None:
            return
        node = self.ctx.informer.get_node()
        total_cpus = int((node.allocatable.get("cpu", 0)) // 1000) if node else 0
        if slo.resource_used_threshold_with_be.cpu_suppress_policy == "cfsQuota":
            period = 100000
            quota = max(int(suppress * period), period // 100)
            self.ctx.executor.update(
                ResourceUpdater(be_rel, sysutil.CPU_CFS_QUOTA, str(quota))
            )
            self.policy_in_use = "cfsQuota"
            koordlet_metrics.BE_SUPPRESS_CPU_CORES.set(quota / period)
        else:
            # cpuset policy: round up, at least 2, paired HT cores from the
            # top — skipping the node's exclusive SYSTEM-QoS cores
            # (cpu_suppress.go system-qos-resource path)
            excluded = self._system_qos_excluded(node)
            want = min(max(int(math.ceil(suppress)), self.MIN_SUPPRESS_CPUS),
                       max(total_cpus - len(excluded),
                           self.MIN_SUPPRESS_CPUS))
            # only real cpu ids: running past total_cpus would write a
            # cpuset the kernel rejects with EINVAL
            picked = [c for c in range(total_cpus) if c not in excluded]
            if len(picked) < self.MIN_SUPPRESS_CPUS:
                # the exclusion is unsatisfiable (system cores cover nearly
                # the whole node): top up with the least-bad excluded cores
                # — still only REAL cpu ids, never fabricated ones
                picked = picked + [c for c in sorted(excluded)
                                   if c < total_cpus]
            if not picked:
                return  # no real cpus known; writing any cpuset would EINVAL
            cpus = CPUSet(picked[:want])
            self.ctx.executor.update(
                ResourceUpdater(be_rel, sysutil.CPUSET_CPUS, cpus.format())
            )
            self.policy_in_use = "cpuset"
            koordlet_metrics.BE_SUPPRESS_CPU_CORES.set(float(len(cpus)))

    @staticmethod
    def _system_qos_excluded(node) -> set:
        """Exclusive SYSTEM-QoS cores are barred to BE under suppression
        AND recovery (cpu_suppress.go system-qos-resource path)."""
        if node is None:
            return set()
        sys_cpus, sys_exclusive = node.system_qos_resource()
        if sys_cpus and sys_exclusive:
            return set(CPUSet.parse(sys_cpus))
        return set()

    def _recover(self, be_rel: str) -> None:
        if self.policy_in_use == "cfsQuota":
            self.ctx.executor.update(
                ResourceUpdater(be_rel, sysutil.CPU_CFS_QUOTA, "-1")
            )
        elif self.policy_in_use == "cpuset":
            node = self.ctx.informer.get_node()
            if node is not None:
                total = int(node.allocatable.get("cpu", 0) // 1000)
                excluded = self._system_qos_excluded(node)
                restore = [c for c in range(total) if c not in excluded]
                if not restore:
                    restore = list(range(total))  # unsatisfiable exclusion
                if restore:
                    self.ctx.executor.update(
                        ResourceUpdater(
                            be_rel, sysutil.CPUSET_CPUS,
                            CPUSet(restore).format(),
                        )
                    )
        self.policy_in_use = None
        koordlet_metrics.BE_SUPPRESS_CPU_CORES.clear()


class CPUEvict:
    """Evict BE pods when BE cpu satisfaction is below threshold
    (plugins/cpuevict)."""

    name = "cpuevict"

    def __init__(self, ctx: QOSStrategyContext):
        self.ctx = ctx

    def run(self, now: Optional[float] = None) -> None:
        if not KOORDLET_GATES.enabled("BECPUEvict"):
            return
        now = time.time() if now is None else now
        slo = self.ctx.informer.get_node_slo()
        thr = slo.resource_used_threshold_with_be
        if not thr.enable:
            return
        be_usage = self.ctx.cache.query(mc.BE_CPU_USAGE, "avg", 300, now)
        node = self.ctx.informer.get_node()
        if be_usage is None or node is None:
            return
        capacity = node.allocatable.get("cpu", 0) / 1000.0
        if capacity and be_usage / capacity * 100 >= thr.cpu_evict_be_usage_threshold_percent:
            victims = self.ctx.evictor.be_victims_by_usage()
            if victims:
                self.ctx.evictor.evict(victims[0], "BECPUEvict")


class MemoryEvict:
    """Evict BE pods on node memory pressure (plugins/memoryevict)."""

    name = "memoryevict"

    def __init__(self, ctx: QOSStrategyContext):
        self.ctx = ctx

    def run(self, now: Optional[float] = None) -> None:
        if not KOORDLET_GATES.enabled("BEMemoryEvict"):
            return
        now = time.time() if now is None else now
        slo = self.ctx.informer.get_node_slo()
        thr = slo.resource_used_threshold_with_be
        if not thr.enable:
            return
        node = self.ctx.informer.get_node()
        mem_usage = self.ctx.cache.query(mc.NODE_MEMORY_USAGE, "latest", now=now)
        if node is None or mem_usage is None:
            return
        capacity = node.allocatable.get("memory", 0)
        if not capacity:
            return
        util = mem_usage / capacity * 100
        if util < thr.memory_evict_threshold_percent:
            return
        lower = thr.memory_evict_lower_percent or (thr.memory_evict_threshold_percent - 2)
        to_release = (util - lower) / 100.0 * capacity
        released = 0.0
        for victim in self.ctx.evictor.be_victims_by_usage():
            if released >= to_release:
                break
            released += self.ctx.cache.query(
                mc.POD_MEMORY_USAGE, "latest", pod=victim.meta.key
            ) or 0.0
            self.ctx.evictor.evict(victim, "BEMemoryEvict")


class CPUBurst:
    """cfs burst for LS pods (plugins/cpuburst)."""

    name = "cpuburst"

    def __init__(self, ctx: QOSStrategyContext):
        self.ctx = ctx

    def run(self, now: Optional[float] = None) -> None:
        if not KOORDLET_GATES.enabled("CPUBurst"):
            return
        slo = self.ctx.informer.get_node_slo()
        strategy = slo.cpu_burst_strategy
        if strategy.policy == "none":
            return
        for pod in self.ctx.informer.get_all_pods():
            if not pod.qos_class.is_latency_sensitive:
                continue
            limit_milli = pod.spec.limits.get("cpu", 0)
            if limit_milli <= 0:
                continue
            rel = self.ctx.executor.config.pod_relative_path(
                pod_qos_dir(pod), pod.meta.uid or pod.meta.name
            )
            if strategy.policy in ("cpuBurstOnly", "auto"):
                burst_us = int(
                    limit_milli / 1000.0 * 100000
                    * strategy.cpu_burst_percent / 100.0
                )
                self.ctx.executor.update(
                    ResourceUpdater(rel, sysutil.CPU_CFS_BURST, str(burst_us), level=1)
                )
                koordlet_metrics.CPU_BURST_TOTAL.inc(pod=pod.meta.key)


class ResctrlReconcile:
    """LLC / memory-bandwidth isolation via resctrl groups (plugins/resctrl).

    Creates BE/LS resctrl groups and writes schemata lines with the configured
    LLC way-percentage and MBA percent."""

    name = "resctrl"

    def __init__(self, ctx: QOSStrategyContext, cache_ways: int = 12):
        self.ctx = ctx
        # fallback way count when the root schemata isn't readable
        self.cache_ways = cache_ways
        self.iface = resctrl_util.ResctrlInterface(ctx.executor.config)

    def run(self, now: Optional[float] = None) -> None:
        if not KOORDLET_GATES.enabled("RdtResctrl"):
            return
        slo = self.ctx.informer.get_node_slo()
        qos = slo.resource_qos_strategy
        if not qos.be_enable:
            return
        num_ways = self.iface.num_l3_ways() or self.cache_ways
        # tolerate out-of-range config (mis-rendered sloconfig) rather than
        # crashing the whole strategy loop
        percent = min(100, max(1, qos.llc_be_percent))
        schemata = resctrl_util.Schemata(
            l3_masks={0: resctrl_util.calculate_l3_mask(num_ways, 0, percent)},
            mb_percents={0: qos.mba_be_percent},
        )
        self.iface.write_schemata(resctrl_util.BE_GROUP, schemata)
        koordlet_metrics.RESCTRL_UPDATE_TOTAL.inc(group="BE")
        self.ctx.executor.auditor.record(
            "info", "node", "resctrl_write", group="BE",
            schemata=schemata.format().strip()
        )


class CgroupReconcile:
    """Baseline per-QoS cgroup parameters (plugins/cgreconcile): cpu.shares and
    memory protection per QoS class."""

    name = "cgreconcile"
    CPU_SHARES_BY_QOS = {
        QoSClass.LSE: 4096, QoSClass.LSR: 4096, QoSClass.LS: 2048,
        QoSClass.BE: 2,
    }

    def __init__(self, ctx: QOSStrategyContext):
        self.ctx = ctx

    def run(self, now: Optional[float] = None) -> None:
        if not KOORDLET_GATES.enabled("CgroupReconcile"):
            return
        for pod in self.ctx.informer.get_all_pods():
            shares = self.CPU_SHARES_BY_QOS.get(pod.qos_class)
            if shares is None:
                continue
            rel = self.ctx.executor.config.pod_relative_path(
                pod_qos_dir(pod), pod.meta.uid or pod.meta.name
            )
            self.ctx.executor.update(
                ResourceUpdater(rel, sysutil.CPU_SHARES, str(shares), level=1)
            )


class BlkIOReconcile:
    """Per-QoS-tier block-IO weights (plugins/blkio): LS gets a high io.weight
    (v2; blkio.bfq.weight on v1 via the resource table translation), BE a low
    one, so BE IO yields under contention."""

    name = "blkio"

    def __init__(self, ctx: QOSStrategyContext):
        self.ctx = ctx

    def run(self, now: Optional[float] = None) -> None:
        if not KOORDLET_GATES.enabled("BlkIOReconcile"):
            return
        slo = self.ctx.informer.get_node_slo()
        qos = slo.resource_qos_strategy
        if not qos.blkio_enable:
            return
        # tier dirs first (besteffort/burstable; NOT the kubepods root —
        # guaranteed pods are its direct children and boosting the root
        # would change kubepods-vs-system weighting instead)
        for qos_dir, weight in (
            (sysutil.QOS_BURSTABLE, qos.ls_blkio_weight),
            (sysutil.QOS_BESTEFFORT, qos.be_blkio_weight),
        ):
            rel = self.ctx.executor.config.qos_relative_path(qos_dir)
            self.ctx.executor.update(
                ResourceUpdater(rel, sysutil.BLKIO_WEIGHT, str(weight))
            )
        # guaranteed pods get the LS weight on their own pod dirs
        for pod in self.ctx.informer.get_all_pods():
            if pod_qos_dir(pod) != sysutil.QOS_GUARANTEED:
                continue
            weight = (qos.be_blkio_weight
                      if pod.qos_class == QoSClass.BE else qos.ls_blkio_weight)
            rel = self.ctx.executor.config.pod_relative_path(
                sysutil.QOS_GUARANTEED, pod.meta.uid or pod.meta.name)
            self.ctx.executor.update(
                ResourceUpdater(rel, sysutil.BLKIO_WEIGHT, str(weight), level=1)
            )


class SystemReconcile:
    """Node-level memory watermark tuning (plugins/sysreconcile): writes
    /proc/sys/vm knobs from the NodeSLO system strategy so reclaim starts
    early enough to protect LS pods from BE memory bursts."""

    name = "sysreconcile"

    def __init__(self, ctx: QOSStrategyContext):
        self.ctx = ctx

    def run(self, now: Optional[float] = None) -> None:
        if not KOORDLET_GATES.enabled("SystemConfig"):
            return
        slo = self.ctx.informer.get_node_slo()
        strategy = slo.system_strategy
        cfg = self.ctx.executor.config
        mem = sysutil.read_meminfo(cfg)
        total_kb = mem.get("MemTotal", 0) // 1024
        if total_kb:
            # factor is per-ten-thousand of total memory
            min_free = total_kb * strategy.min_free_kbytes_factor // 10_000
            sysutil.write_file(
                cfg.proc_path("sys/vm/min_free_kbytes"), str(min_free))
        sysutil.write_file(
            cfg.proc_path("sys/vm/watermark_scale_factor"),
            str(strategy.watermark_scale_factor))
        self.ctx.executor.auditor.record(
            "info", "node", "sysreconcile",
            watermark_scale_factor=str(strategy.watermark_scale_factor))


class QoSManager:
    """Strategy loop (qosmanager framework)."""

    def __init__(self, store: ObjectStore, informer: StatesInformer,
                 cache: mc.MetricCache, executor: ResourceUpdateExecutor):
        self.evictor = Evictor(store, informer, cache)
        self.ctx = QOSStrategyContext(informer, cache, executor, self.evictor)
        self.strategies = [
            CPUSuppress(self.ctx),
            CPUEvict(self.ctx),
            MemoryEvict(self.ctx),
            CPUBurst(self.ctx),
            ResctrlReconcile(self.ctx),
            CgroupReconcile(self.ctx),
            BlkIOReconcile(self.ctx),
            SystemReconcile(self.ctx),
        ]

    def run_once(self, now: Optional[float] = None) -> None:
        t_start = time.perf_counter()
        for strategy in self.strategies:
            strategy.run(now)
            koordlet_metrics.QOS_STRATEGY_RUN_TOTAL.inc(
                strategy=type(strategy).__name__)
        koordlet_metrics.QOS_CYCLE_SECONDS.observe(
            time.perf_counter() - t_start)
