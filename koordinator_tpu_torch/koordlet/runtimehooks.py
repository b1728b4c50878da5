"""Runtime hooks: container-lifecycle resource injection.

Analog of reference `pkg/koordlet/runtimehooks/` (runtimehooks.go:35-77): a hook
registry applied in three modes —
  (a) proxy: invoked by the runtime-proxy gRPC interceptor per CRI call
      (runtimeproxy/ hands us a ContainerContext, we mutate it)
  (b) NRI: the koordlet/nri.py plugin dials containerd's NRI socket,
      registers, and serves RunPodSandbox/CreateContainer/UpdateContainer
      from the same hook chain (reference runtimehooks/nri/server.go;
      e2e against a fake containerd in tests/test_nri.py)
  (c) standalone reconciler (reconciler/reconciler.go): watch pods, write
      cgroups directly via the executor — always-on backstop.

Hooks (feature-gated, config.go:38-100):
  * groupidentity : bvt.warp_ns per QoS class (hooks/groupidentity)
  * cpuset        : apply the scheduler's resource-status annotation
  * batchresource : cfs quota + memory limits from batch-cpu/batch-memory
  * gpu           : device env injection (NVIDIA_VISIBLE_DEVICES)
  * cpunormalization: scale cfs quota by the node's cpu-normalization ratio
  * coresched     : SMT core-scheduling cookies per QoS group (hooks/coresched)
  * terwayqos     : network-QoS config files for the terway dataplane
                    (hooks/terwayqos)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.objects import (
    ANNOTATION_DEVICE_ALLOCATED,
    ANNOTATION_RESOURCE_STATUS,
    Pod,
)
from koordinator_tpu_torch.api.qos import QoSClass
from koordinator_tpu_torch.api.resources import ResourceName
from koordinator_tpu_torch.koordlet.metricsadvisor import pod_qos_dir
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    ResourceUpdateExecutor,
    ResourceUpdater,
)
from koordinator_tpu_torch.koordlet.statesinformer import StatesInformer
from koordinator_tpu_torch.koordlet.util import system as sysutil

ANNOTATION_CPU_NORMALIZATION_RATIO = "node.koordinator.sh/cpu-normalization-ratio"

# bvt.warp_ns values per QoS (groupidentity defaults: LS=2, BE=-1)
BVT_BY_QOS = {
    QoSClass.LSE: 2,
    QoSClass.LSR: 2,
    QoSClass.LS: 2,
    QoSClass.SYSTEM: 0,
    QoSClass.BE: -1,
    QoSClass.NONE: 0,
}


@dataclass
class ContainerContext:
    """Mutable view of a container's runtime config (protocol/ adapters)."""

    pod: Pod
    cgroup_parent: str
    env: Dict[str, str] = field(default_factory=dict)
    cgroup_writes: List[ResourceUpdater] = field(default_factory=list)

    def add_write(self, resource: str, value: str, level: int = 2) -> None:
        self.cgroup_writes.append(
            ResourceUpdater(self.cgroup_parent, resource, value, level)
        )


class Hook:
    name = "hook"

    def apply(self, ctx: ContainerContext) -> None:
        raise NotImplementedError


class GroupIdentityHook(Hook):
    name = "GroupIdentity"

    def apply(self, ctx: ContainerContext) -> None:
        bvt = BVT_BY_QOS.get(ctx.pod.qos_class, 0)
        ctx.add_write(sysutil.CPU_BVT_WARP_NS, str(bvt))


class CPUSetHook(Hook):
    name = "CPUSetAllocator"

    def __init__(self, informer: Optional[StatesInformer] = None):
        self.informer = informer

    def apply(self, ctx: ContainerContext) -> None:
        # SYSTEM QoS pods run on the node's dedicated system cpuset
        # (hooks/cpuset/rule.go system-qos-resource path)
        if ctx.pod.qos_class == QoSClass.SYSTEM and self.informer is not None:
            node = self.informer.get_node()
            if node is not None:
                sys_cpus, _excl = node.system_qos_resource()
                if sys_cpus:
                    ctx.add_write(sysutil.CPUSET_CPUS, sys_cpus)
                    return
        raw = ctx.pod.meta.annotations.get(ANNOTATION_RESOURCE_STATUS)
        if not raw:
            return
        try:
            status = json.loads(raw)
        except (ValueError, TypeError):
            return
        cpuset = status.get("cpuset")
        if cpuset:
            ctx.add_write(sysutil.CPUSET_CPUS, cpuset)


class BatchResourceHook(Hook):
    name = "BatchResource"

    def apply(self, ctx: ContainerContext) -> None:
        req = ctx.pod.spec.requests
        limits = ctx.pod.spec.limits
        batch_cpu = limits.get(ResourceName.BATCH_CPU) or req.get(ResourceName.BATCH_CPU)
        batch_mem = limits.get(ResourceName.BATCH_MEMORY) or req.get(
            ResourceName.BATCH_MEMORY
        )
        if batch_cpu:
            period = 100000
            ctx.add_write(sysutil.CPU_CFS_QUOTA, str(int(batch_cpu / 1000 * period)))
        if batch_mem:
            ctx.add_write(sysutil.MEMORY_LIMIT, str(int(batch_mem)))


class GPUEnvHook(Hook):
    name = "GPUEnv"

    def apply(self, ctx: ContainerContext) -> None:
        raw = ctx.pod.meta.annotations.get(ANNOTATION_DEVICE_ALLOCATED)
        if not raw:
            return
        try:
            alloc = json.loads(raw)
        except (ValueError, TypeError):
            return
        gpus = alloc.get("gpu") or []
        if gpus:
            ctx.env["NVIDIA_VISIBLE_DEVICES"] = ",".join(
                str(g["minor"]) for g in gpus
            )
            core = sum(g.get("core", 0) for g in gpus)
            if core and core % 100 != 0:
                ctx.env["CUDA_MPS_ACTIVE_THREAD_PERCENTAGE"] = str(core)


class CPUNormalizationHook(Hook):
    name = "CPUNormalization"

    def __init__(self, informer: StatesInformer):
        self.informer = informer

    def apply(self, ctx: ContainerContext) -> None:
        node = self.informer.get_node()
        if node is None:
            return
        raw = node.meta.annotations.get(ANNOTATION_CPU_NORMALIZATION_RATIO)
        if not raw:
            return
        try:
            ratio = float(raw)
        except ValueError:
            return
        if ratio <= 0 or ratio == 1.0:
            return
        cpu_limit = ctx.pod.spec.limits.get(ResourceName.CPU)
        if cpu_limit:
            period = 100000
            quota = int(cpu_limit / 1000.0 * period / ratio)
            ctx.add_write(sysutil.CPU_CFS_QUOTA, str(quota))


class CoreSchedHook(Hook):
    """SMT core-scheduling cookies per QoS trust domain (hooks/coresched/
    core_sched.go): tasks of LS-tier pods share one "expeller" cookie, each
    BE pod group gets its own, so BE never co-runs on a hyperthread sibling
    of an LS task. Gated by NodeSLO resourceQOSStrategy.core_sched_enable and
    kernel support (util/coresched, prctl PR_SCHED_CORE; degrades to no-op)."""

    name = "CoreSched"

    # QoS tiers sharing the node-wide expeller cookie (ExpellerGroupSuffix)
    _EXPELLER = (QoSClass.LSE, QoSClass.LSR, QoSClass.LS, QoSClass.SYSTEM)

    def __init__(self, informer: StatesInformer,
                 executor: ResourceUpdateExecutor, cse=None):
        from koordinator_tpu_torch.koordlet.util.coresched import default_interface

        self.informer = informer
        self.executor = executor
        self.cse = cse if cse is not None else default_interface()
        # core-sched-group-id -> (leader pid, cookie value) — the cookie value
        # guards against pid reuse: a recycled leader pid carries a DIFFERENT
        # cookie, so the entry is discarded instead of leaking a foreign
        # cookie into the group (cookie_cache.go expiry analog)
        self.groups: Dict[str, tuple] = {}
        # every pid a cookie was put on, for cleanup when the group (or the
        # whole feature) goes away
        self.group_pids: Dict[str, set] = {}

    def _group_id(self, pod: Pod) -> str:
        qos = pod.qos_class
        if qos in self._EXPELLER:
            return "ls-expeller"
        if qos is QoSClass.BE:
            return f"be/{pod.meta.uid or pod.meta.key}"
        return ""  # NONE: leave cookies alone

    def _pod_pids(self, relative_dir: str) -> List[int]:
        """Tasks of the pod: the pod dir's procs plus every child (container)
        cgroup's — on cgroup v2 the no-internal-process rule keeps all tasks
        in the leaf container cgroups, so the pod file alone is empty."""
        chunks = [self.executor.read(relative_dir, sysutil.CGROUP_PROCS) or ""]
        pod_file = self.executor.config.cgroup_file_path(
            relative_dir, sysutil.CGROUP_PROCS
        )
        pod_dir = os.path.dirname(pod_file)
        try:
            children = sorted(os.listdir(pod_dir))
        except OSError:
            children = []
        for child in children:
            child_procs = os.path.join(pod_dir, child, sysutil.CGROUP_PROCS)
            if os.path.isfile(child_procs):
                chunks.append(sysutil.read_file(child_procs) or "")
        pids: List[int] = []
        for chunk in chunks:
            pids.extend(int(p) for p in chunk.split() if p.strip().isdigit())
        return pids

    def apply(self, ctx: ContainerContext) -> None:
        if not self.informer.get_node_slo().resource_qos_strategy.core_sched_enable:
            return
        if not self.cse.supported():
            return
        group = self._group_id(ctx.pod)
        if not group:
            return
        pids = self._pod_pids(ctx.cgroup_parent)
        if not pids:
            return
        entry = self.groups.get(group)
        if entry is not None and self.cse.get_cookie(entry[0]) != entry[1]:
            entry = None  # leader died (or its pid was recycled)
        if entry is None:
            # first container of the group: mint a cookie on its first task
            if not self.cse.create_cookie(pids[0]):
                return
            cookie = self.cse.get_cookie(pids[0])
            if not cookie:
                return
            entry = (pids[0], cookie)
            self.groups[group] = entry
        leader, cookie = entry
        # idempotent: only tasks whose cookie diverges are re-shared, so a
        # steady-state reconcile tick issues zero prctls
        stale = [
            p for p in pids if p != leader and self.cse.get_cookie(p) != cookie
        ]
        if stale:
            self.cse.share_from(leader, stale)
        self.group_pids.setdefault(group, set()).update(pids)

    def _clear_group(self, group: str) -> None:
        for pid in self.group_pids.pop(group, ()):  # dead pids fail harmlessly
            self.cse.clear_cookie(pid)
        self.groups.pop(group, None)

    def reconcile_node(self) -> None:
        """Prune cookie groups whose pods are gone, and clear every cookie
        when the feature is switched off (the reference clears on disable —
        otherwise SMT siblings stay force-idled until every pod restarts)."""
        if not self.groups and not self.group_pids:
            return
        if not self.informer.get_node_slo().resource_qos_strategy.core_sched_enable:
            for group in list(self.group_pids) + list(self.groups):
                self._clear_group(group)
            return
        live = {"ls-expeller"}
        for pod in self.informer.get_all_pods():
            group = self._group_id(pod)
            if group:
                live.add(group)
        for group in list(self.groups):
            if group not in live:
                self._clear_group(group)


ANNOTATION_NET_QOS = "koordinator.sh/networkQOS"  # extension network qos


class TerwayQoSHook(Hook):
    """Network QoS config generator (hooks/terwayqos/terwayqos.go): when the
    NodeSLO netQoS policy is "terwayQos", render the node bandwidth ceilings
    to `var/lib/terway/qos/global_bps_config` and every local pod's priority +
    per-pod limits to `pod.json`; the terway dataplane consumes the files.
    Per-container apply() is a no-op — this is a node-level reconciler."""

    name = "TerwayQoS"

    # QoS class -> terway priority band (getPodPrio: LS tiers 0, mid 1, BE 2)
    _PRIO = {QoSClass.LSE: 0, QoSClass.LSR: 0, QoSClass.LS: 0,
             QoSClass.SYSTEM: 0, QoSClass.NONE: 1, QoSClass.BE: 2}

    def __init__(self, informer: StatesInformer,
                 executor: ResourceUpdateExecutor):
        self.informer = informer
        self.executor = executor
        self._written: Dict[str, str] = {}  # path -> last content on disk

    def _qos_dir(self) -> str:
        root = self.executor.config.fs_root_dir
        return os.path.join(root, "var/lib/terway/qos")

    def apply(self, ctx: ContainerContext) -> None:
        return None

    def reconcile_node(self) -> None:
        slo = self.informer.get_node_slo().resource_qos_strategy
        qos_dir = self._qos_dir()
        node_path = os.path.join(qos_dir, "global_bps_config")
        pod_path = os.path.join(qos_dir, "pod.json")
        if slo.net_qos_policy != "terwayQos":
            for path in (node_path, pod_path):
                if self._written.pop(path, None) is not None or os.path.exists(path):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
            return
        os.makedirs(qos_dir, exist_ok=True)
        self._write_atomic(node_path, (
            f"hw_tx_bps_max {slo.net_hw_tx_bps}\n"
            f"hw_rx_bps_max {slo.net_hw_rx_bps}\n"
        ))
        pods = {}
        for pod in self.informer.get_all_pods():
            limits = {}
            raw = pod.meta.annotations.get(ANNOTATION_NET_QOS)
            if raw:
                try:
                    limits = json.loads(raw)
                except (ValueError, TypeError):
                    limits = {}
                if not isinstance(limits, dict):
                    limits = {}  # valid JSON but not an object
            pods[pod.meta.uid or pod.meta.key] = {
                "podName": pod.meta.name,
                "podNamespace": pod.meta.namespace,
                "podUID": pod.meta.uid,
                "prio": self._PRIO.get(pod.qos_class, 1),
                "ingressLimit": limits.get("ingressLimit", ""),
                "egressLimit": limits.get("egressLimit", ""),
            }
        self._write_atomic(pod_path, json.dumps(pods, sort_keys=True))

    def _write_atomic(self, path: str, content: str) -> None:
        # tmp + rename (the dataplane polls these files and must never read a
        # truncated document); unchanged content is not rewritten, so steady
        # state leaves mtime/inode alone and the poller skips re-parsing
        if self._written.get(path) == content:
            return
        tmp = path + ".tmp"
        if sysutil.write_file(tmp, content):
            try:
                os.replace(tmp, path)
            except OSError:
                return
            self._written[path] = content


DEFAULT_HOOKS = (GroupIdentityHook, BatchResourceHook, GPUEnvHook)


class HostApplicationHook(Hook):
    """Group identity for non-k8s host services: every NodeSLO
    `hostApplications` entry gets the bvt of its declared QoS written to its
    own cgroup dir (hooks/groupidentity/rule.go getHostQOSBvtValue +
    interceptor.go host-app path). Node-level only — host apps have no
    container lifecycle, so the standalone reconciler is the only mode."""

    name = "hostapplication"

    def __init__(self, informer: StatesInformer,
                 executor: ResourceUpdateExecutor):
        self.informer = informer
        self.executor = executor
        self._applied: Dict[str, int] = {}  # cgroup rel -> bvt written

    def apply(self, ctx: ContainerContext) -> None:  # no per-container work
        return

    def reconcile_node(self) -> None:
        from koordinator_tpu_torch.api.objects import host_applications
        from koordinator_tpu_torch.api.qos import qos_class_by_name

        want: Dict[str, int] = {}
        for app in host_applications(self.informer.get_node_slo()):
            rel = app.get("cgroupPath")
            if not rel:
                continue
            qos = qos_class_by_name(app.get("qos", ""))
            want[rel] = BVT_BY_QOS.get(qos, 0)
        # entries removed from NodeSLO (or whose path changed) get their
        # bvt reset — otherwise a deleted host app keeps preempting BE
        for rel in list(self._applied):
            if rel not in want:
                self.executor.update(
                    ResourceUpdater(rel, sysutil.CPU_BVT_WARP_NS, "0"))
                del self._applied[rel]
        for rel, bvt in want.items():
            self.executor.update(
                ResourceUpdater(rel, sysutil.CPU_BVT_WARP_NS, str(bvt)))
            self._applied[rel] = bvt


class RuntimeHooks:
    """Hook runner: proxy-mode entry (run_hooks) + standalone reconciler."""

    def __init__(self, informer: StatesInformer, executor: ResourceUpdateExecutor,
                 core_sched=None):
        self.informer = informer
        self.executor = executor
        self.hooks: List[Hook] = [cls() for cls in DEFAULT_HOOKS]
        self.hooks.append(CPUSetHook(informer))
        self.hooks.append(CPUNormalizationHook(informer))
        self.hooks.append(CoreSchedHook(informer, executor, cse=core_sched))
        self.hooks.append(TerwayQoSHook(informer, executor))
        self.hooks.append(HostApplicationHook(informer, executor))

    def run_hooks(self, ctx: ContainerContext) -> ContainerContext:
        """Proxy/NRI-mode: mutate the container context; the caller (runtime
        proxy or NRI adapter) applies the response to the real runtime call."""
        for hook in self.hooks:
            hook.apply(ctx)
        return ctx

    def reconcile(self) -> int:
        """Standalone reconciler backstop (reconciler.go:144): apply hook output
        directly through the executor for every local pod; returns writes."""
        wrote = 0
        for hook in self.hooks:
            node_level = getattr(hook, "reconcile_node", None)
            if node_level is not None:
                node_level()
        for pod in self.informer.get_all_pods():
            if not pod.is_assigned:
                continue
            rel = self.executor.config.pod_relative_path(
                pod_qos_dir(pod), pod.meta.uid or pod.meta.name
            )
            ctx = ContainerContext(pod=pod, cgroup_parent=rel)
            self.run_hooks(ctx)
            shrink = [u for u in ctx.cgroup_writes]
            wrote += self.executor.leveled_update_batch(shrink, increase=False)
        return wrote
