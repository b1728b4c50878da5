"""All-in-one colocation demo: every binary's component on one store.

Runs the cross-component control loop (SURVEY 3.3) in a single process —
the `kind`-cluster analog for trying the framework without a cluster:

  koordlet metrics -> NodeMetric CR -> koord-manager batch allocatable ->
  admission webhook BE mutation -> batched scheduler placement ->
  koordlet cgroup enforcement (hermetic FakeFS node)

The scheduler, manager and descheduler run their device passes on the
card unless ``--device cpu`` is given.

Usage: python -m koordinator_tpu_torch.cmd.demo [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

from koordinator_tpu_torch.cmd import add_device_flag


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="koord-demo")
    ap.add_argument("--be-pods", type=int, default=3,
                    help="best-effort spark pods to co-locate")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from koordinator_tpu_torch.api.objects import (
        LABEL_POD_QOS,
        ClusterColocationProfile,
        Node,
        ObjectMeta,
        Pod,
        PodSpec,
    )
    from koordinator_tpu_torch.api.qos import QoSClass
    from koordinator_tpu_torch.api.resources import ResourceList, ResourceName
    from koordinator_tpu_torch.client.store import (
        KIND_COLOCATION_PROFILE,
        KIND_NODE,
        KIND_POD,
        ObjectStore,
    )
    from koordinator_tpu_torch.descheduler import Descheduler
    from koordinator_tpu_torch.koordlet.daemon import Daemon
    from koordinator_tpu_torch.koordlet.util import system as sysutil
    from koordinator_tpu_torch.koordlet.util.system import FakeFS
    from koordinator_tpu_torch.manager import Manager
    from koordinator_tpu_torch.scheduler.cycle import Scheduler

    GIB = 1024**3
    NOW = 1_000_000.0
    store = ObjectStore()
    fs = FakeFS(use_cgroup_v2=True)
    try:
        store.add(KIND_NODE, Node(
            meta=ObjectMeta(name="node-0", namespace=""),
            allocatable=ResourceList.of(cpu=16_000, memory=64 * GIB,
                                        pods=110)))
        fs.set_proc("stat", "cpu  1000 0 1000 8000 0 0 0 0 0 0\n")
        fs.set_proc(
            "meminfo",
            "MemTotal: %d kB\nMemFree: %d kB\nMemAvailable: %d kB\n"
            % (64 * GIB // 1024, 48 * GIB // 1024, 56 * GIB // 1024))
        ls = Pod(
            meta=ObjectMeta(name="web", uid="web",
                            labels={LABEL_POD_QOS: "LS"}),
            spec=PodSpec(node_name="node-0",
                         requests=ResourceList.of(cpu=4000, memory=8 * GIB),
                         limits=ResourceList.of(cpu=4000, memory=8 * GIB)),
            phase="Running")
        store.add(KIND_POD, ls)
        ls_rel = fs.config.pod_relative_path("", "web")
        fs.set_cgroup(ls_rel, sysutil.CPU_STAT, "usage_usec 10000000\n")
        fs.set_cgroup(ls_rel, sysutil.MEMORY_USAGE, str(4 * GIB))
        log("[cluster] 1 node (16 cores / 64Gi), 1 LS pod (web, 4 cores)")

        daemon = Daemon(store, "node-0", fs.config,
                        report_interval_seconds=0)
        daemon.run_once(now=NOW)
        fs.set_proc("stat", "cpu  2000 0 2000 12000 0 0 0 0 0 0\n")
        fs.set_cgroup(ls_rel, sysutil.CPU_STAT, "usage_usec 30000000\n")
        daemon.run_once(now=NOW + 10)
        log("[koordlet] metrics collected; NodeMetric CR reported")

        manager = Manager(store, identity="demo-manager",
                          device=args.device)
        manager.tick(now=NOW + 11)
        node = store.get(KIND_NODE, "/node-0")
        log(f"[koord-manager] batch allocatable: "
            f"cpu={node.allocatable[ResourceName.BATCH_CPU]}m "
            f"memory={node.allocatable[ResourceName.BATCH_MEMORY] // GIB}Gi")

        store.add(KIND_COLOCATION_PROFILE, ClusterColocationProfile(
            meta=ObjectMeta(name="spark"), selector={"app": "spark"},
            qos_class=QoSClass.BE, priority_class_name="koord-batch",
            scheduler_name="koord-scheduler"))
        for i in range(args.be_pods):
            store.add(KIND_POD, Pod(
                meta=ObjectMeta(name=f"spark-{i}", uid=f"spark-{i}",
                                labels={"app": "spark"},
                                creation_timestamp=NOW + 11 + i),
                spec=PodSpec(
                    requests=ResourceList.of(cpu=2000, memory=4 * GIB),
                    limits=ResourceList.of(cpu=2000, memory=4 * GIB))))
        sample = store.get(KIND_POD, "default/spark-0")
        log(f"[webhook] spark pods mutated to BE: requests "
            f"batch-cpu={sample.spec.requests[ResourceName.BATCH_CPU]}m")

        result = Scheduler(store, device=args.device).run_cycle(
            now=NOW + 15)
        log(f"[koord-scheduler] bound {len(result.bound)} BE pods "
            f"({result.kernel_seconds * 1000:.1f}ms kernel): "
            f"{[b.pod_key for b in result.bound]}")

        for b in result.bound:
            pod = store.get(KIND_POD, b.pod_key)
            pod.phase = "Running"
            store.update(KIND_POD, pod)
            rel = fs.config.pod_relative_path(
                sysutil.QOS_BESTEFFORT, pod.meta.name)
            fs.set_cgroup(rel, sysutil.CPU_STAT, "usage_usec 0\n")
            fs.set_cgroup(rel, sysutil.MEMORY_USAGE, "0")
        daemon.run_once(now=NOW + 20)
        first = fs.config.pod_relative_path(sysutil.QOS_BESTEFFORT, "spark-0")
        log(f"[koordlet] BE cgroups enforced: cfs_quota="
            f"{daemon.executor.read(first, sysutil.CPU_CFS_QUOTA)} "
            f"bvt={daemon.executor.read(first, sysutil.CPU_BVT_WARP_NS)}")

        summary = Descheduler(store, device=args.device).run_once(
            now=NOW + 30)
        log(f"[koord-descheduler] rebalance pass: {summary}")
        log("demo complete: the full colocation loop ran end to end")
        return 0
    finally:
        fs.cleanup()


if __name__ == "__main__":
    raise SystemExit(main())
