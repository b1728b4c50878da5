"""A GPU pool on a churn world: node agents that publish Device CRs, and
GPU-share pods that ask for fractions of the cards.

``pool_nodes`` picks the pool's nodes, spread over the world;
``start_pool_agents`` gives each a koordlet ``Daemon`` on its own
``FakeFS`` (seeded by ``koordlet --fake-node``'s seed) and ticks it
twice, so each publishes its NodeMetric and, through its device collector,
its Device CR. ``gpu_share_specs`` are the pods as plain dicts and
``add_gpu_share_pods`` adds them to a store, so one list can be applied to
the stores of either package. ``gpu_dump`` is what two worlds are
compared by on the GPU axes. A caller of the JAX package passes its
modules through ``NodeSide``; the default is this package's.
"""

from __future__ import annotations

import dataclasses
import json
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

GIB = 1024 ** 3
# gpu_core per pod, in turn; gpu_memory_ratio equals it
SHARE_CYCLE = (25, 50, 100)


@dataclasses.dataclass(frozen=True)
class NodeSide:
    """The modules a pool is built from: one package's api.objects,
    api.resources, client.store, koordlet.daemon, koordlet.util.system
    and cmd.koordlet."""

    objects: types.ModuleType
    resources: types.ModuleType
    store: types.ModuleType
    daemon: types.ModuleType
    system: types.ModuleType
    koordlet_cmd: types.ModuleType


def port_node_side() -> NodeSide:
    from koordinator_tpu_torch.api import objects, resources
    from koordinator_tpu_torch.client import store
    from koordinator_tpu_torch.cmd import koordlet as koordlet_cmd
    from koordinator_tpu_torch.koordlet import daemon
    from koordinator_tpu_torch.koordlet.util import system

    return NodeSide(objects, resources, store, daemon, system, koordlet_cmd)


def pool_nodes(store, count: int, side: Optional[NodeSide] = None
               ) -> List[str]:
    """``count`` node names spread evenly over the store's nodes (sorted
    by name)."""
    side = side or port_node_side()
    names = sorted(n.meta.name for n in store.list(side.store.KIND_NODE))
    if not 0 < count <= len(names):
        raise ValueError(f"a pool of {count} from {len(names)} nodes")
    step = len(names) // count
    return [names[i * step] for i in range(count)]


def start_pool_agents(store, names: Sequence[str], now: float,
                      device_collector: Optional[Callable] = None,
                      side: Optional[NodeSide] = None) -> List[Tuple]:
    """A (Daemon, FakeFS) per pool node, each ticked at ``now`` and
    ``now + 10``. ``device_collector`` None keeps the Daemon's default,
    the real device probe. The caller cleans the FakeFS trees up; where
    this raises, it has cleaned them up itself."""
    side = side or port_node_side()
    agents = []
    try:
        for name in names:
            fs = side.system.FakeFS(use_cgroup_v2=True)
            agents.append((None, fs))
            side.koordlet_cmd._seed_fake_node(fs, store, name)
            daemon = side.daemon.Daemon(
                store, name, fs.config, report_interval_seconds=0,
                device_collector=device_collector)
            agents[-1] = (daemon, fs)
        for daemon, fs in agents:
            daemon.run_once(now=now)
        for daemon, fs in agents:
            fs.set_proc("stat", "cpu  2000 0 2000 12000 0 0 0 0 0 0\n")
            daemon.run_once(now=now + 10)
    except BaseException:
        cleanup(agents)
        raise
    return agents


def cleanup(agents) -> None:
    for _daemon, fs in agents:
        fs.cleanup()


def gpu_share_specs(count: int) -> List[Dict]:
    """``count`` GPU-share pods: gpu_core cycles through SHARE_CYCLE, with
    gpu_memory_ratio equal to it, beside a small CPU and memory ask."""
    return [dict(name=f"gpu-share-{i}", uid=f"gpu-share-{i}",
                 gpu=SHARE_CYCLE[i % len(SHARE_CYCLE)],
                 cpu=500, mem=GIB)
            for i in range(count)]


def add_gpu_share_pods(store, specs: Sequence[Dict], created: float,
                       side: Optional[NodeSide] = None) -> None:
    side = side or port_node_side()
    o, rl = side.objects, side.resources.ResourceList
    for s in specs:
        store.add(side.store.KIND_POD, o.Pod(
            meta=o.ObjectMeta(name=s["name"], namespace="gpu",
                              uid=s["uid"], creation_timestamp=created),
            spec=o.PodSpec(requests=rl.of(
                cpu=s["cpu"], memory=s["mem"], pods=1, gpu_core=s["gpu"],
                gpu_memory_ratio=s["gpu"]))))


def gpu_dump(store, side: Optional[NodeSide] = None) -> Dict:
    """Each GPU-share pod's node, device-allocation annotation and
    PodScheduled condition; each node's GPU allocatable; each Device CR's
    devices. Reads only names the two packages share."""
    side = side or port_node_side()
    k = side.store
    gpu_names = ("gpu", "gpu_core", "gpu_memory", "gpu_memory_ratio")
    pods = {}
    for p in store.list(k.KIND_POD):
        if p.meta.namespace != "gpu":
            continue
        cond = p.get_condition("PodScheduled")
        pods[p.meta.key] = (
            p.spec.node_name,
            p.meta.annotations.get(side.objects.ANNOTATION_DEVICE_ALLOCATED),
            None if cond is None else (cond.status, cond.reason,
                                       cond.message))
    nodes = {}
    for n in store.list(k.KIND_NODE):
        totals = {g: n.allocatable[getattr(side.resources.ResourceName,
                                           g.upper())] for g in gpu_names}
        if any(totals.values()):
            nodes[n.meta.name] = totals
    devices = {
        d.meta.name: [(x.type, x.uuid, x.minor, x.health, x.numa_node,
                       sorted((str(r), x.resources[r]) for r in x.resources))
                      for x in d.devices]
        for d in store.list(k.KIND_DEVICE)}
    return {"pods": pods, "nodes": nodes, "devices": devices}


def allocations(pod, side: Optional[NodeSide] = None) -> Dict:
    """A bound pod's device-allocation annotation, decoded."""
    side = side or port_node_side()
    raw = pod.meta.annotations.get(side.objects.ANNOTATION_DEVICE_ALLOCATED)
    return json.loads(raw) if raw else {}
