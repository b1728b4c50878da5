"""States informer: a registry of node-state informer plugins.

Analog of reference `pkg/koordlet/statesinformer/` — the plugin registry in
`impl/registry.go:21-28` instantiates {nodeSLO, pvc, nodeTopo, node, pods,
nodeMetric} informers, plus the device reporter (`impl/states_device_linux.go`).
Mirrored here:

  * ``NodeInformer`` / ``NodeSLOInformer`` — local views of the store with
    callback fan-out to subscribers (api.go:94-108)
  * ``PodsInformer`` — pod map keyed by UID; when a :class:`KubeletStub` is
    attached it pulls `GET /pods` on an interval and PLEG pod-added events
    force an immediate resync (`impl/states_pods.go:91-126`), otherwise it
    mirrors the store
  * ``PVCInformer`` — pvc namespace/name -> bound volume name map
    (`impl/states_pvc.go:44-60`)
  * ``DeviceInformer`` — publishes the node's accelerator inventory as a
    Device CR (`impl/states_device_linux.go`); the default collector probes
    the node's CUDA devices through ``torch.cuda`` instead of NVML
  * ``NodeMetricInformer`` — aggregates the metric cache into the NodeMetric
    CR status on an interval (`impl/states_nodemetric.go:182-210`)
  * ``NodeTopoInformer`` — publishes NodeResourceTopology from machine info.

The outer :class:`StatesInformer` keeps the pre-registry surface (get_node,
get_all_pods, register_callback, ...) by delegating to the plugins, so every
koordlet module keeps working unchanged.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional

from koordinator_tpu_torch.api.objects import (
    Device,
    DeviceInfo,
    Node,
    NodeMetric,
    NodeMetricInfo,
    NodeResourceTopology,
    NodeSLO,
    ObjectMeta,
    PersistentVolumeClaim,
    Pod,
    PodMetricInfo,
)
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.client.store import (
    KIND_DEVICE,
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_NODE_SLO,
    KIND_NODE_TOPOLOGY,
    KIND_POD,
    KIND_PVC,
    EventType,
    ObjectStore,
)
from koordinator_tpu_torch.koordlet import metriccache as mc
from koordinator_tpu_torch.koordlet.kubeletstub import KubeletError, KubeletStub
from koordinator_tpu_torch.koordlet.pleg import Pleg, PodLifecycleEvent

CALLBACK_NODE_SLO = "nodeslo"
CALLBACK_PODS = "pods"
CALLBACK_NODE = "node"


@dataclass
class PluginOption:
    """Construction-time wiring handed to every plugin's setup()
    (impl/states_informer.go PluginOption)."""

    store: ObjectStore
    node_name: str
    cache: mc.MetricCache
    report_interval: int = 60
    aggregate_windows: tuple = (300, 900, 1800)
    kubelet_stub: Optional[KubeletStub] = None
    kubelet_sync_interval: float = 30.0
    pleg: Optional[Pleg] = None
    device_collector: Optional[Callable[[], List[DeviceInfo]]] = None


class PluginState:
    """Shared inter-plugin state: the plugin map (for cross-plugin lookups the
    way podsInformer grabs nodeInformer in states_pods.go:79-86) and the
    callback runner."""

    def __init__(self) -> None:
        self.informer_plugins: Dict[str, "InformerPlugin"] = {}
        self._callbacks: Dict[str, List[Callable]] = {}

    def register_callback(self, kind: str, fn: Callable) -> None:
        self._callbacks.setdefault(kind, []).append(fn)

    def fire(self, kind: str, obj) -> None:
        for fn in self._callbacks.get(kind, []):
            fn(obj)


class InformerPlugin:
    """informerPlugin interface (impl/states_informer.go:60-66): Setup wires
    dependencies, sync() is one tick of the plugin's loop, HasSynced gates
    consumers that need a complete first view."""

    name: str = ""

    def setup(self, opts: PluginOption, state: PluginState) -> None:
        raise NotImplementedError

    def sync(self, now: float) -> None:  # default: event-driven plugins no-op
        return None

    def has_synced(self) -> bool:
        return True


class NodeInformer(InformerPlugin):
    name = "nodeInformer"

    def setup(self, opts: PluginOption, state: PluginState) -> None:
        self.opts, self.state = opts, state
        opts.store.subscribe(KIND_NODE, self._on_node)

    def get_node(self) -> Optional[Node]:
        return self.opts.store.get(KIND_NODE, f"/{self.opts.node_name}")

    def _on_node(self, ev: EventType, node: Node, old) -> None:
        if node.meta.name == self.opts.node_name:
            self.state.fire(CALLBACK_NODE, node)


class NodeSLOInformer(InformerPlugin):
    name = "nodeSLOInformer"

    def setup(self, opts: PluginOption, state: PluginState) -> None:
        self.opts, self.state = opts, state
        opts.store.subscribe(KIND_NODE_SLO, self._on_nodeslo)

    def get_node_slo(self) -> NodeSLO:
        slo = self.opts.store.get(KIND_NODE_SLO, f"/{self.opts.node_name}")
        return slo if slo is not None else NodeSLO(
            meta=ObjectMeta(name=self.opts.node_name, namespace="")
        )

    def _on_nodeslo(self, ev: EventType, slo: NodeSLO, old) -> None:
        if slo.meta.name == self.opts.node_name:
            self.state.fire(CALLBACK_NODE_SLO, slo)


class PodsInformer(InformerPlugin):
    """Pod map for this node. Two sources, matching the reference:

    * apiserver mirror: store events keep the map fresh (the default; all
      in-process tests run this way)
    * kubelet: when ``opts.kubelet_stub`` is set, `GET /pods` is pulled every
      ``kubelet_sync_interval`` seconds and a PLEG pod-added event forces the
      next sync() to pull immediately (states_pods.go:102-126) — the kubelet
      list then *owns* the map (pods it no longer reports are dropped)."""

    name = "podsInformer"

    def __init__(self) -> None:
        self._pods_by_uid: Dict[str, Pod] = {}
        self._synced = False
        self._last_kubelet_sync = 0.0
        self._resync_requested = False

    def setup(self, opts: PluginOption, state: PluginState) -> None:
        self.opts, self.state = opts, state
        opts.store.subscribe(KIND_POD, self._on_pod)
        if opts.pleg is not None:
            opts.pleg.add_handler(self._on_pleg_event)

    # -- views ---------------------------------------------------------------
    def get_all_pods(self) -> List[Pod]:
        if self.opts.kubelet_stub is not None:
            return [p for p in self._pods_by_uid.values() if not p.is_terminated]
        return [
            p
            for p in self.opts.store.list(KIND_POD)
            if p.spec.node_name == self.opts.node_name and not p.is_terminated
        ]

    def get_pod_by_uid(self, uid: str) -> Optional[Pod]:
        """O(1) lookup for the hook server's per-RPC critical path."""
        return self._pods_by_uid.get(uid)

    def has_synced(self) -> bool:
        return self.opts.kubelet_stub is None or self._synced

    # -- sources -------------------------------------------------------------
    def _on_pod(self, ev: EventType, pod: Pod, old) -> None:
        if pod.spec.node_name != self.opts.node_name:
            return
        uid = pod.meta.uid
        if uid:
            if ev is EventType.DELETED:
                self._pods_by_uid.pop(uid, None)
            else:
                self._pods_by_uid[uid] = pod
        self.state.fire(CALLBACK_PODS, pod)

    def _on_pleg_event(self, ev: PodLifecycleEvent) -> None:
        # states_pods.go:102-112: only pod creation triggers an early resync,
        # and an already-pending request is not duplicated.
        if ev.event_type == "pod_added":
            self._resync_requested = True

    def request_resync(self) -> None:
        self._resync_requested = True

    def sync(self, now: float) -> None:
        stub = self.opts.kubelet_stub
        if stub is None:
            return
        due = now - self._last_kubelet_sync >= self.opts.kubelet_sync_interval
        if not (due or self._resync_requested):
            return
        try:
            pods = stub.get_all_pods()
        except KubeletError:
            # kubelet unreachable: keep the last good view (states_pods.go:148)
            return
        if not pods and self._pods_by_uid:
            # kubelet recovering from a crash may return empty; don't wipe
            return
        self._last_kubelet_sync = now
        self._resync_requested = False
        self._pods_by_uid = {p.meta.uid: p for p in pods if p.meta.uid}
        self._synced = True
        for pod in self._pods_by_uid.values():
            self.state.fire(CALLBACK_PODS, pod)


class PVCInformer(InformerPlugin):
    name = "pvcInformer"

    def __init__(self) -> None:
        self._volume_name: Dict[str, str] = {}

    def setup(self, opts: PluginOption, state: PluginState) -> None:
        self.opts = opts
        opts.store.subscribe(KIND_PVC, self._on_pvc)

    def get_volume_name(self, namespace: str, name: str) -> str:
        """pvc namespace/name -> bound PV name (states_pvc.go:55-60); the
        blkio reconciler resolves device majmin through this."""
        return self._volume_name.get(f"{namespace}/{name}", "")

    def _on_pvc(self, ev: EventType, pvc: PersistentVolumeClaim, old) -> None:
        if ev is EventType.DELETED:
            self._volume_name.pop(pvc.meta.key, None)
        elif pvc.volume_name:
            self._volume_name[pvc.meta.key] = pvc.volume_name


_DEVICE_PROBE_LOGGED = set()  # log each failure stage once, count always
_DEVICE_PROBE_LOCK = threading.Lock()  # probes run from informer threads


def _device_probe_error(stage: str, exc: Exception) -> None:
    """A device-probe failure degrades the report to no accelerators but
    must never be invisible: count every occurrence
    (koord_koordlet_informer_errors_total) and log the first per stage —
    a silent `except Exception` here once hid real breakage behind an
    empty device inventory."""
    from koordinator_tpu_torch.koordlet import metrics as koordlet_metrics

    koordlet_metrics.INFORMER_ERRORS_TOTAL.inc(
        informer="deviceInformer", stage=stage)
    with _DEVICE_PROBE_LOCK:
        first = stage not in _DEVICE_PROBE_LOGGED
        _DEVICE_PROBE_LOGGED.add(stage)
    if first:
        logging.getLogger(__name__).warning(
            "device probe %s failed (%s: %s); reporting no accelerators "
            "— counted in koord_koordlet_informer_errors_total",
            stage, type(exc).__name__, exc)


def cuda_device_count() -> int:
    """The node's visible CUDA devices; 0 where torch sees no CUDA (a CPU
    build, no driver, no card). Raises what torch.cuda raises."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def cuda_device_uuid(props) -> str:
    """The card's UUID as NVML and nvidia-smi spell it ("GPU-<uuid>")."""
    uuid = str(props.uuid)
    return uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"


def collect_gpu_devices() -> List[DeviceInfo]:
    """Default device collector: probe the node's CUDA devices through
    torch.cuda (the stand-in for the reference's NVML walk in
    states_device_linux.go buildGPUDevice; the JAX package's
    ``collect_tpu_devices`` probes TPU chips through ``jax.devices()``).
    One device per visible card under the generic accelerator axes, so
    DeviceShare/gpudeviceresource consume them unchanged. With no CUDA
    device it returns [] and counts nothing, as the JAX probe does off-TPU;
    a probe that raises returns [] (counted and logged once per stage,
    never silent, never a made-up capacity)."""
    import torch

    try:
        count = cuda_device_count()
    except Exception as exc:
        _device_probe_error("cuda_devices", exc)
        return []
    out = []
    for minor in range(count):
        try:
            props = torch.cuda.get_device_properties(minor)
            uuid = cuda_device_uuid(props)
            mem = int(props.total_memory)
        except Exception as exc:
            _device_probe_error("device_properties", exc)
            return []
        out.append(
            DeviceInfo(
                type="gpu",
                uuid=uuid,
                minor=minor,
                health=True,
                resources=ResourceList.of(
                    gpu_core=100, gpu_memory=mem, gpu_memory_ratio=100
                ),
                # the JAX probe's process_index: 0 for one agent on one host
                numa_node=0,
            )
        )
    return out


class DeviceInformer(InformerPlugin):
    """Publish the node's device inventory as a Device CR for the scheduler's
    DeviceShare plugin and the gpudeviceresource node-resource plugin
    (states_device_linux.go reportDevice)."""

    name = "deviceInformer"

    def setup(self, opts: PluginOption, state: PluginState) -> None:
        self.opts = opts
        self.collector = opts.device_collector or collect_gpu_devices

    def sync(self, now: float) -> None:
        devices = self.collector()
        if not devices:
            return
        # the CR owns its copies: a collector reusing DeviceInfo objects must
        # not mutate the stored view (nvml walk rebuilds each report too)
        devices = [replace(d) for d in devices]
        store, name = self.opts.store, self.opts.node_name
        existing: Optional[Device] = store.get(KIND_DEVICE, f"/{name}")
        if existing is None:
            store.add(KIND_DEVICE, Device(
                meta=ObjectMeta(name=name, namespace=""), devices=devices
            ))
        elif [
            (d.type, d.uuid, d.minor, d.health) for d in existing.devices
        ] != [(d.type, d.uuid, d.minor, d.health) for d in devices]:
            existing.devices = devices
            store.update(KIND_DEVICE, existing)


class NodeMetricInformer(InformerPlugin):
    """NodeMetric reporter (states_nodemetric.go:182-210): avg + percentile
    windows aggregated from the metric cache into the CR status."""

    name = "nodeMetricInformer"

    def __init__(self) -> None:
        self._last_report = 0.0

    def setup(self, opts: PluginOption, state: PluginState) -> None:
        self.opts = opts
        self.pods = state.informer_plugins["podsInformer"]

    def sync(self, now: float) -> None:
        self.sync_node_metric(now)

    def sync_node_metric(self, now: Optional[float] = None) -> Optional[NodeMetric]:
        now = time.time() if now is None else now
        opts = self.opts
        if now - self._last_report < opts.report_interval:
            return None
        self._last_report = now
        cache = opts.cache

        def usage(window: Optional[float], agg: str) -> ResourceList:
            cpu = cache.query(mc.NODE_CPU_USAGE, agg, window, now)
            mem = cache.query(mc.NODE_MEMORY_USAGE, agg, window, now)
            return ResourceList.of(
                cpu=int((cpu or 0.0) * 1000), memory=int(mem or 0)
            )

        info = NodeMetricInfo(
            node_usage=usage(opts.report_interval * 2, "avg"),
            system_usage=ResourceList.of(
                cpu=int(
                    (cache.query(mc.SYS_CPU_USAGE, "avg",
                                 opts.report_interval * 2, now) or 0.0)
                    * 1000
                )
            ),
            aggregated_node_usages={
                w: {
                    agg: usage(float(w), agg)
                    for agg in ("avg", "p50", "p90", "p95", "p99")
                }
                for w in opts.aggregate_windows
            },
        )
        pods_metric = []
        for pod in self.pods.get_all_pods():
            cpu = cache.query(
                mc.POD_CPU_USAGE, "avg", opts.report_interval * 2, now,
                pod=pod.meta.key,
            )
            memv = cache.query(
                mc.POD_MEMORY_USAGE, "avg", opts.report_interval * 2, now,
                pod=pod.meta.key,
            )
            if cpu is None and memv is None:
                continue
            pods_metric.append(
                PodMetricInfo(
                    namespace=pod.meta.namespace,
                    name=pod.meta.name,
                    pod_usage=ResourceList.of(
                        cpu=int((cpu or 0.0) * 1000), memory=int(memv or 0)
                    ),
                    priority_class=pod.priority_class,
                )
            )
        nm = opts.store.get(KIND_NODE_METRIC, f"/{opts.node_name}")
        if nm is None:
            nm = NodeMetric(meta=ObjectMeta(name=opts.node_name, namespace=""))
            opts.store.add(KIND_NODE_METRIC, nm)
        nm.update_time = now
        nm.node_metric = info
        nm.pods_metric = pods_metric
        nm.report_interval_seconds = opts.report_interval
        nm.aggregate_durations = list(opts.aggregate_windows)
        opts.store.update(KIND_NODE_METRIC, nm)
        return nm


class NodeTopoInformer(InformerPlugin):
    name = "nodeTopoInformer"

    def setup(self, opts: PluginOption, state: PluginState) -> None:
        self.opts = opts

    def sync_node_topology(self, topo_cr: NodeResourceTopology) -> None:
        topo_cr.meta.name = self.opts.node_name
        topo_cr.meta.namespace = ""
        store = self.opts.store
        existing = store.get(KIND_NODE_TOPOLOGY, f"/{self.opts.node_name}")
        if existing is None:
            store.add(KIND_NODE_TOPOLOGY, topo_cr)
        else:
            store.update(KIND_NODE_TOPOLOGY, topo_cr)


# registry.go:21-28 (+ the linux device reporter, a method there, a plugin here)
DEFAULT_PLUGIN_REGISTRY: Dict[str, Callable[[], InformerPlugin]] = {
    "nodeSLOInformer": NodeSLOInformer,
    "pvcInformer": PVCInformer,
    "nodeTopoInformer": NodeTopoInformer,
    "nodeInformer": NodeInformer,
    "podsInformer": PodsInformer,
    "nodeMetricInformer": NodeMetricInformer,
    "deviceInformer": DeviceInformer,
}


class StatesInformer:
    """Facade over the plugin registry; keeps the original method surface."""

    def __init__(self, store: ObjectStore, node_name: str,
                 cache: mc.MetricCache,
                 report_interval_seconds: int = 60,
                 aggregate_windows=(300, 900, 1800),
                 kubelet_stub: Optional[KubeletStub] = None,
                 kubelet_sync_interval: float = 30.0,
                 pleg: Optional[Pleg] = None,
                 device_collector: Optional[Callable[[], List[DeviceInfo]]] = None,
                 registry: Optional[Dict[str, Callable[[], InformerPlugin]]] = None):
        self.store = store
        self.node_name = node_name
        self.cache = cache
        opts = PluginOption(
            store=store, node_name=node_name, cache=cache,
            report_interval=report_interval_seconds,
            aggregate_windows=tuple(aggregate_windows),
            kubelet_stub=kubelet_stub,
            kubelet_sync_interval=kubelet_sync_interval,
            pleg=pleg, device_collector=device_collector,
        )
        self.state = PluginState()
        self.plugins = self.state.informer_plugins
        # two-phase: instantiate all, then setup all, so plugins can resolve
        # each other through PluginState (states_pods.go:79-86)
        for name, factory in (registry or DEFAULT_PLUGIN_REGISTRY).items():
            plugin = factory()
            plugin.name = name
            self.plugins[name] = plugin
        for plugin in self.plugins.values():
            plugin.setup(opts, self.state)

    def sync(self, now: Optional[float] = None) -> None:
        """One tick of every plugin's loop (states_informer.go Run)."""
        now = time.time() if now is None else now
        for plugin in self.plugins.values():
            plugin.sync(now)

    def has_synced(self) -> bool:
        return all(p.has_synced() for p in self.plugins.values())

    # -- pre-registry surface, delegated -------------------------------------
    def get_node(self) -> Optional[Node]:
        return self.plugins["nodeInformer"].get_node()

    def get_node_slo(self) -> NodeSLO:
        return self.plugins["nodeSLOInformer"].get_node_slo()

    def get_all_pods(self) -> List[Pod]:
        return self.plugins["podsInformer"].get_all_pods()

    def get_pod_by_uid(self, uid: str) -> Optional[Pod]:
        return self.plugins["podsInformer"].get_pod_by_uid(uid)

    def get_volume_name(self, namespace: str, name: str) -> str:
        return self.plugins["pvcInformer"].get_volume_name(namespace, name)

    def register_callback(self, kind: str, fn: Callable) -> None:
        self.state.register_callback(kind, fn)

    def sync_node_metric(self, now: Optional[float] = None) -> Optional[NodeMetric]:
        return self.plugins["nodeMetricInformer"].sync_node_metric(now)

    def sync_node_topology(self, topo_cr: NodeResourceTopology) -> None:
        self.plugins["nodeTopoInformer"].sync_node_topology(topo_cr)
