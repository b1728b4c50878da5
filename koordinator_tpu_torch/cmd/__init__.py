"""Binary entrypoints — the analog of the reference's cmd/ tree.

The reference ships five cooperating binaries (koord-scheduler,
koord-descheduler, koord-manager, koordlet, koord-runtime-proxy), and the
rebuild adds a sixth, the scheduling sidecar. The port has the scheduler,
the sidecar, the descheduler and the manager so far; each module here is a
thin CLI over the corresponding library runner, launchable as

    python -m koordinator_tpu_torch.cmd.koord_scheduler --synth 50x200
    python -m koordinator_tpu_torch.cmd.koord_sidecar --listen unix:///tmp/s.sock
    python -m koordinator_tpu_torch.cmd.koord_descheduler --synth 50x200
    python -m koordinator_tpu_torch.cmd.koord_manager --synth 50x200

A copy of the JAX package's cmd/__init__.py. Cluster state comes from
`--state cluster.json` (the minimal schema below) or `--synth NxP` (N
nodes, P pods via the synthetic generator). The store is in-process — the
reference's cross-binary bus is the Kubernetes API server, whose analog
here is `client.store.ObjectStore`.

state JSON schema (all fields optional):
  {"nodes": [{"name", "cpu": milli, "memory": bytes, "pods": n,
              "labels": {..}}],
   "pods":  [{"name", "namespace", "cpu": milli, "memory": bytes,
              "priority": n, "labels": {..}, "node": bound-node-or-absent}],
   "node_metrics": [{"node", "cpu": milli, "memory": bytes}]}
"""

from __future__ import annotations

import json
import signal
import sys
import threading
import time
from typing import Callable, Optional


def add_cluster_flags(ap) -> None:
    ap.add_argument("--state", help="cluster state JSON file (see schema)")
    ap.add_argument(
        "--synth", metavar="NxP",
        help="synthetic cluster: N nodes x P pending pods")


def add_device_flag(ap) -> None:
    """--device: where the binary's device passes run, "cuda" (the
    default; the card's kernels) or "cpu" (the plain versions, as the
    tests run them)."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the device passes run (default cuda)")


def add_loop_flags(ap, default_interval: float) -> None:
    ap.add_argument("--interval", type=float, default=default_interval,
                    help="seconds between loop ticks")
    ap.add_argument("--max-ticks", type=int, default=0,
                    help="stop after this many ticks (0 = run until signal)")


def serve_obs(port: int, metrics_registry, name: str, tracer=None,
              health_provider=None, explain_provider=None, flight=None,
              timeline=None, slo=None):
    """`--obs-port` wiring shared by the binaries: serve /metrics (and
    /traces when a tracer is given, plus the koordexplain surfaces when
    providers are given, plus the koordwatch /debug/timeline and
    /debug/slo bundles) via obs.server.ObsServer and announce the bound
    address. Returns the live server, or None when port is 0; the caller
    shuts it down after its tick loop ends."""
    if not port:
        return None
    from koordinator_tpu_torch.obs.server import ObsServer

    server, _thread = ObsServer(
        metrics_registry, tracer, health_provider=health_provider,
        explain_provider=explain_provider, flight=flight,
        timeline=timeline, slo=slo).serve(port)
    routes = "/metrics + /traces" if tracer is not None else "/metrics"
    if explain_provider is not None:
        routes += " + /explain"
    if flight is not None:
        routes += " + /debug/flightrecorder"
    if timeline is not None:
        routes += " + /debug/timeline"
    if slo is not None:
        routes += " + /debug/slo"
    print(f"{name}: {routes} on 127.0.0.1:{server.server_address[1]}",
          file=sys.stderr)
    return server


def parse_feature_gates(gate_obj, spec: Optional[str]) -> None:
    """--feature-gates Gate1=true,Gate2=false (component main.go flag)."""
    if not spec:
        return
    values = {}
    for item in spec.split(","):
        if not item:
            continue
        name, _, raw = item.partition("=")
        values[name.strip()] = raw.strip().lower() in ("1", "true", "yes", "")
    gate_obj.set_from_map(values)


def build_store(args):
    """ObjectStore from --state / --synth (empty store otherwise)."""
    from koordinator_tpu_torch.api.objects import (
        Node,
        NodeMetric,
        NodeMetricInfo,
        ObjectMeta,
        Pod,
        PodSpec,
    )
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import (
        KIND_NODE,
        KIND_NODE_METRIC,
        KIND_POD,
        ObjectStore,
    )

    store = ObjectStore()
    if getattr(args, "synth", None):
        n_s, p_s = args.synth.lower().split("x")
        _populate_synth(store, int(n_s), int(p_s))
        return store
    if not getattr(args, "state", None):
        return store
    with open(args.state) as f:
        spec = json.load(f)
    now = time.time()
    for n in spec.get("nodes", []):
        node = Node(
            meta=ObjectMeta(name=n["name"], namespace="",
                            labels=dict(n.get("labels", {}))),
            allocatable=ResourceList.of(
                cpu=int(n.get("cpu", 4000)),
                memory=int(n.get("memory", 16 * 1024**3)),
                pods=int(n.get("pods", 110))),
        )
        store.add(KIND_NODE, node)
    for p in spec.get("pods", []):
        ns = p.get("namespace", "default")
        pod = Pod(
            meta=ObjectMeta(name=p["name"],
                            namespace=ns,
                            # uid must be cluster-unique: same-named pods in
                            # two namespaces would otherwise share cgroup
                            # paths and informer entries
                            uid=f"{ns}/{p['name']}",
                            labels=dict(p.get("labels", {})),
                            creation_timestamp=now),
            spec=PodSpec(
                priority=p.get("priority"),
                requests=ResourceList.of(
                    cpu=int(p.get("cpu", 1000)),
                    memory=int(p.get("memory", 1024**3)))),
        )
        if p.get("node"):
            pod.spec.node_name = p["node"]
            pod.phase = "Running"
        store.add(KIND_POD, pod)
    for m in spec.get("node_metrics", []):
        store.add(KIND_NODE_METRIC, NodeMetric(
            meta=ObjectMeta(name=m["node"], namespace=""),
            update_time=now,
            node_metric=NodeMetricInfo(node_usage=ResourceList.of(
                cpu=int(m.get("cpu", 0)), memory=int(m.get("memory", 0)))),
        ))
    return store


def _populate_synth(store, num_nodes: int, num_pods: int) -> None:
    from koordinator_tpu_torch.client.store import (
        KIND_NODE,
        KIND_NODE_METRIC,
        KIND_POD,
    )
    from koordinator_tpu_torch.testing import synth_full_cluster

    _cluster, state = synth_full_cluster(num_nodes, num_pods, seed=0)
    for node in state.nodes:
        store.add(KIND_NODE, node)
    for nm in state.node_metrics.values():
        store.add(KIND_NODE_METRIC, nm)
    for pod in state.pods_by_key.values():
        store.add(KIND_POD, pod)
    for pod in state.pending_pods:
        if store.get(KIND_POD, pod.meta.key) is None:
            store.add(KIND_POD, pod)


def run_ticks(tick: Callable[[], object], interval: float, max_ticks: int,
              name: str) -> int:
    """The shared serve loop: tick, sleep, repeat; SIGTERM/SIGINT stop it
    cleanly (the reference binaries' context-cancellation analog)."""
    stop = threading.Event()

    def _handler(_sig, _frame):
        print(f"{name}: signal received, stopping", file=sys.stderr)
        stop.set()

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _handler)
        except ValueError:  # non-main thread (tests)
            pass
    ticks = 0
    try:
        while not stop.is_set():
            tick()
            ticks += 1
            if max_ticks and ticks >= max_ticks:
                break
            stop.wait(interval)
    finally:
        # restore: an embedding process (pytest, the demo) must keep its
        # own Ctrl-C behavior once the loop is done
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return ticks
