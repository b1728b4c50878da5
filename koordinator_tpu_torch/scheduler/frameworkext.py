"""Framework extension engine: the host-side orchestration around the kernels.

Analog of reference `pkg/scheduler/frameworkext/` (SURVEY.md section 2.2): the
extender owns the plugin registry, runs the scheduling cycle (snapshot -> fused
kernel -> host Reserve/PreBind/Bind), dispatches store events to plugin caches,
and provides the monitor/debug surfaces (scheduler_monitor.go, debug.go).

The kube-scheduler extension points map as:
  PreFilter/Filter/Score -> fused into the batched kernel (models/full_chain.py)
  Reserve/Unreserve      -> host plugin hooks (cpuset take, device pick,
                            reservation consume) run per actual binding
  PreBind                -> accumulated object patches applied once
                            (defaultprebind semantics, frameworkext/interface.go:194)
  Bind                   -> store update of pod.spec.node_name
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from koordinator_tpu_torch.api.objects import Pod
from koordinator_tpu_torch.client.store import ObjectStore


@dataclass
class BindResult:
    pod_key: str
    node_name: str
    annotations: Dict[str, str] = field(default_factory=dict)


@dataclass
class CycleResult:
    bound: List[BindResult] = field(default_factory=list)
    failed: List[str] = field(default_factory=list)      # pod keys left pending
    rejected: List[str] = field(default_factory=list)    # struck by permit/quota
    preempted_victims: List[str] = field(default_factory=list)  # quota PostFilter
    resized: List[str] = field(default_factory=list)     # in-place resizes applied
    resize_pending: List[str] = field(default_factory=list)  # resize didn't fit
    duration_seconds: float = 0.0
    kernel_seconds: float = 0.0
    # wall spent between kernel dispatch and readback completion (the
    # window where the device has work queued; upper bound when overlapped
    # host work outlasts the kernel) — feeds the pipeline occupancy number
    device_busy_seconds: float = 0.0
    skipped_not_leader: bool = False  # election-gated replica in standby
    # logical scheduling rounds this cycle consumed: 1 on the serial path,
    # up to K on a fused multi-wave dispatch (models/fused_waves.py). A
    # fused cycle truncated by a Reserve veto or a preemption retry
    # reports the rounds it actually completed, so a driver replaying a
    # K-round budget knows how much remains.
    waves: int = 1
    # koordwatch demotion accounting: the structured reasons this cycle
    # ran below its configured wave/explain/mesh level (deduped per
    # cycle, in first-hit order; empty = no demotion). Every entry also
    # incremented koord_scheduler_wave_demotions_total{reason} and rides
    # the cycle's flight record — the sim aggregates these into the
    # per-scenario demotion profile.
    demotions: List[str] = field(default_factory=list)
    # koordwatch decision correlation: the decision ids of the device
    # windows this cycle opened (obs/timeline.py), joinable against
    # kernel spans, timeline windows and flight records
    decision_ids: List[str] = field(default_factory=list)


class Plugin:
    """Host-side plugin base. Kernels consume arrays the plugins contribute via
    the snapshot builder; these hooks cover cache maintenance + per-binding
    effects."""

    name = "plugin"

    def register(self, store: ObjectStore) -> None:
        """Subscribe to store events to maintain caches."""

    def reserve(self, pod: Pod, node_name: str, ctx: "CycleContext") -> Optional[str]:
        """Claim host-side resources for a tentative binding. Return an error
        string to veto (triggers unreserve of earlier plugins)."""
        return None

    def unreserve(self, pod: Pod, node_name: str, ctx: "CycleContext") -> None:
        """Roll back reserve."""

    def pre_bind(self, pod: Pod, node_name: str, ctx: "CycleContext",
                 annotations: Dict[str, str]) -> None:
        """Contribute annotations/patches to the single PreBind patch."""


@dataclass
class CycleContext:
    """Per-cycle scratch shared by plugins (cycleState analog)."""

    now: float
    data: Dict[str, Any] = field(default_factory=dict)


class SchedulingTransformer:
    """Declared view-transform extension point (frameworkext/interface.go:78-97).

    The reference runs Before/After hooks per (pod, node) inside the Go
    framework; in the batched architecture the same power lives at the three
    places a view exists on host:

      * ``PreFilterTransformer.before_prefilter`` — rewrite one pending pod's
        view before it is packed (BeforePreFilter: return a replacement, never
        mutate the stored object)
      * ``PreFilterTransformer.after_prefilter`` / ``FilterTransformer.
        before_filter`` — rewrite the assembled ClusterState (the batched
        nodeInfo view) before packing
      * ``ScoreTransformer.before_score`` — rewrite the packed
        FullChainInputs before the kernel launches (BeforeScore over all
        nodes at once).
    """

    name = "transformer"


class PreFilterTransformer(SchedulingTransformer):
    def before_prefilter(self, pod: Pod, ctx: "CycleContext") -> Optional[Pod]:
        """Return a replacement pod view for this cycle, or None to keep."""
        return None

    def after_prefilter(self, state, ctx: "CycleContext") -> None:
        """Adjust the assembled ClusterState after per-pod transforms ran."""
        return None


class FilterTransformer(SchedulingTransformer):
    def before_filter(self, state, ctx: "CycleContext") -> None:
        """Rewrite node-side views (assigned_requests, topologies, ...)."""
        return None


class ScoreTransformer(SchedulingTransformer):
    def before_score(self, inputs, ctx: "CycleContext"):
        """Return replacement FullChainInputs, or None to keep."""
        return None

    # device-expressible protocol: a ScoreTransformer whose rewrite
    # can run INSIDE the fused wave kernel sets ``device_pass`` (see
    # DeviceScoreTransformer); transformers without it force the fused
    # dispatch down to the exact serial path (the
    # ``non-expressible-transformer`` demotion).
    device_pass = None


class DeviceScoreTransformer(ScoreTransformer):
    """A ScoreTransformer expressible as a pure tensor pass — the shape
    the fused wave kernel can carry (models/fused_waves.py).

    Implement ``device_pass(inputs) -> inputs``: a pure, cycle-independent
    torch rewrite of the packed FullChainInputs (models/full_chain.py,
    tensors). Contract:

      * SCORE-side fields only (la_term_nonprod / la_term_prod,
        pref_scores, img_scores, ppref_w, base.weights ...): the kept-
        only replay commits through the UNtransformed inputs, so a
        filter/commit-side rewrite would desynchronize carried state.
      * pure + trace-stable: the pass is compiled INTO the wave program
        and re-applied to every wave's rebuilt inputs. Parameter changes
        must bump ``device_epoch`` (a step-cache key component) or a
        cached program keeps the old constants.
      * elementwise/gather torch ops only for bit-stability: the host
        ``before_score`` (which the SERIAL path still runs) applies the
        SAME function, so the two paths produce identical floats.

    The default ``before_score`` hands ``device_pass`` the host batch as
    CPU tensors (models/convert.to_device) and materializes the result
    back to numpy, keeping the serial path's packed batch a plain host
    array set."""

    device_epoch = 0

    def device_pass(self, inputs):  # pragma: no cover - interface
        raise NotImplementedError

    def before_score(self, inputs, ctx: "CycleContext"):
        from koordinator_tpu_torch.models.convert import to_device

        out = self.device_pass(to_device(inputs, "cpu"))
        if out is None:
            return None
        base = type(out.base)(*(t.cpu().numpy() for t in out.base))
        return type(out)(base, *(t.cpu().numpy() for t in out[1:]))


class SchedulerMonitor:
    """Slow/stuck cycle watchdog (frameworkext/scheduler_monitor.go:44-108).
    History is a bounded window; totals are running counters so a long-running
    scheduler never grows unbounded."""

    def __init__(self, timeout_seconds: float = 10.0, history_size: int = 512):
        from collections import deque

        self.timeout = timeout_seconds
        self.history = deque(maxlen=history_size)
        self.total_cycles = 0
        self._slow_cycles = 0

    def record(self, result: CycleResult) -> None:
        slow = result.duration_seconds > self.timeout
        self.total_cycles += 1
        self._slow_cycles += int(slow)
        self.history.append(
            {
                "duration": result.duration_seconds,
                "kernel": result.kernel_seconds,
                "bound": float(len(result.bound)),
                "slow": float(slow),
            }
        )

    @property
    def slow_cycles(self) -> int:
        return self._slow_cycles


class ErrorHandlerDispatcher:
    """Scheduling-failure dispatch chain (frameworkext/errorhandler_dispatcher.go):
    pre-handlers run in registration order until one consumes the failure;
    unconsumed failures fall through to the default handler (requeue)."""

    def __init__(self, history_size: int = 1024) -> None:
        from collections import deque

        self._handlers: List[Callable[[Pod, str], bool]] = []
        self.default_handler: Optional[Callable[[Pod, str], None]] = None
        # bounded (pod_key, reason) audit trail: permanently-pending pods
        # dispatch every cycle, so an unbounded list would leak
        self.failures = deque(maxlen=history_size)

    def register(self, handler: Callable[[Pod, str], bool]) -> None:
        self._handlers.append(handler)

    def dispatch(self, pod: Pod, reason: str) -> None:
        self.failures.append((pod.meta.key, reason))
        for handler in self._handlers:
            if handler(pod, reason):
                return
        if self.default_handler is not None:
            self.default_handler(pod, reason)


class ServicesEngine:
    """Per-plugin debug/API endpoints (frameworkext/services/services.go:44-53):
    plugins expose callables under /apis/v1/plugins/<plugin>/<endpoint>, and
    /apis/v1/nodes/<name> dumps a node's scheduling view. `handle(path)` is the
    routing core; `serve()` wraps it in a ThreadingHTTPServer for live use."""

    def __init__(self, extender: "FrameworkExtender"):
        self.extender = extender

    def handle(self, path: str) -> Any:
        parts = [p for p in path.split("/") if p]
        if parts[:2] != ["apis", "v1"]:
            raise KeyError(f"unknown path {path!r}")
        if len(parts) == 4 and parts[2] == "nodes":
            return self._dump_node(parts[3])
        if len(parts) >= 5 and parts[2] == "plugins":
            plugin = self.extender.plugin(parts[3])
            if plugin is None:
                raise KeyError(f"unknown plugin {parts[3]!r}")
            services = getattr(plugin, "services", None)
            endpoints = services() if callable(services) else {}
            if parts[4] not in endpoints:
                raise KeyError(f"plugin {parts[3]!r} has no endpoint {parts[4]!r}")
            return endpoints[parts[4]]()
        raise KeyError(f"unknown path {path!r}")

    def _dump_node(self, name: str) -> Dict[str, Any]:
        from koordinator_tpu_torch.client.store import KIND_NODE, KIND_POD

        node = self.extender.store.get(KIND_NODE, f"/{name}")
        if node is None:
            raise KeyError(f"unknown node {name!r}")
        pods = [
            p.meta.key
            for p in self.extender.store.list(KIND_POD)
            if p.spec.node_name == name and not p.is_terminated
        ]
        return {
            "name": name,
            "allocatable": dict(node.allocatable.quantities),
            "pods": sorted(pods),
        }

    def serve(self, port: int = 0):
        """Start an HTTP server exposing handle(); returns (server, thread)."""
        import json
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        engine = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                try:
                    route = self.path.split("?", 1)[0]
                    payload = json.dumps(engine.handle(route)).encode()
                    self.send_response(200)
                except KeyError as e:
                    payload = json.dumps({"error": str(e)}).encode()
                    self.send_response(404)
                except Exception as e:  # debug surface must answer, not drop
                    payload = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):  # silence per-request stderr noise
                pass

        server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, thread


class FrameworkExtender:
    """Plugin registry + event fan-out (framework_extender_factory.go analog)."""

    def __init__(self, store: ObjectStore):
        self.store = store
        self.plugins: List[Plugin] = []
        self.transformers: List[SchedulingTransformer] = []
        self.monitor = SchedulerMonitor()
        self.error_handlers = ErrorHandlerDispatcher()
        self.services = ServicesEngine(self)
        self._debug_top_n = 0

    def register_plugin(self, plugin: Plugin) -> None:
        self.plugins.append(plugin)
        plugin.register(self.store)

    def register_transformer(self, transformer: SchedulingTransformer) -> None:
        """Transformers run in registration order at each stage
        (framework_extender.go runTransformers)."""
        self.transformers.append(transformer)

    # -- transformer dispatch (interface.go:78-97) ---------------------------
    def transform_before_prefilter(self, pods: List[Pod],
                                   ctx: CycleContext) -> List[Pod]:
        if not self.transformers:
            return pods
        out = []
        for pod in pods:
            for t in self.transformers:
                if isinstance(t, PreFilterTransformer):
                    replaced = t.before_prefilter(pod, ctx)
                    if replaced is not None:
                        pod = replaced
            out.append(pod)
        return out

    def transform_after_prefilter(self, state, ctx: CycleContext) -> None:
        for t in self.transformers:
            if isinstance(t, PreFilterTransformer):
                t.after_prefilter(state, ctx)

    def transform_before_filter(self, state, ctx: CycleContext) -> None:
        for t in self.transformers:
            if isinstance(t, FilterTransformer):
                t.before_filter(state, ctx)

    def transform_before_score(self, inputs, ctx: CycleContext):
        for t in self.transformers:
            if isinstance(t, ScoreTransformer):
                replaced = t.before_score(inputs, ctx)
                if replaced is not None:
                    inputs = replaced
        return inputs

    def plugin(self, name: str) -> Optional[Plugin]:
        for p in self.plugins:
            if p.name == name:
                return p
        return None

    # debug.go analog: runtime-settable top-N score dump
    def set_debug_top_n(self, n: int) -> None:
        self._debug_top_n = n

    def debug_scores(self, score_row: np.ndarray, node_names: List[str]) -> List[str]:
        if self._debug_top_n <= 0:
            return []
        order = np.argsort(-score_row)[: self._debug_top_n]
        return [
            f"{node_names[i]}={score_row[i]:.0f}"
            for i in order
            if i < len(node_names)
        ]
