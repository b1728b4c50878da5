"""DeviceRebalancer: drive the rebalance pass against the shared device
mirror, with the degradation ladder underneath.

The rebalancer is the descheduler-side consumer of the scheduler's
``DeviceSnapshot``: its arrays upload through the SAME reuse/scatter/put
machinery (``upload_fields``) under ``rb_*`` names, so a steady-state
cluster ships only row deltas and the two consumers share one device
mirror. Standalone, the rebalancer owns a private mirror on its device.

Resilience reuses the scheduler's ladder machine
(scheduler/degrade.DegradationLadder). On one card the rungs that
change behaviour here are ``full`` (the pass on the card) and
``host-fallback`` (the host ``LowNodeLoad`` oracle, decision-identical
by the parity gate); there is no mesh, so no ``no-mesh`` rung. As in the
port's Scheduler, the ladder absorbs only device faults
(``degrade.is_device_fault``): any other failure of a pass leaves
``select_victims`` with the ladder untouched, because a broken pass
must not be served by the host oracle.

A mesh (``mesh=`` or ``KOORD_TPU_MESH``) comes with the parallel/ slice
of the port and raises NotImplementedError here.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

import numpy as np

from koordinator_tpu_torch.obs import Tracer
from koordinator_tpu_torch.obs.flight import (
    FLIGHT_SCHEMA_VERSION,
    FlightRecorder,
)
from koordinator_tpu_torch.scheduler.deadline import (
    DeadlineWatchdog,
    DispatchDeadlineExceeded,
    deadline_seconds_from,
)
from koordinator_tpu_torch.scheduler.degrade import (
    LEVEL_HOST_FALLBACK,
    DegradationLadder,
    is_device_fault,
)

logger = logging.getLogger(__name__)


def rebalance_from_env():
    """KOORD_TPU_REBALANCE=on|off|host selects the LowNodeLoad engine:
    "on" (default) runs the device pass (with the host fallback ladder
    underneath), "host" pins the host numpy oracle, "off" disables the
    rebalance pass entirely (the incident kill switch — the
    descheduler's other plugins keep running)."""
    import os

    raw = os.environ.get("KOORD_TPU_REBALANCE", "on").strip().lower()
    if raw in ("", "on", "1", "true", "device"):
        return "on"
    if raw in ("off", "0", "false", "no"):
        return "off"
    if raw == "host":
        return "host"
    logger.warning("KOORD_TPU_REBALANCE=%r unknown; using 'on'", raw)
    return "on"


def _bucket(n: int, lo: int) -> int:
    """Power-of-two pad bucket (>= lo): the pad shapes stay the JAX
    package's, so both packages hand the pass the same arrays."""
    p = lo
    while p < n:
        p *= 2
    return p


class DeviceRebalancer:
    """Owns the rebalance steps, the (possibly shared) device mirror, the
    rebalance ladder, span tree, metrics and flight ring.

    ``device`` is the torch device the pass runs on ("cuda" unless the
    caller asks for the CPU). ``snapshot_getter`` returns the scheduler's
    live ``DeviceSnapshot`` (it is rebuilt when the scheduler abandons a
    window, so the reference must be read per pass); without one the
    rebalancer owns a private mirror on ``device``."""

    def __init__(self, device="cuda",
                 snapshot_getter: Optional[Callable[[], object]] = None,
                 ladder: Optional[DegradationLadder] = None,
                 promote_after: int = 16,
                 tracer: Optional[Tracer] = None,
                 flight: Optional[FlightRecorder] = None,
                 dispatch_deadline_ms=None,
                 timeline=None,
                 mesh=None) -> None:
        from koordinator_tpu_torch.models.convert import check_device
        from koordinator_tpu_torch.scheduler.cycle import (
            _mesh_requested,
            _refuse,
        )

        if _mesh_requested(mesh):
            _refuse("the mesh-sharded rebalance pass", "parallel/")
        self.device = check_device(device)
        self.snapshot_getter = snapshot_getter
        self.ladder = ladder if ladder is not None else DegradationLadder(
            promote_after=promote_after)
        self.tracer = tracer if tracer is not None else Tracer()
        self.flight = flight if flight is not None else FlightRecorder()
        # koordwatch: the device timeline this pass records its windows
        # into — the SCHEDULER's ring when co-located (the consumers
        # share one device, so they share one timeline and one
        # decision-id sequence), a private ring standalone. Every pass
        # mints a decision id; migration jobs carry it (-> Reservation
        # annotations), joining descheduler decisions to the window.
        if timeline is None:
            # standalone: record into the DESCHEDULER's registry and
            # honor the KOORD_TPU_WATCH kill switch like every other ring
            from koordinator_tpu_torch.descheduler import metrics as dm
            from koordinator_tpu_torch.obs.timeline import (
                DeviceTimeline,
                watch_from_env,
            )

            timeline = DeviceTimeline(
                window_histogram=dm.DEVICE_WINDOW_SECONDS,
                idle_gauge=dm.DEVICE_IDLE_FRACTION,
                enabled=watch_from_env())
        self.timeline = timeline
        self.last_decision_id: Optional[str] = None
        self._steps: Dict[int, object] = {}  # per-node cap -> step
        self._own_snapshot = None
        self._seq = 0
        self._warned_host_only = False
        # the outputs of a pass abandoned by a deadline overrun, kept
        # referenced while the card may still be writing them
        self._abandoned_out = None
        # sim/test failure-injection hook: a callable() invoked at the
        # top of every device-pass window; raising an InjectedFault from
        # it exercises the rebalance ladder like a real device fault
        self.fault_injector = None
        # dispatch deadline: the rebalance pass shares the scheduler's
        # KOORD_TPU_DISPATCH_DEADLINE_MS knob and watchdog discipline —
        # an overrun abandons the pass (the shared mirror's dispatch
        # window stays open so no in-place scatter lands under the slow
        # pass) and walks THIS ladder toward the host oracle.
        self.dispatch_deadline_seconds = deadline_seconds_from(
            dispatch_deadline_ms)
        self.dispatch_watchdog = DeadlineWatchdog(
            self.dispatch_deadline_seconds,
            on_overrun=self._on_deadline_overrun)
        # sim/test latency hook: invoked inside the monitored readback
        self.sync_delay_injector = None
        self.stats = {"device_passes": 0, "host_passes": 0,
                      "candidates": 0, "victims": 0}
        # device faults the ladder absorbed (each a retry or a demotion)
        self.failures = 0

    def _on_deadline_overrun(self, path: str) -> None:
        from koordinator_tpu_torch.scheduler import (
            metrics as scheduler_metrics,
        )

        scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.inc(path=path)
        self.flight.dump("dispatch_deadline")

    # ------------------------------------------------------------------
    @staticmethod
    def _features() -> Dict[str, bool]:
        return {"mesh": False, "waves": False, "explain": False}

    def _snapshot(self):
        """The device mirror for this pass: the scheduler's shared mirror
        when co-located, else a private one on this rebalancer's
        device."""
        if self.snapshot_getter is not None:
            shared = self.snapshot_getter()
            if shared is not None:
                return shared
        if self._own_snapshot is None:
            from koordinator_tpu_torch.scheduler.snapshot_cache import (
                DeviceSnapshot,
            )

            self._own_snapshot = DeviceSnapshot(device=self.device)
        return self._own_snapshot

    def _get_step(self, cap: int):
        # no compile to record: the JAX package's warm-up rung for this
        # pass (record_step_compile) comes with the port's warm-up slice
        step = self._steps.get(cap)
        if step is None:
            from koordinator_tpu_torch.balance.step import (
                build_rebalance_step,
            )

            step = self._steps[cap] = build_rebalance_step(
                cap, device=self.device)
        return step

    # ------------------------------------------------------------------
    # a per-SEGMENT freed total above this bound could make the f32
    # product X = freed * 100 inexact and flip the limb compare near the
    # threshold (balance/step.py module doc): f32 is integer-exact to
    # 2^24, so freed*100 is unconditionally exact below 2^24/100. The
    # per-node sum of ALL movable pod requests upper-bounds any
    # segment's freed prefix.
    _X_EXACT_BOUND = (2 ** 24) // 100

    @staticmethod
    def _device_eligible(view) -> Optional[str]:
        """The device pass's exactness preconditions (module doc of
        balance/step.py). A view outside them is not a fault — it is a
        per-pass demotion to the host oracle, like the fused-wave
        feature demotions."""
        req = view["pod_req"]
        if not req.size:
            return None
        if not np.all(np.floor(req) == req):
            return "non-integer packed request rows"
        n = view["alloc"].shape[0]
        live = view["pod_alive"] & view["pod_movable"] & (
            view["pod_node"] >= 0)
        per_node = np.zeros((n, req.shape[1]), np.float64)
        np.add.at(per_node, view["pod_node"][live],
                  np.abs(req[live], dtype=np.float64))
        if np.any(per_node > DeviceRebalancer._X_EXACT_BOUND):
            return ("per-node request totals exceed the f32 "
                    "freed*100 exactness bound")
        return None

    @staticmethod
    def _prep(view, low_thr: np.ndarray, high_thr: np.ndarray):
        """Pad-bucketed host arrays + the float64 rhs limb split."""
        from koordinator_tpu_torch.balance.step import split_rhs_limbs

        n = view["alloc"].shape[0]
        p = view["pod_node"].shape[0]
        n_pad = _bucket(n, 8)
        p_pad = _bucket(p, 64)
        usage = np.zeros((n_pad, view["usage_pct"].shape[1]), np.float32)
        usage[:n] = view["usage_pct"]
        has_metric = np.zeros(n_pad, bool)
        has_metric[:n] = view["has_metric"]
        rhs_hi, rhs_lo = split_rhs_limbs(
            view["usage_pct"], view["alloc"], high_thr)
        hi = np.zeros_like(usage)
        hi[:n] = rhs_hi
        lo = np.zeros_like(usage)
        lo[:n] = rhs_lo
        pod_node = np.full(p_pad, -1, np.int32)
        pod_node[:p] = view["pod_node"].astype(np.int32)
        pod_prio = np.zeros(p_pad, np.int32)
        pod_prio[:p] = view["pod_prio"].astype(np.int32)
        pod_cpu = np.zeros(p_pad, np.float32)
        pod_cpu[:p] = view["pod_cpu"]
        pod_req = np.zeros((p_pad, view["pod_req"].shape[1]), np.int32)
        pod_req[:p] = view["pod_req"].astype(np.int32)
        pod_ok = np.zeros(p_pad, bool)
        pod_ok[:p] = view["pod_alive"] & view["pod_movable"]
        return {
            "rb_usage_pct": usage, "rb_has_metric": has_metric,
            "rb_low_thr": low_thr, "rb_high_thr": high_thr,
            "rb_rhs_hi": hi, "rb_rhs_lo": lo,
            "rb_pod_node": pod_node, "rb_pod_prio": pod_prio,
            "rb_pod_cpu": pod_cpu, "rb_pod_req": pod_req,
            "rb_pod_ok": pod_ok,
        }

    # ------------------------------------------------------------------
    def select_victims(self, plugin, view, now: float):
        """One rebalance pass over the packed view. Returns
        (picked slot indices, stats dict) — decision-identical to the
        host oracle ``plugin.select_victims_host`` (the parity gate
        pins it); the ladder demotes to that oracle on device faults."""
        t0 = time.perf_counter()
        self._seq += 1
        self.ladder.begin_pass()
        # koordwatch: one decision id per pass (device OR host — jobs
        # need the join either way); the timeline window records only
        # completed device passes
        win = self.timeline.open("rebalance", "serial")
        self.last_decision_id = win.decision_id
        reason = self._device_eligible(view)
        if reason is not None:
            if not self._warned_host_only:
                logger.warning("rebalance device pass ineligible (%s); "
                               "using the host oracle", reason)
                self._warned_host_only = True
            return self._host_pass(plugin, view, now, t0,
                                   engine="host-ineligible")
        attempts = 0
        had_deadline = False
        level0 = self.ladder.level
        while True:
            if self.ladder.level >= LEVEL_HOST_FALLBACK:
                return self._host_pass(plugin, view, now, t0)
            try:
                picked, stats = self._device_pass(plugin, view, win)
            except Exception as exc:
                if not is_device_fault(exc):
                    raise
                attempts += 1
                self.failures += 1
                if isinstance(exc, DispatchDeadlineExceeded):
                    had_deadline = True
                action = self.ladder.on_failure(
                    self._features(),
                    error=f"{type(exc).__name__}: {exc}")
                if action == "exhausted":
                    # cannot happen above the host rung (it always
                    # changes behavior); defensive parity with the
                    # scheduler's wrapper
                    raise
                logger.warning(
                    "rebalance device pass failed (%s: %s); %s at "
                    "ladder level %s", type(exc).__name__, exc, action,
                    self.ladder.level_name)
                continue
            outcome = ("deadline" if had_deadline
                       else "demoted" if self.ladder.level > level0
                       else "retried" if attempts else "clean")
            self.timeline.close(win, outcome)
            self._record(now, t0, stats)
            self.ladder.note_cycle()
            return picked, stats

    def _host_pass(self, plugin, view, now: float, t0: float,
                   engine: str = "host"):
        with self.tracer.span("score", host="1"):
            picked = plugin.select_victims_host(view)
        stats = {"engine": engine,
                 "candidates": int(plugin.last_pass_stats.get(
                     "candidates", 0)),
                 "victims": int(picked.size),
                 "decision_id": self.last_decision_id,
                 "ladder_level": self.ladder.level_name}
        self.stats["host_passes"] += 1
        self.stats["candidates"] += stats["candidates"]
        self.stats["victims"] += stats["victims"]
        self._record(now, t0, stats)
        self.ladder.note_cycle()
        return picked, stats

    def _device_pass(self, plugin, view, win):
        if self.fault_injector is not None:
            self.fault_injector()
        with self.tracer.span("classify") as csp:
            low_thr = plugin._thr_vec(plugin.args.low_thresholds)
            high_thr = plugin._thr_vec(plugin.args.high_thresholds)
            fields = self._prep(view, low_thr, high_thr)
            csp.attributes["nodes"] = str(view["alloc"].shape[0])
            csp.attributes["pods"] = str(view["pod_node"].shape[0])
        step = self._get_step(int(plugin.args.max_pods_to_evict_per_node))
        snap = self._snapshot()
        n = view["alloc"].shape[0]

        def sync_readback():
            # the rebalance pass's designated sync point, run under the
            # dispatch-deadline watchdog — route new syncs through here
            # (koordlint naked-device-sync-without-deadline). A watchdog
            # worker thread starts on device 0: set the pass's first.
            import torch

            if self.sync_delay_injector is not None:
                self.sync_delay_injector()
            if out.sel_count.is_cuda:
                torch.cuda.set_device(out.sel_count.device)
            sel_count = int(out.sel_count.item())
            return (sel_count, int(out.cand_count.item()),
                    out.sel_pod[:sel_count].cpu().numpy(),
                    out.sel_node[:sel_count].cpu().numpy(),
                    out.sel_score[:sel_count].cpu().numpy(),
                    out.is_low[:n].cpu().numpy(),
                    out.is_high[:n].cpu().numpy(),
                    out.margin[:n].cpu().numpy())

        snap.begin_dispatch()
        win.mark_dispatch("serial")
        abandoned = False
        try:
            with self.tracer.span("score", decision_id=win.decision_id):
                dev = snap.upload_fields(fields)
                out = step(dev["rb_usage_pct"], dev["rb_has_metric"],
                           dev["rb_low_thr"], dev["rb_high_thr"],
                           dev["rb_rhs_hi"], dev["rb_rhs_lo"],
                           dev["rb_pod_node"], dev["rb_pod_prio"],
                           dev["rb_pod_cpu"], dev["rb_pod_req"],
                           dev["rb_pod_ok"])
            with self.tracer.span("readback"):
                try:
                    (sel_count, cand_count, sel_pod, sel_node, sel_score,
                     is_low, is_high, margin) = self.dispatch_watchdog.run(
                        sync_readback, "rebalance")
                except DispatchDeadlineExceeded:
                    # slow-not-dead device: abandon the pass. Its outputs
                    # stay referenced while the card may still write
                    # them; the dispatch window stays OPEN on this mirror
                    # (the scheduler's shared mirror scatters into clones
                    # until its own next rebuild), and a privately owned
                    # mirror is dropped so the next pass re-uploads
                    # through a fresh one.
                    abandoned = True
                    self._abandoned_out = out
                    if snap is self._own_snapshot:
                        self._own_snapshot = None
                    raise
        finally:
            if not abandoned:
                snap.end_dispatch()
        picked = sel_pod.astype(np.int64)
        stats = {"engine": "device", "candidates": cand_count,
                 "victims": sel_count,
                 "is_low": is_low, "is_high": is_high, "margin": margin,
                 "victim_nodes": sel_node, "victim_scores": sel_score,
                 "decision_id": win.decision_id,
                 "ladder_level": self.ladder.level_name}
        self.stats["device_passes"] += 1
        self.stats["candidates"] += cand_count
        self.stats["victims"] += sel_count
        return picked, stats

    def _record(self, now: float, t0: float, stats: dict) -> None:
        """One pass record into the flight ring (valid ``cycle`` record
        per obs/flight.py's schema, so rebalance dumps replay through
        the same tooling) + the pass metrics."""
        from koordinator_tpu_torch.descheduler import metrics as dm

        duration = time.perf_counter() - t0
        dm.REBALANCE_PASS_SECONDS.observe(duration)
        if stats.get("candidates"):
            dm.REBALANCE_CANDIDATES.inc(stats["candidates"])
        if stats.get("victims"):
            dm.REBALANCE_VICTIMS.inc(stats["victims"])
        self.flight.record_cycle({
            "v": FLIGHT_SCHEMA_VERSION,
            "kind": "cycle",
            "seq": self._seq,
            "ts": float(now),
            "duration_ms": duration * 1000.0,
            "waves": 0,
            "bound": [], "failed": [], "rejected": [], "preempted": [],
            # koordwatch: joins this pass to its timeline window and to
            # the migration jobs it issued
            "decision_id": str(stats.get("decision_id") or ""),
            "metrics": {
                "rebalance_candidates": float(stats.get("candidates", 0)),
                "rebalance_victims": float(stats.get("victims", 0)),
                "rebalance_device": float(stats.get("engine") == "device"),
            },
            "spans": [],
        })
