"""DeviceColoReconciler: drive the colo pass against the shared device
mirror, with the degradation ladder underneath.

The reconciler is the koord-manager-side consumer of the scheduler's
``DeviceSnapshot`` — the third, after the dispatch kernels and the
descheduler's rebalance pass: its arrays upload through the SAME
reuse/scatter/put machinery (``upload_fields``) under ``colo_*`` names,
so a steady-state cluster ships only row deltas and the three consumers
share one device mirror. Standalone, the reconciler owns a private
mirror on its device.

The colocation loop closes on the card: the batch/mid writeback goes
through the host oracle's OWN ``NodeResourceController.apply`` (so the
store-visible effect is engine-independent by construction) and the
VERY NEXT scheduling dispatch packs the new allocatable. The quota
runtime fold runs against the PREDICTED post-writeback cluster total
(the pass knows its own batch/mid integers); the prediction is verified
against the store after the writeback and the published device runtime
is dropped on any mismatch (the plugin-chain edge: a Device CR write in
the same pass), falling back to the epoch-memoized host fold.

A pass whose quota view lies outside the device fold's exactness
envelope (``_device_eligible``) runs on the host oracle as
``engine="host-ineligible"``: that is the JAX package's own behaviour,
with its reason strings, not a fallback; ``stats["ineligible_passes"]``
counts it.

Departures from the JAX package's reconciler, as in the port's
``DeviceRebalancer``:

  * the ladder absorbs only device faults (``degrade.is_device_fault``):
    any other failure of a pass leaves ``reconcile`` with the ladder
    untouched, because a broken pass must not be served by the host
    oracle. The rungs that change behaviour are ``full`` (the pass on
    the card; sharded under a mesh) -> ``no-mesh`` (the single-device
    pass, skipped when no mesh is configured) -> ``host-fallback`` (the
    retained host oracles: NodeResourceController +
    compute_runtime_quotas).

With a mesh (``mesh=``: the co-located scheduler's configured mesh, or
KOORD_TPU_MESH standalone) the ``colo_*`` node fields shard over it and
the pass runs per shard (parallel/colo_mesh.py), its outputs replicated.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.api.resources import RESOURCE_INDEX, ResourceName
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
    LEVEL_NO_MESH,
    DegradationLadder,
    is_device_fault,
)

logger = logging.getLogger(__name__)

# names of the node-axis upload fields in the device mirror
COLO_NODE_FIELDS = (
    "colo_capacity", "colo_node_reserved", "colo_system_reserved",
    "colo_node_used", "colo_pod_all_used", "colo_hp_used",
    "colo_hp_request", "colo_hp_max", "colo_prod_reclaimable",
    "colo_reclaim_pct", "colo_mid_pct", "colo_degraded",
)

BATCH_CPU_AXIS = RESOURCE_INDEX[ResourceName.BATCH_CPU]
BATCH_MEM_AXIS = RESOURCE_INDEX[ResourceName.BATCH_MEMORY]
MID_CPU_AXIS = RESOURCE_INDEX[ResourceName.MID_CPU]
MID_MEM_AXIS = RESOURCE_INDEX[ResourceName.MID_MEMORY]
_OVERCOMMIT_AXES = (BATCH_CPU_AXIS, BATCH_MEM_AXIS,
                    MID_CPU_AXIS, MID_MEM_AXIS)

# f32 integer-exact envelope for the quota fold (colo/step.py module
# doc): segment sums and the cluster total must stay below 2^24 for the
# device fold's order-free arithmetic to equal the host's
_F32_EXACT_BOUND = float(2 ** 24)


def colo_from_env() -> str:
    """KOORD_TPU_COLO=on|off|host selects the control-plane engine:
    "on" (default) runs the device colo pass (with the host-oracle
    fallback ladder underneath), "host" pins the host reconcilers with
    the colo surfaces (metrics/spans/flight) kept, "off" detaches the
    colo subsystem entirely — the legacy per-controller reconciles run
    exactly as before (the incident kill switch)."""
    import os

    raw = os.environ.get("KOORD_TPU_COLO", "on").strip().lower()
    if raw in ("", "on", "1", "true", "device"):
        return "on"
    if raw in ("off", "0", "false", "no"):
        return "off"
    if raw == "host":
        return "host"
    logger.warning("KOORD_TPU_COLO=%r unknown; using 'on'", raw)
    return "on"


def _bucket(n: int, lo: int) -> int:
    """Power-of-two pad bucket (>= lo): the pad shapes stay the JAX
    package's, so both packages hand the pass the same arrays."""
    p = lo
    while p < n:
        p *= 2
    return p


class DeviceColoReconciler:
    """Owns the colo steps, the (possibly shared) device mirror, the colo
    ladder, span tree, metrics and flight ring.

    ``controller`` is the host-oracle NodeResourceController (writeback
    + host fallback), ``quota_plugin`` the (scheduler-shared)
    ElasticQuotaPlugin, ``pack`` the ColoPack. ``device`` is the torch
    device the pass runs on ("cuda" unless the caller asks for the CPU).
    ``snapshot_getter`` returns the scheduler's live DeviceSnapshot (it
    is rebuilt when the scheduler abandons a window, so the reference is
    read per pass); without one the reconciler owns a private mirror on
    ``device``."""

    def __init__(self, store, controller, quota_plugin, pack,
                 device="cuda",
                 snapshot_getter: Optional[Callable[[], object]] = None,
                 ladder: Optional[DegradationLadder] = None,
                 promote_after: int = 16,
                 tracer: Optional[Tracer] = None,
                 flight: Optional[FlightRecorder] = None,
                 dispatch_deadline_ms=None,
                 engine: str = "on",
                 timeline=None,
                 mesh=None) -> None:
        from koordinator_tpu_torch.models.convert import check_device
        self.store = store
        self.controller = controller
        self.quota_plugin = quota_plugin
        self.pack = pack
        self.engine = engine  # "on" = device (ladder under it) | "host"
        self.device = check_device(device)
        if isinstance(mesh, (int, str)):
            from koordinator_tpu_torch.scheduler.cycle import resolve_mesh

            mesh = resolve_mesh(mesh, self.device)
        self.mesh = mesh
        self.snapshot_getter = snapshot_getter
        self.ladder = ladder if ladder is not None else DegradationLadder(
            promote_after=promote_after)
        self.tracer = tracer if tracer is not None else Tracer()
        self.flight = flight if flight is not None else FlightRecorder()
        # koordwatch: the device timeline this pass records its windows
        # into — the SCHEDULER's ring when co-located (three consumers,
        # one device, one ring / decision-id sequence), else private.
        # The per-pass decision id lands on last_pass_stats and the
        # flight record; it is deliberately NOT written to the store —
        # the batch/mid writeback must stay engine-independent byte for
        # byte (run_colo_parity pins that).
        if timeline is None:
            # standalone: record into the MANAGER's registry and honor
            # the KOORD_TPU_WATCH kill switch like every other ring
            from koordinator_tpu_torch import manager_metrics as mm
            from koordinator_tpu_torch.obs.timeline import (
                DeviceTimeline,
                watch_from_env,
            )

            timeline = DeviceTimeline(
                window_histogram=mm.DEVICE_WINDOW_SECONDS,
                idle_gauge=mm.DEVICE_IDLE_FRACTION,
                enabled=watch_from_env())
        self.timeline = timeline
        self.last_decision_id: Optional[str] = None
        # policies (under a mesh: with the mesh's tag) -> step
        self._steps: Dict[Tuple, object] = {}
        # whether the last _get_step built the step (a warm-up rung)
        self._last_step_compiled = False
        self._own_snapshot = None
        self._own_mesh_snapshot = None
        self._seq = 0
        self._warned_host_only = False
        # the outputs of a pass abandoned by a deadline overrun, kept
        # referenced while the card may still be writing them
        self._abandoned_out = None
        # sim/test failure-injection hook: a callable() invoked at the
        # top of every device-pass window; raising an InjectedFault from
        # it exercises the colo ladder like a real device fault
        self.fault_injector = None
        # dispatch deadline: shares the scheduler's
        # KOORD_TPU_DISPATCH_DEADLINE_MS knob and watchdog discipline
        self.dispatch_deadline_seconds = deadline_seconds_from(
            dispatch_deadline_ms)
        self.dispatch_watchdog = DeadlineWatchdog(
            self.dispatch_deadline_seconds,
            on_overrun=self._on_deadline_overrun)
        # sim/test latency hook: invoked inside the monitored readback
        self.sync_delay_injector = None
        self.stats = {"device_passes": 0, "host_passes": 0,
                      "ineligible_passes": 0,
                      "nodes_changed": 0, "degraded_nodes": 0,
                      "revoke_candidates": 0}
        # device faults the ladder absorbed (each a retry or a demotion)
        self.failures = 0
        self.last_pass_stats: Dict[str, object] = {}

    def _on_deadline_overrun(self, path: str) -> None:
        from koordinator_tpu_torch.scheduler import (
            metrics as scheduler_metrics,
        )

        scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.inc(path=path)
        self.flight.dump("dispatch_deadline")

    # ------------------------------------------------------------------
    def _features(self) -> Dict[str, bool]:
        return {"mesh": self.mesh is not None,
                "waves": False, "explain": False}

    def _active_mesh(self):
        return self.mesh if self.ladder.level < LEVEL_NO_MESH else None

    def _snapshot(self, mesh):
        """The device mirror for this pass — the scheduler's shared
        mirror while its mesh placement matches ours, else a private one
        (the contract of balance/rebalancer._snapshot)."""
        if self.snapshot_getter is not None:
            shared = self.snapshot_getter()
            if shared is not None and getattr(shared, "mesh", None) is mesh:
                return shared
        attr = "_own_snapshot" if mesh is None else "_own_mesh_snapshot"
        snap = getattr(self, attr)
        if snap is None:
            from koordinator_tpu_torch.scheduler.snapshot_cache import (
                DeviceSnapshot,
            )

            snap = DeviceSnapshot(device=self.device, mesh=mesh)
            setattr(self, attr, snap)
        return snap

    def _get_step(self, policies: Tuple[str, str], mesh):
        # the policy strings key the cache — a config hot-reload that
        # flips the calculate policy reuses the step built for it before;
        # under a mesh its device IDS too (two same-size submeshes never
        # share a step)
        key = policies if mesh is None else (policies, mesh.tag)
        step = self._steps.get(key)
        self._last_step_compiled = step is None
        if step is None:
            if mesh is not None:
                from koordinator_tpu_torch.parallel.colo_mesh import (
                    build_sharded_colo_step,
                )

                step = build_sharded_colo_step(policies[0], policies[1],
                                               mesh)
            else:
                from koordinator_tpu_torch.colo.step import build_colo_step

                step = build_colo_step(policies[0], policies[1],
                                       device=self.device)
            self._steps[key] = step
        return step

    # ------------------------------------------------------------------
    @staticmethod
    def _device_eligible(qv) -> Optional[str]:
        """The device quota fold's exactness preconditions (colo/step.py
        module doc). A view outside them is not a fault — it is a
        per-pass demotion to the host oracle, like the rebalancer's
        integer guard. The batch/mid side has no preconditions (it is
        the host's own f32 function)."""
        if qv is None:
            return None
        # static 5-name integrality sweep (vectorized numpy inside)
        # koordlint: disable=host-reconcile-in-colo-path
        for name in ("q_min", "q_guarantee", "q_request", "q_weight",
                     "q_total"):
            a = qv[name]
            if a.size and not np.all(np.floor(a) == a):
                return f"non-integer {name} rows"
        if np.any(qv["q_total"] >= _F32_EXACT_BOUND):
            return "cluster total exceeds the f32-exact bound"
        parent = qv["q_parent"]
        G = parent.shape[0]
        seg = np.where(parent >= 0, parent, G)
        eff_min = np.maximum(qv["q_min"], qv["q_guarantee"])
        # static 3-name segment-sum bound sweep (vectorized inside)
        # koordlint: disable=host-reconcile-in-colo-path
        for name, a in (("min", eff_min), ("request", qv["q_request"]),
                        ("weight", qv["q_weight"])):
            sums = np.zeros((G + 1, a.shape[1]), np.float64)
            np.add.at(sums, seg, a)
            if np.any(sums >= _F32_EXACT_BOUND):
                return (f"per-parent {name} sums exceed the f32-exact "
                        f"bound")
        return None

    @staticmethod
    def _prep(view, qv):
        """Pad-bucketed host arrays for the upload, and the water-filling
        plan (colo/step.py ``water_fill_plan``) the host counts from
        them."""
        from koordinator_tpu_torch.colo.step import water_fill_plan

        n = view["capacity"].shape[0]
        R = view["capacity"].shape[1]
        n_pad = _bucket(max(n, 1), 8)
        fields: Dict[str, np.ndarray] = {}
        # fixed 11-field pad staging (whole-array copies, no per-row work)
        # koordlint: disable=host-reconcile-in-colo-path
        for src, dst in (
                ("capacity", "colo_capacity"),
                ("node_reserved", "colo_node_reserved"),
                ("system_reserved", "colo_system_reserved"),
                ("node_used", "colo_node_used"),
                ("pod_all_used", "colo_pod_all_used"),
                ("hp_used", "colo_hp_used"),
                ("hp_request", "colo_hp_request"),
                ("hp_max", "colo_hp_max"),
                ("prod_reclaimable", "colo_prod_reclaimable"),
                ("reclaim_pct", "colo_reclaim_pct"),
                ("mid_pct", "colo_mid_pct")):
            buf = np.zeros((n_pad, R), np.float32)
            buf[:n] = view[src]
            fields[dst] = buf
        degraded = np.zeros(n_pad, bool)
        degraded[:n] = view["degraded"]
        fields["colo_degraded"] = degraded
        # quota side: pad rows are level=-1 / invalid
        if qv is not None:
            G = qv["q_parent"].shape[0]
            total = qv["q_total"].copy()
        else:
            G = 0
            total = np.zeros(R, np.float32)
        g_pad = _bucket(max(G, 1), 8)
        q_parent = np.full(g_pad, -1, np.int32)
        q_level = np.full(g_pad, -1, np.int32)
        q_valid = np.zeros(g_pad, bool)
        q_allow = np.zeros(g_pad, bool)
        q_enable = np.zeros(g_pad, bool)
        mats = {name: np.zeros((g_pad, R), np.float32)
                for name in ("q_min", "q_max", "q_weight", "q_guarantee",
                             "q_request", "q_used")}
        if qv is not None:
            q_parent[:G] = qv["q_parent"]
            q_level[:G] = qv["q_level"]
            q_valid[:G] = True
            q_allow[:G] = qv["q_allow_lent"]
            q_enable[:G] = qv["q_enable_scale"]
            # fixed 6-matrix pad staging
            # koordlint: disable=host-reconcile-in-colo-path
            for name in mats:
                mats[name][:G] = qv[name]
        # the runtime fold divides the PREDICTED post-writeback total:
        # base axes from the store total, the overcommit axes re-derived
        # in the pass from its own batch/mid integers
        total_base = total.copy()
        total_base[list(_OVERCOMMIT_AXES)] = 0.0
        fields.update({
            "colo_q_parent": q_parent, "colo_q_level": q_level,
            "colo_q_valid": q_valid, "colo_q_allow_lent": q_allow,
            "colo_q_enable_scale": q_enable,
            "colo_q_total_base": total_base.astype(np.float32),
        })
        # fixed 6-matrix field naming
        # koordlint: disable=host-reconcile-in-colo-path
        for name, mat in mats.items():
            fields[f"colo_{name}"] = mat
        plan = water_fill_plan(q_level, mats["q_weight"], q_valid, g_pad)
        return fields, plan

    # ------------------------------------------------------------------
    def reconcile(self, now: Optional[float] = None) -> int:
        """One colo pass: batch/mid writeback + the quota runtime
        publish. Returns the node change count (the host controller's
        reconcile contract, so the Manager's last_changes stays
        shaped)."""
        now = time.time() if now is None else now
        t0 = time.perf_counter()
        self._seq += 1
        with self.tracer.span("colo"):
            changes = self._reconcile_inner(now, t0)
        return changes

    def _reconcile_inner(self, now: float, t0: float) -> int:
        self.ladder.begin_pass()
        with self.tracer.span("pack"):
            view = self.pack.view(now)
            qv = self.pack.quota_view(self.quota_plugin)
        if not view["nodes"]:
            self.last_pass_stats = {"engine": "empty"}
            return 0
        # koordwatch: one decision id per pass (device or host); only a
        # completed device pass records a timeline window
        win = self.timeline.open(
            "colo", "mesh" if self._active_mesh() is not None else "serial")
        self.last_decision_id = win.decision_id
        if self.engine != "on":
            return self._host_pass(view, now, t0, engine="host-pinned")
        reason = self._device_eligible(qv)
        if reason is not None:
            if not self._warned_host_only:
                logger.warning("colo device pass ineligible (%s); using "
                               "the host oracle", reason)
                self._warned_host_only = True
            self.stats["ineligible_passes"] += 1
            return self._host_pass(view, now, t0, engine="host-ineligible")
        attempts = 0
        had_deadline = False
        level0 = self.ladder.level
        while True:
            if self.ladder.level >= LEVEL_HOST_FALLBACK:
                return self._host_pass(view, now, t0)
            try:
                changes = self._device_pass(view, qv, now, t0,
                                            self._active_mesh(), win)
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
                    "colo device pass failed (%s: %s); %s at ladder "
                    "level %s", type(exc).__name__, exc, action,
                    self.ladder.level_name)
                continue
            outcome = ("deadline" if had_deadline
                       else "demoted" if self.ladder.level > level0
                       else "retried" if attempts else "clean")
            self.timeline.close(win, outcome)
            self.ladder.note_cycle()
            return changes

    # ------------------------------------------------------------------
    def _host_pass(self, view, now: float, t0: float,
                   engine: str = "host") -> int:
        """The retained host oracles: NodeResourceController.reconcile
        plus the epoch-memoized host runtime fold (consumed lazily by
        the revoke controller — nothing to publish)."""
        with self.tracer.span("writeback", host="1"):
            changes = self.controller.reconcile(now)
        self.quota_plugin.device_runtime = None
        degraded = int(np.count_nonzero(view["degraded"]))
        self.stats["host_passes"] += 1
        self.stats["nodes_changed"] += changes
        self.stats["degraded_nodes"] = degraded
        self.last_pass_stats = {
            "engine": engine, "changes": changes,
            "degraded": view["degraded"].copy(),
            "decision_id": self.last_decision_id,
            "ladder_level": self.ladder.level_name,
        }
        self._record(now, t0, engine, changes, degraded, 0)
        self.ladder.note_cycle()
        return changes

    def _device_pass(self, view, qv, now: float, t0: float, mesh,
                     win) -> int:
        if self.fault_injector is not None:
            self.fault_injector()
        with self.tracer.span("encode") as esp:
            fields, plan = self._prep(view, qv)
            esp.attributes["nodes"] = str(len(view["nodes"]))
            esp.attributes["quotas"] = str(
                0 if qv is None else len(qv["names"]))
        from koordinator_tpu_torch.colo.step import STEP_FIELDS

        step = self._get_step((view["cpu_policy"], view["memory_policy"]),
                              mesh)
        snap = self._snapshot(mesh)
        n = len(view["nodes"])
        g = 0 if qv is None else len(qv["names"])

        def sync_readback():
            # the colo pass's designated sync point, run under the
            # dispatch-deadline watchdog — route new syncs through here
            # (koordlint naked-device-sync-without-deadline). A watchdog
            # worker thread starts on device 0: set the pass's first.
            import torch

            if self.sync_delay_injector is not None:
                self.sync_delay_injector()
            if out.batch_cpu.is_cuda:
                torch.cuda.set_device(out.batch_cpu.device)
            return (out.batch_cpu[:n].cpu().numpy(),
                    out.batch_mem[:n].cpu().numpy(),
                    out.mid_cpu[:n].cpu().numpy(),
                    out.mid_mem[:n].cpu().numpy(),
                    out.runtime[:g].cpu().numpy(),
                    out.revoke_over[:g].cpu().numpy(),
                    out.revoke_mask[:g].cpu().numpy(),
                    out.predicted_total.cpu().numpy())

        snap.begin_dispatch()
        win.mark_dispatch("mesh" if mesh is not None else "serial")
        abandoned = False
        try:
            with self.tracer.span("kernel", mesh=str(
                    mesh.size if mesh is not None else 0),
                    decision_id=win.decision_id):
                dev = snap.upload_fields(fields)
                step_args = tuple(dev[f"colo_{name}"]
                                  for name in STEP_FIELDS)
                if self._last_step_compiled:
                    # the warm-up index (scheduler/warmup.py): record the
                    # fresh rung so a restarted process can pay the pass's
                    # first-call costs off the bind path; the padded
                    # shapes and the water-filling plan ride the meta
                    from koordinator_tpu_torch.scheduler.warmup import (
                        record_step_compile,
                    )

                    record_step_compile(
                        "colo",
                        {"policies": [view["cpu_policy"],
                                      view["memory_policy"]],
                         "n_pad": int(dev["colo_capacity"].shape[0]),
                         "g_pad": int(dev["colo_q_parent"].shape[0]),
                         "plan": [int(v) for v in plan],
                         "mesh_tag": list(mesh.tag)
                         if mesh is not None else []},
                        step_args)
                out = step(*step_args, plan=plan)
            with self.tracer.span("readback"):
                try:
                    (batch_cpu, batch_mem, mid_cpu, mid_mem, runtime,
                     revoke_over, revoke_mask,
                     predicted_total) = self.dispatch_watchdog.run(
                        sync_readback, "colo")
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
                    if snap is self._own_mesh_snapshot:
                        self._own_mesh_snapshot = None
                    raise
        finally:
            if not abandoned:
                snap.end_dispatch()

        # ---- writeback: the host oracle's own apply(), so the
        # store-visible effect of a pass is engine-independent
        with self.tracer.span("writeback"):
            changes = self.controller.apply(
                view["nodes"], batch_cpu, batch_mem, mid_cpu, mid_mem)
            self._publish_runtime(qv, runtime, revoke_over, revoke_mask,
                                  predicted_total)
        degraded = int(np.count_nonzero(view["degraded"]))
        candidates = int(np.count_nonzero(revoke_mask))
        self.stats["device_passes"] += 1
        self.stats["nodes_changed"] += changes
        self.stats["degraded_nodes"] = degraded
        self.stats["revoke_candidates"] = candidates
        self.last_pass_stats = {
            "engine": "device", "changes": changes,
            "degraded": view["degraded"].copy(),
            "batch_cpu": batch_cpu, "batch_mem": batch_mem,
            "mid_cpu": mid_cpu, "mid_mem": mid_mem,
            "runtime": runtime, "revoke_mask": revoke_mask,
            "decision_id": win.decision_id,
            "ladder_level": self.ladder.level_name,
        }
        self._record(now, t0, "device", changes, degraded, candidates)
        return changes

    def _publish_runtime(self, qv, runtime, revoke_over, revoke_mask,
                         predicted_total) -> None:
        """Land the device fold's quota decisions on the plugin — but
        only when the pass's predicted post-writeback cluster total
        matches the store (the plugin-chain edge can move non-overcommit
        axes); a mismatch falls back to the host fold, never drifts."""
        plugin = self.quota_plugin
        if qv is None:
            plugin.device_runtime = None
            return
        # the verification total routes through the pack's nodes-epoch
        # memo: a writeback that changed nothing reuses the cached
        # vector (no store walk); only a pass that actually moved node
        # status pays the O(N) re-sum — event-driven, not per-pass
        actual = self.pack._cluster_total(plugin)
        if not np.array_equal(predicted_total, actual):
            logger.warning(
                "colo: predicted post-writeback cluster total does not "
                "match the store (plugin-chain resource write?); "
                "dropping the device runtime for this pass")
            plugin.device_runtime = None
            return
        plugin.set_device_runtime(
            qv["names"], runtime, revoke_over, revoke_mask,
            key=plugin.epoch_key)

    def _record(self, now: float, t0: float, engine: str, changes: int,
                degraded: int, candidates: int) -> None:
        """One pass record into the flight ring (valid ``cycle`` record
        per obs/flight.py's schema, so colo dumps replay through the
        same tooling) + the pass metrics."""
        from koordinator_tpu_torch import manager_metrics as mm

        duration = time.perf_counter() - t0
        mm.COLO_PASS_SECONDS.observe(duration)
        mm.COLO_PASSES_TOTAL.inc(engine=(
            "device" if engine == "device" else "host"))
        mm.COLO_DEGRADED_NODES.set(degraded)
        mm.COLO_REVOKE_CANDIDATES.set(candidates)
        if changes:
            mm.COLO_NODES_CHANGED_TOTAL.inc(changes)
        self.flight.record_cycle({
            "v": FLIGHT_SCHEMA_VERSION,
            "kind": "cycle",
            "seq": self._seq,
            "ts": float(now),
            "duration_ms": duration * 1000.0,
            "waves": 0,
            "bound": [], "failed": [], "rejected": [], "preempted": [],
            # koordwatch: the colo writeback's join key — spans, the
            # timeline window and this record share it
            "decision_id": str(self.last_decision_id or ""),
            "metrics": {
                "colo_nodes_changed": float(changes),
                "colo_degraded_nodes": float(degraded),
                "colo_revoke_candidates": float(candidates),
                "colo_device": float(engine == "device"),
            },
            "spans": [],
        })
