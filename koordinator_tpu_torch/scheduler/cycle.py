"""The scheduling cycle driver: the rebuild's scheduleOne loop, in the port.

Where the reference runs one pod at a time through Go plugin dispatch
(frameworkext/framework_extender_factory.go:156-185), this driver drains the
whole pending queue per cycle:

  1. collect pending pods + unscheduled Reservation CRs (reservations ride the
     same queue as pseudo-pods, eventhandlers/reservation_handler.go semantics)
  2. reservation nomination pre-pass: pods matching an Available reservation are
     host-assigned to its node (the nominator prefers reservations; reserved
     resources are owner-restricted, so they bypass the open-capacity kernel)
  3. snapshot (incremental through SnapshotCache) -> device mirror
     (DeviceSnapshot) -> one full-chain round (the CUDA kernel on the card,
     the plain torch round on the CPU) -> gang Permit -> one readback
  4. per binding in queue order: plugin Reserve hooks (cpuset take, device pick)
     -> PreBind annotation accumulation -> single store patch (defaultprebind)
  5. Reserve failure vetoes the binding (unreserve earlier plugins); the pod
     stays pending for the next cycle — mirroring the reference's assume/bind
     error path; unbound pods get PodScheduled=False with the per-stage
     diagnosis, and PostFilter preemption reruns the pass once.

A port of the JAX package's ``Scheduler`` with serial dispatch (one round
per cycle). Its bindings, conditions, gang and quota writes are the JAX
package's byte for byte (tests/test_torch_cycle.py). The paths a later
slice brings raise NotImplementedError and never run something else
silently: fused/chained multi-wave dispatch (a wave depth resolving to
K > 1 — "auto" does at >= 256 pending pods, so pass ``waves=1``), explain
attribution, the mesh, the gRPC sidecar, the degradation ladder and the
warm-up ladder. With no ladder, a dispatch failure propagates out of
``run_cycle`` as an unhandled cycle exception.

Steps are cached per scheduler by shape signature (P/N/G buckets, gangs,
groups, active axes).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

from koordinator_tpu_torch.api.objects import (
    ObjectMeta,
    Pod,
    PodSpec,
    Reservation,
)
from koordinator_tpu_torch.api.resources import NUM_RESOURCES, PACK_SCALE
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    KIND_PV,
    KIND_PVC,
    KIND_RESERVATION,
    KIND_STORAGECLASS,
    ObjectStore,
)
from koordinator_tpu_torch.models.convert import check_device, to_device
from koordinator_tpu_torch.models.full_chain import build_best_full_chain_step
from koordinator_tpu_torch.obs import Tracer
from koordinator_tpu_torch.ops.fit import with_pod_count
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
from koordinator_tpu_torch.scheduler.deadline import (
    DeadlineWatchdog,
    DispatchDeadlineExceeded,
    deadline_seconds_from,
)
from koordinator_tpu_torch.scheduler.frameworkext import (
    BindResult,
    CycleContext,
    CycleResult,
    FrameworkExtender,
)
from koordinator_tpu_torch.scheduler.plugins import DEFAULT_PLUGINS
from koordinator_tpu_torch.scheduler.snapshot import (
    ClusterState,
    build_full_chain_inputs,
    reduce_to_active_axes,
)

RESERVATION_POD_PREFIX = "__reservation__/"

# the fused multi-wave depth cap (models/fused_waves.MAX_WAVES in the JAX
# package); any depth above 1 comes with the fused-wave slice
MAX_WAVES = 8

# failure reasons whose condition message is recomputed from the packed
# batch (scheduler/diagnose.py); the deferral path keeps the batch alive
# only when one of these is present — the two sites must stay in sync
DIAGNOSED_REASONS = ("no feasible node", "admission rejected")


def waves_from_env():
    """KOORD_TPU_WAVES=K pins the fused multi-wave depth (K rounds per
    device dispatch); "auto" (the default) picks K from the pending-queue
    depth, K=1 being the exact serial path — the only one this slice of
    the port runs."""
    raw = os.environ.get("KOORD_TPU_WAVES", "auto").strip().lower()
    if raw in ("", "auto"):
        return "auto"
    try:
        return max(1, min(int(raw), MAX_WAVES))
    except ValueError:
        logger.warning("KOORD_TPU_WAVES=%r not an int; using auto", raw)
        return "auto"


def explain_from_env():
    """KOORD_TPU_EXPLAIN=off|counts|full gates koordexplain decision
    attribution (models/full_chain.explain_stage_counts): "counts" emits
    the per-pod per-stage rejected-node counts in the scheduling dispatch
    (diagnose becomes a pure formatter over them), "full" adds the winning
    node's per-plugin score terms + runner-up for bound pods. Returns
    None (off), "counts" or "full"."""
    raw = os.environ.get("KOORD_TPU_EXPLAIN", "off").strip().lower()
    if raw in ("", "off", "0", "false", "no"):
        return None
    if raw in ("counts", "on", "1", "true"):
        return "counts"
    if raw == "full":
        return "full"
    logger.warning("KOORD_TPU_EXPLAIN=%r unknown; explain stays off", raw)
    return None


def replay_overlap_from_env() -> bool:
    """KOORD_TPU_REPLAY_OVERLAP=0 keeps the deferred-condition flush as
    per-pod store writes (event granularity included); default on, one
    flush lands as ONE ``store.update_many`` transaction (the JAX
    package's overlapped-replay setting, which also governs its fused
    wave replay)."""
    return os.environ.get("KOORD_TPU_REPLAY_OVERLAP", "1") != "0"


def pack_overlap_from_env() -> bool:
    """KOORD_TPU_PACK_OVERLAP=0 keeps the incremental pack strictly in
    the inter-window gap (the byte-parity twin). Default on: cycle N's
    device window pre-packs the next cycle's candidate pod rows into the
    pack memo (snapshot.py
    prepack_pending_rows) while the device runs — rows dirtied later in
    the window reconcile through the (key, resourceVersion) memo keys,
    so the produced ScheduleInputs are byte-identical either way
    (the JAX package's run_pack_overlap_parity gates it)."""
    return os.environ.get("KOORD_TPU_PACK_OVERLAP", "1") != "0"


def cycle_deadline_from_env():
    """KOORD_TPU_CYCLE_DEADLINE_MS=N arms the flight recorder's
    deadline-overrun trigger: a cycle slower than N ms dumps the ring.
    Unset/0 disables (the default)."""
    raw = os.environ.get("KOORD_TPU_CYCLE_DEADLINE_MS", "").strip()
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        logger.warning("KOORD_TPU_CYCLE_DEADLINE_MS=%r not a number; "
                       "deadline trigger off", raw)
        return None
    return ms / 1000.0 if ms > 0 else None


def watch_from_env() -> bool:
    """KOORD_TPU_WATCH=0 turns koordwatch off (see the canonical helper
    in obs/timeline.py — shared with the standalone rebalance/colo
    timelines so the kill switch covers every consumer)."""
    from koordinator_tpu_torch.obs.timeline import watch_from_env as _watch

    return _watch()


def _auto_waves(queue_depth: int) -> int:
    """Depth-based auto-K: the fused dispatch amortizes the fixed
    dispatch+readback overhead over K dependent rounds, but each extra
    wave costs real device work, so shallow queues (where one round
    drains everything bindable and the fixed overhead is small relative
    to host work anyway) stay serial. Powers of two only, so the
    compile cache sees at most 4 distinct K values."""
    if queue_depth >= 4096:
        return 8
    if queue_depth >= 1024:
        return 4
    if queue_depth >= 256:
        return 2
    return 1


class _DeferredFlushTxn:
    """Read-your-writes view for one deferred-condition flush: patches
    accumulate here and land as ONE ``store.update_many`` transaction
    (the vectorized store write the wave-replay batching promises),
    while later entries in the same flush still see earlier entries'
    patches — the sequential supersede/idempotence semantics of per-pod
    writes are preserved exactly; only the per-pod lock round-trips and
    duplicate MODIFIED events for re-verdicted pods are gone."""

    def __init__(self, store: ObjectStore) -> None:
        self._store = store
        self.pending: Dict[str, Pod] = {}

    def get(self, key: str) -> Optional[Pod]:
        obj = self.pending.get(key)
        return obj if obj is not None else self._store.get(KIND_POD, key)

    def put(self, obj: Pod) -> None:
        self.pending[obj.meta.key] = obj

    def flush(self) -> None:
        if self.pending:
            self._store.update_many(KIND_POD, list(self.pending.values()))
            self.pending.clear()


def _refuse(feature: str, slice_name: str):
    """A path this slice of the port leaves out: raise, never run
    something else silently."""
    raise NotImplementedError(
        f"{feature} comes with the {slice_name} slice of the port")


def _mesh_requested(mesh) -> bool:
    """KOORD_TPU_MESH (or ``mesh=``) asks for mesh-backed dispatch unless
    it reads as off; the port has no mesh yet."""
    raw = (os.environ.get("KOORD_TPU_MESH", "") if mesh is None
           else mesh)
    if not isinstance(raw, (int, str)):
        return True  # a mesh object
    return str(raw).strip().lower() not in ("", "0", "off", "false", "no")


def _warmup_requested(warmup) -> bool:
    """KOORD_TPU_WARMUP (or ``warmup=``) asks for the warm-up ladder:
    "auto" does only when KOORD_TPU_COMPILE_CACHE_DIR is set, as in the
    JAX package; the port has no warm-up ladder yet."""
    raw = (os.environ.get("KOORD_TPU_WARMUP", "auto") if warmup is None
           else str(warmup)).strip().lower()
    if raw in ("", "auto"):
        return bool(os.environ.get("KOORD_TPU_COMPILE_CACHE_DIR", "").strip())
    return raw not in ("0", "off", "false", "no")


class Scheduler:
    """koord-scheduler analog: batched cycles against the object store.

    ``device`` is where rounds run: "cuda" (the default; the CUDA kernel)
    or "cpu" (the plain torch round). Asking for CUDA where there is none
    raises."""

    def __init__(
        self,
        store: ObjectStore,
        args: Optional[LoadAwareArgs] = None,
        scheduler_name: str = "koord-scheduler",
        config: Optional["SchedulerConfiguration"] = None,
        elector=None,
        sidecar_address: Optional[str] = None,
        waves=None,
        explain=None,
        mesh=None,
        ladder=None,
        replay_overlap=None,
        dispatch_deadline_ms=None,
        watch=None,
        pack_overlap=None,
        warmup=None,
        device="cuda",
    ):
        from koordinator_tpu_torch.scheduler.config import SchedulerConfiguration
        from koordinator_tpu_torch.scheduler.plugins.reservation import (
            ReservationController,
        )

        import dataclasses as _dc

        self.device = check_device(device)
        if sidecar_address:
            _refuse("the gRPC sidecar dispatch", "transport")
        if ladder is not None:
            _refuse("the degradation ladder", "degrade.py")
        if _mesh_requested(mesh):
            _refuse("mesh-backed dispatch", "parallel/")
        if _warmup_requested(warmup):
            _refuse("the warm-up ladder", "warm-up")
        # koordexplain (KOORD_TPU_EXPLAIN): None=off, "counts", "full".
        # Unknown strings fail loudly, as in the JAX package; anything but
        # off comes with a later slice.
        if explain not in (None, "off", "counts", "full"):
            raise ValueError(
                f"explain must be None, 'off', 'counts' or 'full'; "
                f"got {explain!r}")
        self.explain_spec = (explain_from_env() if explain is None
                             else (None if explain == "off" else explain))
        if self.explain_spec is not None:
            _refuse("explain attribution", "explain")
        # fused multi-wave depth: K rounds per device dispatch. "auto"
        # picks from queue depth per cycle (_effective_waves refuses a
        # depth above 1); an int pins it.
        self.waves_spec = waves_from_env() if waves is None else waves
        if self.waves_spec != "auto" and int(self.waves_spec) > 1:
            _refuse(f"waves={self.waves_spec} (fused multi-wave dispatch)",
                    "fused-wave")

        base = config or SchedulerConfiguration()
        # explicit args win over config (older call sites pass args directly);
        # keep a private copy so the caller's config object is never mutated,
        # and validate what will actually be used
        self.config = (_dc.replace(base, load_aware=args)
                       if args is not None else base)
        self.config.validate()
        self.store = store
        self.args = self.config.load_aware
        self.scheduler_name = scheduler_name
        self.extender = FrameworkExtender(store)
        numa_args = self.config.node_numa_resource
        plugin_kwargs = {
            "NodeNUMAResource": dict(
                max_ref_count=numa_args.max_ref_count,
                default_cpu_bind_policy=numa_args.default_cpu_bind_policy,
                numa_allocate_strategy=numa_args.numa_allocate_strategy,
            ),
            "Coscheduling": dict(
                default_timeout_seconds=self.config.coscheduling.default_timeout_seconds,
            ),
            "DeviceShare": dict(
                scoring_strategy=self.config.device_share.scoring_strategy,
            ),
        }
        for cls in DEFAULT_PLUGINS:
            plugin = cls(**plugin_kwargs.get(cls.name, {}))
            self.extender.register_plugin(plugin)
        # DeviceShare contributes NUMA hints to the shared topology admit
        # (GetPodTopologyHints, deviceshare/topology_hint.go:33)
        numa_plugin = self.extender.plugin("NodeNUMAResource")
        device_plugin = self.extender.plugin("DeviceShare")
        if numa_plugin is not None and device_plugin is not None:
            numa_plugin.topology_manager.register_provider(device_plugin)
        res_plugin = self.extender.plugin("Reservation")
        self.reservation_controller = (
            ReservationController(
                res_plugin, store,
                self.config.reservation.gc_duration_seconds)
            if res_plugin else None
        )
        if res_plugin is not None:
            from koordinator_tpu_torch.scheduler.plugins.reservation import (
                ReservationRestoreTransformer,
            )

            self.extender.register_transformer(
                ReservationRestoreTransformer(store)
            )
        quota_plugin = self.extender.plugin("ElasticQuota")
        self.quota_revoke_controller = (
            quota_plugin.revoke_controller(store, self.config.elastic_quota)
            if quota_plugin else None
        )
        from koordinator_tpu_torch.scheduler.preempt import QuotaPreemptor

        self.preemptor = (
            QuotaPreemptor(store, quota_plugin) if quota_plugin else None
        )
        # active/standby gating (cmd/koord-scheduler/app/server.go:227-256):
        # with an elector, a cycle runs only while this replica holds the lease
        self.elector = elector
        # koordtrace: every cycle emits a root span with the per-stage
        # split (snapshot/encode/kernel/bind)
        self.tracer = Tracer()
        # the step memo, keyed by shape signature; one per scheduler, so
        # no step is ever shared between two schedulers
        self._step_cache: Dict[Tuple, object] = {}
        # whether the most recent _get_step call built a fresh step
        self._last_step_compiled = False
        # the backend of the last dispatch ("cuda" or "serial") and the
        # count of dispatch windows: one kernel launch per window on the
        # card, which is how a run shows the cycle went through the kernel
        self.last_backend: Optional[str] = None
        self.dispatches = 0
        # pack/device overlap (KOORD_TPU_PACK_OVERLAP): pre-pack the
        # next cycle's candidate pod rows inside this cycle's device
        # window. An explicit argument pins it (the parity twins need it).
        self.pack_overlap = (pack_overlap_from_env()
                             if pack_overlap is None else bool(pack_overlap))
        # parity/test hook: called with the post-reduce host
        # FullChainInputs at the end of every encode
        self.encode_observer = None
        # batched deferred-condition flush (KOORD_TPU_REPLAY_OVERLAP): one
        # store transaction per flush; 0 keeps per-pod writes
        self.replay_overlap = (replay_overlap_from_env()
                               if replay_overlap is None
                               else bool(replay_overlap))
        # cycle flight recorder (obs/flight.py): decision records for the
        # last N cycles, dumped on deadline overrun / unhandled cycle
        # exception / HTTP demand
        from koordinator_tpu_torch.obs.flight import FlightRecorder
        from koordinator_tpu_torch.obs.timeline import DeviceTimeline

        self.flight = FlightRecorder(
            dump_counter=scheduler_metrics.FLIGHT_DUMPS)
        # koordwatch: the device timeline. KOORD_TPU_WATCH=0 (or
        # watch=False) is the kill switch — decision ids keep minting
        # but the ring stops recording.
        self.watch_enabled = (watch_from_env() if watch is None
                              else bool(watch))
        self.timeline = DeviceTimeline(
            window_histogram=scheduler_metrics.DEVICE_WINDOW_SECONDS,
            idle_gauge=scheduler_metrics.DEVICE_IDLE_FRACTION,
            enabled=self.watch_enabled)
        # per-cycle koordwatch state, reset at run_cycle start: the
        # decision ids of this cycle's device windows and the id of the
        # window currently open (stamped onto /explain attribution)
        self._cycle_decision_ids: List[str] = []
        self._current_decision_id: Optional[str] = None
        self.cycle_deadline_seconds = cycle_deadline_from_env()
        self._cycle_counter = 0
        # koordguard dispatch deadline (scheduler/deadline.py,
        # KOORD_TPU_DISPATCH_DEADLINE_MS): the designated readback sync
        # runs under the watchdog; an overrun counts, flight-dumps and
        # raises out of the cycle. None/0 (the default) keeps it inline.
        self.dispatch_deadline_seconds = deadline_seconds_from(
            dispatch_deadline_ms)
        self.dispatch_watchdog = DeadlineWatchdog(
            self.dispatch_deadline_seconds,
            on_overrun=self._on_deadline_overrun)
        # test failure-injection hook: a callable(stage) invoked at the
        # top of every device-dispatch window ("serial"); what it raises
        # propagates out of run_cycle
        self.fault_injector = None
        # test latency hook: a callable() invoked inside every monitored
        # readback sync — sleeping in it is a slow-not-dead device
        self.sync_delay_injector = None
        # test upload-failure hook, propagated onto every DeviceSnapshot
        # this scheduler builds (see the property below)
        self._upload_fault_injector = None
        # pipelined-cycle mode (CyclePipeline): diagnose/condition writes
        # for unbound pods are deferred into the NEXT cycle's kernel
        # window so host work overlaps device execution. Off by default —
        # plain run_cycle callers keep the strictly serial path.
        self.pipeline_mode = False
        # (items, last-batch tuple, now) per deferral
        self._deferred_diagnose: List[Tuple[list, object, float]] = []
        self._flushed_this_cycle = False
        # last DeviceSnapshot stats snapshot, for counter deltas
        self._upload_stats_last: Dict[str, int] = {}
        # the packed batch of the last pass (fc, key -> row, n_nodes) for
        # end-of-cycle unschedulability diagnosis
        self._last_batch = None
        # admission grouping of the last encode: raw arrays, with the
        # dict view materialized lazily on the preemption path
        self._last_admission_raw = None
        self._last_admission = None
        # DefaultPreemption's attempted-latch and its cycle clock
        self._preempt_attempted: Dict[str, int] = {}
        self._cycle_seq = 0
        # incremental snapshot packing (SURVEY 7: caches become
        # device-resident arrays updated by deltas) — event-driven memos
        # replacing the per-cycle cluster walks, and the device mirror
        # uploading only what changed; gate off for the rebuild-everything
        # behavior (every cycle then uploads in full, as the sidecar does)
        from koordinator_tpu_torch.utils.features import SCHEDULER_GATES

        self.snapshot_cache = None
        self.device_snapshot = None
        if SCHEDULER_GATES.enabled("IncrementalSnapshot"):
            from koordinator_tpu_torch.scheduler.snapshot_cache import (
                SnapshotCache,
            )

            self.snapshot_cache = SnapshotCache(
                store,
                loadaware_plugin=self.extender.plugin("LoadAwareScheduling"),
                numa_plugin=self.extender.plugin("NodeNUMAResource"),
            )
            self.device_snapshot = self._new_device_snapshot()

    # ------------------------------------------------------------------
    def _new_device_snapshot(self):
        """Build a DeviceSnapshot on this scheduler's device with the
        upload-failure hook propagated."""
        from koordinator_tpu_torch.scheduler.snapshot_cache import DeviceSnapshot

        snap = DeviceSnapshot(device=self.device)
        snap.fault_injector = self._upload_fault_injector
        return snap

    @property
    def upload_fault_injector(self):
        return self._upload_fault_injector

    @upload_fault_injector.setter
    def upload_fault_injector(self, fn) -> None:
        self._upload_fault_injector = fn
        if self.device_snapshot is not None:
            self.device_snapshot.fault_injector = fn

    def _open_window(self, base: str):
        """Open a device-timeline window for one dispatch pass; the
        minted decision id joins spans, flight records and /explain."""
        win = self.timeline.open("scheduler", base)
        self._current_decision_id = win.decision_id
        self._cycle_decision_ids.append(win.decision_id)
        return win

    def _on_deadline_overrun(self, path: str) -> None:
        """The dispatch watchdog abandoned a monitored sync: count it and
        dump the flight ring (reason dispatch_deadline); the
        DispatchDeadlineExceeded raised right after propagates out of the
        cycle."""
        scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.inc(path=path)
        self.flight.dump("dispatch_deadline")

    def _abandon_device_state(self) -> None:
        """A deadline overrun left a round running against the mirror's
        tensors. Never block on it: the mirror is replaced wholesale, and
        the next upload repopulates the fresh one through full puts."""
        if self.device_snapshot is None:
            return
        self.device_snapshot = self._new_device_snapshot()
        self._upload_stats_last = {}

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _pending_queue(self, now: float) -> Tuple[List[Pod], Dict[str, Reservation]]:
        pods = [
            p
            for p in self.store.list(KIND_POD)
            if not p.is_assigned
            and not p.is_terminated
            and p.spec.scheduler_name == self.scheduler_name
        ]
        reservations: Dict[str, Reservation] = {}
        for res in self.store.list(KIND_RESERVATION):
            if res.phase == "Pending" and not res.node_name and not res.is_expired(now):
                pseudo = Pod(
                    meta=ObjectMeta(
                        name=res.meta.name,
                        namespace="__reservation__",
                        creation_timestamp=res.meta.creation_timestamp,
                    ),
                    spec=PodSpec(
                        priority=(
                            res.template.priority
                            if res.template.priority is not None
                            else 9500
                        ),
                        requests=res.template.requests,
                        limits=res.template.limits,
                    ),
                )
                pods.append(pseudo)
                reservations[pseudo.meta.key] = res
        # pending-queue visibility (koordwatch, pre-work for the ROADMAP
        # admission/queueing item): the depth this cycle drains and every
        # entry's enqueue-to-dispatch age. creation_timestamp is the
        # enqueue instant for both real pods and reservation pseudo-pods.
        if self.watch_enabled:
            scheduler_metrics.PENDING_QUEUE_DEPTH.set(float(len(pods)))
            for p in pods:
                created = p.meta.creation_timestamp or now
                scheduler_metrics.QUEUE_WAIT_SECONDS.observe(
                    max(0.0, now - created))
        return pods, reservations

    def _process_resizes(self, now: float, result: CycleResult) -> None:
        """In-place pod resize (KEP-1287 shape; reference gates it behind
        the ResizePod feature and runs Reserve + ResizePod instead of a
        scheduling pass): an assigned pod carrying spec.resize_requests is
        granted when its node still fits the DELTA against every other
        assigned pod's requests; otherwise it stays pending and retries
        next cycle. cpuset-bound (LSE/LSR integer-cpu) pods are refused —
        their core allocation would need a release/re-take, which in-place
        resize cannot do safely."""
        import dataclasses

        from koordinator_tpu_torch.scheduler.snapshot import _pod_cpuset_flags

        candidates = [
            p for p in self.store.list(KIND_POD)
            if p.is_assigned and not p.is_terminated
            and p.spec.resize_requests is not None
            and p.spec.scheduler_name == self.scheduler_name
        ]
        if not candidates:
            return
        assigned = self._assigned_requests()
        # Available reservations HOLD capacity the batch pass counts via
        # ReservationRestoreTransformer — the resize fit base must count it
        # too, or a granted resize overcommits against a reservation whose
        # owner binds later
        for res in self.store.list(KIND_RESERVATION):
            if res.is_available and not res.is_expired(now) and res.node_name:
                vec = res.allocatable.to_vector()
                assigned[res.node_name] = (
                    assigned.get(res.node_name, np.zeros_like(vec)) + vec)
        nodes = {n.meta.name: n for n in self.store.list(KIND_NODE)}
        numa_plugin = self.extender.plugin("NodeNUMAResource")
        from koordinator_tpu_torch.scheduler.topologymanager import (
            POLICY_SINGLE_NUMA_NODE,
        )
        for pod in candidates:
            node = nodes.get(pod.spec.node_name)
            if node is None:
                result.resize_pending.append(pod.meta.key)
                self.extender.error_handlers.dispatch(
                    pod, "resize target node not found")
                continue
            # cpuset guard on BOTH shapes: the old allocation AND what the
            # pod would become (a resize to integer-cpu LSR must not dodge
            # the cpuset release/re-take it cannot do in place)
            needs_bind_old, _c, _f = _pod_cpuset_flags(pod)
            resized_view = dataclasses.replace(
                pod, spec=dataclasses.replace(
                    pod.spec, requests=pod.spec.resize_requests))
            needs_bind_new, _c, _f = _pod_cpuset_flags(resized_view)
            if needs_bind_old or needs_bind_new:
                result.resize_pending.append(pod.meta.key)
                self.extender.error_handlers.dispatch(
                    pod, "in-place resize unsupported for cpuset-bound pods")
                continue
            # SingleNUMANode-policy nodes account per-zone state the
            # whole-node delta check below cannot see: a granted resize
            # could overcommit a zone the batch pass believes free.
            # Refuse, the same stance as cpuset-bound pods.
            if numa_plugin is not None:
                topo = numa_plugin.topologies.get(pod.spec.node_name)
                if (topo is not None and topo.zones
                        and numa_plugin.node_policy(pod.spec.node_name)
                        == POLICY_SINGLE_NUMA_NODE):
                    result.resize_pending.append(pod.meta.key)
                    self.extender.error_handlers.dispatch(
                        pod, "in-place resize unsupported on "
                             "SingleNUMANode-policy nodes")
                    continue
            new_vec = pod.spec.resize_requests.to_vector()
            old_vec = pod.spec.requests.to_vector()
            others = (assigned.get(pod.spec.node_name,
                                   np.zeros_like(new_vec)) - old_vec)
            # the SAME trimmed allocatable the batch kernel fits against
            # (node-reservation annotation trims — ops/estimator.py); raw
            # status.allocatable would grant resizes into reserved cores
            from koordinator_tpu_torch.ops.estimator import (
                estimate_node_allocatable,
            )

            alloc = estimate_node_allocatable(node)
            need = new_vec > 0
            if np.any(need & (others + new_vec > alloc)):
                result.resize_pending.append(pod.meta.key)
                self.extender.error_handlers.dispatch(
                    pod, "resize does not fit the node")
                continue
            pod.spec.requests = pod.spec.resize_requests
            pod.spec.resize_requests = None
            self.store.update(KIND_POD, pod)
            # the node's fit base shifts for later candidates on it
            assigned[pod.spec.node_name] = others + new_vec
            result.resized.append(pod.meta.key)

    def _assigned_requests(self) -> Dict[str, np.ndarray]:
        """Base fit state per node: every assigned pod's requests. Reservation
        accounting (reserved capacity + double-count restore) is layered on by
        ReservationRestoreTransformer via the declared before-Filter extension
        point — a custom transformer can rewrite the same view.

        Rebuilt per cycle (robust against in-place object mutation), but as
        ONE wire-matrix fill + scale + segment-sum instead of per-pod vector
        allocations. With the incremental snapshot cache the sums are
        event-maintained instead (same values; test_snapshot_cache.py)."""
        if self.snapshot_cache is not None:
            return self.snapshot_cache.assigned_requests()
        assigned = [
            p for p in self.store.list(KIND_POD)
            if p.is_assigned and not p.is_terminated
        ]
        if not assigned:
            return {}
        node_ids: Dict[str, int] = {}
        rows = np.zeros(len(assigned), np.int64)
        wire = np.zeros((len(assigned), NUM_RESOURCES), np.float64)
        for i, pod in enumerate(assigned):
            pod.spec.requests.fill_wire_row(wire[i])
            rows[i] = node_ids.setdefault(pod.spec.node_name, len(node_ids))
        packed = with_pod_count((wire / PACK_SCALE).astype(np.float32))
        sums = np.zeros((len(node_ids), NUM_RESOURCES), np.float32)
        np.add.at(sums, rows, packed)
        return {node: sums[i] for node, i in node_ids.items()}

    def _cluster_state(self, pending: List[Pod], now: float) -> ClusterState:
        la = self.extender.plugin("LoadAwareScheduling")
        numa = self.extender.plugin("NodeNUMAResource")
        quota = self.extender.plugin("ElasticQuota")
        gang = self.extender.plugin("Coscheduling")
        return ClusterState(
            nodes=[n for n in self.store.list(KIND_NODE) if not n.unschedulable],
            pending_pods=pending,
            node_metrics={
                m.meta.name: m for m in self.store.list(KIND_NODE_METRIC)
            },
            pods_by_key={p.meta.key: p for p in self.store.list(KIND_POD)},
            assigned=la.assigned_view() if la else {},
            assigned_requests=self._assigned_requests(),
            topologies=dict(numa.topologies) if numa else {},
            cpu_states=dict(numa.cpu_states) if numa else {},
            numa_allocated=dict(numa.numa_allocated) if numa else {},
            quotas=quota.quota_list() if quota else [],
            pod_groups=list(gang.pod_groups.values()) if gang else [],
            gang_assumed=dict(gang.assumed) if gang else {},
            pvcs={c.meta.key: c for c in self.store.list(KIND_PVC)},
            pvs={v.meta.name: v for v in self.store.list(KIND_PV)},
            storage_classes={
                s.meta.name: s
                for s in self.store.list(KIND_STORAGECLASS)
            },
            now=now,
        )


    def _get_step(self, signature: Tuple, ng: int, ngroups: int,
                  active) -> object:
        key = (signature, ng, ngroups, tuple(active))
        step = self._step_cache.get(key)
        if step is not None:
            self._last_step_compiled = False
            scheduler_metrics.COMPILE_CACHE_HITS.inc()
            return step
        # shape-signature miss: this span times the host-side step
        # construction; on the card the kernel library loads at the
        # step's first call, in the NEXT kernel span, which is why the
        # kernel span carries compiled="1" on that cycle
        self._last_step_compiled = True
        scheduler_metrics.COMPILE_CACHE_MISSES.inc()
        with self.tracer.span("compile", signature=str(key)):
            step = build_best_full_chain_step(
                self.args, ng, ngroups, active_axes=active)
        self._step_cache[key] = step
        return step

    def _effective_waves(self, pending: List[Pod], override=None) -> int:
        """Resolve this cycle's wave depth: 1 is the serial path this
        slice ports; a depth above 1 (an int, or "auto" at >= 256 pending
        pods) is the fused dispatch, which comes with a later slice."""
        spec = self.waves_spec if override is None else override
        k = _auto_waves(len(pending)) if spec == "auto" else int(spec)
        k = max(1, min(k, MAX_WAVES))
        if k > 1:
            _refuse(f"a wave depth of {k} (fused multi-wave dispatch; "
                    f"pass waves=1)", "fused-wave")
        return k

    # ------------------------------------------------------------------
    def run_cycle(self, now: Optional[float] = None,
                  waves=None) -> CycleResult:
        now = time.time() if now is None else now
        if self.elector is not None and not self.elector.tick(now):
            return CycleResult(skipped_not_leader=True)
        self._cycle_decision_ids = []
        self._current_decision_id = None
        result = CycleResult()
        carried_deferred = bool(self._deferred_diagnose)
        self._flushed_this_cycle = False
        self._cycle_counter += 1
        flight_base = self._flight_metric_base()
        root = None
        # root span: the ONE place the cycle duration is stamped. Every
        # early-return path inside the traced body (empty queue, pre-pass
        # binds everything, full pass) exits through the span's finally,
        # so no return path can ship a zero duration.
        try:
            with self.tracer.span("cycle") as root:
                self._run_cycle_traced(now, result, waves_override=waves)
                # a cycle with no kernel window (empty queue) never reached
                # the overlap flush: drain carried-over deferred writes here
                # so they cannot linger unboundedly — without device work
                # to overlap, flushing now IS the serial timing
                if (self.pipeline_mode and carried_deferred
                        and not self._flushed_this_cycle
                        and self._deferred_diagnose):
                    self.flush_deferred()
        except Exception as exc:
            # flight-recorder trigger: an unhandled cycle exception leaves
            # the wreck behind — the partial result, the span tree and the
            # preceding cycles in the ring — then re-raises unchanged
            result.duration_seconds = (root.duration_seconds
                                       if root is not None else 0.0)
            result.decision_ids = list(self._cycle_decision_ids)
            self.flight.record_cycle(self._flight_record(
                result, now, root, flight_base,
                error=f"{type(exc).__name__}: {exc}"))
            self.flight.dump("cycle_exception")
            raise
        result.duration_seconds = root.duration_seconds
        result.decision_ids = list(self._cycle_decision_ids)
        scheduler_metrics.CYCLE_SECONDS.observe(result.duration_seconds)
        if result.duration_seconds > 0:
            # device-busy fraction of this cycle (the "is the device the
            # bottleneck yet" gauge), clamped against timer skew
            scheduler_metrics.PIPELINE_OCCUPANCY.set(min(
                1.0, result.device_busy_seconds / result.duration_seconds))
        if result.bound:
            scheduler_metrics.PODS_BOUND_TOTAL.inc(len(result.bound))
        self.extender.monitor.record(result)
        self._finish_cycle_obs(result, now, root, flight_base)
        return result

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _flight_metric_base(self) -> Dict[str, float]:
        """Cycle-start counter values, so the flight record carries per-
        cycle METRIC DELTAS instead of meaningless cumulative totals."""
        return {
            "pods_bound": scheduler_metrics.PODS_BOUND_TOTAL.get() or 0.0,
            "compile_cache_misses":
                scheduler_metrics.COMPILE_CACHE_MISSES.get() or 0.0,
            "readback_bytes": scheduler_metrics.READBACK_BYTES.get() or 0.0,
        }

    def _flight_record(self, result: CycleResult, now: float, root,
                       base: Dict[str, float], error=None) -> dict:
        """One flight-recorder cycle record (obs/flight.py schema)."""
        from koordinator_tpu_torch.obs.flight import FLIGHT_SCHEMA_VERSION

        end = self._flight_metric_base()
        bound = [{"pod": b.pod_key, "node": b.node_name}
                 for b in result.bound]

        def unbound(keys: List[str]) -> List[dict]:
            return [{"pod": key} for key in keys]

        record = {
            "v": FLIGHT_SCHEMA_VERSION,
            "kind": "cycle",
            "seq": self._cycle_counter,
            "ts": float(now),
            "duration_ms": result.duration_seconds * 1000.0,
            "waves": int(result.waves),
            "bound": bound,
            "failed": unbound(result.failed),
            "rejected": unbound(result.rejected),
            "preempted": list(result.preempted_victims),
            # koordwatch: the cycle's structured demotion reasons and
            # the decision ids of its device windows (joinable against
            # the timeline bundle and the kernel spans' decision_id)
            "demotions": list(result.demotions),
            "decision_ids": list(result.decision_ids),
            "metrics": {k: end[k] - base.get(k, 0.0) for k in end},
            "spans": ([s.to_record() for s in root.walk()]
                      if root is not None else []),
        }
        if error is not None:
            record["error"] = str(error)
        return record

    def _finish_cycle_obs(self, result: CycleResult, now: float, root,
                          flight_base: Dict[str, float]) -> None:
        """Post-cycle bookkeeping: the flight ring and the deadline
        trigger."""
        self.flight.record_cycle(
            self._flight_record(result, now, root, flight_base))
        if (self.cycle_deadline_seconds is not None
                and result.duration_seconds > self.cycle_deadline_seconds):
            self.flight.dump("deadline_overrun")

    def _run_cycle_traced(self, now: float, result: CycleResult,
                          waves_override=None) -> None:
        # [ResizePod gate] in-place resize of assigned pods, before the
        # batch pass sees their requests (frameworkext factory
        # RunReservePluginsReserve + RunResizePod analog)
        from koordinator_tpu_torch.utils.features import SCHEDULER_GATES

        if SCHEDULER_GATES.enabled("ResizePod"):
            self._process_resizes(now, result)
        res_plugin = self.extender.plugin("Reservation")
        if self.reservation_controller is not None:
            self.reservation_controller.reconcile(now)
        if self.quota_revoke_controller is not None:
            self.quota_revoke_controller.reconcile(now)
        pending, pending_reservations = self._pending_queue(now)
        # permit-timeout rejection: pods of terminally-failed gangs never
        # re-enter admission (gang.go WaitingPods timeout semantics)
        gang_plugin = self.extender.plugin("Coscheduling")
        if gang_plugin is not None:
            gang_plugin.update_pod_group_status(self.store, now)
            dead_gangs = set(gang_plugin.timed_out_gangs())
            if dead_gangs:
                kept = []
                timed_out: List[Tuple[Pod, str]] = []
                for pod in pending:
                    if pod.gang_key in dead_gangs:
                        result.rejected.append(pod.meta.key)
                        self.extender.error_handlers.dispatch(
                            pod, "gang schedule timeout")
                        timed_out.append((pod, "gang schedule timeout"))
                    else:
                        kept.append(pod)
                pending = kept
                # these pods never reach the batch pass, so the terminal
                # reason must land on their status here (the end-of-cycle
                # writer only sees batch-pass failures)
                self._write_unschedulable_conditions([], timed_out, now)
        if not pending:
            return

        # ---- per-pod view transforms (BeforePreFilter) run before ANY
        # scheduling decision — the nomination pre-pass must see the same
        # views the kernel pass packs; originals are kept for the
        # preemption retry, which re-transforms from scratch
        ctx = CycleContext(now=now)
        originals = {p.meta.key: p for p in pending}
        pending = self.extender.transform_before_prefilter(pending, ctx)

        # ---- reservation nomination pre-pass. Gang/quota pods are excluded:
        # their admission barriers live in the batched kernel, and binding them
        # here would bypass min-member and quota checks. So are pods whose
        # placement the kernel Filter chain must vet — hostPorts, CSI
        # volume claims, inter-pod (anti-)affinity, topology spread: the
        # nominator checks only the reservation's resource fit, and with
        # descheduler-issued migration reservations (owner-matched to a
        # whole workload) a port-carrying replica nominated onto the
        # reserved node could double-bind a hostPort the kernel would
        # have rejected (the koordbalance drain-storm scenario caught
        # exactly that). Such pods schedule through the kernel, which
        # still counts reserved capacity via the restore transformer.
        with self.tracer.span("reservation_prepass") as presp:
            remaining: List[Pod] = []
            nominated = 0
            for pod in pending:
                if (
                    pod.meta.key in pending_reservations
                    or res_plugin is None
                    or pod.gang_name
                    or pod.quota_name
                    or pod.spec.host_ports
                    or pod.spec.pvc_names
                    or pod.spec.pod_affinity
                    or pod.spec.pod_anti_affinity
                    or pod.spec.topology_spread
                ):
                    remaining.append(pod)
                    continue
                res = res_plugin.nominate(pod, now)
                if res is None:
                    remaining.append(pod)
                    continue
                err = self._reserve_and_bind(pod, res.node_name, ctx, result,
                                             via_reservation=res)
                if err:
                    remaining.append(pod)
                else:
                    nominated += 1
            presp.attributes["nominated"] = str(nominated)
        pending = remaining
        if not pending:
            return

        # ---- the wave depth: 1 is this slice's serial path; a depth
        # above 1 (the fused multi-wave dispatch) raises
        self._effective_waves(pending, waves_override)

        # ---- batched kernel pass
        rejected_pods, failed_pods = self._batch_pass(
            pending, now, ctx, result, pending_reservations
        )

        any_victims = self._post_filter_preempt(
            rejected_pods, failed_pods, result)
        if any_victims:
            # retry transforms from the ORIGINAL queued pods, not the
            # already-transformed views — a non-idempotent rewrite would
            # otherwise apply twice (BeforePreFilter runs per attempt on
            # the queued pod in the reference too)
            retry = self.extender.transform_before_prefilter(
                [
                    originals.get(p.meta.key, p)
                    for p in rejected_pods + [p for p, _ in failed_pods]
                ],
                ctx,
            )
            rejected_pods, failed_pods = self._batch_pass(
                retry, now, ctx, result, pending_reservations
            )
        for b in result.bound:
            self._preempt_attempted.pop(b.pod_key, None)

        for pod in rejected_pods:
            result.rejected.append(pod.meta.key)
            self.extender.error_handlers.dispatch(pod, "admission rejected")
        for pod, reason in failed_pods:
            result.failed.append(pod.meta.key)
            self.extender.error_handlers.dispatch(pod, reason)
        # pod-status propagation (upstream PodScheduled=False/Unschedulable
        # with the per-stage message): the reason becomes store-visible on
        # the pod object, not just the failure trail
        self._write_unschedulable_conditions(
            rejected_pods, failed_pods, now)
        # the packed batch is only needed within this cycle; don't pin
        # tens of MB of host arrays across idle periods
        self._last_batch = None

        if gang_plugin is not None:
            gang_plugin.update_pod_group_status(self.store, now)

    # ------------------------------------------------------------------
    def _post_filter_preempt(self, rejected_pods: List[Pod],
                             failed_pods: List[Tuple[Pod, str]],
                             result: CycleResult) -> bool:
        """PostFilter preemption for ONE logical scheduling cycle: the
        shared block behind both the serial flow and every fused-wave
        logical cycle, so their preemption cadence can never drift.
        Advances the cycle sequence (the rotation/latch clock) and returns
        whether any victims were evicted (the caller reruns the kernel
        then, exactly as the reference's nominate-then-reschedule).

        ElasticQuota preemption (preempt.go): quota-rejected non-gang pods
        try to reclaim from lower-priority same-group members.
        DefaultPreemption (the vendored kube fallback): pods with no
        feasible node try priority preemption; victims terminate
        synchronously and the kernel rerun is the real gate. The
        attempted-latch stops a pod the kernel STILL rejects (e.g.
        spread/NUMA constraints the host dry-run cannot see) from
        draining a fresh victim set EVERY cycle: a latched pod may retry
        only every PREEMPT_RETRY_CYCLES (cluster state may have unblocked
        it by then — bounded drain instead of either extreme). Keys of
        pods that bound or left the queue are dropped each cycle."""
        any_victims = False
        if self.preemptor is not None and rejected_pods:
            quota_rejected = [
                p for p in rejected_pods if p.quota_name and not p.gang_name
            ]
            for round_ in self.preemptor.post_filter(quota_rejected):
                any_victims = True
                result.preempted_victims.extend(round_.victim_keys)
        PREEMPT_RETRY_CYCLES = 5
        attempted = self._preempt_attempted
        self._cycle_seq += 1
        still_failed_keys = {p.meta.key for p, _ in failed_pods}
        for key in [k for k in attempted if k not in still_failed_keys]:
            del attempted[key]
        no_fit = [
            p for p, reason in failed_pods
            if reason == "no feasible node" and not p.gang_name
            and self._cycle_seq - attempted.get(p.meta.key, -10**9)
            >= PREEMPT_RETRY_CYCLES
        ]
        if no_fit:
            from koordinator_tpu_torch.scheduler.preempt import DefaultPreemption

            preempter = DefaultPreemption(
                self.store,
                kernel_admission=self._resolve_admission(),
                attempt_seed=self._cycle_seq,
            )
            for round_ in preempter.post_filter(no_fit):
                any_victims = True
                attempted[round_.preemptor_key] = self._cycle_seq
                result.preempted_victims.extend(round_.victim_keys)
        return any_victims

    # ------------------------------------------------------------------
    def _write_unschedulable_conditions(
        self,
        rejected_pods: List[Pod],
        failed_pods: List[Tuple[Pod, str]],
        now: float,
    ) -> None:
        """PodScheduled=False/Unschedulable on every pod ending the cycle
        unbound. Specific reasons (encoding overflow, volume PreFilter,
        Reserve vetoes) pass through verbatim; generic kernel rejections
        get the per-stage breakdown from scheduler/diagnose.py. Idempotent:
        an unchanged condition writes nothing (no store churn, no snapshot
        cache invalidation for permanently-pending pods)."""
        last = self._last_batch
        items = list(failed_pods) + [
            (p, "admission rejected") for p in rejected_pods]
        if not items:
            return
        if self.pipeline_mode:
            # pipelined cycle: the writes run inside the NEXT cycle's
            # kernel window (flush_deferred), overlapping device work.
            # `now` and the packed batch are captured here, so the
            # diagnosis content is byte-identical to the serial path.
            # Only generic kernel rejections consult the packed batch —
            # drop it when no item needs it, so a deferred entry does not
            # pin the fc arrays the `_last_batch = None` release below
            # exists to free. (Streaming use bounds the pinning to one
            # cycle anyway: the next kernel window or a kernel-less cycle
            # drains the queue; idle drivers must call flush().)
            if not any(r in DIAGNOSED_REASONS for _p, r in items):
                last = None
            self._deferred_diagnose.append((items, last, now))
            scheduler_metrics.DIAGNOSE_DEFERRED_TOTAL.inc(len(items))
            scheduler_metrics.DIAGNOSE_DEFERRED_DEPTH.set(
                float(len(self._deferred_diagnose)))
            return
        with self.tracer.span("diagnose", pods=str(len(items))):
            self._diagnose_and_write(items, last, now)

    def _prepack_in_window(self) -> None:
        """Pack/device overlap (KOORD_TPU_PACK_OVERLAP): pre-pack the
        NEXT cycle's candidate pod rows into the pack memo while the
        device executes this cycle's kernel — the store-delta snapshot
        is taken HERE, at dispatch time, after the deferred flush bumped
        the condition-written pods. Rows dirtied later in the window
        (bind patches from the in-flight replay, watch events) simply
        miss the (key, resourceVersion) memo keys at the real pack and
        re-pack there, so the produced ScheduleInputs are byte-identical
        to the non-overlapped pack by construction (and gated by
        run_pack_overlap_parity + the mid-window-mutation test).

        Purely a memo warm: a failure here costs nothing but the
        overlap — the next cycle packs in the gap exactly as before —
        so it is caught and logged, never raised.

        A registered BeforePreFilter view transform disables the
        pre-pack: the real pack consumes TRANSFORMED pod views that
        keep the store resourceVersion, so a pre-packed raw row would
        be a (key, rv) hit serving untransformed bytes — the same
        cannot-see-the-rewrite stance as the fused path's host-only
        transformer demotion."""
        if not self.pack_overlap or self.snapshot_cache is None:
            return
        from koordinator_tpu_torch.scheduler.frameworkext import (
            PreFilterTransformer,
        )

        if any(isinstance(t, PreFilterTransformer)
               and type(t).before_prefilter
               is not PreFilterTransformer.before_prefilter
               for t in self.extender.transformers):
            return
        try:
            from koordinator_tpu_torch.scheduler.snapshot import (
                prepack_pending_rows,
            )

            with self.tracer.span("prepack") as sp:
                pods = [
                    p for p in self.store.list(KIND_POD)
                    if not p.is_assigned and not p.is_terminated
                    and p.spec.scheduler_name == self.scheduler_name
                ]
                n = prepack_pending_rows(self.snapshot_cache, pods,
                                         self.args)
                sp.attributes["rows"] = str(n)
            if n:
                scheduler_metrics.PREPACK_ROWS.inc(n)
        except Exception:
            # a pre-pack wreck may have left HALF-updated memo rows
            # (resourceVersion bumped before every column refreshed) —
            # rows the next build would serve as hits with stale bytes.
            # Poison the memo wholesale: the next pack runs the cold
            # path (bit-identical by the snapshot-cache contract) and
            # rebuilds it; one expensive build buys back correctness.
            self.snapshot_cache.pack_memo = None
            self.snapshot_cache.pack_memo_prev = None
            logger.exception("in-window pre-pack failed; pack memo "
                             "dropped — the next cycle repacks cold in "
                             "the gap")

    def flush_deferred(self) -> None:
        """Drain deferred diagnose/condition work (pipeline mode). Runs in
        the next cycle's kernel window — host work the device never waits
        on — and from CyclePipeline.flush() at end of stream. FIFO order
        preserves the serial path's write sequence when a pod accumulates
        verdicts across cycles."""
        self._flushed_this_cycle = True
        # overlapped-replay mode batches the whole flush into one store
        # transaction; overlap=0 keeps the per-pod writes of the parity
        # twin byte-for-byte (event granularity included)
        txn = (_DeferredFlushTxn(self.store)
               if self.replay_overlap and self._deferred_diagnose else None)
        while self._deferred_diagnose:
            items, last, now = self._deferred_diagnose.pop(0)
            with self.tracer.span("diagnose", pods=str(len(items)),
                                  deferred="1"):
                self._diagnose_and_write(items, last, now, deferred=True,
                                         txn=txn)
        if txn is not None and txn.pending:
            with self.tracer.span("store_flush",
                                  writes=str(len(txn.pending))):
                txn.flush()
        scheduler_metrics.DIAGNOSE_DEFERRED_DEPTH.set(
            float(len(self._deferred_diagnose)))

    def _diagnose_and_write(self, items, last, now: float,
                            deferred: bool = False,
                            txn: Optional[_DeferredFlushTxn] = None) -> None:
        from koordinator_tpu_torch.scheduler.diagnose import (
            diagnose_unbound,
            shared_state,
        )

        shared = None  # node-level diagnosis state, built once per cycle
        for pod, reason in items:
            msg = reason
            if last is not None and reason in DIAGNOSED_REASONS:
                # the host-numpy recompute over the batch the round
                # consumed (explain's kernel-emitted counts come later)
                fc, index, n_nodes = last
                j = index.get(pod.meta.key)
                if j is not None:
                    try:
                        if shared is None:
                            shared = shared_state(fc, n_nodes)
                        msg = diagnose_unbound(fc, j, n_nodes, shared=shared)
                    except Exception:  # diagnosis must never wedge a cycle
                        logger.exception(
                            "unschedulability diagnosis failed for %s",
                            pod.meta.key)
            stored = (txn.get(pod.meta.key) if txn is not None
                      else self.store.get(KIND_POD, pod.meta.key))
            if stored is None:  # reservation pseudo-pods, raced deletions
                continue
            if deferred:
                # the flush runs after later store activity; two ways the
                # verdict can be superseded, both of which the serial path
                # resolved by writing BEFORE that activity:
                #  * the pod was bound (next cycle's nomination pre-pass):
                #    serial's transient False was overwritten by the
                #    bind's PodScheduled=True — skipping converges;
                #  * the pod was deleted and RECREATED under the same key
                #    (stable StatefulSet-style names, fresh uid): serial
                #    stamped the old incarnation; the new pod must wait
                #    for its own verdict.
                if stored.is_assigned:
                    continue
                if (stored.meta.uid and pod.meta.uid
                        and stored.meta.uid != pod.meta.uid):
                    continue
                # uid-less objects (bare test fixtures): creation time is
                # the remaining identity signal — a recreated incarnation
                # carries a fresh timestamp, the same incarnation never
                # changes its own
                if (stored.meta.creation_timestamp
                        != pod.meta.creation_timestamp):
                    continue
            cur = stored.get_condition("PodScheduled")
            if cur is not None and (cur.status, cur.message) == ("False", msg):
                continue
            patched = stored.patch_copy()
            patched.set_condition(
                "PodScheduled", "False", "Unschedulable", msg, now)
            if txn is not None:
                txn.put(patched)
            else:
                self.store.update(KIND_POD, patched)

    # ------------------------------------------------------------------
    def _resolve_admission(self):
        """The (node -> group, pod key -> mask) dicts host-side dry-runs
        consult. Built lazily from the raw arrays the last encode stashed:
        materializing 10k-entry dicts on every cycle charged the hot path
        for a mapping only the (rare) preemption path reads."""
        raw = self._last_admission_raw
        if raw is None:
            return None
        if self._last_admission is None:
            node_group_arr, node_names, pod_mask_arr, pod_keys = raw
            self._last_admission = (
                {n: int(node_group_arr[i]) for i, n in enumerate(node_names)},
                {key: int(pod_mask_arr[i])
                 for i, key in enumerate(pod_keys)},
            )
        return self._last_admission

    def _encode_batch(self, pending: List[Pod], now: float,
                      ctx: CycleContext):
        """Snapshot + encode: store objects -> packed FullChainInputs.
        Returns (fc, pods, nodes, ng, ngroups, active) or None when no
        schedulable node exists."""
        # pods arrive already view-transformed (run_cycle runs BeforePreFilter
        # ahead of the nomination pre-pass); here the state-level transformer
        # chain runs: ClusterState rewrites, then packed-input rewrites
        with self.tracer.span("snapshot") as ssp:
            state = self._cluster_state(pending, now)
            self.extender.transform_after_prefilter(state, ctx)
            self.extender.transform_before_filter(state, ctx)
            ssp.attributes["nodes"] = str(len(state.nodes))
            ssp.attributes["pods"] = str(len(pending))
        if not state.nodes:
            return None
        with self.tracer.span("encode"):
            cs = (self.snapshot_cache.stats
                  if self.snapshot_cache is not None else None)
            hits0 = cs["pod_row_hits"] if cs is not None else 0
            miss0 = cs["pod_row_misses"] if cs is not None else 0
            with self.tracer.span("pack_incremental") as pis:
                fc, pods, nodes, tree, gang_index, ng, ngroups = (
                    build_full_chain_inputs(
                        state, self.args, cache=self.snapshot_cache
                    ))
            if cs is not None:
                reused = cs["pod_row_hits"] - hits0
                repacked = cs["pod_row_misses"] - miss0
                pis.attributes["rows_reused"] = str(reused)
                pis.attributes["rows_repacked"] = str(repacked)
                scheduler_metrics.PACK_ROWS_REUSED.inc(reused)
                scheduler_metrics.PACK_ROWS_REPACKED.inc(repacked)
            # stash the admission grouping this kernel pass used so
            # host-side dry-runs (DefaultPreemption) consult the SAME
            # encoding — the raw label check can be more permissive when
            # the signature budget overflowed, and the dry-run must never
            # accept a node the kernel cannot bind (it would evict victims
            # in vain). Raw arrays only: _resolve_admission materializes
            # the dicts on the (rare) preemption path instead of charging
            # every cycle for them.
            self._last_admission_raw = (
                np.asarray(fc.node_taint_group),
                [n.meta.name for n in state.nodes],
                np.asarray(fc.pod_taint_mask),
                list(pods.keys),
            )
            self._last_admission = None
            fc = self.extender.transform_before_score(fc, ctx)
            fc, active = reduce_to_active_axes(fc)
            # keep the packed batch for end-of-cycle unschedulability
            # diagnosis (scheduler/diagnose.py reads the same arrays the
            # kernel consumed); a retry pass overwrites this with the
            # final batch
            self._last_batch = (
                fc, {key: j for j, key in enumerate(pods.keys)},
                len(state.nodes))
        if self.encode_observer is not None:
            # parity/test hook: the post-reduce host arrays — the
            # ScheduleInputs level the pack-overlap byte-parity gates on
            self.encode_observer(fc)
        return fc, pods, nodes, ng, ngroups, active

    def _record_upload_deltas(self) -> None:
        """DeviceSnapshot stats -> per-cycle counter deltas."""
        ds = self.device_snapshot.stats
        prev_ds = self._upload_stats_last
        for key, counter in (
            ("reused", scheduler_metrics.UPLOAD_FIELDS_REUSED),
            ("scattered", scheduler_metrics.UPLOAD_FIELDS_SCATTERED),
            ("put", scheduler_metrics.UPLOAD_FIELDS_PUT),
            ("bytes_scattered", scheduler_metrics.UPLOAD_BYTES_SCATTERED),
            ("bytes_put", scheduler_metrics.UPLOAD_BYTES_PUT),
        ):
            counter.inc(ds[key] - prev_ds.get(key, 0))
        self._upload_stats_last = dict(ds)


    def _readback_sync(self, *tensors):
        """The designated host sync point: materialize the round's outputs,
        MONITORED by the dispatch-deadline watchdog (koordguard). With a
        deadline armed the blocking body runs on a watchdog worker; an
        overrun raises DispatchDeadlineExceeded out of the cycle instead
        of wedging it behind a slow-not-dead device. The default
        no-deadline path is inline."""
        return self.dispatch_watchdog.run(
            lambda: self._readback_sync_now(*tensors), "serial")

    def _readback_sync_now(self, *tensors):
        """The blocking readback body: ``.cpu().numpy()`` of each tensor.
        On a watchdog worker thread the CUDA device is set first (a new
        thread starts on device 0)."""
        import torch

        if self.sync_delay_injector is not None:
            # latency injection: a slow-not-dead device is a sync that
            # takes too long, exactly where the watchdog watches
            self.sync_delay_injector()
        out = []
        for t in tensors:
            if t.is_cuda:
                torch.cuda.set_device(t.device)
            out.append(t.cpu().numpy())
        return out

    def _batch_pass(
        self,
        pending: List[Pod],
        now: float,
        ctx: CycleContext,
        result: CycleResult,
        pending_reservations: Dict[str, Reservation],
    ) -> Tuple[List[Pod], List[Tuple[Pod, str]]]:
        """One snapshot -> kernel -> bind pass. Appends bindings to `result`
        and returns (rejected_pods, failed) still unbound — `failed` carries
        (pod, reason) so Reserve/PreBind veto reasons survive to dispatch —
        the caller decides whether to retry them (preemption) or record them."""
        rejected_pods: List[Pod] = []
        failed_pods: List[Tuple[Pod, str]] = []
        enc = self._encode_batch(pending, now, ctx)
        if enc is None:
            return rejected_pods, [(p, "no schedulable node") for p in pending]
        fc, pods, nodes, ng, ngroups, active = enc
        chosen = self._dispatch_serial(fc, pods, nodes, ng, ngroups,
                                       active, result)

        # apply bindings in queue order
        with self.tracer.span("bind") as bsp:
            bound_before = len(result.bound)
            by_key = {p.meta.key: p for p in pending}
            for i, key in enumerate(pods.keys):
                node_idx = int(chosen[i])
                pod = by_key[key]
                if node_idx < 0:
                    # encoding-budget overflows carry their own first-class
                    # reason (surfaced via the error-handler event trail
                    # and the overflow metric) and never enter preemption —
                    # no victim set can fix an encoding cut
                    reason = pods.unschedulable_reasons.get(i)
                    if reason is not None:
                        failed_pods.append((pod, reason))
                    elif pod.gang_name or pod.quota_name:
                        rejected_pods.append(pod)
                    else:
                        failed_pods.append((pod, "no feasible node"))
                    continue
                node_name = nodes.names[node_idx]
                reservation = pending_reservations.get(key)
                err = self._reserve_and_bind(
                    pod, node_name, ctx, result, reservation_cr=reservation
                )
                if err:
                    failed_pods.append((pod, err))
            bsp.attributes["bound"] = str(len(result.bound) - bound_before)
        return rejected_pods, failed_pods

    # ------------------------------------------------------------------
    def _dispatch_serial(self, fc_host, pods, nodes, ng, ngroups, active,
                         result: CycleResult) -> np.ndarray:
        """The single-round device-dispatch window: upload (through the
        device mirror, or in full without one), one round (the CUDA kernel
        on the card; gang Permit included), one readback. ``fc_host``
        keeps the host arrays for diagnosis. A failure anywhere in the
        window propagates out of the cycle; there is no degradation
        ladder in this slice of the port."""
        # koordwatch device window for this pass: the decision id joins
        # the kernel span, the flight record and /explain; the window
        # records the dispatch->sync interval
        win = self._open_window("serial")
        step = self._get_step(
            (pods.padded_size, nodes.padded_size,
             fc_host.quota_runtime.shape[0]),
            ng, ngroups, active,
        )
        with self.tracer.span(
                "kernel",
                compiled="1" if self._last_step_compiled else "0",
                decision_id=win.decision_id) as ksp:
            snap = self.device_snapshot
            with self.tracer.span("upload"):
                if snap is not None:
                    # device-resident steady state: unchanged fields reuse
                    # the previous cycle's tensors, small row deltas go up
                    # as row scatters (snapshot_cache.DeviceSnapshot)
                    fc = snap.upload(fc_host)
                    self._record_upload_deltas()
                else:
                    fc = to_device(fc_host, self.device)
            if snap is not None:
                snap.begin_dispatch()
            t_dispatch = time.perf_counter()
            win.mark_dispatch("serial")
            try:
                if self.fault_injector is not None:
                    self.fault_injector("serial")
                chosen, _, _ = step(fc)  # queued on the stream — no sync
                self.last_backend = step.last_backend
                self.dispatches += 1
                if self.pipeline_mode:
                    # overlap window: the previous cycle's deferred host
                    # work (unschedulability diagnosis + condition writes)
                    # runs while the device executes this cycle's round,
                    # then the next cycle's candidate rows pre-pack into
                    # the memo (pack overlap). Host memory only: the
                    # mirror's next scatter waits for the sync below.
                    self.flush_deferred()
                    self._prepack_in_window()
                    with self.tracer.span("overlap_wait"):
                        # the pipeline's single designated sync point:
                        # bind needs the chosen vector, nothing before does
                        chosen, = self._readback_sync(chosen)
                else:
                    with self.tracer.span("readback"):
                        chosen, = self._readback_sync(chosen)
            except DispatchDeadlineExceeded:
                # slow-not-dead device: the round may still read the
                # mirror's tensors — never scatter into them again
                self._abandon_device_state()
                raise
            finally:
                if snap is not None:
                    snap.end_dispatch()
            result.device_busy_seconds += time.perf_counter() - t_dispatch
            scheduler_metrics.WAVES_PER_DISPATCH.observe(1.0)
            scheduler_metrics.READBACK_BYTES.inc(int(chosen.nbytes))
        result.kernel_seconds += ksp.duration_seconds
        scheduler_metrics.KERNEL_SECONDS.observe(ksp.duration_seconds)
        self.timeline.close(win, "clean")
        return chosen

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _reserve_and_bind(
        self,
        pod: Pod,
        node_name: str,
        ctx: CycleContext,
        result: CycleResult,
        via_reservation: Optional[Reservation] = None,
        reservation_cr: Optional[Reservation] = None,
    ) -> Optional[str]:
        """Reserve hooks -> PreBind -> Bind; returns error to leave pod
        pending."""
        if reservation_cr is not None:
            # binding a Reservation CR itself: no plugin reserve (it only holds
            # capacity), just set status (reservation plugin Bind, plugin.go:596).
            # Allocatable comes from the CR's own template, NOT the pseudo-pod,
            # which may be a cycle-local transformer view that must not persist
            reservation_cr.node_name = node_name
            reservation_cr.phase = "Available"
            reservation_cr.allocatable = reservation_cr.template.requests.copy()
            self.store.update(KIND_RESERVATION, reservation_cr)
            result.bound.append(
                BindResult(RESERVATION_POD_PREFIX + reservation_cr.meta.name,
                           node_name)
            )
            return None

        with self.tracer.span("bind_pod", pod=pod.meta.key,
                              node=node_name) as psp:
            with self.tracer.span("reserve"):
                done: List = []
                for plugin in self.extender.plugins:
                    err = plugin.reserve(pod, node_name, ctx)
                    if err:
                        for p in reversed(done):
                            p.unreserve(pod, node_name, ctx)
                        psp.attributes["veto"] = plugin.name
                        return f"{plugin.name}: {err}"
                    done.append(plugin)
                if via_reservation is not None:
                    res_plugin = self.extender.plugin("Reservation")
                    res_plugin.consume(pod, via_reservation, ctx)

            with self.tracer.span("prebind"):
                annotations: Dict[str, str] = {}
                for plugin in self.extender.plugins:
                    plugin.pre_bind(pod, node_name, ctx, annotations)
                prebind = self.extender.plugin("DefaultPreBind")
                prebind.apply_patch(pod, node_name, annotations, now=ctx.now)
        result.bound.append(BindResult(pod.meta.key, node_name, annotations))
        return None


# ---------------------------------------------------------------------------
# pipelined cycle driver
# ---------------------------------------------------------------------------

def pipeline_enabled_from_env() -> bool:
    """KOORD_TPU_PIPELINE=0 restores the strictly serial cycle."""
    return os.environ.get("KOORD_TPU_PIPELINE", "1") != "0"


class CyclePipeline:
    """Pipelined cycle driver: overlap host work with device execution.

    Wraps a Scheduler for a STREAM of cycles (the input-pipeline shape from
    the training world — keep the accelerator fed). Three hand-off points
    change relative to the serial path, none of which changes results:

      1. the kernel dispatch is non-blocking — no ``.cpu()`` readback
         until the bind loop actually needs the chosen vector;
      2. unschedulability diagnosis + PodScheduled condition writes for
         cycle N run inside cycle N+1's kernel window (``flush_deferred``),
         while the device executes — content is captured at cycle N (same
         packed batch, same ``now``), so the writes are byte-identical;
      3. ``flush()`` drains whatever the last cycle deferred.

    Bind order, CRD writes and unschedulable conditions end up byte-for-
    byte what the serial path produces (tests/test_torch_cycle.py runs
    both paths against the JAX package's and diffs the store).
    ``KOORD_TPU_PIPELINE=0`` (or ``enabled=False``) falls back to the
    serial single-threaded path exactly.
    """

    def __init__(self, scheduler: Scheduler,
                 enabled: Optional[bool] = None) -> None:
        self.scheduler = scheduler
        self.enabled = (pipeline_enabled_from_env()
                        if enabled is None else bool(enabled))
        scheduler.pipeline_mode = self.enabled

    def run_cycle(self, now: Optional[float] = None,
                  waves=None) -> CycleResult:
        return self.scheduler.run_cycle(now=now, waves=waves)

    def flush(self) -> None:
        """Drain deferred condition writes (call at end of stream)."""
        self.scheduler.flush_deferred()

    def __enter__(self) -> "CyclePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()
