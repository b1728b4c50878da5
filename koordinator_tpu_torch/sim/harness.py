"""The churn simulator: seeded hostile traffic against the real Scheduler.

One :class:`ChurnSimulator` owns a synthetic cluster store, drives the
production :class:`~koordinator_tpu_torch.scheduler.cycle.Scheduler` (and
optionally the descheduler) cycle by cycle on a synthetic clock, on
``device`` ("cuda" by default, or "cpu"), and layers on everything a
shared cluster throws at a scheduler:

  * seeded arrival/departure processes — Poisson pod arrivals with a
    prod/BE/quota/feature mix, gang storms, burst queues, Poisson
    departures of running pods;
  * cluster events — node drain (cordon + evict + uncordon-or-delete),
    spot reclamation of bound BE pods (re-queued as fresh arrivals),
    NodeMetric expiry flips, elastic-quota rebalances;
  * fault injection — a :class:`FaultPlan` arming dispatch exceptions
    (exercising the degradation ladder), scheduler store-write failures
    and dead-sidecar cycles at chosen cycles;
  * pending-queue backpressure — a bounded admitted queue with a
    waiting room: arrivals beyond ``queue_cap`` wait (requeue) and
    beyond ``overflow_cap`` are shed;
  * per-cycle invariant checks (:mod:`koordinator_tpu_torch.sim.invariants`)
    and time-to-bind SLO tracking, flight-recorder dumps on any breach
    or overrun.

Everything is deterministic for a (scenario, seed) pair — the binding
log is byte-stable, the same on the card as on the CPU, and the same as
the JAX package's sim (tests/test_torch_sim.py holds them together).

A copy of the JAX package's harness. A scenario's mesh (``mesh``) is
that many virtual shards of the sim's device (parallel/mesh.py, the
counterpart of the JAX sim's virtual CPU devices); explain attribution
(``explain``) and dead-sidecar cycles run as configured. A co-located descheduler
(``descheduler_every``) and a co-located koord-manager (``colo_every``)
share the scheduler's
snapshot, device mirror and device, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

from koordinator_tpu_torch.api.objects import (
    LABEL_POD_GROUP,
    LABEL_QUOTA_NAME,
    ElasticQuota,
    Node,
    NodeMetric,
    NodeMetricInfo,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodGroup,
    PodSpec,
)
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.client.store import (
    KIND_ELASTIC_QUOTA,
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    KIND_POD_GROUP,
    ObjectStore,
)
from koordinator_tpu_torch.sim.faults import (
    DeadSidecarClient,
    FaultPlan,
    FaultyStore,
)
from koordinator_tpu_torch.sim.invariants import check_invariants
from koordinator_tpu_torch.sim.scenarios import Scenario

GIB = 1024 ** 3
ZONE = "topology.kubernetes.io/zone"
PRIORITY_PROD = 9500
PRIORITY_BE = 5500
MAX_EVENT_DUMPS = 3  # flight dumps per trigger kind, so a pathological
#                      run cannot turn the recorder into the bottleneck


@dataclasses.dataclass
class SimReport:
    """Everything a scenario run produced, JSON-ready via to_dict()."""

    scenario: str
    seed: int
    cycles: int
    pods_created: int = 0
    pods_bound: int = 0
    pods_departed: int = 0
    pods_reclaimed: int = 0
    pods_drained: int = 0
    pods_shed: int = 0
    pods_requeued: int = 0
    max_pending: int = 0
    max_overflow: int = 0
    final_pending: int = 0
    ttb_seconds: List[float] = dataclasses.field(default_factory=list)
    slo_target_seconds: float = 0.0
    slo_overruns: int = 0
    invariant_breaches: List[str] = dataclasses.field(default_factory=list)
    cycle_exceptions: List[str] = dataclasses.field(default_factory=list)
    faults_injected: int = 0
    sidecar_fallbacks: int = 0
    # koordguard: monitored-sync overruns (slow-not-dead devices) and
    # the crash-restart recovery SLO — sim-clock seconds from each
    # scheduler teardown to the fresh scheduler's first bind
    deadline_overruns: int = 0
    restarts: int = 0
    restart_to_first_bind_seconds: List[float] = dataclasses.field(
        default_factory=list)
    # wall-clock recovery (report-only): dominated by the fresh
    # scheduler's cold compiles — the number the ROADMAP's AOT-warm-up
    # item will have to beat; sim-clock gates the SLO because wall time
    # is backend-bound
    restart_to_first_bind_wall_seconds: List[float] = dataclasses.field(
        default_factory=list)
    # the wall-clock recovery split — how much of each restart's
    # wall was compile (step builds + freshly-compiled kernel windows +
    # the warm-up ladder) vs pack/encode, so the persistent-cache win is
    # attributable (the CHURN_r03 comparability note in BENCH_NOTES)
    restart_wall_compile_seconds: List[float] = dataclasses.field(
        default_factory=list)
    restart_wall_pack_seconds: List[float] = dataclasses.field(
        default_factory=list)
    # steady-state compile guard (koordlint rule 20, runtime half): step
    # cache misses flagged AFTER a warm-up ladder completed — per
    # restart up to its first bind, and the run total
    restart_steady_state_compiles: List[int] = dataclasses.field(
        default_factory=list)
    steady_state_compile_flags: int = 0
    # warm-up ladder stats of the LAST-BUILT scheduler (the restarted
    # one, in crash-restart scenarios) — empty dict when warm-up is off
    warmup: Dict[str, object] = dataclasses.field(default_factory=dict)
    # koordwatch device timeline: final idle fraction (gap-over-wall) —
    # THE number the pack-overlap A/B pair must move
    device_idle_fraction: float = 0.0
    restart_slo_seconds: float = 0.0
    ladder_transitions: List[dict] = dataclasses.field(default_factory=list)
    cycles_at_level: Dict[str, int] = dataclasses.field(default_factory=dict)
    final_level: str = "full"
    flight_dumps: int = 0
    descheduler_runs: int = 0
    # koordbalance: the rebalance closed loop's activity + SLO
    migration_jobs_created: int = 0
    pods_migrated: int = 0
    hotspot_events: int = 0
    hotspots_open: int = 0        # flagged node sets still hot at end
    dissipate_cycles: List[int] = dataclasses.field(default_factory=list)
    # the co-located rebalancer's passes by engine ("device", "host") and
    # the device faults its ladder absorbed ("failures"): the port's own,
    # kept out of to_dict so the report stays the JAX package's
    rebalance_passes: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    dissipate_slo_cycles: int = 0
    # koordcolo: the colocation control loop's activity + SLO
    manager_rounds: int = 0
    colo_device_passes: int = 0
    colo_host_passes: int = 0
    overcommit_shifts: int = 0
    batch_pods_bound: int = 0
    colo_staleness_cycles: List[int] = dataclasses.field(
        default_factory=list)
    colo_staleness_slo_cycles: int = 0
    colo_final_engine: str = ""
    # koordwatch demotion profile: cycles that ran below their
    # configured wave/explain/mesh level (CycleResult.demotions), each
    # attributed to its FIRST structured reason so the per-reason counts
    # sum exactly to cycles_demoted — zero unattributed demotions
    cycles_demoted: int = 0
    demotion_cycles_by_reason: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # koordwatch pending-queue visibility: per-cycle depth at dispatch
    # and the oldest enqueued entry's age (store-pending + waiting room)
    queue_depth_by_cycle: List[int] = dataclasses.field(
        default_factory=list)
    queue_oldest_wait_by_cycle: List[float] = dataclasses.field(
        default_factory=list)
    binding_log: List[str] = dataclasses.field(default_factory=list)
    wall_seconds: float = 0.0
    # pipeline-occupancy accounting under realistic arrivals: per-cycle
    # wall and device-busy sums, plus bound/wall bucketed by the logical
    # cycles each dispatch consumed (CycleResult.waves) — the churn-side
    # pods_per_sec_at_k / pipeline_occupancy the bench report cites
    cycle_wall_seconds: float = 0.0
    device_busy_seconds: float = 0.0
    wall_by_waves: Dict[int, float] = dataclasses.field(default_factory=dict)
    bound_by_waves: Dict[int, int] = dataclasses.field(default_factory=dict)

    def percentile(self, q: float) -> float:
        if not self.ttb_seconds:
            return 0.0
        return float(np.percentile(np.asarray(self.ttb_seconds), q))

    def slo_registry(self, burn_gauge=None, met_gauge=None):
        """The report's SLO accounting as koordwatch registrations
        (obs/slo.py): the four objectives the scenarios gate — ttb p99,
        restart-to-first-bind (max-gated), hotspot dissipation
        (max-gated) and colo staleness p99 — registered against one
        SloRegistry and bulk-observed from the sample lists. to_dict's
        SLO blocks compute through this registry (shape pinned
        field-for-field by test), and the ChurnSimulator keeps a live
        instance feeding the koord_slo_* gauges and /debug/slo."""
        from koordinator_tpu_torch.obs.slo import SloRegistry

        reg = SloRegistry(burn_gauge=burn_gauge, met_gauge=met_gauge)
        reg.register("ttb_p99", target=self.slo_target_seconds,
                     percentile=99.0, unit="seconds")
        reg.observe_many("ttb_p99", self.ttb_seconds)
        reg.register("restart_to_first_bind",
                     target=self.restart_slo_seconds,
                     percentile=100.0, unit="seconds")
        reg.observe_many("restart_to_first_bind",
                         self.restart_to_first_bind_seconds)
        reg.register("hotspot_dissipate",
                     target=float(self.dissipate_slo_cycles),
                     percentile=100.0, unit="cycles")
        reg.observe_many("hotspot_dissipate",
                         [float(c) for c in self.dissipate_cycles])
        reg.register("colo_staleness",
                     target=float(self.colo_staleness_slo_cycles),
                     percentile=99.0, unit="cycles")
        reg.observe_many("colo_staleness",
                         [float(c) for c in self.colo_staleness_cycles])
        return reg

    @property
    def binding_log_sha256(self) -> str:
        h = hashlib.sha256()
        for line in self.binding_log:
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()

    def to_dict(self, include_log: bool = False) -> dict:
        # the SLO math routes through the koordwatch registry — ONE
        # implementation of percentile/target/burn arithmetic for the
        # sim report, the live gauges and /debug/slo. The JSON shape of
        # every pre-existing block is preserved field-for-field
        # (tests/test_koordwatch.py pins it against the legacy
        # expressions); scenario-specific met rules compose from the
        # registry's stats below.
        reg = self.slo_registry()
        ttb_o = reg.objective("ttb_p99")
        restart_o = reg.objective("restart_to_first_bind")
        dissipate_o = reg.objective("hotspot_dissipate")
        stale_o = reg.objective("colo_staleness")
        ttb = {
            "count": ttb_o.count(),
            "p50": round(ttb_o.quantile(50), 3),
            "p90": round(ttb_o.quantile(90), 3),
            "p99": round(ttb_o.quantile(99), 3),
            "max": round(ttb_o.maximum(), 3) if self.ttb_seconds
            else 0.0,
            "mean": round(ttb_o.mean(), 3)
            if self.ttb_seconds else 0.0,
        }
        out = {
            "scenario": self.scenario,
            "seed": self.seed,
            "cycles": self.cycles,
            "pods": {
                "created": self.pods_created,
                "bound": self.pods_bound,
                "departed": self.pods_departed,
                "reclaimed": self.pods_reclaimed,
                "drained": self.pods_drained,
                "shed": self.pods_shed,
                "requeued": self.pods_requeued,
                "final_pending": self.final_pending,
            },
            "time_to_bind_seconds": ttb,
            "slo": {
                "ttb_p99_target_seconds": self.slo_target_seconds,
                "met": (ttb["p99"] <= self.slo_target_seconds
                        if self.ttb_seconds else True),
                "overruns": self.slo_overruns,
            },
            "queue": {
                "max_pending": self.max_pending,
                "max_overflow": self.max_overflow,
                # koordwatch pending-queue visibility (per-cycle stats)
                "depth": {
                    "mean": (round(float(np.mean(
                        self.queue_depth_by_cycle)), 1)
                        if self.queue_depth_by_cycle else 0.0),
                    "max": (int(max(self.queue_depth_by_cycle))
                            if self.queue_depth_by_cycle else 0),
                },
                "oldest_wait_seconds": {
                    "p50": (round(float(np.percentile(np.asarray(
                        self.queue_oldest_wait_by_cycle), 50)), 3)
                        if self.queue_oldest_wait_by_cycle else 0.0),
                    "p99": (round(float(np.percentile(np.asarray(
                        self.queue_oldest_wait_by_cycle), 99)), 3)
                        if self.queue_oldest_wait_by_cycle else 0.0),
                    "max": (round(max(self.queue_oldest_wait_by_cycle), 3)
                            if self.queue_oldest_wait_by_cycle else 0.0),
                },
            },
            "invariant_breaches": len(self.invariant_breaches),
            "invariant_breach_samples": self.invariant_breaches[:5],
            "cycle_exceptions": len(self.cycle_exceptions),
            "cycle_exception_samples": self.cycle_exceptions[:5],
            "faults_injected": self.faults_injected,
            "sidecar_fallbacks": self.sidecar_fallbacks,
            "deadline_overruns": self.deadline_overruns,
            "restart": {
                "count": self.restarts,
                "to_first_bind_seconds": {
                    "count": restart_o.count(),
                    "p50": restart_o.quantile(50),
                    "p99": restart_o.quantile(99),
                    "max": restart_o.maximum(),
                },
                "to_first_bind_wall_seconds": [
                    round(w, 2)
                    for w in self.restart_to_first_bind_wall_seconds],
                # the wall split: compile vs pack attribution of
                # each recovery — the persistent compile cache's win
                # shows up as the compile component collapsing
                "restart_wall_compile_seconds": [
                    round(w, 2)
                    for w in self.restart_wall_compile_seconds],
                "restart_wall_pack_seconds": [
                    round(w, 3)
                    for w in self.restart_wall_pack_seconds],
                "steady_state_compiles": list(
                    self.restart_steady_state_compiles),
                "slo_seconds": self.restart_slo_seconds,
                # every restart must have rebound within the SLO; a
                # restart that never rebinds can never meet it
                "met": (self.restarts == 0 or (
                    self.restart_slo_seconds <= 0) or (
                    restart_o.count() == self.restarts
                    and restart_o.met())),
            },
            "degradation": {
                "transitions": self.ladder_transitions,
                "cycles_at_level": self.cycles_at_level,
                "final_level": self.final_level,
            },
            # koordwatch demotion profile: first-reason attribution, so
            # sum(by_reason.values()) == cycles_demoted exactly — zero
            # unattributed demotions (tests pin this)
            "demotions": {
                "cycles_demoted": self.cycles_demoted,
                "fraction_of_cycles": (
                    round(self.cycles_demoted / self.cycles, 3)
                    if self.cycles else 0.0),
                "by_reason": {
                    k: self.demotion_cycles_by_reason[k]
                    for k in sorted(self.demotion_cycles_by_reason)},
            },
            # koordwatch SLO registry dump: the same objectives the
            # blocks above gate, with burn rates — the /debug/slo view
            # of this run
            "slos": {
                name: {k: v for k, v in rec.items()
                       if k not in ("v", "kind", "slo")}
                for name, rec in reg.snapshot().items()},
            "flight_dumps": self.flight_dumps,
            "descheduler_runs": self.descheduler_runs,
            "rebalance": {
                "migration_jobs": self.migration_jobs_created,
                "pods_migrated": self.pods_migrated,
                "hotspot_events": self.hotspot_events,
                "hotspots_undissipated": self.hotspots_open,
                "time_to_dissipate_cycles": {
                    "count": dissipate_o.count(),
                    "p50": dissipate_o.quantile(50),
                    "p99": dissipate_o.quantile(99),
                    # int in the JSON, as the raw cycle counts are
                    "max": (max(self.dissipate_cycles)
                            if self.dissipate_cycles else 0),
                },
                "dissipate_slo_cycles": self.dissipate_slo_cycles,
                "dissipate_slo_met": (
                    self.dissipate_slo_cycles <= 0
                    or (self.hotspots_open == 0 and dissipate_o.met())),
            },
            "colo": {
                "manager_rounds": self.manager_rounds,
                "device_passes": self.colo_device_passes,
                "host_passes": self.colo_host_passes,
                "overcommit_shifts": self.overcommit_shifts,
                "batch_pods_bound": self.batch_pods_bound,
                "final_engine": self.colo_final_engine,
                "staleness_cycles": {
                    "count": stale_o.count(),
                    "p50": stale_o.quantile(50),
                    "p99": stale_o.quantile(99),
                    # int in the JSON, as the raw cycle counts are
                    "max": (max(self.colo_staleness_cycles)
                            if self.colo_staleness_cycles else 0),
                },
                "staleness_slo_cycles": self.colo_staleness_slo_cycles,
                "staleness_slo_met": stale_o.met(),
            },
            "binding_log_sha256": self.binding_log_sha256,
            "bindings": len(self.binding_log),
            "wall_seconds": round(self.wall_seconds, 2),
            # warm-up ladder + steady-state compile guard
            "warmup": dict(self.warmup),
            "steady_state_compile_flags": self.steady_state_compile_flags,
            "pipeline": {
                "device_idle_fraction": round(
                    self.device_idle_fraction, 3),
                "occupancy": (
                    round(self.device_busy_seconds
                          / self.cycle_wall_seconds, 3)
                    if self.cycle_wall_seconds > 0 else 0.0),
                "pods_per_sec_at_k": {
                    str(k): round(self.bound_by_waves.get(k, 0)
                                  / self.wall_by_waves[k], 1)
                    for k in sorted(self.wall_by_waves)
                    if self.wall_by_waves[k] > 0},
                "cycle_wall_seconds": round(self.cycle_wall_seconds, 2),
                "device_busy_seconds": round(self.device_busy_seconds, 2),
            },
        }
        if include_log:
            out["binding_log"] = list(self.binding_log)
        return out


class ChurnSimulator:
    """Drive one scenario on ``device`` ("cuda", or "cpu"). ``run()``
    returns the :class:`SimReport`."""

    def __init__(self, scenario: Scenario,
                 flight_dir: Optional[str] = None,
                 device: str = "cuda") -> None:
        import random

        self.device = device
        self.sc = scenario
        self.rng = random.Random(scenario.seed)
        self.store = ObjectStore()  # the simulator's own (never-failing) view
        self.plan = FaultPlan(scenario.faults)
        self.now = 1_000_000.0
        self.report = SimReport(
            scenario=scenario.name,
            seed=scenario.seed,
            cycles=scenario.cycles,
            slo_target_seconds=scenario.ttb_slo_seconds,
            dissipate_slo_cycles=scenario.hotspot_dissipate_slo_cycles,
            restart_slo_seconds=scenario.restart_slo_seconds)
        self._uid = 0
        self._arrival_time: Dict[str, float] = {}   # pod key -> sim arrival
        self._overflow: List[Pod] = []              # waiting room (FIFO)
        self._draining: List[Tuple[str, int]] = []  # (node, cycles left)
        self._gangs: List[Tuple[int, str, List[str]]] = (
            [])  # (finish cycle, PodGroup key, member pod keys)
        self._metric_flip_state = False
        # koordbalance: per-pod usage multipliers (hotspot-marked pods
        # run HOT; migration replacements inherit — the workload is hot
        # wherever it runs, so hotspots dissipate by SPREADING) and the
        # open hotspot events awaiting dissipation
        self._pod_mult: Dict[str, float] = {}
        self._hotspots: List[Tuple[int, set]] = []
        # koordcolo: the active prod-usage surge (end cycle, marked pod
        # keys) and the pending staleness probes — (metric-write cycle,
        # node -> batch-cpu baseline) awaiting the dispatch that first
        # observes the shifted overcommit
        self._surge: Optional[Tuple[int, set]] = None
        self._colo_pending: List[Tuple[int, Dict[str, int]]] = []
        self._dump_budget = {"invariant_breach": MAX_EVENT_DUMPS,
                             "slo_overrun": MAX_EVENT_DUMPS}
        # crash-restart (koordguard): sim time of the last restart still
        # awaiting its first bind, plus the dead schedulers' counters
        # folded into the final report
        self._flight_dir = flight_dir
        self._restart_time: Optional[float] = None
        self._restart_wall = 0.0
        self._prior_transitions: List[dict] = []
        self._prior_flight_dumps = 0
        self._prior_sidecar_fallbacks = 0
        self._prior_deadline_overruns = 0
        self._build_world()
        self._build_scheduler(flight_dir)
        # koordwatch: the LIVE SloRegistry — same objectives the report
        # computes from, observed as samples land, feeding the
        # koord_slo_burn_rate/koord_slo_met gauges and /debug/slo.
        # Built AFTER _build_scheduler: the colo staleness target lands
        # on the report there, and the registry must register the REAL
        # target, not the dataclass default.
        from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics

        self.slo = self.report.slo_registry(
            burn_gauge=scheduler_metrics.SLO_BURN_RATE,
            met_gauge=scheduler_metrics.SLO_MET)

    # ------------------------------------------------------------------
    # world + scheduler construction
    # ------------------------------------------------------------------
    def _build_world(self) -> None:
        import json

        for i in range(self.sc.nodes):
            node = Node(
                meta=ObjectMeta(name=f"n{i}", namespace=""),
                allocatable=ResourceList.of(cpu=16_000, memory=64 * GIB,
                                            pods=50))
            node.meta.labels[ZONE] = f"z{i % 3}"
            if i % 4 == 0:
                node.attachable_volume_limit = 3
            if i % 5 == 0:
                node.meta.annotations[
                    "node.koordinator.sh/reservation"] = json.dumps(
                        {"resources": {"cpu": "2", "memory": "4Gi"}})
            self.store.add(KIND_NODE, node)
            nm = NodeMetric(
                meta=ObjectMeta(name=f"n{i}", namespace=""),
                update_time=self.now,
                node_metric=NodeMetricInfo(
                    node_usage=ResourceList.of(
                        cpu=1_000 + 500 * (i % 3), memory=4 * GIB)))
            self.store.add(KIND_NODE_METRIC, nm)
        # pre-bound initial workload (plain pods, round-robin): load
        # events (hotspots, drain storms) have real mass from cycle 0
        # instead of waiting for arrivals to fill the cluster
        rng = self.rng
        for i in range(self.sc.initial_pods):
            uid = self._next_uid()
            pod = Pod(
                meta=ObjectMeta(name=f"w{uid}", namespace="sim",
                                uid=f"w{uid}",
                                creation_timestamp=self.now,
                                labels={"app": rng.choice("abc")},
                                owner_kind="ReplicaSet",
                                owner_name=f"rs-{uid % 13}"),
                spec=PodSpec(
                    node_name=f"n{i % self.sc.nodes}",
                    priority=(PRIORITY_BE
                              if rng.random() < self.sc.be_fraction
                              else PRIORITY_PROD),
                    requests=ResourceList.of(
                        cpu=rng.choice([250, 500, 1000, 2000]),
                        memory=rng.choice([1, 2, 4]) * GIB)),
                phase="Running")
            self.store.add(KIND_POD, pod)
        # two sibling elastic quotas; the rebalance event shifts max
        # capacity between them
        total_cpu = self.sc.nodes * 16_000
        for qname in ("q-a", "q-b"):
            self.store.add(KIND_ELASTIC_QUOTA, ElasticQuota(
                meta=ObjectMeta(name=qname, namespace="sim"),
                min=ResourceList.of(cpu=2_000, memory=8 * GIB),
                max=ResourceList.of(cpu=total_cpu // 2,
                                    memory=self.sc.nodes * 32 * GIB)))

    def _mesh(self):
        """The scenario's mesh: ``sc.mesh`` virtual shards of the sim's
        device (ids 0..mesh-1, the ids a device_loss fault names), or
        "off"."""
        if self.sc.mesh is None:
            return "off"
        from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

        return virtual_mesh(int(self.sc.mesh), self.device)

    def _build_scheduler(self, flight_dir: Optional[str]) -> None:
        from koordinator_tpu_torch.obs.flight import FlightRecorder
        from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
        from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler
        from koordinator_tpu_torch.scheduler.degrade import DegradationLadder

        sc = self.sc
        self.sched_store = FaultyStore(self.store, self.plan)
        self.sched = Scheduler(
            self.sched_store,
            waves=sc.waves,
            explain=sc.explain if sc.explain is not None else "off",
            mesh=self._mesh(),
            ladder=DegradationLadder(promote_after=sc.promote_after),
            dispatch_deadline_ms=(sc.dispatch_deadline_ms
                                  if sc.dispatch_deadline_ms is not None
                                  else 0),
            pack_overlap=sc.pack_overlap,
            device=self.device,
        )
        # koordlint rule 20, runtime half: after the warm-up ladder
        # completes, a step-cache miss in the hot path is flagged — the
        # report carries the per-restart (to first bind) and run totals
        # the coldstart gate asserts on
        self._steady_flags_since_restart = 0

        def _on_steady_miss(_key) -> None:
            self._steady_flags_since_restart += 1
            self.report.steady_state_compile_flags += 1

        self.sched.compile_miss_hook = _on_steady_miss
        self.sched.fault_injector = self.plan.dispatch_hook
        self.sched.sync_delay_injector = self.plan.sync_delay_hook
        self.sched.upload_fault_injector = self.plan.upload_hook
        if flight_dir:
            self.sched.flight = FlightRecorder(
                dump_dir=flight_dir,
                dump_counter=scheduler_metrics.FLIGHT_DUMPS)
        self.pipeline = (CyclePipeline(self.sched, enabled=True)
                         if sc.pipeline else None)
        self.manager = None
        if sc.colo_every > 0:
            from koordinator_tpu_torch.manager import Manager

            # the co-located koord-manager (koordcolo): shares the
            # scheduler's SnapshotCache subscriptions (the pack),
            # DeviceSnapshot (the uploads) and device — the third
            # consumer. It writes through the simulator's own store view
            # (manager store writes are not the faulted path under test)
            # and its lease never expires inside a run (one replica).
            self.manager = Manager(
                self.store, identity="sim-manager",
                scheduler=self.sched,
                colo=(sc.colo if sc.colo is not None else "on"),
                lease_duration_seconds=1e9)
            self.report.colo_staleness_slo_cycles = (
                sc.colo_staleness_slo_cycles)
        self.desch = None
        if sc.descheduler_every > 0:
            from koordinator_tpu_torch.descheduler.descheduler import (
                Descheduler,
            )

            # the descheduler shares the simulator's store view directly
            # (injected store faults target the scheduler's bind path)
            # and the SCHEDULER's snapshot: its LowNodeLoad view rides
            # the SnapshotCache subscription chain and the device
            # rebalance pass uploads through the scheduler's
            # DeviceSnapshot — the one-upload-two-consumers production
            # wiring (koordbalance)
            self.desch = Descheduler(self.store, scheduler=self.sched,
                                     rebalance=sc.rebalance)

    # ------------------------------------------------------------------
    # workload generation
    # ------------------------------------------------------------------
    def _next_uid(self) -> int:
        self._uid += 1
        return self._uid

    def _make_pod(self, prefix: str = "p") -> Pod:
        rng = self.rng
        uid = self._next_uid()
        name = f"{prefix}{uid}"
        labels = {"app": rng.choice("abc")}
        is_be = rng.random() < self.sc.be_fraction
        is_batch = (is_be and self.sc.batch_fraction > 0
                    and rng.random() < self.sc.batch_fraction)
        if is_batch:
            # koordcolo consumer: a batch-class pod whose requests live
            # on the overcommit axes the colo pass publishes — it binds
            # only where batch allocatable (capacity*reclaim% - usage)
            # currently covers it
            spec = PodSpec(
                priority=PRIORITY_BE,
                requests=ResourceList.of(
                    batch_cpu=rng.choice([500, 1000, 2000]),
                    batch_memory=rng.choice([1, 2]) * GIB))
        else:
            spec = PodSpec(
                priority=PRIORITY_BE if is_be else PRIORITY_PROD,
                requests=ResourceList.of(
                    cpu=rng.choice([250, 500, 1000, 2000]),
                    memory=rng.choice([1, 2, 4]) * GIB))
        # controller-owned (ReplicaSet analog): the eviction chain
        # categorically refuses bare pods, so ownerless sim pods would
        # make every migration vacuous. Deterministic owner from uid —
        # no extra rng draws, the arrival stream is unchanged.
        pod = Pod(meta=ObjectMeta(name=name, namespace="sim", uid=name,
                                  creation_timestamp=self.now,
                                  labels=labels,
                                  owner_kind="ReplicaSet",
                                  owner_name=f"rs-{uid % 13}"),
                  spec=spec)
        r = rng.random()
        if r < 0.10:
            pod.spec.host_ports.append(
                ("TCP", rng.choice([80, 443, 9090])))
        elif r < 0.20:
            pod.spec.pvc_names = [f"claim-{uid}"]
        elif r < 0.30:
            pod.spec.pod_anti_affinity.append(PodAffinityTerm(
                selector={"app": labels["app"]}, topology_key=ZONE))
        elif r < 0.40 and not is_be:
            pod.meta.labels[LABEL_QUOTA_NAME] = rng.choice(["q-a", "q-b"])
        return pod

    def _make_gang(self, storm_idx: int, cycle: int) -> List[Pod]:
        gname = f"gang-{storm_idx}-{self._next_uid()}"
        pg = PodGroup(
            meta=ObjectMeta(name=gname, namespace="sim",
                            creation_timestamp=self.now),
            min_member=self.sc.gang_size)
        self.store.add(KIND_POD_GROUP, pg)
        members = []
        for _ in range(self.sc.gang_size):
            uid = self._next_uid()
            members.append(Pod(
                meta=ObjectMeta(name=f"g{uid}", namespace="sim",
                                uid=f"g{uid}",
                                creation_timestamp=self.now,
                                labels={LABEL_POD_GROUP: gname},
                                # training jobs protect their members:
                                # the PDB-like guard keeps the
                                # descheduler's migration pass off gang
                                # pods (evicting one would break the
                                # all-or-nothing invariant mid-life)
                                annotations={
                                    "descheduler.alpha.kubernetes.io/"
                                    "evict": "false"}),
                spec=PodSpec(requests=ResourceList.of(
                    cpu=1000, memory=GIB))))
        if self.sc.gang_lifetime > 0:
            self._gangs.append((cycle + self.sc.gang_lifetime, pg.meta.key,
                                [m.meta.key for m in members]))
        return members

    def _finish_gangs(self, cycle: int) -> None:
        """Whole gangs complete as one unit (a training job finishing):
        every member and the PodGroup leave together — all-or-nothing in
        death as in life, so the invariant checker never sees a partial
        gang from lifecycle churn. Without this, immortal gangs slowly
        clog the cluster and strangle plain-pod throughput."""
        due = [g for g in self._gangs if g[0] <= cycle]
        if not due:
            return
        self._gangs = [g for g in self._gangs if g[0] > cycle]
        for _at, pg_key, member_keys in due:
            for key in member_keys:
                if self.store.get(KIND_POD, key) is not None:
                    self.store.delete(KIND_POD, key)
                self._arrival_time.pop(key, None)
                self.report.pods_departed += 1
            self.store.delete(KIND_POD_GROUP, pg_key)

    def _poisson(self, lam: float) -> int:
        """Knuth's seeded Poisson draw — numpy's generator would need a
        second seed stream; random.Random keeps ONE deterministic
        sequence for the whole scenario."""
        import math

        if lam <= 0:
            return 0
        L = math.exp(-lam)
        k, p = 0, 1.0
        while True:
            p *= self.rng.random()
            if p <= L:
                return k
            k += 1

    # ------------------------------------------------------------------
    # queue admission (backpressure)
    # ------------------------------------------------------------------
    def _pending_count(self) -> int:
        return sum(1 for p in self.store.list(KIND_POD)
                   if not p.is_assigned and not p.is_terminated)

    def _admit(self, fresh: List[Pod]) -> None:
        """Bounded-queue admission: the waiting room drains FIFO first
        (requeue), fresh arrivals line up behind it, and anything beyond
        the waiting room's own bound is shed (dropped, counted). Gang
        members bypass the cap as one unit — admitting half a gang would
        deadlock its barrier forever."""
        for pod in fresh:
            self._arrival_time.setdefault(pod.meta.key, self.now)
        gangs, plain = [], []
        for pod in fresh:
            (gangs if pod.gang_name else plain).append(pod)
        for pod in gangs:
            self.store.add(KIND_POD, pod)
        queue = self._overflow + plain
        budget = max(0, self.sc.queue_cap - self._pending_count())
        admit, wait = queue[:budget], queue[budget:]
        fresh_ids = {id(p) for p in plain}
        self.report.pods_requeued += sum(
            1 for p in admit if id(p) not in fresh_ids)
        for pod in admit:
            self.store.add(KIND_POD, pod)
        if len(wait) > self.sc.overflow_cap:
            shed = wait[self.sc.overflow_cap:]
            wait = wait[:self.sc.overflow_cap]
            self.report.pods_shed += len(shed)
            for pod in shed:
                self._arrival_time.pop(pod.meta.key, None)
        self._overflow = wait
        self.report.max_overflow = max(self.report.max_overflow,
                                       len(self._overflow))

    # ------------------------------------------------------------------
    # cluster events
    # ------------------------------------------------------------------
    def _running_pods(self, include_gang: bool = False) -> List[Pod]:
        return [p for p in self.store.list(KIND_POD)
                if p.is_assigned and not p.is_terminated
                and (include_gang or not p.gang_key)]

    def _departures(self) -> None:
        n = self._poisson(self.sc.departure_rate)
        if n <= 0:
            return
        running = self._running_pods()
        for pod in self.rng.sample(running, min(n, len(running))):
            self.store.delete(KIND_POD, pod.meta.key)
            self._arrival_time.pop(pod.meta.key, None)
            self._pod_mult.pop(pod.meta.key, None)
            self.report.pods_departed += 1

    def _drain_step(self, cycle: int) -> None:
        sc = self.sc
        # advance in-flight drains
        by_name = {n.meta.name: n for n in self.store.list(KIND_NODE)}
        still = []
        for name, left in self._draining:
            node = by_name.get(name)
            if node is None:
                continue
            if left > 1:
                still.append((name, left - 1))
                continue
            # drain complete: delete the node only when nothing is bound
            # to it anymore (gang pods are not drained — see below — and
            # deleting a node under them would orphan bound pods)
            bound = [p for p in self.store.list(KIND_POD)
                     if p.spec.node_name == name and p.is_assigned
                     and not p.is_terminated]
            if sc.drain_delete and not bound:
                self.store.delete(KIND_NODE, node.meta.key)
            else:
                node.unschedulable = False
                self.store.update(KIND_NODE, node)
        self._draining = still
        if sc.drain_every <= 0 or cycle == 0 or cycle % sc.drain_every:
            return
        # drains_per_event > 1 is the drain-storm shape: several nodes
        # cordoned in one event, their load concentrating on the
        # survivors (which the descheduler then has to rebalance)
        for _ in range(max(1, sc.drains_per_event)):
            draining_names = {n for n, _ in self._draining}
            candidates = [n for n in self.store.list(KIND_NODE)
                          if not n.unschedulable
                          and n.meta.name not in draining_names]
            if len(candidates) <= 2:
                return  # never drain the cluster below a working floor
            node = self.rng.choice(candidates)
            node.unschedulable = True
            self.store.update(KIND_NODE, node)
            self._draining.append((node.meta.name,
                                   sc.drain_uncordon_after))
            # evict (and requeue) the node's non-gang pods — the
            # reference drains via eviction + reschedule; gang members
            # stay (evicting one would legitimately break
            # all-or-nothing, which is gang lifecycle churn, not a
            # scheduler violation)
            evicted = []
            for pod in self.store.list(KIND_POD):
                if (pod.spec.node_name == node.meta.name
                        and pod.is_assigned
                        and not pod.is_terminated and not pod.gang_key):
                    self.store.delete(KIND_POD, pod.meta.key)
                    self._arrival_time.pop(pod.meta.key, None)
                    self._pod_mult.pop(pod.meta.key, None)
                    evicted.append(pod)
            self.report.pods_drained += len(evicted)
            self._admit([self._make_pod(prefix="re") for _ in evicted])

    def _spot_reclaim(self, cycle: int) -> None:
        sc = self.sc
        if sc.spot_reclaim_every <= 0 or cycle == 0 or (
                cycle % sc.spot_reclaim_every):
            return
        be = [p for p in self._running_pods()
              if (p.spec.priority or 0) < 9000]
        victims = self.rng.sample(be, min(sc.spot_reclaim_count, len(be)))
        for pod in victims:
            self.store.delete(KIND_POD, pod.meta.key)
            self._arrival_time.pop(pod.meta.key, None)
            self._pod_mult.pop(pod.meta.key, None)
            self.report.pods_reclaimed += 1
        # the reclaimed workload comes straight back as fresh arrivals —
        # spot churn, not capacity loss
        self._admit([self._make_pod(prefix="sp") for _ in victims])

    def _metric_flip(self, cycle: int) -> None:
        sc = self.sc
        if sc.metric_flip_every <= 0 or cycle == 0 or (
                cycle % sc.metric_flip_every):
            return
        self._metric_flip_state = not self._metric_flip_state
        for i, nm in enumerate(self.store.list(KIND_NODE_METRIC)):
            if i % 2 == (0 if self._metric_flip_state else 1):
                nm.update_time = self.now  # fresh
                nm.node_metric.node_usage = ResourceList.of(
                    cpu=1_000 + 250 * (i % 5), memory=4 * GIB)
            else:
                nm.update_time = self.now - 10_000.0  # expired
            self.store.update(KIND_NODE_METRIC, nm)

    # ------------------------------------------------------------------
    # rebalance-under-load events (koordbalance)
    # ------------------------------------------------------------------
    def _hotspot_step(self, cycle: int) -> None:
        """Every hotspot_every cycles: the pods on a few seeded nodes
        turn HOT (usage multiplier) — real overload from mis-estimated
        workloads, which only migration can dissipate. Gang pods are
        skipped (their guard makes them unevictable, so their heat could
        never dissipate)."""
        sc = self.sc
        if sc.hotspot_every <= 0 or cycle == 0 or cycle % sc.hotspot_every:
            return
        nodes = [n for n in self.store.list(KIND_NODE)
                 if not n.unschedulable]
        if not nodes:
            return
        # the MOST-LOADED nodes flip hot (deterministic: count desc,
        # name): a hotspot on an empty node is not a hotspot
        counts: Dict[str, int] = {}
        for pod in self.store.list(KIND_POD):
            if pod.is_assigned and not pod.is_terminated and not pod.gang_key:
                counts[pod.spec.node_name] = counts.get(
                    pod.spec.node_name, 0) + 1
        nodes.sort(key=lambda n: (-counts.get(n.meta.name, 0),
                                  n.meta.name))
        chosen = nodes[: sc.hotspot_nodes]
        names = {n.meta.name for n in chosen}
        marked = 0
        for pod in self.store.list(KIND_POD):
            if (pod.is_assigned and not pod.is_terminated
                    and pod.spec.node_name in names and not pod.gang_key):
                self._pod_mult[pod.meta.key] = sc.hotspot_multiplier
                marked += 1
        if marked:
            self._hotspots.append((cycle, names))
            self.report.hotspot_events += 1

    # ------------------------------------------------------------------
    # overcommit-shift events (koordcolo)
    # ------------------------------------------------------------------
    def _batch_cpu_baseline(self, names) -> Dict[str, int]:
        out = {}
        for name in names:
            node = self.store.get(KIND_NODE, f"/{name}")
            if node is not None:
                out[name] = node.allocatable[
                    "kubernetes.io/batch-cpu"] or 0
        return out

    def _overcommit_surge(self, cycle: int) -> None:
        """Prod-usage surge: the PROD pods on the busiest nodes run hot
        for overcommit_surge_cycles (usage-derived NodeMetrics rise, the
        colo pass shrinks batch allocatable), then recede. Both edges
        record a staleness probe: the metric-write cycle plus the nodes'
        batch-cpu baseline — resolved by the first dispatch that runs
        against a changed value."""
        sc = self.sc
        if sc.overcommit_surge_every <= 0:
            return
        if self._surge is not None:
            end, keys = self._surge
            if cycle >= end:
                names = set()
                for key in keys:
                    self._pod_mult.pop(key, None)
                    pod = self.store.get(KIND_POD, key)
                    if pod is not None and pod.spec.node_name:
                        names.add(pod.spec.node_name)
                self._surge = None
                self.report.overcommit_shifts += 1
                self._colo_pending.append(
                    (cycle, self._batch_cpu_baseline(names)))
            return
        if cycle == 0 or cycle % sc.overcommit_surge_every:
            return
        counts: Dict[str, int] = {}
        for pod in self.store.list(KIND_POD):
            if (pod.is_assigned and not pod.is_terminated
                    and not pod.gang_key
                    and (pod.spec.priority or 0) >= 9000):
                counts[pod.spec.node_name] = counts.get(
                    pod.spec.node_name, 0) + 1
        nodes = sorted(counts, key=lambda n: (-counts[n], n))
        chosen = set(nodes[: sc.overcommit_surge_nodes])
        if not chosen:
            return
        keys = set()
        for pod in self.store.list(KIND_POD):
            if (pod.is_assigned and not pod.is_terminated
                    and pod.spec.node_name in chosen and not pod.gang_key
                    and (pod.spec.priority or 0) >= 9000):
                self._pod_mult[pod.meta.key] = (
                    sc.overcommit_surge_multiplier)
                keys.add(pod.meta.key)
        if keys:
            self._surge = (cycle + sc.overcommit_surge_cycles, keys)
            self.report.overcommit_shifts += 1
            self._colo_pending.append(
                (cycle, self._batch_cpu_baseline(chosen)))

    def _observe_colo_staleness(self, cycle: int) -> None:
        """Resolve pending staleness probes: the first cycle whose
        dispatch ran against a changed batch-cpu on any probed node
        closes the probe at (cycle - write cycle)."""
        still = []
        for write_cycle, baseline in self._colo_pending:
            if not baseline:
                # every probed node departed before the edge landed:
                # nothing left to observe — drop rather than park the
                # probe forever (the SLO must not claim unmeasured edges)
                continue
            changed = False
            for n, base in baseline.items():
                node = self.store.get(KIND_NODE, f"/{n}")
                if node is not None and (
                        node.allocatable["kubernetes.io/batch-cpu"]
                        or 0) != base:
                    changed = True
                    break
            if changed:
                self.report.colo_staleness_cycles.append(
                    cycle - write_cycle)
                self.slo.observe("colo_staleness",
                                 float(cycle - write_cycle))
            else:
                still.append((write_cycle, baseline))
        self._colo_pending = still

    def _refresh_usage_metrics(self) -> None:
        """metrics_follow_usage: NodeMetric usage derives from the pods
        actually bound to each node (x their hot multipliers), so
        migrating load away genuinely lowers the source node's reading.
        Metrics the flip event deliberately expired stay expired."""
        sc = self.sc
        if not sc.metrics_follow_usage:
            return
        cpu_by: Dict[str, float] = {}
        mem_by: Dict[str, float] = {}
        for pod in self.store.list(KIND_POD):
            if not pod.is_assigned or pod.is_terminated:
                continue
            mult = self._pod_mult.get(pod.meta.key, 1.0)
            node = pod.spec.node_name
            cpu_by[node] = cpu_by.get(node, 0.0) + (
                pod.spec.requests.get("cpu", 0) or 0) * mult
            mem_by[node] = mem_by.get(node, 0.0) + (
                pod.spec.requests.get("memory", 0) or 0) * mult
        for nm in self.store.list(KIND_NODE_METRIC):
            expired = nm.update_time <= self.now - 9_000.0
            nm.node_metric = NodeMetricInfo(node_usage=ResourceList.of(
                cpu=sc.usage_idle_cpu + int(
                    cpu_by.get(nm.meta.name, 0.0) * sc.usage_fraction),
                memory=2 * GIB + int(
                    mem_by.get(nm.meta.name, 0.0) * sc.usage_fraction)))
            if not expired:
                nm.update_time = self.now
            self.store.update(KIND_NODE_METRIC, nm)

    def _node_is_hot(self, name: str) -> bool:
        """LowNodeLoad's default high thresholds (70% cpu / 80% mem)
        against the current metric — the dissipation probe."""
        node = self.store.get(KIND_NODE, f"/{name}")
        nm = self.store.get(KIND_NODE_METRIC, f"/{name}")
        if node is None or nm is None:
            return False
        alloc = node.allocatable
        usage = nm.node_metric.node_usage
        cpu_pct = (usage.get("cpu", 0) or 0) * 100.0 / max(
            alloc.get("cpu", 0) or 1, 1)
        mem_pct = (usage.get("memory", 0) or 0) * 100.0 / max(
            alloc.get("memory", 0) or 1, 1)
        return cpu_pct > 70.0 or mem_pct > 80.0

    def _note_hotspot_dissipation(self, cycle: int) -> None:
        still: List[Tuple[int, set]] = []
        for event_cycle, names in self._hotspots:
            if (cycle > event_cycle
                    and not any(self._node_is_hot(n) for n in names)):
                self.report.dissipate_cycles.append(cycle - event_cycle)
                self.slo.observe("hotspot_dissipate",
                                 float(cycle - event_cycle))
            else:
                still.append((event_cycle, names))
        self._hotspots = still

    def _sweep_migrated(self) -> None:
        """The workload-controller analog for migration evictions: a pod
        the migration controller evicted (Failed + the evicted
        annotation) is replaced by a fresh replica with the same labels
        and requests — which the scheduler's nomination pre-pass matches
        to the migration's replacement Reservation. The replacement
        inherits the hot multiplier: the workload is hot wherever it
        runs, so hotspots dissipate by SPREADING, not by vanishing."""
        evicted = [p for p in self.store.list(KIND_POD)
                   if p.phase == "Failed"
                   and "koordinator.sh/evicted" in p.meta.annotations]
        if not evicted:
            return
        fresh: List[Pod] = []
        for pod in evicted:
            self.store.delete(KIND_POD, pod.meta.key)
            mult = self._pod_mult.pop(pod.meta.key, 1.0)
            self._arrival_time.pop(pod.meta.key, None)
            self.report.pods_migrated += 1
            uid = self._next_uid()
            repl = Pod(
                meta=ObjectMeta(name=f"mg{uid}", namespace="sim",
                                uid=f"mg{uid}",
                                creation_timestamp=self.now,
                                labels=dict(pod.meta.labels),
                                owner_kind=pod.meta.owner_kind,
                                owner_name=pod.meta.owner_name),
                spec=PodSpec(priority=pod.spec.priority,
                             requests=pod.spec.requests.copy()))
            if mult != 1.0:
                self._pod_mult[repl.meta.key] = mult
            fresh.append(repl)
        self._admit(fresh)

    def _quota_rebalance(self, cycle: int) -> None:
        sc = self.sc
        if sc.quota_rebalance_every <= 0 or cycle == 0 or (
                cycle % sc.quota_rebalance_every):
            return
        total_cpu = max(1, len(self.store.list(KIND_NODE))) * 16_000
        quotas = sorted(self.store.list(KIND_ELASTIC_QUOTA),
                        key=lambda q: q.meta.name)
        if len(quotas) < 2:
            return
        # shift capacity: one quota tight, the other generous, alternating
        tight, wide = ((quotas[0], quotas[1])
                       if (cycle // sc.quota_rebalance_every) % 2
                       else (quotas[1], quotas[0]))
        tight.max = ResourceList.of(cpu=total_cpu // 8,
                                    memory=len(quotas) * 16 * GIB)
        wide.max = ResourceList.of(cpu=total_cpu,
                                   memory=len(quotas) * 64 * GIB)
        self.store.update(KIND_ELASTIC_QUOTA, tight)
        self.store.update(KIND_ELASTIC_QUOTA, wide)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def _dump(self, reason: str) -> None:
        if self._dump_budget.get(reason, 0) > 0:
            self._dump_budget[reason] -= 1
            self.sched.flight.dump(reason)

    def _crash_restart(self, cycle: int) -> None:
        """The crash-restart event (koordguard): the scheduler process
        dies mid-soak — every watch its store view registered is severed
        (the apiserver dropping a dead client), and ALL in-process state
        goes with the object graph: device buffers, compiled step
        caches, the pack memo, plugin assumed/quota state. A fresh
        Scheduler is then constructed against the SURVIVING store: its
        plugins and SnapshotCache replay list-then-watch, so the first
        cycle re-derives assumed/quota/gang state from store-visible
        binds. The report tracks sim time from here to the fresh
        scheduler's first bind (the restart-to-first-bind SLO)."""
        old = self.sched
        self._prior_transitions.extend(old.ladder.transitions)
        self._prior_flight_dumps += old.flight.dumps
        self._prior_sidecar_fallbacks += old.sidecar_fallbacks
        self._prior_deadline_overruns += old.dispatch_watchdog.overruns
        if self.desch is not None and self.desch.rebalancer is not None:
            # the descheduler dies with the scheduler process: its
            # rebalance-pass overruns must survive into the report too
            self._prior_deadline_overruns += (
                self.desch.rebalancer.dispatch_watchdog.overruns)
        if self.manager is not None and self.manager.colo is not None:
            # so do the co-located manager's colo-pass overruns
            self._prior_deadline_overruns += (
                self.manager.colo.dispatch_watchdog.overruns)
        self.sched_store.sever()
        self.report.restarts += 1
        # the crash is anchored at the END of the previous cycle: a
        # fresh scheduler that binds within its first cycle reads one
        # dt of sim-clock recovery, not a degenerate 0.0
        self._restart_time = self.now - self.sc.dt_seconds
        self._restart_wall = time.perf_counter()
        self._build_scheduler(self._flight_dir)
        logger.warning("sim cycle %d: scheduler crash-restart (store "
                       "survives, scheduler state dropped)", cycle)

    def _account_bind(self, cycle: int, pod_key: str,
                      node_name: str) -> None:
        """One committed binding into the report: phase bookkeeping is
        the caller's; this records ttb (+ SLO overrun), the bound
        counter, restart recovery, and the binding-log line."""
        if self._restart_time is not None:
            recovery = self.now - self._restart_time
            self.report.restart_to_first_bind_seconds.append(recovery)
            self.slo.observe("restart_to_first_bind", recovery)
            self.report.restart_to_first_bind_wall_seconds.append(
                time.perf_counter() - self._restart_wall)
            # the recovery wall split: the fresh scheduler's
            # cumulative compile/pack wall IS the restart's — it was
            # born at the crash, and warm-up ran inside this window
            self.report.restart_wall_compile_seconds.append(
                self.sched.compile_wall_seconds)
            self.report.restart_wall_pack_seconds.append(
                self.sched.pack_wall_seconds)
            self.report.restart_steady_state_compiles.append(
                self._steady_flags_since_restart)
            self._restart_time = None
        arrived = self._arrival_time.pop(pod_key, None)
        if arrived is not None:
            ttb = self.now - arrived
            self.report.ttb_seconds.append(ttb)
            self.slo.observe("ttb_p99", ttb)
            if ttb > self.sc.ttb_slo_seconds:
                self.report.slo_overruns += 1
                self._dump("slo_overrun")
        self.report.pods_bound += 1
        self.report.binding_log.append(
            f"{cycle}\t{pod_key}\t{node_name}")

    def _reconcile_store_binds(self, cycle: int):
        """After a mid-cycle exception: bindings the cycle applied before
        the wreck are already store-visible (a store-write fault raises
        mid-bind-loop), but never reached ``result.bound``. Sweep the
        tracked pending pods and account any the store now shows
        assigned, exactly as the normal path would — arrival order, the
        seeded run's deterministic iteration order. Returns the
        reconciled keys so the invariant check (batch-bind discipline
        included) sees the partial cycle's binds."""
        bound = []
        for key in list(self._arrival_time):
            pod = self.store.get(KIND_POD, key)
            if pod is None or not pod.is_assigned or pod.is_terminated:
                continue
            if pod.phase != "Running":
                pod.phase = "Running"
                self.store.update(KIND_POD, pod)
            self._account_bind(cycle, key, pod.spec.node_name)
            bound.append(key)
        return bound

    def _check_invariants(self, cycle: int, bound_keys=()) -> None:
        breaches = check_invariants(
            self.store, now=self.now,
            batch_shrink_grace=self.sc.colo_every > 0)
        if self.sc.colo_every > 0 and bound_keys:
            from koordinator_tpu_torch.sim.invariants import (
                check_batch_bind_discipline,
            )

            breaches = breaches + check_batch_bind_discipline(
                self.store, bound_keys)
        if breaches:
            self.report.invariant_breaches.extend(
                f"cycle {cycle}: {b}" for b in breaches)
            self._dump("invariant_breach")

    def _run_one_cycle(self, cycle: int) -> None:
        sc = self.sc
        self.now += sc.dt_seconds
        if cycle in sc.restart_at:
            self._crash_restart(cycle)
        self.plan.begin_cycle(cycle)
        # sidecar fault window: swap a dead client in (the sidecar layer
        # must degrade to the local step, never wedge the cycle)
        self.sched._sidecar_client = (DeadSidecarClient()
                                      if self.plan.sidecar_armed() else None)
        # cluster events before arrivals, arrivals before the cycle —
        # a fixed order is what makes the run reproducible
        self._finish_gangs(cycle)
        self._drain_step(cycle)
        self._spot_reclaim(cycle)
        self._metric_flip(cycle)
        self._quota_rebalance(cycle)
        self._departures()
        self._hotspot_step(cycle)
        self._overcommit_surge(cycle)
        self._refresh_usage_metrics()
        self._note_hotspot_dissipation(cycle)
        fresh = [self._make_pod() for _ in range(
            self._poisson(sc.arrival_rate))]
        if sc.burst_every > 0 and cycle > 0 and cycle % sc.burst_every == 0:
            fresh.extend(self._make_pod(prefix="b")
                         for _ in range(sc.burst_size))
        if sc.gang_every > 0 and cycle > 0 and cycle % sc.gang_every == 0:
            for s in range(sc.gangs_per_storm):
                fresh.extend(self._make_gang(cycle * 10 + s, cycle))
        self.report.pods_created += len(fresh)
        self._admit(fresh)
        # koordwatch pending-queue visibility: the depth this cycle's
        # dispatch will drain, plus the oldest enqueued entry's age
        # (store-pending AND waiting-room pods — both are enqueued)
        depth = self._pending_count()
        self.report.max_pending = max(self.report.max_pending, depth)
        self.report.queue_depth_by_cycle.append(depth)
        self.report.queue_oldest_wait_by_cycle.append(
            self.now - min(self._arrival_time.values())
            if self._arrival_time else 0.0)

        # koordcolo: the manager tick BEFORE the dispatch — the very
        # next scheduling dispatch consumes the overcommit this pass
        # publishes (the closed-loop ordering the acceptance pins)
        if (self.manager is not None
                and cycle % self.sc.colo_every == 0):
            self.manager.tick(now=self.now)
            self.report.manager_rounds += 1
            stats = (self.manager.colo.last_pass_stats
                     if self.manager.colo is not None else {})
            if stats.get("engine") == "device":
                self.report.colo_device_passes += 1
            elif stats.get("engine"):
                self.report.colo_host_passes += 1

        driver = self.pipeline if self.pipeline is not None else self.sched
        t_cycle = time.perf_counter()
        try:
            result = driver.run_cycle(now=self.now)
        except NotImplementedError:
            raise  # a path the port does not have yet: never absorbed
        except Exception as exc:  # the flight recorder already dumped
            # the wrecked cycle's wall still counts (device idle in it)
            self.report.cycle_wall_seconds += (
                time.perf_counter() - t_cycle)
            self.report.cycle_exceptions.append(
                f"cycle {cycle}: {type(exc).__name__}: {exc}")
            logger.warning("sim cycle %d raised: %s", cycle, exc)
            # bindings applied before the wreck are already store-visible
            # (e.g. a store-write fault mid-bind-loop): reconcile them
            # into the report so binding_log/ttb/pods_bound match the
            # store, then still run the invariant check — a partially
            # applied cycle is exactly when it matters
            bound_keys = self._reconcile_store_binds(cycle)
            self._check_invariants(cycle, bound_keys=bound_keys)
            return
        wall = time.perf_counter() - t_cycle
        self.report.cycle_wall_seconds += wall
        self.report.device_busy_seconds += result.device_busy_seconds
        # koordwatch demotion profile: a cycle that ran below its
        # configured level carries its structured reasons; attribute the
        # cycle to the FIRST (the chokepoint appends in hit order), so
        # per-reason counts sum exactly to cycles_demoted
        if result.demotions:
            self.report.cycles_demoted += 1
            reason = result.demotions[0]
            self.report.demotion_cycles_by_reason[reason] = (
                self.report.demotion_cycles_by_reason.get(reason, 0) + 1)
        k = max(1, int(result.waves))
        self.report.wall_by_waves[k] = (
            self.report.wall_by_waves.get(k, 0.0) + wall)
        self.report.bound_by_waves[k] = (
            self.report.bound_by_waves.get(k, 0) + len(result.bound))
        for b in result.bound:
            pod = self.store.get(KIND_POD, b.pod_key)
            if pod is None or pod.is_terminated:
                # bound and then preempted/evicted within the SAME cycle
                # (a later wave's preemption chose it as a victim):
                # flipping it back to Running would resurrect a
                # terminated pod in place and overcommit its node
                continue
            pod.phase = "Running"  # bind -> Running, as the kubelet would
            self.store.update(KIND_POD, pod)
            self._account_bind(cycle, b.pod_key, b.node_name)
            if (pod.spec.requests["kubernetes.io/batch-cpu"]
                    or pod.spec.requests["kubernetes.io/batch-memory"]):
                self.report.batch_pods_bound += 1
        if self.manager is not None:
            self._observe_colo_staleness(cycle)
        if (self.desch is not None and cycle > 0
                and cycle % sc.descheduler_every == 0):
            try:
                out = self.desch.run_once(now=self.now)
                self.report.descheduler_runs += 1
                self.report.migration_jobs_created += out.get(
                    "jobs_created", 0)
            except NotImplementedError:
                raise  # a path the port does not have yet: never absorbed
            except Exception as exc:
                self.report.cycle_exceptions.append(
                    f"cycle {cycle} descheduler: "
                    f"{type(exc).__name__}: {exc}")
            # the workload-controller analog replaces migration-evicted
            # pods (they re-enter the queue and consume the replacement
            # reservations via the nomination pre-pass)
            self._sweep_migrated()
        # invariants run AFTER the descheduler so the migration-job and
        # reservation double-booking checks see its writes every cycle
        self._check_invariants(
            cycle, bound_keys=[b.pod_key for b in result.bound])

    def run(self) -> SimReport:
        self._t0 = time.perf_counter()
        for cycle in range(self.sc.cycles):
            self._run_one_cycle(cycle)
        return self.run_report()

    def run_report(self) -> SimReport:
        """Finalize the report — run() is loop + run_report(); tests
        that drive cycles manually (inspecting scheduler state between
        them) call this directly."""
        if self.pipeline is not None:
            self.pipeline.flush()
        self.report.wall_seconds = (
            time.perf_counter() - getattr(self, "_t0", time.perf_counter()))
        self.report.final_pending = self._pending_count()
        self.report.hotspots_open = len(self._hotspots)
        self.report.faults_injected = len(self.plan.injected)
        self.report.sidecar_fallbacks = (
            self._prior_sidecar_fallbacks + self.sched.sidecar_fallbacks)
        self.report.ladder_transitions = (
            self._prior_transitions + list(self.sched.ladder.transitions))
        self.report.final_level = self.sched.ladder.level_name
        self.report.flight_dumps = (
            self._prior_flight_dumps + self.sched.flight.dumps)
        overruns = (self._prior_deadline_overruns
                    + self.sched.dispatch_watchdog.overruns)
        if self.desch is not None and self.desch.rebalancer is not None:
            overruns += self.desch.rebalancer.dispatch_watchdog.overruns
            rb = self.desch.rebalancer.stats
            self.report.rebalance_passes = {
                "device": rb["device_passes"], "host": rb["host_passes"],
                "failures": self.desch.rebalancer.failures}
        if self.manager is not None and self.manager.colo is not None:
            overruns += self.manager.colo.dispatch_watchdog.overruns
            self.report.colo_final_engine = str(
                self.manager.colo.last_pass_stats.get("engine", ""))
        self.report.deadline_overruns = overruns
        # koordwatch timeline: the final scheduler's idle fraction (the
        # ring is per-scheduler, so a crash-restart resets the window —
        # the A/B pack-overlap pair runs restart-free soaks)
        self.report.device_idle_fraction = self.sched.timeline.idle_fraction()
        if self.sched.warmup is not None:
            self.report.warmup = dict(self.sched.warmup.stats)
        return self.report


def run_scenario(scenario: Scenario,
                 flight_dir: Optional[str] = None,
                 device: str = "cuda") -> SimReport:
    """Build + run in one call on ``device``; the harness tracks the
    per-cycle ladder residency histogram here so every caller gets it."""
    sim = ChurnSimulator(scenario, flight_dir=flight_dir, device=device)
    # per-cycle level residency: wrap the cycle runner
    counts: Dict[str, int] = {}
    orig = sim._run_one_cycle

    def counted(cycle: int) -> None:
        orig(cycle)
        name = sim.sched.ladder.level_name
        counts[name] = counts.get(name, 0) + 1

    sim._run_one_cycle = counted
    report = sim.run()
    report.cycles_at_level = counts
    return report
