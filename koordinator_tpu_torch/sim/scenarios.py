"""Named simulation scenarios: the workload catalog.

Every scenario is a fully-seeded :class:`Scenario` — same name + same
seed means the same arrival stream, the same cluster events, the same
fault schedule, and (because the scheduler itself is deterministic on a
fixed backend) a byte-stable binding log. The catalog is the JAX
package's, copied as data: tests/test_torch_sim.py holds the port's
binding logs to the JAX package's, scenario by scenario.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from koordinator_tpu_torch.sim.faults import Fault


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One reproducible churn workload. Times are sim-clock seconds
    (the simulator advances ``dt_seconds`` per cycle); every `_every`
    knob is in cycles, 0 = event disabled."""

    name: str
    description: str = ""
    seed: int = 11
    cycles: int = 200
    nodes: int = 12
    initial_pods: int = 0         # pre-bound plain pods (round-robin)
    #                               so load events bite from cycle 0
    dt_seconds: float = 5.0
    # arrivals / departures
    arrival_rate: float = 6.0     # Poisson mean pods per cycle
    be_fraction: float = 0.35     # arrivals that are best-effort (spot prey)
    departure_rate: float = 2.0   # Poisson mean running-pod deletions/cycle
    burst_every: int = 0          # burst queue: +burst_size pods at once
    burst_size: int = 40
    gang_every: int = 0           # gang storm cadence
    gang_size: int = 3
    gangs_per_storm: int = 1
    gang_lifetime: int = 0        # cycles until a whole gang finishes
    #                               (0 = gangs run forever)
    # cluster events
    drain_every: int = 0          # cordon a node, evict its pods, then
    drain_delete: bool = False    # ... delete it (True) or uncordon later
    drain_uncordon_after: int = 6
    drains_per_event: int = 1     # nodes cordoned per drain event
    #                               (>1 = the drain-storm shape)
    spot_reclaim_every: int = 0   # evict bound BE pods (re-queued as new)
    spot_reclaim_count: int = 3
    metric_flip_every: int = 0    # alternate NodeMetric fresh <-> expired
    quota_rebalance_every: int = 0  # shrink/grow quota max
    # rebalance-under-load (koordbalance): NodeMetric usage derived from
    # the pods actually bound to each node, so migrating load away
    # genuinely lowers the source node's reading
    metrics_follow_usage: bool = False
    usage_fraction: float = 0.6   # measured usage per unit of request
    usage_idle_cpu: int = 500     # per-node idle floor (milli-cores)
    hotspot_every: int = 0        # skew event: pods on chosen nodes run HOT
    hotspot_nodes: int = 2        # nodes skewed per event
    hotspot_multiplier: float = 2.5  # hot pods' usage multiplier
    hotspot_dissipate_slo_cycles: int = 0  # 0 = report-only
    # backpressure
    queue_cap: int = 512          # max pending pods admitted to the store
    overflow_cap: int = 2048      # waiting-room bound; beyond it -> shed
    # koordguard: scheduler crash-restart events (the harness tears the
    # Scheduler down at these cycles and rebuilds it against the
    # surviving store) and the recovery SLO; dispatch deadline in ms
    # (None pins it OFF for determinism — latency faults need it armed)
    restart_at: Tuple[int, ...] = ()
    restart_slo_seconds: float = 0.0   # 0 = report-only
    dispatch_deadline_ms: Optional[float] = None
    # koordcolo: the colocation control loop in the sim — a co-located
    # koord-manager (sharing the scheduler's snapshot) recomputes
    # batch/mid overcommit + runtime quotas every colo_every cycles
    colo_every: int = 0           # manager tick cadence (0 = no manager)
    colo: Optional[str] = None    # KOORD_TPU_COLO pin (None = env default)
    batch_fraction: float = 0.0   # BE arrivals requesting batch-cpu/mem
    #                               (the overcommit consumers)
    overcommit_surge_every: int = 0   # prod-usage surge event cadence
    overcommit_surge_cycles: int = 8  # cycles until the surge recedes
    overcommit_surge_nodes: int = 3   # nodes whose prod pods run hot
    overcommit_surge_multiplier: float = 3.0
    colo_staleness_slo_cycles: int = 0  # metric write -> observing
    #                                     dispatch, p99 target (0 = off)
    # SLOs
    ttb_slo_seconds: float = 120.0  # time-to-bind p99 target
    # scheduler configuration under test
    waves: object = 1             # Scheduler(waves=...): int or "auto"
    pack_overlap: Optional[bool] = None  # KOORD_TPU_PACK_OVERLAP pin
    #                               (None = env default; the bench
    #                               --churn A/B pair pins on/off)
    explain: Optional[str] = None  # None keeps explain off ("off" pin)
    mesh: Optional[int] = None    # KOORD_TPU_MESH-style device count
    pipeline: bool = False        # drive through CyclePipeline
    descheduler_every: int = 0    # run the real descheduler every N cycles
    rebalance: Optional[str] = None  # KOORD_TPU_REBALANCE pin for the
    #                                  descheduler (None = env default)
    promote_after: int = 8        # ladder clean-cycle re-promotion probe
    # fault schedule
    faults: Tuple[Fault, ...] = ()

    def resolved(self, cycles: Optional[int] = None,
                 seed: Optional[int] = None,
                 waves=None) -> "Scenario":
        """CLI overrides without losing the catalog definition."""
        changes = {}
        if cycles is not None:
            changes["cycles"] = cycles
        if seed is not None:
            changes["seed"] = seed
        if waves is not None:
            changes["waves"] = waves
        return dataclasses.replace(self, **changes) if changes else self


SCENARIOS: Dict[str, Scenario] = {}


def _register(sc: Scenario) -> Scenario:
    if sc.name in SCENARIOS:
        raise ValueError(f"duplicate scenario {sc.name!r}")
    SCENARIOS[sc.name] = sc
    return sc


_register(Scenario(
    name="smoke",
    description=(
        "tier-1 / lint gate: ~50 cycles of light churn with one gang "
        "storm cadence, a node drain, metric flips, and a dispatch-fault "
        "burst that demotes the ladder to the host fallback and back — "
        "fixed seed, byte-stable binding log, zero invariant breaches"),
    seed=11, cycles=50, nodes=10,
    arrival_rate=5.0, departure_rate=1.5,
    gang_every=9, gang_size=3,
    drain_every=17, drain_uncordon_after=5,
    metric_flip_every=13,
    queue_cap=128,
    ttb_slo_seconds=180.0,
    promote_after=6,
    faults=(Fault(cycle=20, kind="dispatch", count=3,
                  message="smoke dispatch fault"),),
))

_register(Scenario(
    name="soak",
    description=(
        "the 1000-cycle acceptance soak (slow): sustained Poisson "
        "traffic with gang storms, bursts, drains, spot reclamation, "
        "metric flips, quota rebalances, and dispatch/store-write "
        "faults mid-soak; emits the CHURN SLO report"),
    seed=7, cycles=1000, nodes=16, initial_pods=120,
    # near-capacity but sustainable: ~16x16 cores hold ~270 of these
    # pods; steady arrivals (+ gang storms and bursts on top) roughly
    # match departures + reclamation so the queue breathes instead of
    # diverging — the bursts are the stress, not a monotone backlog
    arrival_rate=3.0, departure_rate=4.0, be_fraction=0.4,
    burst_every=97, burst_size=60,
    gang_every=23, gang_size=4, gangs_per_storm=2, gang_lifetime=40,
    drain_every=61, drain_uncordon_after=8,
    spot_reclaim_every=43, spot_reclaim_count=4,
    metric_flip_every=29,
    quota_rebalance_every=53,
    queue_cap=384, overflow_cap=1536,
    ttb_slo_seconds=300.0,
    waves="auto",
    # the citable occupancy/throughput pair runs through the production
    # CyclePipeline: deferred condition writes drain in the next kernel
    # window and the fused dispatches replay overlapped — decisions (and
    # the binding log) are parity-gated identical either way
    pipeline=True,
    # rebalance-under-load (koordbalance): usage-derived metrics +
    # periodic hotspots give the descheduler REAL work every soak —
    # tests assert nonzero migration activity (binding-log change vs
    # pre-koordbalance soaks declared in BENCH_NOTES_r11)
    metrics_follow_usage=True, usage_fraction=0.8,
    hotspot_every=60, hotspot_nodes=2, hotspot_multiplier=4.0,
    descheduler_every=25,
    promote_after=16,
    faults=(
        Fault(cycle=300, kind="dispatch", count=2,
              message="soak transient dispatch fault"),
        Fault(cycle=450, kind="store_write", count=1,
              message="soak store-write fault"),
        Fault(cycle=600, kind="dispatch", count=8,
              message="soak dispatch fault storm"),
        Fault(cycle=750, kind="sidecar", count=3,
              message="soak sidecar outage"),
    ),
))

_register(Scenario(
    name="gang-storm",
    description=(
        "gang-dominated arrivals: storms of multi-member PodGroups every "
        "few cycles plus burst queues — the all-or-nothing admission "
        "path under sustained pressure"),
    seed=3, cycles=300, nodes=14,
    arrival_rate=3.0, departure_rate=2.0,
    burst_every=31, burst_size=30,
    gang_every=3, gang_size=5, gangs_per_storm=2, gang_lifetime=12,
    queue_cap=256,
    ttb_slo_seconds=240.0,
    waves="auto",
))

_register(Scenario(
    name="spot-churn",
    description=(
        "spot-heavy cluster: most arrivals are best-effort and "
        "reclamation keeps evicting bound BE pods (re-queued as fresh "
        "arrivals) while drains rotate nodes out and back"),
    seed=5, cycles=300, nodes=12,
    arrival_rate=7.0, be_fraction=0.7, departure_rate=1.0,
    spot_reclaim_every=5, spot_reclaim_count=4,
    drain_every=41, drain_uncordon_after=6,
    metric_flip_every=19,
    queue_cap=256,
    ttb_slo_seconds=240.0,
))

_register(Scenario(
    name="drain-storm",
    description=(
        "mass cordon + migration under arrival pressure: every drain "
        "event cordons several nodes at once, their load concentrates "
        "on the survivors (usage-derived metrics), and the descheduler "
        "must keep rebalancing through its reservation closed loop "
        "while arrivals keep coming"),
    seed=17, cycles=200, nodes=16, initial_pods=96,
    arrival_rate=5.0, departure_rate=3.0, be_fraction=0.3,
    drain_every=23, drains_per_event=3, drain_uncordon_after=7,
    # near-1.0 usage-per-request: a survivor node that fills up with
    # drained load genuinely reads above the 70% high threshold, so the
    # storm's concentration is what the descheduler must dissipate
    metrics_follow_usage=True, usage_fraction=0.85,
    descheduler_every=5,
    queue_cap=384,
    ttb_slo_seconds=240.0,
    waves="auto",
))

_register(Scenario(
    name="hotspot",
    description=(
        "skewed usage flips that must dissipate: every event marks the "
        "pods on a few nodes HOT (usage multiplier), LowNodeLoad "
        "classifies them high, and the migration closed loop "
        "(reservation -> next dispatch -> evict -> respread) must bring "
        "every flagged node back under the high thresholds within the "
        "dissipation SLO"),
    seed=23, cycles=160, nodes=16, initial_pods=128,
    arrival_rate=3.5, departure_rate=3.0, be_fraction=0.3,
    metrics_follow_usage=True, usage_fraction=0.5,
    hotspot_every=40, hotspot_nodes=2, hotspot_multiplier=3.5,
    hotspot_dissipate_slo_cycles=30,
    descheduler_every=3,
    queue_cap=256,
    # time-to-dissipate is this scenario's tight deliverable; the ttb
    # target stays loose enough that feature-stuck stragglers (hostPort
    # collisions under load) do not mask a dissipation regression
    ttb_slo_seconds=360.0,
))

_register(Scenario(
    name="overcommit-shift",
    description=(
        "koordcolo closed loop under load: a co-located koord-manager "
        "recomputes batch/mid overcommit on device every cycle while "
        "batch-class BE pods consume it; mid-soak prod-usage surges "
        "(usage-derived NodeMetrics) shrink batch allocatable and then "
        "recede, and the invariants pin that batch binds never exceed "
        "the CURRENT batch allocatable at their dispatch plus a bounded "
        "metric-write-to-observing-dispatch staleness SLO — fixed seed, "
        "byte-stable binding log, the bench --colo A/B pair (device vs "
        "host oracle) must be log-identical"),
    seed=31, cycles=160, nodes=12, initial_pods=72,
    arrival_rate=4.0, departure_rate=3.0, be_fraction=0.55,
    metrics_follow_usage=True, usage_fraction=0.7,
    colo_every=1, batch_fraction=0.6,
    overcommit_surge_every=40, overcommit_surge_cycles=12,
    overcommit_surge_nodes=4, overcommit_surge_multiplier=3.0,
    colo_staleness_slo_cycles=2,
    queue_cap=256,
    ttb_slo_seconds=400.0,
    promote_after=8,
))

_register(Scenario(
    name="fault-ladder",
    description=(
        "robustness proof (koordguard): mesh + fused waves + explain "
        "all on with a dispatch deadline armed; an attributable device "
        "loss lands the ladder on partial-mesh (surviving submesh), a "
        "slow-not-dead device (latency > deadline) demotes via the "
        "watchdog instead of wedging, a dispatch-fault storm walks the "
        "rest of the ladder to the host fallback, a crash-restart "
        "tears the scheduler down against the surviving store, and "
        "clean cycles re-promote after each — the deterministic seeded "
        "scenario the acceptance test pins"),
    seed=13, cycles=72, nodes=8,
    arrival_rate=4.0, departure_rate=1.0,
    queue_cap=128,
    ttb_slo_seconds=300.0,
    waves=4, explain="counts", mesh=2,
    dispatch_deadline_ms=150.0,
    restart_at=(58,),
    restart_slo_seconds=60.0,
    promote_after=5,
    faults=(
        # one mesh device named dead -> partial-mesh (1-device submesh)
        Fault(cycle=8, kind="device_loss", count=2, devices=(1,),
              message="ICI link down"),
        # slow-not-dead device: the monitored sync overruns the 150ms
        # deadline twice (retry, then demote) — 600ms clears it with
        # margin on any CI box
        Fault(cycle=22, kind="latency", count=2, delay_ms=600.0,
              message="slow-not-dead device"),
        # anonymous fault storm: walks the remaining rungs to host
        Fault(cycle=34, kind="dispatch", count=8,
              message="ladder walk fault storm"),
    ),
))

_register(Scenario(
    name="crash-restart",
    description=(
        "koordguard recovery gate: light churn with gangs and quota "
        "pods, then the scheduler crash-restarts mid-soak — device "
        "state, step caches and the pack memo all drop, the fresh "
        "scheduler replays list-then-watch from the surviving store, "
        "re-derives assumed/quota/gang state from store-visible binds, "
        "and must reach its first bind inside the restart SLO with "
        "zero double-booking breaches across the boundary — fixed "
        "seed, byte-stable binding log (hack/lint.sh runs it twice)"),
    seed=19, cycles=36, nodes=10, initial_pods=30,
    arrival_rate=5.0, departure_rate=2.0, be_fraction=0.3,
    gang_every=7, gang_size=3, gang_lifetime=18,
    quota_rebalance_every=11,
    queue_cap=192,
    ttb_slo_seconds=240.0,
    restart_at=(16,),
    restart_slo_seconds=30.0,
    promote_after=6,
))
