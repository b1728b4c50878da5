"""Fused-wave parity harnesses of the port: same fixture, byte-identical
outcomes.

The fused multi-wave dispatch (models/fused_waves.py, scheduler/cycle.py)
changes HOW a cycle's rounds run — K dependent rounds per dispatch, replayed
host-side as logical cycles, and with replay overlap the host replay of
wave w running while the device runs wave w+1. None of that may change
WHAT the scheduler produces: each harness drives twin stores through
identical churn and diffs every bound sequence, the failure/rejection
lists, every PodScheduled condition, the gang/quota plugin counters and the
final assignments.

  * ``run_fused_wave_parity``: fused-K against K serial cycles;
  * ``run_replay_overlap_parity``: the chained dispatch against the
    single-call twin (replay overlap off);
  * ``run_carried_state_parity``: one world per piece of carried state
    (reservations, claims, prod-usage scoring, a device ScoreTransformer).

Each takes ``device=``: "cuda" (the default, the kernels) or "cpu" (the
plain wave step). The worlds and deltas are the JAX package's
(koordinator_tpu/scheduler/pipeline_parity.py), imports renamed. Run
on the card:

    python -m koordinator_tpu_torch.scheduler.pipeline_parity
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

GIB = 1024 ** 3


def build_store_from_state(state):
    from koordinator_tpu_torch.client.store import (
        KIND_ELASTIC_QUOTA,
        KIND_NODE,
        KIND_NODE_METRIC,
        KIND_NODE_TOPOLOGY,
        KIND_POD,
        KIND_POD_GROUP,
        ObjectStore,
    )

    store = ObjectStore()
    for n in state.nodes:
        store.add(KIND_NODE, n)
    for nm in state.node_metrics.values():
        store.add(KIND_NODE_METRIC, nm)
    for p in state.pods_by_key.values():
        store.add(KIND_POD, p)
    for p in state.pending_pods:
        store.add(KIND_POD, p)
    for pg in state.pod_groups:
        store.add(KIND_POD_GROUP, pg)
    for q in state.quotas:
        store.add(KIND_ELASTIC_QUOTA, q)
    for t in state.topologies.values():
        store.add(KIND_NODE_TOPOLOGY, t)
    return store


def apply_round_delta(store, round_idx: int, now: float, arrivals: int,
                      metric_touches: Optional[int] = None,
                      prefix: str = "pp", namespace: str = "parity") -> None:
    """Deterministic per-round churn: fresh pending pods + metric touches.
    Twin worlds receive byte-identical objects (independent instances).
    Shared by the parity gate and bench.run_steady_state so both exercise
    the same delta shape; ``metric_touches`` defaults to ~1/7 of the
    metrics (the parity fixture's historical cadence)."""
    from koordinator_tpu_torch.api.objects import (
        NodeMetricInfo,
        ObjectMeta,
        Pod,
        PodSpec,
    )
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import KIND_NODE_METRIC, KIND_POD

    for i in range(arrivals):
        store.add(KIND_POD, Pod(
            meta=ObjectMeta(name=f"{prefix}-{round_idx}-{i}",
                            namespace=namespace,
                            uid=f"{prefix}-{round_idx}-{i}",
                            creation_timestamp=now + round_idx),
            spec=PodSpec(priority=5000 + (i % 4) * 1000,
                         requests=ResourceList.of(
                             cpu=250 * (1 + i % 6),
                             memory=(1 + i % 3) * GIB, pods=1)),
        ))
    metrics = store.list(KIND_NODE_METRIC)
    stride = (7 if metric_touches is None
              else max(1, len(metrics) // metric_touches))
    for nm in metrics[round_idx % min(3, stride)::stride]:
        nm.update_time = now + round_idx
        nm.node_metric = NodeMetricInfo(
            node_usage=ResourceList.of(
                cpu=4000 + 500 * round_idx, memory=(8 + round_idx) * GIB))
        store.update(KIND_NODE_METRIC, nm)


def _conditions(store) -> Dict[str, tuple]:
    """Every pod's PodScheduled condition, keyed by pod key."""
    from koordinator_tpu_torch.client.store import KIND_POD

    out = {}
    for pod in store.list(KIND_POD):
        cond = pod.get_condition("PodScheduled")
        if cond is not None:
            out[pod.meta.key] = (cond.status, cond.reason, cond.message,
                                 cond.last_transition_time)
    return out


def _dump_on_mismatch(mismatches, *scheds) -> None:
    """Flight-recorder trigger: a parity mismatch dumps each world's ring
    (files land in KOORD_TPU_FLIGHT_DIR when set; the dump counter always
    increments so the trigger is observable either way)."""
    if not mismatches:
        return
    for sched in scheds:
        sched.flight.dump("parity_mismatch")


def run_fused_wave_parity(k_waves: int, num_nodes: int = 24,
                          num_pods: int = 70, rounds: int = 2,
                          seed: int = 11, arrivals: int = 9,
                          device="cuda") -> dict:
    """Fused-K vs K sequential single-round cycles: byte-identical state.

    The fused wave kernel (models/fused_waves.py) runs K dependent
    scheduling rounds in one dispatch; the Scheduler replays them as logical
    cycles. This harness drives twin stores through identical churn: the
    serial world runs K plain single-round cycles per round, the fused
    world runs pipelined fused cycles until K logical cycles are consumed
    (``CycleResult.waves`` — a veto/preemption truncation hands the
    remaining budget to the next dispatch). Diffed per round: the
    CONCATENATED bound sequences and failed/rejected/victim lists across
    the K logical cycles; at end of stream: every pod's PodScheduled
    condition tuple and node assignment. Both worlds run on ``device``."""
    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler
    from koordinator_tpu_torch.testing import synth_full_cluster

    def make_world():
        _cluster, state = synth_full_cluster(
            num_nodes, num_pods, seed=seed, num_quotas=3, num_gangs=4,
            topology_fraction=0.5, lsr_fraction=0.2)
        return state, build_store_from_state(state)

    state_s, store_serial = make_world()
    _state_f, store_fused = make_world()
    sched_serial = Scheduler(store_serial, waves=1, device=device)
    sched_fused = Scheduler(store_fused, waves=k_waves, device=device)
    pipeline = CyclePipeline(sched_fused, enabled=True)
    assert sched_serial.pipeline_mode is False

    now = state_s.now
    mismatches: List[str] = []
    fields = ("failed", "rejected", "preempted_victims", "resized",
              "resize_pending")
    for r in range(rounds + 1):
        if r > 0:
            apply_round_delta(store_serial, r, now, arrivals)
            apply_round_delta(store_fused, r, now, arrivals)
        t = now + 2 * r
        ser_bound: List[tuple] = []
        ser_lists = {f: [] for f in fields}
        for _c in range(k_waves):
            res = sched_serial.run_cycle(now=t)
            ser_bound.extend(
                (b.pod_key, b.node_name, b.annotations) for b in res.bound)
            for f in fields:
                ser_lists[f].extend(getattr(res, f))
        fused_bound: List[tuple] = []
        fused_lists = {f: [] for f in fields}
        consumed = 0
        while consumed < k_waves:
            res = pipeline.run_cycle(now=t, waves=k_waves - consumed)
            if res.waves <= 0:  # defensive: a cycle must consume >= 1
                mismatches.append(f"round {r}: fused cycle consumed 0")
                break
            consumed += res.waves
            fused_bound.extend(
                (b.pod_key, b.node_name, b.annotations) for b in res.bound)
            for f in fields:
                fused_lists[f].extend(getattr(res, f))
        if ser_bound != fused_bound:
            mismatches.append(
                f"round {r}: bound sequence differs "
                f"(serial {len(ser_bound)} vs fused {len(fused_bound)})")
        for f in fields:
            if ser_lists[f] != fused_lists[f]:
                mismatches.append(f"round {r}: {f} differs")
    pipeline.flush()

    cond_s, cond_f = _conditions(store_serial), _conditions(store_fused)
    if cond_s != cond_f:
        keys = {k for k in set(cond_s) | set(cond_f)
                if cond_s.get(k) != cond_f.get(k)}
        mismatches.append(
            f"PodScheduled conditions differ for {len(keys)} pods "
            f"(e.g. {sorted(keys)[:3]})")
    # plugin-side counters: the fused path increments gang assumed and
    # quota used via carried device state + per-wave binds — the host
    # plugin caches must land exactly where K serial cycles put them
    import numpy as np

    def plugin_counters(sched):
        gang = sched.extender.plugin("Coscheduling")
        quota = sched.extender.plugin("ElasticQuota")
        return (
            {g: n for g, n in (gang.assumed if gang else {}).items() if n},
            {q: tuple(np.asarray(v).tolist())
             for q, v in (quota.used if quota else {}).items()
             if np.asarray(v).any()},
        )

    gang_s, quota_s = plugin_counters(sched_serial)
    gang_f, quota_f = plugin_counters(sched_fused)
    if gang_s != gang_f:
        mismatches.append(f"gang assumed counters differ: "
                          f"{gang_s} vs {gang_f}")
    if quota_s != quota_f:
        mismatches.append("quota used counters differ")
    assign_s = {p.meta.key: p.spec.node_name
                for p in store_serial.list(KIND_POD)}
    assign_f = {p.meta.key: p.spec.node_name
                for p in store_fused.list(KIND_POD)}
    if assign_s != assign_f:
        diff = sorted(k for k in set(assign_s) | set(assign_f)
                      if assign_s.get(k) != assign_f.get(k))
        mismatches.append(
            f"final pod->node assignments differ for {len(diff)} pods "
            f"(e.g. {diff[:3]})")
    _dump_on_mismatch(mismatches, sched_serial, sched_fused)

    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "waves": k_waves,
        "rounds": rounds + 1,
        "pods": len(assign_s),
        "conditions_checked": len(cond_s),
        "device": str(device),
    }


def run_replay_overlap_parity(k_waves: int, num_nodes: int = 24,
                              num_pods: int = 70, rounds: int = 2,
                              seed: int = 11, arrivals: int = 9,
                              device="cuda") -> dict:
    """Overlapped wave replay vs the serial-replay fused dispatch:
    byte-identical state.

    The overlap world (KOORD_TPU_REPLAY_OVERLAP=1 semantics pinned) runs
    the fused dispatch as a chain of per-wave device programs with the
    host replay of wave w draining while wave w+1 executes, batched bind
    transactions and deduped condition repeats; the twin pins overlap
    OFF — the single fused program with strictly serial post-readback
    replay, i.e. today's exact path. Both drive identical churn at the
    same wave depth through the pipeline. Diffed per round: bound
    (pod, node, annotations) sequences, the failure/victim/resize lists;
    at end of stream: every PodScheduled condition tuple, gang/quota
    plugin counters, and final assignments."""
    import numpy as np

    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler
    from koordinator_tpu_torch.testing import synth_full_cluster

    def make_world():
        _cluster, state = synth_full_cluster(
            num_nodes, num_pods, seed=seed, num_quotas=3, num_gangs=4,
            topology_fraction=0.5, lsr_fraction=0.2)
        return state, build_store_from_state(state)

    state_s, store_serial = make_world()
    _state_o, store_overlap = make_world()
    sched_serial = Scheduler(store_serial, waves=k_waves, device=device,
                             replay_overlap=False)
    sched_overlap = Scheduler(store_overlap, waves=k_waves, device=device,
                              replay_overlap=True)
    pipe_serial = CyclePipeline(sched_serial, enabled=True)
    pipe_overlap = CyclePipeline(sched_overlap, enabled=True)

    now = state_s.now
    mismatches: List[str] = []
    fields = ("failed", "rejected", "preempted_victims", "resized",
              "resize_pending")
    for r in range(rounds + 1):
        if r > 0:
            apply_round_delta(store_serial, r, now, arrivals)
            apply_round_delta(store_overlap, r, now, arrivals)
        t = now + 2 * r
        res_s = pipe_serial.run_cycle(now=t)
        res_o = pipe_overlap.run_cycle(now=t)
        if ([(b.pod_key, b.node_name, b.annotations) for b in res_s.bound]
                != [(b.pod_key, b.node_name, b.annotations)
                    for b in res_o.bound]):
            mismatches.append(f"round {r}: bound sequence differs")
        if res_s.waves != res_o.waves:
            mismatches.append(f"round {r}: waves consumed differ "
                              f"({res_s.waves} vs {res_o.waves})")
        for f in fields:
            if sorted(getattr(res_s, f)) != sorted(getattr(res_o, f)):
                mismatches.append(f"round {r}: {f} differs")
    pipe_serial.flush()
    pipe_overlap.flush()

    cond_s, cond_o = _conditions(store_serial), _conditions(store_overlap)
    if cond_s != cond_o:
        keys = {k for k in set(cond_s) | set(cond_o)
                if cond_s.get(k) != cond_o.get(k)}
        mismatches.append(
            f"PodScheduled conditions differ for {len(keys)} pods "
            f"(e.g. {sorted(keys)[:3]})")

    def plugin_counters(sched):
        gang = sched.extender.plugin("Coscheduling")
        quota = sched.extender.plugin("ElasticQuota")
        return (
            {g: n for g, n in (gang.assumed if gang else {}).items() if n},
            {q: tuple(np.asarray(v).tolist())
             for q, v in (quota.used if quota else {}).items()
             if np.asarray(v).any()},
        )

    gang_s, quota_s = plugin_counters(sched_serial)
    gang_o, quota_o = plugin_counters(sched_overlap)
    if gang_s != gang_o:
        mismatches.append(f"gang assumed counters differ: "
                          f"{gang_s} vs {gang_o}")
    if quota_s != quota_o:
        mismatches.append("quota used counters differ")
    assign_s = {p.meta.key: p.spec.node_name
                for p in store_serial.list(KIND_POD)}
    assign_o = {p.meta.key: p.spec.node_name
                for p in store_overlap.list(KIND_POD)}
    if assign_s != assign_o:
        diff = sorted(k for k in set(assign_s) | set(assign_o)
                      if assign_s.get(k) != assign_o.get(k))
        mismatches.append(
            f"final pod->node assignments differ for {len(diff)} pods "
            f"(e.g. {diff[:3]})")
    _dump_on_mismatch(mismatches, sched_serial, sched_overlap)

    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "waves": k_waves,
        "rounds": rounds + 1,
        "pods": len(assign_s),
        "conditions_checked": len(cond_s),
        "device": str(device),
    }


def _make_parity_transformer():
    """Device-expressible ScoreTransformer for the transformer parity
    gate. Two exact elementwise rewrites, chosen to cover BOTH rewrite
    classes: the LoadAware nonprod term (a field the wave body REBUILDS
    from carried state each wave — the pass must re-apply on top) and
    the score weights (a field the wave body does NOT rebuild — a pass
    applied both host-side at encode and in-kernel would compound to
    9x instead of 3x, so this gate catches a double application)."""
    from koordinator_tpu_torch.scheduler.frameworkext import (
        DeviceScoreTransformer,
    )

    class ParityHalver(DeviceScoreTransformer):
        name = "parity-halver"

        def device_pass(self, inputs):
            import torch

            base = inputs.base
            w = base.weights
            w = w * torch.where(
                torch.arange(w.shape[0], device=w.device) == 0, 3.0, 1.0)
            return inputs._replace(base=base._replace(
                la_term_nonprod=base.la_term_nonprod * 0.5, weights=w))

    return ParityHalver()


def _reservation_world():
    """A store whose fused dispatch MUST carry reservation rows: Pending
    Reservation CRs bind in wave 1, selector-blocked owner pods consume
    them via the wave-2 in-kernel nomination (allocate-once + shared
    multi-consumer), and the consumed allocate-once row's Succeeded
    transition lands at the wave-3 boundary — exactly what K serial
    cycles do through the host pre-pass + reconcile."""
    from koordinator_tpu_torch.api.objects import (
        Node,
        ObjectMeta,
        Pod,
        PodSpec,
        Reservation,
        ReservationOwner,
    )
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import (
        KIND_NODE,
        KIND_POD,
        KIND_RESERVATION,
        ObjectStore,
    )

    now = 1_000_000.0
    store = ObjectStore()
    for name, used in (("n0", 3000), ("n1", 9000)):
        store.add(KIND_NODE, Node(
            meta=ObjectMeta(name=name, namespace=""),
            allocatable=ResourceList.of(cpu=10000, memory=64 * GIB,
                                        pods=60)))
        store.add(KIND_POD, Pod(
            meta=ObjectMeta(name=f"pre-{name}", uid=f"pre-{name}",
                            creation_timestamp=now - 100),
            spec=PodSpec(node_name=name,
                         requests=ResourceList.of(cpu=used, memory=GIB,
                                                  pods=1))))

    def pend(name, cpu, labels=None, blocked=True, ts=now):
        pod = Pod(
            meta=ObjectMeta(name=name, uid=name, creation_timestamp=ts,
                            labels=dict(labels or {})),
            spec=PodSpec(requests=ResourceList.of(cpu=cpu, memory=GIB,
                                                  pods=1)))
        if blocked:
            # owner pods ride ONLY the reserved capacity: the selector
            # matches no node, so open-capacity scheduling always fails
            # and the nomination pre-pass is the single bind channel
            pod.spec.node_selector = {"reserved-only": "true"}
        store.add(KIND_POD, pod)
        return pod

    pend("big-f", 7500, blocked=False)       # fails every round: no fit
    pend("own-a", 2000, labels={"app": "a"})
    pend("own-b1", 400, labels={"app": "b"})
    pend("own-b2", 400, labels={"app": "b"})
    pend("small", 800, blocked=False)        # binds wave 1
    store.add(KIND_RESERVATION, Reservation(
        meta=ObjectMeta(name="resv-a", namespace="",
                        creation_timestamp=now - 10),
        template=PodSpec(requests=ResourceList.of(cpu=6000, memory=2 * GIB,
                                                   pods=4)),
        owners=[ReservationOwner(label_selector={"app": "a"})],
        allocate_once=True))
    store.add(KIND_RESERVATION, Reservation(
        meta=ObjectMeta(name="resv-b", namespace="",
                        creation_timestamp=now - 5),
        template=PodSpec(requests=ResourceList.of(cpu=1000, memory=2 * GIB,
                                                   pods=2)),
        owners=[ReservationOwner(label_selector={"app": "b"})],
        allocate_once=False))
    return now, store


def _reservation_round_delta(store, round_idx: int, now: float) -> None:
    """Per-round churn for the reservation world: a fresh Pending
    reservation + its selector-blocked owner + an open filler — the
    descheduler's closed-loop cadence (every migration creates a
    Reservation)."""
    from koordinator_tpu_torch.api.objects import (
        ObjectMeta,
        Pod,
        PodSpec,
        Reservation,
        ReservationOwner,
    )
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import KIND_POD, KIND_RESERVATION

    t = now + round_idx
    store.add(KIND_POD, Pod(
        meta=ObjectMeta(name=f"own-r{round_idx}", uid=f"own-r{round_idx}",
                        creation_timestamp=t,
                        labels={"app": f"r{round_idx}"}),
        spec=PodSpec(node_selector={"reserved-only": "true"},
                     requests=ResourceList.of(cpu=300, memory=GIB,
                                              pods=1))))
    store.add(KIND_POD, Pod(
        meta=ObjectMeta(name=f"fill-r{round_idx}", uid=f"fill-r{round_idx}",
                        creation_timestamp=t),
        spec=PodSpec(requests=ResourceList.of(cpu=200, memory=GIB,
                                              pods=1))))
    store.add(KIND_RESERVATION, Reservation(
        meta=ObjectMeta(name=f"resv-r{round_idx}", namespace="",
                        creation_timestamp=t),
        template=PodSpec(requests=ResourceList.of(cpu=500, memory=GIB,
                                                   pods=1)),
        owners=[ReservationOwner(
            label_selector={"app": f"r{round_idx}"})],
        allocate_once=True))


def _claims_world():
    """A store whose fused dispatch MUST carry claim state: hot claims
    (shared between pending pods AND already attached on nodes), tight
    attachable-volume limits, and a pod whose bind becomes feasible only
    after another pod's in-dispatch attachment grants it the
    already-attached exemption (the wave-2 regrouping)."""
    from koordinator_tpu_torch.api.objects import Node, ObjectMeta, Pod, PodSpec
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import KIND_NODE, KIND_POD, ObjectStore

    now = 1_000_000.0
    store = ObjectStore()
    for i in range(4):
        node = Node(
            meta=ObjectMeta(name=f"n{i}", namespace="",
                            labels={"vg": str(i)}),
            allocatable=ResourceList.of(cpu=32000, memory=64 * GIB,
                                        pods=80))
        node.attachable_volume_limit = 3
        store.add(KIND_NODE, node)

    def pod(name, cpu, pvcs=(), node_name="", selector=None, ts=now):
        p = Pod(
            meta=ObjectMeta(name=name, uid=name, creation_timestamp=ts),
            spec=PodSpec(requests=ResourceList.of(cpu=cpu, memory=GIB,
                                                  pods=1),
                         pvc_names=list(pvcs)))
        if node_name:
            p.spec.node_name = node_name
        if selector:
            p.spec.node_selector = dict(selector)
        store.add(KIND_POD, p)
        return p

    # attached sets: shared-x lives on n0 AND n1 (distinct volume groups)
    pod("b0", 1000, pvcs=["shared-x", "a0"], node_name="n0", ts=now - 100)
    pod("b1", 1000, pvcs=["shared-x"], node_name="n1", ts=now - 100)
    # pending: the exemption consumer (shared-x already attached), a
    # shared pair, the wave-2 exemption flip (q3 pinned to n2 binds only
    # after q2's attachment covers its claim), and unique-claim pods
    pod("q1", 500, pvcs=["shared-x", "new-1"])
    pod("q2", 500, pvcs=["shared-y", "y-extra", "y-extra2"],
        selector={"vg": "2"})
    pod("q3", 500, pvcs=["shared-y"], selector={"vg": "2"})
    pod("q4", 500, pvcs=["u1", "u2"])
    pod("plain", 700)
    return now, store


def _claims_round_delta(store, round_idx: int, now: float) -> None:
    """Per-round claim churn: fresh pods re-sharing earlier claims (some
    now attached — exemptions), plus a new shared pair."""
    from koordinator_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import KIND_POD

    t = now + round_idx
    for i, pvcs in enumerate((["shared-x"],
                              [f"r{round_idx}-s"],
                              [f"r{round_idx}-s", "u-extra"])):
        store.add(KIND_POD, Pod(
            meta=ObjectMeta(name=f"cl-{round_idx}-{i}",
                            uid=f"cl-{round_idx}-{i}",
                            creation_timestamp=t),
            spec=PodSpec(requests=ResourceList.of(cpu=400, memory=GIB,
                                                  pods=1),
                         pvc_names=pvcs)))


def run_carried_state_parity(feature: str, k_waves: int = 4,
                             overlap: bool = True, rounds: int = 2,
                             seed: int = 11, device="cuda") -> dict:
    """One byte-parity gate per retired fused-wave demotion.

    ``feature`` selects the carried state under test:

      * ``reservations`` — Pending Reservation CRs ride the batch, turn
        Available in wave 1, get consumed by the wave-2 in-kernel
        nomination (allocate-once Succeeded transition at wave 3).
      * ``claims`` — hot-claim columns: shared/attached claims, volume
        limits, the wave-2 already-attached exemption flip.
      * ``prod`` — scoreAccordingProdUsage with the carried est/adj prod
        term split, over the full synth cluster.
      * ``transformer`` — a device-expressible ScoreTransformer applied
        as an in-kernel tensor pass each wave vs the serial twin's host
        before_score.

    The fused world runs K waves per dispatch (overlap on — the default
    production shape), the serial twin runs K single-round cycles, both on
    ``device``; diffed per round: bound (pod, node,
    annotations) sequences and the failure/rejection/victim lists; at
    end of stream: every PodScheduled condition tuple, gang/quota plugin
    counters and final assignments. A regression that re-demotes (the
    fused world silently running serial) fails the ``fused_engaged``
    assertion — this gate can never pass vacuously."""
    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
    from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler
    from koordinator_tpu_torch.testing import synth_full_cluster

    args = None
    round_delta = None
    transformer_factory = None
    if feature == "reservations":
        def make_world():
            return _reservation_world()

        round_delta = _reservation_round_delta
    elif feature == "claims":
        def make_world():
            return _claims_world()

        round_delta = _claims_round_delta
    elif feature in ("prod", "transformer"):
        if feature == "prod":
            args = LoadAwareArgs(score_according_prod_usage=True)
        else:
            transformer_factory = _make_parity_transformer

        def make_world():
            _cluster, state = synth_full_cluster(
                20, 60, seed=seed, num_quotas=2, num_gangs=3,
                topology_fraction=0.5, lsr_fraction=0.2)
            return state.now, build_store_from_state(state)

        def round_delta(store, r, now):
            apply_round_delta(store, r, now, arrivals=7)
    else:
        raise ValueError(f"unknown feature {feature!r}")

    now, store_serial = make_world()
    _now, store_fused = make_world()
    sched_serial = Scheduler(store_serial, args=args, waves=1,
                             device=device)
    sched_fused = Scheduler(store_fused, args=args, waves=k_waves,
                            device=device, replay_overlap=overlap)
    if transformer_factory is not None:
        sched_serial.extender.register_transformer(transformer_factory())
        sched_fused.extender.register_transformer(transformer_factory())
    pipeline = CyclePipeline(sched_fused, enabled=True)

    mismatches: List[str] = []
    fields = ("failed", "rejected", "preempted_victims", "resized",
              "resize_pending")
    fused_engaged = 0
    for r in range(rounds + 1):
        if r > 0:
            round_delta(store_serial, r, now)
            round_delta(store_fused, r, now)
        t = now + 2 * r
        ser_bound: List[tuple] = []
        ser_lists = {f: [] for f in fields}
        for _c in range(k_waves):
            res = sched_serial.run_cycle(now=t)
            ser_bound.extend(
                (b.pod_key, b.node_name, b.annotations) for b in res.bound)
            for f in fields:
                ser_lists[f].extend(getattr(res, f))
        fused_bound: List[tuple] = []
        fused_lists = {f: [] for f in fields}
        consumed = 0
        while consumed < k_waves:
            res = pipeline.run_cycle(now=t, waves=k_waves - consumed)
            if res.waves <= 0:
                mismatches.append(f"round {r}: fused cycle consumed 0")
                break
            # the burn-down's whole point: none of the retired reasons
            # may fire, and the dispatch must actually run multi-wave
            if res.demotions:
                mismatches.append(
                    f"round {r}: fused cycle demoted ({res.demotions})")
            if res.waves > 1:
                fused_engaged += 1
            consumed += res.waves
            fused_bound.extend(
                (b.pod_key, b.node_name, b.annotations) for b in res.bound)
            for f in fields:
                fused_lists[f].extend(getattr(res, f))
        if ser_bound != fused_bound:
            mismatches.append(
                f"round {r}: bound sequence differs "
                f"(serial {len(ser_bound)} vs fused {len(fused_bound)}): "
                f"{ser_bound} != {fused_bound}")
        for f in fields:
            if ser_lists[f] != fused_lists[f]:
                mismatches.append(f"round {r}: {f} differs")
    pipeline.flush()
    if not fused_engaged:
        mismatches.append("fused path never ran multi-wave: the gate "
                          "would be vacuous (did a demotion sneak back?)")

    cond_s, cond_f = _conditions(store_serial), _conditions(store_fused)
    if cond_s != cond_f:
        keys = {k for k in set(cond_s) | set(cond_f)
                if cond_s.get(k) != cond_f.get(k)}
        mismatches.append(
            f"PodScheduled conditions differ for {len(keys)} pods "
            f"(e.g. {sorted(keys)[:3]})")
    import numpy as np

    def plugin_counters(sched):
        gang = sched.extender.plugin("Coscheduling")
        quota = sched.extender.plugin("ElasticQuota")
        return (
            {g: n for g, n in (gang.assumed if gang else {}).items() if n},
            {q: tuple(np.asarray(v).tolist())
             for q, v in (quota.used if quota else {}).items()
             if np.asarray(v).any()},
        )

    if plugin_counters(sched_serial) != plugin_counters(sched_fused):
        mismatches.append("gang/quota plugin counters differ")
    assign_s = {p.meta.key: p.spec.node_name
                for p in store_serial.list(KIND_POD)}
    assign_f = {p.meta.key: p.spec.node_name
                for p in store_fused.list(KIND_POD)}
    if assign_s != assign_f:
        diff = sorted(k for k in set(assign_s) | set(assign_f)
                      if assign_s.get(k) != assign_f.get(k))
        mismatches.append(
            f"final pod->node assignments differ for {len(diff)} pods "
            f"(e.g. {diff[:3]})")
    _dump_on_mismatch(mismatches, sched_serial, sched_fused)

    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "feature": feature,
        "waves": k_waves,
        "rounds": rounds + 1,
        "pods": len(assign_s),
        "conditions_checked": len(cond_s),
        "fused_engaged": fused_engaged,
        "overlap": overlap,
        "device": str(device),
    }


def main(device="cuda") -> int:
    """Every harness on ``device``; prints one JSON line per report and
    returns 1 when any fails."""
    import json

    reports = [run_fused_wave_parity(k, device=device) for k in (2, 4, 8)]
    reports += [run_replay_overlap_parity(k, device=device) for k in (2, 4)]
    reports += [run_carried_state_parity(f, device=device)
                for f in ("reservations", "claims", "prod", "transformer")]
    for report in reports:
        print(json.dumps(report))
    return 0 if all(r["ok"] for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
