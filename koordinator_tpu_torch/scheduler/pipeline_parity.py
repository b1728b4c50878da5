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

  * ``run_pipeline_parity``: the pipelined serial cycle against the
    plain one;
  * ``run_explain_parity``: explain "counts" (PodScheduled messages
    formatted from the dispatch's stage counts) against explain off (the
    host recompute), string for string;
  * ``run_pack_overlap_parity``: the cycle that pre-packs the next
    cycle's pod rows inside the device window (pack overlap) against its
    gap-pack twin, every uploaded FullChainInputs array byte for byte;
  * ``run_fused_wave_parity``: fused-K against K serial cycles;
  * ``run_replay_overlap_parity``: the chained dispatch against the
    single-call twin (replay overlap off);
  * ``run_carried_state_parity``: one world per piece of carried state
    (reservations, claims, prod-usage scoring, a device ScoreTransformer);
  * ``run_mesh_parity``: the cycle on a mesh of ``ndev`` virtual shards
    (parallel/) against the single-device path;
  * ``run_rebalance_parity``: the descheduler's device rebalance pass
    against its host oracle, on the scheduler's shared snapshot (on a
    mesh with ``ndev``);
  * ``run_colo_parity``: the manager's device colo pass against the host
    oracles, on the scheduler's shared snapshot (on a mesh with
    ``ndev``).

Each takes ``device=``: "cuda" (the default, the kernels) or "cpu" (the
plain wave step); the scheduler harnesses take ``explain=`` too. The worlds and deltas are the JAX package's
(koordinator_tpu/scheduler/pipeline_parity.py), imports renamed. Run
on the card:

    python -m koordinator_tpu_torch.scheduler.pipeline_parity
"""

from __future__ import annotations

import logging
import sys
from collections import Counter
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


def _synth_world(num_nodes, num_pods, seed):
    from koordinator_tpu_torch.testing import synth_full_cluster

    _cluster, state = synth_full_cluster(
        num_nodes, num_pods, seed=seed, num_quotas=3, num_gangs=4,
        topology_fraction=0.5, lsr_fraction=0.2)
    return state, build_store_from_state(state)


def run_pipeline_parity(num_nodes: int = 24, num_pods: int = 70,
                        rounds: int = 4, seed: int = 11,
                        arrivals: int = 9, explain: str = "off",
                        device="cuda") -> dict:
    """Drive identical twin stores through the serial and pipelined paths.

    Returns a report dict; report["ok"] is the gate. Diffs per round:
    bound (pod, node) sequences in order, failed/rejected/victim sets —
    and at end of stream (after flush): every pod's PodScheduled
    condition tuple and node assignment. ``explain`` runs BOTH worlds at
    that koordexplain level: the pipeline stays byte-identical with
    attribution enabled."""
    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler

    state_s, store_serial = _synth_world(num_nodes, num_pods, seed)
    _state_p, store_pipe = _synth_world(num_nodes, num_pods, seed)
    # waves pinned to 1: this gate isolates pipelining; the fused-wave
    # gate (run_fused_wave_parity) owns the K > 1 dimension
    sched_serial = Scheduler(store_serial, waves=1, explain=explain,
                             device=device)
    sched_pipe = Scheduler(store_pipe, waves=1, explain=explain,
                           device=device)
    pipeline = CyclePipeline(sched_pipe, enabled=True)
    assert sched_serial.pipeline_mode is False

    now = state_s.now
    mismatches: List[str] = []
    for r in range(rounds + 1):
        if r > 0:
            apply_round_delta(store_serial, r, now, arrivals)
            apply_round_delta(store_pipe, r, now, arrivals)
        t = now + 2 * r
        res_s = sched_serial.run_cycle(now=t)
        res_p = pipeline.run_cycle(now=t)
        if ([(b.pod_key, b.node_name, b.annotations) for b in res_s.bound]
                != [(b.pod_key, b.node_name, b.annotations)
                    for b in res_p.bound]):
            mismatches.append(f"round {r}: bound sequence differs")
        for field in ("failed", "rejected", "preempted_victims",
                      "resized", "resize_pending"):
            if sorted(getattr(res_s, field)) != sorted(getattr(res_p, field)):
                mismatches.append(f"round {r}: {field} differs")
    pipeline.flush()

    cond_s, cond_p = _conditions(store_serial), _conditions(store_pipe)
    if cond_s != cond_p:
        keys = {k for k in set(cond_s) | set(cond_p)
                if cond_s.get(k) != cond_p.get(k)}
        mismatches.append(
            f"PodScheduled conditions differ for {len(keys)} pods "
            f"(e.g. {sorted(keys)[:3]})")
    assign_s = {p.meta.key: p.spec.node_name
                for p in store_serial.list(KIND_POD)}
    assign_p = {p.meta.key: p.spec.node_name
                for p in store_pipe.list(KIND_POD)}
    if assign_s != assign_p:
        mismatches.append("final pod->node assignments differ")
    _dump_on_mismatch(mismatches, sched_serial, sched_pipe)

    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "rounds": rounds + 1,
        "pods": len(assign_s),
        "conditions_checked": len(cond_s),
        "explain": explain,
        "device": str(device),
    }


def run_explain_parity(num_nodes: int = 24, num_pods: int = 70,
                       rounds: int = 4, seed: int = 11,
                       arrivals: int = 9, waves=1, device="cuda",
                       replay_overlap=None, explain: str = "counts",
                       schedulers=None) -> dict:
    """Formatter-over-dispatch-counts vs the host-numpy diagnosis:
    byte-identical stores on a churn workload.

    Twin worlds run the SAME cycle cadence, one at koordexplain
    ``explain`` ("counts": PodScheduled messages formatted from the
    dispatch's per-stage counts) and one pinned off (the diagnose_unbound
    recompute). Every observable — bound sequences, failure sets, every
    PodScheduled condition tuple string-for-string, final assignments —
    must match, proving BOTH that attribution does not perturb decisions
    and that the counts format to the exact host messages. ``waves`` and
    ``replay_overlap`` pick the dispatch (1: serial; K > 1: fused, chained
    unless replay_overlap is False). ``schedulers``, a list, receives the
    (off, explain) Scheduler pair for the caller to inspect."""
    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.scheduler.cycle import Scheduler

    state_l, store_legacy = _synth_world(num_nodes, num_pods, seed)
    _state_e, store_explain = _synth_world(num_nodes, num_pods, seed)
    kw = dict(waves=waves, device=device, replay_overlap=replay_overlap)
    sched_legacy = Scheduler(store_legacy, explain="off", **kw)
    sched_explain = Scheduler(store_explain, explain=explain, **kw)
    if schedulers is not None:
        schedulers.extend((sched_legacy, sched_explain))

    now = state_l.now
    mismatches: List[str] = []
    for r in range(rounds + 1):
        if r > 0:
            apply_round_delta(store_legacy, r, now, arrivals)
            apply_round_delta(store_explain, r, now, arrivals)
        t = now + 2 * r
        res_l = sched_legacy.run_cycle(now=t)
        res_e = sched_explain.run_cycle(now=t)
        if ([(b.pod_key, b.node_name) for b in res_l.bound]
                != [(b.pod_key, b.node_name) for b in res_e.bound]):
            mismatches.append(f"round {r}: bound sequence differs")
        for field in ("failed", "rejected", "preempted_victims"):
            if sorted(getattr(res_l, field)) != sorted(getattr(res_e, field)):
                mismatches.append(f"round {r}: {field} differs")

    cond_l, cond_e = _conditions(store_legacy), _conditions(store_explain)
    if cond_l != cond_e:
        keys = {k for k in set(cond_l) | set(cond_e)
                if cond_l.get(k) != cond_e.get(k)}
        mismatches.append(
            f"PodScheduled conditions differ for {len(keys)} pods "
            f"(e.g. {sorted(keys)[:3]})")
    assign_l = {p.meta.key: p.spec.node_name
                for p in store_legacy.list(KIND_POD)}
    assign_e = {p.meta.key: p.spec.node_name
                for p in store_explain.list(KIND_POD)}
    if assign_l != assign_e:
        mismatches.append("final pod->node assignments differ")
    _dump_on_mismatch(mismatches, sched_legacy, sched_explain)

    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "rounds": rounds + 1,
        "waves": waves,
        "pods": len(assign_l),
        "conditions_checked": len(cond_l),
        "explain": explain,
        "device": str(device),
    }


def run_fused_wave_parity(k_waves: int, num_nodes: int = 24,
                          num_pods: int = 70, rounds: int = 2,
                          seed: int = 11, arrivals: int = 9,
                          device="cuda", explain: str = "off") -> dict:
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
    condition tuple and node assignment. Both worlds run on ``device``
    and at koordexplain level ``explain``."""
    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler

    state_s, store_serial = _synth_world(num_nodes, num_pods, seed)
    _state_f, store_fused = _synth_world(num_nodes, num_pods, seed)
    sched_serial = Scheduler(store_serial, waves=1, device=device,
                             explain=explain)
    sched_fused = Scheduler(store_fused, waves=k_waves, device=device,
                            explain=explain)
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
        "explain": explain,
        "device": str(device),
    }


def run_pack_overlap_parity(waves: int = 1, ndev: Optional[int] = None,
                            num_nodes: int = 24, num_pods: int = 70,
                            rounds: int = 3, seed: int = 11,
                            arrivals: int = 9, device="cuda") -> dict:
    """Pack/device overlap vs the gap-pack twin: byte-identical
    ScheduleInputs, decisions and conditions.

    The overlap world pre-packs the next cycle's candidate pod rows
    INSIDE the device window (cycle.py _prepack_in_window); the twin pins
    pack_overlap off, so its pack runs strictly in the gap between
    windows. Both drive identical churn through the pipeline and both
    register the encode observer: every FullChainInputs array the cycle
    uploads is byte-compared encode for encode — the overlap may move
    WHEN rows pack, never a bit they hold. ``waves`` selects the serial
    (1) or fused-chain path; ``ndev`` shards both worlds over a mesh of
    that many virtual shards of ``device``.

    A pre-pack that fails, or never stages a row, leaves the overlap
    world packing cold in the gap, identical to the twin by
    construction: the report counts the rows the overlap world
    pre-packed (``prepacked_rows``) and the pre-packs that failed
    (``prepack_failures``, from the cycle's log), and either a failure
    or no row at all is a mismatch."""
    import numpy as np

    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler

    def snap_fc(fc):
        out = {}
        for name in fc._fields:
            value = getattr(fc, name)
            if name == "base":
                for f2 in value._fields:
                    out["base." + f2] = np.array(
                        np.asarray(getattr(value, f2)), copy=True)
            else:
                out[name] = np.array(np.asarray(value), copy=True)
        return out

    state_on, store_on = _synth_world(num_nodes, num_pods, seed)
    _state_off, store_off = _synth_world(num_nodes, num_pods, seed)
    sched_on = Scheduler(store_on, waves=waves, explain="off",
                         mesh=_mesh_arg(ndev, device), pack_overlap=True,
                         device=device)
    sched_off = Scheduler(store_off, waves=waves, explain="off",
                          mesh=_mesh_arg(ndev, device), pack_overlap=False,
                          device=device)
    encodes = {True: [], False: []}
    sched_on.encode_observer = lambda fc: encodes[True].append(snap_fc(fc))
    sched_off.encode_observer = lambda fc: encodes[False].append(
        snap_fc(fc))
    pipe_on = CyclePipeline(sched_on, enabled=True)
    pipe_off = CyclePipeline(sched_off, enabled=True)
    failures = _PrepackFailures()
    cycle_log = logging.getLogger("koordinator_tpu_torch.scheduler.cycle")
    cycle_log.addHandler(failures)

    now = state_on.now
    mismatches: List[str] = []
    try:
        for r in range(rounds + 1):
            if r > 0:
                apply_round_delta(store_on, r, now, arrivals)
                apply_round_delta(store_off, r, now, arrivals)
            t = now + 2 * r
            res_on = pipe_on.run_cycle(now=t)
            res_off = pipe_off.run_cycle(now=t)
            if ([(b.pod_key, b.node_name, b.annotations)
                 for b in res_on.bound]
                    != [(b.pod_key, b.node_name, b.annotations)
                        for b in res_off.bound]):
                mismatches.append(f"round {r}: bound sequence differs")
            for f in ("failed", "rejected", "preempted_victims"):
                if sorted(getattr(res_on, f)) != sorted(getattr(res_off, f)):
                    mismatches.append(f"round {r}: {f} differs")
        pipe_on.flush()
        pipe_off.flush()
    finally:
        cycle_log.removeHandler(failures)
    cache = sched_on.snapshot_cache
    prepacked = 0 if cache is None else cache.stats.get(
        "pod_rows_prepacked", 0)
    if failures.n:
        mismatches.append(f"{failures.n} in-window pre-packs failed")
    if not prepacked:
        mismatches.append("the overlap world pre-packed no row")

    if len(encodes[True]) != len(encodes[False]):
        mismatches.append(
            f"encode counts differ ({len(encodes[True])} vs "
            f"{len(encodes[False])})")
    else:
        for i, (a, b) in enumerate(zip(encodes[True], encodes[False])):
            bad = [k for k in a
                   if a[k].shape != b[k].shape
                   or not np.array_equal(a[k], b[k])]
            if bad:
                mismatches.append(
                    f"encode {i}: ScheduleInputs fields differ {bad[:4]}")
    cond_on, cond_off = _conditions(store_on), _conditions(store_off)
    if cond_on != cond_off:
        mismatches.append("PodScheduled conditions differ")
    assign_on = {p.meta.key: p.spec.node_name
                 for p in store_on.list(KIND_POD)}
    assign_off = {p.meta.key: p.spec.node_name
                  for p in store_off.list(KIND_POD)}
    if assign_on != assign_off:
        mismatches.append("final pod->node assignments differ")
    _dump_on_mismatch(mismatches, sched_on, sched_off)

    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "waves": waves,
        "rounds": rounds + 1,
        "pods": len(assign_on),
        "conditions_checked": len(cond_on),
        "encodes_compared": len(encodes[True]),
        "prepacked_rows": int(prepacked),
        "prepack_failures": failures.n,
        "device": str(device),
    }


class _PrepackFailures(logging.Handler):
    """Counts the cycle's "in-window pre-pack failed" log records."""

    def __init__(self) -> None:
        super().__init__(logging.ERROR)
        self.n = 0

    def emit(self, record) -> None:
        if record.getMessage().startswith("in-window pre-pack failed"):
            self.n += 1


def run_replay_overlap_parity(k_waves: int, num_nodes: int = 24,
                              num_pods: int = 70, rounds: int = 2,
                              seed: int = 11, arrivals: int = 9,
                              device="cuda", explain: str = "off") -> dict:
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
    plugin counters, and final assignments; at ``explain`` "full" also
    every pod's /explain record (the terms rows ride the chain's carried
    state)."""
    import numpy as np

    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler

    state_s, store_serial = _synth_world(num_nodes, num_pods, seed)
    _state_o, store_overlap = _synth_world(num_nodes, num_pods, seed)
    sched_serial = Scheduler(store_serial, waves=k_waves, device=device,
                             explain=explain, replay_overlap=False)
    sched_overlap = Scheduler(store_overlap, waves=k_waves, device=device,
                              explain=explain, replay_overlap=True)
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
    if explain == "full":
        rec_s = {k: sched_serial.explain_record(k) for k in assign_s}
        rec_o = {k: sched_overlap.explain_record(k) for k in assign_o}
        if rec_s != rec_o:
            keys = sorted(k for k in set(rec_s) | set(rec_o)
                          if rec_s.get(k) != rec_o.get(k))
            mismatches.append(
                f"explain=full records differ for {len(keys)} pods "
                f"(e.g. {keys[:3]})")
    _dump_on_mismatch(mismatches, sched_serial, sched_overlap)

    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "waves": k_waves,
        "rounds": rounds + 1,
        "pods": len(assign_s),
        "conditions_checked": len(cond_s),
        "explain": explain,
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


def _launch_counts() -> dict:
    """The kernel wrappers' launch counters, by kernel and instance."""
    from koordinator_tpu_torch.ops import explain_kernel as ek
    from koordinator_tpu_torch.ops import full_chain_kernel as fck

    return {"full_chain": fck.launches,
            "full_chain_replay": fck.replay_launches,
            "full_chain_terms": fck.terms_launches,
            "explain_counts": ek.launches,
            "full_chain_xchg": fck.xchg_launches,
            "full_chain_xchg_replay": fck.xchg_replay_launches,
            "full_chain_xchg_terms": fck.xchg_terms_launches,
            "explain_counts_shards": ek.shard_launches}


def run_carried_state_parity(feature: str, k_waves: int = 4,
                             overlap: bool = True, rounds: int = 2,
                             seed: int = 11, device="cuda",
                             mesh=None) -> dict:
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
    ``device``; with ``mesh`` the fused world's Scheduler runs on that
    mesh (a mesh of cards: the exchange route) and the twin on one
    device, and ``fused_launches`` counts the kernel launches the fused
    world's cycles made; diffed per round: bound (pod, node,
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
                            device=device, replay_overlap=overlap,
                            **({} if mesh is None else {"mesh": mesh}))
    if transformer_factory is not None:
        sched_serial.extender.register_transformer(transformer_factory())
        sched_fused.extender.register_transformer(transformer_factory())
    pipeline = CyclePipeline(sched_fused, enabled=True)

    mismatches: List[str] = []
    fields = ("failed", "rejected", "preempted_victims", "resized",
              "resize_pending")
    fused_engaged = 0
    fused_launches: Counter = Counter()
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
            before = _launch_counts()
            res = pipeline.run_cycle(now=t, waves=k_waves - consumed)
            fused_launches.update(
                {k: v - before[k] for k, v in _launch_counts().items()})
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
    before = _launch_counts()
    pipeline.flush()
    fused_launches.update(
        {k: v - before[k] for k, v in _launch_counts().items()})
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
        "fused_launches": dict(fused_launches),
        "overlap": overlap,
        "device": str(device),
        "mesh": None if mesh is None else mesh.size,
    }


def _mesh_arg(ndev: Optional[int], device):
    """The Scheduler ``mesh=`` of a parity world: "off", or a mesh of
    ``ndev`` virtual shards of ``device`` (testing/mesh_round.py)."""
    if ndev is None:
        return "off"
    from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

    return virtual_mesh(ndev, device)


def run_mesh_parity(ndev: int, waves: int = 1, num_nodes: int = 24,
                    num_pods: int = 70, rounds: int = 2, seed: int = 11,
                    arrivals: int = 9, explain: str = "off",
                    device="cuda") -> dict:
    """Mesh-backed dispatch vs the single-device path: byte-identical.

    The mesh world runs the production cycle on a mesh of ``ndev`` virtual
    shards of ``device`` (node-state tensors sharded, sharded upload and
    owner-shard scatter, the sharded steps, the per-shard readback merge
    — scheduler/cycle.py + parallel/); the twin runs the single-device
    path. Both worlds use the SAME wave depth and explain level, so the
    gate isolates the mesh dimension. Diffed per round: bound (pod, node,
    annotations) sequences in order and the failure/victim/resize lists;
    at the end: every PodScheduled condition, the gang/quota plugin
    counters and the final assignments."""
    import numpy as np

    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.scheduler.cycle import Scheduler
    from koordinator_tpu_torch.testing import synth_full_cluster

    def make_world():
        _cluster, state = synth_full_cluster(
            num_nodes, num_pods, seed=seed, num_quotas=3, num_gangs=4,
            topology_fraction=0.5, lsr_fraction=0.2)
        return state, build_store_from_state(state)

    state_s, store_single = make_world()
    _state_m, store_mesh = make_world()
    sched_single = Scheduler(store_single, waves=waves, explain=explain,
                             mesh="off", device=device)
    sched_mesh = Scheduler(store_mesh, waves=waves, explain=explain,
                           mesh=_mesh_arg(ndev, device), device=device)
    assert sched_mesh.mesh is not None and sched_mesh.mesh.size == ndev

    now = state_s.now
    mismatches: List[str] = []
    fields = ("failed", "rejected", "preempted_victims", "resized",
              "resize_pending")
    for r in range(rounds + 1):
        if r > 0:
            apply_round_delta(store_single, r, now, arrivals)
            apply_round_delta(store_mesh, r, now, arrivals)
        t = now + 2 * r
        res_s = sched_single.run_cycle(now=t)
        res_m = sched_mesh.run_cycle(now=t)
        if ([(b.pod_key, b.node_name, b.annotations) for b in res_s.bound]
                != [(b.pod_key, b.node_name, b.annotations)
                    for b in res_m.bound]):
            mismatches.append(f"round {r}: bound sequence differs")
        if res_s.waves != res_m.waves:
            mismatches.append(f"round {r}: waves consumed differ "
                              f"({res_s.waves} vs {res_m.waves})")
        for f in fields:
            if sorted(getattr(res_s, f)) != sorted(getattr(res_m, f)):
                mismatches.append(f"round {r}: {f} differs")

    cond_s, cond_m = _conditions(store_single), _conditions(store_mesh)
    if cond_s != cond_m:
        keys = {k for k in set(cond_s) | set(cond_m)
                if cond_s.get(k) != cond_m.get(k)}
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

    gang_s, quota_s = plugin_counters(sched_single)
    gang_m, quota_m = plugin_counters(sched_mesh)
    if gang_s != gang_m:
        mismatches.append(f"gang assumed counters differ: "
                          f"{gang_s} vs {gang_m}")
    if quota_s != quota_m:
        mismatches.append("quota used counters differ")
    assign_s = {p.meta.key: p.spec.node_name
                for p in store_single.list(KIND_POD)}
    assign_m = {p.meta.key: p.spec.node_name
                for p in store_mesh.list(KIND_POD)}
    if assign_s != assign_m:
        diff = sorted(k for k in set(assign_s) | set(assign_m)
                      if assign_s.get(k) != assign_m.get(k))
        mismatches.append(
            f"final pod->node assignments differ for {len(diff)} pods "
            f"(e.g. {diff[:3]})")
    _dump_on_mismatch(mismatches, sched_single, sched_mesh)

    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "ndev": ndev,
        "waves": waves,
        "rounds": rounds + 1,
        "pods": len(assign_s),
        "conditions_checked": len(cond_s),
        "explain": explain,
        "device": str(device),
    }


def run_rebalance_parity(ndev: Optional[int] = None, num_nodes: int = 16,
                         rounds: int = 4, seed: int = 11, arrivals: int = 18,
                         device="cuda") -> dict:
    """Device rebalance pass vs the host LowNodeLoad oracle:
    decision-identical on seeded churn, with the pack-memo-shared
    snapshot (koordbalance acceptance gate).

    ONE world runs the production Scheduler on ``device`` (on a mesh of
    ``ndev`` virtual shards when given) plus a Descheduler wired as the
    second snapshot consumer (``Descheduler(scheduler=...)``: the
    LowNodeLoad view comes from the scheduler's SnapshotCache
    subscription chain and the device pass uploads through the
    scheduler's DeviceSnapshot). Every round applies seeded churn, runs
    a scheduling cycle, then runs BOTH engines over the SAME packed view
    and diffs:

      * the victim list (order included — the migration-job creation
        order is the arbitrator's input),
      * node classification (is_low / is_high) against a host
        ``classify_nodes`` recompute,
      * the migration-job list the descheduler actually writes vs the
        jobs the host victim set implies.

    The device engine must actually run (``stats["engine"] ==
    "device"``) — a silent host demotion would compare host to host."""
    import numpy as np

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
        KIND_POD_MIGRATION_JOB,
        ObjectStore,
    )
    from koordinator_tpu_torch.descheduler.descheduler import Descheduler
    from koordinator_tpu_torch.descheduler.lownodeload import classify_nodes
    from koordinator_tpu_torch.scheduler.cycle import Scheduler

    import random

    rng = random.Random(seed)
    now = 1_000_000.0
    store = ObjectStore()
    for i in range(num_nodes):
        store.add(KIND_NODE, Node(
            meta=ObjectMeta(name=f"rb-n{i}", namespace=""),
            allocatable=ResourceList.of(cpu=32_000, memory=128 * GIB,
                                        pods=128)))
        store.add(KIND_NODE_METRIC, NodeMetric(
            meta=ObjectMeta(name=f"rb-n{i}", namespace=""),
            update_time=now - 5,
            node_metric=NodeMetricInfo(node_usage=ResourceList.of(
                cpu=6_000, memory=16 * GIB))))
    sched = Scheduler(store, mesh=_mesh_arg(ndev, device), device=device)
    desch = Descheduler(store, scheduler=sched, rebalance="on")
    plugin = None
    for profile in desch.profiles:
        for p in profile.balance_plugins:
            if p.name == "LowNodeLoad":
                plugin = p.inner
    assert plugin is not None and plugin.device is desch.rebalancer

    mismatches: List[str] = []
    uid = 0
    for r in range(rounds + 1):
        now += 10.0
        # seeded churn: arrivals (the scheduler binds them), departures,
        # and a rotating metric skew that flips which nodes read high/low
        for _ in range(arrivals):
            uid += 1
            store.add(KIND_POD, Pod(
                meta=ObjectMeta(name=f"rb-p{uid}", namespace="parity",
                                uid=f"rb-p{uid}", creation_timestamp=now,
                                owner_kind="ReplicaSet",
                                owner_name=f"rs-{uid % 13}"),
                spec=PodSpec(
                    priority=rng.choice([100, 5500, 9000]),
                    requests=ResourceList.of(
                        cpu=rng.choice([300, 700, 1100, 1500]),
                        memory=rng.choice([1, 2, 3]) * GIB))))
        running = [p for p in store.list(KIND_POD)
                   if p.is_assigned and not p.is_terminated]
        for p in rng.sample(running, min(3, len(running))):
            store.delete(KIND_POD, p.meta.key)
        for i, nm in enumerate(store.list(KIND_NODE_METRIC)):
            band = 0.85 if (i + r) % 3 == 0 else (
                0.15 if (i + r) % 3 == 1 else 0.55)
            nm.update_time = now - 5
            nm.node_metric = NodeMetricInfo(node_usage=ResourceList.of(
                cpu=int(32_000 * band), memory=int(128 * GIB * band)))
            store.update(KIND_NODE_METRIC, nm)
        res = sched.run_cycle(now=now)
        for b in res.bound:
            pod = store.get(KIND_POD, b.pod_key)
            if pod is not None and not pod.is_terminated:
                pod.phase = "Running"
                store.update(KIND_POD, pod)

        # ---- both engines over the SAME packed view
        picked_dev, _src, v = plugin.select_victims(now=now)
        stats = dict(plugin.last_pass_stats)
        if stats.get("engine") != "device":
            mismatches.append(
                f"round {r}: device engine did not run "
                f"(engine={stats.get('engine')!r})")
            break
        picked_host = plugin.select_victims_host(v)
        if list(picked_dev) != list(picked_host):
            mismatches.append(
                f"round {r}: victim lists differ "
                f"({len(picked_dev)} device vs {len(picked_host)} host)")
        is_low_h, is_high_h = classify_nodes(
            v["usage_pct"], v["has_metric"],
            plugin._thr_vec(plugin.args.low_thresholds),
            plugin._thr_vec(plugin.args.high_thresholds))
        if (list(stats["is_low"]) != list(is_low_h)
                or list(stats["is_high"]) != list(is_high_h)):
            mismatches.append(f"round {r}: node classification differs")

        # ---- the migration-job list the descheduler writes must be
        # exactly what the host victim set implies
        before = {j.meta.key for j in store.list(KIND_POD_MIGRATION_JOB)}
        expected = before | {
            f"koordinator-system/migrate-"
            f"{_src[k].meta.namespace}-{_src[k].meta.name}"
            for k in picked_host}
        desch.run_once(now=now)
        after = {j.meta.key for j in store.list(KIND_POD_MIGRATION_JOB)}
        if after != expected:
            mismatches.append(
                f"round {r}: migration-job list differs "
                f"(+{sorted(after - expected)[:3]} "
                f"-{sorted(expected - after)[:3]})")
    if mismatches and desch.rebalancer is not None:
        desch.rebalancer.flight.dump("rebalance_parity_mismatch")
    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "device": str(device),
        "rounds": rounds + 1,
        "pods": len(store.list(KIND_POD)),
        "conditions_checked": len(store.list(KIND_POD_MIGRATION_JOB)),
        "ndev": ndev or 0,
    }


def run_colo_parity(ndev: Optional[int] = None, num_nodes: int = 12,
                    rounds: int = 4, seed: int = 29, arrivals: int = 10,
                    device="cuda") -> dict:
    """Device colo pass vs the retained host oracles: decision-identical
    on seeded churn, with the pack fed from the SnapshotCache's existing
    subscriptions (koordcolo acceptance gate).

    TWO worlds run the identical seeded sequence — production Scheduler
    on ``device`` (on a mesh of ``ndev`` virtual shards when given) + a
    co-located Manager — with only the colo engine differing (``colo="on"``
    vs ``colo="host"``).
    Every round applies churn (arrivals incl. quota-labeled and
    batch-class pods, departures, metric skews + staleness flips, a
    reservation-annotation rewrite, a mid-run slo-config hot reload, a
    quota max shift), ticks the manager, revokes, and runs a scheduling
    cycle; the gate diffs:

      * batch/mid allocatable on every node (the writeback vectors),
      * the staleness-degraded node set (against a fresh host gather),
      * the runtime-quota matrix (device fold vs compute_runtime_quotas),
      * the revoke-victim lists (order included) from the overuse loop,
      * the binding logs of the scheduling cycles (the closed loop).

    The device engine must actually run (``engine == "device"``) and the
    revoke loop must consume the device runtime at least once — a silent
    host demotion would compare host to host."""
    import random

    import numpy as np

    from koordinator_tpu_torch.api.objects import (
        ConfigMap,
        ElasticQuota,
        LABEL_QUOTA_IS_PARENT,
        LABEL_QUOTA_NAME,
        LABEL_QUOTA_PARENT,
        Node,
        NodeMetric,
        NodeMetricInfo,
        ObjectMeta,
        Pod,
        PodMetricInfo,
        PodSpec,
    )
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import (
        KIND_CONFIG_MAP,
        KIND_ELASTIC_QUOTA,
        KIND_NODE,
        KIND_NODE_METRIC,
        KIND_POD,
        ObjectStore,
    )
    from koordinator_tpu_torch.manager import Manager
    from koordinator_tpu_torch.scheduler.config import SchedulerConfiguration
    from koordinator_tpu_torch.scheduler.cycle import Scheduler

    import json

    def build_world(colo: str):
        rng = random.Random(seed)
        now = 1_000_000.0
        store = ObjectStore()
        for i in range(num_nodes):
            node = Node(
                meta=ObjectMeta(name=f"co-n{i}", namespace=""),
                allocatable=ResourceList.of(cpu=32_000, memory=128 * GIB,
                                            pods=128))
            if i % 3 == 0:
                node.meta.annotations[
                    "node.koordinator.sh/reservation"] = json.dumps(
                        {"resources": {"cpu": "2", "memory": "4Gi"},
                         "systemResources": {"cpu": "1"}})
            if i % 4 == 0:
                node.meta.labels["pool"] = "batchy"
            store.add(KIND_NODE, node)
            store.add(KIND_NODE_METRIC, NodeMetric(
                meta=ObjectMeta(name=f"co-n{i}", namespace=""),
                update_time=now - 5,
                node_metric=NodeMetricInfo(node_usage=ResourceList.of(
                    cpu=4_000 + 1_000 * (i % 3), memory=16 * GIB)),
                prod_reclaimable=ResourceList.of(cpu=2_000,
                                                 memory=8 * GIB)))
        # slo-config: cluster strategy + a node-pool override (the
        # per-node strategy scalars must reach the device pass)
        store.add(KIND_CONFIG_MAP, ConfigMap(
            meta=ObjectMeta(name="slo-controller-config",
                            namespace="koordinator-system"),
            data={"colocation-config": json.dumps({
                "cpuReclaimThresholdPercent": 65,
                "memoryReclaimThresholdPercent": 70,
                "nodeConfigs": [{"nodeSelector": {"pool": "batchy"},
                                 "cpuReclaimThresholdPercent": 80}],
            })}))
        # quota tree: root capped tight enough that the children's mins
        # force AutoScaleMin, one child not lending — the fold's corners
        store.add(KIND_ELASTIC_QUOTA, ElasticQuota(
            meta=ObjectMeta(name="co-root", namespace="parity",
                            labels={LABEL_QUOTA_IS_PARENT: "true"}),
            min=ResourceList.of(cpu=12_000, memory=48 * GIB),
            max=ResourceList.of(cpu=20_000, memory=64 * GIB)))
        for qname, lent in (("co-qa", "true"), ("co-qb", "false")):
            store.add(KIND_ELASTIC_QUOTA, ElasticQuota(
                meta=ObjectMeta(
                    name=qname, namespace="parity",
                    labels={
                        LABEL_QUOTA_PARENT: "co-root",
                        "quota.scheduling.koordinator.sh/"
                        "allow-lent-resource": lent}),
                min=ResourceList.of(cpu=6_000, memory=16 * GIB),
                max=ResourceList.of(cpu=18_000, memory=56 * GIB)))
        cfg = SchedulerConfiguration()
        sched = Scheduler(store, config=cfg, device=device,
                          mesh=_mesh_arg(ndev, device))
        mgr = Manager(store, identity=f"mgr-{colo}", scheduler=sched,
                      colo=colo)
        plugin = sched.extender.plugin("ElasticQuota")
        import dataclasses as _dc

        revoke_args = _dc.replace(cfg.elastic_quota,
                                  monitor_all_quotas=True,
                                  delay_evict_time_seconds=5.0,
                                  revoke_pod_interval_seconds=1.0)
        revoker = plugin.revoke_controller(store, revoke_args)
        return rng, now, store, sched, mgr, plugin, revoker

    worlds = {name: build_world(name) for name in ("on", "host")}
    mismatches: List[str] = []
    device_runtime_consumed = 0
    victims_seen = 0
    uid = 0
    for r in range(rounds + 1):
        state = {}
        for name in ("on", "host"):
            rng, now, store, sched, mgr, plugin, revoker = worlds[name]
            now += 10.0
            wuid = uid
            # ---- seeded churn (identical draws per world)
            for _ in range(arrivals):
                wuid += 1
                flavor = rng.random()
                spec = PodSpec(
                    priority=rng.choice([9500, 9200, 5500]),
                    requests=ResourceList.of(
                        cpu=rng.choice([500, 1000, 2000]),
                        memory=rng.choice([1, 2, 4]) * GIB))
                labels = {}
                if flavor < 0.3:
                    labels[LABEL_QUOTA_NAME] = rng.choice(
                        ["co-qa", "co-qb"])
                elif flavor < 0.45:
                    # batch-class pod consuming the overcommit the colo
                    # pass publishes — the closed loop's consumer
                    spec = PodSpec(
                        priority=5500,
                        requests=ResourceList.of(
                            batch_cpu=rng.choice([1000, 2000]),
                            batch_memory=rng.choice([1, 2]) * GIB))
                store.add(KIND_POD, Pod(
                    meta=ObjectMeta(name=f"co-p{wuid}",
                                    namespace="parity",
                                    uid=f"co-p{wuid}",
                                    creation_timestamp=now,
                                    labels=labels,
                                    owner_kind="ReplicaSet",
                                    owner_name=f"rs-{wuid % 7}"),
                    spec=spec))
            running = [p for p in store.list(KIND_POD)
                       if p.is_assigned and not p.is_terminated]
            for p in rng.sample(running, min(2, len(running))):
                store.delete(KIND_POD, p.meta.key)
            for i, nm in enumerate(store.list(KIND_NODE_METRIC)):
                stale = (i + r) % 5 == 0
                nm.update_time = (now - 10_000.0) if stale else (now - 5)
                band = 0.25 + 0.15 * ((i + r) % 4)
                usage = {}
                for p in store.list(KIND_POD):
                    if (p.is_assigned and not p.is_terminated
                            and p.spec.node_name == nm.meta.name):
                        usage[p.meta.key] = ResourceList.of(
                            cpu=(p.spec.requests["cpu"] * 3) // 4,
                            memory=(p.spec.requests["memory"] // GIB)
                            * GIB // 2)
                nm.pods_metric = [
                    PodMetricInfo(namespace=k.split("/")[0],
                                  name=k.split("/")[1], pod_usage=v)
                    for k, v in usage.items()]
                nm.node_metric = NodeMetricInfo(
                    node_usage=ResourceList.of(
                        cpu=int(32_000 * band), memory=int(128 * GIB * band)))
                store.update(KIND_NODE_METRIC, nm)
            if r == 1:
                # reservation-annotation rewrite on one node
                node = store.get(KIND_NODE, "/co-n0")
                node.meta.annotations[
                    "node.koordinator.sh/reservation"] = json.dumps(
                        {"resources": {"cpu": "4", "memory": "8Gi"}})
                store.update(KIND_NODE, node)
            if r == 2:
                # slo-config hot reload: the policy scalars must move
                cm = store.get(KIND_CONFIG_MAP,
                               "koordinator-system/slo-controller-config")
                cm.data["colocation-config"] = json.dumps({
                    "cpuReclaimThresholdPercent": 55,
                    "memoryReclaimThresholdPercent": 60,
                    "midCPUThresholdPercent": 15,
                })
                store.update(KIND_CONFIG_MAP, cm)
            if r == 3:
                # quota shrink: runtime collapses under the live used,
                # arming the overuse revoke path
                q = store.get(KIND_ELASTIC_QUOTA, "parity/co-qa")
                q.min = ResourceList.of(cpu=500, memory=GIB)
                q.max = ResourceList.of(cpu=1_000, memory=2 * GIB)
                store.update(KIND_ELASTIC_QUOTA, q)

            # ---- manager tick (the engines under test), then revoke,
            # then the scheduling cycle that consumes the overcommit
            assert mgr.tick(now=now)
            consumed = plugin.fresh_device_runtime() is not None
            victims = revoker.reconcile(now)
            res = sched.run_cycle(now=now)
            for b in res.bound:
                pod = store.get(KIND_POD, b.pod_key)
                if pod is not None and not pod.is_terminated:
                    pod.phase = "Running"
                    store.update(KIND_POD, pod)
            snap = plugin.tree_snapshot(store)
            state[name] = {
                "now": now,
                "uid": wuid,
                "alloc": {n.meta.name: dict(n.allocatable.quantities)
                          for n in store.list(KIND_NODE)},
                "victims": list(victims),
                "bound": [(b.pod_key, b.node_name) for b in res.bound],
                "runtime": (None if snap is None else snap[1]),
                "consumed": consumed,
                "stats": (dict(mgr.colo.last_pass_stats)
                          if mgr.colo is not None else {}),
            }
            worlds[name] = (rng, now, store, sched, mgr, plugin, revoker)
        uid = state["on"]["uid"]
        a, b = state["on"], state["host"]
        if a["stats"].get("engine") != "device":
            mismatches.append(
                f"round {r}: device engine did not run "
                f"(engine={a['stats'].get('engine')!r})")
            break
        if a["consumed"]:
            device_runtime_consumed += 1
        if a["alloc"] != b["alloc"]:
            diff = [n for n in a["alloc"]
                    if a["alloc"][n] != b["alloc"].get(n)]
            mismatches.append(
                f"round {r}: batch/mid allocatable differs on "
                f"{diff[:3]}")
        # degraded set: device stats vs a fresh host gather
        rngh, nowh, storeh, schedh, mgrh, _p, _rv = worlds["host"]
        ctl = mgrh.controllers["noderesource"]
        nodes_h = storeh.list(KIND_NODE)
        degraded_h = ctl._gather(nodes_h, b["now"])[-1]
        degraded_d = np.asarray(a["stats"]["degraded"])
        if list(degraded_d) != list(degraded_h):
            mismatches.append(f"round {r}: degraded-node set differs")
        if (a["runtime"] is None) != (b["runtime"] is None) or (
                a["runtime"] is not None
                and not np.array_equal(a["runtime"], b["runtime"])):
            mismatches.append(f"round {r}: runtime-quota matrix differs")
        dev_rt = a["stats"].get("runtime")
        if dev_rt is not None and a["runtime"] is not None:
            # the device fold's published matrix itself, against the
            # host oracle fold over the same post-writeback store
            if not np.array_equal(np.asarray(dev_rt),
                                  np.asarray(b["runtime"])):
                mismatches.append(
                    f"round {r}: device runtime matrix differs from "
                    f"the host fold")
        if a["victims"] != b["victims"]:
            mismatches.append(
                f"round {r}: revoke-victim lists differ "
                f"({a['victims'][:3]} vs {b['victims'][:3]})")
        victims_seen += len(a["victims"])
        if a["bound"] != b["bound"]:
            mismatches.append(f"round {r}: binding logs differ")
    if not mismatches and device_runtime_consumed == 0:
        mismatches.append(
            "the revoke loop never consumed the device runtime")
    if not mismatches and victims_seen == 0:
        # the victim-list comparison must not be vacuous: the round-3
        # quota shrink is designed to arm the overuse revoke
        mismatches.append("the revoke loop never selected a victim")
    mgr_on = worlds["on"][4]
    if mismatches and mgr_on.colo is not None:
        mgr_on.colo.flight.dump("colo_parity_mismatch")
    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "device": str(device),
        "rounds": rounds + 1,
        "pods": len(worlds["on"][2].list(KIND_POD)),
        "conditions_checked": device_runtime_consumed,
        "ndev": ndev or 0,
    }


def main(device="cuda") -> int:
    """Every harness on ``device``; prints one JSON line per report and
    returns 1 when any fails."""
    import json

    reports = [run_pipeline_parity(device=device),
               run_pipeline_parity(explain="counts", device=device)]
    # pack overlap is on by default: the in-window pre-pack must be a
    # pure latency lever, serial, fused-chain and mesh-sharded
    reports += [run_pack_overlap_parity(waves=w, device=device)
                for w in (1, 4)]
    reports.append(run_pack_overlap_parity(waves=4, ndev=2, device=device))
    reports += [run_explain_parity(waves=w, device=device)
                for w in (1, 4)]
    reports += [run_fused_wave_parity(k, device=device) for k in (2, 4, 8)]
    reports.append(run_fused_wave_parity(4, device=device, explain="full"))
    reports += [run_replay_overlap_parity(k, device=device) for k in (2, 4)]
    reports += [run_replay_overlap_parity(4, device=device, explain=e)
                for e in ("counts", "full")]
    reports += [run_carried_state_parity(f, device=device)
                for f in ("reservations", "claims", "prod", "transformer")]
    reports.append(run_rebalance_parity(device=device))
    reports.append(run_colo_parity(device=device))
    # the mesh: 1/2/3/4/8 virtual shards, serial and fused K = 4, explain
    # counts; the descheduler's and the manager's passes on 2 and 8
    for nd in (1, 2, 3, 4, 8):
        reports.append(run_mesh_parity(nd, device=device))
        reports.append(run_mesh_parity(nd, waves=4, explain="counts",
                                       device=device))
    for nd in (2, 8):
        reports.append(run_rebalance_parity(nd, device=device))
        reports.append(run_colo_parity(nd, device=device))
    for report in reports:
        print(json.dumps(report))
    return 0 if all(r["ok"] for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
