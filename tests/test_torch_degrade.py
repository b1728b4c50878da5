"""The port's degradation ladder against the JAX package's.

Four layers:

  * the ``DegradationLadder`` state machine: tests/test_sim.py's cases,
    run on both packages' ladders (each case is parametrised over them);
  * ``host_fallback_schedule``, the ladder's bottom rung, on the same
    numpy pack in both packages (gang and quota pods present);
  * the Scheduler with its ladder: one seeded FaultPlan sequence on twin
    stores — dispatch faults, an upload OOM, a deadline overrun and a
    fault storm, serial and auto waves, chained and single-call — must
    give the same transition records, ``DISPATCH_RETRIES`` deltas,
    ``CycleResult.waves`` and bindings every cycle in both packages;
  * what the ladder must let through: a failed store write and every
    failure of a broken kernel (build, argument check, library load,
    launch, readback) propagate, and the ladder stays at full.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from koordinator_tpu.api import objects as ref_objects
from koordinator_tpu.api.resources import ResourceList as RefResourceList
from koordinator_tpu.client.store import ObjectStore as RefObjectStore
from koordinator_tpu.scheduler import degrade as ref_degrade
from koordinator_tpu.scheduler import metrics as ref_metrics
from koordinator_tpu.scheduler.cycle import Scheduler as RefScheduler
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
    reduce_to_active_axes as ref_reduce,
)
from koordinator_tpu.sim import faults as ref_faults
from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefLoadAwareArgs
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.client.store import KIND_POD
from koordinator_tpu_torch.ops.kernel_common import KernelContractError
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler import degrade
from koordinator_tpu_torch.scheduler import metrics as port_metrics
from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.sim import faults as port_faults
from koordinator_tpu_torch.testing import synth_full_cluster
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    churn_store,
    store_from_state,
)

ALL_FEATURES = {"mesh": True, "waves": True, "explain": True}
NO_FEATURES = {"mesh": False, "waves": False, "explain": False}
LADDERS = pytest.mark.parametrize("pkg", [ref_degrade, degrade],
                                  ids=["jax", "port"])


# ---------------------------------------------------------------------------
# the state machine, in both packages
# ---------------------------------------------------------------------------


@LADDERS
def test_retry_once_then_demote_walks_every_rung(pkg):
    ladder = pkg.DegradationLadder(promote_after=4)
    ladder.begin_pass()
    seen = [ladder.on_failure(ALL_FEATURES, error="boom") for _ in range(8)]
    assert seen == ["retry", "demoted"] * 4
    assert ladder.level == pkg.LEVEL_HOST_FALLBACK
    assert [t["to_level"] for t in ladder.transitions] == [
        pkg.LEVEL_NO_MESH, pkg.LEVEL_SERIAL_WAVES, pkg.LEVEL_NO_EXPLAIN,
        pkg.LEVEL_HOST_FALLBACK]
    assert ladder.on_failure(ALL_FEATURES) == "retry"
    assert ladder.on_failure(ALL_FEATURES) == "exhausted"


@LADDERS
def test_meaningless_rungs_are_skipped(pkg):
    ladder = pkg.DegradationLadder(promote_after=4)
    ladder.begin_pass()
    ladder.on_failure(NO_FEATURES)
    assert ladder.on_failure(NO_FEATURES) == "demoted"
    assert ladder.level == pkg.LEVEL_HOST_FALLBACK
    for _ in range(5):
        ladder.note_cycle()
    assert ladder.level == pkg.LEVEL_FULL


@LADDERS
def test_one_gpu_ladder_is_full_serial_host(pkg):
    """The port's live ladder on one GPU with explain off: only the waves
    rung between full and the host fallback changes anything."""
    feats = {"mesh": False, "waves": True, "explain": False}
    ladder = pkg.DegradationLadder(promote_after=2)
    ladder.begin_pass()
    for _ in range(4):
        ladder.on_failure(feats)
    levels = []
    for _ in range(6):
        ladder.note_cycle()
        levels.append(ladder.level)
    assert [(t["from"], t["to"]) for t in ladder.transitions] == [
        ("full", "serial-waves"), ("serial-waves", "host-fallback"),
        ("host-fallback", "serial-waves"), ("serial-waves", "full")]
    assert levels == [5, 5, 3, 3, 0, 0]


@LADDERS
def test_promotion_probes_one_rung_per_window(pkg):
    ladder = pkg.DegradationLadder(promote_after=3)
    ladder.begin_pass()
    for _ in range(8):
        ladder.on_failure(ALL_FEATURES)
    assert ladder.level == pkg.LEVEL_HOST_FALLBACK
    levels = []
    for _ in range(13):
        ladder.note_cycle()
        levels.append(ladder.level)
    assert levels == [5, 5, 5, 4, 4, 4, 3, 3, 3, 2, 2, 2, 0]


@LADDERS
def test_failed_probe_doubles_the_backoff(pkg):
    ladder = pkg.DegradationLadder(promote_after=2, max_promote_after=8)
    ladder.begin_pass()
    for _ in range(8):
        ladder.on_failure(ALL_FEATURES)
    for _ in range(3):
        ladder.note_cycle()
    assert ladder.level == pkg.LEVEL_NO_EXPLAIN
    ladder.begin_pass()
    ladder.on_failure(ALL_FEATURES)
    ladder.on_failure(ALL_FEATURES)
    assert ladder.level == pkg.LEVEL_HOST_FALLBACK
    assert ladder.promote_after == 4
    for _ in range(5):
        ladder.note_cycle()
    assert ladder.level == pkg.LEVEL_NO_EXPLAIN
    ladder.begin_pass()
    ladder.on_failure(ALL_FEATURES)
    ladder.on_failure(ALL_FEATURES)
    assert ladder.promote_after == 8


@LADDERS
def test_surviving_probation_resets_the_backoff(pkg):
    ladder = pkg.DegradationLadder(promote_after=2, max_promote_after=64)
    ladder.begin_pass()
    for _ in range(4):
        ladder.on_failure(NO_FEATURES)
    for _ in range(3):
        ladder.note_cycle()
    assert ladder.level == pkg.LEVEL_FULL
    ladder.begin_pass()
    ladder.on_failure(NO_FEATURES)
    ladder.on_failure(NO_FEATURES)
    assert ladder.promote_after == 4
    for _ in range(5):
        ladder.note_cycle()
    assert ladder.level == pkg.LEVEL_FULL
    ladder.note_cycle()
    ladder.note_cycle()
    assert ladder.promote_after == 2


@LADDERS
def test_failed_cycle_does_not_count_clean(pkg):
    ladder = pkg.DegradationLadder(promote_after=2)
    ladder.begin_pass()
    ladder.on_failure(NO_FEATURES)
    ladder.on_failure(NO_FEATURES)
    assert ladder.level == pkg.LEVEL_HOST_FALLBACK
    ladder.note_cycle()
    ladder.note_cycle()
    assert ladder.level == pkg.LEVEL_HOST_FALLBACK
    ladder.note_cycle()
    assert ladder.level == pkg.LEVEL_FULL


@LADDERS
def test_attributable_failure_takes_the_partial_mesh_rung(pkg):
    ladder = pkg.DegradationLadder(promote_after=4)
    ladder.begin_pass()
    feats = dict(ALL_FEATURES, partial_mesh=True)
    assert ladder.on_failure(feats, error="dev 3 down") == "retry"
    assert ladder.on_failure(feats, error="dev 3 down") == "demoted"
    assert ladder.level == pkg.LEVEL_PARTIAL_MESH
    ladder.begin_pass()
    ladder.on_failure(ALL_FEATURES)
    assert ladder.on_failure(ALL_FEATURES) == "demoted"
    assert ladder.level == pkg.LEVEL_NO_MESH


@LADDERS
def test_partial_mesh_shrinks_in_place_on_new_loss(pkg):
    ladder = pkg.DegradationLadder(promote_after=4)
    ladder.begin_pass()
    feats = dict(ALL_FEATURES, partial_mesh=True)
    ladder.on_failure(feats)
    ladder.on_failure(feats)
    ladder.begin_pass()
    shrink = dict(feats, partial_mesh_shrink=True)
    ladder.on_failure(shrink)
    assert ladder.on_failure(shrink) == "demoted"
    assert ladder.level == pkg.LEVEL_PARTIAL_MESH
    last = ladder.transitions[-1]
    assert (last["from"], last["to"]) == ("partial-mesh", "partial-mesh")


@LADDERS
def test_promotion_from_partial_mesh_probes_full(pkg):
    ladder = pkg.DegradationLadder(promote_after=2)
    ladder.begin_pass()
    feats = dict(ALL_FEATURES, partial_mesh=True)
    ladder.on_failure(feats)
    ladder.on_failure(feats)
    for _ in range(3):
        ladder.note_cycle()
    assert ladder.level == pkg.LEVEL_FULL


@LADDERS
def test_attributable_device_ids(pkg):
    class Named(RuntimeError):
        failed_device_ids = (3, "1")

    assert pkg.attributable_device_ids(Named()) == frozenset({1, 3})
    assert pkg.attributable_device_ids(RuntimeError()) == frozenset()


# ---------------------------------------------------------------------------
# the bottom rung on one numpy pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 8])
def test_host_fallback_schedule_matches_reference(seed):
    """Both packages' host passes over their own pack of the same seeded
    cluster (packs equal by tests/test_torch_pack.py): the same chosen
    vector; gang and quota pods stay unchosen; plain pods bind."""
    _c, ref_state = ref_synth(24, 160, seed=seed, num_quotas=8, num_gangs=6)
    _c, state = synth_full_cluster(24, 160, seed=seed, num_quotas=8,
                                   num_gangs=6)
    ref_fc, ref_pods, ref_nodes = ref_build(ref_state, RefLoadAwareArgs())[:3]
    fc, pods, nodes = build_full_chain_inputs(state, LoadAwareArgs())[:3]
    ref_fc, _ = ref_reduce(ref_fc)
    fc, _ = reduce_to_active_axes(fc)
    assert list(pods.keys) == list(ref_pods.keys)
    want = ref_degrade.host_fallback_schedule(ref_fc, ref_pods,
                                              len(ref_nodes.names))
    got = degrade.host_fallback_schedule(fc, pods, len(nodes.names))
    np.testing.assert_array_equal(got, want)
    gang = np.asarray(fc.gang_id)[:len(pods.keys)] >= 0
    quota = np.asarray(fc.quota_id)[:len(pods.keys)] >= 0
    assert gang.any() and quota.any()
    assert (got[gang | quota] == -1).all()
    assert (got >= 0).sum() > 0


# ---------------------------------------------------------------------------
# the Scheduler's ladder, one fault sequence in both packages
# ---------------------------------------------------------------------------

# name -> (pods at cycle 0, Scheduler kwargs, faults, expected walk).
# Cycle 0 then churn cycles of ARRIVALS pods on NODES nodes. The pinned
# K=2 worlds stay small; "auto" needs 256 pending pods for K=2 at cycle 0
# (the churn cycles after it resolve K=1 by depth). Only a world that
# plans a `latency` fault sets a dispatch deadline: elsewhere a slow CPU
# cycle under parallel test workers would overrun it, in either package,
# and add a retry that no fault planted.
NODES, ARRIVALS, CYCLES = 12, 30, 9
SERIAL, HOST, FULL = "serial-waves", "host-fallback", "full"
CONFIGS = {
    "chained": (60, dict(waves=2, dispatch_deadline_ms=300), (
        ("dispatch", 0, dict(count=1)),
        ("oom_upload", 1, dict(count=1)),
        ("latency", 2, dict(count=1, delay_ms=1500.0)),
        ("dispatch", 3, dict(count=4)),
    ), [(FULL, SERIAL), (SERIAL, HOST), (HOST, SERIAL), (SERIAL, FULL)]),
    "single-call": (60, dict(waves=2, replay_overlap=False), (
        ("dispatch", 1, dict(count=2)),
        ("oom_upload", 4, dict(count=1)),
    ), [(FULL, SERIAL), (SERIAL, FULL)]),
    "auto": (260, dict(waves="auto"), (
        ("dispatch", 0, dict(count=4)),
    ), [(FULL, SERIAL), (SERIAL, HOST), (HOST, SERIAL), (SERIAL, FULL)]),
    "serial": (60, dict(waves=1), (
        ("oom_upload", 0, dict(count=1)),
        ("dispatch", 2, dict(count=3)),
    ), [(FULL, HOST), (HOST, FULL)]),
    # a 4-shard mesh (the JAX package's first 4 virtual CPU devices, the
    # port's 4 virtual CPU shards: ids 0-3 in both): a device loss naming
    # shard 3 runs the 3 survivors, an anonymous storm drops the mesh
    "mesh": (60, dict(waves=2, mesh=4), (
        ("device_loss", 0, dict(count=2, devices=(3,))),
        ("dispatch", 4, dict(count=2)),
    ), [(FULL, "partial-mesh"), ("partial-mesh", FULL), (FULL, "no-mesh"),
        ("no-mesh", FULL)]),
}


def _plan(mod, faults):
    return mod.FaultPlan([mod.Fault(cycle=c, kind=kind, **kw)
                          for kind, c, kw in faults])


def _retries(metrics):
    return {s: metrics.DISPATCH_RETRIES.get(stage=s) or 0.0
            for s in ("serial", "fused")}


def _drive(sched, store, state, plan, metrics, add):
    """Cycle 0 and CYCLES-1 churn cycles under ``plan``: per cycle the
    bindings/failed/rejected, waves, level and transitions so far, and
    the DISPATCH_RETRIES deltas."""
    sched.fault_injector = plan.dispatch_hook
    sched.sync_delay_injector = plan.sync_delay_hook
    sched.upload_fault_injector = plan.upload_hook
    base = _retries(metrics)
    out = []
    for c in range(CYCLES):
        now = state.now + 2 * c
        if c:
            add(store, arrival_specs(c, ARRIVALS), state.now + 2 * c - 1)
        plan.begin_cycle(c)
        res = sched.run_cycle(now=now)
        out.append(([(b.pod_key, b.node_name) for b in res.bound],
                    list(res.failed), list(res.rejected), res.waves,
                    sched.ladder.level, len(sched.ladder.transitions)))
    after = _retries(metrics)
    return (out, list(sched.ladder.transitions),
            {s: after[s] - base[s] for s in after}, list(plan.injected))


def _ref_add(store, specs, created):
    add_arrivals(store, specs, created, objects=ref_objects,
                 resource_list=RefResourceList)


@functools.lru_cache(maxsize=None)
def _reference(name):
    pods, kwargs, faults, _walk = CONFIGS[name]
    _c, state = ref_synth(NODES, pods, seed=5, num_quotas=8, num_gangs=4)
    store = store_from_state(state, RefObjectStore())
    sched = RefScheduler(store, **{
        "explain": "off", "mesh": "off", "warmup": "off",
        "dispatch_deadline_ms": 0,
        "ladder": ref_degrade.DegradationLadder(promote_after=2), **kwargs})
    return _drive(sched, store, state, _plan(ref_faults, faults),
                  ref_metrics, _ref_add)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fault_sequence_matches_reference(name):
    pods, kwargs, faults, walk = CONFIGS[name]
    _c, state = synth_full_cluster(NODES, pods, seed=5, num_quotas=8,
                                   num_gangs=4)
    store = store_from_state(state)
    if "mesh" in kwargs:
        from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

        kwargs = dict(kwargs, mesh=virtual_mesh(kwargs["mesh"], "cpu"))
    sched = Scheduler(store, device="cpu", **{
        "dispatch_deadline_ms": 0,
        "ladder": degrade.DegradationLadder(promote_after=2), **kwargs})
    got = _drive(sched, store, state, _plan(port_faults, faults),
                 port_metrics, add_arrivals)
    want = _reference(name)
    cycles, transitions, retries, injected = got
    for c, (a, b) in enumerate(zip(cycles, want[0])):
        assert a == b, f"cycle {c}"
    assert transitions == want[1]
    assert retries == want[2]
    assert injected == want[3]
    # every armed fault fired, and the ladder walked as designed
    assert len(injected) == sum(kw["count"] for _k, _c, kw in faults)
    assert [(t["from"], t["to"]) for t in transitions] == walk
    assert sched.ladder.level == 0
    assert all(c[0] for c in cycles), "every cycle binds"


def test_retry_only_faults_stay_at_full():
    """The chained world: a dispatch fault, an upload OOM (rolled back by
    the mirror) and a deadline overrun each retry once at full; the storm
    then demotes the fused window (FusedDispatchDemoted re-runs the pass
    serially, whose own two failures reach the host fallback)."""
    cycles, transitions, retries, _inj = _reference("chained")
    assert [c[4] for c in cycles[:4]] == [0, 0, 0, 5]
    assert [c[3] for c in cycles[:3]] == [2, 2, 2]
    assert retries == {"fused": 5.0, "serial": 2.0}


def test_health_snapshot_carries_the_ladder():
    store, state = churn_store(8, 16, seed=0)
    sched = Scheduler(store, waves=1, device="cpu")
    assert sched.health_snapshot()["degraded"]["level_name"] == "full"
    sched.run_cycle(now=state.now)
    snap = sched.health_snapshot()
    assert snap["cycles"] == 1 and snap["last_cycle_waves"] == 1
    assert snap["degraded"] == sched.ladder.snapshot()
    assert isinstance(sched.ladder, degrade.DegradationLadder)


# ---------------------------------------------------------------------------
# what the ladder lets through
# ---------------------------------------------------------------------------


def _assert_ladder_untouched(sched, before):
    assert sched.ladder.level == 0
    assert sched.ladder.transitions == []
    assert _retries(port_metrics) == before


def test_store_write_fault_propagates_and_the_ladder_stays_full():
    store, state = churn_store(8, 40, seed=0)
    plan = port_faults.FaultPlan([port_faults.Fault(cycle=0,
                                                    kind="store_write")])
    sched = Scheduler(port_faults.FaultyStore(store, plan), waves=1,
                      device="cpu")
    before = _retries(port_metrics)
    plan.begin_cycle(0)
    with pytest.raises(port_faults.InjectedFault, match="store_write"):
        sched.run_cycle(now=state.now)
    _assert_ladder_untouched(sched, before)


@pytest.mark.parametrize("waves", [1, "auto"])
def test_in_window_flush_failure_propagates(waves):
    """Pipelined: the previous cycle's deferred condition writes flush
    inside the next dispatch window; their failure is a store fault, not
    a device fault (_HostWriteFailure is unwrapped and re-raised)."""
    store, state = churn_store(16, 300, seed=1)
    # a pod no node fits: its verdict is deferred to the next window
    add_arrivals(store, [dict(name="hog", uid="hog", prio=9000,
                              cpu=10 ** 7, mem=1024 ** 3)], state.now)
    sched = Scheduler(store, waves=waves, device="cpu")
    pipe = CyclePipeline(sched, enabled=True)
    pipe.run_cycle(now=state.now)
    add_arrivals(store, arrival_specs(1, 300), state.now + 1)
    assert sched._deferred_diagnose, "cycle 0 left verdicts to flush"

    def broken_flush():
        raise OSError("store unavailable")

    sched.flush_deferred = broken_flush
    before = _retries(port_metrics)
    with pytest.raises(OSError, match="store unavailable"):
        pipe.run_cycle(now=state.now + 2)
    _assert_ladder_untouched(sched, before)


def _nvcc_failed():
    raise KernelContractError("nvcc failed for full_chain.cu")


def _tensor_check_failed():
    import torch

    from koordinator_tpu_torch.ops.kernel_common import check_tensor

    check_tensor("records", torch.zeros(4), torch.int32, (4,))


def _launch_faulted():
    from koordinator_tpu_torch.ops.kernel_common import launch_error

    raise launch_error("full_chain round", 700,
                       "an illegal memory access was encountered")


def _readback_faulted():
    # torch's error for the kernel's fault, raised at the next sync
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def _library_load_failed():
    import ctypes

    ctypes.CDLL("/nonexistent/libfull_chain.so")


# what a broken kernel raises, from its build to its readback: none is
# a device fault, so none may reach the ladder's host fallback
KERNEL_FAILURES = {
    "nvcc": (_nvcc_failed, KernelContractError, "nvcc failed"),
    "check_tensor": (_tensor_check_failed, ValueError, "CUDA tensors"),
    "cuda_error_700": (_launch_faulted, KernelContractError,
                       "cudaError 700"),
    "readback": (_readback_faulted, RuntimeError, "illegal memory"),
    "library_load": (_library_load_failed, OSError, "libfull_chain"),
}


@pytest.mark.parametrize("failure", sorted(KERNEL_FAILURES))
@pytest.mark.parametrize("waves,overlap", [
    (1, True), ("auto", True), ("auto", False)],
    ids=["serial", "chained", "single-call"])
def test_kernel_contract_error_propagates(waves, overlap, failure):
    raise_it, exc_type, match = KERNEL_FAILURES[failure]
    store, state = churn_store(16, 300, seed=1)
    sched = Scheduler(store, waves=waves, replay_overlap=overlap,
                      device="cpu")
    sched.fault_injector = lambda stage: raise_it()
    before = _retries(port_metrics)
    assigned = sum(p.is_assigned for p in store.list(KIND_POD))
    with pytest.raises(exc_type, match=match):
        sched.run_cycle(now=state.now)
    _assert_ladder_untouched(sched, before)
    assert sum(p.is_assigned for p in store.list(KIND_POD)) == assigned


def _lose(ids, budget):
    """A dispatch hook raising a device loss that names ``ids``."""
    holder = {"n": budget}

    def hook(stage):
        if holder["n"] > 0:
            holder["n"] -= 1
            raise port_faults.DeviceLossFault(f"link down on {ids}", ids)
    return hook


def test_partial_mesh_shrinks_in_place_on_second_loss():
    """tests/test_koordguard.py's case on the port: a second device loss
    while already ON a submesh sheds only the newly named device: 8 ->
    lose {6, 7} -> 6 shards -> lose {5} -> 5 shards, still at the
    partial-mesh rung, binds continuing — never a collapse to one
    device."""
    from koordinator_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

    store, state = churn_store(16, 40, seed=23)
    sched = Scheduler(store, mesh=virtual_mesh(8, "cpu"), waves=1,
                      device="cpu")
    sched.fault_injector = _lose((6, 7), 2)
    sched.run_cycle(now=state.now)
    assert sched.ladder.level == degrade.LEVEL_PARTIAL_MESH
    assert sched.mesh.size == 6
    for i in range(4):  # fresh pending pods for the next dispatches
        store.add(KIND_POD, Pod(
            meta=ObjectMeta(name=f"fresh-{i}", namespace="t",
                            uid=f"fresh-{i}",
                            creation_timestamp=state.now + 1),
            spec=PodSpec(requests=ResourceList.of(cpu=200,
                                                  memory=1 << 28))))
    sched.fault_injector = _lose((5,), 2)
    result = sched.run_cycle(now=state.now + 5)
    assert sched.ladder.level == degrade.LEVEL_PARTIAL_MESH
    assert sched.mesh.size == 5
    assert sorted(d.id for d in sched.mesh.devices.flat) == [0, 1, 2, 3, 4]
    assert result.bound
    last = sched.ladder.transitions[-1]
    assert (last["from"], last["to"]) == ("partial-mesh", "partial-mesh")
    assert "partial-mesh" in result.demotions


def test_device_loss_on_the_mesh_matches_a_single_device_twin():
    """A loss naming 2 of 8 shards: the ladder lands on partial-mesh with
    the 6 survivors, binds continue on the submesh decision for decision
    a fault-free single-device twin's, and clean cycles re-promote to the
    whole 8-shard mesh."""
    from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

    store, state = churn_store(16, 40, seed=29)
    twin_store, _ = churn_store(16, 40, seed=29)
    sched = Scheduler(store, mesh=virtual_mesh(8, "cpu"), waves=1,
                      device="cpu",
                      ladder=degrade.DegradationLadder(promote_after=2))
    twin = Scheduler(twin_store, waves=1, device="cpu")
    sched.fault_injector = _lose((2, 5), 2)
    sizes = []
    for c in range(5):
        now = state.now + 2 * c
        if c:
            for s_ in (store, twin_store):
                add_arrivals(s_, arrival_specs(c, 8), now - 1)
        res, ref = sched.run_cycle(now=now), twin.run_cycle(now=now)
        assert ([(b.pod_key, b.node_name) for b in res.bound]
                == [(b.pod_key, b.node_name) for b in ref.bound]), c
        sizes.append(sched.mesh.size)
    assert sizes[0] == 6 and sizes[-1] == 8
    assert [(t["from"], t["to"]) for t in sched.ladder.transitions] == [
        ("full", "partial-mesh"), ("partial-mesh", "full")]


def test_anonymous_faults_drop_the_mesh_and_name_it():
    """tests/test_koordwatch.py's ladder-demotion case on the port: an
    anonymous fault burst on a mesh walks no-mesh -> serial-waves ->
    no-explain, and the next cycle's demotions name the mesh and the
    wave/explain chokepoints."""
    from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

    store, state = churn_store(8, 12, seed=3)
    sched = Scheduler(store, waves=4, explain="counts",
                      mesh=virtual_mesh(2, "cpu"), device="cpu")
    calls = {"n": 0}

    def inj(stage):
        calls["n"] += 1
        if calls["n"] <= 4:
            raise port_faults.InjectedFault("injected dispatch fault")

    sched.fault_injector = inj
    sched.run_cycle(now=state.now)
    assert sched.ladder.level >= degrade.LEVEL_SERIAL_WAVES
    add_arrivals(store, arrival_specs(1, 4), state.now + 1)
    res2 = sched.run_cycle(now=state.now + 2)
    assert "mesh-off" in res2.demotions
    assert "ladder-serial-waves" in res2.demotions
    if sched.ladder.level >= degrade.LEVEL_NO_EXPLAIN:
        assert "explain-ladder" in res2.demotions


def test_cycle_exception_dump_when_ladder_exhausted_on_mesh(monkeypatch):
    """tests/test_flight_triggers.py's mesh case on the port: every
    device dispatch fails AND the host fallback dies; the ladder walks
    mesh -> no-mesh -> host fallback (a degradation dump each), the
    bottom rung raises, and the cycle driver dumps cycle_exception and
    re-raises."""
    import koordinator_tpu_torch.scheduler.cycle as cycle_mod
    from koordinator_tpu_torch.obs.flight import load_bundle
    from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

    def dumps(reason):
        return port_metrics.FLIGHT_DUMPS.get(reason=reason) or 0.0

    store, state = churn_store(8, 16, seed=0)
    sched = Scheduler(store, waves=1, explain="off",
                      mesh=virtual_mesh(2, "cpu"), device="cpu",
                      ladder=degrade.DegradationLadder(promote_after=4))

    def dead(stage):
        raise port_faults.InjectedFault(f"device dead ({stage})")

    def host_dead(fc, pods, n_real):
        raise RuntimeError("host fallback dead too")

    sched.fault_injector = dead
    monkeypatch.setattr(cycle_mod, "host_fallback_schedule", host_dead)
    degr_before, exc_before = dumps("degradation"), dumps("cycle_exception")
    with pytest.raises(RuntimeError, match="host fallback dead"):
        sched.run_cycle(now=state.now)
    assert sched.ladder.level == degrade.LEVEL_HOST_FALLBACK
    assert dumps("degradation") == degr_before + 2
    assert dumps("cycle_exception") == exc_before + 1
    assert "host fallback dead" in sched.flight.snapshot()[-1]["error"]
    _h, _r, errors = load_bundle(sched.flight.dump("post").splitlines())
    assert not errors, errors


def test_kernel_contract_errors_are_classified():
    import torch

    from koordinator_tpu_torch.ops.kernel_common import launch_error
    from koordinator_tpu_torch.scheduler.deadline import (
        DispatchDeadlineExceeded,
    )
    from koordinator_tpu_torch.scheduler.snapshot_cache import (
        DeviceAllocationError,
    )

    for code in (1, 98, 209, 700, 719):
        err = launch_error("round", code, "x")
        assert isinstance(err, KernelContractError)
        assert f"cudaError {code}" in str(err)
        assert not degrade.is_device_fault(err)
    for exc in (port_faults.InjectedFault("x"), DeviceAllocationError("x"),
                torch.cuda.OutOfMemoryError("x"),
                DispatchDeadlineExceeded("serial", 0.01)):
        assert degrade.is_device_fault(exc), exc
    for exc in (RuntimeError("CUDA error: an illegal memory access"),
                ValueError("x"), OSError("x"), AttributeError("x"),
                NotImplementedError("x")):
        assert not degrade.is_device_fault(exc), exc
