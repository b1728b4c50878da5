"""The port's rebalance pass (koordinator_tpu_torch/balance/) against the
JAX package's, on the CPU.

The step: the same numpy inputs, made from a seed, go through the JAX
``build_rebalance_step`` and the port's on CPU tensors; every
``RebalanceOut`` field must be equal exactly (dtype and value, tolerance
0) — over seeds and caps, and on the cases that stress its exactness
(ties and -0.0 in the sort keys, pad rows, the ``active`` gate, an
unchecked high axis, the ``X == hi, lo > 0`` limb case, a global prefix
past 2^31). The rebalancer: ``DeviceRebalancer(device="cpu")`` gives the JAX
``DeviceRebalancer``'s victims, order and stats on config-5-shaped
stores, and its ladder, deadline, knob and surfaces behave as the port
documents (only device faults reach the ladder).
"""

from __future__ import annotations

import functools
import re
import time

import numpy as np
import pytest
import torch

import bench
from koordinator_tpu.balance.rebalancer import (
    DeviceRebalancer as RefDeviceRebalancer,
)
from koordinator_tpu.balance.step import (
    build_rebalance_step as ref_build_step,
)
from koordinator_tpu.descheduler.lownodeload import (
    LowNodeLoad as RefLowNodeLoad,
)

from koordinator_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.balance import (
    DeviceRebalancer,
    RebalanceOut,
    build_rebalance_step,
    rebalance_from_env,
)
from koordinator_tpu_torch.balance.step import split_rhs_limbs
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    KIND_POD_MIGRATION_JOB,
)
from koordinator_tpu_torch.descheduler.descheduler import Descheduler
from koordinator_tpu_torch.descheduler.lownodeload import (
    LowNodeLoad,
    classify_nodes,
)
from koordinator_tpu_torch.scheduler.degrade import (
    LEVEL_FULL,
    LEVEL_HOST_FALLBACK,
)
from koordinator_tpu_torch.sim.faults import InjectedFault
from koordinator_tpu_torch.testing.rebalance_fixture import rebalance_store

GIB = 1024 ** 3
NOW = 1_000_000.0
R = 4
# the default LowNodeLoad thresholds on the first two axes (cpu, memory)
LOW = np.array([45.0, 55.0, 0.0, 0.0], np.float32)
HIGH = np.array([70.0, 80.0, 0.0, 0.0], np.float32)


# ---------------------------------------------------------------------------
# the step, field for field
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_step(cap):
    return ref_build_step(cap)


def _inputs(seed, N=16, P=128):
    """Seeded step inputs with ties in cpu and priority, zero-cpu pods,
    pad rows (pod_node -1, pod_ok False) and metric-less nodes."""
    rng = np.random.default_rng(seed)
    usage = rng.choice([10.0, 30.0, 50.0, 71.0, 75.0, 90.0],
                       size=(N, R)).astype(np.float32)
    has_metric = rng.random(N) < 0.85
    alloc = rng.choice([1000.0, 4000.0, 32000.0],
                       size=(N, R)).astype(np.float32)
    hi, lo = split_rhs_limbs(usage, alloc, HIGH)
    pod_node = rng.integers(-1, N, P).astype(np.int32)
    pod_prio = rng.choice([0, 100, 9000], P).astype(np.int32)
    pod_cpu = rng.choice([0.0, 100.0, 200.0, 300.0], P).astype(np.float32)
    pod_req = rng.integers(0, 400, (P, R)).astype(np.int32)
    pod_ok = rng.random(P) < 0.8
    pod_ok[pod_node < 0] = False
    return dict(usage_pct=usage, has_metric=has_metric, low_thr=LOW.copy(),
                high_thr=HIGH.copy(), rhs_hi=hi, rhs_lo=lo,
                pod_node=pod_node, pod_prio=pod_prio, pod_cpu=pod_cpu,
                pod_req_i=pod_req, pod_ok=pod_ok)


def _run_both(inputs, cap):
    args = [inputs[k] for k in ("usage_pct", "has_metric", "low_thr",
                                "high_thr", "rhs_hi", "rhs_lo", "pod_node",
                                "pod_prio", "pod_cpu", "pod_req_i",
                                "pod_ok")]
    ref = _ref_step(cap)(*args)
    out = build_rebalance_step(cap, device="cpu")(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    return ref, out


def _assert_equal(ref, out):
    assert type(out) is RebalanceOut
    for name, r, o in zip(RebalanceOut._fields, ref, out):
        r = np.asarray(r)
        o = o.numpy()
        assert o.dtype == r.dtype, (name, o.dtype, r.dtype)
        assert o.shape == r.shape, (name, o.shape, r.shape)
        # bit for bit: signed zeros and all
        assert o.tobytes() == r.tobytes(), (name, o, r)


@pytest.mark.parametrize("cap", [1, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_step_matches_reference(seed, cap):
    inputs = _inputs(seed)
    ref, out = _run_both(inputs, cap)
    _assert_equal(ref, out)
    assert int(out.sel_count) > 0


def _no_low(inputs):
    inputs["usage_pct"][:] = 90.0
    return inputs


def _unchecked_high_axis(inputs):
    # the third axis has no threshold but reads high: it enters the
    # host's over_gate and not the margin or the still-over compare
    inputs["usage_pct"][:, 2] = 95.0
    return inputs


def _negative_zero(inputs):
    zero = inputs["pod_cpu"] == 0.0
    inputs["pod_cpu"][zero & (np.arange(zero.size) % 2 == 0)] = -0.0
    return inputs


def _all_ties(inputs):
    inputs["pod_cpu"][:] = 100.0
    inputs["pod_prio"][:] = 0
    return inputs


@pytest.mark.parametrize("edit", [_no_low, _unchecked_high_axis,
                                  _negative_zero, _all_ties],
                         ids=["no-low-node", "unchecked-high-axis",
                              "negative-zero", "all-ties"])
def test_step_matches_reference_on_edge_cases(edit):
    inputs = edit(_inputs(7))
    ref, out = _run_both(inputs, 3)
    _assert_equal(ref, out)
    if edit is _no_low:
        assert int(out.sel_count) == int(out.cand_count) == 0
        assert not out.is_low.any()


def _limb_world(lo_value):
    """One hot node whose rhs is exactly 300 in its hi limb: the fourth
    candidate's freed*100 (3 pods of 1 unit before it) hits X == hi, and
    the lo limb decides whether it is taken."""
    N, P = 8, 64
    usage = np.full((N, R), 30.0, np.float32)
    usage[0, 0] = 90.0
    pod_node = np.full(P, -1, np.int32)
    pod_node[:6] = 0
    pod_req = np.zeros((P, R), np.int32)
    pod_req[:6, 0] = 1
    pod_ok = pod_node >= 0
    rhs_hi = np.zeros((N, R), np.float32)
    rhs_hi[0, 0] = 300.0
    rhs_lo = np.zeros((N, R), np.float32)
    rhs_lo[0, 0] = lo_value
    return dict(usage_pct=usage, has_metric=np.ones(N, bool),
                low_thr=LOW.copy(), high_thr=HIGH.copy(), rhs_hi=rhs_hi,
                rhs_lo=rhs_lo, pod_node=pod_node,
                pod_prio=np.zeros(P, np.int32),
                pod_cpu=np.full(P, 100.0, np.float32), pod_req_i=pod_req,
                pod_ok=pod_ok)


@pytest.mark.parametrize("lo_value,taken", [(1e-6, 4), (0.0, 3),
                                            (-1e-6, 3)])
def test_step_limb_compare_at_x_equal_hi(lo_value, taken):
    ref, out = _run_both(_limb_world(lo_value), 5)
    _assert_equal(ref, out)
    assert int(out.sel_count) == taken


def test_step_global_prefix_past_2_31():
    """Per-node freed totals stay below 2^31 while the global prefix over
    all segments passes it (the JAX step's int32 cumsum wraps there; the
    port's int64 one does not): the outputs agree."""
    N, P = 64, 512
    usage = np.full((N, R), 20.0, np.float32)
    usage[: N // 2, 0] = 90.0
    pod_node = np.repeat(np.arange(N // 2, dtype=np.int32), 4)
    pod_node = np.concatenate([pod_node, np.full(P - pod_node.size, -1,
                                                 np.int32)])
    pod_req = np.zeros((P, R), np.int32)
    pod_req[pod_node >= 0, 0] = 2 ** 27
    total = int(pod_req[:, 0].astype(np.int64).sum())
    assert total > 2 ** 31
    per_node = np.bincount(pod_node[pod_node >= 0],
                           weights=pod_req[pod_node >= 0, 0])
    assert per_node.max() < 2 ** 31
    rng = np.random.default_rng(3)
    rhs_hi = np.zeros((N, R), np.float32)
    rhs_hi[:, 0] = rng.choice([1.0, 2.0, 3.0], N) * 2 ** 27 * 100.0 + 1.0
    inputs = dict(usage_pct=usage, has_metric=np.ones(N, bool),
                  low_thr=LOW.copy(), high_thr=HIGH.copy(), rhs_hi=rhs_hi,
                  rhs_lo=np.zeros((N, R), np.float32), pod_node=pod_node,
                  pod_prio=rng.choice([0, 5], P).astype(np.int32),
                  pod_cpu=np.full(P, 100.0, np.float32), pod_req_i=pod_req,
                  pod_ok=pod_node >= 0)
    ref, out = _run_both(inputs, 5)
    _assert_equal(ref, out)
    assert 0 < int(out.sel_count) < int(out.cand_count)


def test_step_refuses_tensors_off_its_device():
    inputs = _inputs(0)
    step = build_rebalance_step(3, device="cuda")
    with pytest.raises(ValueError, match="built for cuda"):
        step(*[torch.from_numpy(inputs[k]) for k in (
            "usage_pct", "has_metric", "low_thr", "high_thr", "rhs_hi",
            "rhs_lo", "pod_node", "pod_prio", "pod_cpu", "pod_req_i",
            "pod_ok")])


# ---------------------------------------------------------------------------
# the rebalancer against the JAX package's, on config-5-shaped stores
# ---------------------------------------------------------------------------

STORES = [(2000, 200), (3000, 256)]


@functools.lru_cache(maxsize=None)
def _reference_pass(pods, nodes):
    store = bench._build_rebalance_fixture(pods, nodes, NOW)
    plugin = RefLowNodeLoad(store)
    plugin.attach_device(RefDeviceRebalancer())
    picked, _src, view = plugin.select_victims(now=NOW)
    return picked, dict(plugin.last_pass_stats), view


def test_fixture_is_the_bench_fixture():
    def objects(store, kind):
        # nodes and metrics are stamped with the wall clock at creation
        return [re.sub(r"creation_timestamp=[0-9.e+]+", "", repr(o))
                for o in store.list(kind)]

    ref = bench._build_rebalance_fixture(300, 30, NOW)
    port = rebalance_store(300, 30, NOW)
    for kind in (KIND_NODE, KIND_NODE_METRIC, KIND_POD):
        assert objects(port, kind) == objects(ref, kind), kind
    assert objects(port, KIND_POD)[0].startswith("Pod(meta=ObjectMeta(")


@pytest.mark.parametrize("pods,nodes", STORES)
def test_rebalancer_matches_reference(pods, nodes):
    ref_picked, ref_stats, ref_view = _reference_pass(pods, nodes)
    store = rebalance_store(pods, nodes, NOW)
    plugin = LowNodeLoad(store)
    reb = DeviceRebalancer(device="cpu")
    plugin.attach_device(reb)
    picked, _src, view = plugin.select_victims(now=NOW)
    stats = dict(plugin.last_pass_stats)
    for key in ref_view:
        assert np.array_equal(view[key], ref_view[key]), key
    assert stats["engine"] == ref_stats["engine"] == "device"
    assert picked.tolist() == ref_picked.tolist()
    assert picked.size > 0
    for key in ("candidates", "victims", "ladder_level"):
        assert stats[key] == ref_stats[key], key
    for key in ("is_low", "is_high", "margin", "victim_nodes",
                "victim_scores"):
        assert np.array_equal(stats[key], ref_stats[key]), key
    # and the plain version on the same view
    assert picked.tolist() == plugin.select_victims_host(view).tolist()
    is_low, is_high = classify_nodes(
        view["usage_pct"], view["has_metric"],
        plugin._thr_vec(plugin.args.low_thresholds),
        plugin._thr_vec(plugin.args.high_thresholds))
    assert np.array_equal(stats["is_low"], is_low)
    assert np.array_equal(stats["is_high"], is_high)
    assert reb.stats["device_passes"] == 1 and reb.stats["host_passes"] == 0


# ---------------------------------------------------------------------------
# the ladder: device faults only
# ---------------------------------------------------------------------------

def _small_plugin(promote_after=2, **kw):
    store = rebalance_store(600, 60, NOW)
    plugin = LowNodeLoad(store)
    reb = DeviceRebalancer(device="cpu", promote_after=promote_after, **kw)
    plugin.attach_device(reb)
    view, _src = plugin._view(NOW)
    return plugin, reb, plugin.select_victims_host(view).tolist()


def test_injected_fault_serves_the_host_oracle_then_repromotes():
    plugin, reb, expected = _small_plugin()
    budget = {"left": 2}  # retry once, then demote

    def boom():
        if budget["left"] > 0:
            budget["left"] -= 1
            raise InjectedFault("rebalance: injected device fault")

    reb.fault_injector = boom
    picked, _src, _v = plugin.select_victims(now=NOW)
    assert plugin.last_pass_stats["engine"] == "host"
    assert picked.tolist() == expected
    assert reb.ladder.level == LEVEL_HOST_FALLBACK
    assert [(t["from"], t["to"]) for t in reb.ladder.transitions] == [
        ("full", "host-fallback")]
    plugin.select_victims(now=NOW)
    plugin.select_victims(now=NOW)
    picked2, _s, _v2 = plugin.select_victims(now=NOW)
    assert reb.ladder.level == LEVEL_FULL
    assert plugin.last_pass_stats["engine"] == "device"
    assert picked2.tolist() == expected
    assert reb.stats["host_passes"] == 3
    assert reb.failures == 2


def test_non_device_error_propagates_with_the_ladder_at_full():
    plugin, reb, _expected = _small_plugin()
    cap = plugin.args.max_pods_to_evict_per_node

    def broken(*_args):
        raise ValueError("a broken rebalance step")

    reb._steps[cap] = broken
    with pytest.raises(ValueError, match="broken rebalance step"):
        plugin.select_victims(now=NOW)
    assert reb.ladder.level == LEVEL_FULL
    assert reb.ladder.transitions == []
    assert reb.stats["host_passes"] == 0 and reb.failures == 0


def test_ineligible_view_demotes_one_pass_to_the_host():
    plugin, reb, _expected = _small_plugin()
    view, _src = plugin._view(NOW)
    view["pod_req"] = view["pod_req"] + np.float32(0.5)
    picked, stats = reb.select_victims(plugin, view, NOW)
    assert stats["engine"] == "host-ineligible"
    assert picked.tolist() == plugin.select_victims_host(view).tolist()
    assert reb.ladder.level == LEVEL_FULL


def test_slow_readback_walks_the_ladder_and_drops_the_private_mirror():
    from koordinator_tpu_torch.obs.flight import load_bundle
    from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics

    plugin, reb, expected = _small_plugin(promote_after=1,
                                          dispatch_deadline_ms=50.0)
    assert reb.dispatch_deadline_seconds == 0.05
    budget = {"left": 2}

    def slow():
        if budget["left"] > 0:
            budget["left"] -= 1
            time.sleep(0.4)

    reb.sync_delay_injector = slow
    overruns0 = (scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.get(
        path="rebalance") or 0.0)
    picked, _src, _v = plugin.select_victims(now=NOW)
    assert plugin.last_pass_stats["engine"] == "host"
    assert picked.tolist() == expected
    assert reb.ladder.level == LEVEL_HOST_FALLBACK
    assert reb.dispatch_watchdog.overruns == 2
    assert (scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.get(
        path="rebalance") or 0.0) - overruns0 == 2
    assert reb._own_snapshot is None  # the abandoned mirror is dropped
    assert reb._abandoned_out is not None
    _h, _records, errors = load_bundle(reb.flight.dump("post").splitlines())
    assert not errors, errors
    plugin.select_victims(now=NOW)
    picked2, _s, _v2 = plugin.select_victims(now=NOW)
    assert plugin.last_pass_stats["engine"] == "device"
    assert picked2.tolist() == expected
    assert reb._own_snapshot is not None
    assert reb._own_snapshot._in_flight == 0


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_mesh(ndev):
    """tests/test_balance.py TestRebalanceParityGate.test_mesh on the
    port: the co-located rebalance pass on the scheduler's mesh of ndev
    virtual CPU shards, against the host oracle."""
    from koordinator_tpu_torch.scheduler.pipeline_parity import (
        run_rebalance_parity,
    )

    rep = run_rebalance_parity(ndev, device="cpu")
    assert rep["ok"], rep["mismatches"]
    assert rep["ndev"] == ndev


def test_mesh_rung_drops_to_single_device():
    """A mesh fault demotes the pass to the single-device rung (no-mesh),
    still on the device engine, with the host oracle's victims."""
    from koordinator_tpu_torch.scheduler.degrade import LEVEL_NO_MESH
    from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

    plugin, reb, expected = _small_plugin(
        promote_after=64, mesh=virtual_mesh(2, "cpu"))
    budget = {"left": 2}

    def boom():
        if budget["left"] > 0:
            budget["left"] -= 1
            raise InjectedFault("injected mesh fault")

    reb.fault_injector = boom
    picked, _src, _v = plugin.select_victims(now=NOW)
    assert reb.ladder.level == LEVEL_NO_MESH
    assert plugin.last_pass_stats["engine"] == "device"
    assert picked.tolist() == expected
    # the demoted pass ran the single-device step on a private mirror
    assert reb._active_mesh() is None
    assert list(reb._steps) == [plugin.args.max_pods_to_evict_per_node]
    assert reb._own_snapshot is not None and reb._own_snapshot.mesh is None


def test_mesh_pass_matches_single_device_pass():
    """The sharded pass on 3 shards (a non-divisible padding) gives the
    single-device pass's victims, classification and margins."""
    from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

    plugin, _reb, expected = _small_plugin()
    picked1, _s, _v = plugin.select_victims(now=NOW)
    single = dict(plugin.last_pass_stats)
    plugin3, reb3, _e = _small_plugin(mesh=virtual_mesh(3, "cpu"))
    picked3, _s, _v = plugin3.select_victims(now=NOW)
    stats = plugin3.last_pass_stats
    assert stats["engine"] == "device" and reb3.mesh.size == 3
    assert picked3.tolist() == picked1.tolist() == expected
    for key in ("is_low", "is_high", "margin", "victim_nodes",
                "victim_scores"):
        np.testing.assert_array_equal(stats[key], single[key], err_msg=key)


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceRebalancer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Descheduler(rebalance_store(10, 2, NOW), rebalance="on")


# ---------------------------------------------------------------------------
# the shared mirror: rb_* fields beside the scheduler's own
# ---------------------------------------------------------------------------

def test_rebalance_fields_ride_the_scheduler_mirror():
    from koordinator_tpu_torch.scheduler.cycle import Scheduler

    store = rebalance_store(400, 40, NOW)
    # a few pending pods so the scheduler's own fields are on the mirror
    for i in range(8):
        store.add(KIND_POD, Pod(
            meta=ObjectMeta(name=f"pending-{i}", uid=f"pending-{i}",
                            creation_timestamp=NOW),
            spec=PodSpec(priority=100, requests=ResourceList.of(
                cpu=500, memory=GIB))))
    sched = Scheduler(store, waves=1, device="cpu")
    desch = Descheduler(store, scheduler=sched, rebalance="on")
    sched.run_cycle(now=NOW)
    snap = sched.device_snapshot
    own = {k: v for k, v in snap._fields.items() if not k.startswith("rb_")}
    assert own
    plugin = desch.profiles[0].balance_plugins[0].inner
    assert plugin.pack_cache is sched.snapshot_cache.rebalance_pack(
        plugin.args.node_metric_expiration_seconds)
    picked, _src, view = plugin.select_victims(now=NOW)
    assert plugin.last_pass_stats["engine"] == "device"
    rb = {k: v[1] for k, v in snap._fields.items() if k.startswith("rb_")}
    assert {k: t.dtype for k, t in rb.items()} == {
        "rb_usage_pct": torch.float32, "rb_has_metric": torch.bool,
        "rb_low_thr": torch.float32, "rb_high_thr": torch.float32,
        "rb_rhs_hi": torch.float32, "rb_rhs_lo": torch.float32,
        "rb_pod_node": torch.int32, "rb_pod_prio": torch.int32,
        "rb_pod_cpu": torch.float32, "rb_pod_req": torch.int32,
        "rb_pod_ok": torch.bool}
    for k, (host, dev) in own.items():  # untouched by the pass
        assert snap._fields[k][0] is host and snap._fields[k][1] is dev, k
    # a second pass after one pod departs: the pod rows scatter, the
    # node rows whose metric did not move are reused
    stats0 = dict(snap.stats)
    store.delete(KIND_POD, store.list(KIND_POD)[0].meta.key)
    picked2, _src2, view2 = plugin.select_victims(now=NOW)
    assert plugin.last_pass_stats["engine"] == "device"
    assert picked2.tolist() == plugin.select_victims_host(view2).tolist()
    assert snap.stats["scattered"] > stats0["scattered"]
    assert snap.stats["reused"] > stats0["reused"]
    assert sched.ladder.level == LEVEL_FULL


def test_shared_pack_adds_no_store_subscription():
    from koordinator_tpu_torch.scheduler.cycle import Scheduler

    store = rebalance_store(40, 4, NOW)
    sched = Scheduler(store, waves=1, device="cpu")
    kinds = (KIND_POD, KIND_NODE, KIND_NODE_METRIC)
    before = {k: len(store._collections[k].handlers) for k in kinds}
    pack = sched.snapshot_cache.rebalance_pack(300.0)
    assert sched.snapshot_cache.rebalance_pack(300.0) is pack
    assert {k: len(store._collections[k].handlers) for k in kinds} == before
    standalone = LowNodeLoad(store)._view(NOW)[0]
    store.delete(KIND_POD, store.list(KIND_POD)[0].meta.key)
    nm = store.get(KIND_NODE_METRIC, "/node-1")
    nm.update_time = NOW - 1
    store.update(KIND_NODE_METRIC, nm)
    fresh = LowNodeLoad(store, incremental=False)._view(NOW)[0]
    shared = pack.view(NOW)
    assert set(shared) == set(standalone)
    # the shared pack followed the events: the cold walk agrees on the
    # node side and on the live pods
    for key in ("alloc", "usage_pct", "has_metric"):
        assert np.array_equal(shared[key], fresh[key]), key
    assert int(shared["pod_alive"].sum()) == fresh["pod_node"].size


# ---------------------------------------------------------------------------
# the knob and the surfaces
# ---------------------------------------------------------------------------

def test_rebalance_from_env(monkeypatch):
    monkeypatch.delenv("KOORD_TPU_REBALANCE", raising=False)
    assert rebalance_from_env() == "on"
    for raw, mode in (("host", "host"), ("off", "off"), ("bogus", "on")):
        monkeypatch.setenv("KOORD_TPU_REBALANCE", raw)
        assert rebalance_from_env() == mode


def test_off_is_a_kill_switch_and_host_attaches_nothing():
    store = rebalance_store(600, 60, NOW)
    Descheduler(store, rebalance="off").run_once(now=NOW)
    assert store.list(KIND_POD_MIGRATION_JOB) == []
    desch = Descheduler(store, rebalance="host")
    assert desch.rebalancer is None
    desch.run_once(now=NOW)
    assert store.list(KIND_POD_MIGRATION_JOB)


def test_span_tree_metrics_and_flight_ring():
    from koordinator_tpu_torch.descheduler import metrics as dm
    from koordinator_tpu_torch.obs.flight import validate_cycle_record

    plugin, reb, expected = _small_plugin()
    c0 = dm.REBALANCE_CANDIDATES.get() or 0.0
    v0 = dm.REBALANCE_VICTIMS.get() or 0.0
    jobs = plugin.balance(now=NOW)
    assert len(jobs) == len(expected) > 0
    roots = [r for r in plugin.tracer.roots() if r.name == "rebalance"]
    assert roots
    assert {"classify", "score", "readback", "migrate"} <= {
        s.name for s in roots[-1].walk()}
    assert (dm.REBALANCE_CANDIDATES.get() or 0.0) > c0
    assert (dm.REBALANCE_VICTIMS.get() or 0.0) == v0 + len(expected)
    record = reb.flight.snapshot()[-1]
    assert validate_cycle_record(record) == []
    assert record["metrics"]["rebalance_device"] == 1.0
    assert record["decision_id"] == reb.last_decision_id
    assert reb.timeline.snapshot()[-1]["outcome"] == "clean"
