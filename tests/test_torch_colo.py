"""The port's colo pass (koordinator_tpu_torch/colo/) against the JAX
package's, on the CPU.

The step: the same numpy packs, made from a seed, go through the JAX
``build_colo_step(jit=False)`` and the port's on CPU tensors; every
``ColoOut`` field must be equal exactly (dtype and value, tolerance 0) —
under all three calculate policies, with degraded and pad rows, a 3-level
quota tree, a tree whose mins AutoScaleMin must shrink, a level that
needs many water-filling iterations, and no quota at all.
``predicted_total`` is compared in
every world here: each lies inside the f32-exact envelope, the only
place the reconciler reads it. ``_exact_floordiv`` is held to the JAX
function and to int64 floor division where ``a*m`` passes 2^31, and the
host oracle ``_batch_mid_kernel`` to the JAX one: its op sequence bit
for bit, and the jitted one's published integers.

The reconciler: ``_device_eligible``'s reason strings equal the JAX
package's on out-of-envelope views; only device faults reach the ladder;
the co-located pass uploads into the scheduler's mirror; and
``run_colo_parity`` runs in both packages with every manager tick,
revoke pass and scheduling cycle recorded — the batch/mid allocatable,
degraded sets, device runtime matrices, revoke victim lists and binding
logs must be equal between the packages, round by round. Each JAX
reference run is made once per process (cached).
"""

from __future__ import annotations

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.colo.reconciler import (
    DeviceColoReconciler as RefReconciler,
)
from koordinator_tpu.colo.step import _exact_floordiv as ref_floordiv
from koordinator_tpu.colo.step import build_colo_step as ref_build_step
from koordinator_tpu.slocontroller.noderesource import (
    _batch_mid_kernel as ref_batch_mid,
)

from koordinator_tpu_torch.api.objects import (
    ElasticQuota,
    Node,
    NodeMetric,
    NodeMetricInfo,
    ObjectMeta,
)
from koordinator_tpu_torch.api.resources import (
    NUM_RESOURCES,
    RESOURCE_INDEX,
    ResourceList,
    ResourceName,
)
from koordinator_tpu_torch.client.store import (
    KIND_ELASTIC_QUOTA,
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    ObjectStore,
)
from koordinator_tpu_torch.colo import (
    COLO_NODE_FIELDS,
    ColoOut,
    DeviceColoReconciler,
    build_colo_step,
    colo_from_env,
)
from koordinator_tpu_torch.colo.step import (
    NUM_LEVELS,
    STEP_FIELDS,
    _exact_floordiv,
    device_runtime_quotas,
    water_fill_plan,
)
from koordinator_tpu_torch.manager import Manager
from koordinator_tpu_torch.ops.quota import (
    build_quota_tree,
    compute_runtime_quotas,
)
from koordinator_tpu_torch.scheduler.cycle import Scheduler
from koordinator_tpu_torch.scheduler.degrade import (
    LEVEL_FULL,
    LEVEL_HOST_FALLBACK,
)
from koordinator_tpu_torch.sim.faults import InjectedFault
from koordinator_tpu_torch.slocontroller.noderesource import (
    _batch_mid_kernel,
)

GIB = 1024 ** 3
NOW = 1_000_000.0
R = NUM_RESOURCES
CPU = RESOURCE_INDEX[ResourceName.CPU]
MEM = RESOURCE_INDEX[ResourceName.MEMORY]
OVERCOMMIT = [RESOURCE_INDEX[n] for n in (
    ResourceName.BATCH_CPU, ResourceName.BATCH_MEMORY, ResourceName.MID_CPU,
    ResourceName.MID_MEMORY)]
POLICIES = [("usage", "usage"), ("request", "maxUsageRequest"),
            ("maxUsageRequest", "request")]
BATCH_CPU = ResourceName.BATCH_CPU


# ---------------------------------------------------------------------------
# seeded packs
# ---------------------------------------------------------------------------

def _node_arrays(rng, n_real=13, n_pad=16):
    """The 11 [N, R] node columns and ``degraded``, padded the way the
    reconciler pads them (zero rows, not degraded)."""
    def col(lo, hi):
        x = rng.uniform(lo, hi, (n_pad, R)).astype(np.float32)
        x[n_real:] = 0.0
        return x

    capacity = col(1e3, 1e5)
    node_reserved, system_reserved = col(0, 2e3), col(0, 2e3)
    node_used, pod_all_used = col(0, 6e4), col(0, 5e4)
    hp_used, hp_request = col(0, 3e4), col(0, 4e4)
    hp_max = np.maximum(hp_used, hp_request)
    prod_reclaimable = col(0, 2e4)
    reclaim = np.zeros((n_pad, R), np.float32)
    mid_pct = np.zeros((n_pad, R), np.float32)
    for axis in (CPU, MEM):
        reclaim[:n_real, axis] = rng.integers(40, 100, n_real)
        mid_pct[:n_real, axis] = rng.integers(0, 40, n_real)
    degraded = rng.random(n_pad) < 0.25
    degraded[n_real:] = False
    return [capacity, node_reserved, system_reserved, node_used,
            pod_all_used, hp_used, hp_request, hp_max, prod_reclaimable,
            reclaim, mid_pct, degraded]


def _tree(parent, g_pad):
    """Padded parent/level/valid arrays for a tree given by parents."""
    G = len(parent)
    level = np.zeros(G, np.int32)
    for i in range(G):
        g = i
        while parent[g] >= 0:
            g = parent[g]
            level[i] += 1
    q_parent = np.full(g_pad, -1, np.int32)
    q_level = np.full(g_pad, -1, np.int32)
    q_parent[:G] = parent
    q_level[:G] = level
    valid = np.zeros(g_pad, bool)
    valid[:G] = True
    return q_parent, q_level, valid


def _quota_arrays(rng, kind, g_pad=16):
    """The quota side in STEP_FIELDS order (from q_parent on)."""
    if kind == "none":
        parent = []
    elif kind == "many-iterations":
        # a root and 10 equal-weight children, one saturating per round
        parent = [-1] + [0] * 10
    else:
        parent = [-1, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 3]
    G = len(parent)
    q_parent, q_level, valid = _tree(np.asarray(parent, np.int32), g_pad)

    def mat(lo, hi):
        x = np.zeros((g_pad, R), np.float32)
        x[:G] = rng.integers(lo, hi, (G, R))
        return x

    q_min, q_max = mat(0, 4000), mat(0, 1)
    q_max[:G] = q_min[:G] + rng.integers(0, 30000, (G, R))
    q_weight, q_guarantee = mat(0, 4), mat(0, 1500)
    q_guarantee[rng.random((g_pad, R)) < 0.6] = 0.0
    q_request, q_used = mat(0, 12000), mat(0, 12000)
    allow = np.zeros(g_pad, bool)
    enable = np.zeros(g_pad, bool)
    allow[:G] = rng.random(G) < 0.7
    enable[:G] = rng.random(G) < 0.8
    total = rng.integers(20_000, 80_000, R).astype(np.float32)
    if kind == "scaled":
        # the cluster below the root's children's mins: AutoScaleMin
        total = rng.integers(2_000, 6_000, R).astype(np.float32)
        enable[:G] = True
        enable[1] = False
    if kind == "many-iterations":
        # round t hands each of the n - t + 1 children still adjustable
        # d_t; child t's request sits (n - t) * d_{t+1} below its total
        # so its overshoot is exactly next round's share, and child t+1's
        # 1 above the total before round t+1: one child leaves per round,
        # n rounds (d_t = (n - t) d_{t+1} + 1 keeps every quotient exact)
        n = G - 1
        d = [0] * (n + 2)
        d[n] = 1
        for t in range(n - 1, 0, -1):
            d[t] = (n - t) * d[t + 1] + 1
        c = np.cumsum(d[1:n + 1])
        req = [c[t - 1] - (n - t) * d[t + 1] for t in range(1, n + 1)]
        q_min[:G] = q_guarantee[:G] = 0.0
        q_weight[:G] = 1.0
        q_max[:G] = 2.0 ** 24 - 1
        q_min[0] = q_request[0] = n * d[1]
        q_request[1:G] = np.asarray(req, np.float32)[:, None]
        allow[:G] = enable[:G] = True
        total = np.full(R, n * d[1] + 1000, np.float32)
    if kind == "none":
        # no quota: the reconciler's zero total, all pad rows
        total = np.zeros(R, np.float32)
    total[OVERCOMMIT] = 0.0
    return [q_parent, q_level, q_min, q_max, q_weight, q_guarantee,
            q_request, q_used, allow, enable, valid, total]


def _world(seed, kind):
    rng = np.random.default_rng(seed)
    return _node_arrays(rng) + _quota_arrays(rng, kind)


WORLDS = [(3, "tree3"), (5, "tree3"), (7, "scaled"), (11, "many-iterations"),
          (13, "none")]


@functools.lru_cache(maxsize=None)
def _reference(seed, kind, policy):
    arrays = _world(seed, kind)
    out = ref_build_step(*policy, jit=False)(
        *[jnp.asarray(a) for a in arrays])
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


def _port(arrays, policy, plan):
    step = build_colo_step(*policy, device="cpu")
    out = step(*[torch.from_numpy(a) for a in arrays], plan=plan)
    return {f: getattr(out, f).numpy() for f in out._fields}


def _assert_equal(port, ref):
    assert list(port) == list(ref) == list(ColoOut._fields)
    for field in ref:
        assert port[field].dtype == ref[field].dtype, field
        assert port[field].shape == ref[field].shape, field
        assert np.array_equal(port[field], ref[field]), field


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: "-".join(p))
@pytest.mark.parametrize("seed,kind", WORLDS,
                         ids=[f"{k}-{s}" for s, k in WORLDS])
def test_step_matches_reference(seed, kind, policy):
    arrays = _world(seed, kind)
    q = dict(zip(STEP_FIELDS, arrays))
    plan = water_fill_plan(q["q_level"], q["q_weight"], q["q_valid"],
                           q["q_parent"].shape[0])
    _assert_equal(_port(arrays, policy, plan), _reference(seed, kind, policy))


def test_worlds_reach_the_cases_they_name():
    """The seeded worlds are not vacuous: degraded and pad rows exist,
    AutoScaleMin engages, the fold revokes, and the many-iterations
    level needs many water-filling rounds — no more than the plan's."""
    arrays = _world(7, "scaled")
    q = dict(zip(STEP_FIELDS, arrays))
    assert q["degraded"].any() and not q["capacity"][13:].any()
    children = (q["q_level"] == 1)
    # the root's runtime (<= total) is below its children's min sum
    assert (q["q_min"][children].sum(axis=0) > q["q_total_base"]).any()
    assert _reference(3, "tree3", POLICIES[0])["revoke_mask"].any()

    arrays = _world(11, "many-iterations")
    q = dict(zip(STEP_FIELDS, arrays))
    gp = q["q_parent"].shape[0]
    plan = water_fill_plan(q["q_level"], q["q_weight"], q["q_valid"], gp)
    assert plan == (2, 11, -1, -1, -1)
    full = _port(arrays, POLICIES[0], plan)["runtime"]
    # the fewest iterations at level 1 that reach the loop's result
    needed = next(k for k in range(plan[1] + 1) if np.array_equal(
        _port(arrays, POLICIES[0], (plan[0], k, -1, -1, -1))["runtime"],
        full))
    assert needed == 10


def test_water_fill_plan_counts_levels_and_weights():
    q_level = np.array([0, 1, 1, 1, 2, -1, -1, -1], np.int32)
    q_valid = q_level >= 0
    w = np.zeros((8, R), np.float32)
    w[1:3, 0] = 1.0      # two weighted rows on axis 0 at level 1
    w[3, 1] = 2.0        # one on axis 1
    w[4, :] = 1.0
    w[6, :] = 5.0        # a pad row never counts
    assert water_fill_plan(q_level, w, q_valid, 8) == (1, 3, 2, -1, -1)
    assert len(water_fill_plan(q_level, w, q_valid, 8)) == NUM_LEVELS
    # the cap, gp + 2, bounds a level with more weighted rows than that
    assert water_fill_plan(np.zeros(4, np.int32), np.ones((4, R)),
                           np.ones(4, bool), 2) == (4, -1, -1, -1, -1)


def test_step_refuses_tensors_on_another_device():
    arrays = [torch.from_numpy(a) for a in _world(3, "tree3")]
    step = build_colo_step("usage", "usage", device="cuda")
    plan = (-1,) * NUM_LEVELS
    with pytest.raises(ValueError, match="colo step built for cuda"):
        step(*arrays, plan=plan)
    with pytest.raises(TypeError, match="24 arrays"):
        build_colo_step("usage", "usage", device="cpu")(*arrays[:3],
                                                        plan=plan)


def test_exact_floordiv_past_int32():
    """a*m up to 2^48: the int64 correction gives the exact floor, as the
    JAX step's int32 modular one does."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2 ** 24, size=512).astype(np.float32)
    s = rng.integers(1, 2 ** 24, size=512).astype(np.float32)
    m = (s * rng.random(512)).astype(np.int64).astype(np.float32)
    am = a.astype(np.int64) * m.astype(np.int64)
    assert (am >= 2 ** 31).mean() > 0.5
    want = (am // s.astype(np.int64)).astype(np.float32)
    got = _exact_floordiv(torch.from_numpy(a), torch.from_numpy(m),
                          torch.from_numpy(s)).numpy()
    ref = np.asarray(ref_floordiv(jnp.asarray(a), jnp.asarray(m),
                                  jnp.asarray(s)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref)


def _integer_packs(rng, n=4096):
    """Node columns as ColoPack builds them: milli-cores and MiB, so
    integer-valued, with integer percentages."""
    def ints(lo, hi):
        return rng.integers(lo, hi, (n, R)).astype(np.float32)

    hp_used, hp_request = ints(0, 300_000), ints(0, 300_000)
    return [ints(1000, 1_000_000), ints(0, 4000), ints(0, 4000),
            ints(0, 500_000), ints(0, 400_000), hp_used, hp_request,
            np.maximum(hp_used, hp_request), ints(0, 200_000),
            ints(40, 100), ints(0, 40), rng.random(n) < 0.1]


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: "-".join(p))
def test_host_oracle_matches_reference(policy):
    """The port's host oracle (torch on CPU tensors) against the JAX
    package's ``_batch_mid_kernel``. Its op sequence, run eagerly
    (``__wrapped__``), gives the same f32 bits on any input. The jitted
    one XLA compiles with the division by 100 rewritten as a
    multiplication by f32(0.01), so its f32 values can differ in the last
    bit; on the integer-valued packs the system builds, the integers the
    writeback publishes (``int()`` of each value) are the same."""
    t = torch.from_numpy
    arrays = _node_arrays(np.random.default_rng(17))
    batch, mid = _batch_mid_kernel(*[t(a) for a in arrays],
                                   cpu_policy=policy[0],
                                   memory_policy=policy[1])
    rb, rm = ref_batch_mid.__wrapped__(*[jnp.asarray(a) for a in arrays],
                                       cpu_policy=policy[0],
                                       memory_policy=policy[1])
    assert np.array_equal(batch.numpy(), np.asarray(rb))
    assert np.array_equal(mid.numpy(), np.asarray(rm))

    packs = _integer_packs(np.random.default_rng(19))
    batch, mid = _batch_mid_kernel(*[t(a) for a in packs],
                                   cpu_policy=policy[0],
                                   memory_policy=policy[1])
    rb, rm = ref_batch_mid(*[jnp.asarray(a) for a in packs],
                           cpu_policy=policy[0], memory_policy=policy[1])
    for port, ref in ((batch, rb), (mid, rm)):
        assert np.array_equal(port.numpy().astype(np.int64),
                              np.asarray(ref).astype(np.int64))


def _eq(name, min_cpu, max_cpu, parent=None, labels=None):
    labels = dict(labels or {})
    if parent:
        labels["quota.scheduling.koordinator.sh/parent"] = parent
    return ElasticQuota(
        meta=ObjectMeta(name=name, namespace="t", labels=labels),
        min=ResourceList.of(cpu=min_cpu, memory=min_cpu * 1024 * 1024),
        max=ResourceList.of(cpu=max_cpu, memory=max_cpu * 1024 * 1024))


@pytest.mark.parametrize("total_cpu", [13_001, 13_003, 20_999, 21_000, 1,
                                       6_999])
def test_fold_matches_host_compute_runtime_quotas(total_cpu):
    """AutoScaleMin against the port's host fold: the fold's one float64
    site (floor(avail*min/sum)) exact through _exact_floordiv."""
    quotas = [_eq("sa", 7_000, 50_000), _eq("sb", 9_000, 50_000),
              _eq("sc", 5_000, 50_000)]
    requests = {
        name: ResourceList.of(cpu=c, memory=m * 1024 * 1024).to_vector()
        for name, c, m in (("sa", 30_000, 3000), ("sb", 10_000, 900),
                           ("sc", 2_000, 100))}
    tree = build_quota_tree(quotas, pod_requests_by_quota=requests)
    total = np.zeros(R, np.float32)
    total[CPU] = total[MEM] = total_cpu
    host = compute_runtime_quotas(tree, total)
    G = len(tree.names)
    t = torch.from_numpy
    dev = device_runtime_quotas(
        t(tree.parent.astype(np.int32)), t(tree.level.astype(np.int32)),
        t(tree.min.astype(np.float32)), t(tree.max.astype(np.float32)),
        t(tree.shared_weight.astype(np.float32)),
        t(tree.guarantee.astype(np.float32)),
        t(tree.request.astype(np.float32)), t(np.ones(G, bool)),
        t(tree.allow_lent.astype(bool)), t(np.ones(G, bool)), t(total),
        water_fill_plan(tree.level, tree.shared_weight, np.ones(G, bool),
                        G))
    assert np.array_equal(dev.numpy(), host)


# ---------------------------------------------------------------------------
# the reconciler
# ---------------------------------------------------------------------------

def _qv(G=3, **override):
    """An in-envelope quota view: a root and two children."""
    qv = {
        "q_parent": np.array([-1, 0, 0], np.int32)[:G],
        "q_min": np.full((G, R), 100.0, np.float32),
        "q_guarantee": np.zeros((G, R), np.float32),
        "q_request": np.full((G, R), 200.0, np.float32),
        "q_weight": np.ones((G, R), np.float32),
        "q_total": np.full(R, 50_000.0, np.float32),
    }
    qv.update(override)
    return qv


ELIGIBILITY = {
    "no-quota": (None, None),
    "in-envelope": (_qv(), None),
    "fraction": (_qv(q_min=np.full((3, R), 100.5, np.float32)),
                 "non-integer q_min rows"),
    "fraction-weight": (_qv(q_weight=np.full((3, R), 0.5, np.float32)),
                        "non-integer q_weight rows"),
    "total": (_qv(q_total=np.full(R, 2.0 ** 24, np.float32)),
              "cluster total exceeds the f32-exact bound"),
    "min-sum": (_qv(q_min=np.full((3, R), 2.0 ** 23, np.float32)),
                "per-parent min sums exceed the f32-exact bound"),
    "guarantee-sum": (_qv(q_guarantee=np.full((3, R), 2.0 ** 23,
                                              np.float32)),
                      "per-parent min sums exceed the f32-exact bound"),
    "request-sum": (_qv(q_request=np.full((3, R), 2.0 ** 23, np.float32)),
                    "per-parent request sums exceed the f32-exact bound"),
    "weight-sum": (_qv(q_weight=np.full((3, R), 2.0 ** 23, np.float32)),
                   "per-parent weight sums exceed the f32-exact bound"),
}


@pytest.mark.parametrize("case", sorted(ELIGIBILITY))
def test_device_eligible_reasons_match_reference(case):
    qv, want = ELIGIBILITY[case]
    assert DeviceColoReconciler._device_eligible(qv) == want
    assert RefReconciler._device_eligible(qv) == want


def _store(nodes=4, usage_cpu=3000):
    store = ObjectStore()
    for i in range(nodes):
        store.add(KIND_NODE, Node(
            meta=ObjectMeta(name=f"n{i}", namespace=""),
            allocatable=ResourceList.of(cpu=16_000, memory=64 * GIB,
                                        pods=64)))
        store.add(KIND_NODE_METRIC, NodeMetric(
            meta=ObjectMeta(name=f"n{i}", namespace=""),
            update_time=NOW,
            node_metric=NodeMetricInfo(node_usage=ResourceList.of(
                cpu=usage_cpu, memory=8 * GIB))))
    return store


def _alloc(store):
    return {n.meta.name: dict(n.allocatable.quantities)
            for n in store.list(KIND_NODE)}


def test_colo_from_env(monkeypatch):
    for raw, want in (("", "on"), ("device", "on"), ("off", "off"),
                      ("0", "off"), ("host", "host"), ("bogus", "on")):
        monkeypatch.setenv("KOORD_TPU_COLO", raw)
        assert colo_from_env() == want


def test_non_device_fault_passes_through_the_ladder():
    store = _store(nodes=2)
    mgr = Manager(store, colo="on", device="cpu")

    def boom():
        raise RuntimeError("a broken pass, not a device fault")

    mgr.colo.fault_injector = boom
    with pytest.raises(RuntimeError, match="a broken pass"):
        mgr.colo.reconcile(now=NOW + 1)
    assert mgr.colo.ladder.level == LEVEL_FULL
    assert mgr.colo.ladder.transitions == []
    assert mgr.colo.failures == 0
    assert mgr.colo.stats["host_passes"] == 0


def test_device_fault_retries_demotes_and_repromotes():
    store = _store(nodes=2)
    twin_store = _store(nodes=2)
    mgr = Manager(store, colo="on", device="cpu")
    twin = Manager(twin_store, colo="host", device="cpu")
    mgr.colo.ladder.promote_after = 2
    mgr.colo.ladder._base_promote_after = 2
    calls = {"n": 0}

    def fault():
        calls["n"] += 1
        raise InjectedFault("injected colo fault")

    mgr.colo.fault_injector = fault
    changes = mgr.colo.reconcile(now=NOW + 1)
    twin.colo.reconcile(now=NOW + 1)
    # retry once at-level, then straight to the host fallback (no mesh
    # rung on one card); the decisions still land, equal to the twin's
    assert calls["n"] == 2 and mgr.colo.failures == 2
    assert mgr.colo.ladder.level == LEVEL_HOST_FALLBACK
    assert mgr.colo.last_pass_stats["engine"] == "host"
    assert changes > 0 and _alloc(store) == _alloc(twin_store)
    mgr.colo.fault_injector = None
    for k in range(2, 5):
        mgr.colo.reconcile(now=NOW + k)
    assert mgr.colo.ladder.level == LEVEL_FULL
    assert mgr.colo.last_pass_stats["engine"] == "device"


def test_deadline_overrun_abandons_and_demotes():
    import time as _time

    store = _store(nodes=2)
    mgr = Manager(store, colo="on", device="cpu")
    mgr.colo.dispatch_deadline_seconds = 0.05
    mgr.colo.dispatch_watchdog.deadline_seconds = 0.05
    mgr.colo.sync_delay_injector = lambda: _time.sleep(0.3)
    changes = mgr.colo.reconcile(now=NOW + 1)
    assert mgr.colo.dispatch_watchdog.overruns == 2
    assert mgr.colo.last_pass_stats["engine"] == "host"
    assert mgr.colo._abandoned_out is not None
    assert changes > 0


def test_host_ineligible_is_counted_and_keeps_the_oracle():
    store = _store(nodes=2)
    store.add(KIND_ELASTIC_QUOTA, ElasticQuota(
        meta=ObjectMeta(name="frac", namespace="t"),
        min=ResourceList.of(cpu=1000, memory=GIB + 512 * 1024),
        max=ResourceList.of(cpu=2000, memory=2 * GIB)))
    mgr = Manager(store, colo="on", device="cpu")
    assert mgr.tick(now=NOW + 1)
    assert mgr.colo.last_pass_stats["engine"] == "host-ineligible"
    assert mgr.colo.stats["ineligible_passes"] == 1
    assert mgr.colo.stats["host_passes"] == 1
    assert store.get(KIND_NODE, "/n0").allocatable[BATCH_CPU] > 0


def test_mesh_and_missing_card_raise(monkeypatch):
    store = _store(nodes=1)
    monkeypatch.setenv("KOORD_TPU_MESH", "4")
    with pytest.raises(NotImplementedError, match="parallel/"):
        Manager(store, colo="on", device="cpu")
    monkeypatch.delenv("KOORD_TPU_MESH")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Manager(_store(nodes=1), colo="on")


def test_colocated_pass_uses_the_scheduler_mirror():
    store = _store()
    sched = Scheduler(store, device="cpu")
    handlers = {kind: len(store._collections[kind].handlers)
                for kind in (KIND_POD, KIND_NODE, KIND_NODE_METRIC)}
    mgr = Manager(store, scheduler=sched, colo="on")
    # the pack rides the SnapshotCache's chain: no new watch
    assert handlers == {kind: len(store._collections[kind].handlers)
                        for kind in handlers}
    assert mgr.colo.pack is sched.snapshot_cache.colo_pack(None)
    assert mgr.colo.device == sched.device
    assert mgr.tick(now=NOW + 1)
    assert mgr.colo.last_pass_stats["engine"] == "device"
    fields = set(sched.device_snapshot._fields)
    assert set(COLO_NODE_FIELDS) <= fields
    assert mgr.colo._own_snapshot is None
    assert store.get(KIND_NODE, "/n0").allocatable[BATCH_CPU] > 0


# ---------------------------------------------------------------------------
# run_colo_parity in both packages, every round recorded
# ---------------------------------------------------------------------------

def _recorded_parity(pkg, monkeypatch_cls):
    """Run ``pkg``'s run_colo_parity with its Manager.tick, the overuse
    revoke pass and Scheduler.run_cycle wrapped to record what each
    returned and wrote, in call order."""
    manager = importlib.import_module(f"{pkg}.manager")
    cycle = importlib.import_module(f"{pkg}.scheduler.cycle")
    eq = importlib.import_module(f"{pkg}.scheduler.plugins.elasticquota")
    parity = importlib.import_module(f"{pkg}.scheduler.pipeline_parity")
    kind_node = importlib.import_module(f"{pkg}.client.store").KIND_NODE
    log = []
    tick = manager.Manager.tick
    run_cycle = cycle.Scheduler.run_cycle
    revoke = eq.QuotaOveruseRevokeController.reconcile

    def tick_rec(self, now=None):
        led = tick(self, now)
        stats = self.colo.last_pass_stats
        runtime = stats.get("runtime")
        log.append(("tick", self.identity, led, stats.get("engine"),
                    sorted((n.meta.name, sorted(
                        (str(k), v) for k, v in
                        n.allocatable.quantities.items()))
                        for n in self.store.list(kind_node)),
                    np.asarray(stats["degraded"]).tolist(),
                    None if runtime is None
                    else np.asarray(runtime).tolist()))
        return led

    def cycle_rec(self, *args, **kwargs):
        res = run_cycle(self, *args, **kwargs)
        log.append(("cycle", [(b.pod_key, b.node_name) for b in res.bound]))
        return res

    def revoke_rec(self, now):
        victims = revoke(self, now)
        log.append(("revoke", list(victims)))
        return victims

    monkeypatch_cls(manager.Manager, "tick", tick_rec)
    monkeypatch_cls(cycle.Scheduler, "run_cycle", cycle_rec)
    monkeypatch_cls(eq.QuotaOveruseRevokeController, "reconcile", revoke_rec)
    if pkg == "koordinator_tpu":
        report = parity.run_colo_parity()
    else:
        report = parity.run_colo_parity(device="cpu")
    return report, log


@functools.lru_cache(maxsize=None)
def _parity(pkg):
    mp = pytest.MonkeyPatch()
    try:
        return _recorded_parity(pkg, mp.setattr)
    finally:
        mp.undo()


def test_run_colo_parity_passes_in_both_packages():
    for pkg in ("koordinator_tpu_torch", "koordinator_tpu"):
        report, log = _parity(pkg)
        assert report["ok"], (pkg, report["mismatches"])
        assert report["rounds"] == 5 and report["conditions_checked"] > 0
    port, ref = _parity("koordinator_tpu_torch")[0], _parity(
        "koordinator_tpu")[0]
    assert port["pods"] == ref["pods"]


def test_run_colo_parity_rounds_match_reference():
    """Every tick's batch/mid allocatable, degraded set and device runtime
    matrix, every revoke victim list (order included) and every binding
    log, in both worlds (device and host engine), equal between the
    packages."""
    (_r, port), (_s, ref) = (_parity("koordinator_tpu_torch"),
                             _parity("koordinator_tpu"))
    # per round and world: the tick, the harness's revoke pass, the
    # scheduler cycle's own revoke pass, the cycle
    assert len(port) == len(ref) == 5 * 2 * 4
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, (i, a[:2])
    ticks = [entry for entry in port if entry[0] == "tick"]
    assert {t[3] for t in ticks if t[1] == "mgr-on"} == {"device"}
    assert any(t[6] is not None for t in ticks)
    assert any(entry[1] for entry in port if entry[0] == "revoke")
