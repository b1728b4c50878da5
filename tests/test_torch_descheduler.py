"""The port's koord-descheduler against the JAX package's, on the CPU.

One seeded world, built the same way in both packages, carries work for
every plugin: pods violating node affinity, taints and inter-pod
anti-affinity, duplicates, an over-spread topology, failed and
crash-looping pods, old pods, DaemonSet pods, and node metrics that make
LowNodeLoad and HighNodeUtilization act. ``Descheduler.run_once`` runs
over a few ticks — standalone with the device rebalance pass and with
the host oracle, and co-located with a Scheduler whose cycles bind the
migration Reservations — and after every tick both packages must hold
the same pods, PodMigrationJobs, Reservations and evictions, and
``run_once`` must return the same report. The port's
``run_rebalance_parity`` passes, and leader election gates a standby
replica as in the JAX package.
"""

from __future__ import annotations

import functools
import importlib
import re
import types

import pytest

from koordinator_tpu.client.leaderelection import (
    LeaderElector as RefLeaderElector,
)
from koordinator_tpu.descheduler.framework import (
    registered_plugins as ref_registered_plugins,
)

from koordinator_tpu_torch.client.leaderelection import LeaderElector
from koordinator_tpu_torch.client.store import ObjectStore
from koordinator_tpu_torch.descheduler.descheduler import Descheduler
from koordinator_tpu_torch.descheduler.framework import registered_plugins
from koordinator_tpu_torch.scheduler.pipeline_parity import (
    run_rebalance_parity,
)
from koordinator_tpu_torch.testing.rebalance_fixture import rebalance_store

GIB = 1024 ** 3
NOW = 1_000_000.0
TICKS = 4
NODES = 12
ZONES = ("east", "west", "north")
DESCHEDULE = ["RemovePodsViolatingNodeAffinity", "PodLifeTime",
              "RemoveFailedPods", "RemovePodsHavingTooManyRestarts",
              "RemovePodsViolatingNodeTaints",
              "RemovePodsViolatingInterPodAntiAffinity"]
BALANCE = ["RemoveDuplicates", "RemovePodsViolatingTopologySpreadConstraint",
           "HighNodeUtilization", "LowNodeLoad"]
PLUGIN_ARGS = {"PodLifeTime": {"maxPodLifeTimeSeconds": 7200.0,
                               "states": ["Running"]},
               "RemovePodsHavingTooManyRestarts": {"podRestartThreshold": 5},
               "HighNodeUtilization": {"cpu_threshold_percent": 15}}


def _pkg(root):
    """The classes a world needs, from ``root`` (either package)."""
    mod = functools.partial(importlib.import_module)
    objects = mod(f"{root}.api.objects")
    store = mod(f"{root}.client.store")
    framework = mod(f"{root}.descheduler.framework")
    return types.SimpleNamespace(
        o=objects, ResourceList=mod(f"{root}.api.resources").ResourceList,
        s=store, ProfileConfig=framework.ProfileConfig,
        Descheduler=mod(f"{root}.descheduler.descheduler").Descheduler,
        Scheduler=mod(f"{root}.scheduler.cycle").Scheduler)


def _world(ns, seed=3):
    """Nodes in three zones (one tainted, one over-hot, several cold), and
    running pods that give every plugin something to do."""
    import random

    o, s = ns.o, ns.s
    rng = random.Random(seed)
    store = s.ObjectStore()
    for i in range(NODES):
        name = f"n{i}"
        frac = 0.9 if i % 4 == 0 else (0.1 if i % 4 == 1 else 0.5)
        store.add(s.KIND_NODE, o.Node(
            meta=o.ObjectMeta(name=name, namespace="", labels={
                "zone": ZONES[i % 3], "kubernetes.io/hostname": name},
                creation_timestamp=NOW - 9e4),
            allocatable=ns.ResourceList.of(cpu=32_000, memory=128 * GIB,
                                           pods=110),
            taints=[("dedicated", "gpu")] if i == 5 else []))
        store.add(s.KIND_NODE_METRIC, o.NodeMetric(
            meta=o.ObjectMeta(name=name, namespace="",
                              creation_timestamp=NOW - 9e4),
            update_time=NOW - 10,
            node_metric=o.NodeMetricInfo(node_usage=ns.ResourceList.of(
                cpu=int(32_000 * frac), memory=int(128 * GIB * frac)))))

    def pod(name, node, owner=("ReplicaSet", "rs"), age=600.0, **spec):
        p = o.Pod(
            meta=o.ObjectMeta(name=name, uid=name, namespace="default",
                              labels=spec.pop("labels", {}),
                              owner_kind=owner[0], owner_name=owner[1],
                              creation_timestamp=NOW - age),
            spec=o.PodSpec(node_name=node,
                           priority=rng.choice([100, 5500, 9000]),
                           requests=ns.ResourceList.of(
                               cpu=rng.choice([500, 1000, 2000]),
                               memory=rng.choice([1, 2, 4]) * GIB),
                           **spec),
            phase=spec_phase.pop(name, "Running"))
        store.add(s.KIND_POD, p)

    spec_phase = {"failed-0": "Failed", "failed-1": "Failed"}
    for i in range(60):  # the bulk, spread round-robin
        pod(f"bulk-{i}", f"n{i % NODES}", owner=("ReplicaSet", f"rs{i % 7}"),
            age=rng.choice([600.0, 9000.0]))
    for i in range(3):  # duplicates of one owner on one node
        pod(f"dup-{i}", "n2", owner=("ReplicaSet", "dup"))
    pod("affinity-0", "n0", node_selector={"zone": "west"})
    pod("taint-0", "n5")
    pod("taint-ok", "n5", tolerations=[("dedicated", "")])
    for i in range(2):  # anti-affine pair on one node
        pod(f"anti-{i}", "n6", labels={"app": "anti"},
            pod_anti_affinity=[o.PodAffinityTerm(selector={"app": "anti"})])
    for i in range(4):  # three in one zone, one in another: skew 3 > 1
        pod(f"spread-{i}", "n0" if i < 3 else "n1",
            labels={"app": "spread"},
            topology_spread=[o.TopologySpreadConstraint(
                max_skew=1, topology_key="zone",
                selector={"app": "spread"})])
    pod("failed-0", "n3")
    pod("failed-1", "n4", owner=("", ""))
    p = store.get(s.KIND_POD, "default/bulk-3")
    p.restart_count = 9
    store.update(s.KIND_POD, p)
    for i in range(3):
        pod(f"ds-{i}", f"n{4 * i}", owner=("DaemonSet", "agent"))
    return store


def _dump(ns, store):
    """Every pod, job and reservation, in the store's order, with the
    wall-clock stamps of objects created outside the sim clock masked."""
    def objects(kind):
        return [re.sub(r"creation_timestamp=[0-9.e+]+", "", repr(x))
                for x in store.list(kind)]

    return {kind: objects(kind) for kind in (
        ns.s.KIND_POD, ns.s.KIND_POD_MIGRATION_JOB, ns.s.KIND_RESERVATION)}


def _run(root, mode, colocated):
    ns = _pkg(root)
    store = _world(ns)
    sched = None
    if colocated:
        kw = ({"device": "cpu"} if root == "koordinator_tpu_torch" else
              {"explain": "off", "mesh": "off", "warmup": "off"})
        sched = ns.Scheduler(store, waves=1, **kw)
    kw = {"device": "cpu"} if root == "koordinator_tpu_torch" else {}
    desch = ns.Descheduler(
        store, profiles=[ns.ProfileConfig(
            name="all", deschedule=list(DESCHEDULE), balance=list(BALANCE),
            plugin_args=dict(PLUGIN_ARGS))],
        scheduler=sched, rebalance=mode, **kw)
    ticks = []
    for t in range(TICKS):
        now = NOW + 10.0 * t
        bound = []
        if sched is not None:
            res = sched.run_cycle(now=now)
            bound = [(b.pod_key, b.node_name) for b in res.bound]
        out = desch.run_once(now=now)
        ticks.append((out, bound, _dump(ns, store)))
    stats = (desch.rebalancer.stats if desch.rebalancer is not None
             else None)
    return ticks, stats


@functools.lru_cache(maxsize=None)
def _reference(mode, colocated):
    return _run("koordinator_tpu", mode, colocated)


def test_plugin_registry_is_the_reference_registry():
    assert registered_plugins() == ref_registered_plugins()


@pytest.mark.parametrize("mode,colocated", [
    ("on", False), ("host", False), ("on", True)],
    ids=["device", "host", "colocated"])
def test_run_once_matches_reference(mode, colocated):
    ref_ticks, ref_stats = _reference(mode, colocated)
    ticks, stats = _run("koordinator_tpu_torch", mode, colocated)
    for t, ((out, bound, dump), (ref_out, ref_bound, ref_dump)) in \
            enumerate(zip(ticks, ref_ticks)):
        assert out == ref_out, f"tick {t}"
        assert bound == ref_bound, f"tick {t}"
        for kind in dump:
            assert dump[kind] == ref_dump[kind], f"tick {t} {kind}"
    # the world did give every part work
    first = ticks[0][0]
    assert first["jobs_created"] > 0
    assert first["evicted"]["all"] > 0
    assert any(out["migration_transitions"] for out, _b, _d in ticks)
    if mode == "on":
        assert stats["device_passes"] == TICKS and stats["host_passes"] == 0
        assert stats == ref_stats
    if colocated:
        assert any(bound for _o, bound, _d in ticks)


def test_rebalance_parity_harness_passes():
    report = run_rebalance_parity(device="cpu")
    assert report["ok"], report["mismatches"]
    assert report["rounds"] == 5 and report["conditions_checked"] > 0


def test_standby_replica_skips_until_it_holds_the_lease():
    def electors(cls, store):
        return [cls(store, "koord-descheduler", f"replica-{i}",
                    lease_duration_seconds=15.0) for i in range(2)]

    ref_store = _world(_pkg("koordinator_tpu"))
    ref = electors(RefLeaderElector, ref_store)
    store = _world(_pkg("koordinator_tpu_torch"))
    port = electors(LeaderElector, store)
    active = Descheduler(store, elector=port[0], rebalance="host")
    standby = Descheduler(store, elector=port[1], rebalance="host")
    assert active.run_once(now=NOW)["jobs_created"] > 0
    assert standby.run_once(now=NOW + 1)["skipped_not_leader"]
    # the active replica stops renewing: the standby takes over after the
    # lease runs out, as the JAX package's elector does
    for now in (NOW + 20.0, NOW + 40.0):
        assert port[1].tick(now) == ref[1].tick(now)
    assert port[1].is_leader and ref[1].is_leader
    assert "skipped_not_leader" not in standby.run_once(now=NOW + 41.0)


def test_bare_descheduler_runs_on_an_empty_store():
    desch = Descheduler(ObjectStore(), rebalance="host")
    out = desch.run_once(now=NOW)
    assert out["jobs_created"] == 0 and out["migration_transitions"] == 0


def test_config5_fixture_gives_the_balancer_work():
    store = rebalance_store(500, 50, NOW)
    out = Descheduler(store, rebalance="on", device="cpu").run_once(now=NOW)
    assert out["jobs_created"] > 0
    assert out["profiles"]["koord-descheduler"] == {"LowNodeLoad": None}
