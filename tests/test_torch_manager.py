"""The port's koord-manager (koordinator_tpu_torch/manager.py) against the
JAX package's, on the CPU.

The same world — nodes (one in a labelled pool, one with a node
reservation), NodeMetrics (one stale, one missing), the
slo-controller-config ConfigMap, a ClusterColocationProfile, an
ElasticQuotaProfile and an ElasticQuota tree — is built in each package's
own store, and two replicas of each package's ``Manager`` run on it, in
colo modes ``on``, ``host`` and ``off``. The webhook's admission decisions
(a mutated co-location pod, rejected pods and quotas), the leader
election (the first replica leads, the second stands by, and takes over
once the leader releases its lease), every object the controllers write
(node allocatable, NodeMetric, NodeSLO, ElasticQuota), each controller's
change count and the health payload must be the same in both packages,
tick by tick; the ``manager_metrics`` catalogs must name the same
metrics. The modules copied from the JAX package keep its names.
"""

from __future__ import annotations

import functools
import importlib
import json
import re

import pytest

import koordinator_tpu.manager_metrics as ref_mm

import koordinator_tpu_torch.manager_metrics as mm

GIB = 1024 ** 3
NOW = 1_000_000.0
PACKAGES = ("koordinator_tpu_torch", "koordinator_tpu")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _build(pkg):
    """The world in ``pkg``'s own store and object classes."""
    o = _mod(pkg, "api.objects")
    rl = _mod(pkg, "api.resources").ResourceList
    st = _mod(pkg, "client.store")
    QoSClass = _mod(pkg, "api.qos").QoSClass
    store = st.ObjectStore()
    for i in range(4):
        labels = {"pool": "batch", "zone": "z1"} if i == 0 else {"zone": "z2"}
        node = o.Node(
            meta=o.ObjectMeta(name=f"mn-{i}", namespace="", labels=labels),
            allocatable=rl.of(cpu=64_000, memory=256 * GIB, pods=110),
            capacity=rl.of(cpu=64_000, memory=256 * GIB, pods=110))
        if i == 1:
            node.meta.annotations["node.koordinator.sh/reservation"] = (
                json.dumps({"resources": {"cpu": "2", "memory": "4Gi"}}))
        store.add(st.KIND_NODE, node)
    for i in range(3):  # mn-3 has none: the nodemetric controller adds it
        store.add(st.KIND_NODE_METRIC, o.NodeMetric(
            meta=o.ObjectMeta(name=f"mn-{i}", namespace=""),
            update_time=NOW - (10_000.0 if i == 2 else 5.0),
            node_metric=o.NodeMetricInfo(node_usage=rl.of(
                cpu=8_000 * (i + 1), memory=32 * GIB * (i + 1))),
            prod_reclaimable=rl.of(cpu=4_000, memory=16 * GIB)))
    store.add(st.KIND_CONFIG_MAP, o.ConfigMap(
        meta=o.ObjectMeta(name="slo-controller-config",
                          namespace="koordinator-system"),
        data={
            "colocation-config": json.dumps({
                "enable": True,
                "cpuReclaimThresholdPercent": 70,
                "memoryReclaimThresholdPercent": 75,
                "midCPUThresholdPercent": 20,
                "nodeConfigs": [{"nodeSelector": {"pool": "batch"},
                                 "cpuReclaimThresholdPercent": 85}]}),
            "resource-threshold-config": json.dumps({
                "clusterStrategy": {"enable": True,
                                    "cpuSuppressThresholdPercent": 60},
                "nodeStrategies": [{"nodeSelector": {"pool": "batch"},
                                    "cpuSuppressThresholdPercent": 80}]}),
        }))
    store.add(st.KIND_COLOCATION_PROFILE, o.ClusterColocationProfile(
        meta=o.ObjectMeta(name="batch-profile"),
        selector={"koordinator-colocation": "true"},
        qos_class=QoSClass.BE, priority_class_name="koord-batch",
        scheduler_name="koord-scheduler", labels={"injected": "yes"}))
    store.add(st.KIND_QUOTA_PROFILE, o.ElasticQuotaProfile(
        meta=o.ObjectMeta(name="profile-z2", namespace="default",
                          annotations={"quota.scheduling.koordinator.sh/"
                                       "total-resource-ratio": "0.5"}),
        quota_name="quota-z2", node_selector={"zone": "z2"}))
    store.add(st.KIND_ELASTIC_QUOTA, o.ElasticQuota(
        meta=o.ObjectMeta(name="team", namespace="default",
                          labels={o.LABEL_QUOTA_IS_PARENT: "true"}),
        min=rl.of(cpu=40_000, memory=128 * GIB),
        max=rl.of(cpu=100_000, memory=512 * GIB)))
    return store


def _admit(pkg, store):
    """Objects through the store's admission seam: each decision is the
    admitted object's repr or the rejection's message."""
    o = _mod(pkg, "api.objects")
    rl = _mod(pkg, "api.resources").ResourceList
    st = _mod(pkg, "client.store")
    WebhookError = _mod(pkg, "webhook").AdmissionError
    cases = [
        (st.KIND_POD, o.Pod(
            meta=o.ObjectMeta(name="spark", namespace="default", uid="spark",
                              labels={"koordinator-colocation": "true"}),
            spec=o.PodSpec(requests=rl.of(cpu=4000, memory=8 * GIB),
                           limits=rl.of(cpu=4000, memory=8 * GIB)))),
        (st.KIND_POD, o.Pod(
            meta=o.ObjectMeta(name="be-prod", namespace="default",
                              uid="be-prod",
                              labels={o.LABEL_POD_QOS: "BE"}),
            spec=o.PodSpec(priority=9500))),
        (st.KIND_POD, o.Pod(
            meta=o.ObjectMeta(name="lsr", namespace="default", uid="lsr",
                              labels={o.LABEL_POD_QOS: "LSR"}),
            spec=o.PodSpec(priority=9500,
                           requests=rl.of(cpu=2000, memory=GIB)))),
        (st.KIND_ELASTIC_QUOTA, o.ElasticQuota(
            meta=o.ObjectMeta(name="bad", namespace="default"),
            min=rl.of(cpu=2000), max=rl.of(cpu=1000))),
        (st.KIND_ELASTIC_QUOTA, o.ElasticQuota(
            meta=o.ObjectMeta(name="job", namespace="default",
                              labels={o.LABEL_QUOTA_PARENT: "team"}),
            min=rl.of(cpu=10_000, memory=32 * GIB),
            max=rl.of(cpu=60_000, memory=256 * GIB))),
    ]
    decisions = []
    for kind, obj in cases:
        try:
            store.add(kind, obj)
            decisions.append(("admitted", _repr(store.get(kind,
                                                          obj.meta.key))))
        except WebhookError as exc:
            decisions.append(("rejected", str(exc)))
    return decisions


def _repr(obj) -> str:
    """The object's repr without its creation time (the wall clock)."""
    return re.sub(r"creation_timestamp=[0-9.e+-]+", "creation_timestamp=*",
                  repr(obj))


def _dump(pkg, store):
    st = _mod(pkg, "client.store")
    return {kind: [_repr(obj) for obj in store.list(kind)]
            for kind in (st.KIND_NODE, st.KIND_NODE_METRIC, st.KIND_NODE_SLO,
                         st.KIND_ELASTIC_QUOTA, st.KIND_POD)}


@functools.lru_cache(maxsize=None)
def _run(pkg, colo):
    """Two replicas through 3 ticks, the leader's release and a takeover;
    everything the test compares, in order."""
    Manager = _mod(pkg, "manager").Manager
    kwargs = {"device": "cpu"} if pkg == "koordinator_tpu_torch" else {}
    store = _build(pkg)
    a = Manager(store, identity="mgr-a", colo=colo,
                lease_duration_seconds=15.0, **kwargs)
    b = Manager(store, identity="mgr-b", colo=colo,
                lease_duration_seconds=15.0, **kwargs)
    trace = [("admission", _admit(pkg, store))]
    for k in range(3):
        now = NOW + 5.0 * k
        led = (a.tick(now=now), b.tick(now=now))
        engine = (a.colo.last_pass_stats.get("engine")
                  if a.colo is not None else None)
        trace.append(("tick", k, led, dict(a.last_changes),
                      a.reconcile_rounds, b.reconcile_rounds, engine,
                      _dump(pkg, store)))
    a.stop(now=NOW + 20.0)
    # the standby ticks first and takes the released lease
    b_led = b.tick(now=NOW + 21.0)
    led = (a.tick(now=NOW + 21.0), b_led)
    trace.append(("takeover", led, dict(b.last_changes),
                  b.reconcile_rounds, _dump(pkg, store)))
    health = b.health_snapshot()
    trace.append(("health", health.get("is_leader"),
                  health.get("reconcile_rounds"), health.get("colo_mode"),
                  health.get("colo_engine"),
                  sorted(health.get("degraded", {}))))
    b.stop(now=NOW + 22.0)
    return trace


@pytest.mark.parametrize("colo", ["on", "host", "off"])
def test_manager_matches_reference(colo):
    port, ref = _run(PACKAGES[0], colo), _run(PACKAGES[1], colo)
    assert len(port) == len(ref) == 6
    for step_port, step_ref in zip(port, ref):
        assert step_port == step_ref, step_port[0]


@pytest.mark.parametrize("colo", ["on", "host", "off"])
def test_manager_trace_is_not_vacuous(colo):
    trace = _run(PACKAGES[0], colo)
    decisions = trace[0][1]
    assert [d[0] for d in decisions] == [
        "admitted", "rejected", "admitted", "rejected", "admitted"]
    # the co-location profile mutated the pod onto the batch axes
    assert "batch-cpu" in decisions[0][1] and "injected" in decisions[0][1]
    ticks = [t for t in trace if t[0] == "tick"]
    assert [t[2] for t in ticks] == [(True, False)] * 3
    assert ticks[0][3]["nodemetric"] > 0 and ticks[0][3]["nodeslo"] > 0
    assert ticks[0][3]["noderesource"] > 0
    assert ticks[0][3]["quotaprofile"] > 0
    assert [t[4] for t in ticks] == [1, 2, 3]
    assert trace[4][1] == (False, True)
    assert ticks[-1][6] == {"on": "device", "host": "host-pinned",
                            "off": None}[colo]
    assert "batch-cpu" in "".join(ticks[0][7]["Node"])


def test_manager_metrics_catalog_matches_reference():
    assert sorted(mm.REGISTRY._metrics) == sorted(ref_mm.REGISTRY._metrics)
    for name, metric in mm.REGISTRY._metrics.items():
        assert metric.kind == ref_mm.REGISTRY._metrics[name].kind, name


def test_copied_modules_keep_the_reference_names():
    for name in ("utils.sloconfig", "slocontroller", "slocontroller.nodemetric",
                 "slocontroller.nodeslo", "slocontroller.noderesource",
                 "slocontroller.noderesource_plugins", "quotacontroller",
                 "quotacontroller.profile", "webhook", "webhook.server",
                 "colo", "colo.pack", "colo.step", "colo.reconciler",
                 "manager"):
        port, ref = (_mod(pkg, name) for pkg in PACKAGES)
        public = {k for k in vars(ref) if not k.startswith("__")
                  and getattr(vars(ref)[k], "__module__", "").startswith(
                      "koordinator_tpu.")}
        missing = {k for k in public if not hasattr(port, k)}
        assert not missing, (name, sorted(missing))
