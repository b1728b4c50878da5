"""The port's Scheduler cycle against the JAX package's, on twin stores.

Both packages build their store from the same seeded cluster (each its own
``synth_full_cluster``, equal by tests/test_torch_pack.py), run cycle 0 and
two churn cycles whose arrivals come from one list of dicts, and must agree
on every cycle's ordered bindings, ``failed`` and ``rejected`` lists and on
the canonical dump of the world (every pod's node, annotations and
PodScheduled condition, every PodGroup's status, every ElasticQuota's used
vector). Each churn cycle also carries a pod no node can fit, so unbound
pods' PodScheduled messages are compared string for string. The port runs
``Scheduler(device="cpu", waves=1)`` (the plain round) with the incremental
snapshot on and off, plain and under CyclePipeline; the JAX reference runs
once per world, serial, incremental, explain/mesh/warm-up off.
"""

from __future__ import annotations

import contextlib
import functools

import pytest

from koordinator_tpu.api import objects as ref_objects
from koordinator_tpu.api.resources import ResourceList as RefResourceList
from koordinator_tpu.client.store import ObjectStore as RefObjectStore
from koordinator_tpu.scheduler.cycle import Scheduler as RefScheduler
from koordinator_tpu.testing import synth_full_cluster as ref_synth
from koordinator_tpu.utils.features import SCHEDULER_GATES as REF_GATES

from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler
from koordinator_tpu_torch.testing import mixed_cluster
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    churn_store,
    cycle_dump,
    store_from_state,
)
from koordinator_tpu_torch.utils.features import SCHEDULER_GATES

NODES, PODS, ARRIVALS = 16, 128, 150
SEEDS = (1, 2, 3)


@contextlib.contextmanager
def gates(**values):
    """Set scheduler gates in BOTH packages (each has its own gate
    object) and reset both afterwards."""
    try:
        for g in (SCHEDULER_GATES, REF_GATES):
            g.set_from_map(values)
        yield
    finally:
        for g in (SCHEDULER_GATES, REF_GATES):
            g.reset()


def _arrivals(cycle: int, n: int):
    """run_churn's arrivals plus one pod no node can fit."""
    hog = dict(name=f"hog-{cycle}", uid=f"hog-{cycle}", prio=9000,
               cpu=10 ** 7, mem=1024 ** 3)
    return arrival_specs(cycle, n) + [hog]


def _key(res):
    return ([(b.pod_key, b.node_name) for b in res.bound],
            list(res.failed), list(res.rejected))


def _run(sched, store, now, arrivals, add, pipeline=False):
    """Cycle 0 plus len(arrivals) churn cycles -> (per-cycle keys,
    per-cycle dumps, the dump after the last flush)."""
    driver = CyclePipeline(sched, enabled=True) if pipeline else sched
    keys, dumps = [], []
    keys.append(_key(driver.run_cycle(now=now)))
    dumps.append(cycle_dump(sched))
    for c, specs in enumerate(arrivals, start=1):
        add(store, specs, now + c)
        keys.append(_key(driver.run_cycle(now=now + 2 * c)))
        dumps.append(cycle_dump(sched))
    if pipeline:
        driver.flush()
    return keys, dumps, cycle_dump(sched)


def _ref_add(store, specs, created):
    add_arrivals(store, specs, created, objects=ref_objects,
                 resource_list=RefResourceList)


def _ref_scheduler(store):
    return RefScheduler(store, waves=1, explain="off", mesh="off",
                        warmup="off")


def _churn_arrivals():
    return [_arrivals(c, ARRIVALS) for c in (1, 2)]


@functools.lru_cache(maxsize=None)
def _reference_run(seed: int):
    """The JAX package's serial cycle on its twin store, once per seed."""
    _cluster, state = ref_synth(
        NODES, PODS, seed=seed, num_quotas=max(8, PODS // 100),
        num_gangs=max(4, PODS // 50))
    store = store_from_state(state, RefObjectStore())
    with gates():
        sched = _ref_scheduler(store)
        return _run(sched, store, state.now, _churn_arrivals(), _ref_add)


@pytest.mark.parametrize("pipeline", [False, True], ids=["plain", "pipeline"])
@pytest.mark.parametrize("incremental", [True, False],
                         ids=["incremental", "rebuild"])
@pytest.mark.parametrize("seed", SEEDS)
def test_cycle_matches_reference(seed, incremental, pipeline):
    ref_keys, ref_dumps, ref_final = _reference_run(seed)
    store, state = churn_store(NODES, PODS, seed=seed)
    with gates(IncrementalSnapshot=incremental):
        sched = Scheduler(store, waves=1, device="cpu")
    assert (sched.snapshot_cache is not None) == incremental
    keys, dumps, final = _run(sched, store, state.now, _churn_arrivals(),
                              add_arrivals, pipeline=pipeline)
    for c, (key, ref_key) in enumerate(zip(keys, ref_keys)):
        assert key == ref_key, f"cycle {c}"
    if not pipeline:
        # pipelined condition writes land a cycle late; the flushed end
        # state is what the pipeline promises to match
        for c, (dump, ref_dump) in enumerate(zip(dumps, ref_dumps)):
            assert dump == ref_dump, f"cycle {c}"
    assert final == ref_final
    assert sched.last_backend == "serial"
    assert sched.dispatches >= len(keys)


def test_unbound_messages_compared_string_for_string():
    """The worlds above end with unbound pods of several kinds; their
    PodScheduled=False messages (diagnose.py's per-stage recompute) are
    part of the dumps compared, so they match the JAX package's."""
    _keys, _dumps, ref_final = _reference_run(SEEDS[0])
    store, state = churn_store(NODES, PODS, seed=SEEDS[0])
    with gates():
        sched = Scheduler(store, waves=1, device="cpu")
    _keys, _dumps, final = _run(sched, store, state.now, _churn_arrivals(),
                                add_arrivals)
    unbound = {k: v[2] for k, v in final["pods"].items()
               if v[2] is not None and v[2][0] == "False"}
    messages = {cond[2] for cond in unbound.values()}
    assert any(m.startswith("0/") and "insufficient resources" in m
               for m in messages), messages
    assert len(messages) >= 2, messages
    ref_unbound = {k: v[2] for k, v in ref_final["pods"].items()
                   if v[2] is not None and v[2][0] == "False"}
    assert unbound == ref_unbound


def test_mixed_cluster_matches_reference():
    """Every branch of the round (affinity, spread, ports, images, volume
    groups, taints, preferences) through the whole cycle: the port's
    mixed_cluster against the JAX package's own cross-feature fixture
    (tests/test_parity_fuzz.py), whose decoration it copies."""
    from test_torch_pack import mixed_fixture_state

    seed = 101
    arrivals = [_arrivals(c, 20) for c in (1, 2)]
    ref_state = mixed_fixture_state(seed)
    ref_store = store_from_state(ref_state, RefObjectStore())
    _, state = mixed_cluster(seed, 30, 60)
    store = store_from_state(state)
    with gates():
        ref = _run(_ref_scheduler(ref_store), ref_store, ref_state.now,
                   arrivals, _ref_add)
        mine = _run(Scheduler(store, waves=1, device="cpu"), store,
                    state.now, arrivals, add_arrivals)
    assert mine[0] == ref[0]
    assert mine[1] == ref[1]
    assert any(b for b, _f, _r in mine[0]) and any(f for _b, f, _r in mine[0])
