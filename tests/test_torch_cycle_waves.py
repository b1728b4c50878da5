"""The port's fused multi-wave Scheduler against the JAX package's, on
twin churn stores, and the port's own wave parity harnesses.

Both packages build their store from the same seeded cluster, run cycle 0
and two churn cycles whose arrivals come from one list of dicts (each churn
cycle carries a pod no node can fit), with the same wave depth: K in
{2, 8} pinned and ``"auto"`` (K = 2 at cycle 0's 300 pending pods). The
port runs ``Scheduler(device="cpu", waves=K)`` (the plain wave step) with
replay overlap on (the chained dispatch) and off (the single-call twin);
the JAX reference runs ``Scheduler(waves=K, explain="off", mesh="off",
warmup="off")`` once per K. Every cycle's ordered bindings, ``failed`` and
``rejected`` lists, ``CycleResult.waves`` and the canonical dump of the
world (every pod's node, annotations and PodScheduled condition, every
PodGroup's status, every ElasticQuota's used vector) must be equal.

Then the port's scheduler/pipeline_parity.py harnesses, on the CPU:
fused-K against K serial cycles (``run_fused_wave_parity``), the chained
dispatch against the single-call twin (``run_replay_overlap_parity``), the
four carried-state worlds (``run_carried_state_parity``) and the in-window
pre-pack against its gap-pack twin (``run_pack_overlap_parity``, whose
report must count what the JAX package's counts on the same world).
"""

from __future__ import annotations

import functools

import pytest

from koordinator_tpu.api import objects as ref_objects
from koordinator_tpu.api.resources import ResourceList as RefResourceList
from koordinator_tpu.client.store import ObjectStore as RefObjectStore
from koordinator_tpu.scheduler import pipeline_parity as ref_parity
from koordinator_tpu.scheduler.cycle import Scheduler as RefScheduler
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.scheduler import pipeline_parity
from koordinator_tpu_torch.scheduler.cycle import Scheduler
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    churn_store,
    cycle_dump,
    store_from_state,
)

NODES, PODS, ARRIVALS, SEED = 16, 300, 150, 1


def _arrivals(cycle: int, n: int):
    """run_churn's arrivals plus one pod no node can fit."""
    hog = dict(name=f"hog-{cycle}", uid=f"hog-{cycle}", prio=9000,
               cpu=10 ** 7, mem=1024 ** 3)
    return arrival_specs(cycle, n) + [hog]


def _key(res):
    return ([(b.pod_key, b.node_name) for b in res.bound],
            list(res.failed), list(res.rejected), res.waves)


def _run(sched, store, now, add):
    """Cycle 0 plus two churn cycles -> (per-cycle keys, per-cycle
    dumps)."""
    keys = [_key(sched.run_cycle(now=now))]
    dumps = [cycle_dump(sched)]
    for c in (1, 2):
        add(store, _arrivals(c, ARRIVALS), now + c)
        keys.append(_key(sched.run_cycle(now=now + 2 * c)))
        dumps.append(cycle_dump(sched))
    return keys, dumps


def _ref_add(store, specs, created):
    add_arrivals(store, specs, created, objects=ref_objects,
                 resource_list=RefResourceList)


@functools.lru_cache(maxsize=None)
def _reference_run(waves):
    """The JAX package's Scheduler at this wave depth, once per depth."""
    _cluster, state = ref_synth(
        NODES, PODS, seed=SEED, num_quotas=max(8, PODS // 100),
        num_gangs=max(4, PODS // 50))
    store = store_from_state(state, RefObjectStore())
    sched = RefScheduler(store, waves=waves, explain="off", mesh="off",
                         warmup="off")
    return _run(sched, store, state.now, _ref_add)


@pytest.mark.parametrize("overlap", [True, False], ids=["chained", "fused"])
@pytest.mark.parametrize("waves", [2, 8, "auto"])
def test_waves_match_reference(waves, overlap):
    ref_keys, ref_dumps = _reference_run(waves)
    store, state = churn_store(NODES, PODS, seed=SEED)
    sched = Scheduler(store, waves=waves, device="cpu",
                      replay_overlap=overlap)
    keys, dumps = _run(sched, store, state.now, add_arrivals)
    for c, (key, ref_key) in enumerate(zip(keys, ref_keys)):
        assert key == ref_key, f"cycle {c}"
    for c, (dump, ref_dump) in enumerate(zip(dumps, ref_dumps)):
        assert dump == ref_dump, f"cycle {c}"
    # the fused path ran: cycle 0 consumed more than one logical cycle
    assert keys[0][3] > 1
    assert sched.last_backend == "serial"


@pytest.mark.parametrize("waves", [2, 8])
def test_fused_wave_parity(waves):
    report = pipeline_parity.run_fused_wave_parity(waves, device="cpu")
    assert report["ok"], report["mismatches"]
    assert report["conditions_checked"] > 0


@pytest.mark.parametrize("waves", [2, 4])
def test_replay_overlap_parity(waves):
    report = pipeline_parity.run_replay_overlap_parity(waves, device="cpu")
    assert report["ok"], report["mismatches"]


@pytest.mark.parametrize("feature",
                         ["reservations", "claims", "prod", "transformer"])
def test_carried_state_parity(feature):
    report = pipeline_parity.run_carried_state_parity(feature, device="cpu")
    assert report["ok"], report["mismatches"]
    assert report["fused_engaged"] > 0


@pytest.mark.parametrize("waves,ndev", [(1, None), (4, None), (4, 2)],
                         ids=["serial", "fused4", "fused4-mesh2"])
def test_pack_overlap_parity(waves, ndev):
    """The in-window pre-pack is byte-identical to the gap pack, encode
    for encode, serial, fused and sharded over a 2-shard mesh; the worlds
    are the JAX package's: its gate counts the same pods, conditions and
    encodes."""
    report = pipeline_parity.run_pack_overlap_parity(waves=waves, ndev=ndev,
                                                     device="cpu")
    assert report["ok"], report["mismatches"]
    assert report["prepacked_rows"] > 0 and report["prepack_failures"] == 0
    ref = _ref_pack_overlap_report(waves)
    assert ref["ok"]
    for key in ("rounds", "pods", "conditions_checked", "encodes_compared"):
        assert report[key] == ref[key], key


@pytest.mark.parametrize("waves", [1, 4])
def test_pack_overlap_parity_fails_when_the_prepack_never_runs(
        waves, monkeypatch):
    """A pre-pack that fails leaves the overlap world packing cold in the
    gap, byte-identical to the twin: the gate counts the failures from
    the cycle's log and fails on them, and on no row pre-packed."""
    from koordinator_tpu_torch.scheduler import snapshot

    def boom(cache, pods, args):
        raise RuntimeError("prepack wrecked")

    monkeypatch.setattr(snapshot, "prepack_pending_rows", boom)
    report = pipeline_parity.run_pack_overlap_parity(waves=waves,
                                                     device="cpu")
    assert not report["ok"]
    assert report["prepacked_rows"] == 0 and report["prepack_failures"] > 0
    assert report["mismatches"] == [
        f"{report['prepack_failures']} in-window pre-packs failed",
        "the overlap world pre-packed no row"]


@functools.lru_cache(maxsize=None)
def _ref_pack_overlap_report(waves):
    return ref_parity.run_pack_overlap_parity(waves=waves)
