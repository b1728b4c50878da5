"""The port's warm-up ladder and rung index (scheduler/warmup.py).

The cases of tests/test_warmup.py on the port:

  * the spec roundtrip the index records call shapes with (tensors,
    arrays, tuples, None slots, scalars by value, namedtuples through the
    registry) and the refusal of an unregistered namedtuple;
  * a corrupt index loads empty, and a stale fingerprint is purged on the
    next write;
  * record -> restart -> replay: a fresh Scheduler against the same cache
    dir rebuilds every recorded rung through the keyed step caches, so its
    first cycle binds with zero steady-state step builds;
  * a fingerprint bump invalidates every rung and the on-demand build still
    works; a corrupted index or a wrecked rung degrades to a clean build;
  * a ladder transition drops the steady-state guard, and an empty ladder
    never arms it.

Four more: the bindings with warm-up on (sync and background) equal
those with it off, cycle by cycle; the JAX package's index in the same
directory is left byte-identical while the port records and replays; the
sim's crash-restart scenario replays its predecessor's rungs after the
restart with zero steady-state builds and an unchanged binding log; and
the co-located colo and rebalance passes record rungs a restart replays.
Each test has a cache dir of its own (``KOORD_TPU_COMPILE_CACHE_DIR``).
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
from koordinator_tpu_torch.scheduler import warmup as wu
from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler
from koordinator_tpu_torch.scheduler.pipeline_parity import (
    apply_round_delta,
    build_store_from_state,
)
from koordinator_tpu_torch.testing import synth_full_cluster


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "compile_cache")
    monkeypatch.setenv("KOORD_TPU_COMPILE_CACHE_DIR", d)
    monkeypatch.delenv("KOORD_TPU_WARMUP", raising=False)
    monkeypatch.delenv("KOORD_TPU_PROGRAM_FINGERPRINT", raising=False)
    assert wu.configure_compile_cache() == os.path.abspath(d)
    return os.path.abspath(d)


def _world(seed=7, pods=40):
    _cluster, state = synth_full_cluster(
        16, pods, seed=seed, num_quotas=2, num_gangs=2,
        topology_fraction=0.5, lsr_fraction=0.2)
    return state, build_store_from_state(state)


def _bound(res):
    return [(b.pod_key, b.node_name) for b in res.bound]


def _run_rounds(sched, store, now, rounds=3, arrivals=7):
    pipe = CyclePipeline(sched, enabled=True)
    out = []
    for r in range(rounds):
        if r:
            apply_round_delta(store, r, now, arrivals)
        out.append(_bound(pipe.run_cycle(now=now + 2 * r)))
    pipe.flush()
    return out


def _scheduler(store, waves, warmup):
    return Scheduler(store, waves=waves, explain="off", warmup=warmup,
                     device="cpu")


class TestAvalSpec:
    def test_roundtrip_arrays_tuples_none_values(self):
        from koordinator_tpu_torch.models.scheduler_model import (
            ScheduleInputs,
        )

        spec = wu.aval_spec((torch.zeros((3, 4)), None, np.int32(5),
                             (np.ones(2, bool), torch.ones(2, dtype=torch.int32)),
                             7))
        json.dumps(spec)
        out = wu.zeros_from_spec(spec)
        assert out[1] is None
        assert out[0].shape == (3, 4) and out[0].dtype == torch.float32
        assert out[2] == 5 and out[4] == 7  # scalars record BY VALUE
        assert out[3][0].dtype == torch.bool and not out[3][0].any()
        assert out[3][1].dtype == torch.int32
        # namedtuples rebuild through the registry
        n_fields = len(ScheduleInputs._fields)
        si = ScheduleInputs(*([torch.zeros((2, 2))] * n_fields))
        out = wu.zeros_from_spec(wu.aval_spec(si))
        assert isinstance(out, ScheduleInputs)
        assert out[0].shape == (2, 2)

    def test_unregistered_namedtuple_rejected(self):
        Odd = collections.namedtuple("OddTuple", "x")
        with pytest.raises(TypeError):
            wu.aval_spec(Odd(x=torch.zeros(1)))


class TestIndex:
    def test_corrupt_index_loads_empty(self, tmp_path):
        idx = wu.CompileCacheIndex(str(tmp_path))
        with open(idx.path, "w") as f:
            f.write('{"v": 1, "entries": {"x"')  # truncated JSON
        assert idx.load() == {}
        # a record after the corruption rewrites a clean index
        idx.record("serial", {"signature": [16, 16, 1]}, [])
        assert len(idx.load()) == 1

    def test_stale_fingerprint_purged_on_write(self, tmp_path, monkeypatch):
        idx = wu.CompileCacheIndex(str(tmp_path))
        monkeypatch.setenv("KOORD_TPU_PROGRAM_FINGERPRINT", "v1")
        idx.record("serial", {"signature": [16, 16, 1]}, [])
        assert len(idx.load()) == 1
        monkeypatch.setenv("KOORD_TPU_PROGRAM_FINGERPRINT", "v2")
        idx.record("serial", {"signature": [32, 16, 1]}, [])
        entries = idx.load()
        assert len(entries) == 1
        assert all(e["fp"] == "v2" for e in entries.values())


class TestWarmupLadder:
    def test_record_then_restart_replays_with_zero_steady_misses(
            self, cache_dir):
        state, store = _world()
        sched = _scheduler(store, 4, "off")
        _run_rounds(sched, store, state.now)
        entries = wu.CompileCacheIndex(cache_dir).load()
        assert entries, "dispatch builds must record rungs"
        assert {e["kind"] for e in entries.values()} <= {
            "serial", "fused", "chain", "rebalance", "colo"}

        # the "restarted" scheduler: same store world, sync warm-up
        state2, store2 = _world()
        sched2 = _scheduler(store2, 4, "sync")
        stats = sched2.warmup.stats
        assert stats["complete"] is True
        assert stats["warmed"] == stats["rungs"] > 0  # every rung replayed
        assert stats["failed"] == stats["invalidated"] == 0
        assert sched2._steady_state is True
        roots = [r.name for r in sched2.warmup.tracer.roots()]
        assert roots == ["warmup"]

        # the first cycle binds with ZERO steady-state builds
        flagged = []
        sched2.compile_miss_hook = flagged.append
        m0 = scheduler_metrics.COMPILE_CACHE_MISSES.get()
        pipe = CyclePipeline(sched2, enabled=True)
        res = pipe.run_cycle(now=state2.now)
        pipe.flush()
        assert res.bound, "the warm scheduler must actually bind"
        assert scheduler_metrics.COMPILE_CACHE_MISSES.get() == m0
        assert flagged == []

    def test_fingerprint_bump_invalidates_and_recompiles(
            self, cache_dir, monkeypatch):
        state, store = _world(seed=9)
        sched = _scheduler(store, 1, "off")
        _run_rounds(sched, store, state.now, rounds=2)
        # simulated code-version bump: every recorded rung must MISS
        monkeypatch.setenv("KOORD_TPU_PROGRAM_FINGERPRINT", "bumped-version")
        state2, store2 = _world(seed=9)
        sched2 = _scheduler(store2, 1, "sync")
        stats = sched2.warmup.stats
        assert stats["warmed"] == 0 and stats["built"] == 0
        assert stats["invalidated"] == stats["rungs"] > 0
        # ...and the on-demand build path still works
        m0 = scheduler_metrics.COMPILE_CACHE_MISSES.get()
        res = sched2.run_cycle(now=state2.now)
        assert res.bound
        assert scheduler_metrics.COMPILE_CACHE_MISSES.get() > m0

    def test_corrupted_cache_entries_fall_back_cleanly(self, cache_dir):
        state, store = _world(seed=13)
        sched = _scheduler(store, 4, "off")
        _run_rounds(sched, store, state.now, rounds=2)
        # wreck every rung's call spec: each zero call fails, is counted,
        # and warm-up still completes; the scheduler still binds
        idx_path = os.path.join(cache_dir, wu.INDEX_NAME)
        with open(idx_path) as f:
            data = json.load(f)
        for entry in data["entries"].values():
            entry["args"] = [{"t": "a", "s": [1], "d": "float32"}]
        with open(idx_path, "w") as f:
            json.dump(data, f)
        state2, store2 = _world(seed=13)
        sched2 = _scheduler(store2, 4, "sync")
        stats = sched2.warmup.stats
        assert stats["complete"] is True  # never crashes the ladder
        assert stats["failed"] == stats["rungs"] > 0
        assert sched2.run_cycle(now=state2.now).bound

        # a fully garbage index degrades to an empty ladder
        with open(idx_path, "w") as f:
            f.write("\x00not json at all")
        state3, store3 = _world(seed=13)
        sched3 = _scheduler(store3, 4, "sync")
        assert sched3.warmup.stats["rungs"] == 0
        assert sched3.warmup.stats["complete"] is True
        assert sched3.run_cycle(now=state3.now).bound

    def test_ladder_transition_drops_steady_state_guard(self, cache_dir):
        state, store = _world(seed=21)
        sched = _scheduler(store, 1, "off")
        sched.note_warmup_complete(
            {"warmed": 2, "built": 0, "rungs": 2, "seconds": 0.1,
             "skipped": 0, "failed": 0, "invalidated": 0})
        assert sched._steady_state is True
        sched._on_ladder_transition(
            {"from": "full", "to": "host-fallback", "from_level": 0,
             "to_level": 5, "reason": "test"})
        assert sched._steady_state is False

    def test_empty_ladder_never_arms_the_guard(self, cache_dir):
        """A first boot against an index that covered nothing promised
        nothing — its legitimate cold builds must not be flagged as
        steady-state misses."""
        state, store = _world(seed=25)
        sched = _scheduler(store, 1, "sync")
        assert sched.warmup.stats["rungs"] == 0
        assert sched._steady_state is False
        flagged = []
        sched.compile_miss_hook = flagged.append
        assert sched.run_cycle(now=state.now).bound
        assert flagged == []


@pytest.mark.parametrize("mode", ["sync", "background"])
def test_warmup_never_moves_a_decision(cache_dir, mode):
    """Bindings with warm-up on equal those with it off, cycle by cycle,
    through a restart replaying the rungs of every path (serial, fused,
    chained)."""
    base = []
    for waves, overlap in ((1, True), (4, False), (4, True)):
        state, store = _world(seed=31)
        sched = Scheduler(store, waves=waves, explain="off", warmup="off",
                          replay_overlap=overlap, device="cpu")
        base.append(_run_rounds(sched, store, state.now))
    kinds = {e["kind"] for e in wu.CompileCacheIndex(cache_dir).load().values()}
    assert kinds == {"serial", "fused", "chain"}
    for (waves, overlap), want in zip(((1, True), (4, False), (4, True)),
                                      base):
        state, store = _world(seed=31)
        sched = Scheduler(store, waves=waves, explain="off", warmup=mode,
                          replay_overlap=overlap, device="cpu")
        sched.warmup.join(timeout=60)
        assert sched.warmup.stats["complete"] is True
        assert sched.warmup.stats["failed"] == 0
        assert _run_rounds(sched, store, state.now) == want


def test_jax_index_in_the_same_dir_left_untouched(cache_dir):
    """The JAX package's rung index shares the directory: the port keeps
    its own file, so neither package purges the other's rungs."""
    jax_index = os.path.join(cache_dir, "koord_warmup_index.json")
    os.makedirs(cache_dir, exist_ok=True)
    body = json.dumps({"v": 1, "entries": {"k": {
        "kind": "serial", "meta": {"signature": [8, 8, 1]}, "args": [],
        "fp": "a-jax-fingerprint"}}}, sort_keys=True).encode()
    with open(jax_index, "wb") as f:
        f.write(body)
    assert wu.INDEX_NAME != os.path.basename(jax_index)
    state, store = _world(seed=41)
    _run_rounds(_scheduler(store, 4, "off"), store, state.now, rounds=2)
    state2, store2 = _world(seed=41)
    sched2 = _scheduler(store2, 4, "sync")
    assert sched2.warmup.stats["warmed"] > 0
    with open(jax_index, "rb") as f:
        assert f.read() == body


def test_crash_restart_replays_the_ladder(tmp_path, monkeypatch):
    """The sim's crash-restart scenario with waves pinned to 4, as the JAX
    package's cold-start gate (hack/check_coldstart.py) runs it: with a
    cache dir and sync warm-up, the restarted scheduler replays the rungs
    its predecessor recorded, binds its first pod with zero steady-state
    builds, and the binding log equals the run without a cache dir."""
    from koordinator_tpu_torch.sim.harness import run_scenario
    from koordinator_tpu_torch.sim.scenarios import SCENARIOS

    sc = SCENARIOS["crash-restart"].resolved(waves=4)
    monkeypatch.delenv("KOORD_TPU_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("KOORD_TPU_WARMUP", raising=False)
    cold = run_scenario(sc, device="cpu").to_dict()
    monkeypatch.setenv("KOORD_TPU_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    monkeypatch.setenv("KOORD_TPU_WARMUP", "sync")
    warm = run_scenario(sc, device="cpu").to_dict()
    assert warm["binding_log_sha256"] == cold["binding_log_sha256"]
    assert warm["invariant_breaches"] == cold["invariant_breaches"] == 0
    wu_stats = warm["warmup"]
    assert wu_stats["complete"] and wu_stats["rungs"] > 0
    assert wu_stats["warmed"] == wu_stats["rungs"]
    assert wu_stats["failed"] == wu_stats["invalidated"] == 0
    restart = warm["restart"]
    assert restart["count"] >= 1
    assert restart["steady_state_compiles"] == [0] * restart["count"]
    assert cold["warmup"] == {}


def test_rebalance_and_colo_rungs_record_and_replay(cache_dir):
    """The co-located manager's colo pass and descheduler's rebalance
    pass record their first builds as rungs; a restarted scheduler
    replays them through their build functions."""
    from koordinator_tpu_torch.client.store import KIND_ELASTIC_QUOTA
    from koordinator_tpu_torch.descheduler import Descheduler
    from koordinator_tpu_torch.manager import Manager
    from koordinator_tpu_torch.testing.churn import churn_store

    store, state = churn_store(64, 128, seed=1)
    # the quota tree is outside the colo fold's f32 envelope: without it
    # the pass runs on the device engine
    for q in store.list(KIND_ELASTIC_QUOTA):
        store.delete(KIND_ELASTIC_QUOTA, q.meta.key)
    sched = _scheduler(store, 1, "off")
    sched.run_cycle(now=state.now)
    mgr = Manager(store, scheduler=sched)
    assert mgr.tick(now=state.now)
    assert mgr.colo.last_pass_stats["engine"] == "device"
    desch = Descheduler(store, scheduler=sched)
    desch.run_once(now=state.now)
    assert desch.rebalancer.stats["device_passes"] == 1
    kinds = sorted(e["kind"]
                   for e in wu.CompileCacheIndex(cache_dir).load().values())
    assert kinds == ["colo", "rebalance", "serial"]
    store2, _state2 = churn_store(64, 128, seed=1)
    stats = _scheduler(store2, 1, "sync").warmup.stats
    assert stats["warmed"] == stats["rungs"] == 3 and stats["failed"] == 0
