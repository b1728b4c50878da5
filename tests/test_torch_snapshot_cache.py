"""The port's SnapshotCache and DeviceSnapshot against the JAX package's.

* The cached ``build_full_chain_inputs`` equals the cold build, array for
  array, through store churn driven by real scheduler cycles, and equals the
  JAX package's cached build on the twin store.
* ``DeviceSnapshot`` keeps the same ``stats`` as the JAX package's on the same
  sequence of uploads (reuse, scatter, the scatter/put crossover, the
  in-flight clone, dtype and shape changes), and every tensor it hands out
  equals its host array and ``models/convert.to_device``'s tensor, dtype
  included.
* The paths this slice leaves out raise NotImplementedError, a CUDA request
  without a card raises, and a dispatch failure propagates out of the cycle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from koordinator_tpu.api import objects as ref_objects
from koordinator_tpu.api.resources import ResourceList as RefResourceList
from koordinator_tpu.client.store import ObjectStore as RefObjectStore
from koordinator_tpu.scheduler.cycle import Scheduler as RefScheduler
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
)
from koordinator_tpu.scheduler.snapshot_cache import (
    DeviceSnapshot as RefDeviceSnapshot,
)
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.api import objects
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    ObjectStore,
)
from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.scheduler.cycle import Scheduler
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.scheduler.snapshot_cache import (
    _SCATTER_FRACTION,
    DeviceSnapshot,
)
from koordinator_tpu_torch.testing import synth_full_cluster
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    churn_store,
    store_from_state,
)

GIB = 1024 ** 3
WORLD = dict(num_quotas=3, num_gangs=4, topology_fraction=0.5,
             lsr_fraction=0.2)


def _fields(fc):
    out = {f"base.{k}": v for k, v in fc.base._asdict().items()}
    out.update((k, v) for k, v in fc._asdict().items() if k != "base")
    return out


def _assert_fc_equal(got, want, what):
    g, w = _fields(got), _fields(want)
    assert sorted(g) == sorted(w)
    for name, warr in w.items():
        garr, warr = np.asarray(g[name]), np.asarray(warr)
        assert garr.dtype == warr.dtype, f"{what}: {name} dtype"
        np.testing.assert_array_equal(garr, warr, err_msg=f"{what}: {name}")


def _fresh_state(sched, now):
    pending, _ = sched._pending_queue(now)
    return sched._cluster_state(pending, now)


class _Twins:
    """The port's world and the JAX package's, mutated identically."""

    def __init__(self):
        _, state = synth_full_cluster(24, 60, seed=3, **WORLD)
        _, ref_state = ref_synth(24, 60, seed=3, **WORLD)
        self.now = state.now
        self.store = store_from_state(state)
        self.ref_store = store_from_state(ref_state, RefObjectStore())
        self.sched = Scheduler(self.store, waves=1, device="cpu")
        self.ref = RefScheduler(self.ref_store, waves=1, explain="off",
                                mesh="off", warmup="off")

    def worlds(self):
        return ((self.store, objects, ResourceList),
                (self.ref_store, ref_objects, RefResourceList))

    def check_builds(self, now):
        """Port cold == port cached == JAX cached, array for array."""
        state = _fresh_state(self.sched, now)
        cold = build_full_chain_inputs(state, self.sched.args)
        cached = build_full_chain_inputs(
            _fresh_state(self.sched, now), self.sched.args,
            cache=self.sched.snapshot_cache)
        ref = ref_build(_fresh_state(self.ref, now), self.ref.args,
                        cache=self.ref.snapshot_cache)
        _assert_fc_equal(cached[0], cold[0], "cached vs cold")
        _assert_fc_equal(cached[0], ref[0], "cached vs reference cached")
        assert list(cached[1].keys) == list(cold[1].keys)
        assert list(cached[1].keys) == list(ref[1].keys)
        assert cached[2].names == ref[2].names
        assert cached[4:] == ref[4:]
        assert (self.sched.snapshot_cache.stats
                == self.ref.snapshot_cache.stats)

    def cycle(self, now):
        res = self.sched.run_cycle(now=now)
        ref = self.ref.run_cycle(now=now)
        assert ([(b.pod_key, b.node_name) for b in res.bound]
                == [(b.pod_key, b.node_name) for b in ref.bound])


def test_cached_build_matches_cold_and_reference_through_churn():
    t = _Twins()
    now = t.now
    t.check_builds(now)
    t.cycle(now)

    # churn A: arrivals
    specs = arrival_specs(1, 12)
    add_arrivals(t.store, specs, now + 1)
    add_arrivals(t.ref_store, specs, now + 1, objects=ref_objects,
                 resource_list=RefResourceList)
    t.check_builds(now + 2)
    t.cycle(now + 2)

    # churn B: terminations + deletions release capacity
    for store, _o, _r in t.worlds():
        running = sorted((p for p in store.list(KIND_POD)
                          if p.is_assigned and not p.is_terminated),
                         key=lambda p: p.meta.key)
        for p in running[:5]:
            p.phase = "Succeeded"
            store.update(KIND_POD, p)
        for p in running[5:8]:
            store.delete(KIND_POD, p.meta.key)
    t.check_builds(now + 4)
    t.cycle(now + 4)

    # churn C: metric updates on a third of the nodes + one node relabel
    for store, obj, rl in t.worlds():
        for nm in sorted(store.list(KIND_NODE_METRIC),
                         key=lambda m: m.meta.key)[::3]:
            nm.update_time = now + 5
            nm.node_metric = obj.NodeMetricInfo(
                node_usage=rl.of(cpu=9000, memory=30 * GIB))
            store.update(KIND_NODE_METRIC, nm)
        node = sorted(store.list(KIND_NODE), key=lambda n: n.meta.key)[1]
        node.meta.labels["churn"] = "yes"
        store.update(KIND_NODE, node)
    t.check_builds(now + 6)
    t.cycle(now + 6)

    # churn D: a node added and one removed (layout rebuild)
    for store, obj, rl in t.worlds():
        store.add(KIND_NODE, obj.Node(
            meta=obj.ObjectMeta(name="node-new", namespace=""),
            allocatable=rl.of(cpu=64000, memory=256 * GIB, pods=256)))
        gone = sorted(store.list(KIND_NODE), key=lambda n: n.meta.key)[0]
        store.delete(KIND_NODE, gone.meta.key)
    t.check_builds(now + 8)
    t.cycle(now + 8)

    # churn E: metric expiry boundary crossing; an in-place resize
    far = now + t.sched.args.node_metric_expiration_seconds + 100
    t.check_builds(far)
    for store, _o, rl in t.worlds():
        victim = sorted((p for p in store.list(KIND_POD)
                         if p.is_assigned and not p.is_terminated),
                        key=lambda p: p.meta.key)[0]
        victim.spec = dataclasses.replace(
            victim.spec, requests=rl.of(cpu=123, memory=GIB, pods=1))
        store.update(KIND_POD, victim)
    t.check_builds(now + 10)
    stats = t.sched.snapshot_cache.stats
    assert stats["pod_row_hits"] > 0 and stats["builds"] >= 8


def test_steady_state_build_recomputes_nothing():
    store, state = churn_store(24, 60, seed=5)
    sched = Scheduler(store, waves=1, device="cpu")
    cache = sched.snapshot_cache
    build_full_chain_inputs(_fresh_state(sched, state.now), sched.args,
                            cache=cache)
    before = dict(cache.stats)
    build_full_chain_inputs(_fresh_state(sched, state.now), sched.args,
                            cache=cache)
    for k in ("la_recomputed", "numa_recomputed", "pod_row_misses"):
        assert cache.stats[k] == before[k], k
    assert not cache.dirty_fields


# ---------------------------------------------------------------------------
# DeviceSnapshot
# ---------------------------------------------------------------------------

def _mini_fc(arr, extra=None):
    """A FullChainInputs-shaped pair of namedtuples for upload()."""
    from collections import namedtuple

    Base = namedtuple("MiniBase", ["core"])
    FC = namedtuple("MiniFC", ["base", "aux"])
    return FC(base=Base(core=arr),
              aux=extra if extra is not None else np.arange(4, dtype=np.int32))


def _twin_upload(ds, ref, fc):
    out = ds.upload(fc)
    ref.upload(fc)
    assert ds.stats == ref.stats
    return out


def test_scatter_empty_index_set_is_guarded():
    ds = DeviceSnapshot(device="cpu")
    dev = torch.zeros((16, 4))
    assert ds._scatter(dev, np.zeros(0, np.int64),
                       np.zeros((0, 4), np.float32)) is dev


def test_scatter_vs_put_crossover_matches_reference_stats():
    n = 64
    at_fraction = int(n * _SCATTER_FRACTION)
    ds, ref = DeviceSnapshot(device="cpu"), RefDeviceSnapshot()
    base = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    _twin_upload(ds, ref, _mini_fc(base))
    assert ds.stats["put"] == 2
    same = _twin_upload(ds, ref, _mini_fc(base.copy()))
    assert ds.stats["reused"] == 2
    under = base.copy()
    under[:at_fraction] += 1.0
    dev = ds._fields["core"][1]
    fc2 = _twin_upload(ds, ref, _mini_fc(under))
    assert ds.stats["scattered"] == 1 and ds.stats["scattered_safe"] == 0
    assert fc2.base.core is dev, "no round in flight: scatter in place"
    assert torch.equal(fc2.base.core, torch.from_numpy(under))
    assert same.base.core is dev
    over = under.copy()
    over[: at_fraction + 1] += 1.0
    fc3 = _twin_upload(ds, ref, _mini_fc(over))
    assert ds.stats["scattered"] == 1 and ds.stats["put"] == 3
    assert torch.equal(fc3.base.core, torch.from_numpy(over))
    assert ds.stats["bytes_scattered"] == at_fraction * 4 * 4


def test_scatter_while_in_flight_writes_a_clone():
    n = 32
    ds, ref = DeviceSnapshot(device="cpu"), RefDeviceSnapshot()
    base = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    old = _twin_upload(ds, ref, _mini_fc(base)).base.core
    ds.begin_dispatch()
    ref.begin_dispatch()
    changed = base.copy()
    changed[5] = -1.0
    fc2 = _twin_upload(ds, ref, _mini_fc(changed))
    assert ds.stats["scattered"] == 1 and ds.stats["scattered_safe"] == 1
    assert fc2.base.core is not old
    assert torch.equal(old, torch.from_numpy(base)), "the round's input"
    assert torch.equal(fc2.base.core, torch.from_numpy(changed))
    ds.end_dispatch()
    ref.end_dispatch()
    changed2 = changed.copy()
    changed2[7] = -2.0
    fc3 = _twin_upload(ds, ref, _mini_fc(changed2))
    assert ds.stats["scattered"] == 2 and ds.stats["scattered_safe"] == 1
    assert fc3.base.core is fc2.base.core
    assert torch.equal(fc3.base.core, torch.from_numpy(changed2))


def test_dtype_or_shape_change_forces_full_put():
    n = 32
    ds, ref = DeviceSnapshot(device="cpu"), RefDeviceSnapshot()
    base = np.zeros((n, 4), np.float32)
    _twin_upload(ds, ref, _mini_fc(base))
    as_int = np.zeros((n, 4), np.int32)
    as_int[1] = 3
    fc = _twin_upload(ds, ref, _mini_fc(as_int))
    assert ds.stats["put"] == 3 and ds.stats["scattered"] == 0
    assert fc.base.core.dtype == torch.int32
    wider = np.zeros((n, 5), np.int32)
    wider[2] = 1
    _twin_upload(ds, ref, _mini_fc(wider))
    assert ds.stats["put"] == 4 and ds.stats["scattered"] == 0


def test_upload_failure_rolls_back_and_maps_oom():
    from koordinator_tpu_torch.scheduler.snapshot_cache import (
        DeviceAllocationError,
    )

    ds = DeviceSnapshot(device="cpu")
    base = np.zeros((16, 4), np.float32)
    ds.upload(_mini_fc(base))

    def oom(name):
        if name == "core":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    ds.fault_injector = oom
    with pytest.raises(DeviceAllocationError):
        ds.upload(_mini_fc(base))
    assert "core" not in ds._fields
    ds.fault_injector = None
    ds.upload(_mini_fc(base))
    assert ds.stats["put"] == 3


def test_mirror_tensors_equal_host_and_to_device_through_churn():
    """A scheduler's real uploads: every field the mirror hands the round
    equals its host array and to_device's tensor in dtype and value, and
    the stats move exactly as the JAX package's mirror's on the twin."""
    store, state = churn_store(24, 60, seed=7)
    _, ref_state = ref_synth(24, 60, seed=7, num_quotas=8, num_gangs=4)
    ref_store = store_from_state(ref_state, RefObjectStore())
    sched = Scheduler(store, waves=1, device="cpu")
    ref = RefScheduler(ref_store, waves=1, explain="off", mesh="off",
                       warmup="off")
    ds, ref_ds = DeviceSnapshot(device="cpu"), RefDeviceSnapshot()
    now = state.now
    for c in range(4):
        if c:
            specs = arrival_specs(c, 15)
            add_arrivals(store, specs, now + c)
            add_arrivals(ref_store, specs, now + c, objects=ref_objects,
                         resource_list=RefResourceList)
        fc, *_ = build_full_chain_inputs(
            _fresh_state(sched, now + 2 * c), sched.args,
            cache=sched.snapshot_cache)
        fc, _active = reduce_to_active_axes(fc)
        ref_fc, *_ = ref_build(_fresh_state(ref, now + 2 * c), ref.args,
                               cache=ref.snapshot_cache)
        from koordinator_tpu.scheduler.snapshot import (
            reduce_to_active_axes as ref_reduce,
        )

        ref_fc, _ = ref_reduce(ref_fc)
        up = ds.upload(fc)
        ref_ds.upload(ref_fc)
        assert ds.stats == ref_ds.stats, c
        want = _fields(to_device(fc, "cpu"))
        for name, t in _fields(up).items():
            assert t.dtype == want[name].dtype, name
            assert torch.equal(t, want[name]), name
            np.testing.assert_array_equal(t.numpy(), _fields(fc)[name])
        sched.run_cycle(now=now + 2 * c)
        ref.run_cycle(now=now + 2 * c)
    assert ds.stats["reused"] > 0 and ds.stats["put"] > 0


# ---------------------------------------------------------------------------
# what this slice leaves out, and no fallback hiding the device
# ---------------------------------------------------------------------------

def test_colo_pack_is_the_shared_pack():
    """colo_pack returns one pack, fed from the cache's own subscriptions:
    it replays the running pods at attach and follows later pod, node and
    metric events, as a standalone pack with its own subscriptions does."""
    from koordinator_tpu_torch.client.store import KIND_NODE_METRIC
    from koordinator_tpu_torch.colo.pack import ColoPack
    from koordinator_tpu_torch.utils.sloconfig import ColocationConfigSource

    store, state = churn_store(8, 8, seed=0)
    sched = Scheduler(store, waves=1, device="cpu")
    sched.run_cycle(now=state.now)
    cache = sched.snapshot_cache
    source = ColocationConfigSource(store, None)
    pack = cache.colo_pack(source)
    assert isinstance(pack, ColoPack)
    assert cache.colo_pack(source) is pack
    standalone = ColoPack(store, source)  # its own subscriptions
    bound = [p for p in store.list(KIND_POD) if p.is_assigned]
    assert bound
    store.delete(KIND_POD, bound[0].meta.key)
    nm = store.list(KIND_NODE_METRIC)[0]
    nm.update_time = state.now - 10_000.0
    store.update(KIND_NODE_METRIC, nm)
    shared, own = pack.view(state.now), standalone.view(state.now)
    assert set(shared) == set(own)
    assert shared["degraded"].any()
    for key in shared:
        if key == "nodes":
            assert shared[key] == own[key]
        elif isinstance(shared[key], str):
            assert shared[key] == own[key], key
        else:
            np.testing.assert_array_equal(shared[key], own[key],
                                          err_msg=key)


def test_rebalance_pack_is_the_shared_pack():
    """rebalance_pack returns one pack per metric expiration, fed from the
    cache's own subscriptions: it replays the running pods at attach and
    follows later events, as the JAX package's shared pack does."""
    from koordinator_tpu_torch.balance.pack import RebalancePack

    store, state = churn_store(8, 8, seed=0)
    sched = Scheduler(store, waves=1, device="cpu")
    sched.run_cycle(now=state.now)
    cache = sched.snapshot_cache
    pack = cache.rebalance_pack(180.0)
    assert isinstance(pack, RebalancePack)
    assert cache.rebalance_pack(180.0) is pack
    assert cache.rebalance_pack(300.0) is not pack
    standalone = RebalancePack(store, 180.0)  # its own subscriptions
    bound = [p for p in store.list(KIND_POD) if p.is_assigned]
    assert bound
    store.delete(KIND_POD, bound[0].meta.key)
    shared, own = pack.view(state.now), standalone.view(state.now)
    assert set(shared) == set(own)
    for key in shared:
        np.testing.assert_array_equal(shared[key], own[key], err_msg=key)


@pytest.mark.parametrize("kwargs,match", [
    (dict(explain="counts"), None),
    (dict(explain="full"), None),
    (dict(mesh=4), None),
    (dict(mesh="auto"), None),
    (dict(warmup="sync"), None),
    (dict(warmup="background"), None),
], ids=["explain-counts", "explain-full", "mesh", "mesh-auto",
        "warmup-sync", "warmup-background"])
def test_left_out_knobs_raise(kwargs, match, tmp_path, monkeypatch):
    """The knobs of paths a later slice brings raise, naming them;
    explain attribution, the warm-up ladder and the mesh are ported
    (match None): their knobs take effect (the mesh over the CPU's
    virtual shard devices). The sidecar's dispatches
    (test_sidecar_knob_dispatches)."""
    kwargs = {"waves": 1, **kwargs}
    if "mesh" in kwargs:
        monkeypatch.setenv("KOORD_TORCH_VIRTUAL_DEVICES", "4")
        sched = Scheduler(ObjectStore(), device="cpu", **kwargs)
        assert sched.mesh.size == 4
        assert sched.device_snapshot.mesh is sched.mesh
        return
    if match is None:
        if "warmup" in kwargs:
            monkeypatch.setenv("KOORD_TPU_COMPILE_CACHE_DIR",
                               str(tmp_path / "cc"))
        sched = Scheduler(ObjectStore(), device="cpu", **kwargs)
        if "warmup" in kwargs:
            assert sched._warmup_mode == kwargs["warmup"]
            sched.warmup.join(timeout=60)
            assert sched.warmup.background == (
                kwargs["warmup"] == "background")
            assert sched.warmup.stats["complete"] is True
        else:
            assert sched.explain_spec == kwargs["explain"]
        return
    with pytest.raises(NotImplementedError, match=match):
        Scheduler(ObjectStore(), device="cpu", **kwargs)


def test_sidecar_knob_dispatches(tmp_path):
    """``sidecar_address`` used to raise; now every cycle's batch goes to
    the ScheduleBatch server at that address and binds as the in-process
    serial dispatch does."""
    from koordinator_tpu_torch.scheduler.sidecar import serve_sidecar

    address = f"unix://{tmp_path}/sidecar.sock"
    server = serve_sidecar(address, device="cpu")
    try:
        store, state = churn_store(8, 40, seed=2)
        sched = Scheduler(store, device="cpu", waves=1,
                          sidecar_address=address)
        res = sched.run_cycle(now=state.now)
    finally:
        server.stop(0)
    twin_store, _ = churn_store(8, 40, seed=2)
    twin = Scheduler(twin_store, device="cpu", waves=1).run_cycle(
        now=state.now)
    assert sched.last_backend == "sidecar" and sched.sidecar_fallbacks == 0
    assert res.bound and ([(b.pod_key, b.node_name) for b in res.bound]
                          == [(b.pod_key, b.node_name) for b in twin.bound])


def test_mirror_owns_its_tensors_on_the_cpu():
    """On the CPU a tensor aliases the array it is made from: the mirror
    must keep its own copy, or a caller rewriting a reused host array in
    place (the pack does) changes a tensor a later upload reuses."""
    snap = DeviceSnapshot(device="cpu")
    first = np.arange(16, dtype=np.float32)
    dev = snap._one("f", first)
    first[:] = -1.0  # the caller reuses its buffer
    again = snap._one("f", np.arange(16, dtype=np.float32))
    assert snap.stats["reused"] == 1
    np.testing.assert_array_equal(again.numpy(), np.arange(16))
    assert again is dev


@pytest.mark.parametrize("env,value", [
    ("KOORD_TPU_MESH", "2"), ("KOORD_TPU_EXPLAIN", "counts"),
    ("KOORD_TPU_WARMUP", "sync"), ("KOORD_TPU_WAVES", "4"),
])
def test_left_out_env_knobs_raise(monkeypatch, tmp_path, env, value):
    monkeypatch.setenv(env, value)
    if env == "KOORD_TPU_WAVES":
        # the fused dispatch is ported: the knob pins K, and its per-wave
        # explain attribution rides it
        assert Scheduler(ObjectStore(), device="cpu").waves_spec == 4
        monkeypatch.setenv("KOORD_TPU_EXPLAIN", "counts")
        assert Scheduler(ObjectStore(), device="cpu").explain_spec == (
            "counts")
        return
    if env == "KOORD_TPU_MESH":
        # the mesh is ported: the knob takes effect over the visible
        # shard devices, and more than are visible raises
        with pytest.raises(ValueError, match="KOORD_TPU_MESH=2"):
            Scheduler(ObjectStore(), device="cpu", waves=1)
        monkeypatch.setenv("KOORD_TORCH_VIRTUAL_DEVICES", "2")
        assert Scheduler(ObjectStore(), device="cpu",
                         waves=1).mesh.size == 2
        return
    if env == "KOORD_TPU_EXPLAIN":
        # explain is ported: the knob takes effect
        assert Scheduler(ObjectStore(), device="cpu",
                         waves=1).explain_spec == "counts"
        return
    if env == "KOORD_TPU_WARMUP":
        # the warm-up ladder is ported: the knob takes effect, and it runs
        # once a cache dir is set
        assert Scheduler(ObjectStore(), device="cpu",
                         waves=1)._warmup_mode == "sync"
        monkeypatch.setenv("KOORD_TPU_COMPILE_CACHE_DIR",
                           str(tmp_path / "cc"))
        sched = Scheduler(ObjectStore(), device="cpu", waves=1)
        assert sched.warmup.stats["complete"] is True
        monkeypatch.setenv(env, "auto")
        sched = Scheduler(ObjectStore(), device="cpu", waves=1)
        assert sched._warmup_mode == "background"
        sched.warmup.join(timeout=60)
        return
    with pytest.raises(NotImplementedError):
        Scheduler(ObjectStore(), device="cpu", waves=1)


def test_auto_waves_raise_when_the_queue_resolves_deep():
    """waves="auto" resolves K from the queue depth: serial below 256
    pending pods, the fused dispatch at 256 and above (K = 2 there; it
    used to raise before the fused dispatch was ported)."""
    store, state = churn_store(8, 40, seed=0)
    res = Scheduler(store, device="cpu").run_cycle(now=state.now)
    assert res.waves == 1
    store, state = churn_store(16, 300, seed=0)
    res = Scheduler(store, device="cpu").run_cycle(now=state.now)
    assert res.waves == 2 and res.bound and not res.demotions


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler(ObjectStore(), waves=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceSnapshot()


def test_dispatch_failure_propagates_out_of_the_cycle():
    """A dispatch failure the degradation ladder must not absorb — the
    kernel build/contract error — propagates out of the cycle with
    nothing bound, by no fallback either; a device fault is the ladder's
    (tests/test_torch_degrade.py)."""
    from koordinator_tpu_torch.ops.kernel_common import KernelContractError

    store, state = churn_store(8, 16, seed=0)
    sched = Scheduler(store, waves=1, device="cpu")

    def boom(stage):
        raise KernelContractError(f"injected {stage} dispatch fault")

    def assigned():
        return sum(p.is_assigned for p in store.list(KIND_POD))

    before = assigned()
    sched.fault_injector = boom
    with pytest.raises(RuntimeError, match="injected serial"):
        sched.run_cycle(now=state.now)
    assert assigned() == before, "nothing bound, by no fallback either"
    assert sched.flight.dumps == 1
    assert sched.ladder.level == 0 and not sched.ladder.transitions


def test_readback_deadline_overrun_raises_and_abandons_the_mirror():
    """koordguard: with a dispatch deadline the readback runs on a
    watchdog worker; a sync slower than the deadline raises
    DispatchDeadlineExceeded into the dispatch window, the mirror is
    replaced, so no later scatter writes into tensors a slow round may
    still read, and the ladder's retry re-uploads into the fresh mirror
    through full puts and binds at full."""
    import time

    from koordinator_tpu_torch.scheduler import metrics as sm

    store, state = churn_store(8, 16, seed=0)
    sched = Scheduler(store, waves=1, device="cpu", dispatch_deadline_ms=50)
    mirror = sched.device_snapshot
    slow = [1]

    def delay():
        if slow:
            slow.pop()
            time.sleep(0.3)

    sched.sync_delay_injector = delay
    retries = sm.DISPATCH_RETRIES.get(stage="serial") or 0.0
    res = sched.run_cycle(now=state.now)
    assert sched.device_snapshot is not mirror
    assert sched.dispatch_watchdog.overruns == 1
    assert sm.DISPATCH_RETRIES.get(stage="serial") == retries + 1
    assert res.bound and sched.device_snapshot.stats["put"] > 0
    assert sched.ladder.level == 0 and sched.last_backend == "serial"
    add_arrivals(store, arrival_specs(1, 4), state.now + 1)
    res = sched.run_cycle(now=state.now + 2)
    assert res.bound and sched.device_snapshot.stats["reused"] > 0
