"""Mesh-backed production dispatch of the port (KOORD_TPU_MESH): the cases
of tests/test_mesh_dispatch.py on the port, on the CPU.

The scheduling cycle sharded over a mesh of virtual CPU shards must be
byte-identical to the single-device path; the sharding helpers absorb
non-divisible axis sizes; the mesh path is observable (devices and shard
gauges, shard spans). The JAX package runs these on its 8 virtual CPU
devices; the port's meshes are D virtual shards of the CPU
(testing/mesh_round.virtual_mesh, or KOORD_TORCH_VIRTUAL_DEVICES=8 for the
``mesh=<n>`` knob). ``run_mesh_parity`` is run as the JAX package runs it,
plus fused K = 4 at every depth and explain "full".
"""

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
from koordinator_tpu_torch.scheduler.pipeline_parity import run_mesh_parity
from koordinator_tpu_torch.testing.mesh_round import virtual_mesh


@pytest.fixture
def eight_shards(monkeypatch):
    """The port's counterpart of the ``cpu_devices`` fixture: the CPU
    appears as 8 shard devices."""
    monkeypatch.setenv("KOORD_TORCH_VIRTUAL_DEVICES", "8")


# ---------------------------------------------------------------------------
# production-path parity (the tentpole gate)
# ---------------------------------------------------------------------------

def test_mesh_parity_serial_2dev():
    rep = run_mesh_parity(2, device="cpu")
    assert rep["ok"], rep["mismatches"]
    assert rep["conditions_checked"] > 0


def test_mesh_parity_fused_8dev():
    rep = run_mesh_parity(8, waves=4, device="cpu")
    assert rep["ok"], rep["mismatches"]


def test_mesh_parity_explain_counts():
    rep = run_mesh_parity(4, explain="counts", device="cpu")
    assert rep["ok"], rep["mismatches"]


def test_mesh_parity_non_divisible_mesh():
    """3 shards never divide the node buckets, so every upload pads
    (pad_for_sharding inside put_on_mesh)."""
    rep = run_mesh_parity(3, device="cpu")
    assert rep["ok"], rep["mismatches"]


@pytest.mark.parametrize("ndev", [2, 3, 4])
def test_mesh_parity_fused_k4(ndev):
    """The default path's dispatch shape (chained waves with the replay
    overlapped) on every depth, explain counts riding it."""
    rep = run_mesh_parity(ndev, waves=4, explain="counts", device="cpu")
    assert rep["ok"], rep["mismatches"]


def test_mesh_parity_explain_full_auto_waves():
    rep = run_mesh_parity(8, waves="auto", explain="full", device="cpu")
    assert rep["ok"], rep["mismatches"]


# ---------------------------------------------------------------------------
# DeviceSnapshot: sharded upload + owner-shard scatter
# ---------------------------------------------------------------------------

def _snap(n):
    from koordinator_tpu_torch.scheduler.snapshot_cache import DeviceSnapshot

    return DeviceSnapshot(device="cpu", mesh=virtual_mesh(n, "cpu"))


def test_device_snapshot_mesh_upload_shards_node_axis():
    ds = _snap(8)
    node_arr = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    pod_arr = np.ones((16, 3), np.float32)
    dev_node = ds._one("allocatable", node_arr)
    dev_pod = ds._one("fit_requests", pod_arr)
    # node-axis field sharded over all devices; pod field replicated
    assert len({d.id for d, _t, _i in dev_node.addressable_shards}) == 8
    assert dev_node.addressable_shards[0][1].shape[0] == 8  # 64 / 8
    assert np.asarray(dev_pod).shape == pod_arr.shape
    for _d, t, _i in dev_pod.addressable_shards:
        assert tuple(t.shape) == pod_arr.shape  # replicated: full copy


def test_device_snapshot_mesh_pads_non_divisible():
    ds = _snap(8)
    node_arr = np.random.default_rng(0).random((30, 3)).astype(np.float32)
    dev = ds._one("allocatable", node_arr)
    assert tuple(dev.shape) == (32, 3)  # padded to the mesh factor
    host = np.asarray(dev)
    np.testing.assert_array_equal(host[:30], node_arr)
    assert not host[30:].any()  # zero pad rows
    # an unchanged re-upload reuses the tensors (pad rows never look dirty)
    before = dict(ds.stats)
    dev2 = ds._one("allocatable", node_arr)
    assert dev2 is dev
    assert ds.stats["reused"] == before["reused"] + 1


def test_device_snapshot_mesh_scatter_keeps_sharding():
    ds = _snap(8)
    rng = np.random.default_rng(1)
    node_arr = rng.random((64, 4)).astype(np.float32)
    dev = ds._one("requested", node_arr)
    sharding = dev.sharding
    # dirty two rows on different shards -> the scatter path, each row
    # written only into the shard that owns it
    node_arr2 = node_arr.copy()
    node_arr2[3] += 1.0
    node_arr2[60] += 2.0
    dev2 = ds._one("requested", node_arr2)
    assert ds.stats["scattered"] == 1
    assert dev2.sharding == sharding
    np.testing.assert_array_equal(np.asarray(dev2), node_arr2)
    # in place (no dispatch in flight): every shard stays the same tensor
    assert all(a is b for a, b in zip(dev.shards, dev2.shards))


def test_device_snapshot_mesh_scatter_respects_dispatch_guard():
    ds = _snap(2)
    node_arr = np.zeros((64, 4), np.float32)
    dev = ds._one("requested", node_arr)
    ds.begin_dispatch()
    try:
        node_arr2 = node_arr.copy()
        node_arr2[5] = 1.0
        dev2 = ds._one("requested", node_arr2)
    finally:
        ds.end_dispatch()
    assert ds.stats["scattered_safe"] == 1  # the owning shard cloned
    assert dev2.shards[0] is not dev.shards[0]
    assert dev2.shards[1] is dev.shards[1]
    assert not np.asarray(dev).any()  # the round's view stayed whole


# ---------------------------------------------------------------------------
# mesh observability
# ---------------------------------------------------------------------------

def _mesh_world(num_nodes=16, num_pods=40, ndev=4, **kw):
    from koordinator_tpu_torch.scheduler.cycle import Scheduler
    from koordinator_tpu_torch.scheduler.pipeline_parity import (
        build_store_from_state,
    )
    from koordinator_tpu_torch.testing import synth_full_cluster

    _cluster, state = synth_full_cluster(
        num_nodes, num_pods, seed=5, num_quotas=2, num_gangs=2)
    store = build_store_from_state(state)
    return Scheduler(store, mesh=ndev, device="cpu", **kw), state


def test_mesh_cycle_emits_shard_spans_and_gauges(eight_shards):
    sched, state = _mesh_world(ndev=4, waves=1)
    assert scheduler_metrics.MESH_DEVICES.get() == 4.0
    res = sched.run_cycle(now=state.now)
    assert res.bound  # the fixture must actually schedule
    root = sched.tracer.roots(limit=1)[0]
    kernel = root.find("kernel")

    def under(span):
        for child in span.children:
            yield child
            yield from under(child)

    # the port's readback span sits inside the kernel span; the markers
    # hang under it
    shards = [s for s in under(kernel) if s.name == "shard"]
    assert len(shards) == 4
    assert [s.attributes["index"] for s in shards] == ["0", "1", "2", "3"]
    total_rows = sum(int(s.attributes["rows"]) for s in shards)
    assert total_rows == 16  # real rows split across shards
    imb = scheduler_metrics.MESH_SHARD_IMBALANCE.get()
    assert imb is not None and imb >= 1.0
    assert any(
        scheduler_metrics.MESH_SHARD_READBACK_BYTES.get(shard=str(i))
        for i in range(4))
    assert sched.last_backend == "serial"  # the plain sharded round


def test_mesh_off_reports_zero_devices():
    from koordinator_tpu_torch.client.store import ObjectStore
    from koordinator_tpu_torch.scheduler.cycle import Scheduler

    Scheduler(ObjectStore(), mesh="off", device="cpu")
    assert scheduler_metrics.MESH_DEVICES.get() == 0.0


def test_mesh_from_env_parsing(eight_shards, monkeypatch):
    from koordinator_tpu_torch.parallel import mesh_from_env

    assert mesh_from_env(env_value="off", device="cpu") is None
    assert mesh_from_env(env_value="0", device="cpu") is None
    assert mesh_from_env(env_value="auto", device="cpu").devices.size == 8
    assert mesh_from_env(env_value=4, device="cpu").devices.size == 4
    assert mesh_from_env(env_value="1", device="cpu").devices.size == 1
    assert mesh_from_env(env_value="bogus", device="cpu") is None
    with pytest.raises(ValueError):
        mesh_from_env(env_value=99, device="cpu")
    monkeypatch.setenv("KOORD_TPU_MESH", "2")
    assert mesh_from_env(device="cpu").devices.size == 2
    # "auto" with one visible device is the single-device path
    monkeypatch.setenv("KOORD_TORCH_VIRTUAL_DEVICES", "1")
    assert mesh_from_env(env_value="auto", device="cpu") is None


def test_mesh_demoted_with_sidecar(eight_shards):
    from koordinator_tpu_torch.client.store import ObjectStore
    from koordinator_tpu_torch.scheduler.cycle import Scheduler

    sched = Scheduler(ObjectStore(), mesh=2, device="cpu",
                      sidecar_address="localhost:1")
    assert sched.mesh is None  # the sidecar protocol is single-device


# ---------------------------------------------------------------------------
# batched per-dispatch condition writes
# ---------------------------------------------------------------------------

def test_fused_dispatch_single_condition_flush():
    """A non-pipelined fused dispatch drains ALL its logical cycles'
    PodScheduled writes in one flush after the wave replay — on a mesh
    too."""
    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.scheduler.cycle import Scheduler
    from koordinator_tpu_torch.scheduler.pipeline_parity import (
        build_store_from_state,
    )
    from koordinator_tpu_torch.testing import synth_full_cluster

    _cluster, state = synth_full_cluster(24, 70, seed=11, num_quotas=3,
                                         num_gangs=4, topology_fraction=0.5,
                                         lsr_fraction=0.2)
    store = build_store_from_state(state)
    events = []

    def on_pod(ev, pod, old):
        cond = pod.get_condition("PodScheduled")
        if cond is not None and cond.status == "False":
            events.append(("cond", pod.meta.key))
        elif pod.is_assigned and (old is None or not old.is_assigned):
            events.append(("bind", pod.meta.key))

    store.subscribe(KIND_POD, on_pod)
    sched = Scheduler(store, waves=4, mesh=virtual_mesh(2, "cpu"),
                      device="cpu", replay_overlap=False)
    assert sched.pipeline_mode is False
    res = sched.run_cycle(now=state.now)
    assert res.waves >= 1
    conds = [i for i, e in enumerate(events) if e[0] == "cond"]
    binds = [i for i, e in enumerate(events) if e[0] == "bind"]
    assert conds, "fixture produced no unschedulable pods"
    assert binds, "fixture produced no bindings"
    assert min(conds) > max(binds)
    assert not sched._deferred_diagnose
    assert sched._defer_condition_writes is False


# ---------------------------------------------------------------------------
# sharding helpers: padding + the multi-process branch + dtypes
# ---------------------------------------------------------------------------

def _la(num_nodes, num_pods, seed, pad_pods=None, pad_nodes=None):
    from koordinator_tpu_torch.models.scheduler_model import make_inputs
    from koordinator_tpu_torch.ops.loadaware import (
        LoadAwareArgs,
        build_loadaware_node_state,
    )
    from koordinator_tpu_torch.ops.packing import pack_nodes, pack_pods
    from koordinator_tpu_torch.testing import synth_cluster

    args = LoadAwareArgs()
    cluster = synth_cluster(num_nodes=num_nodes, num_pods=num_pods,
                            seed=seed)
    pods = pack_pods(cluster.pods, args.resource_weights,
                     args.estimated_scaling_factors,
                     **({"pad_to": pad_pods} if pad_pods else {}))
    nodes = pack_nodes(cluster.nodes,
                       **({"pad_to": pad_nodes} if pad_nodes else {}))
    nodes.extras = build_loadaware_node_state(
        cluster.nodes, cluster.node_metrics, cluster.pods_by_key,
        cluster.assigned, args, cluster.now, pad_to=nodes.padded_size)
    return args, pods, make_inputs(pods, nodes, args)


def test_put_on_mesh_pads_1023_node_snapshot():
    """1023 nodes on 8 shards: the helpers pad to the mesh factor
    internally; bindings match the single-device step bit for bit."""
    from koordinator_tpu_torch.models.convert import (
        schedule_inputs_from_numpy,
    )
    from koordinator_tpu_torch.models.scheduler_model import (
        build_schedule_step,
    )
    from koordinator_tpu_torch.parallel import (
        build_sharded_schedule_step,
        shard_inputs_nodewise,
    )

    args, pods, inputs = _la(1023, 64, 2, pad_nodes=1023)
    assert inputs.allocatable.shape[0] == 1023
    chosen_1, _ = build_schedule_step(args)(
        schedule_inputs_from_numpy(inputs._asdict(), "cpu"))
    mesh = virtual_mesh(8, "cpu")
    sharded = shard_inputs_nodewise(inputs, mesh)
    assert sharded.allocatable.shape[0] == 1024  # padded inside the helper
    assert sharded.pod_valid.shape == inputs.pod_valid.shape  # replicated
    chosen_8, _ = build_sharded_schedule_step(args, mesh)(sharded)
    np.testing.assert_array_equal(chosen_1.numpy(), np.asarray(chosen_8))
    assert (chosen_1.numpy()[: pods.num_valid] >= 0).sum() > 0


def test_shard_inputs_2d_pads_both_axes():
    from koordinator_tpu_torch.parallel import shard_inputs_2d
    from koordinator_tpu_torch.parallel.mesh import Mesh

    _args, _pods, inputs = _la(29, 17, 4, pad_pods=17, pad_nodes=29)
    mesh = virtual_mesh(8, "cpu")  # 2 x 4: pods x 2, nodes x 4
    assert isinstance(mesh, Mesh)
    sharded = shard_inputs_2d(inputs, mesh)
    assert sharded.fit_requests.shape[0] % 2 == 0   # pods axis padded
    assert sharded.allocatable.shape[0] % 4 == 0    # nodes axis padded
    assert sharded.weights.shape == inputs.weights.shape  # replicated


def test_shard_inputs_preserve_dtypes():
    """Every field of the sharders keeps the dtype the single-device
    upload gives the same host array (models/convert.as_tensor): an
    upcast would change the numerics on the mesh only."""
    from koordinator_tpu_torch.models.convert import to_device
    from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
    from koordinator_tpu_torch.parallel import (
        shard_full_chain_inputs,
        shard_inputs_2d,
        shard_inputs_nodewise,
    )
    from koordinator_tpu_torch.scheduler.snapshot import (
        build_full_chain_inputs,
    )
    from koordinator_tpu_torch.testing import synth_full_cluster

    _cluster, state = synth_full_cluster(12, 24, seed=6)
    fc, *_rest = build_full_chain_inputs(state, LoadAwareArgs())
    single = to_device(fc, "cpu")
    mesh = virtual_mesh(8, "cpu")
    for sharder, val, ref in (
        (shard_inputs_nodewise, fc.base, single.base),
        (shard_inputs_2d, fc.base, single.base),
        (shard_full_chain_inputs, fc, single),
    ):
        out = sharder(val, mesh)
        for name in type(val)._fields:
            if name == "base":
                continue  # covered by the nodewise pass above
            assert getattr(out, name).dtype == getattr(ref, name).dtype, (
                sharder.__name__, name)


def test_put_on_mesh_multihost_branch():
    """The branch a mesh spanning processes takes: this process (rank 0)
    materializes only its own shards, each exactly its slice of the
    padded host array; the other process's slots stay empty."""
    from koordinator_tpu_torch.parallel.mesh import (
        MeshDevice,
        NamedSharding,
        P,
        make_mesh,
        put_on_mesh,
    )

    cpu = torch.device("cpu")
    mesh = make_mesh([MeshDevice(k, cpu, k // 4) for k in range(8)])
    assert mesh.spans_processes and mesh.rank == 0
    sharding = NamedSharding(mesh, P(("pods", "nodes")))
    rng = np.random.default_rng(7)
    for dtype in (np.float32, np.int32, bool):
        host = (rng.random((42, 3)) * 10).astype(dtype)  # 42 -> pad 48
        arr = put_on_mesh(host, sharding)
        assert tuple(arr.shape) == (48, 3)
        assert arr.local().numpy().dtype == host.dtype
        padded = np.zeros((48, 3), dtype)
        padded[:42] = host
        held = arr.addressable_shards
        assert [d.id for d, _t, _i in held] == [0, 1, 2, 3]
        assert arr.shards[4:] == [None] * 4
        for _d, t, idx in held:
            np.testing.assert_array_equal(t.numpy(), padded[idx])


def test_pad_for_sharding_noop_when_divisible():
    from koordinator_tpu_torch.parallel.mesh import (
        NamedSharding,
        P,
        pad_for_sharding,
    )

    mesh = virtual_mesh(8, "cpu")
    sharding = NamedSharding(mesh, P(("pods", "nodes")))
    arr = np.ones((64, 3), np.float32)
    assert pad_for_sharding(arr, sharding) is arr  # divisible: no copy
    rep = NamedSharding(mesh, P())
    odd = np.ones((7, 3), np.float32)
    assert pad_for_sharding(odd, rep) is odd  # replicated: never padded


def test_mesh_row_layout_imbalance():
    from koordinator_tpu_torch.parallel import mesh_row_layout

    mesh = virtual_mesh(8, "cpu")
    rows = mesh_row_layout(mesh, n_real=30, n_padded=32)
    assert rows == [4, 4, 4, 4, 4, 4, 4, 2]
    assert sum(rows) == 30
