"""The port's mesh (koordinator_tpu_torch/parallel/) against the JAX
package's sharded steps, on the CPU.

The JAX package runs its mesh on 8 virtual CPU devices (tests/conftest.py,
the ``cpu_devices`` fixture); the port splits the CPU into virtual shard
devices the same way (KOORD_TORCH_VIRTUAL_DEVICES, or a mesh built from
explicit shard devices, testing/mesh_round.virtual_mesh) and runs its plain
sharded round there. The same numpy inputs, packed by the JAX package from
a seeded cluster, go through the JAX sharded step and the port's sharded
step at D = 1, 2, 3, 4 and 8 shards (3 divides neither the node buckets nor
the padding, so its uploads pad). Tolerance 0: chosen, requested,
quota_used, the wave rows and the explain counts are bit-identical, to the
JAX sharded step and to the port's own single-device round. The explain
"full" terms equal the port's single-device rows bit for bit and the
jitted JAX step's within 1 ulp (ROADMAP queue 3's caveat).

The cases of tests/test_parallel.py and tests/test_full_chain_mesh.py run
here on the port under their own names.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from koordinator_tpu.models.scheduler_model import make_inputs as ref_inputs
from koordinator_tpu.ops.loadaware import (
    LoadAwareArgs as RefArgs,
    build_loadaware_node_state,
)
from koordinator_tpu.ops.packing import pack_nodes, pack_pods
from koordinator_tpu.parallel import (
    build_sharded_full_chain_step as ref_sharded_fc,
    build_sharded_schedule_step as ref_sharded_schedule,
    build_sharded_score_matrix as ref_sharded_matrix,
    build_sharded_fused_wave_step as ref_sharded_fused,
    make_mesh as ref_make_mesh,
    put_on_mesh as ref_put,
    shard_full_chain_inputs as ref_shard_fc,
    shard_inputs_2d as ref_shard_2d,
    shard_inputs_nodewise as ref_shard_nodewise,
    wave_side_shardings as ref_side_shardings,
)
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
    reduce_to_active_axes as ref_reduce,
)
from koordinator_tpu.testing import (
    synth_cluster as ref_synth_cluster,
    synth_full_cluster as ref_synth,
)

from koordinator_tpu_torch.models import fused_waves as fw
from koordinator_tpu_torch.models.convert import (
    schedule_inputs_from_numpy,
    to_device,
)
from koordinator_tpu_torch.models.full_chain import (
    FullChainInputs,
    build_full_chain_step,
)
from koordinator_tpu_torch.models.scheduler_model import (
    ScheduleInputs,
    build_schedule_step,
    build_score_matrix,
)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.parallel import (
    build_sharded_chained_wave_step,
    build_sharded_full_chain_step,
    build_sharded_fused_wave_step,
    build_sharded_schedule_step,
    build_sharded_score_matrix,
    initial_sharded_wave_carry,
    make_mesh,
    put_on_mesh,
    shard_full_chain_inputs,
    shard_inputs_2d,
    shard_inputs_nodewise,
    visible_devices,
    wave_side_shardings,
)
from koordinator_tpu_torch.parallel.mesh import (
    MeshDevice,
    surviving_submesh,
)
from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

DEPTHS = (1, 2, 3, 4, 8)


def _np_fc(fc):
    """A JAX pack as the port's FullChainInputs of numpy arrays."""
    base = ScheduleInputs(**{k: np.asarray(v)
                             for k, v in fc.base._asdict().items()})
    return FullChainInputs(base=base, **{
        k: np.asarray(v) for k, v in fc._asdict().items() if k != "base"})


def _np_si(si):
    return ScheduleInputs(**{k: np.asarray(v) for k, v in si._asdict().items()})


@functools.lru_cache(maxsize=None)
def _full_chain(seed, num_nodes=30, num_pods=60, reduce=False, **kw):
    args = RefArgs()
    _c, state = ref_synth(num_nodes, num_pods, seed=seed, **kw)
    fc, pods, _n, _t, _g, ng, ngroups = ref_build(state, args)
    active = None
    if reduce:
        fc, active = ref_reduce(fc)
    return args, fc, pods, ng, ngroups, active


@functools.lru_cache(maxsize=None)
def _loadaware(num_nodes=48, num_pods=64, seed=0, pad=None):
    cluster = ref_synth_cluster(num_nodes=num_nodes, num_pods=num_pods,
                                seed=seed)
    args = RefArgs()
    pods = pack_pods(cluster.pods, args.resource_weights,
                     args.estimated_scaling_factors,
                     **({"pad_to": pad[0]} if pad else {}))
    nodes = pack_nodes(cluster.nodes, **({"pad_to": pad[1]} if pad else {}))
    nodes.extras = build_loadaware_node_state(
        cluster.nodes, cluster.node_metrics, cluster.pods_by_key,
        cluster.assigned, args, cluster.now, pad_to=nodes.padded_size)
    return args, pods, ref_inputs(pods, nodes, args)


def _port_args():
    return LoadAwareArgs()


def _host(x):
    return np.asarray(x)


def _assert_round(ref, out, n_real=None):
    """chosen, requested (its real rows), quota_used: bit for bit."""
    np.testing.assert_array_equal(_host(ref[0]), _host(out[0]))
    req_r, req = _host(ref[1]), _host(out[1])
    n = req_r.shape[0] if n_real is None else n_real
    np.testing.assert_array_equal(req_r[:n], req[:n])
    np.testing.assert_array_equal(_host(ref[2]), _host(out[2]))


# ---------------------------------------------------------------------------
# tests/test_parallel.py on the port
# ---------------------------------------------------------------------------

def test_mesh_shape(cpu_devices, monkeypatch):
    monkeypatch.setenv("KOORD_TORCH_VIRTUAL_DEVICES", "8")
    mesh = make_mesh(visible_devices("cpu"))
    ref = ref_make_mesh(cpu_devices)
    assert mesh.devices.size == ref.devices.size == 8
    assert mesh.axis_names == ref.axis_names == ("pods", "nodes")
    assert mesh.devices.shape == ref.devices.shape == (2, 4)
    assert [d.id for d in mesh.devices.flat] == list(range(8))


def test_sharded_serial_step_matches_single_device(cpu_devices):
    args, _pods, inputs = _loadaware()
    host = _np_si(inputs)
    single = build_schedule_step(_port_args())(
        schedule_inputs_from_numpy(host._asdict(), "cpu"))
    mesh = virtual_mesh(8, "cpu")
    step = build_sharded_schedule_step(_port_args(), mesh)
    out = step(shard_inputs_nodewise(host, mesh))
    assert step.last_backend == "serial"
    np.testing.assert_array_equal(single[0].numpy(), _host(out[0]))
    np.testing.assert_array_equal(single[1].numpy(), _host(out[1]))
    rm = ref_make_mesh(cpu_devices)
    ref = ref_sharded_schedule(args, rm)(ref_shard_nodewise(inputs, rm))
    np.testing.assert_array_equal(_host(ref[0]), _host(out[0]))
    assert (_host(out[0]) >= 0).sum() > 0


def test_sharded_score_matrix_matches(cpu_devices):
    args, _pods, inputs = _loadaware(seed=3)
    host = _np_si(inputs)
    feas_1, score_1 = build_score_matrix(_port_args())(
        schedule_inputs_from_numpy(host._asdict(), "cpu"))
    mesh = virtual_mesh(8, "cpu")
    feas_8, score_8 = build_sharded_score_matrix(_port_args(), mesh)(
        shard_inputs_2d(host, mesh))
    np.testing.assert_array_equal(feas_1.numpy(), _host(feas_8))
    np.testing.assert_array_equal(score_1.numpy(), _host(score_8))
    rm = ref_make_mesh(cpu_devices)
    ref = ref_sharded_matrix(args, rm)(ref_shard_2d(inputs, rm))
    np.testing.assert_array_equal(_host(ref[0]), _host(feas_8))
    np.testing.assert_array_equal(_host(ref[1]), _host(score_8))


# ---------------------------------------------------------------------------
# tests/test_full_chain_mesh.py on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "seed,kw",
    [
        (0, {}),                                        # mixed: NUMA+quota+gang
        (7, {"topology_fraction": 1.0, "lsr_fraction": 0.4}),  # all-topology
        (11, {"num_nodes": 40, "num_pods": 96}),        # bigger batch
        (13, {"num_nodes": 4, "num_pods": 40}),         # tiny cluster, gang strikes
    ],
)
def test_sharded_full_chain_matches_single_device(cpu_devices, seed, kw):
    kw = dict(kw)
    n, p = kw.pop("num_nodes", 30), kw.pop("num_pods", 60)
    args, fc, pods, ng, ngroups, _a = _full_chain(
        seed, n, p, **dict(sorted(kw.items())))
    host = _np_fc(fc)
    single = build_full_chain_step(_port_args(), ng, ngroups)(
        to_device(host, "cpu"))
    mesh = virtual_mesh(8, "cpu")
    out = build_sharded_full_chain_step(_port_args(), ng, ngroups, mesh)(
        shard_full_chain_inputs(host, mesh))
    _assert_round(single, out)
    rm = ref_make_mesh(cpu_devices)
    ref = ref_sharded_fc(args, ng, ngroups, rm)(ref_shard_fc(fc, rm))
    _assert_round(ref, out)
    assert (_host(out[0])[: len(pods.keys)] >= 0).sum() > 0


def test_sharded_full_chain_large_shape(cpu_devices):
    """Bucket/pad/shard interplay at a non-toy scale: 2048 x 1024 with
    the axes reduced to the active set, under the 8-shard mesh."""
    args, fc, pods, ng, ngroups, axes = _full_chain(
        1, num_nodes=1024, num_pods=2048, reduce=True)
    host = _np_fc(fc)
    mesh = virtual_mesh(8, "cpu")
    chosen_8 = _host(build_sharded_full_chain_step(
        _port_args(), ng, ngroups, mesh, active_axes=axes)(
            shard_full_chain_inputs(host, mesh))[0])
    rm = ref_make_mesh(cpu_devices)
    ref = _host(ref_sharded_fc(args, ng, ngroups, rm, active_axes=axes)(
        ref_shard_fc(fc, rm))[0])
    np.testing.assert_array_equal(ref, chosen_8)
    assert (chosen_8[: len(pods.keys)] >= 0).sum() >= 1024
    assert len(pods.keys) >= 2048


def test_sharded_full_chain_gang_and_quota_active(cpu_devices):
    _args, fc, pods, ng, ngroups, _a = _full_chain(0)
    host = _np_fc(fc)
    mesh = virtual_mesh(8, "cpu")
    chosen, _, quota_used = build_sharded_full_chain_step(
        _port_args(), ng, ngroups, mesh)(shard_full_chain_inputs(host, mesh))
    chosen = _host(chosen)[: len(pods.keys)]
    gang_id = host.gang_id[: len(pods.keys)]
    quota_id = host.quota_id[: len(pods.keys)]
    assert (gang_id >= 0).any() and (quota_id >= 0).any()
    assert ((chosen >= 0) & (quota_id >= 0)).sum() > 0
    assert _host(quota_used).sum() > host.quota_used.sum()


# ---------------------------------------------------------------------------
# every depth, against the JAX sharded step and the port's single device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", DEPTHS)
def test_full_chain_and_explain_at_every_depth(cpu_devices, depth):
    """The serial step, explain "counts" and "full", at D shards."""
    args, fc, _pods, ng, ngroups, _a = _full_chain(
        5, 24, 48, topology_fraction=0.5, lsr_fraction=0.2)
    host = _np_fc(fc)
    n_real = 24
    mesh = virtual_mesh(depth, "cpu")
    rm = ref_make_mesh(cpu_devices[:depth])
    sfc = shard_full_chain_inputs(host, mesh)
    single = build_full_chain_step(_port_args(), ng, ngroups,
                                   explain="full")(to_device(host, "cpu"),
                                                   n_real)
    for explain in (None, "counts", "full"):
        step = build_sharded_full_chain_step(_port_args(), ng, ngroups,
                                             mesh, explain=explain)
        out = step(sfc, n_real) if explain else step(sfc)
        _assert_round(single, out, n_real)
        ref_step = ref_sharded_fc(args, ng, ngroups, rm, explain=explain)
        ref = (ref_step(ref_shard_fc(fc, rm), n_real) if explain
               else ref_step(ref_shard_fc(fc, rm)))
        _assert_round(ref, out, n_real)
        if explain is None:
            continue
        counts = _host(out[3].stage_counts)
        np.testing.assert_array_equal(single[3].stage_counts.numpy(), counts)
        np.testing.assert_array_equal(_host(ref[3].stage_counts), counts)
        if explain == "full":
            terms = _host(out[3].terms)
            np.testing.assert_array_equal(single[3].terms.numpy(), terms)
            # rows outside pod_valid are 0 in the port by design; the
            # jitted JAX step's valid rows agree within 1 ulp
            valid = host.base.pod_valid
            np.testing.assert_array_max_ulp(_host(ref[3].terms)[valid],
                                            terms[valid], maxulp=1)


@pytest.mark.parametrize("depth", DEPTHS)
def test_loadaware_and_matrix_at_every_depth(cpu_devices, depth):
    args, _pods, inputs = _loadaware(num_nodes=29, num_pods=17, seed=4,
                                     pad=(17, 29))
    host = _np_si(inputs)
    dev_inputs = schedule_inputs_from_numpy(host._asdict(), "cpu")
    single = build_schedule_step(_port_args())(dev_inputs)
    matrix = build_score_matrix(_port_args())(dev_inputs)
    mesh = virtual_mesh(depth, "cpu")
    rm = ref_make_mesh(cpu_devices[:depth])
    out = build_sharded_schedule_step(_port_args(), mesh)(
        shard_inputs_nodewise(host, mesh))
    ref = ref_sharded_schedule(args, rm)(ref_shard_nodewise(inputs, rm))
    for r in (single, ref):
        np.testing.assert_array_equal(_host(r[0]), _host(out[0]))
        np.testing.assert_array_equal(_host(r[1])[:29], _host(out[1])[:29])
    feas, score = build_sharded_score_matrix(_port_args(), mesh)(
        shard_inputs_2d(host, mesh))
    ref_m = ref_sharded_matrix(args, rm)(ref_shard_2d(inputs, rm))
    for r in (matrix, ref_m):
        np.testing.assert_array_equal(_host(r[0])[:17, :29],
                                      _host(feas)[:17, :29])
        np.testing.assert_array_equal(_host(r[1])[:17, :29],
                                      _host(score)[:17, :29])


def _wave_inputs():
    from test_torch_fused_waves import _world_inputs

    return _world_inputs("synth")


def _shard_sides(sides, mesh):
    sh = wave_side_shardings(mesh, prod=sides.prod is not None,
                             claims=sides.claims is not None,
                             res=sides.res is not None)

    def put(x, s):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(put(a, b) for a, b in zip(x, s)))
        return put_on_mesh(x, s)

    return put(sides, sh)


def _ref_shard_sides(sides, rm, b):
    """The JAX side inputs of the same world on the JAX mesh: the
    LoadAware split and, where the world has them, the prod split, the
    hot-claim and the reservation sides."""
    from test_torch_fused_waves import _ref_sides

    sh = ref_side_shardings(rm, prod=b["prod"], claims=b["claims"],
                            res=b["res"])

    def put(x, s):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(put(a, c) for a, c in zip(x, s)))
        return ref_put(x, s)

    return put(_ref_sides(sides), sh)


@pytest.mark.parametrize("depth", DEPTHS)
def test_wave_steps_at_every_depth(cpu_devices, depth):
    """The fused K = 4 step and the chained step, with explain counts, at
    D shards: every wave row and count against the single-device steps,
    and the fused rows against the JAX sharded fused step."""
    from test_torch_fused_waves import _args, _fc, _ref_args, _ref_fc, _sides

    fc, sides, b = _wave_inputs()
    kw = dict(active_axes=b["active_axes"], prod=b["prod"],
              claims=b["claims"], res=b["res"])
    n_real = int(np.asarray(fc.base.node_ok).sum())
    single = fw.build_fused_wave_step(
        _args(False), b["num_gangs"], b["num_groups"], waves=4,
        explain="counts", **kw)(_fc(fc), _sides(sides), n_real)
    mesh = virtual_mesh(depth, "cpu")
    sfc, ssides = shard_full_chain_inputs(fc, mesh), _shard_sides(sides,
                                                                  mesh)
    out, ex = build_sharded_fused_wave_step(
        _args(False), b["num_gangs"], b["num_groups"], 4, mesh,
        explain="counts", **kw)(sfc, ssides, n_real)
    fields = ("bind_pods", "bind_nodes", "bind_zones", "bind_res",
              "wave_counts")
    for k in fields:
        np.testing.assert_array_equal(getattr(single[0], k).numpy(),
                                      _host(getattr(out, k)), err_msg=k)
    assert out.waves_run == single[0].waves_run >= 2
    np.testing.assert_array_equal(single[1].stage_counts.numpy(),
                                  _host(ex.stage_counts))
    rm = ref_make_mesh(cpu_devices[:depth])
    ref = ref_sharded_fused(
        _ref_args(False), b["num_gangs"], b["num_groups"], 4, rm, **kw)(
            ref_shard_fc(_ref_fc(fc), rm), _ref_shard_sides(sides, rm, b))
    for k in fields:
        np.testing.assert_array_equal(_host(getattr(ref, k)),
                                      _host(getattr(out, k)), err_msg=k)
    # the chained step, wave by wave, the carry staying on its shards
    cstep = fw.build_chained_wave_step(_args(False), b["num_gangs"],
                                       b["num_groups"], explain="counts",
                                       **kw)
    sstep = build_sharded_chained_wave_step(
        _args(False), b["num_gangs"], b["num_groups"], mesh,
        explain="counts", **kw)
    pfc, psides = _fc(fc), _sides(sides)
    carry = fw.initial_wave_carry(pfc, psides)
    scarry = initial_sharded_wave_carry(sfc, ssides, mesh)
    for _w in range(3):
        carry, rows, counts = cstep(pfc, carry, psides, n_real)
        scarry, srows, scounts = sstep(sfc, scarry, ssides, n_real)
        for a, s in zip(rows, srows):
            np.testing.assert_array_equal(a.numpy(), _host(s))
        np.testing.assert_array_equal(counts.numpy(), _host(scounts))
    node_slot = 1  # requested: its shards hold the carried rows
    assert len(scarry[node_slot].shards) == depth
    np.testing.assert_array_equal(carry[node_slot].numpy(),
                                  _host(scarry[node_slot])[:fc.base.allocatable.shape[0]])


@pytest.mark.parametrize("world", ["reservations", "claims", "prod", "gang",
                                   "spread"])
def test_wave_worlds_on_a_non_divisible_mesh(world):
    """Every carried feature of the wave body (reservation pre-passes,
    the claim view and its boundary, the prod term split, gang Permit
    retries, spread) on 3 shards: fused and chained rows equal the
    single-device steps'."""
    from test_torch_fused_waves import _args, _fc, _sides, _world_inputs

    fc, sides, b = _world_inputs(world)
    kw = dict(active_axes=b["active_axes"], prod=b["prod"],
              claims=b["claims"], res=b["res"])
    single = fw.build_fused_wave_step(
        _args(b["prod"]), b["num_gangs"], b["num_groups"], waves=4, **kw)(
            _fc(fc), _sides(sides))
    mesh = virtual_mesh(3, "cpu")
    sfc, ssides = shard_full_chain_inputs(fc, mesh), _shard_sides(sides,
                                                                  mesh)
    out = build_sharded_fused_wave_step(
        _args(b["prod"]), b["num_gangs"], b["num_groups"], 4, mesh, **kw)(
            sfc, ssides)
    for k in ("bind_pods", "bind_nodes", "bind_zones", "bind_res",
              "wave_counts"):
        np.testing.assert_array_equal(getattr(single, k).numpy(),
                                      _host(getattr(out, k)), err_msg=k)
    assert out.waves_run == single.waves_run
    cstep = fw.build_chained_wave_step(_args(b["prod"]), b["num_gangs"],
                                       b["num_groups"], **kw)
    sstep = build_sharded_chained_wave_step(
        _args(b["prod"]), b["num_gangs"], b["num_groups"], mesh, **kw)
    pfc, psides = _fc(fc), _sides(sides)
    carry = fw.initial_wave_carry(pfc, psides)
    scarry = initial_sharded_wave_carry(sfc, ssides, mesh)
    for _w in range(3):
        carry, rows = cstep(pfc, carry, psides)
        scarry, srows = sstep(sfc, scarry, ssides)
        for a, s in zip(rows, srows):
            np.testing.assert_array_equal(a.numpy(), _host(s))


# ---------------------------------------------------------------------------
# the mesh's own rules
# ---------------------------------------------------------------------------

def test_surviving_submesh_refactors_the_survivors():
    mesh = virtual_mesh(8, "cpu")
    sub = surviving_submesh(mesh, {6, 7})
    assert sub.devices.shape == (2, 3)
    assert [d.id for d in sub.devices.flat] == [0, 1, 2, 3, 4, 5]
    assert surviving_submesh(mesh, range(8)) is None


def test_two_processes_on_one_card_are_two_cards():
    """A card is a (process, device) pair: two processes on one card hold
    two cards, whose mesh exchanges (the card's own memory, two CUDA
    contexts), and card_shards groups by the pair; shards of ONE process
    on one card, or of the CPU, make a mesh that gathers."""
    two = make_mesh([MeshDevice(k, torch.device("cuda", 0), k // 2)
                     for k in range(4)])
    assert two.exchange and two.spans_processes
    assert two.card_keys == [(0, torch.device("cuda", 0)),
                             (1, torch.device("cuda", 0))]
    assert two.card_shards() == [(torch.device("cuda", 0), [0, 1]),
                                 (torch.device("cuda", 0), [2, 3])]
    # this process (rank 0) holds the first card only
    assert two.local_card_shards() == [(torch.device("cuda", 0), [0, 1])]
    assert two.cards == [torch.device("cuda", 0)]
    one = make_mesh([MeshDevice(k, torch.device("cuda", 0))
                     for k in range(3)])
    assert one.size == 3 and not one.exchange
    assert one.card_shards() == one.local_card_shards()
    assert not virtual_mesh(4, "cpu").exchange


def test_shards_on_two_cards_exchange():
    """Shards on two cards of one process make a mesh that exchanges (no
    card is touched to build it), each card holding its own shards."""
    mesh = make_mesh([MeshDevice(k, torch.device("cuda", k // 2))
                      for k in range(4)])
    assert mesh.size == 4 and mesh.exchange
    assert mesh.card_shards() == [(torch.device("cuda", 0), [0, 1]),
                                  (torch.device("cuda", 1), [2, 3])]


def test_virtual_devices_setting(monkeypatch):
    monkeypatch.delenv("KOORD_TORCH_VIRTUAL_DEVICES", raising=False)
    assert len(visible_devices("cpu")) == 1
    monkeypatch.setenv("KOORD_TORCH_VIRTUAL_DEVICES", "3")
    assert [d.id for d in visible_devices("cpu")] == [0, 1, 2]
    monkeypatch.setenv("KOORD_TORCH_VIRTUAL_DEVICES", "0")
    with pytest.raises(ValueError):
        visible_devices("cpu")


def test_sharded_tensors_hold_one_tensor_per_shard():
    """A node-axis array is D separate tensors, pad rows only in the
    trailing shard; a replicated one shares one copy per device."""
    mesh = virtual_mesh(3, "cpu")
    from koordinator_tpu_torch.parallel.mesh import NamedSharding, P

    arr = np.arange(10 * 2, dtype=np.float32).reshape(10, 2)
    st = put_on_mesh(arr, NamedSharding(mesh, P(("pods", "nodes"))))
    assert st.shape == (12, 2) and len(st.shards) == 3
    assert len({t.data_ptr() for t in st.shards}) == 3
    np.testing.assert_array_equal(st.shards[0].numpy(), arr[:4])
    np.testing.assert_array_equal(st.shards[2].numpy()[:2], arr[8:])
    assert not st.shards[2].numpy()[2:].any()
    rep = put_on_mesh(arr, NamedSharding(mesh, P()))
    assert rep.replicated and rep.shards[0] is rep.shards[2]
    assert st.index(1) == (slice(4, 8), slice(0, 2))


def test_parallelize_is_the_reference_utility():
    """utils/parallelize.py, a copy: tests/test_utils.py's cases on the
    port, beside the JAX package's."""
    from koordinator_tpu.utils.parallelize import parallel_map as ref_map

    from koordinator_tpu_torch.utils.parallelize import (
        parallel_map,
        parallelize_until,
    )

    for fn in (parallel_map, ref_map):
        assert fn(list(range(100)), lambda x: x * x) == [
            x * x for x in range(100)]

        def boom(x):
            raise RuntimeError("boom")

        with pytest.raises(RuntimeError):
            fn([1, 2, 3], boom)
    seen = []
    parallelize_until(5, seen.append, parallelism=1)
    assert seen == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("explain,prod,claims,res", [
    (None, False, False, False), ("full", True, True, True)])
def test_wave_shardings_follow_the_reference(cpu_devices, explain, prod,
                                             claims, res):
    """The chained carry's and the side inputs' layout: node-axis slots
    sharded flat, the rest replicated, feature-absent slots None — slot
    for slot the JAX package's out_shardings."""
    from koordinator_tpu.parallel import wave_carry_shardings as ref_carry

    from koordinator_tpu_torch.parallel import wave_carry_shardings

    def kind(sh):
        if sh is None:
            return None
        return "rep" if all(e is None for e in sh.spec) else "node"

    rm = ref_make_mesh(cpu_devices)
    mesh = virtual_mesh(8, "cpu")
    assert [kind(s) for s in wave_carry_shardings(
        mesh, explain, prod, claims, res)] == [
            kind(s) for s in ref_carry(rm, explain, prod, claims, res)]
    ref_sides = ref_side_shardings(rm, prod=prod, claims=claims, res=res)
    sides = wave_side_shardings(mesh, prod=prod, claims=claims, res=res)
    flat = jax.tree_util.tree_leaves(
        ref_sides, is_leaf=lambda x: hasattr(x, "spec"))
    mine = [x for x in jax.tree_util.tree_leaves(
        tuple(sides), is_leaf=lambda x: hasattr(x, "spec"))]
    assert [kind(s) for s in mine] == [kind(s) for s in flat]
