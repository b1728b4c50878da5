"""The exchange route's carried worlds on an exchanging CPU mesh.

A mesh of cards (``Mesh.exchange``) runs the one wave body of
models/fused_waves.py with parallel/full_chain_mesh.py's ``CardBackend``,
every node-axis array on its shard. These tests hold the three worlds
whose passes index node rows by a global node index, or rewrite every node
row at once, to the single-device steps and the JAX package's sharded
steps, tolerance 0, with the mesh's gathers made to raise:

  * reservation rows (the Succeeded fold and the nomination pre-pass),
  * hot-claim columns (the per-card [P, rows] volume view and the claim
    state's wave boundary),
  * device score transformers (pipeline_parity's parity transformer on
    each shard's view).

On the CPU the shards stand for cards: the route runs the plain sharded
pieces over each shard, so a mesh of 2 and of 3 shards (3 pads the node
axis) drives what the card route runs. The reservation and claim worlds
have 2 and 4 real nodes among 16 rows, so the step cases spread the real
nodes over the node axis, last first (``_spread``): every shard then holds
real nodes, and the reservations bind off the first shard. The
Scheduler-level case runs pipeline_parity's carried-state gate with the
fused world on a mesh of 2.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from koordinator_tpu.parallel import (
    build_sharded_fused_wave_step as ref_sharded_fused,
    make_mesh as ref_make_mesh,
    shard_full_chain_inputs as ref_shard_fc,
)
from koordinator_tpu.scheduler import pipeline_parity as ref_parity

from koordinator_tpu_torch.models import fused_waves as fw
from koordinator_tpu_torch.parallel import full_chain_mesh as fcm
from koordinator_tpu_torch.parallel.mesh import ShardedTensor
from koordinator_tpu_torch.scheduler import pipeline_parity
from koordinator_tpu_torch.testing import cross_card
from koordinator_tpu_torch.testing.mesh_round import exchanging_mesh

WORLDS = ("reservations", "claims", "transformer")
FIELDS = ("bind_pods", "bind_nodes", "bind_zones", "bind_res",
          "wave_counts")
# carry slots (fused_waves.WAVE_STATE_FIELDS) each world keeps on the
# node axis: requested, and the claim world's claim_new and vol_new
NODE_SLOTS = {"reservations": (1,), "claims": (1, 13, 14),
              "transformer": (1,)}


def _host(x):
    return np.asarray(x)


def _spread(fc, sides):
    """The world with its node axis permuted: real node i (of n) at row
    (n - 1 - i) * (N // n), the other rows after, in order."""
    from koordinator_tpu_torch.parallel.mesh import _SCHEDULE_POD_FIELDS

    N = fc.base.allocatable.shape[0]
    n = int(np.asarray(fc.base.node_ok).sum())
    step = N // n
    at = {(n - 1 - i) * step: i for i in range(n)}
    rest = iter(range(n, N))
    order = np.array([at[j] if j in at else next(rest) for j in range(N)])

    def perm(x):
        return None if x is None else np.asarray(x)[order]

    base = fc.base._replace(**{k: perm(v) for k, v in fc.base._asdict().items()
                               if k not in _SCHEDULE_POD_FIELDS})
    fc = fc._replace(base=base, **{k: perm(getattr(fc, k))
                                   for k in fcm._FC_NODE_FIELDS})
    sides = sides._replace(
        la_est=perm(sides.la_est), la_adj=perm(sides.la_adj),
        prod=(None if sides.prod is None else
              type(sides.prod)(*(perm(v) for v in sides.prod))),
        claims=(None if sides.claims is None else sides.claims._replace(
            covered0=perm(sides.claims.covered0))))
    return fc, sides


def _world(name):
    """(fc, sides, build kwargs, the port's score passes, the JAX
    package's) of a world, as numpy, its real nodes spread."""
    from test_torch_fused_waves import _world_inputs

    if name == "transformer":
        fc, sides, b = _world_inputs("synth")
        return (*_spread(fc, sides), b,
                (pipeline_parity._make_parity_transformer().device_pass,),
                (ref_parity._make_parity_transformer().device_pass,))
    fc, sides, b = _world_inputs(name)
    return (*_spread(fc, sides), b, (), ())


@pytest.fixture
def gathers_raise(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the exchange route gathered node rows")

    monkeypatch.setattr(fcm, "gather", refuse)
    monkeypatch.setattr(fcm, "gather_tree", refuse)


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("world", WORLDS)
def test_exchange_route_takes_the_carried_worlds(cpu_devices, gathers_raise,
                                                 world, depth):
    """The fused K = 4 step with explain "counts" and three chained waves
    on an exchanging mesh: every row, wave count and stage count equals
    the single-device step's; the carry's node-axis slots stay on their
    shards; at D = 2 the fused rows equal the JAX sharded fused step's."""
    from test_torch_fused_waves import _args, _fc, _ref_args, _ref_fc, _sides
    from test_torch_parallel import _ref_shard_sides, _shard_sides

    fc, sides, b, passes, ref_passes = _world(world)
    kw = dict(active_axes=b["active_axes"], prod=b["prod"],
              claims=b["claims"], res=b["res"], score_passes=passes)
    args = _args(b["prod"])
    n_real = fc.base.allocatable.shape[0]  # every row: the real ones spread
    pfc, psides = _fc(fc), _sides(sides)
    single, single_ex = fw.build_fused_wave_step(
        args, b["num_gangs"], b["num_groups"], waves=4, explain="counts",
        **kw)(pfc, psides, n_real)
    assert single.waves_run >= 2
    mesh = exchanging_mesh(depth, "cpu")
    sfc = fcm.shard_full_chain_inputs(fc, mesh)
    ssides = _shard_sides(sides, mesh)
    out, ex = fcm.build_sharded_fused_wave_step(
        args, b["num_gangs"], b["num_groups"], 4, mesh, explain="counts",
        **kw)(sfc, ssides, n_real)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(single, k).numpy(),
                                      _host(getattr(out, k)), err_msg=k)
    assert out.waves_run == single.waves_run
    np.testing.assert_array_equal(single_ex.stage_counts.numpy(),
                                  _host(ex.stage_counts))

    cstep = fw.build_chained_wave_step(args, b["num_gangs"],
                                       b["num_groups"], **kw)
    sstep = fcm.build_sharded_chained_wave_step(
        args, b["num_gangs"], b["num_groups"], mesh, **kw)
    carry = fw.initial_wave_carry(pfc, psides)
    scarry = fcm.initial_sharded_wave_carry(sfc, ssides, mesh)
    N = fc.base.allocatable.shape[0]
    for _w in range(3):
        carry, rows = cstep(pfc, carry, psides)
        scarry, srows = sstep(sfc, scarry, ssides)
        for a, s in zip(rows, srows):
            np.testing.assert_array_equal(a.numpy(), _host(s))
        for i in NODE_SLOTS[world]:
            assert isinstance(scarry[i], ShardedTensor), i
            assert not scarry[i].replicated and len(scarry[i].shards) == depth
            np.testing.assert_array_equal(carry[i].numpy(),
                                          _host(scarry[i])[:N], err_msg=i)
    if depth != 2:
        return
    rm = ref_make_mesh(cpu_devices[:depth])
    ref = ref_sharded_fused(
        _ref_args(b["prod"]), b["num_gangs"], b["num_groups"], 4, rm,
        active_axes=b["active_axes"], prod=b["prod"], claims=b["claims"],
        res=b["res"], score_passes=ref_passes)(
            ref_shard_fc(_ref_fc(fc), rm), _ref_shard_sides(sides, rm, b))
    for k in FIELDS:
        np.testing.assert_array_equal(_host(getattr(ref, k)),
                                      _host(getattr(out, k)), err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_carried_state_gate_on_an_exchanging_mesh(world):
    """pipeline_parity's carried-state gate with the fused world's
    Scheduler on an exchanging mesh of 2 (its serial twin on one device),
    no node row gathered: ok, multi-wave, no demotion."""
    with cross_card.no_gather():
        report = pipeline_parity.run_carried_state_parity(
            world, mesh=exchanging_mesh(2, "cpu"), device="cpu")
    assert report["ok"], report["mismatches"]
    assert report["fused_engaged"] >= 1 and report["mesh"] == 2


def test_a_score_pass_must_leave_the_cards_alike():
    """A pass that breaks the DeviceScoreTransformer contract (a pod-level
    field that depends on the card's rows) is caught on the CPU route."""
    from test_torch_fused_waves import _world_inputs
    from koordinator_tpu_torch.models.convert import to_device

    fc, _sides, _b = _world_inputs("synth")
    mesh = exchanging_mesh(2, "cpu")
    hfc = fcm.hybrid(fcm.shard_full_chain_inputs(fc, mesh))
    backend = fcm.CardBackend(mesh)

    def by_rows(inputs):
        base = inputs.base
        return inputs._replace(base=base._replace(
            weights=base.weights + base.allocatable.sum()))

    def halve(inputs):
        base = inputs.base
        return inputs._replace(base=base._replace(
            la_term_nonprod=base.la_term_nonprod * 0.5))

    with pytest.raises(ValueError, match="pod-level"):
        backend.score_passes(hfc, (by_rows,))
    got = backend.score_passes(hfc, (halve,))
    want = halve(to_device(fc, "cpu"))
    N = fc.base.allocatable.shape[0]
    np.testing.assert_array_equal(
        want.base.la_term_nonprod.numpy(),
        _host(got.base.la_term_nonprod)[:N])
    assert got.base.weights is hfc.base.weights
    assert isinstance(got.base.la_term_nonprod, ShardedTensor)
    assert torch.equal(got.base.la_term_nonprod.shards[1],
                       hfc.base.la_term_nonprod.shards[1] * 0.5)


def test_a_card_claim_view_routes_its_records_through_the_budget():
    """A card's launch over a hot-claim world carries its [P, rows]
    volume view in every pod record (VG = rows words): the shared-memory
    state where the layout fits the budget, device memory below it, and a
    loud refusal where the record ring alone outgrows a block."""
    from test_torch_fused_waves import _fc, _world_inputs
    from koordinator_tpu_torch.ops import full_chain_kernel as fck
    from koordinator_tpu_torch.ops.kernel_common import (
        SMEM_BUDGET_BYTES,
        KernelContractError,
    )

    fc, _sides, _b = _world_inputs("synth")
    fc = _fc(fc)
    P_, N = fc.base.fit_requests.shape[0], fc.base.allocatable.shape[0]

    def view(rows):
        return fc._replace(vol_needed=torch.zeros((P_, rows)))

    kind, _plan, smem = fck.state_for(view(N), (0, 1), shards=2,
                                      exchange=True)
    assert kind == "smem" and smem <= SMEM_BUDGET_BYTES
    kind, _plan, low = fck.state_for(view(N), (0, 1), smem_budget_bytes=0,
                                     shards=2, exchange=True)
    assert kind == "global" and low < smem
    stride = fck.record_layout(fc.base.fit_requests.shape[1],
                               fc.aff_dom.shape[1], fc.port_used.shape[1],
                               20000)["rec_stride"]
    with pytest.raises(KernelContractError, match=f"record of {stride} "):
        fck.state_for(view(20000), (0, 1), shards=2, exchange=True)
