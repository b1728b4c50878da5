"""The port's fused and chained wave steps against the JAX package's.

Every input is numpy, made from a seed (the packed synth cluster of
tests/test_fused_waves.py) or captured from a port Scheduler's dispatch on a
small world: the JAX test's spread-retry store, in which a pod rejected in
wave 1 binds in wave 2, and scheduler/pipeline_parity.py's reservation,
claim and prod-usage worlds. The same arrays go through the JAX step (jit
on the CPU) and the port's plain step (CPU tensors); tolerance 0
throughout: the compacted rows, the per-wave counts, ``waves_run`` and
every carried field after every wave must be equal. The device functions
the wave body uses (``numa_zone_for_node``, ``effective_vol_needed``,
``advance_claim_state``) and the plain kept-only replay are held against
their JAX counterparts, and the replay kernel's wrapper is checked on its
Python side (the card runs it in chip_smoke.py).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from koordinator_tpu.models import fused_waves as jfw
from koordinator_tpu.models.full_chain import FullChainInputs as RefFC
from koordinator_tpu.models.scheduler_model import ScheduleInputs as RefSI
from koordinator_tpu.ops import numa as ref_numa
from koordinator_tpu.ops import volumes as ref_volumes
from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs

from koordinator_tpu_torch.api.objects import (
    Node,
    ObjectMeta,
    Pod,
    PodGroup,
    PodSpec,
    TopologySpreadConstraint,
)
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_POD,
    KIND_POD_GROUP,
    ObjectStore,
)
from koordinator_tpu_torch.models import fused_waves as fw
from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import permit
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import numa, volumes
from koordinator_tpu_torch.ops.kernel_common import valid_first
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler import pipeline_parity
from koordinator_tpu_torch.scheduler.cycle import Scheduler

GIB = 1024 ** 3
NOW = 1_000_000.0
GANG_LABEL = "pod-group.scheduling.sigs.k8s.io"


# ---------------------------------------------------------------------------
# fixtures: numpy step inputs
# ---------------------------------------------------------------------------

def _synth_inputs():
    """The packed synth cluster of tests/test_fused_waves.py."""
    from koordinator_tpu_torch.scheduler.snapshot import (
        build_full_chain_inputs,
        reduce_to_active_axes,
    )
    from koordinator_tpu_torch.testing import synth_full_cluster

    _c, state = synth_full_cluster(24, 70, seed=11, num_quotas=3,
                                   num_gangs=4, topology_fraction=0.5,
                                   lsr_fraction=0.2)
    fc, _pods, nodes, _t, _g, ng, ngroups = build_full_chain_inputs(
        state, LoadAwareArgs())
    fc, active = reduce_to_active_axes(fc)
    idx = np.asarray(active)
    sides = {k: np.take(nodes.extras[k], idx, axis=-1)
             for k in ("la_est_nonprod", "la_adj_nonprod")}
    build = dict(num_gangs=ng, num_groups=ngroups, active_axes=active,
                 prod=False, claims=False, res=False)
    return fc, sides, build


def _spread_retry_store():
    """Two zones; gang member b1 (Permit always fails) holds n0 in wave 1
    and shadows p; kept pod c raises zone za's spread count, so wave 2
    pushes b1 to zone zb and p binds n0 (tests/test_fused_waves.py)."""
    store = ObjectStore()
    for name, zone in (("n0", "za"), ("n1", "zb")):
        store.add(KIND_NODE, Node(
            meta=ObjectMeta(name=name, namespace="", labels={"zone": zone}),
            allocatable=ResourceList.of(cpu=6000, memory=32 * GIB, pods=20)))
    store.add(KIND_POD_GROUP, PodGroup(
        meta=ObjectMeta(name="gb", namespace="default"), min_member=2))
    store.add(KIND_POD, Pod(
        meta=ObjectMeta(name="b1", uid="b1", creation_timestamp=NOW,
                        labels={GANG_LABEL: "gb", "app": "red"}),
        spec=PodSpec(priority=9000,
                     requests=ResourceList.of(cpu=3000, memory=GIB, pods=1),
                     topology_spread=[TopologySpreadConstraint(
                         max_skew=1, topology_key="zone",
                         selector={"app": "red"})])))
    store.add(KIND_POD, Pod(
        meta=ObjectMeta(name="b2", uid="b2", creation_timestamp=NOW,
                        labels={GANG_LABEL: "gb"}),
        spec=PodSpec(priority=9000,
                     requests=ResourceList.of(cpu=900_000, memory=GIB,
                                              pods=1))))
    store.add(KIND_POD, Pod(
        meta=ObjectMeta(name="c", uid="c", creation_timestamp=NOW + 1,
                        labels={"app": "red"}),
        spec=PodSpec(priority=5000, node_selector={"zone": "za"},
                     requests=ResourceList.of(cpu=1000, memory=GIB,
                                              pods=1))))
    store.add(KIND_POD, Pod(
        meta=ObjectMeta(name="p", uid="p", creation_timestamp=NOW + 2),
        spec=PodSpec(priority=1000, node_selector={"zone": "za"},
                     requests=ResourceList.of(cpu=3000, memory=GIB,
                                              pods=1))))
    return NOW, store


def _gang_retry_store():
    """The spread-retry store plus gang gm (min 2): m1 and m2 bind in wave
    1, m3 (like p, shadowed on n0 in wave 1) binds in wave 2, where its
    Permit passes only against the counter carried from wave 1."""
    now, store = _spread_retry_store()
    store.add(KIND_POD_GROUP, PodGroup(
        meta=ObjectMeta(name="gm", namespace="default"), min_member=2))
    for name, prio, cpu, zone in (("m1", 8000, 500, "zb"),
                                  ("m2", 8000, 500, "zb"),
                                  ("m3", 2000, 3000, "za")):
        store.add(KIND_POD, Pod(
            meta=ObjectMeta(name=name, uid=name, creation_timestamp=NOW + 3,
                            labels={GANG_LABEL: "gm"}),
            spec=PodSpec(priority=prio, node_selector={"zone": zone},
                         requests=ResourceList.of(cpu=cpu, memory=GIB,
                                                  pods=1))))
    return now, store


def _numpy(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_numpy(v) for v in x))
    return x.cpu().numpy()


@functools.lru_cache(maxsize=None)
def _world_inputs(world: str):
    """(fc, sides, build kwargs) of the first fused dispatch a port
    Scheduler (plain step, replay overlap off) makes on ``world``, as
    numpy."""
    if world == "synth":
        fc, sides, build = _synth_inputs()
        return fc, fw.plain_sides(sides["la_est_nonprod"],
                                  sides["la_adj_nonprod"]), build
    args = None
    if world == "spread":
        now, store = _spread_retry_store()
    elif world == "gang":
        now, store = _gang_retry_store()
    elif world == "prod":
        args = LoadAwareArgs(score_according_prod_usage=True)
        from koordinator_tpu_torch.testing import synth_full_cluster

        _c, state = synth_full_cluster(20, 60, seed=11, num_quotas=2,
                                       num_gangs=3, topology_fraction=0.5,
                                       lsr_fraction=0.2)
        now, store = state.now, pipeline_parity.build_store_from_state(state)
    else:
        now, store = {"reservations": pipeline_parity._reservation_world,
                      "claims": pipeline_parity._claims_world}[world]()
    seen = {}
    real_build = fw.build_fused_wave_step

    def spy_build(args_, num_gangs, num_groups, waves, **kw):
        seen["build"] = dict(num_gangs=num_gangs, num_groups=num_groups,
                             active_axes=kw["active_axes"], prod=kw["prod"],
                             claims=kw["claims"], res=kw["res"])
        step = real_build(args_, num_gangs, num_groups, waves, **kw)

        def spy_step(fc, sides):
            seen.setdefault("inputs", (_numpy(fc), _numpy(sides)))
            return step(fc, sides)

        return spy_step

    sched = Scheduler(store, args=args, waves=4, device="cpu",
                      replay_overlap=False)
    fw.build_fused_wave_step = spy_build
    try:
        res = sched.run_cycle(now=now)
    finally:
        fw.build_fused_wave_step = real_build
    assert res.waves > 1 and not res.demotions
    fc, sides = seen["inputs"]
    return fc, sides, seen["build"]


def _ref_args(prod: bool):
    return RefArgs(score_according_prod_usage=prod)


def _args(prod: bool):
    return LoadAwareArgs(score_according_prod_usage=prod)


def _ref_fc(fc):
    return RefFC(base=RefSI(*fc.base), **{k: v for k, v in
                                          fc._asdict().items()
                                          if k != "base"})


def _ref_sides(sides):
    return jfw.WaveSideInputs(
        la_est=sides.la_est, la_adj=sides.la_adj,
        prod=jfw.ProdSides(*sides.prod) if sides.prod is not None else None,
        claims=(jfw.ClaimSides(*sides.claims)
                if sides.claims is not None else None),
        res=jfw.ResSides(*sides.res) if sides.res is not None else None)


def _sides(sides):
    """numpy WaveSideInputs -> the port's, on the CPU."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    def conv(group):
        return None if group is None else type(group)(*(t(v) for v in group))

    return fw.WaveSideInputs(t(sides.la_est), t(sides.la_adj),
                             conv(sides.prod), conv(sides.claims),
                             conv(sides.res))


def _fc(fc):
    return to_device(fc, "cpu")


@functools.lru_cache(maxsize=None)
def _reference_fused(world: str, waves: int):
    fc, sides, b = _world_inputs(world)
    step = jfw.build_fused_wave_step(
        _ref_args(b["prod"]), b["num_gangs"], b["num_groups"], waves=waves,
        active_axes=b["active_axes"], prod=b["prod"], claims=b["claims"],
        res=b["res"])
    out = step(_ref_fc(fc), _ref_sides(sides))
    return {k: np.asarray(getattr(out, k)) for k in out._fields}


@functools.lru_cache(maxsize=None)
def _reference_chain(world: str, waves: int):
    """The JAX chained step dispatched ``waves`` times: each wave's rows
    and the carry after it, as numpy."""
    fc, sides, b = _world_inputs(world)
    step = jfw.build_chained_wave_step(
        _ref_args(b["prod"]), b["num_gangs"], b["num_groups"],
        active_axes=b["active_axes"], prod=b["prod"], claims=b["claims"],
        res=b["res"])
    rfc, rsides = _ref_fc(fc), _ref_sides(sides)
    carry = jfw.initial_wave_carry(rfc, rsides)
    out = []
    for _w in range(waves):
        carry, rows = step(rfc, carry, rsides)
        out.append(([None if c is None else np.asarray(c) for c in carry],
                    {k: np.asarray(getattr(rows, k)) for k in rows._fields}))
    return out


def _port_fused(world: str, waves: int):
    fc, sides, b = _world_inputs(world)
    step = fw.build_fused_wave_step(
        _args(b["prod"]), b["num_gangs"], b["num_groups"], waves=waves,
        active_axes=b["active_axes"], prod=b["prod"], claims=b["claims"],
        res=b["res"])
    return step(_fc(fc), _sides(sides))


def _assert_fused_equal(out, ref):
    for k in ("bind_pods", "bind_nodes", "bind_zones", "bind_res",
              "wave_counts"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), ref[k],
                                      err_msg=k)
    assert out.waves_run == int(ref["waves_run"])


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("waves", [1, 2, 8])
def test_fused_step_matches_reference(waves):
    out = _port_fused("synth", waves)
    _assert_fused_equal(out, _reference_fused("synth", waves))
    assert int(out.wave_counts[0]) > 0


@pytest.mark.parametrize("world", ["spread", "gang"])
@pytest.mark.parametrize("waves", [1, 4])
def test_fused_step_wave2_binds(waves, world):
    """The spread-retry worlds: the pod shadowed in wave 1 binds in wave
    2, so later waves commit work, not only the fixpoint; in the gang
    world it is a gang member whose Permit reads the carried counter."""
    out = _port_fused(world, waves)
    _assert_fused_equal(out, _reference_fused(world, waves))
    if waves > 1:
        assert int(out.wave_counts[1]) > 0


@pytest.mark.parametrize("world", ["spread", "gang", "reservations",
                                   "claims", "prod"])
def test_chained_step_matches_reference_carry(world):
    """The chained step, dispatched K times: every carried field after
    every wave equals the JAX chained step's, and the waves' rows
    concatenated equal the fused step's."""
    waves = 4
    fc, sides, b = _world_inputs(world)
    step = fw.build_chained_wave_step(
        _args(b["prod"]), b["num_gangs"], b["num_groups"],
        active_axes=b["active_axes"], prod=b["prod"], claims=b["claims"],
        res=b["res"])
    tfc, tsides = _fc(fc), _sides(sides)
    carry = fw.initial_wave_carry(tfc, tsides)
    rows_all = []
    for w, (ref_carry, ref_rows) in enumerate(_reference_chain(world,
                                                               waves)):
        carry, rows = step(tfc, carry, tsides)
        assert len(carry) == fw.NUM_WAVE_STATE
        for name, got, want in zip(fw.WAVE_STATE_FIELDS, carry, ref_carry):
            assert (got is None) == (want is None), (w, name)
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"wave {w} {name}")
        n = int(rows.count)
        assert n == int(ref_rows["count"]), w
        for k in ("bind_pods", "bind_nodes", "bind_zones", "bind_res"):
            np.testing.assert_array_equal(getattr(rows, k).numpy(),
                                          ref_rows[k], err_msg=f"{w} {k}")
        rows_all.append(torch.stack([r[:n] for r in rows[:4]]))
    fused = _port_fused(world, waves)
    chained = torch.cat(rows_all, dim=1)
    n = chained.shape[1]
    for k, key in enumerate(("bind_pods", "bind_nodes", "bind_zones",
                             "bind_res")):
        np.testing.assert_array_equal(getattr(fused, key)[:n].numpy(),
                                      chained[k].numpy())


@pytest.mark.parametrize("world", ["reservations", "claims", "prod"])
def test_carried_sides_match_reference(world):
    """Each optional side (reservation rows, hot claims, the prod term
    split) rides the fused step as the JAX step carries it."""
    fc, sides, b = _world_inputs(world)
    flag = {"reservations": "res", "claims": "claims", "prod": "prod"}[world]
    assert b[flag]
    out = _port_fused(world, 4)
    _assert_fused_equal(out, _reference_fused(world, 4))
    if world == "reservations":
        # a reservation bound in wave 1 is consumed in a later wave
        assert (out.bind_res >= 0).any()


def test_step_argument_checks():
    with pytest.raises(ValueError):
        fw.build_fused_wave_step(LoadAwareArgs(), 1, 1, waves=0)
    with pytest.raises(ValueError):
        fw.build_fused_wave_step(LoadAwareArgs(), 1, 1, waves=9)
    with pytest.raises(ValueError):
        fw.build_fused_wave_step(
            LoadAwareArgs(score_according_prod_usage=True), 1, 1, waves=2)
    with pytest.raises(ValueError):
        fw.build_chained_wave_step(LoadAwareArgs(), 1, 1, prod=True)
    # explain is ported: the steps build at every level and refuse an
    # unknown one
    fw.build_fused_wave_step(LoadAwareArgs(), 1, 1, waves=2,
                             explain="counts")
    fw.build_chained_wave_step(LoadAwareArgs(), 1, 1, explain="full")
    for build in (lambda: fw.build_fused_wave_step(
            LoadAwareArgs(), 1, 1, waves=2, explain="all"),
            lambda: fw.build_chained_wave_step(LoadAwareArgs(), 1, 1,
                                               explain="all")):
        with pytest.raises(ValueError, match="explain"):
            build()


# ---------------------------------------------------------------------------
# the wave body's device functions and the plain replay
# ---------------------------------------------------------------------------

def test_numa_zone_for_node_matches_reference():
    rng = np.random.default_rng(5)
    for _ in range(200):
        K, R = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        free = rng.integers(0, 6, (K, R)).astype(np.float32)
        req = rng.integers(0, 5, R).astype(np.float32)
        needs = bool(rng.integers(0, 2))
        policy = int(rng.integers(0, 4))
        want = int(ref_numa.numa_zone_for_node(req, np.bool_(needs), free,
                                               np.int32(policy)))
        got = numa.numa_zone_for_node(
            torch.from_numpy(req), torch.tensor(needs),
            torch.from_numpy(free), torch.tensor(policy, dtype=torch.int32))
        assert got.dtype == torch.int32 and int(got) == want


def _claim_arrays(seed):
    rng = np.random.default_rng(seed)
    P, N, NC, VG = 12, 7, 3, 4
    return dict(
        vol_needed=rng.integers(0, 4, (P, VG)).astype(np.float32),
        node_vol_group=rng.integers(0, VG, N).astype(np.int32),
        pod_claim=rng.integers(0, 2, (P, NC)).astype(np.float32),
        claim_new=rng.integers(0, 2, (N, NC)).astype(np.float32),
        pod_nonhot=rng.integers(0, 3, P).astype(np.float32),
        covered0=rng.integers(0, 2, (N, NC)).astype(np.float32),
        vol_new=rng.integers(0, 3, N).astype(np.float32),
        vol_free0=rng.integers(3, 9, N).astype(np.float32),
        chosen=rng.integers(-1, N, P).astype(np.int32),
        committed=rng.integers(0, 2, P).astype(bool))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_claim_functions_match_reference(seed):
    a = _claim_arrays(seed)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    want = np.asarray(ref_volumes.effective_vol_needed(
        a["vol_needed"], a["node_vol_group"], a["pod_claim"],
        a["claim_new"]))
    got = volumes.effective_vol_needed(t["vol_needed"], t["node_vol_group"],
                                       t["pod_claim"], t["claim_new"])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        volumes.host_effective_vol_needed(a["vol_needed"],
                                          a["node_vol_group"],
                                          a["pod_claim"], a["claim_new"]),
        want)
    committed = a["committed"] & (a["chosen"] >= 0)
    ref = ref_volumes.advance_claim_state(
        a["chosen"], committed, a["pod_claim"], a["pod_nonhot"],
        a["covered0"], a["claim_new"], a["vol_new"], a["vol_free0"])
    out = volumes.advance_claim_state(
        t["chosen"], torch.from_numpy(committed), t["pod_claim"],
        t["pod_nonhot"], t["covered0"], t["claim_new"], t["vol_new"],
        t["vol_free0"])
    for g, w in zip(out, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _wave1_parts(world):
    """Pass 1 and Permit of wave 1 in plain torch on ``world``'s inputs:
    (fc, sides, build, chosen, kept, wave-start state)."""
    fc, sides, b = _world_inputs(world)
    tfc, tsides = _fc(fc), _sides(sides)
    args = _args(b["prod"])
    from koordinator_tpu_torch.models.full_chain import (
        plain_round,
        resolve_balance_idx,
    )
    from koordinator_tpu_torch.models.scheduler_model import (
        resolve_weight_idx,
    )

    wi = resolve_weight_idx(args, b["active_axes"])
    bi = resolve_balance_idx(b["active_axes"])
    inputs = tfc.base
    N, R = inputs.requested.shape
    zero = torch.zeros((N, R))
    fc_w = tfc._replace(base=inputs._replace(
        la_term_nonprod=tsides.la_est + tsides.la_adj))
    chosen = plain_round(fc_w, wi, False, bi)[0]
    kept = permit(tfc, chosen, b["num_gangs"], b["num_groups"]) >= 0
    state0 = (inputs.requested, tsides.la_est, zero, tfc.numa_free,
              tfc.bind_free, tfc.quota_used, tfc.aff_count, tfc.anti_cover,
              tfc.aff_exists.to(torch.bool), tfc.port_used, tfc.vol_free)
    return tfc, tsides, chosen, kept, state0


@pytest.mark.parametrize("world", ["synth", "spread"])
def test_replay_kept_matches_reference_carry(world):
    """The plain kept-only replay from the wave-start state lands where
    the JAX wave body's pass 2 leaves the carry after wave 1."""
    tfc, tsides, chosen, kept, state0 = _wave1_parts(world)
    fc_carry, _nom = fw._carry_fc_variants(tfc, tsides)
    state, zones = fw.replay_kept(fc_carry, False, state0, chosen, kept)
    ref_carry, ref_rows = _reference_chain(world, 1)[0]
    names = ("requested", "est_sum", None, "numa_free", "bind_free",
             "quota_used", "aff_count", "anti_cover", "aff_exists",
             "port_used", "vol_free")
    for name, got in zip(names, state):
        if name is not None:
            want = ref_carry[fw.WAVE_STATE_FIELDS.index(name)]
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    n = int(ref_rows["count"])
    np.testing.assert_array_equal(
        zones[torch.from_numpy(np.array(ref_rows["bind_pods"][:n])).long()]
        .numpy(),
        ref_rows["bind_zones"][:n])
    assert (zones[~kept] == -1).all()


def test_plain_round_chosen_matches_reference_wave1():
    """Pass 1 skips inactive pods; after Permit its picks are wave 1's
    bindings in the JAX chained step."""
    _tfc, _tsides, chosen, kept, _state0 = _wave1_parts("synth")
    ref = _reference_chain("synth", 1)[0][1]
    n = int(ref["count"])
    picked = np.full(chosen.shape[0], -1, np.int32)
    picked[ref["bind_pods"][:n]] = ref["bind_nodes"][:n]
    np.testing.assert_array_equal(
        torch.where(kept, chosen, -1).numpy(), picked)


# ---------------------------------------------------------------------------
# the replay kernel's wrapper (Python side)
# ---------------------------------------------------------------------------

def test_replay_params_mirror_the_kernel():
    """The replay is a kernel of its own (csrc/replay_by_node.cu): the
    round's parameters lost its fields, and ReplayParams is mirrored field
    for field."""
    from test_torch_kernel import _struct_fields

    names = [f for f, _ in fck._Params._fields_]
    assert not {"zones", "dom_rows", "replay"} & set(names)
    assert names.index("aff_exists_out") == names.index("chosen") + 1
    assert _struct_fields(fck.REPLAY_SOURCE, "ReplayParams") == [
        f for f, _ in fck._ReplayParams._fields_]


def test_replay_refuses_cpu_tensors():
    tfc, tsides, chosen, kept, state0 = _wave1_parts("synth")
    fc_carry, _nom = fw._carry_fc_variants(tfc, tsides)
    before = fck.replay_launches
    with pytest.raises(ValueError, match="CUDA"):
        fck.full_chain_replay(fc_carry, chosen, kept, state0, False)
    assert fck.replay_launches == before


def test_replay_records_come_from_fc_carry():
    """The replay reads its pods from the carry form: reservation
    pseudo-pod rows commit the template's allocatable with no estimate,
    NUMA or affinity footprint; packed as the round packs its records, the
    kept pods come first, in queue order."""
    fc, sides, _b = _world_inputs("reservations")
    tfc, tsides = _fc(fc), _sides(sides)
    fc_carry, fc_nom = fw._carry_fc_variants(tfc, tsides)
    res = tsides.res
    rows = res.row_of.long()
    np.testing.assert_array_equal(fc_carry.base.fit_requests[rows].numpy(),
                                  res.alloc.numpy())
    assert (fc_carry.base.estimated[rows] == 0).all()
    assert not fc_carry.needs_numa[rows].any()
    assert (fc_nom.base.fit_requests == 0).all()
    _rnp, _rpr, gang_ok = fck.pod_independent_rows(fc_carry)
    P = tfc.base.fit_requests.shape[0]
    kept = torch.zeros(P, dtype=torch.bool)
    kept[rows] = True
    kept[0] = True
    records, n_kept = valid_first(fck.pack_records(fc_carry, gang_ok), kept)
    assert int(n_kept) == int(kept.sum())
    T, PT = tfc.aff_dom.shape[1], tfc.port_used.shape[1]
    R, VG = tfc.base.fit_requests.shape[1], tfc.vol_needed.shape[1]
    got = fck.unpack_records(records[:int(n_kept)], R, T, PT, VG)
    np.testing.assert_array_equal(got["pod"].numpy(),
                                  torch.nonzero(kept).flatten().numpy())
    np.testing.assert_array_equal(
        got["fit_requests"].numpy(),
        fc_carry.base.fit_requests[kept].numpy())
