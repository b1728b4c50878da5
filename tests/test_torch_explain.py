"""koordexplain in the port against the JAX package's, on the CPU.

The JAX package computes the attribution in XLA on the CPU (its explain
path pins the XLA serial step; no Pallas kernel runs); the port runs the
plain versions of its two kernels — models/full_chain.explain_stage_counts
for the CUDA stage-count pass and the plain round's terms for the
full-chain kernel's terms instance. Every input is numpy from a seed: the
JAX package's pack of synth_full_cluster(24, 70) and of its cross-feature
fixture (affinity, spread, ports, volumes, NUMA, gangs), carried to the
port with to_device, and the fused-wave worlds of
tests/test_torch_fused_waves.py.

Tolerances: stage counts are integers and must be equal. The terms rows
must equal the eager JAX step (jit=False) bit for bit and the jitted JAX
steps within 1 ulp, since XLA may rewrite a division (the score's floor
makes a rewrite visible only where it crosses an integer). Bindings,
requested and quota_used with explain on must equal explain off exactly,
and the JAX step within atol 1e-3 (tests/test_torch_full_chain.py's
tolerance). Rows of pods outside pod_valid are 0 in the port: its round
evaluates no such pod (the JAX package's rows there are read by no
caller).

The Scheduler: run_explain_parity (explain "counts" against the host
recompute, string for string) passes in both packages, serial, fused and
chained; the port's explain_record of every pod equals the JAX package's
(timestamps and decision ids left out); one fault plan with explain on
walks the same ladder transitions in both, through no-explain; flight
bundles validate in both packages' CLIs.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api import objects as ref_objects
from koordinator_tpu.api.resources import ResourceList as RefResourceList
from koordinator_tpu.client.store import ObjectStore as RefObjectStore
from koordinator_tpu.models import full_chain as jfc
from koordinator_tpu.models import fused_waves as jfw
from koordinator_tpu.obs.__main__ import main as ref_obs_main
from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs
from koordinator_tpu.scheduler import degrade as ref_degrade
from koordinator_tpu.scheduler import pipeline_parity as ref_pp
from koordinator_tpu.scheduler.cycle import Scheduler as RefScheduler
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
)
from koordinator_tpu.sim import faults as ref_faults
from koordinator_tpu.sim.harness import run_scenario as ref_run_scenario
from koordinator_tpu.sim.scenarios import SCENARIOS as REF_SCENARIOS
from koordinator_tpu.testing import synth_full_cluster as ref_synth
from test_torch_fused_waves import (
    _args,
    _fc,
    _ref_args,
    _ref_fc,
    _ref_sides,
    _sides,
    _world_inputs,
)
from test_torch_pack import mixed_fixture_state

from koordinator_tpu_torch.models import full_chain as port_fc
from koordinator_tpu_torch.models import fused_waves as fw
from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import (
    NUM_EXPLAIN_STAGES,
    build_best_full_chain_step,
    build_full_chain_step,
    cycle_start_state,
    explain_stage_counts,
)
from koordinator_tpu_torch.obs.__main__ import main as obs_main
from koordinator_tpu_torch.obs.flight import load_bundle
from koordinator_tpu_torch.ops import explain_kernel
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler import degrade
from koordinator_tpu_torch.scheduler import pipeline_parity as pp
from koordinator_tpu_torch.scheduler.cycle import Scheduler
from koordinator_tpu_torch.sim import SCENARIOS
from koordinator_tpu_torch.sim import faults as port_faults
from koordinator_tpu_torch.sim.harness import run_scenario
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    store_from_state,
)

WORLDS = ("synth", "mixed")


# ---------------------------------------------------------------------------
# the packed batch and the JAX references, cached per world
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _packed(world):
    """(numpy FullChainInputs, num_gangs, num_groups, n_real) from the JAX
    package's pack of the world."""
    if world == "synth":
        state = ref_synth(24, 70, seed=0)[1]
    else:
        state = mixed_fixture_state(101)
    fc, _pods, nodes, _t, _g, ng, ngroups = ref_build(state, RefArgs())
    fc = jax.tree_util.tree_map(np.asarray, fc)
    return fc, ng, ngroups, len(nodes.names)


def _jnp(fc):
    return jax.tree_util.tree_map(jnp.asarray, fc)


@functools.lru_cache(maxsize=None)
def _ref_step(world, explain, jit):
    fc, ng, ngroups, n_real = _packed(world)
    step = jfc.build_full_chain_step(RefArgs(), ng, ngroups, jit=jit,
                                     explain=explain)
    out = step(_jnp(fc), np.int32(n_real)) if explain else step(_jnp(fc))
    out = [np.asarray(x) for x in out[:3]] + (
        [(np.asarray(out[3].stage_counts),
          None if out[3].terms is None else np.asarray(out[3].terms))]
        if explain else [])
    return out


def _perturbed_state(fc):
    """A frozen state other than the cycle start: more requested, fewer
    NUMA and bindable cpus and volumes, more affinity counts and covers,
    used ports and quota, every exists flag latched."""
    rng = np.random.default_rng(7)
    req = np.asarray(fc.base.requested)
    N, R = req.shape
    T = fc.aff_dom.shape[1]
    PT = fc.port_used.shape[1]
    dom = np.asarray(fc.aff_dom) >= 0
    return (
        (req + rng.integers(0, 3, (N, R)) * 500).astype(np.float32),
        (np.asarray(fc.numa_free)
         * rng.integers(0, 2, fc.numa_free.shape)).astype(np.float32),
        (np.asarray(fc.bind_free) - rng.integers(0, 3, N)).astype(
            np.float32),
        np.asarray(fc.quota_runtime, np.float32).copy(),
        (np.asarray(fc.aff_count) + dom * rng.integers(0, 2, (N, T))
         ).astype(np.float32),
        (np.asarray(fc.anti_cover) + dom * rng.integers(0, 2, (N, T))
         ).astype(np.float32),
        np.ones(T, bool),
        np.maximum(np.asarray(fc.port_used),
                   rng.integers(0, 2, (N, PT))).astype(np.float32),
        np.minimum(np.asarray(fc.vol_free),
                   rng.integers(0, 2, N)).astype(np.float32),
    )


def _ref_counts(fc, state, n_real):
    jfc_in = _jnp(fc)
    widx = jfc.resolve_weight_idx(RefArgs(), None)
    evaluate = jfc.make_pod_evaluator(jfc_in, widx, False,
                                      jfc.resolve_balance_idx(None))
    out = jax.jit(lambda st, nr: jfc.explain_stage_counts(
        jfc_in, evaluate, st, nr))(tuple(jnp.asarray(a) for a in state),
                                   np.int32(n_real))
    return np.asarray(out)


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("state_kind", ["cycle-start", "perturbed"])
def test_stage_counts_match_reference(world, state_kind, monkeypatch):
    """explain_stage_counts, the CUDA pass's plain version, equals the
    JAX function exactly over the real nodes and over a cut below them,
    in one pod chunk and in chunks of 7 pods."""
    fc, _ng, _ngroups, n_real = _packed(world)
    pfc = to_device(fc, "cpu")
    if state_kind == "cycle-start":
        state = tuple(np.asarray(t) for t in cycle_start_state(pfc))
    else:
        state = _perturbed_state(fc)
    tstate = tuple(torch.from_numpy(np.ascontiguousarray(a))
                   for a in state)
    for nr in (n_real, n_real - 3):
        want = _ref_counts(fc, state, nr)
        got = explain_stage_counts(pfc, tstate, nr)
        assert got.dtype == torch.uint32
        assert tuple(got.shape) == (fc.base.fit_requests.shape[0],
                                    NUM_EXPLAIN_STAGES)
        np.testing.assert_array_equal(got.numpy(), want)
        # the wrapper takes the plain version for CPU tensors; chunking
        # over the pods changes nothing
        np.testing.assert_array_equal(
            explain_kernel.explain_counts(pfc, tstate, nr).numpy(), want)
        with monkeypatch.context() as m:
            m.setattr(port_fc, "_count_chunk", lambda *_a: 7)
            np.testing.assert_array_equal(
                explain_stage_counts(pfc, tstate, nr).numpy(), want)
    assert _ref_counts(fc, state, n_real).sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_stage_counts_match_host_oracle(world):
    """The diagnose module's host-numpy oracle (host_stage_counts, the
    explain-off path's counts) gives the plain counts row for row at the
    cycle-start state: the formatter reads the same numbers either way."""
    from koordinator_tpu_torch.scheduler.diagnose import (
        host_stage_counts,
        shared_state,
    )

    fc, _ng, _ngroups, n_real = _packed(world)
    pfc = to_device(fc, "cpu")
    got = explain_stage_counts(pfc, cycle_start_state(pfc), n_real).numpy()
    shared = shared_state(fc, n_real)
    want = np.stack([host_stage_counts(fc, i, n_real, shared=shared)
                     for i in range(got.shape[0])])
    np.testing.assert_array_equal(got, want)


def test_mixed_world_exercises_every_stage():
    """The cross-feature fixture at the perturbed state, with two nodes
    cordoned: every stage and both verdicts reject somewhere, and the
    port's counts equal the JAX package's."""
    fc, _ng, _ngroups, n_real = _packed("mixed")
    node_ok = np.asarray(fc.base.node_ok).copy()
    node_ok[[1, 4]] = False
    fc = fc._replace(base=fc.base._replace(node_ok=node_ok))
    state = _perturbed_state(fc)
    counts = _ref_counts(fc, state, n_real)
    assert (counts > 0).any(axis=0).all(), (counts > 0).any(axis=0)
    got = explain_stage_counts(
        to_device(fc, "cpu"),
        tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in state),
        n_real)
    np.testing.assert_array_equal(got.numpy(), counts)


# ---------------------------------------------------------------------------
# the serial step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("explain", ["counts", "full"])
def test_serial_step_matches_reference(world, explain):
    fc, ng, ngroups, n_real = _packed(world)
    pfc = to_device(fc, "cpu")
    off = build_full_chain_step(LoadAwareArgs(), ng, ngroups)(pfc)
    step = build_full_chain_step(LoadAwareArgs(), ng, ngroups,
                                 explain=explain)
    out = step(pfc, n_real)
    # attribution adds outputs only
    for a, b in zip(out[:3], off):
        assert torch.equal(a, b)
    ref = _ref_step(world, explain, True)
    np.testing.assert_array_equal(out[0].numpy(), ref[0])
    np.testing.assert_allclose(out[1].numpy(), ref[1], atol=1e-3)
    np.testing.assert_allclose(out[2].numpy(), ref[2], atol=1e-3)
    counts, terms = ref[3]
    np.testing.assert_array_equal(out[3].stage_counts.numpy(), counts)
    if explain == "counts":
        assert out[3].terms is None
        return
    valid = np.asarray(fc.base.pod_valid)
    got = out[3].terms.numpy()
    assert (got[~valid] == 0).all()
    eager = _ref_step(world, explain, False)[3][1]
    np.testing.assert_array_equal(got[valid].view(np.int32),
                                  eager[valid].view(np.int32))
    np.testing.assert_array_max_ulp(got[valid], terms[valid], maxulp=1)
    # the runner-up is a score or the -1 floor; bound pods have a margin
    assert (got[valid, 4] >= -1).all() and (got[valid, 3] >= -1).all()
    bound = out[0].numpy() >= 0
    assert (got[bound, 3] >= got[bound, 4]).all()


def test_selector_runs_the_plain_step_on_cpu_tensors():
    fc, ng, ngroups, n_real = _packed("mixed")
    pfc = to_device(fc, "cpu")
    step = build_best_full_chain_step(LoadAwareArgs(), ng, ngroups,
                                      explain="full")
    out = step(pfc, n_real)
    assert step.last_backend == "serial"
    plain = build_full_chain_step(LoadAwareArgs(), ng, ngroups,
                                  explain="full")(pfc, n_real)
    for a, b in zip(out[:3], plain[:3]):
        assert torch.equal(a, b)
    assert torch.equal(out[3].stage_counts, plain[3].stage_counts)
    assert torch.equal(out[3].terms, plain[3].terms)


# ---------------------------------------------------------------------------
# the wave steps
# ---------------------------------------------------------------------------

def _n_real(fc):
    return max(1, fc.base.allocatable.shape[0] - 1)


@functools.lru_cache(maxsize=None)
def _reference_fused_explain(world, waves, explain):
    fc, sides, b = _world_inputs(world)
    step = jfw.build_fused_wave_step(
        _ref_args(b["prod"]), b["num_gangs"], b["num_groups"], waves=waves,
        active_axes=b["active_axes"], explain=explain, prod=b["prod"],
        claims=b["claims"], res=b["res"])
    out, ex = step(_ref_fc(fc), _ref_sides(sides), np.int32(_n_real(fc)))
    return ({k: np.asarray(getattr(out, k)) for k in out._fields},
            np.asarray(ex.stage_counts),
            None if ex.terms is None else np.asarray(ex.terms))


@pytest.mark.parametrize("world", ["synth", "gang", "reservations"])
@pytest.mark.parametrize("waves", [2, 4])
@pytest.mark.parametrize("explain", ["counts", "full"])
def test_fused_step_attribution_matches_reference(world, waves, explain):
    fc, sides, b = _world_inputs(world)
    step = fw.build_fused_wave_step(
        _args(b["prod"]), b["num_gangs"], b["num_groups"], waves=waves,
        active_axes=b["active_axes"], explain=explain, prod=b["prod"],
        claims=b["claims"], res=b["res"])
    out, ex = step(_fc(fc), _sides(sides), _n_real(fc))
    ref, ref_counts, ref_terms = _reference_fused_explain(world, waves,
                                                          explain)
    for k in ("bind_pods", "bind_nodes", "bind_zones", "bind_res",
              "wave_counts"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), ref[k])
    assert out.waves_run == int(ref["waves_run"])
    assert ex.stage_counts.shape == (waves, *ref_counts.shape[1:])
    np.testing.assert_array_equal(ex.stage_counts.numpy(), ref_counts)
    if explain == "counts":
        assert ex.terms is None
        return
    np.testing.assert_array_max_ulp(ex.terms.numpy(), ref_terms, maxulp=1)
    kept = out.bind_pods.numpy()
    kept = kept[kept >= 0]
    assert kept.size and (ex.terms.numpy()[kept, 3] >= 0).all()


@pytest.mark.parametrize("world", ["spread", "gang", "claims", "prod"])
def test_chained_step_attribution_matches_reference_carry(world):
    """The chained step at explain "full", four waves: each wave's counts
    row, every carried field and the carried terms rows equal the JAX
    chained step's after every wave."""
    waves = 4
    fc, sides, b = _world_inputs(world)
    kw = dict(active_axes=b["active_axes"], explain="full", prod=b["prod"],
              claims=b["claims"], res=b["res"])
    ref_step = jfw.build_chained_wave_step(
        _ref_args(b["prod"]), b["num_gangs"], b["num_groups"], **kw)
    step = fw.build_chained_wave_step(
        _args(b["prod"]), b["num_gangs"], b["num_groups"], **kw)
    rfc, rsides = _ref_fc(fc), _ref_sides(sides)
    tfc, tsides = _fc(fc), _sides(sides)
    n_real = _n_real(fc)
    ref_carry = jfw.initial_wave_carry(rfc, rsides, explain="full")
    carry = fw.initial_wave_carry(tfc, tsides, explain="full")
    assert len(carry) == fw.NUM_WAVE_STATE + 1
    for w in range(waves):
        ref_carry, ref_rows, ref_row = ref_step(rfc, ref_carry, rsides,
                                                np.int32(n_real))
        carry, rows, row = step(tfc, carry, tsides, n_real)
        np.testing.assert_array_equal(row.numpy(), np.asarray(ref_row),
                                      err_msg=f"wave {w} counts")
        for name, got, want in zip(fw.WAVE_STATE_FIELDS, carry, ref_carry):
            assert (got is None) == (want is None), (w, name)
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"wave {w} {name}")
        np.testing.assert_array_max_ulp(carry[-1].numpy(),
                                        np.asarray(ref_carry[-1]),
                                        maxulp=1)
        assert int(rows.count) == int(ref_rows.count)


# ---------------------------------------------------------------------------
# the Scheduler
# ---------------------------------------------------------------------------

# (waves, replay_overlap): serial dispatch, the single-call fused dispatch
# and the chained dispatch
DISPATCHES = {"serial": (1, None), "fused": (4, False), "chained": (4, True)}


@pytest.mark.parametrize("dispatch", sorted(DISPATCHES))
def test_explain_parity_in_both_packages(dispatch):
    """Explain "counts" against the host recompute: bindings, failure
    lists and every PodScheduled message equal, string for string."""
    waves, overlap = DISPATCHES[dispatch]
    scheds = []
    report = pp.run_explain_parity(waves=waves, replay_overlap=overlap,
                                   device="cpu", schedulers=scheds)
    assert report["ok"], report["mismatches"]
    legacy, explained = scheds
    # the messages came from the formatter: an unschedulable pod has its
    # stage counts in the /explain index
    unsched = [k for k, r in explained.explain_index.items()
               if r["verdict"] == "unschedulable" and "stages" in r]
    assert unsched
    assert not legacy.explain_index
    if dispatch != "fused":
        # the JAX harness takes the wave depth only (its dispatch shape
        # follows KOORD_TPU_REPLAY_OVERLAP, chained by default)
        ref = ref_pp.run_explain_parity(waves=waves)
        assert ref["ok"] and ref["conditions_checked"] == report[
            "conditions_checked"]


def _records(sched) -> dict:
    out = {}
    for key in list(sched.explain_index):
        rec = sched.explain_record(key)
        rec.pop("ts", None)
        rec.pop("decision_id", None)
        out[key] = rec
    return out


def _drive_records(scheduler_cls, build_store, add, waves, overlap,
                   explain, synth, **kw):
    """Cycle 0 and three churn cycles on synth_full_cluster(24, 120): the
    /explain records after every cycle."""
    _c, state = synth(24, 120, seed=11, num_quotas=3, num_gangs=4,
                      topology_fraction=0.5, lsr_fraction=0.2)
    store = build_store(state)
    sched = scheduler_cls(store, waves=waves, replay_overlap=overlap,
                          explain=explain, **kw)
    out = []
    for c in range(4):
        if c:
            add(store, arrival_specs(c, 30), state.now + 2 * c - 1)
        sched.run_cycle(now=state.now + 2 * c)
        out.append(_records(sched))
    return out


def _ref_add(store, specs, created):
    add_arrivals(store, specs, created, objects=ref_objects,
                 resource_list=RefResourceList)


@functools.lru_cache(maxsize=None)
def _ref_records(dispatch, explain):
    waves, overlap = DISPATCHES[dispatch]
    return _drive_records(
        RefScheduler, lambda st: store_from_state(st, RefObjectStore()),
        _ref_add, waves, overlap, explain, ref_synth, mesh="off",
        warmup="off")


@pytest.mark.parametrize("dispatch", sorted(DISPATCHES))
@pytest.mark.parametrize("explain", ["counts", "full"])
def test_explain_records_match_reference(dispatch, explain):
    from koordinator_tpu_torch.testing import synth_full_cluster

    waves, overlap = DISPATCHES[dispatch]
    got = _drive_records(Scheduler, store_from_state, add_arrivals, waves,
                         overlap, explain, synth_full_cluster, device="cpu")
    want = _ref_records(dispatch, explain)
    for c, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b), c
        for key in a:
            ra, rb = dict(a[key]), dict(b[key])
            ta, tb = ra.pop("terms", None), rb.pop("terms", None)
            ma, mb = ra.pop("margin", None), rb.pop("margin", None)
            assert ra == rb, (c, key)
            assert (ta is None) == (tb is None), (c, key)
            if ta is not None:
                assert set(ta) == set(tb)
                np.testing.assert_array_max_ulp(
                    np.float32([ta[k] for k in sorted(ta)]),
                    np.float32([tb[k] for k in sorted(tb)]), maxulp=1)
                assert abs(ma - mb) <= 1e-3
    verdicts = {r["verdict"] for r in got[-1].values()}
    assert verdicts == {"bound", "unschedulable"}
    if explain == "full":
        assert any("terms" in r for r in got[-1].values())


def test_fault_plan_walks_through_no_explain_in_both_packages():
    """One fault plan with explain on, fused waves: the storm demotes the
    fused window to serial waves, the serial pass to no-explain (where
    the dispatch binds without attribution, diagnosed by the host
    recompute), and clean cycles promote back; the JAX package walks the
    same transitions with the same bindings."""
    from test_torch_degrade import _drive, _plan, _retries  # noqa: F401
    from koordinator_tpu.scheduler import metrics as ref_metrics
    from koordinator_tpu_torch.scheduler import metrics as port_metrics
    from koordinator_tpu_torch.testing import synth_full_cluster

    faults = (("dispatch", 1, dict(count=4)),)
    kwargs = dict(waves=2, explain="counts")
    _c, rstate = ref_synth(12, 60, seed=5, num_quotas=8, num_gangs=4)
    rstore = store_from_state(rstate, RefObjectStore())
    ref = RefScheduler(rstore, mesh="off", warmup="off",
                       dispatch_deadline_ms=300,
                       ladder=ref_degrade.DegradationLadder(promote_after=2),
                       **kwargs)
    want = _drive(ref, rstore, rstate, _plan(ref_faults, faults),
                  ref_metrics, _ref_add)
    _c, state = synth_full_cluster(12, 60, seed=5, num_quotas=8,
                                   num_gangs=4)
    store = store_from_state(state)
    sched = Scheduler(store, device="cpu", dispatch_deadline_ms=300,
                      ladder=degrade.DegradationLadder(promote_after=2),
                      **kwargs)
    got = _drive(sched, store, state, _plan(port_faults, faults),
                 port_metrics, add_arrivals)
    for c, (a, b) in enumerate(zip(got[0], want[0])):
        assert a == b, f"cycle {c}"
    assert got[1] == want[1] and got[2] == want[2]
    walk = [(t["from"], t["to"]) for t in got[1]]
    assert ("serial-waves", "no-explain") in walk
    assert walk[-1][1] == "full" and sched.ladder.level == 0
    assert sched.ladder.level_name == "full"


def test_flight_bundle_validates_in_both_clis(tmp_path, capsys):
    scheds = []
    pp.run_explain_parity(waves=4, device="cpu", rounds=2,
                          explain="full", schedulers=scheds)
    bundle = scheds[1].flight.dump("test")
    header, records, errors = load_bundle(io.StringIO(bundle))
    assert errors == [] and records
    assert any(b.get("terms") for r in records for b in r["bound"])
    assert any(f.get("message") for r in records for f in r["failed"]
               + r["rejected"])
    path = tmp_path / "bundle.jsonl"
    path.write_text(bundle)
    key = next(f["pod"] for r in records for f in r["failed"] + r["rejected"]
               if f.get("stages"))
    for cli in (obs_main, ref_obs_main):
        assert cli(["flight", str(path)]) == 0
        assert cli(["explain", str(path), key]) == 0
        assert cli(["explain", str(path), "default/no-such-pod"]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the sim
# ---------------------------------------------------------------------------

def _explain_ladder(cat):
    """fault-ladder without its mesh (and the mesh's device-loss fault)
    and without its latency fault and deadline, whose timing a loaded
    test host could move: explain "counts" with fused waves and the
    fault storm at cycle 34, cut to 48 cycles."""
    sc = cat["fault-ladder"]
    return dataclasses.replace(
        sc, mesh=None, dispatch_deadline_ms=None, cycles=48, restart_at=(),
        faults=tuple(f for f in sc.faults if f.kind == "dispatch"))


def test_explain_scenario_matches_reference():
    got = run_scenario(_explain_ladder(SCENARIOS), device="cpu")
    want = ref_run_scenario(_explain_ladder(REF_SCENARIOS))
    assert got.binding_log_sha256 == want.binding_log_sha256
    assert got.ladder_transitions == want.ladder_transitions
    assert got.cycles_at_level == want.cycles_at_level
    assert got.invariant_breaches == [] and got.cycle_exceptions == []
    assert got.cycles_at_level.get("no-explain", 0) > 0
    json.dumps(got.to_dict())


@pytest.mark.parametrize("waves,overlap", [
    (1, True), ("auto", True), ("auto", False)],
    ids=["serial", "chained", "single-call"])
def test_failing_explain_pass_propagates(monkeypatch, waves, overlap):
    """A stage-count pass that raises anything but a device fault (here
    the launch error of a broken kernel) leaves the cycle with the ladder
    at full: it is never demoted away to the no-explain rung."""
    from test_torch_degrade import _assert_ladder_untouched, _retries
    from koordinator_tpu_torch.client.store import KIND_POD
    from koordinator_tpu_torch.ops.kernel_common import (
        KernelContractError,
        launch_error,
    )
    from koordinator_tpu_torch.scheduler import metrics as port_metrics
    from koordinator_tpu_torch.testing.churn import churn_store

    def broken(*_a, **_kw):
        raise launch_error("explain_counts", 700,
                           "an illegal memory access was encountered")

    # the serial plain step reads the plain counts, the wave body goes
    # through the wrapper: break both
    monkeypatch.setattr(port_fc, "explain_stage_counts", broken)
    monkeypatch.setattr(explain_kernel, "explain_counts", broken)
    store, state = churn_store(16, 300, seed=1)
    sched = Scheduler(store, waves=waves, replay_overlap=overlap,
                      device="cpu", explain="counts")
    before = _retries(port_metrics)
    assigned = sum(p.is_assigned for p in store.list(KIND_POD))
    with pytest.raises(KernelContractError, match="cudaError 700"):
        sched.run_cycle(now=state.now)
    _assert_ladder_untouched(sched, before)
    assert sum(p.is_assigned for p in store.list(KIND_POD)) == assigned
