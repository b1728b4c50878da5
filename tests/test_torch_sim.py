"""The port's churn simulator against the JAX package's, on the CPU.

Each catalog scenario the port runs — smoke, gang-storm and spot-churn
(cut to 40 cycles), crash-restart, drain-storm and hotspot with their
co-located descheduler (cut to 55), and overcommit-shift with its
co-located koord-manager (cut to 55: its first prod-usage surge fires at
cycle 40 and lasts 12) — goes through both packages' sims once per test
process (cached), and the reports must agree: the
binding log's SHA-256, the ladder's residency per level and its
transitions, zero invariant breaches and zero cycle exceptions on both
sides, and the SLO report. The scenarios that need a later slice raise
NotImplementedError naming it, and so do the fault kinds the port cannot
model yet. The CLI is driven in-process at ``--device cpu``.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import pytest

from koordinator_tpu.sim.harness import run_scenario as ref_run
from koordinator_tpu.sim.scenarios import SCENARIOS as REF_SCENARIOS

from koordinator_tpu_torch.sim import (
    SCENARIOS,
    ChurnSimulator,
    Fault,
    FaultPlan,
    InjectedFault,
    Scenario,
    check_invariants,
)
from koordinator_tpu_torch.sim.__main__ import main as sim_main
from koordinator_tpu_torch.sim.harness import run_scenario

# the scenarios the port runs, at the cycle counts the tests afford
# (drain-storm and hotspot at 55, as the JAX package's tests/test_sim.py
# cuts them: hotspot's first event fires at cycle 40; overcommit-shift at
# 55 too: its first surge fires at cycle 40 and lasts 12)
RUN = {"smoke": 35, "gang-storm": 40, "spot-churn": 40, "crash-restart": 22,
       "drain-storm": 55, "hotspot": 55, "overcommit-shift": 55}
# the scenarios that need a later slice, and the slice each names
LEFT_OUT = {"soak": "transport", "fault-ladder": "parallel/"}
# report keys that hold wall-clock or per-process numbers
WALL_KEYS = ("wall_seconds", "pipeline", "restart")


@functools.lru_cache(maxsize=None)
def _reference(name):
    return ref_run(dataclasses.replace(REF_SCENARIOS[name],
                                       cycles=RUN[name]))


@functools.lru_cache(maxsize=None)
def _port(name):
    return run_scenario(dataclasses.replace(SCENARIOS[name],
                                            cycles=RUN[name]), device="cpu")


def _comparable(report) -> dict:
    return {k: v for k, v in report.to_dict().items() if k not in WALL_KEYS}


def test_catalog_is_the_reference_catalog():
    assert list(SCENARIOS) == list(REF_SCENARIOS)
    for name, sc in SCENARIOS.items():
        # asdict turns the Fault entries into dicts too
        assert dataclasses.asdict(sc) == dataclasses.asdict(
            REF_SCENARIOS[name]), name


@pytest.mark.parametrize("name", sorted(RUN))
def test_binding_log_matches_reference(name):
    port, ref = _port(name), _reference(name)
    assert port.binding_log == ref.binding_log
    assert port.binding_log_sha256 == ref.binding_log_sha256
    assert port.pods_bound > 0


@pytest.mark.parametrize("name", sorted(RUN))
def test_ladder_residency_matches_reference(name):
    port, ref = _port(name), _reference(name)
    assert port.cycles_at_level == ref.cycles_at_level
    assert port.ladder_transitions == ref.ladder_transitions
    assert port.final_level == ref.final_level == "full"


@pytest.mark.parametrize("name", sorted(RUN))
def test_zero_breaches_on_both_sides(name):
    for report in (_port(name), _reference(name)):
        assert report.invariant_breaches == []
        assert report.cycle_exceptions == []


@pytest.mark.parametrize("name", sorted(RUN))
def test_slo_report_matches_reference(name):
    port, ref = _comparable(_port(name)), _comparable(_reference(name))
    assert port["slo"] == ref["slo"]
    assert port["slos"] == ref["slos"]
    assert port == ref


def test_smoke_walks_the_ladder_and_back():
    """smoke's cycle-20 fault burst: waves=1, so the ladder goes straight
    from full to the host fallback, and promotes back after 6 clean
    cycles; pods keep binding throughout."""
    report = _port("smoke")
    assert [(t["from"], t["to"]) for t in report.ladder_transitions] == [
        ("full", "host-fallback"), ("host-fallback", "full")]
    assert report.cycles_at_level == {"full": 29, "host-fallback": 6}
    assert report.faults_injected == 3


def test_crash_restart_rebinds_within_its_slo():
    report = _port("crash-restart")
    assert report.restarts == 1
    assert len(report.restart_to_first_bind_seconds) == 1
    assert report.to_dict()["restart"]["met"]
    assert report.warmup == {}


@pytest.mark.parametrize("name", sorted(LEFT_OUT))
def test_left_out_scenarios_name_their_slice(name):
    with pytest.raises(NotImplementedError, match=LEFT_OUT[name]):
        ChurnSimulator(SCENARIOS[name], device="cpu")


@pytest.mark.parametrize("kind,match", [
    ("sidecar", "transport"), ("device_loss", "parallel/")])
def test_left_out_faults_name_their_slice(kind, match):
    """A sidecar fault is refused when the simulator is built; a device
    loss (which a scenario without a mesh may still carry) when it fires.
    Either way FaultPlan raises the moment such a fault is armed."""
    fault = Fault(cycle=1, kind=kind, devices=(1,) if kind == "device_loss"
                  else ())
    sc = Scenario(name="mini", seed=23, cycles=3, nodes=4, arrival_rate=2.0,
                  faults=(fault,))
    if kind == "sidecar":
        with pytest.raises(NotImplementedError, match=match):
            ChurnSimulator(sc, device="cpu")
        plan = FaultPlan([fault])
        plan.begin_cycle(0)
        assert not plan.sidecar_armed()
        plan.begin_cycle(1)
        with pytest.raises(NotImplementedError, match=match):
            plan.sidecar_armed()
        return
    sim = ChurnSimulator(sc, device="cpu")
    sim._run_one_cycle(0)
    with pytest.raises(NotImplementedError, match=match):
        sim._run_one_cycle(1)


@pytest.mark.parametrize("name", ["drain-storm", "hotspot"])
def test_descheduler_scenarios_rebalance_through_the_device_pass(name):
    """The co-located descheduler's rebalance passes all ran on the
    device engine (the CPU tensors here), and the migration closed loop
    (job -> reservation -> next dispatch -> evict) did work."""
    report = _port(name)
    assert report.descheduler_runs > 0
    assert report.rebalance_passes["device"] == report.descheduler_runs
    assert report.rebalance_passes["host"] == 0
    assert report.rebalance_passes["failures"] == 0
    assert report.migration_jobs_created > 0
    assert report.cycles_at_level == {"full": RUN[name]}
    if name == "hotspot":
        assert report.pods_migrated > 0 and report.hotspot_events > 0
    else:
        assert report.pods_drained > 0


def test_overcommit_shift_runs_every_manager_round_on_the_device_pass():
    """The co-located koord-manager ticks before every dispatch, each colo
    pass on the device engine (the CPU tensors here); the surge at cycle
    40 shifts batch allocatable and the staleness SLO holds."""
    report = _port("overcommit-shift")
    colo = report.to_dict()["colo"]
    assert colo["manager_rounds"] == RUN["overcommit-shift"]
    assert colo["device_passes"] == RUN["overcommit-shift"]
    assert colo["host_passes"] == 0 and colo["final_engine"] == "device"
    assert colo["overcommit_shifts"] > 0 and colo["batch_pods_bound"] > 0
    assert colo["staleness_slo_met"]
    assert report.cycles_at_level == {"full": RUN["overcommit-shift"]}


def test_fault_plan_budgets_fire_at_their_cycle():
    plan = FaultPlan([Fault(cycle=2, kind="dispatch", count=2)])
    plan.begin_cycle(0)
    plan.dispatch_hook("serial")
    plan.begin_cycle(2)
    with pytest.raises(InjectedFault):
        plan.dispatch_hook("serial")
    with pytest.raises(InjectedFault):
        plan.dispatch_hook("fused")
    plan.dispatch_hook("serial")
    assert [f["kind"] for f in plan.injected] == ["dispatch", "dispatch"]


def test_oom_upload_fault_is_a_device_allocation_error():
    from koordinator_tpu_torch.scheduler.snapshot_cache import (
        DeviceAllocationError,
        DeviceSnapshot,
    )
    from koordinator_tpu_torch.testing import synth_full_cluster
    from koordinator_tpu_torch.scheduler.snapshot import (
        build_full_chain_inputs,
    )
    from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs

    _c, state = synth_full_cluster(4, 8, seed=0)
    fc = build_full_chain_inputs(state, LoadAwareArgs())[0]
    plan = FaultPlan([Fault(cycle=0, kind="oom_upload")])
    plan.begin_cycle(0)
    snap = DeviceSnapshot(device="cpu")
    snap.fault_injector = plan.upload_hook
    with pytest.raises(DeviceAllocationError, match="RESOURCE_EXHAUSTED"):
        snap.upload(fc)
    snap.upload(fc)  # the budget is spent: the retry goes through
    assert snap.stats["put"] > 0


def test_invariant_checker_catches_seeded_breaches():
    from koordinator_tpu_torch.api.objects import Node, ObjectMeta, Pod, PodSpec
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import (
        KIND_NODE,
        KIND_POD,
        ObjectStore,
    )

    gib = 1024 ** 3
    store = ObjectStore()
    store.add(KIND_NODE, Node(meta=ObjectMeta(name="n0", namespace=""),
                              allocatable=ResourceList.of(
                                  cpu=1000, memory=gib, pods=10)))
    for i in range(2):
        pod = Pod(meta=ObjectMeta(name=f"p{i}", namespace="sim",
                                  uid=f"p{i}"),
                  spec=PodSpec(requests=ResourceList.of(cpu=800,
                                                        memory=gib // 2)))
        pod.spec.node_name = "n0"
        pod.spec.host_ports.append(("TCP", 80))
        store.add(KIND_POD, pod)
    breaches = check_invariants(store)
    assert any("overcommitted" in b for b in breaches)
    assert any("double-bound" in b for b in breaches)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_lists_the_catalog(capsys):
    assert sim_main(["--list"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in SCENARIOS)


@pytest.mark.parametrize("argv,code", [
    ([], 4),
    (["no-such-scenario", "--device", "cpu"], 4),
    (["smoke", "--waves", "x", "--device", "cpu"], 4),
    (["soak", "--device", "cpu"], 5),
    (["fault-ladder", "--device", "cpu"], 5),
], ids=["no-scenario", "unknown", "bad-waves", "soak", "fault-ladder"])
def test_cli_usage_contract(argv, code, capsys):
    assert sim_main(argv) == code
    capsys.readouterr()


def test_cli_runs_a_scenario_on_the_cpu(capsys):
    assert sim_main(["smoke", "--cycles", "4", "--device", "cpu",
                     "--quiet", "--check-determinism"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["scenario"] == "smoke" and report["cycles"] == 4
    assert report["determinism"]["binding_log_stable"]
    assert report["invariant_breaches"] == 0


def test_cli_device_defaults_to_cuda(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim_main(["smoke", "--cycles", "1", "--quiet"])
    capsys.readouterr()
