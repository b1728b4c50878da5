"""koordrace's gate on the port: ``check_races`` at its two preemption
seeds on the CPU, held to the JAX package's racecheck binding log, the
second seed's background ladder replaying the rungs the first recorded
into the gate's one rung index; and the gate over the same scenario at
fused waves (K = 2: on the card the chained dispatch, kernel 1 and its
replay instance), held to the JAX package's run of it.

The JAX package's ``run_racecheck(preempt_seed=101)`` runs in a
subprocess, and its waves run in another, both started before the port's
runs and read after them: its compile-cache directory and its harness's
lock factories never reach this process.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's run_racecheck(preempt_seed=101) binding log, on the CPU
RACECHECK_JAX_SHA256 = (
    "eda59ef27b8dc0836abf49db3a36b7ea89f580485609521ebe3050cb43b87e20")
# the same at waves=2 (racecheck_scenario(24) with waves=2)
RACECHECK_WAVES_JAX_SHA256 = (
    "97ba4807280ecd6a3c756daa5ddfa9e98e077eb9936e2f40af3e5d86d6d64bb8")

_JAX_RACECHECK = """
import dataclasses, json, sys
from koordinator_tpu.sim.racecheck import racecheck_scenario, run_racecheck
waves = int(sys.argv[1])
scenario = (dataclasses.replace(racecheck_scenario(24), waves=waves)
            if waves > 1 else None)
rep = run_racecheck(preempt_seed=101, scenario=scenario)
print(json.dumps({"sha": rep.binding_log_sha256, "bindings": rep.bindings,
                  "ok": rep.ok, "touches": rep.touches}))
"""


def _rung_indexes():
    return set(glob.glob(os.path.join(tempfile.gettempdir(),
                                      "koordrace-cache-*")))


@pytest.fixture(scope="module")
def gates():
    """(the port's gate, the port's gate at waves=2 on seed 101, the JAX
    package's two reports, the throwaway rung indexes left behind), run
    side by side."""
    from koordinator_tpu_torch.scheduler import warmup
    from koordinator_tpu_torch.sim.racecheck import check_races

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    refs = [subprocess.Popen([sys.executable, "-c", _JAX_RACECHECK, waves],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for waves in ("1", "2")]
    try:
        index_dir = warmup._configured_dir
        indexes = _rung_indexes()
        gate = check_races(seeds=(101, 202), device="cpu")
        waves = check_races(seeds=(101,), device="cpu", waves=2)
        assert warmup._configured_dir == index_dir
        outs = []
        for ref in refs:
            out, err = ref.communicate(timeout=600)
            assert ref.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
        # after the JAX package's runs, which name theirs the same way
        left = _rung_indexes() - indexes
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    return gate, waves, outs[0], outs[1], left


def test_gate_passes_at_both_seeds(gates):
    gate = gates[0]
    assert gate.ok, gate.failures
    assert [r.preempt_seed for r in gate.reports] == [101, 202]
    assert gate.static == []
    for rep in gate.reports:
        assert rep.witnesses == []
        assert rep.order_violations == []
        assert rep.scrape_errors == []
        assert rep.touches > 0 and rep.scrapes > 0
        assert rep.bindings > 0


def test_second_seed_replays_the_first_seeds_rungs(gates):
    """One rung index for the gate's seeds, removed after it: the first
    seed's background ladder finds it empty and records into it, the
    second's replays every rung recorded while its first cycles run."""
    gate, left = gates[0], gates[4]
    first, second = (r.warmup for r in gate.reports)
    assert first["rungs"] == first["warmed"] == 0
    assert second["rungs"] >= 1 and second["warmed"] == second["rungs"]
    assert not second["failed"] and not second["invalidated"]
    assert left == set()


def test_both_seeds_carry_the_jax_binding_log(gates):
    gate = gates[0]
    assert [r.binding_log_sha256 for r in gate.reports] == [
        RACECHECK_JAX_SHA256] * 2


def test_jax_racecheck_gives_the_pinned_sha(gates):
    gate, _waves, ref, _ref_waves, _left = gates
    assert ref["ok"] and ref["touches"] > 0
    assert ref["sha"] == RACECHECK_JAX_SHA256
    assert ref["bindings"] == gate.reports[0].bindings


def test_waves_run_carries_the_jax_binding_log(gates):
    _gate, waves_gate, _ref, ref_waves, _left = gates
    assert waves_gate.ok, waves_gate.failures
    (waves,) = waves_gate.reports
    assert waves.ok and waves.touches > 0 and waves.scrapes > 0
    assert ref_waves["ok"] and ref_waves["touches"] > 0
    assert waves.binding_log_sha256 == ref_waves["sha"] == \
        RACECHECK_WAVES_JAX_SHA256
    assert waves.bindings == ref_waves["bindings"]


def test_gate_cli_on_the_cpu(tmp_path):
    out = tmp_path / "gate.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "koordinator_tpu_torch.sim.racecheck",
         "--device", "cpu", "--seeds", "7", "--cycles", "4",
         "--json", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "check_races: seed=7 " in proc.stdout
    assert "check_races: OK (1 seeds" in proc.stdout
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["failures"] == [] and doc["static"] == []
    (rep,) = doc["reports"]
    assert rep["preempt_seed"] == 7 and rep["touches"] > 0

