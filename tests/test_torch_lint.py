"""koordlint over the port: the JAX package's analyzer and the port's own
(koordinator_tpu_torch/analysis) report zero findings, and the lock-order
declaration the race rules check against."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = ["DeviceSnapshot._lock", "DeviceTimeline._lock",
             "Registry._lock", "_Metric._lock"]


def _analysis(*args, package="koordinator_tpu"):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", f"{package}.analysis", *args,
         "koordinator_tpu_torch"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def _port_analysis(*args):
    return _analysis(*args, package="koordinator_tpu_torch")


def test_koordlint_reports_no_finding_over_the_port():
    proc = _analysis()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "koordlint: 0 finding(s)" in proc.stdout + proc.stderr


def test_guard_map_carries_the_canonical_lock_order():
    proc = _analysis("--guards", "--check-locks")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    guards = json.loads(proc.stdout)
    assert guards["canonical_lock_order"] == CANONICAL


def test_lock_order_declaration_matches_the_reference():
    from koordinator_tpu.obs.lockorder import (
        CANONICAL_LOCK_ORDER as REF_ORDER,
    )

    from koordinator_tpu_torch.obs.lockorder import CANONICAL_LOCK_ORDER

    assert list(CANONICAL_LOCK_ORDER) == list(REF_ORDER) == CANONICAL


# ---------------------------------------------------------------------------
# the port's own analyzer over the port
# ---------------------------------------------------------------------------

def test_port_koordlint_reports_no_finding_over_the_port():
    proc = _port_analysis()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "koordlint: 0 finding(s) (0 error, 0 warning) across 23 rules" \
        in proc.stdout


def test_port_koordlint_defaults_to_the_port_tree():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "koordinator_tpu_torch.analysis", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    text = " ".join(proc.stdout.split())
    assert "usage: python -m koordinator_tpu_torch.analysis" in text
    assert "(default: koordinator_tpu_torch)" in text


@pytest.fixture(scope="module")
def port_guards():
    proc = _port_analysis("--guards", "--check-locks")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout)


def _fields(guards, path):
    (module,) = [m for m in guards["modules"]
                 if m["path"] == f"koordinator_tpu_torch/{path}"]
    return {(o["owner"], f["name"]): f
            for o in module["owners"] for f in o["fields"]}


def test_port_guard_map_carries_the_canonical_lock_order(port_guards):
    assert port_guards["canonical_lock_order"] == CANONICAL


def test_port_guard_map_carries_the_library_lock(port_guards):
    (module,) = [m for m in port_guards["modules"] if m["path"] ==
                 "koordinator_tpu_torch/ops/kernel_common.py"]
    locks = [(o["owner"], d["attr"]) for o in module["owners"]
             for d in o["locks"]]
    assert locks == [("<module>", "_LIBS_LOCK")]
    libs = _fields(port_guards, "ops/kernel_common.py")[("<module>", "_LIBS")]
    assert libs["guard"] == "_LIBS_LOCK"


@pytest.mark.parametrize("path,owner,field", [
    ("scheduler/cycle.py", "Scheduler", "_submesh_cache"),
    ("scheduler/cycle.py", "Scheduler", "_lost_device_ids"),
    ("scheduler/cycle.py", "Scheduler", "_node_rows"),
    ("scheduler/snapshot_cache.py", "DeviceSnapshot", "_in_flight"),
])
def test_port_guard_map_carries_the_mesh_state(port_guards, path, owner,
                                               field):
    assert (owner, field) in _fields(port_guards, path)
