"""The JAX package's analyzer (koordlint) over the port: zero findings,
and the lock-order declaration the race rules check against."""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = ["DeviceSnapshot._lock", "DeviceTimeline._lock",
             "Registry._lock", "_Metric._lock"]


def _analysis(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "koordinator_tpu.analysis", *args,
         "koordinator_tpu_torch"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


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
