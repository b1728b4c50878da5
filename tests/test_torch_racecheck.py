"""koordrace's dynamic half on the port (koordinator_tpu_torch/sim/racecheck.py).

The cases of test_racecheck.py run on the port at ``device="cpu"`` under
their reference names (tests/test_torch_cases.py): the harness mechanics,
order tracking, the scrape validators, the static index, and the three
pinned interleavings. Edits: the port's Scheduler and DeviceSnapshot are
put on the CPU (both default to the card), the late scatter lands in a
torch tensor where the reference's lands in a jax array, and the gate's
static half is the port gate's own. Then the port's cases: a fork after a
traced run, and the kernel library's first-build lock under two threads.
The two-seed gate is tests/test_torch_racecheck_gate.py.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import threading
import types

import pytest

import test_torch_cases as torch_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch_cases.export(torch_cases.port_module("test_racecheck", [
    ("        import jax.numpy as jnp\n", "        import torch\n"),
    ("dev = jnp.zeros((8, 4), jnp.float32)",
     "dev = torch.zeros((8, 4), dtype=torch.float32)"),
    ('''        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "check_races", os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "hack", "check_races.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.static_race_findings() == []''',
     '''        from koordinator_tpu.sim.racecheck import static_race_findings

        assert static_race_findings() == []'''),
], on_cpu=("DeviceSnapshot", "Scheduler")), globals())


@pytest.fixture(autouse=True)
def _keep_rung_index_dir(monkeypatch):
    """The port's rung index is not first-wins: a case that configures one
    leaves the process's directory as it found it."""
    from koordinator_tpu_torch.scheduler import warmup

    monkeypatch.setattr(warmup, "_configured_dir", warmup._configured_dir)


# ---------------------------------------------------------------------------
# the port's cases
# ---------------------------------------------------------------------------

_FORK_AFTER_RUN = """
import logging, os, threading
from koordinator_tpu_torch.sim.racecheck import RaceCheck, _TracedLock
rc = RaceCheck(preempt_seed=0, preempt_permille=0)
rc.install()
# a thread, an Event (a Condition over a traced lock), a logging handler
# and an RLock: all built while traced, all still wrapped after uninstall
ev = threading.Event()
t = threading.Thread(target=ev.wait, args=(10,))
t.start()
handler = logging.StreamHandler()
logging.getLogger("koordrace-fork").addHandler(handler)
rlock = threading.RLock()
ev.set()
t.join()
rc.uninstall()
assert isinstance(handler.lock, _TracedLock)
with rlock:
    assert rlock._recursion_count() == 1
pid = os.fork()
if pid == 0:
    logging.getLogger("koordrace-fork").warning("child")
    os._exit(0 if rlock.acquire(blocking=False) else 3)
_, status = os.waitpid(pid, 0)
print("child-exit", os.waitstatus_to_exitcode(status))
"""


def test_fork_after_a_traced_run_prints_nothing():
    """Python 3.12 re-inits the threading and logging locks in a forked
    child (``_at_fork_reinit``); locks built during a run are still
    proxies there, and the child must come up clean."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _FORK_AFTER_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "child-exit 0" in proc.stdout
    assert proc.stderr.strip() == "child", proc.stderr
    assert "Exception ignored" not in proc.stderr


def test_traced_lock_reinit_clears_ownership():
    from koordinator_tpu_torch.sim.racecheck import _TracedLock

    lk = _TracedLock(threading.RLock(), "RLock", "X._lock")
    lk.acquire()
    assert lk.held_by_me() and lk._recursion_count() == 1
    lk._at_fork_reinit()
    assert not lk.held_by_me() and lk._recursion_count() == 0
    plain = _TracedLock(threading.Lock(), "Lock", "X._plain")
    plain.acquire()
    plain._at_fork_reinit()
    assert not plain.held_by_me() and not plain.locked()


class _AnnouncingLock:
    """The library lock with a signal when a second thread reaches it, so
    the first build is held until the race is on (no sleeps)."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.waiters = []
        self.second = threading.Event()

    def __enter__(self):
        self.waiters.append(threading.current_thread().name)
        if len(self.waiters) == 2:
            self.second.set()
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_two_first_loads_build_once(monkeypatch):
    from koordinator_tpu_torch.ops import kernel_common

    builds = []
    entered = threading.Event()

    def build_libraries(*sources):
        builds.append(threading.current_thread().name)
        entered.set()
        # hold the lock until the other thread is waiting on it
        assert lock.second.wait(10), "second loader never reached the lock"
        return {s: f"/nonexistent/lib{s}.so" for s in sources}

    lock = _AnnouncingLock(kernel_common._LIBS_LOCK)
    monkeypatch.setattr(kernel_common, "_LIBS", {})
    monkeypatch.setattr(kernel_common, "_LIBS_LOCK", lock)
    monkeypatch.setattr(kernel_common, "build_libraries", build_libraries)
    monkeypatch.setattr(kernel_common, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: ("lib", path)))

    got = {}

    def load(name):
        got[name] = kernel_common.load_library("full_chain.cu")

    threads = [threading.Thread(target=load, args=(f"loader-{i}",),
                                name=f"loader-{i}") for i in range(2)]
    threads[0].start()
    assert entered.wait(10), "first loader never reached the build"
    threads[1].start()
    for t in threads:
        t.join(10)
    assert builds == ["loader-0"]
    assert lock.waiters == ["loader-0", "loader-1"]
    assert got["loader-0"] is got["loader-1"]
    assert kernel_common._LIBS == {
        "full_chain.cu": ("lib", "/nonexistent/libfull_chain.cu.so")}


def test_harness_checks_the_library_lock(monkeypatch):
    """The port's one lock the JAX package lacks is in the harness's
    static index, its fast path excluded by its pragma; a first load
    under the harness touches the library map with the lock held."""
    from koordinator_tpu_torch.ops import kernel_common
    from koordinator_tpu_torch.sim.racecheck import RaceCheck, _TracedLock

    rc = RaceCheck(preempt_seed=0, preempt_permille=0)
    specs = [s for lines in rc._touch_files.values()
             for s in lines.values()
             if s.path.endswith("ops/kernel_common.py")]
    assert {(s.owner, s.field, s.guard) for s in specs} == {
        ("<module>", "_LIBS", "_LIBS_LOCK")}
    with open(kernel_common.__file__) as f:
        pragma = [i for i, ln in enumerate(f.read().splitlines(), start=1)
                  if "koordlint: disable=unguarded-shared-field" in ln]
    assert len(pragma) == 1
    assert pragma[0] not in {s.line for s in specs}

    monkeypatch.setattr(kernel_common, "_LIBS", {})
    monkeypatch.setattr(kernel_common, "build_libraries", lambda *s: {
        x: f"/nonexistent/{x}" for x in s})
    monkeypatch.setattr(kernel_common, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: ("lib", path)))
    seen = []
    rc.add_hook(lambda spec: spec.path.endswith("ops/kernel_common.py"),
                lambda spec, frame: seen.append(spec.line))
    rc.install()
    try:
        assert isinstance(kernel_common._LIBS_LOCK, _TracedLock)
        t = threading.Thread(target=kernel_common.load_library,
                             args=("full_chain.cu",))
        t.start()
        t.join(10)
    finally:
        rc.uninstall()
    assert not isinstance(kernel_common._LIBS_LOCK, _TracedLock)
    assert len(seen) == 2  # the locked re-check and the store
    assert rc.witnesses == []
    assert rc.unchecked == 0


def test_gate_names_every_failure_class():
    """Each failure class of the gate is a line of its own: a witness, an
    order inversion, a torn scrape, zero touches, binding logs that
    differ between seeds, a static race finding, and a witness the static
    map did not flag."""
    from koordinator_tpu_torch.analysis.core import Finding
    from koordinator_tpu_torch.sim.racecheck import RaceReport, gate_failures

    witness = {"path": "p.py", "line": 3, "owner": "C", "field": "f",
               "guard": "_lock", "write": True, "thread": "t"}
    a = RaceReport(preempt_seed=1, binding_log_sha256="aa", touches=5,
                   witnesses=[witness],
                   order_violations=[{"held": "B", "acquired": "A",
                                      "thread": "t"}],
                   scrape_errors=["/metrics: torn"])
    b = RaceReport(preempt_seed=2, binding_log_sha256="bb", touches=0)
    static = [Finding(rule="unguarded-shared-field", severity="error",
                      path="q.py", line=9, message="bare touch")]
    text = "\n".join(gate_failures([a, b], static))
    for needle in ("seed 1: unguarded touch p.py:3 C.f",
                   "seed 1: lock-order inversion: acquired A while "
                   "holding B", "seed 1: torn scrape: /metrics: torn",
                   "seed 2: zero touchpoints observed",
                   "binding log diverged across preemption seeds: "
                   "seed 1=aa, seed 2=bb",
                   "static race finding (must be empty): q.py:9",
                   "DYNAMIC-ONLY witness (analyzer blind spot): p.py:3"):
        assert needle in text, needle
    clean = RaceReport(preempt_seed=1, binding_log_sha256="aa", touches=5)
    assert gate_failures([clean, dataclasses.replace(clean, preempt_seed=2)],
                         []) == []
