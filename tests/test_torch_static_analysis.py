"""koordlint on the port: the port's own analyzer
(koordinator_tpu_torch/analysis) against the JAX package's.

The cases of test_static_analysis.py run on the port's analyzer under
their reference names (tests/test_torch_cases.py). One edit: the two
shipped-tree CLI runs scan the port's tree (``koordinator_tpu_torch``),
which is what the port's CLI scans by default; the JAX package's
``koordinator_tpu bench.py`` stays its own gate. Then the two analyzers
over the same trees: equal findings, and equal guard maps but for the one
module the port's guard scan adds (``ops/kernel_common.py``, whose
first-build lock the JAX package has no counterpart of).
"""

from __future__ import annotations

import os

import test_torch_cases as torch_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch_cases.export(torch_cases.port_module("test_static_analysis", [
    ('proc = _run_cli("koordinator_tpu", "bench.py")',
     'proc = _run_cli("koordinator_tpu_torch")'),
    ('_run_cli("--guards", "--check-locks", "koordinator_tpu")',
     '_run_cli("--guards", "--check-locks", "koordinator_tpu_torch")'),
]), globals())


# ---------------------------------------------------------------------------
# the two analyzers over the same trees
# ---------------------------------------------------------------------------

def _rows(findings):
    return [(f.path, f.line, f.rule, f.message) for f in findings]


def _in_repo(monkeypatch):
    # findings and guard-map keys carry CWD-relative paths
    monkeypatch.chdir(REPO)


def test_analyzers_give_equal_findings_over_both_trees(monkeypatch):
    from koordinator_tpu.analysis import analyze_paths as ref_analyze

    from koordinator_tpu_torch.analysis import analyze_paths

    _in_repo(monkeypatch)
    paths = ["koordinator_tpu", "bench.py", "koordinator_tpu_torch"]
    assert _rows(analyze_paths(paths, jobs=1)) == _rows(
        ref_analyze(paths, jobs=1))


def test_analyzers_give_equal_findings_on_a_findings_fixture(tmp_path,
                                                             monkeypatch):
    """The shipped trees lint clean, so hold the two analyzers together
    where they find something: one module per rule family's path gate."""
    from koordinator_tpu.analysis import analyze_paths as ref_analyze

    from koordinator_tpu_torch.analysis import analyze_paths

    src = (
        "import threading\n"
        "import time\n"
        "import jax.numpy as jnp\n"
        "_cache = {}\n"
        "x = jnp.arange(5)\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._ring = []  # koordlint: guarded-by(_lock)\n"
        "    def put(self, v):\n"
        "        with self._lock:\n"
        "            self._ring.append(v)\n"
        "            time.sleep(0.1)\n"
        "    def peek(self):\n"
        "        return self._ring[-1]\n"
        "def poke(k):\n"
        "    _cache[k] = 1\n"
        "    try:\n"
        "        pass\n"
        "    except Exception:\n"
        "        pass\n")
    for pkg in ("obs", "scheduler", "balance", "colo", "koordlet"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "mod.py").write_text(src)
    monkeypatch.chdir(tmp_path)
    port = _rows(analyze_paths(["."], jobs=1))
    assert port == _rows(ref_analyze(["."], jobs=1))
    rules = {row[2] for row in port}
    assert {"unguarded-shared-field", "blocking-call-under-lock",
            "jax-implicit-dtype"} <= rules, rules


def _guard_maps(paths):
    from koordinator_tpu.analysis.guards import (
        build_guard_map as ref_build,
        collect_facts_for_paths as ref_collect,
    )

    from koordinator_tpu_torch.analysis.guards import (
        build_guard_map,
        collect_facts_for_paths,
    )

    return (build_guard_map(collect_facts_for_paths(paths)).to_dict(),
            ref_build(ref_collect(paths)).to_dict())


def test_guard_maps_equal_over_the_reference_tree(monkeypatch):
    _in_repo(monkeypatch)
    port, ref = _guard_maps(["koordinator_tpu"])
    assert port == ref
    assert ref["modules"]


def test_guard_maps_differ_by_the_kernel_library_lock_over_the_port(
        monkeypatch):
    _in_repo(monkeypatch)
    port, ref = _guard_maps(["koordinator_tpu_torch"])
    added = "koordinator_tpu_torch/ops/kernel_common.py"
    assert [m for m in port["modules"] if m["path"] != added] == \
        ref["modules"]
    assert {k: v for k, v in port.items() if k != "modules"} == \
        {k: v for k, v in ref.items() if k != "modules"}
    (entry,) = [m for m in port["modules"] if m["path"] == added]
    (module,) = [o for o in entry["owners"] if o["owner"] == "<module>"]
    assert [(d["attr"], d["kind"]) for d in module["locks"]] == [
        ("_LIBS_LOCK", "Lock")]
    (libs,) = [f for f in module["fields"] if f["name"] == "_LIBS"]
    assert (libs["guard"], libs["source"]) == ("_LIBS_LOCK", "annotation")
    # the one bare touch is the pragma'd double-checked fast path
    assert libs["bare"] == 1


def test_guard_scan_adds_only_the_kernel_library_module():
    from koordinator_tpu.analysis.guards import (
        is_guard_scanned_path as ref_scanned,
    )

    from koordinator_tpu_torch.analysis.guards import is_guard_scanned_path

    assert is_guard_scanned_path("koordinator_tpu_torch/ops/kernel_common.py")
    assert not ref_scanned("koordinator_tpu_torch/ops/kernel_common.py")
    assert not is_guard_scanned_path("koordinator_tpu_torch/ops/fit.py")
    for path in ("koordinator_tpu/scheduler/cycle.py",
                 "koordinator_tpu/obs/timeline.py",
                 "koordinator_tpu/client/store.py",
                 "koordinator_tpu/koordlet/metrics.py",
                 "koordinator_tpu/ops/fit.py"):
        assert is_guard_scanned_path(path) == ref_scanned(path), path
