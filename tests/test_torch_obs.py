"""The port's observability surfaces and its koord-scheduler binary, on the
CPU.

``obs/server.py``'s ObsServer routes (/healthz with the ladder payload,
/metrics, /traces, /explain?pod=, the flight recorder, /debug/timeline,
/debug/slo) over a port Scheduler with explain on, in process and over
HTTP; the koordexplain/koordwatch CLI (``obs/__main__.py``) with the exit
codes of the JAX package's, on the golden fixtures its tests/test_obs.py
and tests/test_explain.py read (tests/fixtures/); and
``cmd.koord_scheduler.main`` at ``--device cpu``, its /explain answered
over HTTP between ticks and equal to the Scheduler's own record.
"""

from __future__ import annotations

import json
import re
import socket
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest

from koordinator_tpu.obs.__main__ import main as ref_main

from koordinator_tpu_torch.cmd import build_store, koord_scheduler
from koordinator_tpu_torch.obs import Tracer, validate_record
from koordinator_tpu_torch.obs.__main__ import main as cli
from koordinator_tpu_torch.obs.flight import load_bundle
from koordinator_tpu_torch.obs.server import ObsServer
from koordinator_tpu_torch.obs.slo import load_bundle as load_slo
from koordinator_tpu_torch.obs.timeline import load_bundle as load_timeline
from koordinator_tpu_torch.scheduler import cycle
from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
from koordinator_tpu_torch.scheduler.metrics import Registry

FIXTURES = Path(__file__).resolve().parent / "fixtures"
GOLDEN = {name: str(FIXTURES / f"{name}_golden.jsonl")
          for name in ("trace", "flight", "timeline", "slo")}


def _explained_scheduler(explain="full"):
    """Three serial cycles with explain on over the binary's --synth
    50x400 store (running pods and NodeMetrics included): more pods than
    the nodes hold, so some end unschedulable with per-stage messages."""
    store = build_store(types.SimpleNamespace(synth="50x400", state=None))
    sched = cycle.Scheduler(store, waves=1, device="cpu", explain=explain)
    for c in range(3):
        sched.run_cycle(now=1_000_000.0 + 2 * c)
    return sched


def _server(sched):
    return ObsServer(metrics_registry=scheduler_metrics.REGISTRY,
                     tracer=sched.tracer,
                     health_provider=sched.health_snapshot,
                     explain_provider=sched.explain_record,
                     flight=sched.flight, timeline=sched.timeline)


def test_obs_server_routes_over_a_scheduler():
    sched = _explained_scheduler()
    srv = _server(sched)
    status, ctype, body = srv.handle("/healthz")
    health = json.loads(body)
    assert status == 200 and ctype == "application/json"
    assert health["cycles"] == 3 and health["last_cycle_waves"] == 1
    assert health["degraded"]["level_name"] == "full"
    bound = next(k for k, v in sched.explain_index.items()
                 if v["verdict"] == "bound")
    unsched = next(k for k, v in sched.explain_index.items()
                   if v["verdict"] == "unschedulable"
                   and v.get("message", "").startswith("0/"))
    for key in (bound, unsched):
        status, _ctype, body = srv.handle("/explain", {"pod": key})
        assert status == 200
        assert json.loads(body) == json.loads(json.dumps(
            {"pod": key, **sched.explain_record(key)}))
    rec = json.loads(srv.handle("/explain", {"pod": bound})[2])
    assert set(rec["terms"]) == {"LoadAware", "NodeNUMAResource",
                                 "Preferred", "best_score", "runner_up"}
    rec = json.loads(srv.handle("/explain", {"pod": unsched})[2])
    assert rec["message"].startswith("0/") and rec["stages"]
    assert srv.handle("/explain", {"pod": "no/such"})[0] == 404
    assert srv.handle("/explain")[0] == 400
    body = srv.handle("/metrics")[2]
    assert "koord_scheduler_filter_rejections_total" in body
    assert "koord_scheduler_explain_readback_bytes_total" in body
    lines = srv.handle("/traces", {"limit": "1"})[2].strip().splitlines()
    assert lines and all(validate_record(json.loads(ln)) == []
                         for ln in lines)
    assert srv.handle("/traces", {"limit": "x"})[0] == 400
    status, _c, body = srv.handle("/debug/timeline")
    assert status == 200 and load_timeline(body.splitlines())[2] == []
    status, _c, body = srv.handle("/debug/flightrecorder", method="POST")
    _h, recs, errors = load_bundle(body.splitlines())
    assert status == 200 and not errors and len(recs) == 3
    assert json.loads(srv.handle("/debug/flightrecorder")[2])["cycles"] == 3
    assert srv.handle("/nope")[0] == 404


def test_obs_server_defaults_and_slo():
    srv = ObsServer()
    assert srv.handle("/healthz") == (200, "text/plain", "ok")
    for path in ("/metrics", "/traces", "/explain", "/debug/slo",
                 "/debug/timeline", "/debug/flightrecorder"):
        assert srv.handle(path, {"pod": "x"})[0] == 404
    from koordinator_tpu_torch.obs.slo import SloRegistry

    slo = SloRegistry()
    status, _c, body = ObsServer(slo=slo).handle("/debug/slo")
    assert status == 200 and load_slo(body.splitlines())[2] == []
    reg = Registry()
    reg.histogram("x_seconds").observe(0.5)
    t = Tracer()
    with t.span("cycle"):
        pass
    status, ctype, body = ObsServer(reg, t).handle("/metrics")
    assert "version=0.0.4" in ctype and 'x_seconds_bucket{le="+Inf"} 1' in (
        body)


def test_obs_server_over_http():
    sched = _explained_scheduler("counts")
    server, _thread = _server(sched).serve(0)
    try:
        port = server.server_address[1]
        key = next(iter(sched.explain_index))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/explain?pod={key}",
                timeout=10) as resp:
            assert json.loads(resp.read())["pod"] == key
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/debug/flightrecorder", method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert load_bundle(resp.read().decode().splitlines())[2] == []
    finally:
        server.shutdown()


# the CLI's subcommands on the golden fixtures, and the exit codes both
# packages give: 0 valid, 1 schema drift (or a pod absent), 2 usage
@pytest.mark.parametrize("argv,code", [
    (["GOLDEN:trace"], 0),
    (["flight", "GOLDEN:flight"], 0),
    (["explain", "GOLDEN:flight", "FLIGHT_POD"], 0),
    (["explain", "GOLDEN:flight", "no/such-pod"], 1),
    (["timeline", "GOLDEN:timeline"], 0),
    (["slo", "GOLDEN:slo"], 0),
    (["flight", "/does/not/exist.jsonl"], 2),
    (["timeline", "/does/not/exist.jsonl"], 2),
    (["no/such/trace.jsonl"], 2),
    (["flight", "GOLDEN:trace"], 1),
    (["slo", "GOLDEN:flight"], 1),
], ids=["trace", "flight", "explain", "explain-absent", "timeline", "slo",
        "flight-missing", "timeline-missing", "trace-missing",
        "flight-drift", "slo-drift"])
def test_cli_exit_codes_match_reference(argv, code, capsys):
    with open(GOLDEN["flight"]) as f:
        pod = json.loads(f.readlines()[1])["bound"][0]["pod"]
    args = [GOLDEN[a[7:]] if a.startswith("GOLDEN:") else
            pod if a == "FLIGHT_POD" else a for a in argv]
    assert cli(args) == code
    out = capsys.readouterr()
    assert ref_main(args) == code
    ref_out = capsys.readouterr()
    assert out.out == ref_out.out
    if argv[:1] == ["explain"] and code == 0:
        assert "verdict: bound" in out.out


def test_cli_rejects_a_bad_bundle(tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1, "kind": "header"}\n')
    assert cli(["flight", str(bad)]) == 1
    assert "schema error" in capsys.readouterr().err
    lines = Path(GOLDEN["trace"]).read_text().strip().splitlines()
    rec = json.loads(lines[0])
    del rec["duration_ms"]
    drift = tmp_path / "drift.jsonl"
    drift.write_text("\n".join([json.dumps(rec)] + lines[1:]) + "\n")
    assert cli([str(drift)]) == 1
    assert "duration_ms" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the koord-scheduler binary
# ---------------------------------------------------------------------------

def test_koord_scheduler_main_on_cpu(capsys):
    assert koord_scheduler.main(["--synth", "50x200", "--max-ticks", "2",
                                 "--device", "cpu", "--obs-port", "0",
                                 "--interval", "0"]) == 0
    err = capsys.readouterr().err
    assert len(re.findall(r"koord-scheduler: bound=\d+", err)) == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_koord_scheduler_serves_explain(monkeypatch, capsys):
    """KOORD_TPU_EXPLAIN=counts, two ticks a few seconds apart: between
    them /healthz, /metrics and /explain answer over HTTP, and /explain
    for a bound and an unschedulable pod is the Scheduler's own
    record."""
    monkeypatch.setenv("KOORD_TPU_EXPLAIN", "counts")
    made = []

    class Recording(cycle.Scheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(cycle, "Scheduler", Recording)
    port = _free_port()
    seen = {}

    def probe():
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    if json.loads(r.read())["cycles"] >= 1:
                        break
            except OSError:
                pass
            time.sleep(0.05)
        sched = made[0]
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            seen["metrics"] = r.read().decode()
        with sched._health_lock:  # the lock the cycle writes the index under
            index = list(sched.explain_index.items())
        for verdict in ("bound", "unschedulable"):
            key = next(k for k, v in index if v["verdict"] == verdict)
            # a record read before and after the GET: equal unless the
            # next tick landed in between, which a retry rules out
            for _attempt in range(3):
                before = sched.explain_record(key)
                with urllib.request.urlopen(base + f"/explain?pod={key}",
                                            timeout=5) as r:
                    got = json.loads(r.read())
                if sched.explain_record(key) == before:
                    break
            seen[verdict] = (got, {"pod": key, **before})

    thread = threading.Thread(target=probe)
    thread.start()
    # 50 nodes, 400 pods: more pods than the nodes hold, so some stay
    # unschedulable
    assert koord_scheduler.main(["--synth", "50x400", "--max-ticks", "2",
                                 "--device", "cpu", "--obs-port", str(port),
                                 "--interval", "3"]) == 0
    thread.join()
    capsys.readouterr()
    assert made and made[0].explain_spec == "counts"
    assert "koord_scheduler_filter_rejections_total" in seen["metrics"]
    for verdict in ("bound", "unschedulable"):
        got, want = seen[verdict]
        assert got == json.loads(json.dumps(want))
        assert got["verdict"] == verdict
    assert seen["unschedulable"][0]["message"].startswith("0/")


def test_koord_scheduler_ticks_against_a_live_sidecar(tmp_path, capsys):
    """The two binaries as a user runs them: koord_sidecar in its own
    process at --device cpu, koord_scheduler --sidecar-address pointed at
    it; every tick binds through the sidecar (no fallback), and the tick
    line says so."""
    import os
    import subprocess
    import sys

    repo = Path(__file__).resolve().parents[1]
    sock = tmp_path / "sidecar.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", "koordinator_tpu_torch.cmd.koord_sidecar",
         "--listen", f"unix://{sock}", "--device", "cpu"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while not sock.exists() and proc.poll() is None:
            assert time.time() < deadline, "koord_sidecar never listened"
            time.sleep(0.05)
        assert proc.poll() is None, proc.stderr.read()
        assert koord_scheduler.main(["--synth", "8x40", "--max-ticks", "2",
                                     "--device", "cpu", "--interval", "0",
                                     "--sidecar-address",
                                     f"unix://{sock}"]) == 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()
    ticks = re.findall(r"koord-scheduler: bound=(\d+) .* "
                       r"sidecar_fallbacks=(\d+)", capsys.readouterr().err)
    assert len(ticks) == 2
    assert int(ticks[0][0]) > 0
    assert [f for _b, f in ticks] == ["0", "0"]
