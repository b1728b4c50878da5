"""test_koordwatch.py's cases on the port.

Mesh cases run on the host split into 8 virtual shard devices
(test_torch_cases.cpu_devices); the dispatch faults the cases inject
reach the ladder as InjectedFault (test_torch_cases.injected).

Left out:
  * TestObsSurfaces.test_concurrent_scrapes_during_churn on the CPU; its
    property is held by TestObsSurfacesOnPort (below), with two scraper
    threads that yield the GIL between scrapes. The reference's five
    scrapers spin: each of the port's eager torch ops releases the GIL
    and waits about the interpreter's switch interval to take it back
    from them (~40 ms a call with five). On the CPU the round is the
    plain twin of kernel 1, a loop of torch ops per pod: ~511 calls a
    pod before its per-pod flags and hoisted rows, ~119 after
    (tests/test_torch_call_budget.py holds it under 150), so the 14
    cycles still make ~9,600 calls and take minutes beside the scrapers.
    No lock of the port is involved: one scraper of /healthz, which takes
    none, slows them as much as one of /metrics. On the card, where the
    round is one launch, chip_smoke.py's scrape_convoy phase runs the
    case verbatim (testing/scrape_convoy.reference_case) within 150 s.
    PERF.md section 7 has the times.
"""

from __future__ import annotations

import itertools
import json
import threading
import time

import test_torch_cases as torch_cases

cpu_devices = torch_cases.cpu_devices

_ref = torch_cases.port_module("test_koordwatch", [
    *torch_cases.injected('"injected dispatch fault"', '"transient"',
                          '"persistent"'),
    torch_cases.after_import("numpy as np", torch_cases.INJECTED_FAULT),
], on_cpu=("Scheduler", "run_scenario", "ChurnSimulator"))


class TestObsSurfaces(_ref.TestObsSurfaces):
    test_concurrent_scrapes_during_churn = None


torch_cases.export(_ref, globals(), leave_out=("TestObsSurfaces",))


class TestObsSurfacesOnPort:
    def test_concurrent_yielding_scrapes_during_churn(self):
        """The left-out case's property: /metrics, /debug/timeline,
        /debug/slo, /healthz and /traces scraped while the smoke
        scenario's 14 churn cycles run — no torn exposition, no
        exception — by two scraper threads instead of five, which take
        the paths in turn and yield the GIL between scrapes, as one
        waiting on its socket does."""
        from koordinator_tpu_torch.obs.server import ObsServer
        from koordinator_tpu_torch.obs.slo import load_bundle as load_slo
        from koordinator_tpu_torch.obs.timeline import (
            load_bundle as load_timeline,
        )
        from koordinator_tpu_torch.scheduler import metrics
        from koordinator_tpu_torch.sim.harness import ChurnSimulator
        from koordinator_tpu_torch.sim.scenarios import SCENARIOS

        sim = ChurnSimulator(SCENARIOS["smoke"].resolved(cycles=14),
                             device="cpu")
        srv = ObsServer(metrics.REGISTRY, sim.sched.tracer,
                        health_provider=sim.sched.health_snapshot,
                        flight=sim.sched.flight,
                        timeline=sim.sched.timeline, slo=sim.slo)
        stop = threading.Event()
        errors = []
        scrapes = {}

        def scraper(paths):
            for path in itertools.cycle(paths):
                if stop.is_set():
                    return
                try:
                    status, _, body = srv.handle(path)
                    assert status == 200, (path, status)
                    if path == "/metrics":
                        assert ("# TYPE koord_scheduler_cycle_seconds "
                                "histogram") in body
                    elif path == "/debug/timeline":
                        assert load_timeline(body.splitlines())[2] == []
                    elif path == "/debug/slo":
                        assert load_slo(body.splitlines())[2] == []
                    elif path == "/healthz":
                        json.loads(body)
                    scrapes[path] = scrapes.get(path, 0) + 1
                except Exception as exc:  # surfaced via the errors list
                    errors.append(f"{path}: {type(exc).__name__}: {exc}")
                    return
                time.sleep(0)

        split = (("/metrics", "/healthz"),
                 ("/debug/timeline", "/debug/slo", "/traces"))
        threads = [threading.Thread(target=scraper, args=(p,))
                   for p in split]
        for th in threads:
            th.start()
        try:
            for cycle in range(14):
                sim._run_one_cycle(cycle)
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=30)
        assert errors == []
        assert sorted(scrapes) == sorted(sum(split, ()))
        report = sim.run_report()
        assert report.invariant_breaches == []


def test_scrape_convoy_counts_the_cycles_torch_calls():
    """testing/scrape_convoy, which splits the left-out case's slowdown:
    a run alone counts the churn cycles' torch calls, and a run beside a
    spinning scraper at a short switch interval finishes its cycles and
    serves scrapes."""
    from koordinator_tpu_torch.testing import scrape_convoy

    alone = scrape_convoy.run(2, scrapers=0, limit=60, device="cpu",
                              count=True)
    assert alone["cycles"] == 2 and alone["torch_calls"] > 0
    assert sum(alone["torch_calls_per_cycle"]) == alone["torch_calls"]
    spun = scrape_convoy.run(1, scrapers=1, limit=60, device="cpu",
                             switch=1e-4)
    assert spun["cycles"] == 1 and spun["scrapes"] > 0
    assert spun["switch_interval_s"] == 1e-4
