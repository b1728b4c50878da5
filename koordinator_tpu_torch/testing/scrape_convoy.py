"""The churn loop under spinning in-process scrapers: how much of its
slowdown the interpreter's lock (the GIL) explains, and the JAX package's
concurrent-scrape case itself.

    python3 -m koordinator_tpu_torch.testing.scrape_convoy --device cpu \
        [--limit 300]
    python3 -m koordinator_tpu_torch.testing.scrape_convoy --device cuda \
        --reference

Runs the sim's ``smoke`` scenario's churn cycles (the loop of the JAX
package's tests/test_koordwatch.py concurrent-scrape case) three ways,
each in a fresh ChurnSimulator on its own ObsServer:

* ``alone``: no scraper; the cycles' wall seconds, and the torch calls
  they make (a CallCounter, a run of its own): in all, per cycle and by
  route (ROUTES: the round, the kernel route's pack, the upload, the
  diagnosis, the rest), with the plain rounds' valid pods and kernel 1's
  launches. Every torch call but a metadata read releases the GIL around
  its dispatch and must take it back;
* ``spinning``: five threads that scrape /metrics,
  /debug/timeline, /debug/slo, /healthz and /traces in a loop that never
  waits, as the reference case's do, at the interpreter's switch
  interval (``sys.getswitchinterval()``, 5 ms by default);
* ``spinning_fast_switch``: the same at a switch interval of 0.1 ms.

A run stops at ``--limit`` seconds; its line gives the cycles it
finished. One JSON line a run. A convoy predicts a cycle's time under
the scrapers near ``torch_calls x switch interval``, and a faster switch
shortening it in proportion; a lock held across a render would not
move with the switch interval.

``reference_case`` (``--reference``) is the reference case's body, check
for check, on any device: 14 cycles beside the five spinning scrapers,
each scrape checked (status 200, the cycle-seconds TYPE line, the
timeline and SLO bundles load with no error, /healthz parses), then
scrapes > 0, no error and no invariant breach. It returns what it saw.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import threading
import time

import torch

PATHS = ("/metrics", "/debug/timeline", "/debug/slo", "/healthz", "/traces")
CYCLES = 14
FAST_SWITCH_S = 1e-4


ROUTES = ("round", "pack", "upload", "diagnose", "rest")


def _route_table():
    """{code object: route} of the functions that open a route; a torch
    call belongs to the innermost such function on its stack, else to
    "rest"."""
    from koordinator_tpu_torch.models import full_chain as fcm
    from koordinator_tpu_torch.ops import full_chain_kernel as fck
    from koordinator_tpu_torch.scheduler import diagnose
    from koordinator_tpu_torch.scheduler.snapshot_cache import DeviceSnapshot

    table = {fcm.plain_round.__code__: "round",
             fcm.permit.__code__: "round",
             fck.full_chain_round.__code__: "round",
             fck._round_buffers.__code__: "pack"}
    for name in ("upload", "upload_fields", "_one", "_one_transfer",
                 "_scatter", "_upload_many"):
        fn = getattr(DeviceSnapshot, name, None)
        if fn is not None:
            table[fn.__code__] = "upload"
    for fn in vars(diagnose).values():
        code = getattr(fn, "__code__", None)
        if code is not None and code.co_filename == diagnose.__file__:
            table[code] = "diagnose"
    return table


class CallCounter(torch.overrides.TorchFunctionMode):
    """Counts the torch calls made under it (each one a GIL release
    around its dispatch, but for a few metadata reads), in all and by
    route (ROUTES): the innermost function of the route table on the
    call's stack. With ``sites`` also by the caller's file:line."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.n = 0
        self.by_route = dict.fromkeys(ROUTES, 0)
        self.sites = {} if sites else None
        self._table = _route_table()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        frame = sys._getframe(1)
        route = "rest"
        f = frame
        while f is not None:
            hit = self._table.get(f.f_code)
            if hit is not None:
                route = hit
                break
            f = f.f_back
        self.by_route[route] += 1
        if self.sites is not None:
            key = f"{frame.f_code.co_filename}:{frame.f_lineno}"
            self.sites[key] = self.sites.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _round_counts():
    """(plain rounds, their pods, kernel 1 launches) so far."""
    from koordinator_tpu_torch.models import full_chain as fcm
    from koordinator_tpu_torch.ops import full_chain_kernel as fck

    return fcm.plain_rounds, fcm.plain_pods, fck.launches


def _simulator(cycles: int, device):
    from koordinator_tpu_torch.sim.harness import ChurnSimulator
    from koordinator_tpu_torch.sim.scenarios import SCENARIOS

    return ChurnSimulator(SCENARIOS["smoke"].resolved(cycles=cycles),
                          device=device)


def run(cycles: int, scrapers: int, limit: float, device,
        switch: float = None, count: bool = False) -> dict:
    """One run of ``cycles`` churn cycles beside ``scrapers`` spinning
    scraper threads; the wall seconds, the cycles finished within
    ``limit`` and the scrapes served."""
    from koordinator_tpu_torch.obs.server import ObsServer
    from koordinator_tpu_torch.scheduler import metrics

    sim = _simulator(cycles, device)
    srv = ObsServer(metrics.REGISTRY, sim.sched.tracer,
                    health_provider=sim.sched.health_snapshot,
                    flight=sim.sched.flight, timeline=sim.sched.timeline,
                    slo=sim.slo)
    stop = threading.Event()
    scrapes = itertools.count()

    def scraper(path):
        while not stop.is_set():
            srv.handle(path)
            next(scrapes)

    before = sys.getswitchinterval()
    if switch is not None:
        sys.setswitchinterval(switch)
    threads = [threading.Thread(target=scraper, args=(PATHS[i % len(PATHS)],),
                                daemon=True) for i in range(scrapers)]
    counter = CallCounter() if count else None
    calls = []
    routes = []
    rounds0 = _round_counts()
    done = 0
    try:
        for th in threads:
            th.start()
        t0 = time.perf_counter()
        for cycle in range(cycles):
            if counter is None:
                sim._run_one_cycle(cycle)
            else:
                route0 = dict(counter.by_route)
                with counter:
                    sim._run_one_cycle(cycle)
                calls.append(counter.n - sum(calls))
                routes.append({k: counter.by_route[k] - route0[k]
                               for k in ROUTES})
            done += 1
            if time.perf_counter() - t0 > limit:
                break
        seconds = time.perf_counter() - t0
    finally:
        stop.set()
        for th in threads:
            th.join()
        sys.setswitchinterval(before)
    out = {"cycles": done, "seconds": seconds, "scrapers": scrapers,
           "switch_interval_s": switch if switch is not None else before,
           "scrapes": next(scrapes),
           "binding_log_sha256": sim.run_report().binding_log_sha256}
    rounds1 = _round_counts()
    out["plain_rounds"], out["plain_pods"], out["kernel_launches"] = (
        b - a for a, b in zip(rounds0, rounds1))
    if counter is not None:
        out["torch_calls"] = counter.n
        out["torch_calls_per_cycle"] = calls
        out["torch_calls_by_route"] = dict(counter.by_route)
        out["torch_calls_by_route_per_cycle"] = routes
    return out


def reference_case(device, cycles: int = CYCLES) -> dict:
    """tests/test_koordwatch.py TestObsSurfaces.
    test_concurrent_scrapes_during_churn, its body on ``device``: the
    checks' verdicts, the wall seconds of the cycles, the scrapes served,
    kernel 1's launches and the binding log's SHA-256."""
    from koordinator_tpu_torch.obs.server import ObsServer
    from koordinator_tpu_torch.obs.slo import (
        load_bundle as load_slo_bundle,
    )
    from koordinator_tpu_torch.obs.timeline import (
        load_bundle as load_timeline_bundle,
    )
    from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics

    sim = _simulator(cycles, device)
    srv = ObsServer(scheduler_metrics.REGISTRY, sim.sched.tracer,
                    health_provider=sim.sched.health_snapshot,
                    flight=sim.sched.flight,
                    timeline=sim.sched.timeline, slo=sim.slo)
    stop = threading.Event()
    errors = []
    scrapes = {"n": 0}

    def scraper(path):
        while not stop.is_set():
            try:
                status, _, body = srv.handle(path)
                assert status == 200, (path, status)
                if path == "/metrics":
                    assert ("# TYPE koord_scheduler_cycle_seconds "
                            "histogram") in body
                elif path == "/debug/timeline":
                    assert load_timeline_bundle(
                        body.splitlines())[2] == []
                elif path == "/debug/slo":
                    assert load_slo_bundle(
                        body.splitlines())[2] == []
                elif path == "/healthz":
                    json.loads(body)
                scrapes["n"] += 1
            except Exception as exc:  # surfaced via the errors list
                errors.append(f"{path}: {type(exc).__name__}: {exc}")
                return

    threads = [threading.Thread(target=scraper, args=(p,))
               for p in PATHS]
    rounds0 = _round_counts()
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    try:
        for cycle in range(cycles):
            sim._run_one_cycle(cycle)
    finally:
        seconds = time.perf_counter() - t0
        stop.set()
        for th in threads:
            th.join(timeout=30)
    rounds1 = _round_counts()
    report = sim.run_report()
    return {"cycles": cycles, "seconds": seconds, "scrapers": len(threads),
            "scrapes": scrapes["n"], "errors": errors,
            "threads_alive": sum(th.is_alive() for th in threads),
            "invariant_breaches": list(report.invariant_breaches),
            "binding_log_sha256": report.binding_log_sha256,
            "kernel_launches": rounds1[2] - rounds0[2],
            "plain_rounds": rounds1[0] - rounds0[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scrape_convoy")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--limit", type=float, default=300.0)
    ap.add_argument("--reference", action="store_true",
                    help="run the reference case's body instead")
    args = ap.parse_args(argv)
    if args.reference:
        rep = reference_case(args.device)
        print(json.dumps({"run": "reference", **rep}), flush=True)
        return 0 if (not rep["errors"] and rep["scrapes"] > 0
                     and not rep["invariant_breaches"]) else 1
    runs = (("alone_torch_calls", dict(scrapers=0, count=True)),
            ("alone", dict(scrapers=0)),
            ("spinning", dict(scrapers=len(PATHS))),
            ("spinning_fast_switch", dict(scrapers=len(PATHS),
                                          switch=FAST_SWITCH_S)))
    for name, kw in runs:
        rep = run(CYCLES, limit=args.limit, device=args.device, **kw)
        print(json.dumps({"run": name, **rep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
