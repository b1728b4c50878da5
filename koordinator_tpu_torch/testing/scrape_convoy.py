"""The churn loop under spinning in-process scrapers: how much of its
slowdown the interpreter's lock (the GIL) explains.

    python3 -m koordinator_tpu_torch.testing.scrape_convoy --device cpu \
        [--limit 300]

Runs the sim's ``smoke`` scenario's churn cycles (the loop of the JAX
package's tests/test_koordwatch.py concurrent-scrape case) three ways,
each in a fresh ChurnSimulator on its own ObsServer:

* ``alone``: no scraper; the cycles' wall seconds, and the torch calls
  they make, in all and per cycle (a TorchFunctionMode count, a run of
  its own): every torch call releases the GIL around its dispatch and
  must take it back;
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


class _CountCalls(torch.overrides.TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


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
    counter = _CountCalls() if count else None
    calls = []
    done = 0
    try:
        for th in threads:
            th.start()
        t0 = time.perf_counter()
        for cycle in range(cycles):
            if counter is None:
                sim._run_one_cycle(cycle)
            else:
                with counter:
                    sim._run_one_cycle(cycle)
                calls.append(counter.n - sum(calls))
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
           "scrapes": next(scrapes)}
    if counter is not None:
        out["torch_calls"] = counter.n
        out["torch_calls_per_cycle"] = calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scrape_convoy")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--limit", type=float, default=300.0)
    args = ap.parse_args(argv)
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
