"""koordsim CLI: run named churn scenarios against the real scheduler.

    python -m koordinator_tpu_torch.sim --list
    python -m koordinator_tpu_torch.sim smoke                # on the card
    python -m koordinator_tpu_torch.sim smoke --device cpu
    python -m koordinator_tpu_torch.sim smoke --check-determinism

Exit codes: 0 clean; 1 invariant breaches above --max-breaches;
2 determinism check failed; 3 SLO missed under --enforce-slo;
4 usage error.
The SLO verdict is always REPORTED; it only fails the run when asked:
sim time keeps the binding log deterministic, and the same on the card
as on the CPU, but the wall clock differs between machines.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.sim",
        description="fault-injecting churn simulator for the koordinator "
                    "scheduler")
    ap.add_argument("scenario", nargs="?", help="scenario name (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list the scenario catalog and exit")
    ap.add_argument("--cycles", type=int, default=None,
                    help="override the scenario's cycle count")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the scenario's seed")
    ap.add_argument("--waves", default=None,
                    help="override the scenario's fused-wave depth "
                    "(int or 'auto')")
    ap.add_argument("--out", default=None,
                    help="write the SLO report JSON here (default: stdout "
                    "only)")
    ap.add_argument("--flight-dir", default=None,
                    help="land flight-recorder dumps as files here")
    ap.add_argument("--check-determinism", action="store_true",
                    help="run the scenario twice and require byte-identical "
                    "binding logs")
    ap.add_argument("--max-breaches", type=int, default=0,
                    help="fail (exit 1) when invariant breaches exceed this "
                    "(default 0)")
    ap.add_argument("--enforce-slo", action="store_true",
                    help="fail (exit 3) when the time-to-bind p99 misses "
                    "the scenario SLO")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the scheduler's rounds run (default cuda: "
                    "the CUDA kernels; cpu: their plain torch versions)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the progress line, print only the JSON")
    args = ap.parse_args(argv)

    from koordinator_tpu_torch.sim.scenarios import SCENARIOS

    if args.list or not args.scenario:
        for name, sc in SCENARIOS.items():
            print(f"{name:14s} {sc.cycles:5d} cycles, {sc.nodes} nodes — "
                  f"{sc.description}")
        return 0 if args.list else 4
    sc = SCENARIOS.get(args.scenario)
    if sc is None:
        print(f"unknown scenario {args.scenario!r}; --list shows the "
              "catalog", file=sys.stderr)
        return 4
    waves = args.waves
    if waves is not None and waves != "auto":
        try:
            waves = int(waves)
        except ValueError:
            print(f"--waves must be an int or 'auto', got {waves!r}",
                  file=sys.stderr)
            return 4
    sc = sc.resolved(cycles=args.cycles, seed=args.seed, waves=waves)

    from koordinator_tpu_torch.sim.harness import run_scenario

    def progress(msg: str) -> None:
        if not args.quiet:
            print(msg, file=sys.stderr)

    progress(f"[koordsim] scenario {sc.name}: {sc.cycles} cycles, "
             f"{sc.nodes} nodes, seed {sc.seed}, device {args.device}")
    report = run_scenario(sc, flight_dir=args.flight_dir,
                          device=args.device)
    payload = report.to_dict()
    progress(f"[koordsim] bound {report.pods_bound}/{report.pods_created} "
             f"pods, ttb p50/p99 {report.percentile(50):.1f}/"
             f"{report.percentile(99):.1f}s, "
             f"{len(report.invariant_breaches)} breaches, "
             f"{len(report.cycle_exceptions)} cycle exceptions, "
             f"final ladder level {report.final_level}, "
             f"{report.wall_seconds:.1f}s wall")

    if args.check_determinism:
        progress("[koordsim] determinism check: re-running with the same "
                 "seed")
        twin = run_scenario(sc, flight_dir=None, device=args.device)
        if twin.binding_log != report.binding_log:
            first = next(
                (i for i, (a, b) in enumerate(
                    zip(report.binding_log, twin.binding_log)) if a != b),
                min(len(report.binding_log), len(twin.binding_log)))
            print(f"binding logs DIVERGED at entry {first}: "
                  f"{len(report.binding_log)} vs {len(twin.binding_log)} "
                  "bindings", file=sys.stderr)
            return 2
        payload["determinism"] = {
            "checked": True,
            "binding_log_stable": True,
        }
        progress(f"[koordsim] binding log byte-stable "
                 f"({len(report.binding_log)} bindings, sha256 "
                 f"{report.binding_log_sha256[:16]}…)")

    body = json.dumps(payload, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(body + "\n")
        progress(f"[koordsim] report written to {args.out}")
    print(body)

    if len(report.invariant_breaches) > args.max_breaches:
        print(f"invariant breaches: {len(report.invariant_breaches)} > "
              f"--max-breaches {args.max_breaches}", file=sys.stderr)
        return 1
    if args.enforce_slo and report.ttb_seconds and (
            report.percentile(99) > sc.ttb_slo_seconds):
        print(f"SLO missed: ttb p99 {report.percentile(99):.1f}s > "
              f"{sc.ttb_slo_seconds}s", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
