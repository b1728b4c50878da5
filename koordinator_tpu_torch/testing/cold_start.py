"""One scheduler process of a cold-start pair: config 4's churn store
through ``Scheduler(store)`` at its defaults (auto waves, chained
dispatch), cycle 0 then churn cycles of 1000 arrivals, with the warm-up
ladder as the environment sets it.

    # the cold process: records the rungs it builds, no warm-up
    KOORD_TPU_COMPILE_CACHE_DIR=/tmp/cc KOORD_TPU_WARMUP=off \\
        python3 -m koordinator_tpu_torch.testing.cold_start
    # the restart: replays them before its first cycle
    KOORD_TPU_COMPILE_CACHE_DIR=/tmp/cc KOORD_TPU_WARMUP=sync \\
        python3 -m koordinator_tpu_torch.testing.cold_start

Options: ``--nodes``/``--pods`` (5000 x 10000, config 4), ``--cycles``
(churn cycles after cycle 0, 2), ``--device`` (cuda; cpu runs the plain
versions). It prints one JSON line: the construction seconds (the warm-up
ladder included when it runs in sync), construction-to-first-bind wall
seconds, each cycle's wall, ``kernel`` spans, waves and a SHA-256 of its
ordered bindings, the warm-up stats, the step-cache misses counted in
steady state (the guard armed by a complete ladder), the rungs in the
index, and the full-chain kernel's launches.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time


def _bindings_sha(res) -> str:
    text = "\n".join(f"{b.pod_key}\t{b.node_name}" for b in res.bound)
    return hashlib.sha256(text.encode()).hexdigest()


def run(nodes: int, pods: int, cycles: int, device: str) -> dict:
    from koordinator_tpu_torch.ops import full_chain_kernel as fck
    from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
    from koordinator_tpu_torch.scheduler import warmup as wu
    from koordinator_tpu_torch.scheduler.cycle import Scheduler
    from koordinator_tpu_torch.testing.churn import (
        add_arrivals,
        arrival_specs,
        churn_store,
    )

    t0 = time.perf_counter()
    store, state = churn_store(nodes, pods, seed=42)
    fixture_s = time.perf_counter() - t0
    steady0 = scheduler_metrics.STEADY_STATE_COMPILES.get() or 0.0
    flagged = []
    fck.launches = fck.replay_launches = 0
    t_start = time.perf_counter()
    sched = Scheduler(store, device=device)
    construction_s = time.perf_counter() - t_start
    sched.compile_miss_hook = flagged.append
    first_bind_s = None
    out = []
    for c in range(cycles + 1):
        if c:
            add_arrivals(store, arrival_specs(c, pods // 10), state.now + c)
        t = time.perf_counter()
        res = sched.run_cycle(now=state.now + 2 * c)
        end = time.perf_counter()
        if first_bind_s is None and res.bound:
            first_bind_s = end - t_start
        root = [r for r in sched.tracer.roots() if r.name == "cycle"][-1]
        out.append({
            "bound": len(res.bound), "failed": len(res.failed),
            "waves": res.waves, "wall_s": end - t,
            "kernel_ms": [sp.duration_seconds * 1e3
                          for sp in root.find_all("kernel")],
            "bindings_sha256": _bindings_sha(res)})
    index = (wu.CompileCacheIndex(sched.compile_cache_dir).load()
             if sched.compile_cache_dir else {})
    return {
        "mode": sched._warmup_mode, "device": str(sched.device),
        "nodes": nodes, "pods": pods, "fixture_s": fixture_s,
        "construction_s": construction_s,
        "construction_to_first_bind_s": first_bind_s,
        "cycles": out,
        "warmup": (dict(sched.warmup.stats) if sched.warmup is not None
                   else None),
        "steady_state": sched._steady_state,
        "steady_state_compiles": len(flagged),
        "steady_state_compiles_metric":
            (scheduler_metrics.STEADY_STATE_COMPILES.get() or 0.0) - steady0,
        "index_rungs": sorted(e.get("kind", "") for e in index.values()),
        "launches": {"full_chain": fck.launches,
                     "full_chain_replay": fck.replay_launches},
        "last_backend": sched.last_backend,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cold_start")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=10000)
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(json.dumps(run(args.nodes, args.pods, args.cycles, args.device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
