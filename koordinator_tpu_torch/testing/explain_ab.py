"""The stage-count pass on one card: what each piece of its kernel costs,
and what running it beside the round does to the cycle.

    python3 -m koordinator_tpu_torch.testing.explain_ab [--cycles N]

(1) pieces: the kernel's device time (torch.profiler, as
testing/kernel_ab.kernel_device_ms) at config 4 (P = 10240) and at the
churn wave's P = 1280, for csrc/explain_counts.cu as it is and for copies
of the sources built under build/explain_variants/ with one piece changed:
the pods dealt to the threads in record order instead of by branch
("record_order"), and, timed only (their counts are wrong), the cpuset
stage, the NUMA stage or the per-stage counting left out. Each variant is
held against the plain counts and reports its mismatches; two rounds, in
turn.

(2) the cycle: three Schedulers on churn_store(5000, 10000, seed=42) with
explain "counts" and the pass beside the round on the round's pack (the
shipped path, ``WaveBackend.round_counts``), with explain "counts" and the
pass before the round on a pack of its own (the order before, patched in
for this run), and with explain off; cycle 0, one warm-up churn cycle,
then ``--cycles`` churn cycles of 1000 arrivals, the three in turn (the
order flipped every cycle), Python's collector off, their bindings equal
every cycle. Prints each cycle's wall and span split and the medians.

One JSON line per measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from koordinator_tpu_torch.models import fused_waves as fw
from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import (
    cycle_start_state,
    explain_stage_counts,
)
from koordinator_tpu_torch.ops import explain_kernel as ek
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import kernel_common
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.cycle import Scheduler
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    churn_store,
)
from koordinator_tpu_torch.testing.kernel_ab import kernel_device_ms, pod_rows
from koordinator_tpu_torch.testing.synth import synth_full_cluster

VARIANT_DIR = Path(__file__).resolve().parents[2] / "build" / "explain_variants"
# name -> {source file: [(text, replacement)]}
VARIANTS = {
    "as_is": {},
    "record_order": {"explain_counts.cu": [
        ("(live ? order[tid] : 0)", "(live ? tid : 0)")]},
    "no_cpuset": {"filter_chain.cuh": [
        ("  if (pod.needs_bind) {\n    const float cpc",
         "  if (false) {\n    const float cpc")]},
    "no_numa": {"filter_chain.cuh": [
        ("  if (pod.needs_numa) {\n    int zone;",
         "  if (false) {\n    int zone;")]},
    "no_counting": {"explain_counts.cu": [
        ("          c[k] += (bad >> k) & 1u;",
         "          if (k == 0) c[0] += bad;")]},
}


def variant_trees() -> dict:
    """A copy of the package's csrc/ per variant, edited as VARIANTS says;
    raises where an edit no longer matches the source."""
    trees = {}
    for name, edits in VARIANTS.items():
        tree = VARIANT_DIR / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(kernel_common.CSRC_DIR, tree)
        for source, reps in edits.items():
            text = (tree / source).read_text()
            for old, new in reps:
                if old not in text:
                    raise RuntimeError(f"{name}: {source} no longer holds "
                                       f"{old!r}")
                text = text.replace(old, new)
            (tree / source).write_text(text)
        trees[name] = tree
    return trees


def pieces() -> None:
    _c, state = synth_full_cluster(5000, 10000, seed=42, num_quotas=100,
                                   num_gangs=200)
    fc, *_rest = build_full_chain_inputs(state, LoadAwareArgs())
    fc, _active = reduce_to_active_axes(fc)
    dev = to_device(fc, "cuda")
    wave = pod_rows(dev, 1280)
    runs = [(dev, cycle_start_state(dev)), (wave, cycle_start_state(wave))]
    want = [explain_stage_counts(f, s, 5000).to(torch.int64) for f, s in runs]
    print(json.dumps({"pods": int(dev.base.fit_requests.shape[0]),
                      "needs_bind": int(dev.needs_bind.sum()),
                      "needs_numa": int(dev.needs_numa.sum())}), flush=True)
    trees = variant_trees()
    csrc = kernel_common.CSRC_DIR
    try:
        for rnd in range(2):
            for name, tree in trees.items():
                kernel_common.CSRC_DIR = tree
                kernel_common._LIBS.clear()
                row = {"variant": name, "round": rnd}
                for (f, s), w, tag in zip(runs, want, ("P10240", "P1280")):
                    got = ek.explain_counts(f, s, 5000).to(torch.int64)
                    row[f"mismatches_{tag}"] = int((got != w).sum())
                    row[f"device_ms_{tag}"] = kernel_device_ms(
                        lambda: ek.explain_counts(f, s, 5000),
                        "explain_counts")
                print(json.dumps(row), flush=True)
    finally:
        kernel_common.CSRC_DIR = csrc
        kernel_common._LIBS.clear()


def _before_round(backend, fc_k, weight_idx, prod_mode, bal_idx, terms,
                  n_real):
    """The order before: the pass on a pack of its own, then the round."""
    counts = backend.counts(fc_k, cycle_start_state(fc_k), n_real)
    return backend.round(fc_k, weight_idx, prod_mode, bal_idx,
                         terms), counts


def _split(sched) -> dict:
    """Milliseconds per direct child span of the last cycle (summed by
    name) and of the cycle."""
    root = [r for r in sched.tracer.roots() if r.name == "cycle"][-1]
    out = {}
    for child in root.children:
        out[child.name] = out.get(child.name, 0.0) + (
            child.duration_seconds * 1e3)
    out["cycle"] = root.duration_seconds * 1e3
    return out


def cycles(measured: int) -> None:
    kinds = ("off", "beside", "before")
    worlds = {k: churn_store(5000, 10000, seed=42) for k in kinds}
    scheds = {k: Scheduler(worlds[k][0], device="cuda",
                           explain="off" if k == "off" else "counts")
              for k in kinds}
    now = worlds["off"][1].now
    shipped = fw.WaveBackend.round_counts
    walls = {k: [] for k in kinds}
    splits = {k: [] for k in kinds}
    try:
        for c in range(2 + measured):
            if c:
                specs = arrival_specs(c, 1000)
                for store, _s in worlds.values():
                    add_arrivals(store, specs, now + c)
            keys = {}
            for k in (kinds if c % 2 else kinds[::-1]):
                fw.WaveBackend.round_counts = (
                    _before_round if k == "before" else shipped)
                ek.self_packs = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = scheds[k].run_cycle(now=now + 2 * c)
                wall = (time.perf_counter() - t0) * 1e3
                keys[k] = [(b.pod_key, b.node_name) for b in res.bound]
                split = _split(scheds[k])
                if c >= 2:
                    walls[k].append(wall)
                    splits[k].append(split)
                print(json.dumps({"cycle": c, "kind": k, "ms": wall,
                                  "bound": len(res.bound),
                                  "waves": res.waves,
                                  "self_packs": ek.self_packs,
                                  "spans_ms": split}), flush=True)
            if not keys["off"] == keys["beside"] == keys["before"]:
                raise AssertionError(f"cycle {c}: the bindings differ")
    finally:
        fw.WaveBackend.round_counts = shipped
    print(json.dumps({k: {
        "median_ms": statistics.median(v), "all_ms": v,
        "median_spans_ms": {n: statistics.median(s.get(n, 0.0)
                                                  for s in splits[k])
                            for n in splits[k][0]}}
        for k, v in walls.items()}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("explain_ab: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cycles", type=int, default=12,
                    help="measured churn cycles")
    opts = ap.parse_args()
    gc.disable()
    kernel_common.build_libraries(fck.SOURCE, ek.SOURCE, fck.REPLAY_SOURCE)
    pieces()
    cycles(opts.cycles)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
