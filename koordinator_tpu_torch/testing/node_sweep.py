"""Time both CUDA kernels on one card as the node count grows.

    python3 -m koordinator_tpu_torch.testing.node_sweep

Each kernel runs a block of 1024 threads, each owning nodes n = tid (mod
1024), so its per-pod time is a fixed chain (staging, quota, barriers,
argmax) plus a part per node a thread owns. This sweep packs the 10000 pods
of each kernel's main path against 1000, 2000 and 5000 nodes (padded to
1024, 2048 and 5120: one, two and five nodes per thread): BASELINE config
4's (synth_full_cluster(nodes, 10000, seed=42, num_quotas=100,
num_gangs=200)) for the full-chain kernel and bench.py's default chain's
(synth_cluster(nodes, 10000, seed=42)) for the LoadAware kernel. It times
one kernel round on each (CUDA events, median of 10 after a warm-up) and
fits per-pod time = fixed + per_node x (nodes per thread) by least squares.
It prints one JSON line per cluster and kernel, then each kernel's fit,
then the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from koordinator_tpu_torch.models.convert import (
    schedule_inputs_from_numpy,
    to_device,
)
from koordinator_tpu_torch.models.full_chain import (
    resolve_balance_idx,
    resolve_weight_idx,
)
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import schedule_kernel as sk
from koordinator_tpu_torch.ops.kernel_common import build_libraries
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing.synth import (
    loadaware_inputs,
    synth_cluster,
    synth_full_cluster,
)

NODES = (1000, 2000, 5000)
PODS = 10000
REPS = 10
THREADS = 1024  # the kernel's block size


def time_round(run) -> float:
    """Median milliseconds of one kernel round over REPS after a warm-up."""
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def full_chain_run(nodes, args):
    """(P, N, round) for the full-chain kernel at ``nodes`` nodes."""
    _cluster, state = synth_full_cluster(
        nodes, PODS, seed=42, num_quotas=PODS // 100, num_gangs=PODS // 50)
    fc, _p, _n, _t, _gi, _ng, _ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    dev_fc = to_device(fc, "cuda")
    wi, bi = resolve_weight_idx(args, active), resolve_balance_idx(active)
    return (fc.base.fit_requests.shape[0], fc.base.allocatable.shape[0],
            lambda: fck.full_chain_round(dev_fc, wi, False, bi))


def loadaware_run(nodes, args):
    """(P, N, round) for the LoadAware kernel at ``nodes`` nodes."""
    cluster = synth_cluster(num_nodes=nodes, num_pods=PODS, seed=42)
    inputs = schedule_inputs_from_numpy(
        loadaware_inputs(cluster, args)._asdict(), "cuda")
    wi = resolve_weight_idx(args)
    return (inputs.fit_requests.shape[0], inputs.allocatable.shape[0],
            lambda: sk.schedule_round(inputs, wi, False))


def main() -> int:
    if not torch.cuda.is_available():
        print("node_sweep: CUDA is not available", file=sys.stderr)
        return 2
    args = LoadAwareArgs()
    build_libraries(fck.SOURCE, sk.SOURCE)
    for kernel, make_run in (("full_chain", full_chain_run),
                             ("schedule_step", loadaware_run)):
        per_node, per_pod = [], []
        for nodes in NODES:
            P, N, run = make_run(nodes, args)
            ms = time_round(run)
            per_node.append(N / THREADS)
            per_pod.append(ms * 1e3 / P)
            print(json.dumps({"kernel": kernel, "nodes": nodes, "P": int(P),
                              "N": int(N), "kernel_ms": ms,
                              "us_per_pod": per_pod[-1]}), flush=True)
        slope, fixed = np.polyfit(per_node, per_pod, 1)
        print(json.dumps({"kernel": kernel,
                          "fit_fixed_us_per_pod": float(fixed),
                          "fit_us_per_node_per_thread": float(slope)}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
