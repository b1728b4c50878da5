"""Time both CUDA kernels on one card as the node count and the cluster
size change.

    python3 -m koordinator_tpu_torch.testing.node_sweep

Each kernel runs one cluster of C blocks; block b owns a slice of
Nb = ceil(N / C) nodes and each of its node threads the slice's nodes
j = t (mod node_threads) (ops/kernel_common.py cluster_plan). A pod's time
is a fixed chain (record wait, warp reductions, the cluster barrier, the
merge of every warp's partial, the commit) plus the node loop of the nodes
one thread owns.

Node sweep: the 10000 pods of each kernel's main path against 1000, 2000
and 5000 nodes (padded to 1024, 2048 and 5120) at C = 16: BASELINE config
4's (synth_full_cluster(nodes, 10000, seed=42, num_quotas=100,
num_gangs=200)) for the full-chain kernel and bench.py's default chain's
(synth_cluster(nodes, 10000, seed=42)) for the LoadAware kernel. Every
thread owns one node at all three sizes; what grows is the number of node
warps per block (2, 4, 10), so the fit per-pod time = fixed + slope x
(node warps per block) prices one more warp's partial in the merge.

Cluster sweep: the 5120-node cluster at C = 1, 2, 4, 8, 16, in the state
the selector picks and in device memory (smem_budget_bytes=0); the fit
per-pod time = fixed + per_node x (most nodes a thread owns) splits the
node loop from the rest.

Each point is one kernel round (CUDA events, median of 10 after a
warm-up). It prints one JSON line per point, then each fit, then the
card's nvidia-smi name and power limit.
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
from koordinator_tpu_torch.ops.kernel_common import (
    CLUSTER_SIZE,
    build_libraries,
    cluster_plan,
)
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
CLUSTERS = (1, 2, 4, 8, 16)
SWEEP_NODES = 5000  # padded to 5120
PODS = 10000
REPS = 10


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
    """(P, N, round(cluster_size, budget)) for the full-chain kernel."""
    _cluster, state = synth_full_cluster(
        nodes, PODS, seed=42, num_quotas=PODS // 100, num_gangs=PODS // 50)
    fc, _p, _n, _t, _gi, _ng, _ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    dev_fc = to_device(fc, "cuda")
    wi, bi = resolve_weight_idx(args, active), resolve_balance_idx(active)
    return (fc.base.fit_requests.shape[0], fc.base.allocatable.shape[0],
            lambda c, b: fck.full_chain_round(dev_fc, wi, False, bi,
                                              cluster_size=c,
                                              smem_budget_bytes=b))


def loadaware_run(nodes, args):
    """(P, N, round(cluster_size, budget)) for the LoadAware kernel."""
    cluster = synth_cluster(num_nodes=nodes, num_pods=PODS, seed=42)
    inputs = schedule_inputs_from_numpy(
        loadaware_inputs(cluster, args)._asdict(), "cuda")
    wi = resolve_weight_idx(args)
    return (inputs.fit_requests.shape[0], inputs.allocatable.shape[0],
            lambda c, b: sk.schedule_round(inputs, wi, False, cluster_size=c,
                                           smem_budget_bytes=b))


def point(kernel, module, sweep, P, N, run, cluster, budget):
    """Time one (cluster size, budget) point; returns its JSON record."""
    ms = time_round(lambda: run(cluster, budget))
    plan = cluster_plan(N, cluster)
    rec = {"kernel": kernel, "sweep": sweep, "P": int(P), "N": int(N),
           "cluster_size": cluster, "state": module.last_launch["state"],
           "block_threads": plan.block_threads,
           "node_warps": plan.node_threads // 32,
           "nodes_per_thread": -(-plan.nodes_per_block // plan.node_threads),
           "smem_bytes_per_block": module.last_launch["smem_bytes_per_block"],
           "kernel_ms": ms, "us_per_pod": ms * 1e3 / P}
    print(json.dumps(rec), flush=True)
    return rec


def fit(kernel, name, xs, recs):
    slope, fixed = np.polyfit(xs, [r["us_per_pod"] for r in recs], 1)
    print(json.dumps({"kernel": kernel, "fit": name,
                      "fixed_us_per_pod": float(fixed),
                      "slope_us_per_pod": float(slope)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("node_sweep: CUDA is not available", file=sys.stderr)
        return 2
    args = LoadAwareArgs()
    build_libraries(fck.SOURCE, sk.SOURCE)
    for kernel, module, make_run in (("full_chain", fck, full_chain_run),
                                     ("schedule_step", sk, loadaware_run)):
        recs = []
        for nodes in NODES:
            P, N, run = make_run(nodes, args)
            recs.append(point(kernel, module, "nodes", P, N, run,
                              CLUSTER_SIZE, None))
        fit(kernel, "per node warp", [r["node_warps"] for r in recs], recs)
        P, N, run = make_run(SWEEP_NODES, args)
        for budget, name in ((None, "cluster"), (0, "cluster_global")):
            recs = [point(kernel, module, name, P, N, run, c, budget)
                    for c in CLUSTERS]
            fit(kernel, f"{name}: per node per thread",
                [r["nodes_per_thread"] for r in recs], recs)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
