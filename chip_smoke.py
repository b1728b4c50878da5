"""Drive the port's scheduling rounds on one NVIDIA H100 and check them.

    python3 chip_smoke.py    # 10240 pods x 5120 nodes, one card

Phases, one JSON line each:
  device  the card (nvidia-smi name and power limit), torch and CUDA
          versions; builds both CUDA kernels from koordinator_tpu_torch/csrc/
          with nvcc, one process per source started together, and times the
          build.
  main    BASELINE config 4 (synth_full_cluster(5000, 10000, seed=42,
          num_quotas=100, num_gangs=200), bucket-padded to 5120 nodes x
          10240 pods): host pack -> active-axis reduction ->
          SidecarServer.schedule_batch on CUDA, with the launch counts read
          around that call; a second, warm call split into its layers
          (upload, round, Permit, readback; host clock, synchronised
          between them); then the full-chain kernel's time (CUDA events,
          median of repeated rounds after a warm-up) and the plain torch
          round on the card over the same inputs, which must give the same
          bindings.
  main_global  the same kernel with its carried state in device memory
          (smem_budget_bytes=0), against the plain round of `main`.
  mixed   mixed_cluster at 1000 nodes x 2000 pods (affinity, spread,
          preferred node/pod affinity, ports, images, CSI volume groups,
          taints): kernel against the plain round.
  prod    the mixed cluster with score_according_prod_usage: kernel against
          the plain round.
  loadaware  the LoadAware-only round of bench.py's default chain
          (synth_cluster(5000, 10000, seed=42), padded to 10240 pods x 5120
          nodes x 14 axes): pack -> make_inputs -> build_best_schedule_step
          on CUDA, with the launch counts read around that call; then the
          LoadAware kernel's time, the plain torch round on the card (same
          bindings, requested within 1e-4) and the numpy oracle
          serial_schedule on the first 200 pods (same bindings).
  loadaware_prod  the same with score_according_prod_usage.
  loadaware_global  the LoadAware kernel with its carried state in device
          memory (smem_budget_bytes=0), against the plain round of
          `loadaware`.
  generic both kernels with a third weighted axis (cpu, memory and pods),
          which takes their generic instances instead of the ones
          specialised for the common shape (3 axes, 2 zones, 2 weights):
          the full chain on the mixed cluster and the LoadAware round on
          synth_cluster(1000, 2000, seed=7), each in both states against
          its plain round.
Each kernel's phase line names the launch: the state it kept (smem or
global), the instance (common or generic), cluster_size, block_threads and
smem_bytes_per_block. Every phase holds the kernel's bindings and outputs
equal to the plain round's: 0 mismatches and max |err| 0.0. Then the
kernels line, the card line, and the result line. Any failure raises: the
script exits non-zero and prints no result. It imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import ResourceName
from koordinator_tpu_torch.models.convert import (
    schedule_inputs_from_numpy,
    to_device,
)
from koordinator_tpu_torch.models.full_chain import (
    build_full_chain_step,
    resolve_balance_idx,
    resolve_weight_idx,
)
from koordinator_tpu_torch.models.scheduler_model import (
    build_best_schedule_step,
    build_schedule_step,
)
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import schedule_kernel as sk
from koordinator_tpu_torch.ops.kernel_common import BUILD_LOG, build_libraries
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.parity import serial_schedule
from koordinator_tpu_torch.scheduler.sidecar import SidecarServer
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing import (
    loadaware_inputs,
    mixed_cluster,
    synth_cluster,
    synth_full_cluster,
)

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPS = 10  # timed rounds after the warm-up
ORACLE_PODS = 200  # bench.py's --serial-sample default


def round_ops(fc, W: int, balanced: bool) -> int:
    """f32 operations of one round on these inputs, counted from
    csrc/full_chain.cu for R resource axes, K zones and W weighted axes.
    Every (pod, node) pair: Fit 2R, LoadAware and NUMA least-allocated
    2W x 5 plus two weighted sums 2W x 2 and two divides, balanced
    allocation 10 where both its axes are active, score sum 3. Each (cpuset
    pod, node) pair adds the SMT and capacity test, 5; each (NUMA pod, node)
    pair adds the zone fits 2KR and zone totals (K-1)R."""
    P, R = fc.base.fit_requests.shape
    N = fc.base.allocatable.shape[0]
    K = fc.numa_free.shape[1]
    per_pair = 2 * R + 14 * W + 2 + (10 if balanced else 0) + 3
    n_bind = int(fc.needs_bind.sum())
    n_numa = int(fc.needs_numa.sum())
    return N * (P * per_pair + n_bind * 5 + n_numa * (3 * K - 1) * R)


def loadaware_ops(inputs, W: int) -> int:
    """f32 operations of one LoadAware round on these inputs, counted from
    csrc/schedule_step.cu. Every (valid pod, node) pair: Fit 2 per axis the
    pod requests (add, compare), 10 per weighted axis (term + delta, + est,
    the least-requested guard, subtract, multiply, divide, floor, weight,
    sum), 5 for the final divide and floor, the two selects and the argmax
    compare. Padded pods are skipped by the kernel and not counted."""
    fit_req = inputs.fit_requests.cpu().numpy()
    valid = inputs.pod_valid.cpu().numpy().astype(bool)
    N = inputs.allocatable.shape[0]
    fit_axes = int((fit_req[valid] > 0).sum())
    return N * (2 * fit_axes + int(valid.sum()) * (10 * W + 5))


def launch_fields(module):
    """The last launch of a kernel wrapper, for a phase line."""
    return {k: module.last_launch[k] for k in (
        "state", "instance", "cluster_size", "block_threads",
        "smem_bytes_per_block")}


def run_loadaware(tag, args, n_nodes, n_pods, device):
    """The LoadAware-only round through its entry point on the card, then
    the kernel's time, the plain round on the card and the oracle on the
    first ORACLE_PODS pods. Returns the kernels-line entry and the inputs
    and plain outputs, for the device-memory phase."""
    t0 = time.perf_counter()
    inputs = loadaware_inputs(
        synth_cluster(num_nodes=n_nodes, num_pods=n_pods, seed=42), args)
    pack_s = time.perf_counter() - t0
    # the oracle orders its f32 additions differently (it adds each
    # estimate into the term in place); the forms agree where the values
    # the round adds are integers below 2^24, so name those that are not
    non_integer = [f for f in ("fit_requests", "estimated", "allocatable",
                               "requested", "la_term_nonprod", "la_term_prod")
                   if not (np.all(np.floor(getattr(inputs, f))
                                  == getattr(inputs, f))
                           and np.abs(getattr(inputs, f)).max() < 2**24)]

    step = build_best_schedule_step(args, device=device)
    fck.launches = sk.launches = 0
    t0 = time.perf_counter()
    chosen, requested = step(inputs)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = {"schedule_step": sk.launches, "full_chain": fck.launches}
    launch = launch_fields(sk)
    if step.last_backend != "cuda" or launches["schedule_step"] < 1:
        raise AssertionError(
            f"{tag} did not run the kernel (backend {step.last_backend}, "
            f"launches {launches})")
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    if chosen.shape != (P,) or requested.shape != (N, R):
        raise AssertionError(f"{tag}: unexpected output shapes")

    dev_inputs = schedule_inputs_from_numpy(inputs._asdict(), device)
    widx = resolve_weight_idx(args)
    prod = args.score_according_prod_usage
    kernel_ms = time_cuda(lambda: sk.schedule_round(dev_inputs, widx, prod),
                          REPS)
    plain = build_schedule_step(args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = plain(dev_inputs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    chosen_k, req_k = chosen.cpu().numpy(), requested.cpu().numpy()
    chosen_p, req_p = (x.cpu().numpy() for x in out_p)
    if not np.isfinite(req_k).all():
        raise AssertionError(f"{tag}: non-finite requested")
    if not ((chosen_k >= -1) & (chosen_k < N)).all():
        raise AssertionError(f"{tag}: chosen out of range")
    mism = int((chosen_k != chosen_p).sum())
    err = float(np.abs(req_k - req_p).max())
    if mism or err != 0.0:
        raise AssertionError(
            f"{tag}: kernel disagrees with plain round: {mism} bindings "
            f"differ, max |err| {err}")

    # the oracle on the queue's first pods: the round is serial, so their
    # picks do not depend on the pods after them
    k = min(ORACLE_PODS, P)
    head = inputs._replace(**{
        f: np.asarray(getattr(inputs, f))[:k] for f in (
            "fit_requests", "estimated", "is_prod", "is_daemonset",
            "pod_valid")})
    t0 = time.perf_counter()
    chosen_o = serial_schedule(head, args)
    oracle_s = time.perf_counter() - t0
    oracle_mism = int((chosen_o != chosen_k[:k]).sum())
    if oracle_mism:
        raise AssertionError(
            f"{tag}: kernel disagrees with the oracle on {oracle_mism} of "
            f"the first {k} pods")

    in_bytes = sum(t.numel() * t.element_size() for t in dev_inputs)
    nbytes = in_bytes + P * 4 + N * R * 4
    ops = loadaware_ops(dev_inputs, len(widx))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    emit({"phase": tag, "nodes": n_nodes, "pods": n_pods, "P": int(P),
          "N": int(N), "R": int(R), "W": len(widx), "prod_mode": prod,
          **launch,
          "pack_seconds": round(pack_s, 3),
          "entry_point_seconds": round(call_s, 3),
          "pods_bound": int((chosen_k >= 0).sum()), "launches": launches,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "plain_compared_pods": int(P), "mismatches": mism,
          "max_abs_err": err, "oracle_pods": k,
          "oracle_seconds": round(oracle_s, 3),
          "oracle_mismatches": oracle_mism, "non_integer": non_integer,
          "input_bytes": int(in_bytes), "ops": ops,
          "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms})
    return (kernel_entry("schedule_step_round", "schedule_step.cu",
                         "koordinator_tpu/ops/pallas_step.py:46",
                         launches["schedule_step"], mism, err, kernel_ms,
                         plain_ms, bytes_ms, ops_ms),
            (inputs, out_p))


def run_loadaware_global(args, inputs, out_p, device):
    """The LoadAware kernel with its carried state in device memory, through
    the entry point, against the plain round already computed."""
    step = build_best_schedule_step(args, device=device, smem_budget_bytes=0)
    sk.launches = 0
    chosen, requested = step(inputs)
    torch.cuda.synchronize()
    if step.last_state != "global" or sk.launches != 1:
        raise AssertionError(f"loadaware_global ran state {step.last_state} "
                             f"with {sk.launches} launches")
    launch = launch_fields(sk)
    dev_inputs = schedule_inputs_from_numpy(inputs._asdict(), device)
    widx = resolve_weight_idx(args)
    kernel_ms = time_cuda(lambda: sk.schedule_round(
        dev_inputs, widx, args.score_according_prod_usage,
        smem_budget_bytes=0), REPS)
    mism = int((chosen != out_p[0]).sum())
    err = float((requested - out_p[1]).abs().max())
    if mism or err != 0.0:
        raise AssertionError(
            f"loadaware_global: kernel disagrees with plain round: {mism} "
            f"bindings differ, max |err| {err}")
    emit({"phase": "loadaware_global", **launch, "launches": 1,
          "kernel_ms": kernel_ms, "mismatches": mism, "max_abs_err": err})


def run_generic(device):
    """Both kernels' generic instances (three weighted axes) in both
    states, each against its plain round on the card."""
    args = LoadAwareArgs(resource_weights={
        ResourceName.CPU: 1, ResourceName.MEMORY: 1, ResourceName.PODS: 1})
    _c, state = mixed_cluster(7, 1000, 2000)
    fc, ng, ngroups, active = pack(state, args)
    dev_fc = to_device(fc, device)
    out_p = build_full_chain_step(args, ng, ngroups, active)(dev_fc)
    N = fc.base.allocatable.shape[0]
    inputs = loadaware_inputs(
        synth_cluster(num_nodes=1000, num_pods=2000, seed=7), args)
    dev_inputs = schedule_inputs_from_numpy(inputs._asdict(), device)
    la_p = build_schedule_step(args)(dev_inputs)
    for budget in (None, 0):
        step = fck.build_cuda_full_chain_step(args, ng, ngroups, active,
                                              smem_budget_bytes=budget)
        mism, err = compare("generic", step(dev_fc), out_p, N)
        la = build_best_schedule_step(args, device=device,
                                      smem_budget_bytes=budget)
        chosen, requested = la(inputs)
        la_mism = int((chosen != la_p[0]).sum())
        la_err = float((requested - la_p[1]).abs().max())
        if la_mism or la_err != 0.0:
            raise AssertionError(
                f"generic: LoadAware kernel disagrees with plain round: "
                f"{la_mism} bindings differ, max |err| {la_err}")
        if (fck.last_launch["instance"], sk.last_launch["instance"]) != (
                "generic", "generic"):
            raise AssertionError("generic: a specialised instance ran")
        emit({"phase": "generic", "W": 3, "full_chain": launch_fields(fck),
              "schedule_step": launch_fields(sk), "mismatches": mism,
              "max_abs_err": err, "loadaware_mismatches": la_mism,
              "loadaware_max_abs_err": la_err})


def kernel_entry(name, source, replaces, launches, mism, err, ms, plain_ms,
                 bytes_ms, ops_ms):
    """One kernel's entry of the kernels line. No PyTorch call computes
    either serial round, so library_ms is null."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"koordinator_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "mismatches": mism,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def tensor_bytes(fc) -> int:
    n = sum(t.numel() * t.element_size() for t in fc.base)
    return n + sum(t.numel() * t.element_size() for t in fc[1:])


def compare(tag, kernel_out, plain_out, n_nodes):
    """Kernel vs plain on the same inputs: chosen bit-identical and
    requested/quota_used equal (max |err| 0.0): the kernel repeats the
    plain round's f32 operations in order."""
    chosen_k, req_k, q_k = (x.cpu().numpy() for x in kernel_out)
    chosen_p, req_p, q_p = (x.cpu().numpy() for x in plain_out)
    for name, arr in (("requested", req_k), ("quota_used", q_k)):
        if not np.isfinite(arr).all():
            raise AssertionError(f"{tag}: non-finite {name}")
    if not ((chosen_k >= -1) & (chosen_k < n_nodes)).all():
        raise AssertionError(f"{tag}: chosen out of range")
    mismatches = int((chosen_k != chosen_p).sum())
    err = float(max(np.abs(req_k - req_p).max(), np.abs(q_k - q_p).max()))
    if mismatches or err != 0.0:
        raise AssertionError(
            f"{tag}: kernel disagrees with plain round: {mismatches} "
            f"bindings differ, max |err| {err}")
    return mismatches, err


def time_cuda(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after a warm-up,
    each run bracketed by CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def pack(state, args):
    fc, _pods, _nodes, _tree, _gi, ng, ngroups = build_full_chain_inputs(
        state, args)
    fc, active = reduce_to_active_axes(fc)
    return fc, ng, ngroups, active


def run_pair(tag, state, args, device):
    """Kernel and plain round over one cluster on the card."""
    fc, ng, ngroups, active = pack(state, args)
    dev_fc = to_device(fc, device)
    kern = fck.build_cuda_full_chain_step(args, ng, ngroups, active)
    plain = build_full_chain_step(args, ng, ngroups, active)
    out_k = kern(dev_fc)
    launch = launch_fields(fck)
    out_p = plain(dev_fc)
    torch.cuda.synchronize()
    mism, err = compare(tag, out_k, out_p, fc.base.allocatable.shape[0])
    dims = dict(P=int(fc.base.fit_requests.shape[0]),
                N=int(fc.base.allocatable.shape[0]),
                R=int(fc.base.fit_requests.shape[1]),
                K=int(fc.numa_free.shape[1]), T=int(fc.aff_dom.shape[1]),
                S=int(fc.pref_scores.shape[1]),
                S2=int(fc.ppref_w.shape[0]) if fc.aff_dom.shape[1] else 0,
                PT=int(fc.port_used.shape[1]),
                SI=int(fc.img_scores.shape[1]),
                VG=int(fc.vol_needed.shape[1]))
    emit({"phase": tag, **dims, **launch,
          "prod_mode": args.score_according_prod_usage,
          "pods_bound": int((out_k[0] >= 0).sum().item()),
          "mismatches": mism, "max_abs_err": err})
    return dims


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    # ---- device + build: one nvcc per kernel source, all at once
    t0 = time.perf_counter()
    build_libraries(fck.SOURCE, sk.SOURCE)
    build_s = time.perf_counter() - t0
    ptxas = {stem: [ln.strip() for ln in str(log["ptxas"]).splitlines()
                    if "registers" in ln or "spill" in ln]
             for stem, log in BUILD_LOG.items()}
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "build_seconds": round(build_s, 3),
          "build_seconds_each": {stem: round(log["seconds"], 3)
                                 for stem, log in BUILD_LOG.items()},
          "ptxas": ptxas})

    # ---- main path: BASELINE config 4 through the sidecar entry point
    n_nodes, n_pods = 5000, 10000
    args = LoadAwareArgs()
    t0 = time.perf_counter()
    _cluster, state = synth_full_cluster(
        n_nodes, n_pods, seed=42, num_quotas=max(n_pods // 100, 1),
        num_gangs=n_pods // 50)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc, ng, ngroups, active = pack(state, args)
    pack_s = time.perf_counter() - t0
    server = SidecarServer(device=device)
    fck.launches = sk.launches = 0
    t0 = time.perf_counter()
    chosen, requested, quota_used = server.schedule_batch(
        fc, args, ng, ngroups, active)
    call_s = time.perf_counter() - t0
    main_launches = fck.launches
    launches = {"full_chain": fck.launches, "schedule_step": sk.launches}
    launch = launch_fields(fck)
    if server.last_backend != "cuda" or main_launches < 1:
        raise AssertionError(
            f"main path did not run the kernel (backend "
            f"{server.last_backend}, launches {launches})")
    P, R = fc.base.fit_requests.shape
    N = fc.base.allocatable.shape[0]
    if chosen.shape != (P,) or requested.shape != (N, R):
        raise AssertionError("unexpected output shapes")
    if not (np.isfinite(requested).all() and np.isfinite(quota_used).all()):
        raise AssertionError("non-finite outputs")

    # the warm call, split into its layers
    warm = {}
    t0 = time.perf_counter()
    warm_out = server.schedule_batch(fc, args, ng, ngroups, active,
                                     timings=warm)
    warm["total"] = time.perf_counter() - t0
    if any((a != b).any() for a, b in zip(warm_out, (chosen, requested,
                                                     quota_used))):
        raise AssertionError("the warm call changed the bindings")

    dev_fc = to_device(fc, device)
    wi, bi = resolve_weight_idx(args, active), resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    kernel_ms = time_cuda(lambda: fck.full_chain_round(dev_fc, wi, prod, bi),
                          REPS)
    plain = build_full_chain_step(args, ng, ngroups, active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = plain(dev_fc)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out_k = tuple(torch.from_numpy(x) for x in (chosen, requested,
                                                 quota_used))
    mism, err = compare("main", out_k, out_p, N)
    K = fc.numa_free.shape[1]
    G = fc.quota_used.shape[0]
    nbytes = tensor_bytes(dev_fc) + P * 4 + N * R * 4 + G * R * 4
    ops = round_ops(dev_fc, len(wi), bi[0] >= 0)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    emit({"phase": "main", "nodes": n_nodes, "pods": n_pods, "P": int(P),
          "N": int(N), "R": int(R), "K": int(K), "G": int(G),
          "T": int(fc.aff_dom.shape[1]), "VG": int(fc.vol_needed.shape[1]),
          "input_bytes": int(tensor_bytes(dev_fc)),
          "synth_seconds": round(synth_s, 3), "pack_seconds": round(pack_s, 3),
          "schedule_batch_seconds": round(call_s, 3),
          "warm_call_seconds": {k: round(v, 6) for k, v in warm.items()},
          **launch,
          "pods_bound": int((chosen >= 0).sum()), "launches": launches,
          "kernel_ms": kernel_ms,
          "plain_ms": plain_ms,
          "plain_compared_pods": int(P), "mismatches": mism,
          "max_abs_err": err, "ops": ops, "bound_bytes_ms": bytes_ms,
          "bound_ops_ms": ops_ms})

    # ---- the same kernel with its carried state in device memory
    glob = fck.build_cuda_full_chain_step(args, ng, ngroups, active,
                                          smem_budget_bytes=0)
    fck.launches = 0
    out_g = glob(dev_fc)
    torch.cuda.synchronize()
    if glob.last_state != "global" or fck.launches != 1:
        raise AssertionError(f"main_global ran state {glob.last_state} with "
                             f"{fck.launches} launches")
    launch_g = launch_fields(fck)
    g_mism, g_err = compare("main_global", out_g, out_p, N)
    global_ms = time_cuda(lambda: fck.full_chain_round(
        dev_fc, wi, prod, bi, smem_budget_bytes=0), REPS)
    emit({"phase": "main_global", **launch_g, "launches": 1,
          "kernel_ms": global_ms, "mismatches": g_mism,
          "max_abs_err": g_err})

    # ---- mixed features, then prod mode, kernel against the plain round
    m_nodes, m_pods = 1000, 2000
    _c, mstate = mixed_cluster(7, m_nodes, m_pods)
    dims = run_pair("mixed", mstate, LoadAwareArgs(), device)
    for key in ("T", "S", "S2", "PT", "SI"):
        if dims[key] <= 0:
            raise AssertionError(f"mixed cluster left {key} == 0")
    if dims["VG"] <= 1:
        raise AssertionError("mixed cluster has a single volume group")
    _c, pstate = mixed_cluster(7, m_nodes, m_pods)
    run_pair("prod", pstate, LoadAwareArgs(score_according_prod_usage=True),
             device)

    # ---- the LoadAware-only round, default args and prod mode
    la_kernel, (la_inputs, la_plain) = run_loadaware(
        "loadaware", LoadAwareArgs(), n_nodes, n_pods, device)
    run_loadaware("loadaware_prod",
                  LoadAwareArgs(score_according_prod_usage=True), n_nodes,
                  n_pods, device)
    run_loadaware_global(LoadAwareArgs(), la_inputs, la_plain, device)
    run_generic(device)

    emit({"kernels": [
        kernel_entry("full_chain_round", "full_chain.cu",
                     "koordinator_tpu/ops/pallas_full_chain.py:90",
                     main_launches, mism, err, kernel_ms, plain_ms, bytes_ms,
                     ops_ms),
        la_kernel]})
    print(card, flush=True)
    # count: the cards this script drives
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
