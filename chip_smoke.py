"""Drive the port's scheduling rounds on one NVIDIA H100 and check them.

    python3 chip_smoke.py    # 10240 pods x 5120 nodes, one card

Phases, one JSON line each:
  device  the card (nvidia-smi name and power limit), torch and CUDA
          versions; builds both CUDA kernels from koordinator_tpu_torch/csrc/
          with nvcc, one process per source started together, and times the
          build.
  scheduler  BASELINE config 4 through the real scheduler cycle, in the shape
          of bench.py's run_churn: three stores from synth_full_cluster(5000,
          10000, seed=42, num_quotas=100, num_gangs=200), each driven by
          Scheduler(store, waves=1, device="cuda") — plain, under
          CyclePipeline, and with IncrementalSnapshot off (the full-rebuild
          twin) — through cycle 0 (cold, the first kernel call of the run)
          and 2 warm-up + 3 measured churn cycles of 1000 arrivals each. The
          twins' ordered bindings, failed and rejected lists must be
          identical every cycle, and every dispatch window must have
          launched the full-chain kernel exactly once (launch counts set to
          0 before each cycle and read after). Prints cycle 0's seconds and
          span split, the steady cycle's median, kernel and host ms and its
          median span split, the full-rebuild and pipelined twins' cycle ms,
          pods/s end to end, the mirror's and the pack cache's stats, the
          churn cycles' padded P and the kernel's time there. Then the
          twin's DeviceSnapshot must hand the round exactly what to_device
          gives (dtype and value, field by field), and a fresh one must
          scatter rows on the card into a clone while a round is in
          flight and in place after it.
  scheduler_waves  config 4 through the Scheduler's default path: waves
          "auto" (K = 8 at cycle 0's 10000 pending pods, 4 at the churn
          cycles' ~1126) with replay overlap on, the chained dispatch (each
          wave's evaluation in the full-chain kernel, its kept-only replay
          in the kernel's replay instance, the host replaying wave w while
          the card runs wave w+1). Three stores from churn_store(5000,
          10000, seed=42): (a) Scheduler(store, device="cuda") with its
          defaults, (b) the same with replay_overlap=False (all K waves in
          one call), (c) Scheduler(store, waves=1, device="cuda") running as
          many serial cycles as (a) consumed (CycleResult.waves), through
          cycle 0 and 1 warm-up + 3 measured churn cycles of 1000 arrivals.
          The concatenated bound sequences and failed/rejected lists must be
          identical every round, and the canonical dumps after a final flush.
          Prints the K each cycle resolved to, the device waves run and the
          per-wave bound counts and device ms, cycle ms and span splits of
          (a) and (b), both kernels' launches, and the replay instance alone
          at cycle 0's kept set (CUDA events, median of 10) against the
          plain replay_kept on the card, bit for bit, with its state in
          shared memory and again in device memory (smem_budget_bytes=0,
          the replay_global line).
  scheduler_waves_mixed  the mixed cluster (1000 x 2000) with default
          waves on the card and in a CPU twin (the plain wave step): the
          canonical dumps must be identical after each of 3 cycles. As
          mixed_cluster builds it, the world's shared claims overflow the
          volume-group budget and the cycle demotes to serial dispatch
          (claim-entangled, checked first), so the twins keep the shared
          claims of 8 pending pods and drop the others' claims.
  waves_carried  scheduler/pipeline_parity.run_carried_state_parity on the
          card for the reservation, claim, prod-usage and transformer
          worlds: each must report ok and a fused dispatch that ran more
          than one wave. Also the shared memory a config-4 launch takes
          with a claim world's [P, N] volume view.
  ladder  the degradation ladder at config 4: two stores from
          churn_store(5000, 10000, seed=42), each through Scheduler(store,
          device="cuda") at its defaults for cycle 0 and 10 churn cycles of
          1000 arrivals; (a) with a FaultPlan on its three hooks, a 2 s
          dispatch deadline and a ladder that promotes after 2 clean
          cycles, (b) unfaulted. One dispatch fault, one upload OOM and one
          4 s readback each retry at full, and (a) must equal (b) through
          them; then a fault storm demotes full -> serial-waves (the fused
          window's pass re-runs serially) -> host-fallback, and clean
          cycles promote back -> serial-waves -> full. The store
          invariants (sim/invariants) hold after every cycle, the host
          fallback binds no gang or quota pod, the retries per stage and
          the level after each cycle are as planned, and kernel 1 launches
          again once the ladder is above the host fallback. Prints the
          transitions, each cycle's ms and level beside (b)'s, and the
          host-fallback pass's seconds.
  sim     the sim's smoke (50 cycles), gang-storm (300), spot-churn (300)
          and crash-restart (36) scenarios on the card, each with a CPU
          twin in this process (gang-storm's and spot-churn's cut to 150
          cycles for the time limit): the CPU's binding-log SHA-256 equal
          to that of the card's log over the same cycles, zero invariant
          breaches and cycle exceptions on both, smoke's ladder round trip
          in cycles_at_level. Prints each scenario's SHA prefix, cycles at
          each level, SLO flags and wall seconds on each device.
  scheduler_mixed  mixed_cluster(101, 1000 nodes, 2000 pods) as a store,
          through Scheduler(device="cuda", waves=1) and a
          Scheduler(device="cpu", waves=1) twin (the plain round) for cycle 0
          and 2 churn cycles of 200 arrivals: the canonical dumps of both
          worlds (every pod's node, annotations and PodScheduled condition,
          every PodGroup's status, every ElasticQuota's used vector) must be
          identical after every cycle.
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
Every phase that injects no fault ends with each scheduler's ladder at
full, no transition and no dispatch retry (ladder_full in its line).
Each kernel's phase line names the launch: the state it kept (smem or
global), the instance (common or generic), cluster_size, block_threads and
smem_bytes_per_block. Every phase holds the kernel's bindings and outputs
equal to the plain round's: 0 mismatches and max |err| 0.0. Then the
kernels line, the card line, and the result line. Any failure raises: the
script exits non-zero and prints no result. It imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import ResourceName
from koordinator_tpu_torch.client.store import KIND_POD
from koordinator_tpu_torch.models.convert import (
    schedule_inputs_from_numpy,
    to_device,
)
from koordinator_tpu_torch.models import fused_waves
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
from koordinator_tpu_torch.ops.kernel_common import (
    BUILD_LOG,
    SMEM_BUDGET_BYTES,
    build_libraries,
)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
from koordinator_tpu_torch.scheduler import pipeline_parity
from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler
from koordinator_tpu_torch.scheduler.degrade import DegradationLadder
from koordinator_tpu_torch.scheduler.parity import serial_schedule
from koordinator_tpu_torch.scheduler.snapshot_cache import DeviceSnapshot
from koordinator_tpu_torch.scheduler.sidecar import SidecarServer
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.sim.faults import Fault, FaultPlan
from koordinator_tpu_torch.sim.harness import run_scenario
from koordinator_tpu_torch.sim.invariants import check_invariants
from koordinator_tpu_torch.sim.scenarios import SCENARIOS
from koordinator_tpu_torch.testing import (
    loadaware_inputs,
    mixed_cluster,
    synth_cluster,
    synth_full_cluster,
)
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    churn_store,
    cycle_dump,
    store_from_state,
)
from koordinator_tpu_torch.utils.features import SCHEDULER_GATES

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPS = 10  # timed rounds after the warm-up
ORACLE_PODS = 200  # bench.py's --serial-sample default
# bench.py run_churn: 2 warm-up and (with --smoke's count) 3 measured churn
# cycles, num_pods // 10 arrivals each
CHURN_WARMUP, CHURN_MEASURED = 2, 3
# the spans a cycle is split into (direct children of the cycle root, and
# the upload/readback and pack_incremental children of kernel and encode)
CYCLE_SPANS = ("reservation_prepass", "snapshot", "encode", "compile",
               "kernel", "bind", "diagnose", "overlap_wait", "prepack",
               "store_flush")
NESTED_SPANS = ("pack_incremental", "upload", "readback")
# the fused path adds the chained replay's span (wave_replay children)
WAVE_SPANS = CYCLE_SPANS + ("replay_drain",)
# the default-waves phase: cycle 0, then warm-up and measured churn cycles
WAVE_CHURN_WARMUP, WAVE_CHURN_MEASURED = 1, 3
# the ladder phase: churn cycles after cycle 0, the ladder's re-promotion
# probe, the dispatch deadline armed in the faulted scheduler and the
# delay of the latency fault (a wave 1 takes at most ~0.1 s on the card)
LADDER_CYCLES, LADDER_PROMOTE_AFTER = 10, 2
LADDER_DEADLINE_MS, LADDER_DELAY_MS = 2000.0, 4000.0
# the fault plan, by churn cycle, and the ladder level after each cycle
LADDER_FAULTS = (
    Fault(cycle=1, kind="dispatch", message="ladder: one dispatch fault"),
    Fault(cycle=2, kind="oom_upload", message="ladder: one upload OOM"),
    Fault(cycle=3, kind="latency", delay_ms=LADDER_DELAY_MS,
          message="ladder: one slow readback"),
    # the fused window: retry, then demote to serial waves (the pass
    # re-runs serially); next cycle the serial window: retry, then demote
    # to the host fallback
    Fault(cycle=4, kind="dispatch", count=2, message="ladder: fault storm"),
    Fault(cycle=5, kind="dispatch", count=2, message="ladder: fault storm"),
)
LADDER_LEVELS = [0, 0, 0, 0, 3, 5, 5, 3, 3, 0, 0]
LADDER_WALK = [("full", "serial-waves"), ("serial-waves", "host-fallback"),
               ("host-fallback", "serial-waves"), ("serial-waves", "full")]
# the sim phase: the catalog scenarios the port runs, at their catalog
# cycle counts on the card; the CPU twins of gang-storm and spot-churn are
# cut to 150 cycles for the script's time limit (the plain round's per-pod
# loop over their backlog takes ~0.4 and ~1 s a cycle on the host), and
# are held against the card run's first 150 cycles
SIM_SCENARIOS = (("smoke", 50, 50), ("gang-storm", 300, 150),
                 ("spot-churn", 300, 150), ("crash-restart", 36, 36))


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


def last_cycle_root(sched):
    return [r for r in sched.tracer.roots() if r.name == "cycle"][-1]


def span_split(sched, names=CYCLE_SPANS) -> dict:
    """Milliseconds per span of the scheduler's last cycle: each direct
    child of the cycle root (summed by name), the upload/readback and
    pack_incremental children, and the rest of the cycle."""
    root = last_cycle_root(sched)
    out = {name: 0.0 for name in names + NESTED_SPANS}
    for child in root.children:
        if child.name in out:
            out[child.name] += child.duration_seconds * 1e3
        for sub in child.children:
            if sub.name in NESTED_SPANS:
                out[sub.name] += sub.duration_seconds * 1e3
    out["rest"] = root.duration_seconds * 1e3 - sum(
        out[name] for name in names)
    out["cycle"] = root.duration_seconds * 1e3
    return out


def median_split(splits) -> dict:
    return {k: statistics.median(s[k] for s in splits) for k in splits[0]}


def result_key(res):
    return ([(b.pod_key, b.node_name) for b in res.bound], list(res.failed),
            list(res.rejected))


def checked_cycle(tag, sched, run, now):
    """One cycle of ``sched`` (``run`` is its run_cycle or its pipeline's)
    with the launch counts set to 0 just before it and read just after:
    every dispatch window on the card launches the full-chain kernel
    exactly once and the LoadAware kernel never. Returns (result, wall
    seconds, launches, full garbage collections during the cycle)."""
    d0 = sched.dispatches
    gc0 = gc.get_stats()[2]["collections"]
    fck.launches = sk.launches = 0
    t0 = time.perf_counter()
    res = run(now=now)
    wall = time.perf_counter() - t0
    # Python's full (generation 2) collections inside the cycle: a pause
    # no span owns
    gc_full = gc.get_stats()[2]["collections"] - gc0
    windows = sched.dispatches - d0
    if sched.device.type == "cuda" and (
            sched.last_backend != "cuda" or fck.launches != windows
            or sk.launches != 0 or windows < 1):
        raise AssertionError(
            f"{tag}: {windows} dispatch windows, backend "
            f"{sched.last_backend}, launches full_chain {fck.launches} "
            f"schedule_step {sk.launches}")
    return res, wall, fck.launches, gc_full


def fc_fields(fc) -> dict:
    out = {f"base.{k}": v for k, v in fc.base._asdict().items()}
    out.update((k, v) for k, v in fc._asdict().items() if k != "base")
    return out


def check_mirror(fc, device) -> dict:
    """DeviceSnapshot on the card over one real batch: a put of every
    field, a row scatter while a round is in flight (into a clone) and one
    after it (in place), each tensor equal to to_device's in dtype and
    value. Returns the mirror's stats."""
    snap = DeviceSnapshot(device=device)
    snap.upload(fc)
    old = snap.upload(fc)  # nothing changed since the put: reused
    batches, step = [], fc
    n = fc.base.requested.shape[0]
    for rows in ((0, 7, n // 2), (1, 2)):
        req = np.array(step.base.requested, copy=True)
        req[list(rows)] += 1.0
        step = step._replace(base=step.base._replace(requested=req))
        batches.append(step)

    def check(got, host):
        want = fc_fields(to_device(host, device))
        for name, t in fc_fields(got).items():
            if t.dtype != want[name].dtype or not torch.equal(t, want[name]):
                raise AssertionError(f"mirror: {name} differs from to_device")

    snap.begin_dispatch()
    in_flight = snap.upload(batches[0])
    snap.end_dispatch()
    check(in_flight, batches[0])
    if not torch.equal(old.base.requested,
                       to_device(fc, device).base.requested):
        raise AssertionError("mirror: an in-flight scatter wrote in place")
    in_place = snap.upload(batches[1])
    check(in_place, batches[1])
    if in_place.base.requested is not in_flight.base.requested:
        raise AssertionError("mirror: a scatter after the sync cloned")
    if (snap.stats["scattered"], snap.stats["scattered_safe"]) != (2, 1):
        raise AssertionError(f"mirror: unexpected path {snap.stats}")
    return dict(snap.stats)


def run_scheduler(device, n_nodes=5000, n_pods=10000):
    """BASELINE config 4 through Scheduler.run_cycle (bench.py run_churn's
    shape), three twins that must agree every cycle, then the kernel alone
    at the churn cycles' padded P. Returns the phase's full-chain
    launches."""
    arrivals = n_pods // 10
    retries0 = retries_now()
    t0 = time.perf_counter()
    (store_inc, state), (store_pipe, _s2), (store_cold, _s3) = (
        churn_store(n_nodes, n_pods, seed=42) for _ in range(3))
    inc = Scheduler(store_inc, waves=1, device=device)
    pipe_sched = Scheduler(store_pipe, waves=1, device=device)
    pipe = CyclePipeline(pipe_sched, enabled=True)
    SCHEDULER_GATES.set_from_map({"IncrementalSnapshot": False})
    try:
        cold = Scheduler(store_cold, waves=1, device=device)
    finally:
        SCHEDULER_GATES.reset()
    if inc.snapshot_cache is None or cold.snapshot_cache is not None:
        raise AssertionError("scheduler: IncrementalSnapshot gate not applied")
    fixture_s = time.perf_counter() - t0
    twins = (("incremental", inc, inc.run_cycle),
             ("pipelined", pipe_sched, pipe.run_cycle),
             ("rebuild", cold, cold.run_cycle))
    observed = []
    now = state.now
    total_launches = 0
    walls = {name: [] for name, _s, _r in twins}
    kernel_s, splits, padded_p = [], [], []
    cycle0 = {}
    for c in range(1 + CHURN_WARMUP + CHURN_MEASURED):
        if c:
            specs = arrival_specs(c, arrivals)
            for store in (store_inc, store_pipe, store_cold):
                add_arrivals(store, specs, now + c)
        inc.encode_observer = lambda fc: observed.append(
            (fc.base.fit_requests.shape[0], fc))
        keys = {}
        for name, sched, run in twins:
            res, wall, launches, gc_full = checked_cycle(
                f"scheduler cycle {c} {name}", sched, run, now + 2 * c)
            total_launches += launches
            keys[name] = result_key(res)
            if name == "incremental":
                if c == 0:
                    cycle0 = {"seconds": wall,
                              "kernel_seconds": res.kernel_seconds,
                              "bound": len(res.bound),
                              "failed": len(res.failed),
                              "rejected": len(res.rejected),
                              "spans_ms": span_split(inc)}
                elif c > CHURN_WARMUP:
                    kernel_s.append(res.kernel_seconds)
                    splits.append(span_split(inc))
                    splits[-1]["gc_full_collections"] = gc_full
                    padded_p.append(int(observed[-1][0]))
            if c > CHURN_WARMUP:
                walls[name].append(wall)
        inc.encode_observer = None
        if not (keys["incremental"] == keys["pipelined"] == keys["rebuild"]):
            raise AssertionError(f"scheduler cycle {c}: twins disagree")
        if c and not keys["incremental"][0]:
            raise AssertionError(f"scheduler cycle {c}: nothing bound")
    pipe.flush()

    # the kernel alone at the churn cycles' padded P: the last measured
    # cycle's inputs, with the step arguments its cached step was keyed on
    fc = observed[-1][1]
    sig = (fc.base.fit_requests.shape[0], fc.base.allocatable.shape[0],
           fc.quota_runtime.shape[0])
    actives = {key[3] for key in inc._step_cache if key[0] == sig}
    if len(actives) != 1:
        raise AssertionError(f"scheduler: steps for {sig} disagree on the "
                             f"active axes: {actives}")
    active = list(actives.pop())
    dev_fc = to_device(fc, device)
    wi, bi = resolve_weight_idx(inc.args, active), resolve_balance_idx(active)
    prod = inc.args.score_according_prod_usage
    churn_kernel_ms = time_cuda(
        lambda: fck.full_chain_round(dev_fc, wi, prod, bi), REPS)
    # the twin's mirror hands the round what to_device would
    mirror = fc_fields(inc.device_snapshot.upload(fc))
    for name, t in fc_fields(dev_fc).items():
        if mirror[name].dtype != t.dtype or not torch.equal(mirror[name], t):
            raise AssertionError(f"scheduler: mirror field {name} differs "
                                 "from to_device")
    mirror_check = check_mirror(fc, device)
    assert_ladder_full("scheduler", retries0, inc, pipe_sched, cold)

    t_inc = statistics.median(walls["incremental"])
    t_kernel = statistics.median(kernel_s)
    emit({"phase": "scheduler", "nodes": n_nodes, "pods": n_pods,
          "arrivals_per_cycle": arrivals, "warmup_cycles": CHURN_WARMUP,
          "measured_cycles": CHURN_MEASURED,
          "fixture_seconds": round(fixture_s, 3),
          "twins_identical_every_cycle": True, "ladder_full": True,
          "launches": total_launches, "cycle0": cycle0,
          "cycle_ms": t_inc * 1e3, "cycle_ms_each": [w * 1e3 for w in
                                                     walls["incremental"]],
          "kernel_seconds_ms": t_kernel * 1e3,
          "host_ms": (t_inc - t_kernel) * 1e3,
          "spans_ms": median_split(splits),
          "spans_ms_each": splits,
          "pipelined_cycle_ms": statistics.median(walls["pipelined"]) * 1e3,
          "pipelined_cycle_ms_each": [w * 1e3 for w in walls["pipelined"]],
          "rebuild_cycle_ms": statistics.median(walls["rebuild"]) * 1e3,
          "rebuild_cycle_ms_each": [w * 1e3 for w in walls["rebuild"]],
          "pods_per_second": arrivals / t_inc,
          "device_snapshot": inc.device_snapshot.stats,
          "snapshot_cache": inc.snapshot_cache.stats,
          "mirror_check": mirror_check,
          "churn_padded_P": padded_p,
          "churn_kernel_ms": churn_kernel_ms,
          "churn_kernel_state": fck.last_launch["state"]})
    return total_launches


def run_scheduler_mixed(device, n_nodes=1000, n_pods=2000):
    """The mixed cluster through the whole cycle on the card and in a CPU
    twin (the plain round): identical worlds after every cycle."""
    retries0 = retries_now()
    worlds = []
    for dev in (device, "cpu"):
        _c, state = mixed_cluster(101, n_nodes, n_pods)
        store = store_from_state(state)
        worlds.append((store, Scheduler(store, waves=1, device=dev)))
    now = state.now
    launches, walls = 0, {device: [], "cpu": []}
    for c in range(3):
        if c:
            specs = arrival_specs(c, n_pods // 10)
            for store, _s in worlds:
                add_arrivals(store, specs, now + c)
        keys, dumps = [], []
        for store, sched in worlds:
            res, wall, n, _gc = checked_cycle(
                f"scheduler_mixed cycle {c}", sched, sched.run_cycle,
                now + 2 * c)
            launches += n if sched.device.type == "cuda" else 0
            walls[sched.device.type].append(wall)
            keys.append(result_key(res))
            dumps.append(cycle_dump(sched))
        if keys[0] != keys[1] or dumps[0] != dumps[1]:
            raise AssertionError(
                f"scheduler_mixed cycle {c}: the card's world differs from "
                "the plain round's")
        if worlds[1][1].last_backend != "serial":
            raise AssertionError("scheduler_mixed: the CPU twin did not run "
                                 "the plain round")
    assert_ladder_full("scheduler_mixed", retries0,
                       *(s for _st, s in worlds))
    pods = dumps[0]["pods"]
    emit({"phase": "scheduler_mixed", "nodes": n_nodes, "pods": n_pods,
          "cycles": 3, "dumps_identical_every_cycle": True,
          "ladder_full": True,
          "launches": launches,
          "cuda_cycle_seconds": walls[device], "cpu_cycle_seconds": walls["cpu"],
          "pods_bound": sum(1 for v in pods.values() if v[0]),
          "pods_unschedulable": sum(1 for v in pods.values()
                                    if v[2] is not None and v[2][0] == "False"),
          "messages": len({v[2][2] for v in pods.values()
                           if v[2] is not None and v[2][0] == "False"})})
    return launches


def wave_cycle(tag, sched, now):
    """One cycle of ``sched`` with the launch counts set to 0 just before
    it and read just after. On the card the cycle must have run its rounds
    in the full-chain kernel, and a fused dispatch (K > 1) its kept-only
    replays in the replay instance, one of each per device wave. Returns
    (result, wall seconds, launches, the K the cycle resolved to)."""
    d0 = sched.dispatches
    fck.launches = fck.replay_launches = sk.launches = 0
    t0 = time.perf_counter()
    res = sched.run_cycle(now=now)
    wall = time.perf_counter() - t0
    launches = {"full_chain": fck.launches,
                "full_chain_replay": fck.replay_launches,
                "schedule_step": sk.launches}
    kspan = last_cycle_root(sched).find("kernel")
    k = int(kspan.attributes.get("waves", "1")) if kspan else 1
    if sched.device.type == "cuda" and (
            sched.last_backend != "cuda" or sched.dispatches - d0 < 1
            or sk.launches != 0 or fck.launches < fck.replay_launches
            or (k > 1 and fck.replay_launches < 1)
            or (k == 1 and fck.replay_launches != 0)):
        raise AssertionError(f"{tag}: K {k}, backend {sched.last_backend}, "
                             f"launches {launches}")
    return res, wall, launches, k


def wave_detail(sched) -> dict:
    """The last cycle's waves: the chained replay's per-logical-cycle
    spans (bound, the wave's device ms), its waits for later waves' rows,
    and the single-call twin's wave markers under the kernel span
    (bound)."""
    root = last_cycle_root(sched)
    kspan = root.find("kernel")
    return {
        "kernel_span_ms": kspan.duration_seconds * 1e3 if kspan else None,
        "wave_replay": [
            {"bound": int(sp.attributes["bound"]),
             "device_ms": (float(sp.attributes["device_ms"])
                           if "device_ms" in sp.attributes else None)}
            for sp in root.find_all("wave_replay")],
        "waves": [int(sp.attributes["bound"])
                  for sp in (kspan.find_all("wave") if kspan else [])],
        # the host's wait for a later wave's rows after replaying the one
        # before: near 0 where the card finished it during the replay
        "later_wave_wait_ms": [
            sp.duration_seconds * 1e3 for sp in root.find_all("overlap_wait")
            if "wave" in sp.attributes],
    }


def clone_fc(fc):
    return type(fc)(type(fc.base)(*(t.clone() for t in fc.base)),
                    *(t.clone() for t in fc[1:]))


def replay_bound(fc, n_kept: int, n_numa: int):
    """(bytes ms, operations ms) of one kept-only replay on these inputs:
    the kept pods' records, ``chosen`` and the carried state read once,
    the state and the zones written once; per kept pod the Reserve's f32
    operations (csrc/full_chain.cu): requested R, the LoadAware sums R,
    bindable cpus and volume headroom 2, the quota chain D x R, and for a
    pod with NUMA needs the zone fits K x R and the fill 3 x K x R."""
    P, R = fc.base.fit_requests.shape
    N = fc.base.allocatable.shape[0]
    K = fc.numa_free.shape[1]
    G, D = fc.quota_ancestors.shape
    T, PT = fc.aff_dom.shape[1], fc.port_used.shape[1]
    VG = fc.vol_needed.shape[1]
    stride = fck.record_layout(R, T, PT, VG)["rec_stride"]
    state = N * (3 * R + K * R + 2 + PT + 2 * T) + G * R + T
    nbytes = n_kept * stride * 4 + P * 4 + 2 * state * 4 + P * 4
    ops = n_kept * (2 * R + 2 + D * R) + n_numa * 4 * K * R
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def replay_mismatch(out_k, zones_k, out_p, zones_p):
    """(values that differ, max |err| over finite values) between a replay
    kernel's (state, zones) and the plain replay's."""
    mism = int((zones_k != zones_p).sum())
    err = 0.0
    for a, b in zip(out_k, out_p):
        if a.dtype == torch.bool:
            mism += int((a != b).sum())
            continue
        # bit for bit: equal values are not enough where a -0.0 hides, and
        # a node without a volume limit carries +inf headroom
        mism += int((a.view(torch.int32) != b.view(torch.int32)).sum())
        fin = torch.isfinite(a) & torch.isfinite(b)
        if fin.any():
            err = max(err, float((a[fin] - b[fin]).abs().max()))
    return mism, err


def run_scheduler_waves(device, n_nodes=5000, n_pods=10000):
    """Config 4 through Scheduler(store) with its defaults (auto waves,
    chained dispatch), against the single-call twin and the serial twin;
    then the replay instance alone at cycle 0's kept set against the plain
    replay on the card. Returns (the default twin's launches, the replay
    instance's kernels-line entry, cycle 0's first-wave inputs)."""
    arrivals = n_pods // 10
    retries0 = retries_now()
    t0 = time.perf_counter()
    (store_a, state), (store_b, _s2), (store_c, _s3) = (
        churn_store(n_nodes, n_pods, seed=42) for _ in range(3))
    chained = Scheduler(store_a, device=device)
    fused = Scheduler(store_b, device=device, replay_overlap=False)
    serial = Scheduler(store_c, waves=1, device=device)
    if chained.waves_spec != "auto" or not chained.replay_overlap:
        raise AssertionError("scheduler_waves: the defaults are not auto "
                             "waves with replay overlap")
    fixture_s = time.perf_counter() - t0
    # the replay's inputs at cycle 0's first wave, for the timing below
    captured = {}
    real_replay = fck.full_chain_replay

    def spy(fc_carry, chosen, kept, state_, prod_mode, **kw):
        if not captured:
            captured["args"] = (
                clone_fc(fc_carry), chosen.clone(), kept.clone(),
                tuple(t.clone() for t in state_), prod_mode)
        return real_replay(fc_carry, chosen, kept, state_, prod_mode, **kw)

    now = state.now
    total = {"full_chain": 0, "full_chain_replay": 0}
    rows, walls = [], {"chained": [], "fused": [], "serial": []}
    splits = {"chained": [], "fused": []}
    cycle0 = {}
    for c in range(1 + WAVE_CHURN_WARMUP + WAVE_CHURN_MEASURED):
        if c:
            specs = arrival_specs(c, arrivals)
            for store in (store_a, store_b, store_c):
                add_arrivals(store, specs, now + c)
        t = now + 2 * c
        fck.full_chain_replay = spy if c == 0 else real_replay
        try:
            res_a, wall_a, la, k_a = wave_cycle(
                f"scheduler_waves cycle {c} chained", chained, t)
        finally:
            fck.full_chain_replay = real_replay
        detail_a = wave_detail(chained)
        split_a = span_split(chained, WAVE_SPANS)
        res_b, wall_b, lb, k_b = wave_cycle(
            f"scheduler_waves cycle {c} fused", fused, t)
        detail_b = wave_detail(fused)
        split_b = span_split(fused, WAVE_SPANS)
        if (k_a, res_a.waves) != (k_b, res_b.waves):
            raise AssertionError(f"scheduler_waves cycle {c}: K/waves differ "
                                 f"({k_a}, {res_a.waves}) vs ({k_b}, "
                                 f"{res_b.waves})")
        keys = {"chained": result_key(res_a), "fused": result_key(res_b)}
        ser_key = ([], [], [])
        wall_c = 0.0
        for _w in range(res_a.waves):
            res_c, wall, _n, _gc = checked_cycle(
                f"scheduler_waves cycle {c} serial", serial,
                serial.run_cycle, t)
            wall_c += wall
            for part, got in zip(ser_key, result_key(res_c)):
                part.extend(got)
        keys["serial"] = ser_key
        if not (keys["chained"] == keys["fused"] == keys["serial"]):
            raise AssertionError(f"scheduler_waves cycle {c}: twins disagree")
        if not keys["chained"][0]:
            raise AssertionError(f"scheduler_waves cycle {c}: nothing bound")
        for key in total:
            total[key] += la[key]
        rows.append({"cycle": c, "K": k_a, "logical_cycles": res_a.waves,
                     "device_waves": la["full_chain_replay"],
                     "bound": len(res_a.bound), "failed": len(res_a.failed),
                     "rejected": len(res_a.rejected),
                     "launches_chained": la, "launches_fused": lb,
                     "chained": detail_a, "fused": detail_b,
                     "chained_ms": wall_a * 1e3, "fused_ms": wall_b * 1e3,
                     "serial_ms": wall_c * 1e3,
                     "chained_kernel_seconds_ms": res_a.kernel_seconds * 1e3,
                     "fused_kernel_seconds_ms": res_b.kernel_seconds * 1e3})
        if c == 0:
            cycle0 = {"chained_spans_ms": split_a, "fused_spans_ms": split_b}
        elif c > WAVE_CHURN_WARMUP:
            walls["chained"].append(wall_a)
            walls["fused"].append(wall_b)
            walls["serial"].append(wall_c)
            splits["chained"].append(split_a)
            splits["fused"].append(split_b)
    for sched in (chained, fused):
        sched.flush_deferred()
    dumps = [cycle_dump(s) for s in (chained, fused, serial)]
    if not (dumps[0] == dumps[1] == dumps[2]):
        raise AssertionError("scheduler_waves: the final dumps differ")
    assert_ladder_full("scheduler_waves", retries0, chained, fused, serial)
    if n_pods == 10000 and (rows[0]["K"] != 8
                            or any(r["K"] != 4 for r in rows[1:])):
        raise AssertionError(f"scheduler_waves: K per cycle "
                             f"{[r['K'] for r in rows]}, expected 8 then 4")

    # ---- the replay instance alone at cycle 0's first wave
    fc_c, chosen, kept, state0, prod = captured["args"]
    n_kept = int(kept.sum())
    n_numa = int((kept & fc_c.needs_numa).sum())
    replay_ms = time_cuda(
        lambda: real_replay(fc_c, chosen, kept, state0, prod), REPS)
    out_k, zones_k = real_replay(fc_c, chosen, kept, state0, prod)
    launch = launch_fields(fck)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, zones_p = fused_waves.replay_kept(fc_c, prod, state0, chosen,
                                             kept)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mism, err = replay_mismatch(out_k, zones_k, out_p, zones_p)
    if mism or err != 0.0:
        raise AssertionError(f"replay kernel disagrees with replay_kept: "
                             f"{mism} values differ, max |err| {err}")
    # the same replay with its carried state in device memory: the instance
    # a shape past the shared-memory budget takes on its own
    global_ms = time_cuda(
        lambda: real_replay(fc_c, chosen, kept, state0, prod,
                            smem_budget_bytes=0), REPS)
    out_g, zones_g = real_replay(fc_c, chosen, kept, state0, prod,
                                 smem_budget_bytes=0)
    launch_g = launch_fields(fck)
    if launch_g["state"] != "global":
        raise AssertionError(f"replay with a zero budget kept its state in "
                             f"{launch_g['state']}")
    mism_g, err_g = replay_mismatch(out_g, zones_g, out_p, zones_p)
    if mism_g or err_g != 0.0:
        raise AssertionError(f"device-memory replay disagrees with "
                             f"replay_kept: {mism_g} values differ, max "
                             f"|err| {err_g}")
    bytes_ms, ops_ms = replay_bound(fc_c, n_kept, n_numa)
    t_chained = statistics.median(walls["chained"])
    emit({"phase": "scheduler_waves", "nodes": n_nodes, "pods": n_pods,
          "arrivals_per_cycle": arrivals,
          "warmup_cycles": WAVE_CHURN_WARMUP,
          "measured_cycles": WAVE_CHURN_MEASURED,
          "fixture_seconds": round(fixture_s, 3),
          "twins_identical_every_cycle": True, "final_dumps_identical": True,
          "ladder_full": True, "launches": total, "cycles": rows,
          "cycle_ms": t_chained * 1e3,
          "cycle_ms_each": [w * 1e3 for w in walls["chained"]],
          "fused_cycle_ms": statistics.median(walls["fused"]) * 1e3,
          "serial_round_ms": statistics.median(walls["serial"]) * 1e3,
          "pods_per_second": arrivals / t_chained,
          "spans_ms": median_split(splits["chained"]),
          "fused_spans_ms": median_split(splits["fused"]),
          "cycle0": cycle0,
          "replay": {"P": int(kept.shape[0]), "kept": n_kept,
                     "kept_numa": n_numa, **launch, "kernel_ms": replay_ms,
                     "plain_ms": plain_ms, "mismatches": mism,
                     "max_abs_err": err, "bound_bytes_ms": bytes_ms,
                     "bound_ops_ms": ops_ms},
          "replay_global": {**launch_g, "kernel_ms": global_ms,
                            "mismatches": mism_g, "max_abs_err": err_g}})
    entry = kernel_entry(
        "full_chain_replay", "full_chain.cu",
        "koordinator_tpu/models/fused_waves.py:527 (an XLA fori_loop, no "
        "TPU kernel)", total["full_chain_replay"], mism, err, replay_ms,
        plain_ms, bytes_ms, ops_ms)
    return total, entry, fc_c


def keep_shared_claims(state, keep):
    """Drop the claims of every pending pod past the first ``keep`` that
    shares a running pod's claim. At full size the mixed cluster's shared
    claims attach to more node groups than the volume-group budget holds,
    and the Scheduler (like the JAX one) demotes such a batch to serial
    dispatch (claim-entangled). Returns the count of pods left sharing."""
    running = {c for p in state.pods_by_key.values() if p.is_assigned
               for c in p.spec.pvc_names}
    kept = 0
    for pod in state.pending_pods:
        if pod.spec.pvc_names and running.intersection(pod.spec.pvc_names):
            if kept < keep:
                kept += 1
            else:
                pod.spec.pvc_names = []
    return kept


def run_scheduler_waves_mixed(device, n_nodes=1000, n_pods=2000):
    """The mixed cluster with default waves on the card and in a CPU twin
    (the plain wave step): identical worlds after every cycle. The world as
    mixed_cluster builds it demotes to serial dispatch (checked here), so
    its shared claims are cut to 8 pods first."""
    retries0 = retries_now()
    _c, state = mixed_cluster(101, n_nodes, n_pods)
    untrimmed = Scheduler(store_from_state(state), device=device)
    res = untrimmed.run_cycle(now=state.now)
    if res.demotions != ["claim-entangled"] or res.waves != 1:
        raise AssertionError(f"scheduler_waves_mixed: the untrimmed world "
                             f"gave {res.demotions}, K {res.waves}")
    res0 = res
    worlds = []
    for dev in (device, "cpu"):
        _c, state = mixed_cluster(101, n_nodes, n_pods)
        sharing = keep_shared_claims(state, 8)
        store = store_from_state(state)
        worlds.append((store, Scheduler(store, device=dev)))
    now = state.now
    launches = {"full_chain": 0, "full_chain_replay": 0}
    ks, walls = [], {device: [], "cpu": []}
    for c in range(3):
        if c:
            specs = arrival_specs(c, n_pods // 10)
            for store, _s in worlds:
                add_arrivals(store, specs, now + c)
        keys, dumps = [], []
        for store, sched in worlds:
            res, wall, n, k = wave_cycle(f"scheduler_waves_mixed cycle {c}",
                                         sched, now + 2 * c)
            if sched is worlds[0][1]:
                ks.append(k)
                for key in launches:
                    launches[key] += n[key]
            walls[sched.device.type].append(wall)
            keys.append(result_key(res) + ([res.waves],))
            dumps.append(cycle_dump(sched))
        if keys[0] != keys[1] or dumps[0] != dumps[1]:
            raise AssertionError(
                f"scheduler_waves_mixed cycle {c}: the card's world differs "
                "from the plain wave step's")
    if ks[0] < 2 or launches["full_chain_replay"] < 1:
        raise AssertionError(f"scheduler_waves_mixed: K {ks}, launches "
                             f"{launches}")
    assert_ladder_full("scheduler_waves_mixed", retries0, untrimmed,
                       *(s for _st, s in worlds))
    pods = dumps[0]["pods"]
    emit({"phase": "scheduler_waves_mixed", "nodes": n_nodes, "pods": n_pods,
          "cycles": 3, "K": ks, "dumps_identical_every_cycle": True,
          "ladder_full": True,
          "untrimmed_demotions": res0.demotions,
          "pods_sharing_claims": sharing, "launches": launches,
          "cuda_cycle_seconds": walls[device],
          "cpu_cycle_seconds": walls["cpu"],
          "pods_bound": sum(1 for v in pods.values() if v[0])})


def run_waves_carried(device, fc4):
    """The carried-state worlds on the card, each against its serial twin;
    then the shared memory of a config-4 launch whose records carry a
    claim world's [P, N] volume view. No dispatch may retry."""
    retries0 = retries_now()
    reports = []
    for feature in ("reservations", "claims", "prod", "transformer"):
        fck.launches = fck.replay_launches = 0
        report = pipeline_parity.run_carried_state_parity(feature,
                                                          device=device)
        report["launches"] = {"full_chain": fck.launches,
                              "full_chain_replay": fck.replay_launches}
        if (not report["ok"] or report["fused_engaged"] < 1
                or fck.replay_launches < 1):
            raise AssertionError(f"waves_carried {feature}: {report}")
        reports.append(report)
    P = fc4.base.fit_requests.shape[0]
    N = fc4.base.allocatable.shape[0]
    dev = fc4.vol_needed.device
    claims_fc = fc4._replace(
        vol_needed=torch.zeros((P, N), device=dev),
        node_vol_group=torch.arange(N, dtype=torch.int32, device=dev))
    assert_ladder_full("waves_carried", retries0)
    kind, _plan, smem = fck.state_for(claims_fc, (0, 1))
    if smem > SMEM_BUDGET_BYTES:
        raise AssertionError("waves_carried: a claim-world launch does not "
                             "fit a block")
    emit({"phase": "waves_carried", "reports": reports,
          "claims_full_size": {"P": int(P), "N": int(N), "VG": int(N),
                               "state": kind, "smem_bytes_per_block": smem,
                               "budget": SMEM_BUDGET_BYTES}})


def retries_now() -> dict:
    return {stage: scheduler_metrics.DISPATCH_RETRIES.get(stage=stage) or 0.0
            for stage in ("serial", "fused")}


def assert_ladder_full(tag, retries0, *scheds) -> None:
    """A phase that injects no fault: every scheduler ends at the full
    rung with no transitions, and no dispatch attempt was retried."""
    for sched in scheds:
        if sched.ladder.level != 0 or sched.ladder.transitions:
            raise AssertionError(f"{tag}: the ladder moved: "
                                 f"{sched.ladder.transitions}")
    if retries_now() != retries0:
        raise AssertionError(f"{tag}: dispatch retries moved from "
                             f"{retries0} to {retries_now()}")


def host_fallback_seconds(sched) -> float:
    """Seconds of the host-fallback passes in the scheduler's last cycle
    (the kernel spans with host_fallback="1")."""
    return sum(sp.duration_seconds
               for sp in last_cycle_root(sched).find_all("kernel")
               if sp.attributes.get("host_fallback") == "1")


def run_ladder(device, n_nodes=5000, n_pods=10000):
    """Config 4 through two Scheduler(store) twins at their defaults:
    (a) with LADDER_FAULTS attached through the three hooks, (b) with
    none. Through the retry-only faults (a) must equal (b) cycle by cycle;
    from the storm on, (a) walks full -> serial-waves -> host-fallback
    and back and is held to the store invariants instead. Returns the
    kernels' launches in both twins."""
    arrivals = n_pods // 10
    (store_a, state), (store_b, _s) = (
        churn_store(n_nodes, n_pods, seed=42) for _ in range(2))
    plan = FaultPlan(LADDER_FAULTS)
    faulted = Scheduler(store_a, device=device,
                        dispatch_deadline_ms=LADDER_DEADLINE_MS,
                        ladder=DegradationLadder(
                            promote_after=LADDER_PROMOTE_AFTER))
    twin = Scheduler(store_b, device=device)
    faulted.fault_injector = plan.dispatch_hook
    faulted.sync_delay_injector = plan.sync_delay_hook
    faulted.upload_fault_injector = plan.upload_hook
    retries0 = retries_now()
    overruns0 = (scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.get(
        path="fused") or 0.0)
    now = state.now
    total = {"full_chain": 0, "full_chain_replay": 0}
    rows, fallback_s = [], []
    for c in range(1 + LADDER_CYCLES):
        if c:
            specs = arrival_specs(c, arrivals)
            for store in (store_a, store_b):
                add_arrivals(store, specs, now + c)
        t = now + 2 * c
        plan.begin_cycle(c)
        r0 = retries_now()
        snap0 = faulted.device_snapshot
        puts0 = (snap0.stats["put"], twin.device_snapshot.stats["put"])
        res_a, wall_a, la, k_a = ladder_cycle(faulted, t)
        hf_s = host_fallback_seconds(faulted)
        res_b, wall_b, lb, k_b = ladder_cycle(twin, t)
        level = faulted.ladder.level
        dr = {s: retries_now()[s] - r0[s] for s in r0}
        for key in total:
            total[key] += la[key] + lb[key]
        breaches = check_invariants(store_a, now=t)
        if breaches:
            raise AssertionError(f"ladder cycle {c}: {breaches[:3]}")
        if level != LADDER_LEVELS[c]:
            raise AssertionError(f"ladder cycle {c}: level {level}, "
                                 f"expected {LADDER_LEVELS[c]}")
        if c < 4 and result_key(res_a) != result_key(res_b):
            raise AssertionError(f"ladder cycle {c}: (a) differs from (b) "
                                 "through a retry-only fault")
        expect = {1: {"fused": 1.0, "serial": 0.0},
                  2: {"fused": 1.0, "serial": 0.0},
                  3: {"fused": 1.0, "serial": 0.0},
                  4: {"fused": 2.0, "serial": 0.0},
                  5: {"fused": 0.0, "serial": 2.0}}.get(
                      c, {"fused": 0.0, "serial": 0.0})
        if dr != expect:
            raise AssertionError(f"ladder cycle {c}: retries {dr}, "
                                 f"expected {expect}")
        if c == 2 and not (snap0.stats["put"] - puts0[0]
                           > twin.device_snapshot.stats["put"] - puts0[1]):
            raise AssertionError("ladder: the OOM'd field was not rolled "
                                 "back to a full put")
        if c == 3 and faulted.device_snapshot is snap0:
            raise AssertionError("ladder: the deadline overrun kept the "
                                 "abandoned mirror")
        on_host = faulted.last_backend == "host-fallback"
        bound_pods = [store_a.get(KIND_POD, b.pod_key) for b in res_a.bound]
        if on_host and any(p is not None and (p.gang_name or p.quota_name)
                           for p in bound_pods):
            raise AssertionError(f"ladder cycle {c}: the host fallback "
                                 "bound a gang or quota pod")
        if on_host != (c in (5, 6, 7)):
            raise AssertionError(f"ladder cycle {c}: host fallback "
                                 f"{on_host}")
        if device == "cuda" and (
                (on_host and la["full_chain"] != 0)
                or (not on_host and la["full_chain"] < 1)
                or (c == 4 and la != {"full_chain": 1,
                                      "full_chain_replay": 0})
                or (c == LADDER_CYCLES and la["full_chain_replay"] < 1)):
            # cycle 4's pass re-runs serially after the fused window's
            # demotion; back at full, the fused dispatch replays again
            raise AssertionError(f"ladder cycle {c}: launches {la}")
        if not res_a.bound:
            raise AssertionError(f"ladder cycle {c}: nothing bound")
        if on_host:
            fallback_s.append(hf_s)
        rows.append({"cycle": c, "level": faulted.ladder.level_name,
                     "K": k_a, "twin_K": k_b, "waves": res_a.waves,
                     "ms": wall_a * 1e3, "twin_ms": wall_b * 1e3,
                     "bound": len(res_a.bound), "twin_bound": len(res_b.bound),
                     "retries": dr, "launches": la,
                     "host_fallback_s": hf_s})
    transitions = [(t["from"], t["to"]) for t in faulted.ladder.transitions]
    if transitions != LADDER_WALK:
        raise AssertionError(f"ladder: transitions {transitions}")
    if len(plan.injected) != sum(f.count for f in LADDER_FAULTS):
        raise AssertionError(f"ladder: faults fired {plan.injected}")
    overruns = (scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.get(
        path="fused") or 0.0) - overruns0
    if overruns != 1:
        raise AssertionError(f"ladder: {overruns} deadline overruns")
    assert_ladder_full("ladder twin (b)", retries_now(), twin)
    retries = {s: retries_now()[s] - retries0[s] for s in retries0}
    emit({"phase": "ladder", "nodes": n_nodes, "pods": n_pods,
          "arrivals_per_cycle": arrivals, "churn_cycles": LADDER_CYCLES,
          "promote_after": LADDER_PROMOTE_AFTER,
          "dispatch_deadline_ms": LADDER_DEADLINE_MS,
          "latency_delay_ms": LADDER_DELAY_MS,
          "faults": plan.injected,
          "transitions": faulted.ladder.transitions,
          "retries": retries, "deadline_overruns": overruns,
          "identical_through_retries": True,
          "invariant_breaches": 0, "cycles": rows,
          "host_fallback_seconds": fallback_s,
          "repromoted_cycle_ms": rows[-1]["ms"],
          "twin_cycle_ms": rows[-1]["twin_ms"],
          "launches": total})
    return total


def ladder_cycle(sched, now):
    """One cycle with the launch counts set to 0 just before it and read
    just after. Returns (result, wall seconds, launches, K)."""
    fck.launches = fck.replay_launches = sk.launches = 0
    t0 = time.perf_counter()
    res = sched.run_cycle(now=now)
    wall = time.perf_counter() - t0
    if sk.launches:
        raise AssertionError("the LoadAware kernel ran in a scheduler cycle")
    kspan = last_cycle_root(sched).find("kernel")
    k = int(kspan.attributes.get("waves", "1")) if kspan else 1
    return (res, wall, {"full_chain": fck.launches,
                        "full_chain_replay": fck.replay_launches}, k)


def run_sim(device):
    """The sim's scenarios on the card and on the CPU in this process: the
    CPU run's binding log (SHA-256) must equal the card run's over the
    cycles both ran, with zero invariant breaches and no cycle exception
    on either, smoke's ladder round trip in cycles_at_level, and in every
    scenario that injects no fault the card's ladder at full in every
    cycle with no dispatch retry. Returns the kernels' launches on the
    card."""
    rows = []
    total = {"full_chain": 0, "full_chain_replay": 0}
    for name, cycles, cpu_cycles in SIM_SCENARIOS:
        retries0 = retries_now()
        fck.launches = fck.replay_launches = sk.launches = 0
        t0 = time.perf_counter()
        card = run_scenario(SCENARIOS[name].resolved(cycles=cycles),
                            device=device)
        card_s = time.perf_counter() - t0
        if not SCENARIOS[name].faults and (
                card.cycles_at_level != {"full": cycles}
                or card.ladder_transitions or retries_now() != retries0):
            raise AssertionError(
                f"sim {name}: the ladder moved with no fault injected: "
                f"{card.cycles_at_level} {card.ladder_transitions} "
                f"retries {retries0} -> {retries_now()}")
        launches = {"full_chain": fck.launches,
                    "full_chain_replay": fck.replay_launches}
        t0 = time.perf_counter()
        cpu = run_scenario(SCENARIOS[name].resolved(cycles=cpu_cycles),
                           device="cpu")
        cpu_s = time.perf_counter() - t0
        for key in total:
            total[key] += launches[key]
        # the binding log's lines start with their cycle
        prefix = [line for line in card.binding_log
                  if int(line.split("\t", 1)[0]) < cpu_cycles]
        if prefix != cpu.binding_log:
            first = next((i for i, (a, b) in enumerate(
                zip(prefix, cpu.binding_log)) if a != b),
                min(len(prefix), len(cpu.binding_log)))
            raise AssertionError(
                f"sim {name}: the card's binding log differs from the "
                f"CPU's at line {first}: "
                f"{prefix[first:first + 1]} != "
                f"{cpu.binding_log[first:first + 1]}")
        for where, rep in (("card", card), ("cpu", cpu)):
            if rep.invariant_breaches or rep.cycle_exceptions:
                raise AssertionError(
                    f"sim {name} on the {where}: "
                    f"{rep.invariant_breaches[:3]} "
                    f"{rep.cycle_exceptions[:3]}")
        if cpu_cycles == cycles and (
                card.cycles_at_level != cpu.cycles_at_level
                or card.ladder_transitions != cpu.ladder_transitions):
            raise AssertionError(f"sim {name}: the ladders differ")
        if device == "cuda" and launches["full_chain"] < 1:
            raise AssertionError(f"sim {name}: no kernel launch on the card")
        if name == "smoke" and (
                set(card.cycles_at_level) != {"full", "host-fallback"}
                or card.final_level != "full"):
            raise AssertionError(f"sim smoke: no ladder round trip: "
                                 f"{card.cycles_at_level}")
        report = card.to_dict()
        rows.append({
            "scenario": name, "cycles": cycles, "cpu_cycles": cpu_cycles,
            "sha256": card.binding_log_sha256[:16],
            "cpu_sha256": cpu.binding_log_sha256[:16],
            "bindings": len(card.binding_log),
            "cycles_at_level": card.cycles_at_level,
            "transitions": [(t["from"], t["to"])
                            for t in card.ladder_transitions],
            "slo_met": {"ttb_p99": report["slo"]["met"],
                        "restart": report["restart"]["met"],
                        **{k: v["met"] for k, v in report["slos"].items()}},
            "ttb_p99_seconds": report["time_to_bind_seconds"]["p99"],
            "card_seconds": card_s, "cpu_seconds": cpu_s,
            "card_ms_per_cycle": card_s / cycles * 1e3,
            "cpu_ms_per_cycle": cpu_s / cpu_cycles * 1e3,
            "launches": launches})
    emit({"phase": "sim", "scenarios": rows, "sha_equal": True,
          "invariant_breaches": 0,
          "cut": "the CPU twins of gang-storm and spot-churn run 150 of "
                 "the card's 300 cycles (time limit)"})
    return total


def kernel_entry(name, source, replaces, launches, mism, err, ms, plain_ms,
                 bytes_ms, ops_ms, **extra):
    """One kernel's entry of the kernels line. No PyTorch call computes
    either serial round, nor the kept-only replay, so library_ms is null.
    ``extra`` adds keys (the full chain's launches split by path: the
    sidecar call, the serial Scheduler cycles, the waves' pass 1)."""
    return {**extra,
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

    # ---- the scheduler cycle: config 4 with churn, then the mixed cluster
    # against its CPU twin (first, so cycle 0 holds the run's first call of
    # the kernel library)
    scheduler_launches = run_scheduler(device)
    run_scheduler_mixed(device)
    # ---- the default path: auto waves, chained dispatch
    wave_launches, replay_entry, fc4 = run_scheduler_waves(device)
    run_scheduler_waves_mixed(device)
    run_waves_carried(device, fc4)
    # ---- the degradation ladder at config 4, then the sim's scenarios
    ladder_launches = run_ladder(device)
    sim_launches = run_sim(device)
    replay_entry.update(
        launches_waves=replay_entry["launches"],
        launches_ladder=ladder_launches["full_chain_replay"],
        launches_sim=sim_launches["full_chain_replay"])
    replay_entry["launches"] += (ladder_launches["full_chain_replay"]
                                 + sim_launches["full_chain_replay"])

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
                     main_launches + scheduler_launches
                     + wave_launches["full_chain"]
                     + ladder_launches["full_chain"]
                     + sim_launches["full_chain"], mism, err, kernel_ms,
                     plain_ms, bytes_ms, ops_ms, launches_sidecar=main_launches,
                     launches_scheduler=scheduler_launches,
                     launches_waves=wave_launches["full_chain"],
                     launches_ladder=ladder_launches["full_chain"],
                     launches_sim=sim_launches["full_chain"]),
        la_kernel, replay_entry]})
    print(card, flush=True)
    # count: the cards this script drives
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
