"""Compare kernel source trees, or whole package trees, on one card, in
one call.

    python3 -m koordinator_tpu_torch.testing.kernel_ab NAME=DIR [NAME=DIR ...]
    python3 -m koordinator_tpu_torch.testing.kernel_ab --packages \
        NAME=ROOT [NAME=ROOT ...]

Each DIR holds a full_chain.cu, a schedule_step.cu and the kernel_common.cuh
they include, with the parameter structs and C entry points of the
package's csrc/ (DIR `csrc` means the package's own). A tree may lay out its
shared memory differently: its launch sizes that from its own layout, and
the wrappers' cross-check against estimate_smem_bytes is waived for it.

Every tree is first held against the plain rounds on the card, in both
states (shared and device memory): the full chain on BASELINE config 4
(10240 pods x 5120 nodes) and on the mixed cluster (1000 x 2000) with the
default, prod-mode and three-weight arguments, the LoadAware round on
bench.py's default chain (10240 x 5120 x 14). Any binding that differs, or
any |err| above 0, raises. Then each kernel's round at the main shapes is
timed (CUDA events, median of 10 after a warm-up) in both states, for the
trees in the order given and again in reverse, so that a drift of the card
shows as a difference between the two passes. One JSON line per check and
per timing, then the card's nvidia-smi name and power limit.

With --packages each ROOT holds a whole koordinator_tpu_torch (say the
parent commit's, unpacked under build/, and `.`), whose wrappers may differ
from this one's. Each runs in a process of its own with that package first
on the path, in the order given and again in reverse: it builds its
kernels, then (1) the instances over a mesh of cards at D = 2 virtual cards
of the card, at config 4 (testing/mesh_round.check_exchange: kernel 1's
exchange round and terms round, the per-card replay, the per-card stage
counts and kernel 2's exchange instance, each held bit for bit against the
single-device kernels, then timed), and (2) the kept-pod replay at cycle 0's
kept set (the config 4 round after Permit, from the cycle-start state):
the wrapper's call and, apart, the kernel's launch alone (CUDA events
around the library call), held bit for bit against the plain replay_kept
the first time a tree runs, and (3) the stage-count pass called alone at
P = 10240 and at the churn wave's 1280 (the call, the launch alone and the
kernel's device time under torch.profiler; the counts held against the
plain counts the first time a tree runs), the explain step at "counts"
against the step with explain off, and the Scheduler's churn cycle at
config 4 with explain "counts" (host clock). Every run's outputs must hash
alike across the trees. Then each tree's testing/pod_trace.py runs once
(its exchange instance's "merge" phase cycles). One JSON line per run,
then the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import types
from pathlib import Path

import torch

from koordinator_tpu_torch.api.resources import ResourceName
from koordinator_tpu_torch.models.convert import (
    schedule_inputs_from_numpy,
    to_device,
)
from koordinator_tpu_torch.models.full_chain import (
    build_full_chain_step,
    cycle_start_state,
    explain_stage_counts,
    permit,
    resolve_balance_idx,
    resolve_weight_idx,
)
from koordinator_tpu_torch.models.scheduler_model import build_schedule_step
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import kernel_common
from koordinator_tpu_torch.ops import schedule_kernel as sk
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing.synth import (
    loadaware_inputs,
    mixed_cluster,
    synth_cluster,
    synth_full_cluster,
)

REPS = 10
PACKAGE_CSRC = kernel_common.CSRC_DIR
_LIB = {fck: fck._lib, sk: sk._lib}
_NAME = {fck: "full_chain", sk: "schedule_step"}


def _estimate(module, ref) -> int:
    """The package's estimate for a launch's parameters."""
    q = ref._obj
    state = "smem" if q.state_in_smem else "global"
    if module is fck:
        return fck.estimate_smem_bytes(q.N, q.R, q.n_widx, q.K, q.G, q.D, q.T,
                                       q.PT, q.VG, q.cluster_size, state)
    return sk.estimate_smem_bytes(q.N, q.R, q.n_widx, q.cluster_size, state)


def use(tree: Path) -> None:
    """Point both wrappers at the kernels built from ``tree``."""
    kernel_common.CSRC_DIR = tree
    kernel_common._LIBS.clear()
    for module in (fck, sk):
        module._lib = _LIB[module]
        if tree == PACKAGE_CSRC:
            continue
        name = _NAME[module]
        lib = kernel_common.load_library(module.SOURCE)
        if lib[f"{name}_params_size"]() != ctypes.sizeof(module._Params):
            raise RuntimeError(f"{tree}: {name} parameters differ from "
                               "the wrapper's")
        launch = lib[f"{name}_launch"]
        launch.restype = ctypes.c_int
        launch.argtypes = [ctypes.POINTER(module._Params), ctypes.c_void_p]
        module._lib = (lambda ns: lambda: ns)(types.SimpleNamespace(**{
            f"{name}_launch": launch,
            f"{name}_smem_bytes": (
                lambda module: lambda ref: _estimate(module, ref))(module),
            # trees without the entry point had one instance: report it
            # as the common one
            f"{name}_instance": lambda ref: 1,
        }))


def time_ms(fn, reps: int = REPS) -> float:
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


def full_chain_case(tag, state, args):
    fc, _p, _n, _t, _gi, ng, ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    dev = to_device(fc, "cuda")
    wi, bi = resolve_weight_idx(args, active), resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    plain = build_full_chain_step(args, ng, ngroups, active)(dev)

    def check(budget):
        chosen, requested, quota = fck.full_chain_round(
            dev, wi, prod, bi, smem_budget_bytes=budget)
        chosen = permit(dev, chosen, ng, ngroups)
        return (int((chosen != plain[0]).sum()),
                float(max((requested - plain[1]).abs().max(),
                          (quota - plain[2]).abs().max())))

    return tag, check, lambda b: fck.full_chain_round(
        dev, wi, prod, bi, smem_budget_bytes=b)


def loadaware_case(args):
    inputs = schedule_inputs_from_numpy(loadaware_inputs(
        synth_cluster(num_nodes=5000, num_pods=10000, seed=42), args
    )._asdict(), "cuda")
    wl = resolve_weight_idx(args)
    plain = build_schedule_step(args)(inputs)

    def check(budget):
        chosen, requested = sk.schedule_round(inputs, wl, False,
                                              smem_budget_bytes=budget)
        return (int((chosen != plain[0]).sum()),
                float((requested - plain[1]).abs().max()))

    return "loadaware", check, lambda b: sk.schedule_round(
        inputs, wl, False, smem_budget_bytes=b)


def launch_alone_ms(module, getter: str, name: str, fn,
                    reps: int = REPS) -> float:
    """Median milliseconds of the library call ``name`` (a kernel's
    launch) inside ``fn`` over ``reps`` runs after a warm-up: CUDA events
    around that call only, the wrapper's own work outside them.
    ``module.getter`` returns the library; a stand-in answers for it
    during the runs."""
    orig = getattr(module, getter)
    lib = orig()
    real = getattr(lib, name)
    spans = []

    class Timed:
        def __getattr__(self, attr):
            return getattr(lib, attr)

    def timed(*a):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a)
        stop.record()
        spans.append((start, stop))
        return out

    stand_in = Timed()
    setattr(stand_in, name, timed)
    setattr(module, getter, lambda: stand_in)
    try:
        for _ in range(reps + 1):
            fn()
        torch.cuda.synchronize()
    finally:
        setattr(module, getter, orig)
    return statistics.median(a.elapsed_time(b) for a, b in spans[1:])


def kernel_device_ms(fn, kernel: str, reps: int = REPS):
    """Device milliseconds a call of ``fn`` spends in the kernels whose
    name holds ``kernel``, over ``reps`` calls after a warm-up
    (torch.profiler's CUPTI trace); None where the trace holds no such
    kernel (a profiler that sees no device)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    return sum(spans) / 1e3 / reps if spans else None


def pod_rows(fc, n: int):
    """The first ``n`` pods of a batch: every per-pod field cut to its
    first n rows (the churn wave's P out of config 4's)."""
    P = fc.base.fit_requests.shape[0]

    def cut(t):
        return t[:n].contiguous() if t.dim() and t.shape[0] == P else t

    return type(fc)(type(fc.base)(*(cut(t) for t in fc.base)),
                    *(cut(t) for t in fc[1:]))


def counts_timings(ek, fc, n_real: int) -> dict:
    """The stage-count pass called alone on ``fc`` at its own state: the
    call packing its own records (CUDA events around the wrapper), the
    launch alone (around the library call) and the kernel's device time
    (torch.profiler); where the wrapper takes a pack (``ek.pack_for``),
    also the call on a pack made beforehand, as the main path hands it
    the round's."""
    from koordinator_tpu_torch.models.full_chain import cycle_start_state

    state = cycle_start_state(fc)

    def call():
        return ek.explain_counts(fc, state, n_real)

    out = {"call_ms": time_ms(call),
           "launch_ms": launch_alone_ms(ek, "_lib", "explain_launch", call),
           "device_ms": kernel_device_ms(call, "explain_counts")}
    if hasattr(ek, "pack_for"):
        pack = ek.pack_for(fc)
        out["call_on_pack_ms"] = time_ms(
            lambda: ek.explain_counts(fc, state, n_real, pack=pack))
    return out


def scheduler_explain_cycle_ms(cycles: int = 3) -> list:
    """The port's Scheduler at config 4 with explain "counts" (the default
    path): cycle 0, one churn cycle of 1000 arrivals to warm up, then
    ``cycles`` timed churn cycles (host clock, each ending in its
    readback)."""
    import time

    from koordinator_tpu_torch.scheduler.cycle import Scheduler
    from koordinator_tpu_torch.testing.churn import (
        add_arrivals,
        arrival_specs,
        churn_store,
    )

    store, state = churn_store(5000, 10000, seed=42)
    sched = Scheduler(store, device="cuda", explain="counts")
    walls = []
    for c in range(2 + cycles):
        if c:
            add_arrivals(store, arrival_specs(c, 1000), state.now + c)
        t0 = time.perf_counter()
        sched.run_cycle(now=state.now + 2 * c)
        if c > 1:
            walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def worker(plain: bool) -> int:
    """One package's exchange and replay measurements (run with that
    package first on the path); prints one JSON line."""
    from koordinator_tpu_torch.models import fused_waves
    from koordinator_tpu_torch.ops import explain_kernel as ek
    from koordinator_tpu_torch.parallel.full_chain_mesh import replay_state0
    from koordinator_tpu_torch.testing import mesh_round

    replay_source = getattr(fck, "REPLAY_SOURCE", None)
    kernel_common.build_libraries(
        fck.SOURCE, sk.SOURCE, ek.SOURCE,
        *([replay_source] if replay_source else []))
    args = LoadAwareArgs()
    _c, state = synth_full_cluster(5000, 10000, seed=42, num_quotas=100,
                                   num_gangs=200)
    fc, _p, _n, _t, _gi, ng, ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    la_host = loadaware_inputs(synth_cluster(num_nodes=5000, num_pods=10000,
                                             seed=42), args)
    row, = mesh_round.check_exchange(fc, args, ng, ngroups, active, 5000,
                                     la_host, depths=(2,))
    bad = {k: v for k, v in row.items() if k.endswith("mismatches") and v}
    if bad:
        raise AssertionError(f"the exchange instances disagree: {bad}")
    dev = to_device(fc, "cuda")
    wi, bi = resolve_weight_idx(args, active), resolve_balance_idx(active)
    chosen = fck.full_chain_round(dev, wi, False, bi)[0]
    kept = permit(dev, chosen, ng, ngroups) >= 0
    state0 = replay_state0(dev, False)

    def replay():
        return fck.full_chain_replay(dev, chosen, kept, state0, False)

    out, zones = replay()
    # the stage-count pass: called alone at P = 10240 and the churn
    # wave's 1280, and inside the explain step at "counts" against the
    # step with explain off
    state = cycle_start_state(dev)
    counts = ek.explain_counts(dev, state, 5000)
    wave = pod_rows(dev, 1280)
    counts_w = ek.explain_counts(wave, cycle_start_state(wave), 5000)
    steps = {ex: fck.build_cuda_full_chain_step(args, ng, ngroups, active,
                                                explain=ex)
             for ex in (None, "counts")}
    outputs = list(out) + [zones, counts, counts_w]
    res = {"exchange": row, "kept": int(kept.sum()),
           "counts_P10240": counts_timings(ek, dev, 5000),
           "counts_P1280": counts_timings(ek, wave, 5000),
           "step_off_ms": time_ms(lambda: steps[None](dev)),
           "step_counts_ms": time_ms(lambda: steps["counts"](dev, 5000)),
           "scheduler_explain_cycle_ms": scheduler_explain_cycle_ms(),
           "most_kept_on_a_node": int(torch.bincount(
               chosen[kept].long()).max()),
           "replay_wrapper_ms": time_ms(replay),
           "replay_kernel_ms": (
               launch_alone_ms(fck, "_replay_lib", "replay_launch", replay)
               if replay_source else
               launch_alone_ms(fck, "_lib", "full_chain_launch", replay)),
           "digest": _digest(outputs)}
    if plain:
        filled = tuple(torch.zeros_like(dev.base.requested) if t is None
                       else t for t in state0)
        want, want_zones = fused_waves.replay_kept(dev, False, filled,
                                                   chosen, kept)
        res["replay_plain_mismatches"] = sum(
            mesh_round._mismatches(a.cpu(), b.cpu())
            for a, b in zip(outputs, list(want) + [want_zones]))
        if res["replay_plain_mismatches"]:
            raise AssertionError("the replay disagrees with replay_kept")
        res["counts_plain_mismatches"] = sum(
            int((a.to(torch.int64) != explain_stage_counts(
                f, cycle_start_state(f), 5000).to(torch.int64)).sum())
            for a, f in ((counts, dev), (counts_w, wave)))
        if res["counts_plain_mismatches"]:
            raise AssertionError("the stage counts disagree with the plain "
                                 "counts")
    print(json.dumps(res), flush=True)
    return 0


def packages_main(specs) -> int:
    """The --packages A/B: each tree's worker, in order and reversed, then
    each tree's pod_trace."""
    script = str(Path(__file__).resolve())
    digests = set()
    checked = set()
    for name, root in specs + specs[::-1]:
        env = dict(os.environ, PYTHONPATH=str(root))
        cmd = [sys.executable, script, "--worker"]
        if name not in checked:
            cmd.append("--plain")
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"kernel_ab: the {name} worker failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        checked.add(name)
        digests.add(res.pop("digest"))
        print(json.dumps({"tree": name, **res}), flush=True)
    for name, root in specs:
        env = dict(os.environ, PYTHONPATH=str(root))
        proc = subprocess.run(
            [sys.executable, "-m", "koordinator_tpu_torch.testing.pod_trace"],
            cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"kernel_ab: the {name} pod_trace failed")
        for line in proc.stdout.strip().splitlines():
            if line.startswith("{"):
                print(json.dumps({"tree": name, "pod_trace": json.loads(
                    line)}), flush=True)
    if len(digests) != 1:
        raise AssertionError("the trees' replay outputs differ")
    print(json.dumps({"replay_outputs_equal_across_trees": True}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--worker"]:
        return worker("--plain" in sys.argv)
    if sys.argv[1:2] == ["--packages"]:
        specs = []
        for arg in sys.argv[2:]:
            name, _, path = arg.partition("=")
            specs.append((name, Path(path).resolve()))
        status = packages_main(specs)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
        return status
    trees = []
    for arg in sys.argv[1:]:
        name, _, path = arg.partition("=")
        trees.append((name, PACKAGE_CSRC if path == "csrc" else Path(path)))
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for _name, tree in trees:  # every build before any timing
        use(tree)
        kernel_common.build_libraries(fck.SOURCE, sk.SOURCE)
    args = LoadAwareArgs()
    three = LoadAwareArgs(resource_weights={
        ResourceName.CPU: 1, ResourceName.MEMORY: 1, ResourceName.PODS: 1})
    main_case = full_chain_case("main", synth_full_cluster(
        5000, 10000, seed=42, num_quotas=100, num_gangs=200)[1], args)
    la_case = loadaware_case(args)
    cases = [main_case, la_case] + [
        full_chain_case(tag, mixed_cluster(7, 1000, 2000)[1], a)
        for tag, a in (("mixed", args),
                       ("prod", LoadAwareArgs(score_according_prod_usage=True)),
                       ("three_weights", three))]
    for name, tree in trees:
        use(tree)
        for tag, check, _run in cases:
            for budget in (None, 0):
                mism, err = check(budget)
                print(json.dumps({"tree": name, "check": tag,
                                  "budget": budget, "mismatches": mism,
                                  "max_abs_err": err}), flush=True)
                if mism or err != 0.0:
                    raise AssertionError(f"{name}: {tag} disagrees with the "
                                         "plain round")
    for name, tree in trees + trees[::-1]:
        use(tree)
        for budget in (None, 0):
            print(json.dumps({
                "tree": name, "budget": budget,
                "full_chain_ms": time_ms(lambda: main_case[2](budget)),
                "schedule_step_ms": time_ms(lambda: la_case[2](budget)),
            }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
