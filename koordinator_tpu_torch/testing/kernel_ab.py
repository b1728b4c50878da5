"""Compare kernel source trees on one card, in one call.

    python3 -m koordinator_tpu_torch.testing.kernel_ab NAME=DIR [NAME=DIR ...]

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
"""

from __future__ import annotations

import ctypes
import json
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


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
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
