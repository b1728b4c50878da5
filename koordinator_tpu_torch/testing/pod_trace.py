"""Where one pod's time goes inside each CUDA kernel, on one card.

    python3 -m koordinator_tpu_torch.testing.pod_trace

Builds both kernels with -DKOORD_TRACE, which compiles in `KOORD_STAMP`:
block 0's thread 0 records `clock64` at each phase of every pod
(csrc/kernel_common.cuh). Runs one round of each kernel on its main path's
inputs (BASELINE config 4 for the full chain, bench.py's default chain for
the LoadAware round; 10240 pods x 5120 nodes), in the shared-memory and the
device-memory state, and prints the median cycles per pod of each phase of
that thread: waiting for the record, its node loop, publishing its warp's
best, waiting for every block's best, merging them, reserving (pods that
bind), and the whole pod; then the card's nvidia-smi name, power limit and
SM clock. The stamps add a few instructions per phase, so the traced round
is a little slower than the plain build.
"""

from __future__ import annotations

import ctypes
import json
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
from koordinator_tpu_torch.ops import kernel_common
from koordinator_tpu_torch.ops import schedule_kernel as sk
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

TRACE_PODS, TRACE_SLOTS = 16384, 8  # kernel_common.cuh kTracePods/kTraceSlots
# (name, from slot, to slot) of block 0's thread 0
PHASES = (("record_wait", 5, 0), ("node_loop", 0, 1), ("publish", 1, 2),
          ("merge_wait", 2, 3), ("merge", 3, 4), ("reserve", 4, 5))


def phases(trace: np.ndarray, n_pods: int) -> dict:
    """Median cycles of each phase over the pods that bound (slot 5 is
    stamped only there); record_wait runs from the previous pod's end."""
    t = trace.reshape(TRACE_PODS, TRACE_SLOTS)[:n_pods].astype(np.float64)
    bound = t[:, 5] > 0
    out = {}
    for name, a, b in PHASES:
        if name == "record_wait":
            prev_end = np.roll(t[:, 5], 1)
            ok = bound & np.roll(bound, 1)
            ok[0] = False
            out[name] = float(np.median((t[:, 0] - prev_end)[ok]))
        else:
            out[name] = float(np.median((t[:, b] - t[:, a])[bound]))
    out["pod"] = float(np.median(np.diff(t[:, 0])))
    out["pods_bound"] = int(bound.sum())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("pod_trace: CUDA is not available", file=sys.stderr)
        return 2
    kernel_common.BUILD_DEFINES = ("KOORD_TRACE",)
    kernel_common.build_libraries(fck.SOURCE, sk.SOURCE)
    args = LoadAwareArgs()
    _c, state = synth_full_cluster(5000, 10000, seed=42, num_quotas=100,
                                   num_gangs=200)
    fc, _p, _n, _t, _gi, _ng, _ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    dev_fc = to_device(fc, "cuda")
    wi, bi = resolve_weight_idx(args, active), resolve_balance_idx(active)
    inputs = schedule_inputs_from_numpy(loadaware_inputs(
        synth_cluster(num_nodes=5000, num_pods=10000, seed=42), args)._asdict(),
        "cuda")
    wl = resolve_weight_idx(args)
    runs = (
        ("full_chain", fck, int(fc.base.pod_valid.sum()),
         lambda b: fck.full_chain_round(dev_fc, wi, False, bi,
                                        smem_budget_bytes=b)),
        ("schedule_step", sk, int(inputs.pod_valid.sum().item()),
         lambda b: sk.schedule_round(inputs, wl, False, smem_budget_bytes=b)),
    )
    for name, module, n_pods, run in runs:
        copy = getattr(module._lib(), f"{name}_trace_copy")
        copy.restype = ctypes.c_int
        copy.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        for budget in (None, 0):
            run(budget)
            torch.cuda.synchronize()
            buf = np.zeros(TRACE_PODS * TRACE_SLOTS, dtype=np.int64)
            if copy(buf.ctypes.data, buf.nbytes) != 0:  # reads and zeroes
                raise RuntimeError(f"{name}: trace copy failed")
            print(json.dumps({"kernel": name,
                              "state": module.last_launch["state"],
                              "instance": module.last_launch["instance"],
                              "cycles": phases(buf, n_pods)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
