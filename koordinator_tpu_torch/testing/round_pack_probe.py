"""The round's host pack against the device's own pack, on one world.

    python3 -m koordinator_tpu_torch.testing.round_pack_probe \
        [--nodes 5000] [--pods 10000] [--device cuda] [--reps 10]

Builds config 4's world (synth_full_cluster(nodes, pods, seed=42,
num_quotas=pods // 100, num_gangs=pods // 50), packed and sliced to its
active axes as the Scheduler packs it) and moves it to the device twice:
through DeviceSnapshot.upload(fc, pack=True), the serial dispatch's
upload with its host round pack (models/round_pack.py), and through
models/convert.to_device, with no pack. Then:

* the card route's buffers (ops/full_chain_kernel._round_buffers) on
  each upload, equal field for field, and the torch calls each makes
  (testing/scrape_convoy.CallCounter);
* on CUDA: kernel 1's round on each upload, its three outputs equal;
  the torch calls of the whole round on the packed upload; each round's
  milliseconds (CUDA events, median of ``--reps``); the packed upload's
  seconds;
* the plain round at explain "full" (what chip_smoke.py's main phase
  times) on the unpacked tensors: its seconds, and on CUDA its
  mismatches against kernel 1.

Prints one JSON line, after the card's name and power limit (nvidia-smi)
on CUDA. Any disagreement raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def _time_ms(fn, reps: int) -> float:
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


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _equal(tag, got, want) -> None:
    for k, (a, b) in enumerate(zip(got, want)):
        if a is None and b is None:
            continue
        if isinstance(a, dict):
            for key in b:
                if not torch.equal(a[key].to(b[key].dtype), b[key]):
                    raise AssertionError(f"{tag}: state {key} differs")
        elif not torch.equal(a, b):
            raise AssertionError(f"{tag}: item {k} differs")


def probe(n_nodes: int = 5000, n_pods: int = 10000, device="cuda",
          reps: int = 10, plain: bool = True) -> dict:
    """The checks and numbers above, as a dict."""
    from koordinator_tpu_torch.models.convert import to_device
    from koordinator_tpu_torch.models.full_chain import (
        build_full_chain_step,
        resolve_balance_idx,
        resolve_weight_idx,
    )
    from koordinator_tpu_torch.ops import full_chain_kernel as fck
    from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
    from koordinator_tpu_torch.scheduler.snapshot import (
        build_full_chain_inputs,
        reduce_to_active_axes,
    )
    from koordinator_tpu_torch.scheduler.snapshot_cache import DeviceSnapshot
    from koordinator_tpu_torch.testing import synth_full_cluster
    from koordinator_tpu_torch.testing.scrape_convoy import CallCounter

    args = LoadAwareArgs()
    _cluster, state = synth_full_cluster(
        n_nodes, n_pods, seed=42, num_quotas=max(n_pods // 100, 1),
        num_gangs=max(n_pods // 50, 1))
    fc, _p, _n, _t, _g, ng, ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    widx = resolve_weight_idx(args, active)
    bal = resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    snap = DeviceSnapshot(device)
    t0 = time.perf_counter()
    packed = snap.upload(fc, pack=True)
    _sync(device)
    upload_s = time.perf_counter() - t0
    dev_fc = to_device(fc, device)
    counts = {}
    bufs = {}
    for tag, f in (("packed", packed), ("unpacked", dev_fc)):
        counter = CallCounter()
        with counter:
            bufs[tag] = fck._round_buffers(f, list(widx), False)
        counts[tag] = counter.n
    _equal("round buffers", bufs["packed"], bufs["unpacked"])
    out = {"nodes": n_nodes, "pods": n_pods, "device": str(device),
           "P": int(fc.base.fit_requests.shape[0]),
           "N": int(fc.base.allocatable.shape[0]),
           "upload_pack_seconds": upload_s,
           "round_buffers_calls": counts["packed"],
           "round_buffers_calls_unpacked": counts["unpacked"],
           "pack_stats": dict(snap.pack_stats)}
    kernel = torch.device(device).type == "cuda"
    if kernel:
        a = fck.full_chain_round(packed, widx, prod, bal)
        b = fck.full_chain_round(dev_fc, widx, prod, bal)
        _equal("kernel 1 round", a, b)
        counter = CallCounter()
        with counter:
            fck.full_chain_round(packed, widx, prod, bal)
        out["full_chain_round_calls"] = counter.n
        out["kernel_ms_packed"] = _time_ms(
            lambda: fck.full_chain_round(packed, widx, prod, bal), reps)
        out["kernel_ms_unpacked"] = _time_ms(
            lambda: fck.full_chain_round(dev_fc, widx, prod, bal), reps)
    if plain:
        step = build_full_chain_step(args, ng, ngroups, active,
                                     explain="full")
        _sync(device)
        t0 = time.perf_counter()
        res = step(dev_fc, n_nodes)
        _sync(device)
        out["plain_seconds"] = time.perf_counter() - t0
        if kernel:
            k = fck.build_cuda_full_chain_step(args, ng, ngroups,
                                               active)(dev_fc)
            mism = int((k[0].cpu() != res[0].cpu()).sum())
            err = max(float((k[i].cpu() - res[i].cpu()).abs().max())
                      for i in (1, 2))
            if mism or err:
                raise AssertionError(f"kernel 1 against the plain round: "
                                     f"{mism} bindings, max |err| {err}")
            out["plain_mismatches"], out["plain_max_abs_err"] = mism, err
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="round_pack_probe")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=10000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        from koordinator_tpu_torch.ops import full_chain_kernel as fck
        from koordinator_tpu_torch.ops.kernel_common import build_libraries

        build_libraries(fck.SOURCE)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    rep = probe(args.nodes, args.pods, args.device, args.reps)
    print(json.dumps({k: (float(v) if isinstance(v, np.floating) else v)
                      for k, v in rep.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
