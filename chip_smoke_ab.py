"""Kernels 1 and 2 as chip_smoke.py times them, before and after its
pack_overlap phase, for two or more trees on one card in one call.

    python3 chip_smoke_ab.py NAME=DIR [NAME=DIR ...] [--out FILE]

Each DIR is a checkout of the repo (say the parent commit's, unpacked under
build/, and `.`). For each tree in the order given and again in reverse, a
process of its own runs with DIR as its working directory and first on the
path: it imports that tree's chip_smoke.py, builds its kernels as the
script's main does, turns Python's cyclic collector off as main does, and
then:

1. times kernel 1 on config 4's round as main times it (synth_full_cluster(
   5000, 10000, seed=42, num_quotas=100, num_gangs=200), packed and reduced
   to its active axes, the wrapper's full_chain_round on it: CUDA events
   around the call, median of chip_smoke.REPS after a warm-up) and its
   launch alone (testing/kernel_ab.launch_alone_ms), then kernel 2 on the
   LoadAware headline (synth_cluster(5000, 10000, seed=42)) as the
   loadaware phase times it, the call and the launch alone;
2. runs the tree's own pack_overlap phase (chip_smoke.run_pack_overlap);
3. times both kernels again, on the same tensors.

Both rounds' chosen vectors must hash alike in every process. One JSON line
per process, then the card's nvidia-smi name and power limit; --out also
writes the lines as one JSON list.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import subprocess
import sys
import time


def worker() -> int:
    sys.path[0] = os.getcwd()  # the tree under test, not this file's
    import chip_smoke as cs

    gc.disable()
    cs.build_libraries(cs.fck.SOURCE, cs.sk.SOURCE, cs.ek.SOURCE,
                       cs.fck.REPLAY_SOURCE, cs.IPC_SOURCE,
                       cs.mailbox_rtt.SOURCE)
    args = cs.LoadAwareArgs()
    _cluster, state = cs.synth_full_cluster(5000, 10000, seed=42,
                                            num_quotas=100, num_gangs=200)
    fc, _ng, _ngroups, active = cs.pack(state, args)
    dev_fc = cs.to_device(fc, "cuda")
    wi, bi = cs.resolve_weight_idx(args, active), cs.resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    inputs = cs.schedule_inputs_from_numpy(cs.loadaware_inputs(
        cs.synth_cluster(num_nodes=5000, num_pods=10000, seed=42), args
    )._asdict(), "cuda")
    widx = cs.resolve_weight_idx(args)

    def round1():
        return cs.fck.full_chain_round(dev_fc, wi, prod, bi)

    def round2():
        return cs.sk.schedule_round(inputs, widx, prod)

    def timings():
        return {
            "kernel1_ms": cs.time_cuda(round1, cs.REPS),
            "kernel1_launch_ms": cs.launch_alone_ms(
                cs.fck, "_lib", "full_chain_launch", round1, cs.REPS),
            "kernel2_ms": cs.time_cuda(round2, cs.REPS),
            "kernel2_launch_ms": cs.launch_alone_ms(
                cs.sk, "_lib", "schedule_step_launch", round2, cs.REPS)}

    digests = {
        name: hashlib.sha256(
            fn()[0].cpu().numpy().astype("<i4").tobytes()).hexdigest()
        for name, fn in (("kernel1", round1), ("kernel2", round2))}
    before = timings()
    t0 = time.perf_counter()
    cs.run_pack_overlap("cuda")
    pack_overlap_s = time.perf_counter() - t0
    after = timings()
    print(json.dumps({"before": before, "after": after,
                      "pack_overlap_seconds": pack_overlap_s,
                      "chosen_sha256": digests}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    specs = [spec.split("=", 1) for spec in opts.trees]
    rows = []
    for name, root in specs + specs[::-1]:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker"], cwd=root, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"chip_smoke_ab: {name} failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        row = {"tree": name, "process_seconds": time.perf_counter() - t0,
               **json.loads(proc.stdout.strip().splitlines()[-1])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if len({json.dumps(r["chosen_sha256"], sort_keys=True)
            for r in rows}) != 1:
        print("chip_smoke_ab: the trees' rounds disagree", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump({"card": card.strip(), "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        sys.exit(worker())
    sys.exit(main())
