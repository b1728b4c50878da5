"""The exchange's mailbox round trip on the card, and the exchanges one
config 4 round makes: the latency floor of kernel 1's exchange instance.

    python3 -m koordinator_tpu_torch.testing.mailbox_rtt [--rounds N]

Builds csrc/mailbox_rtt.cu: two threads pass one exchange entry (two
8-byte pairs, the flag in each pair's high half) back and forth through
the exchange's own store and load (kernel_common.cuh st_pair, ld_pairs),
each polling a box in its own card's memory. Prints one JSON line per
case with the median over ``--repeats`` runs of ``--rounds`` timed round
trips (%globaltimer ns and clock64 cycles): both sides on one card at
.gpu scope (the scope of an exchange whose shards all run in one launch)
and at .sys scope, and, where two cards are visible, side 0 on card 0 and
side 1 on card 1 at .sys scope (peer access on, over NVLink).

Then kernel 1's exchange round over 2 virtual cards of card 0 at BASELINE
config 4 (10000 pods x 5000 nodes): the exchanges it made, read back from
the mailboxes' flags (the highest flag stored less the launch group's
first, plus one), split into the winner exchanges (one per valid pod) and
the extremes exchanges (pods with spread or preferred-affinity terms). The
floor is exchanges x the one-way trip (half the .gpu round trip): each
exchange waits for one publish to arrive. Last, the card's nvidia-smi
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from koordinator_tpu_torch.ops.kernel_common import (
    KernelContractError,
    launch_error,
    load_library,
)

SOURCE = "mailbox_rtt.cu"
TIMEOUT_S = 5.0


class _RttParams(ctypes.Structure):
    """Mirror of RttParams in csrc/mailbox_rtt.cu, field for field."""

    _fields_ = [("box0", ctypes.c_void_p), ("box1", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("timeout_ns", ctypes.c_longlong),
                ("rounds", ctypes.c_int), ("warm", ctypes.c_int),
                ("gpu", ctypes.c_int), ("side0", ctypes.c_int)]


def _lib():
    lib = load_library(SOURCE)
    if lib.rtt_params_size() != ctypes.sizeof(_RttParams):
        raise KernelContractError("RttParams disagrees with the kernel's")
    return lib


def round_trip(dev0, dev1, gpu: bool, rounds: int, warm: int = 64) -> dict:
    """One run: side 0 on ``dev0``, side 1 on ``dev1`` (one launch of two
    blocks where they are the same card). Returns the timed trips' ns and
    cycles per round trip."""
    lib = _lib()
    box0 = torch.zeros(2, dtype=torch.int64, device=dev0)
    box1 = torch.zeros(2, dtype=torch.int64, device=dev1)
    out = torch.zeros(2, dtype=torch.int64, device=dev0)
    p = _RttParams()
    p.box0, p.box1, p.out = box0.data_ptr(), box1.data_ptr(), out.data_ptr()
    p.timeout_ns = int(TIMEOUT_S * 1e9)
    p.rounds, p.warm, p.gpu = int(rounds), int(warm), int(bool(gpu))
    torch.cuda.synchronize(dev0)
    torch.cuda.synchronize(dev1)
    sides = [(dev0, 0, 1 if dev0 == dev1 else 0)]
    if dev0 != dev1:
        sides.append((dev1, 1, 0))
    for dev, side0, extra in sides:
        p.side0 = side0
        with torch.cuda.device(dev):
            err = lib.rtt_launch(ctypes.byref(p), 1 + extra,
                                 ctypes.c_void_p(
                                     torch.cuda.current_stream(dev)
                                     .cuda_stream))
        if err != 0:
            raise launch_error("mailbox_rtt", err, f"on {dev}")
    torch.cuda.synchronize(dev0)
    torch.cuda.synchronize(dev1)
    ns, cycles = (int(v) for v in out.tolist())
    if ns < 0:
        raise AssertionError(f"mailbox_rtt: no round trip within "
                             f"{TIMEOUT_S} s ({dev0} <-> {dev1})")
    return {"ns": ns / rounds, "cycles": cycles / rounds}


def measure(dev0, dev1, gpu: bool, rounds: int, repeats: int) -> dict:
    runs = [round_trip(dev0, dev1, gpu, rounds) for _ in range(repeats)]
    return {"from": str(dev0), "to": str(dev1),
            "scope": "gpu" if gpu else "sys", "rounds": rounds,
            "repeats": repeats,
            "round_trip_ns": statistics.median(r["ns"] for r in runs),
            "round_trip_cycles": statistics.median(r["cycles"] for r in runs),
            "round_trip_ns_each": [r["ns"] for r in runs]}


def count_exchanges(device="cuda") -> dict:
    """Kernel 1's exchange round over 2 virtual cards at config 4: the
    exchanges it made, from the mailboxes' flags."""
    from koordinator_tpu_torch.models.convert import to_device
    from koordinator_tpu_torch.models.full_chain import resolve_balance_idx
    from koordinator_tpu_torch.models.scheduler_model import (
        resolve_weight_idx,
    )
    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
    from koordinator_tpu_torch.parallel.full_chain_mesh import node_rows
    from koordinator_tpu_torch.testing import mesh_round
    from koordinator_tpu_torch.testing.cross_card import CONFIG4, pack
    from koordinator_tpu_torch.testing.synth import synth_full_cluster

    args = LoadAwareArgs()
    n_nodes, n_pods = CONFIG4
    _c, state = synth_full_cluster(n_nodes, n_pods, seed=42,
                                   num_quotas=max(n_pods // 100, 1),
                                   num_gangs=n_pods // 50)
    fc_host, _ng, _ngroups, active = pack(state, args)
    mesh = mesh_round.exchanging_mesh(2, device)
    dev = mesh.flat[0].device
    fc = to_device(mesh_round._padded_fc(fc_host, mesh), dev)
    per = fc.base.allocatable.shape[0] // 2
    P = fc.base.fit_requests.shape[0]
    jobs = [(v, ks) for _d, ks, v in
            mesh_round._cards_of(fc, mesh, per, node_rows)]
    box = mesh.mailboxes()
    outs = fk.full_chain_round_cards(
        jobs, resolve_weight_idx(args, active),
        args.score_according_prod_usage, resolve_balance_idx(active), box)
    flag0 = box.next_seq - (2 * P + 1)  # begin(2 * P) moved it past
    top = max(int(((b >> 32) & 0xFFFFFFFF).max()) for b in box.boxes)
    exchanges = top - flag0 + 1
    valid = int(fc.base.pod_valid.sum())
    return {"pods": P, "valid_pods": valid, "exchanges": exchanges,
            "winner_exchanges": valid,
            "extremes_exchanges": exchanges - valid,
            "bound": int((outs[0][0] >= 0).sum())}


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--no-round", action="store_true",
                    help="leave out the config 4 round's exchange count")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mailbox_rtt: CUDA is not available", file=sys.stderr)
        return 2
    c0 = torch.device("cuda", 0)
    rows = [measure(c0, c0, True, opts.rounds, opts.repeats),
            measure(c0, c0, False, opts.rounds, opts.repeats)]
    if torch.cuda.device_count() >= 2:
        from koordinator_tpu_torch.ops.full_chain_kernel import (
            enable_peer_access,
        )

        c1 = torch.device("cuda", 1)
        if not torch.cuda.can_device_access_peer(0, 1):
            raise AssertionError("cuda:0 cannot reach cuda:1's memory")
        enable_peer_access([c0, c1])
        rows.append(measure(c0, c1, False, opts.rounds, opts.repeats))
    for row in rows:
        print(json.dumps({"check": "round_trip", **row}), flush=True)
    if not opts.no_round:
        count = count_exchanges()
        one_way = rows[0]["round_trip_ns"] / 2
        print(json.dumps({"check": "exchanges", **count,
                          "one_way_ns": one_way,
                          "floor_ms": count["exchanges"] * one_way * 1e-6}),
              flush=True)
    for line in card_lines():
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
