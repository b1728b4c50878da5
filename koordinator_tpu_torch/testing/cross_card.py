"""The mesh of cards on every card of this machine.

    python3 -m koordinator_tpu_torch.testing.cross_card [--skip-scale]
    python3 -m koordinator_tpu_torch.testing.cross_card --processes N

With two or more visible cards the mesh holds one shard per card
(parallel/mesh.visible_devices), and its exchange crosses NVLink; with one
card it holds two virtual cards of it, exchanging as two clusters of one
launch through the card's own memory (the cross-card half of the protocol
then stays unverified). Each check prints one JSON line:

  exchange    testing/mesh_round.check_exchange on the mesh at config 4
              (10240 pods x 5120 nodes): kernel 1's round and terms
              instances, the per-card replay, the per-card stage counts and
              kernel 2's exchange instance against the single-device
              kernels on the first card, 0 mismatches, with times;
  counts      testing/mesh_round.check_counts_cards on the mesh over
              mixed_cluster(7, 500 nodes, 1000 pods) (affinity, spread,
              ports, volumes): the per-card stage counts against the
              one-card pass and the plain sharded counts, 0 mismatches,
              with times;
  timeout     the first card's launch alone: ExchangeTimeout naming every
              other shard within the limit, and the card takes the next
              launch;
  scheduler   Scheduler(store, mesh=<the mesh>) on churn_store(5000, 10000,
              seed=42), the default path (chained waves) and the
              single-call fused path, against Scheduler(store) on one
              card: the outcomes' SHA-256 (bindings, failed and rejected
              lists, PodScheduled conditions) equal, with no node row
              gathered (the mesh's gathers raise) and the exchange
              instances launched;
  worlds      the carried worlds (reservation rows, hot-claim columns, a
              device score transformer, prod scoring) through
              scheduler/pipeline_parity.run_carried_state_parity with the
              fused world on the mesh and its serial twin on the first
              card: no mismatch, the exchange round and the per-card
              replay launched and no single-device instance, no gather; then kernel 1's exchange round
              at config 4 over a hot-claim world's volume view built per
              card (each card's [P, rows] columns) against the
              single-device round over the [P, N] view
              (testing/mesh_round.check_claim_view), 0 mismatches;
  mesh_scale  2,048 pending pods over 50,000 nodes (bench.py's mesh-scale
              row): ops/full_chain_kernel.state_for of each card's launch
              against one card's, and kernel 1's exchange round against
              its single-device round (0 mismatches, times).

Then each card's name and power limit and, last, one JSON object with
``ok``, the card count and the scheduler's SHA-256. Any failure raises.

With ``--processes N`` the mesh is held by N processes instead
(testing/xproc_cards.py; cards / N cards each, one shard a card, N
dividing the card count, or N processes on one card; each must hold the
cards it was given, by PCI bus id): testing/mesh_round.run_checks at
config 4 with every pod (``--pods`` cuts it): the mailbox round trip
between ranks 0 and 1, kernel 1's exchange round and terms instance, the
per-card replay and stage counts, kernel 2's, the score matrix, the fused
K = 2 wave step with explain "counts" and a chained wave, the carried
worlds (reservation rows, hot-claim columns) and the timeout, each
against the single-card kernels on card 0 with 0 mismatches
(``processes`` line); then the same checks but the round trip on the
one-process mesh of the same cards, timed alike (``one_process`` line).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys
import time

import torch

from koordinator_tpu_torch.client.store import KIND_POD
from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import (
    resolve_balance_idx,
    resolve_weight_idx,
)
from koordinator_tpu_torch.ops import explain_kernel as ek
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import schedule_kernel as sk
from koordinator_tpu_torch.ops.kernel_common import build_libraries
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.parallel import full_chain_mesh as fcm
from koordinator_tpu_torch.parallel import mesh as pm
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing import mesh_round
from koordinator_tpu_torch.testing.synth import (
    loadaware_inputs,
    mixed_cluster,
    synth_cluster,
    synth_full_cluster,
)

CONFIG4 = (5000, 10000)      # nodes, pods (BASELINE config 4)
MESH_SCALE = (50_000, 2_048)  # nodes, pending pods (bench.py mesh scale)
CHURN_CYCLES = 2             # cycle 0 and one churn cycle


def card_mesh(device="cuda"):
    """One shard per visible card (two or more), else two virtual cards
    of the one card; exchanging either way."""
    cards = torch.cuda.device_count()
    if cards >= 2:
        return pm.make_mesh([pm.MeshDevice(c, torch.device("cuda", c))
                             for c in range(cards)])
    return mesh_round.exchanging_mesh(2, device)


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def pack(state, args):
    fc, _p, _n, _t, _gi, ng, ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    return fc, ng, ngroups, active


@contextlib.contextmanager
def no_gather():
    """The block with the mesh's node-row gathers raising: the exchange
    route must not reach them."""
    def refuse(*_a, **_k):
        raise AssertionError("a mesh of cards gathered node rows")

    saved = [(mod, name, getattr(mod, name))
             for mod in (pm, fcm) for name in ("gather", "gather_tree")]
    for mod, name, _f in saved:
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def xchg_launches() -> dict:
    return {"full_chain_xchg": fck.xchg_launches,
            "full_chain_xchg_terms": fck.xchg_terms_launches,
            "full_chain_xchg_replay": fck.xchg_replay_launches,
            "explain_counts_shards": ek.shard_launches,
            "schedule_step_xchg": sk.xchg_launches}


def zero_xchg_launches() -> None:
    fck.xchg_launches = fck.xchg_terms_launches = 0
    fck.xchg_replay_launches = ek.shard_launches = sk.xchg_launches = 0


def outcome_sha(keys, store) -> str:
    """SHA-256 of the per-cycle result keys and every pod's PodScheduled
    condition (chip_smoke.py's outcome_sha)."""
    conds = {}
    for pod in store.list(KIND_POD):
        c = pod.get_condition("PodScheduled")
        if c is not None:
            conds[pod.meta.key] = (c.status, c.reason, c.message)
    blob = json.dumps({"cycles": keys, "conditions": sorted(conds.items())})
    return hashlib.sha256(blob.encode()).hexdigest()


def churn_outcome(mesh=None, device="cuda", cycles=CHURN_CYCLES,
                  n_nodes=CONFIG4[0], n_pods=CONFIG4[1], **kwargs):
    """(SHA-256, seconds) of Scheduler(store[, mesh]) over ``cycles``
    churn cycles of churn_store(n_nodes, n_pods, seed=42)."""
    from koordinator_tpu_torch.scheduler.cycle import Scheduler
    from koordinator_tpu_torch.testing.churn import (
        add_arrivals,
        arrival_specs,
        churn_store,
    )

    store, state = churn_store(n_nodes, n_pods, seed=42)
    sched = Scheduler(store, device=device, mesh=mesh, **kwargs)
    keys = []
    t0 = time.perf_counter()
    for c in range(cycles):
        if c:
            add_arrivals(store, arrival_specs(c, n_pods // 10), state.now + c)
        res = sched.run_cycle(now=state.now + 2 * c)
        keys.append(([(b.pod_key, b.node_name) for b in res.bound],
                     list(res.failed), list(res.rejected)))
    sched.flush_deferred()
    if sched.ladder.level != 0 or sched.ladder.transitions:
        raise AssertionError(f"the ladder moved: {sched.ladder.transitions}")
    return outcome_sha(keys, store), time.perf_counter() - t0


def check_scheduler(mesh, device="cuda") -> dict:
    """The default path and the single-call fused path on the mesh against
    the default path on one card: equal SHA-256, the exchange instances
    launched, no gather."""
    want, single_s = churn_outcome(None, device)
    row = {"sha256": want, "single_seconds": single_s}
    for tag, kw in (("chained", {}), ("fused", {"replay_overlap": False})):
        zero_xchg_launches()
        with no_gather():
            got, secs = churn_outcome(mesh, device, **kw)
        launches = xchg_launches()
        if got != want:
            raise AssertionError(f"scheduler {tag}: outcome {got} is not "
                                 f"the single card's {want}")
        if launches["full_chain_xchg"] < 1 or (
                launches["full_chain_xchg_replay"] < 1):
            raise AssertionError(f"scheduler {tag}: launches {launches}")
        row[tag] = {"seconds": secs, "launches": launches}
    return row


WORLDS = ("reservations", "claims", "transformer", "prod")
# the fused world's launches of one device, which the exchange route
# must not make
SINGLE_DEVICE = ("full_chain", "full_chain_replay", "full_chain_terms",
                 "explain_counts")


def check_worlds(mesh, fc, weight_idx, prod_mode, bal_idx,
                 device="cuda") -> dict:
    """The carried worlds with the fused world on ``mesh``, then kernel
    1's exchange round over the claim view at ``fc`` (one card's tensors,
    the node axis a multiple of the mesh size); raises on any mismatch.
    Returns each world's mismatches, multi-wave cycles and fused-world
    launches, and the claim view's row."""
    from koordinator_tpu_torch.scheduler.pipeline_parity import (
        run_carried_state_parity,
    )

    row = {}
    for world in WORLDS:
        with no_gather():
            report = run_carried_state_parity(world, device=device,
                                              mesh=mesh)
        la = report["fused_launches"]
        if (not report["ok"] or report["fused_engaged"] < 1
                or la["full_chain_xchg"] < 1
                or la["full_chain_xchg_replay"] < 1
                or any(la[k] for k in SINGLE_DEVICE)):
            raise AssertionError(f"worlds {world}: {report}")
        row[world] = {"mismatches": len(report["mismatches"]),
                      "fused_engaged": report["fused_engaged"],
                      "launches": la}
    view = mesh_round.check_claim_view(fc, weight_idx, prod_mode, bal_idx,
                                       mesh=mesh)
    if view["mismatches"]:
        raise AssertionError(f"worlds claim view: {view}")
    row["claim_view"] = view
    return row


def check_mesh_scale(mesh, args) -> dict:
    """The mesh-scale shape: each card's state_for against one card's,
    and kernel 1's exchange round against its single-device round."""
    n_nodes, n_pods = MESH_SCALE
    t0 = time.perf_counter()
    _c, state = synth_full_cluster(n_nodes, n_pods, seed=42,
                                   num_quotas=max(n_pods // 100, 1),
                                   num_gangs=n_pods // 50)
    fc_host, _ng, _ngroups, active = pack(state, args)
    build_s = time.perf_counter() - t0
    widx = resolve_weight_idx(args, active)
    bal = resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    dev0 = mesh.flat[0].device
    fc = to_device(mesh_round._padded_fc(fc_host, mesh), dev0)
    N = fc.base.allocatable.shape[0]
    per = N // mesh.size
    cards = mesh_round._cards_of(fc, mesh, per, fcm.node_rows)
    jobs = [(v, ks) for _d, ks, v in cards]
    one = fck.state_for(fc, widx)
    row = {"nodes": n_nodes, "pods": n_pods, "N": N, "per": per,
           "pack_seconds": build_s,
           "one_card": {"state": one[0], "smem_bytes_per_block": one[2]},
           "per_card": [
               dict(zip(("state", "smem_bytes_per_block"),
                        (lambda s: (s[0], s[2]))(fck.state_for(
                            v, widx, shards=len(ks), exchange=True))),
                    shards=ks, device=str(d))
               for d, ks, v in cards]}
    c1 = fck.full_chain_round(fc, widx, prod, bal)[0]
    outs = fck.full_chain_round_cards(jobs, widx, prod, bal,
                                      mesh.mailboxes())
    row["mismatches"] = sum(mesh_round._mismatches(c1.cpu(), o[0].cpu())
                            for o in outs)
    row["bound"] = int((c1 >= 0).sum())
    row["single_ms"] = mesh_round.time_ms(
        lambda: fck.full_chain_round(fc, widx, prod, bal))
    row["xchg_ms"] = mesh_round.time_ms(
        lambda: fck.full_chain_round_cards(jobs, widx, prod, bal,
                                           mesh.mailboxes()))
    return row


XPROC_REPS = 10  # timed calls of each check in the --processes run


def main_processes(n_procs: int, pods: int) -> int:
    """The --processes run: testing/mesh_round.run_checks in ``n_procs``
    processes (testing/xproc_cards.py) against the single-card kernels,
    then on the one-process mesh of the same cards, both timed."""
    import shutil
    import tempfile

    from koordinator_tpu_torch.ops.kernel_common import IPC_SOURCE
    from koordinator_tpu_torch.testing import mailbox_rtt, xproc_cards

    t_start = time.perf_counter()
    build_libraries(fck.SOURCE, sk.SOURCE, ek.SOURCE, fck.REPLAY_SOURCE,
                    IPC_SOURCE, mailbox_rtt.SOURCE)
    cards = torch.cuda.device_count()
    if cards % n_procs and n_procs % cards:
        raise ValueError(f"{n_procs} processes do not share {cards} cards")
    per_proc = max(1, cards // n_procs)
    depth = n_procs * per_proc
    args = LoadAwareArgs()
    n_nodes, n_pods = CONFIG4
    _c, state = synth_full_cluster(n_nodes, n_pods, seed=42,
                                   num_quotas=max(n_pods // 100, 1),
                                   num_gangs=n_pods // 50)
    la = loadaware_inputs(synth_cluster(num_nodes=n_nodes, num_pods=n_pods,
                                        seed=42), args)
    data = xproc_cards.batch_data(state, args, n_nodes, pods, la_inputs=la,
                                  worlds=("reservations", "claims"))
    data["rtt_rounds"] = 20000
    checks = mesh_round.CHECKS
    tmp = tempfile.mkdtemp(prefix="koord_xproc_")
    try:
        path = f"{tmp}/data.pkl"
        xproc_cards.write_data(path, data)
        t0 = time.perf_counter()
        outs = xproc_cards.launch(
            n_procs, path, f"{tmp}/out", checks, reps=XPROC_REPS,
            cards=per_proc, timeout_s=1800)
        procs_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = mesh_round.reference(data, checks, depth, "cuda")
    res = mesh_round.compare(ref, outs, depth)
    row = {"check": "processes", "processes": n_procs,
           "cards_per_process": per_proc, "shards": depth, "pods": pods,
           "mismatches": res["total"], "outputs": len(res["mismatches"]),
           "digests": res["digests"], "reference": res["reference_digest"],
           "bound": int((ref["rep"]["round.chosen"] >= 0).sum()),
           "bus_ids": [o["extra"]["mesh"]["bus_ids"] for o in outs],
           "times": [o["times"] for o in outs],
           "extra": [o["extra"] for o in outs],
           "launches": [o["launches"] for o in outs], "seconds": procs_s}
    print(json.dumps(row, default=str), flush=True)
    if res["total"] or res["digests"] != [res["reference_digest"]]:
        raise AssertionError(
            f"processes: {({k: v for k, v in res['mismatches'].items() if v})}"
            f" digests {res['digests']}")
    # the same cards, one shard each, held by this one process: every
    # check but the round trip between processes
    mesh = pm.make_mesh([pm.MeshDevice(k, torch.device("cuda", k))
                         for k in range(depth)]) if depth <= cards else None
    if mesh is not None:
        with torch.cuda.device(0):
            one = mesh_round.run_checks(
                mesh, data, [c for c in checks if c != "rtt"], XPROC_REPS)
        ores = mesh_round.compare(ref, [one], depth)
        print(json.dumps({"check": "one_process", "cards": len(mesh.cards),
                          "shards": depth, "mismatches": ores["total"],
                          "times": one["times"],
                          "timeout": one["extra"]["timeout"],
                          "launches": one["launches"]}), flush=True)
        if ores["total"]:
            raise AssertionError(f"one_process: {ores['mismatches']}")
    for line in card_lines():
        print(line, flush=True)
    print(json.dumps({"ok": True, "processes": n_procs, "shards": depth,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-scale", action="store_true",
                    help="leave out the mesh-scale shape")
    ap.add_argument("--processes", type=int, default=0,
                    help="hold the mesh in this many processes")
    ap.add_argument("--pods", type=int, default=CONFIG4[1],
                    help="valid pods of the --processes batch")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cross_card: CUDA is not available", file=sys.stderr)
        return 2
    if opts.processes:
        return main_processes(opts.processes, opts.pods)
    t_start = time.perf_counter()
    build_libraries(fck.SOURCE, sk.SOURCE, ek.SOURCE, fck.REPLAY_SOURCE)
    mesh = card_mesh()
    print(json.dumps({"check": "mesh", "cards": len(mesh.cards),
                      "shards": mesh.size, "exchange": mesh.exchange,
                      "devices": [str(d) for d in mesh.cards]}), flush=True)
    args = LoadAwareArgs()
    n_nodes, n_pods = CONFIG4
    _c, state = synth_full_cluster(n_nodes, n_pods, seed=42,
                                   num_quotas=max(n_pods // 100, 1),
                                   num_gangs=n_pods // 50)
    fc, ng, ngroups, active = pack(state, args)
    la = loadaware_inputs(synth_cluster(num_nodes=n_nodes, num_pods=n_pods,
                                        seed=42), args)
    rows = mesh_round.check_exchange(fc, args, ng, ngroups, active, n_nodes,
                                     la, meshes=[mesh])
    for r in rows:
        bad = {k: v for k, v in r.items() if k.endswith("mismatches") and v}
        if bad:
            raise AssertionError(f"exchange: {bad}")
    print(json.dumps({"check": "exchange", "rows": rows}), flush=True)
    _c, mstate = mixed_cluster(7, 500, 1000)
    counts = mesh_round.check_counts_cards(pack(mstate, args)[0], mesh)
    if counts["mismatches"]:
        raise AssertionError(f"counts: {counts}")
    print(json.dumps({"check": "counts", **counts}), flush=True)
    timeout = mesh_round.check_timeout(fc, args, active, mesh=mesh)
    if timeout["next_launch_mismatches"]:
        raise AssertionError(f"timeout: {timeout}")
    print(json.dumps({"check": "timeout", **timeout}), flush=True)
    sched = check_scheduler(mesh)
    print(json.dumps({"check": "scheduler", **sched}), flush=True)
    worlds = check_worlds(
        mesh, to_device(mesh_round._padded_fc(fc, mesh), mesh.flat[0].device),
        resolve_weight_idx(args, active), args.score_according_prod_usage,
        resolve_balance_idx(active))
    print(json.dumps({"check": "worlds", **worlds}), flush=True)
    if not opts.skip_scale:
        scale = check_mesh_scale(mesh, args)
        if scale["mismatches"]:
            raise AssertionError(f"mesh_scale: {scale}")
        print(json.dumps({"check": "mesh_scale", **scale}), flush=True)
    for line in card_lines():
        print(line, flush=True)
    print(json.dumps({"ok": True, "cards": len(mesh.cards),
                      "shards": mesh.size, "sha256": sched["sha256"],
                      "seconds": time.perf_counter() - t_start}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
