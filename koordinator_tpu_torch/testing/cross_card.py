"""The mesh of cards on every card of this machine.

    python3 -m koordinator_tpu_torch.testing.cross_card [--skip-scale]

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
  mesh_scale  2,048 pending pods over 50,000 nodes (bench.py's mesh-scale
              row): ops/full_chain_kernel.state_for of each card's launch
              against one card's, and kernel 1's exchange round against
              its single-device round (0 mismatches, times).

Then each card's name and power limit and, last, one JSON object with
``ok``, the card count and the scheduler's SHA-256. Any failure raises.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-scale", action="store_true",
                    help="leave out the mesh-scale shape")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cross_card: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    build_libraries(fck.SOURCE, sk.SOURCE, ek.SOURCE)
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
    timeout = mesh_round.check_timeout(fc, args, active, mesh=mesh)
    if timeout["next_launch_mismatches"]:
        raise AssertionError(f"timeout: {timeout}")
    print(json.dumps({"check": "timeout", **timeout}), flush=True)
    sched = check_scheduler(mesh)
    print(json.dumps({"check": "scheduler", **sched}), flush=True)
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
