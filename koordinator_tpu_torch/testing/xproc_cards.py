"""A mesh of cards held by several processes: the worker each process runs.

    python -m koordinator_tpu_torch.testing.xproc_cards --rank R --world W
        --port PORT --data FILE --out DIR [--device cuda|cpu]
        [--checks rtt,round,...] [--reps N] [--cards C]

Each of W processes joins a gloo group over tcp://127.0.0.1:PORT with a
timeout (a dead peer makes the collectives raise), takes its first card
(``torch.cuda.set_device(local rank * C % cards)``: every process sees
the same cards), builds the mesh of every process's shards
(``parallel/mesh.visible_devices("cuda", cards_per_process=C)``: C cards
a process, default 1; KOORD_TORCH_VIRTUAL_DEVICES shards a card, default
1) and runs testing/mesh_round.run_checks (the instances over a mesh of
cards, the wave steps over the card route, the timeout) on the batch that
the caller wrote to FILE (``batch_data``, ``write_data``). On the CPU
(``--device cpu``) the mesh's ``exchange`` is set, so the same wave body
runs CardBackend's plain sharded passes across the processes; only
``waves`` and ``worlds`` apply there.

It never builds a kernel: the caller builds the libraries into build/
first (two processes building at once would race). Each process writes
DIR/rank<R>.pkl (run_checks' result, with the mesh and the PCI bus ids of
its cards under ``extra``) and prints ``XPROC_OK <digest>``, the SHA-256
of the outputs alike in every process (mesh_round.digest). ``launch``
starts the processes, waits for them and checks that each holds the
cards the caller meant; the caller then holds their outputs against
mesh_round.reference with mesh_round.compare.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from koordinator_tpu_torch.models import fused_waves as fw
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.parallel import full_chain_mesh as fcm
from koordinator_tpu_torch.parallel import mesh as pm
from koordinator_tpu_torch.testing import mesh_round

GROUP_TIMEOUT_S = 120  # a collective that waits longer raises


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------

def first_valid(valid, n: int) -> np.ndarray:
    """``valid`` with only its first ``n`` valid pods valid."""
    valid = np.asarray(valid).astype(bool)
    return valid & (np.cumsum(valid) <= n)


def batch_data(state, args: LoadAwareArgs, n_real: int, pods: int,
               la_inputs=None, worlds=()) -> dict:
    """run_checks' batch (mesh_round.exchange_batch) from a synth state
    (config 4's): its packed FullChainInputs and wave sides with only the
    first ``pods`` valid pods valid, the LoadAware ScheduleInputs
    ``la_inputs`` (numpy, cut the same way) and the carried ``worlds``
    (``carried_world``), all as numpy."""
    from koordinator_tpu_torch.scheduler.snapshot import (
        build_full_chain_inputs,
        reduce_to_active_axes,
    )

    fc, _p, nodes, _t, _g, ng, ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    idx = np.asarray(active)
    sides = fw.plain_sides(np.take(nodes.extras["la_est_nonprod"], idx, -1),
                           np.take(nodes.extras["la_adj_nonprod"], idx, -1))
    fc = fc._replace(base=fc.base._replace(
        pod_valid=first_valid(fc.base.pod_valid, pods)))
    la = None if la_inputs is None else la_inputs._replace(
        pod_valid=first_valid(la_inputs.pod_valid, pods))
    data = mesh_round.exchange_batch(
        fc, args, ng, ngroups, active, n_real, la, sides,
        {name: carried_world(name) for name in worlds})
    data["pods"] = pods
    return data


def carried_world(name: str, spread: bool = True):
    """(fc, sides, build kwargs) of the first fused dispatch a CPU
    Scheduler makes on scheduler/pipeline_parity's ``name`` world
    ("reservations" or "claims"), as numpy. With ``spread`` the node axis
    is permuted so that its few real nodes lie apart (real node i of n at
    row (n - 1 - i) * (N // n)): every shard of a small mesh then holds
    real nodes."""
    from koordinator_tpu_torch.scheduler import pipeline_parity
    from koordinator_tpu_torch.scheduler.cycle import Scheduler

    now, store = {"reservations": pipeline_parity._reservation_world,
                  "claims": pipeline_parity._claims_world}[name]()
    seen = {}
    real_build = fw.build_fused_wave_step

    def numpy_of(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(numpy_of(v) for v in x))
        return x.cpu().numpy()

    def spy_build(args_, num_gangs, num_groups, waves, **kw):
        seen["build"] = dict(num_gangs=num_gangs, num_groups=num_groups,
                             active_axes=kw["active_axes"], prod=kw["prod"],
                             claims=kw["claims"], res=kw["res"])
        step = real_build(args_, num_gangs, num_groups, waves, **kw)

        def spy_step(fc, sides):
            seen.setdefault("inputs", (numpy_of(fc), numpy_of(sides)))
            return step(fc, sides)

        return spy_step

    sched = Scheduler(store, waves=4, device="cpu", replay_overlap=False)
    fw.build_fused_wave_step = spy_build
    try:
        res = sched.run_cycle(now=now)
    finally:
        fw.build_fused_wave_step = real_build
    if res.waves <= 1 or res.demotions:
        raise AssertionError(f"world {name}: waves {res.waves}, demotions "
                             f"{res.demotions}")
    fc, sides = seen["inputs"]
    if spread:
        fc, sides = _spread(fc, sides)
    return fc, sides, seen["build"]


def _spread(fc, sides):
    N = fc.base.allocatable.shape[0]
    n = int(np.asarray(fc.base.node_ok).sum())
    step = N // n
    at = {(n - 1 - i) * step: i for i in range(n)}
    rest = iter(range(n, N))
    order = np.array([at[j] if j in at else next(rest) for j in range(N)])

    def perm(x):
        return None if x is None else np.asarray(x)[order]

    base = fc.base._replace(**{k: perm(v) for k, v in fc.base._asdict().items()
                               if k not in pm._SCHEDULE_POD_FIELDS})
    fc = fc._replace(base=base, **{k: perm(getattr(fc, k))
                                   for k in fcm._FC_NODE_FIELDS})
    claims = sides.claims
    if claims is not None:
        claims = claims._replace(covered0=perm(claims.covered0))
    return fc, sides._replace(
        la_est=perm(sides.la_est), la_adj=perm(sides.la_adj),
        prod=(None if sides.prod is None else
              type(sides.prod)(*(perm(x) for x in sides.prod))),
        claims=claims)


def write_data(path, data: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, data_path, out_dir, checks: Sequence[str],
           device="cuda", reps: int = 0, shards: int = 1, cards: int = 1,
           timeout_s: float = 600.0) -> List[dict]:
    """Run the checks in ``world`` processes of this package (``python -m
    koordinator_tpu_torch.testing.xproc_cards``), ``cards`` cards a
    process with ``shards`` shards a card, and return their outputs in
    rank order. Each process sees the cards this one sees (the same
    CUDA_VISIBLE_DEVICES) and takes its own by its rank; on CUDA each must
    hold the cards this process numbers ``rank * cards % count`` on, by
    PCI bus id. Raises, with the end of its errors, where a process exits
    nonzero, outlives ``timeout_s`` or holds other cards; a failed
    process's siblings are killed."""
    repo = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    env[pm.VIRTUAL_DEVICES_ENV] = str(int(shards))
    env.pop("LOCAL_RANK", None)  # each takes its rank's card
    port = free_port()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "koordinator_tpu_torch.testing.xproc_cards",
         "--rank", str(r), "--world", str(world), "--port", str(port),
         "--data", str(data_path), "--out", str(out_dir), "--device",
         device, "--checks", ",".join(checks), "--reps", str(reps),
         "--cards", str(int(cards))],
        cwd=str(repo), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for r, proc in enumerate(procs):
            try:
                out, err = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"xproc_cards: rank {r} outlived "
                                     f"{timeout_s} s")
            if proc.returncode != 0:
                raise AssertionError(
                    f"xproc_cards: rank {r} exited {proc.returncode}:\n"
                    f"{out[-2000:]}\n{err[-4000:]}")
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("XPROC_OK")]
            if len(lines) != 1:
                raise AssertionError(f"xproc_cards: rank {r} printed no "
                                     f"XPROC_OK line:\n{out[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    if device == "cuda":
        check_cards(outs, cards)
    return outs


def bus_ids(devices) -> List[str]:
    """The PCI bus ids of ``devices`` (cards)."""
    from koordinator_tpu_torch.ops.kernel_common import IPC

    return [IPC.bus_id(torch.device(d)) for d in devices]


def check_cards(outs: List[dict], cards: int = 1) -> None:
    """Raise unless process r of ``outs`` held the ``cards`` cards this
    process numbers from ``r * cards % count`` on, by PCI bus id: the
    processes ran on the cards they were given, and no other."""
    count = torch.cuda.device_count()
    for r, o in enumerate(outs):
        first = r * cards % count
        want = bus_ids(f"cuda:{first + j}" for j in range(cards))
        got = o["extra"]["mesh"]["bus_ids"]
        if got != want:
            raise AssertionError(f"xproc_cards: rank {r} held the cards "
                                 f"{got}, not {want}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--checks", default=",".join(mesh_round.CHECKS))
    ap.add_argument("--reps", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1,
                    help="cards a process holds")
    opts = ap.parse_args(argv)
    checks = [c for c in opts.checks.split(",") if c]
    unknown = set(checks) - set(mesh_round.CHECKS)
    if unknown:
        ap.error(f"unknown checks {sorted(unknown)}")
    if opts.device == "cuda" and not torch.cuda.is_available():
        print("xproc_cards: CUDA is not available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{opts.port}",
        world_size=opts.world, rank=opts.rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        if opts.device == "cuda":
            torch.cuda.set_device(pm.local_rank() * opts.cards
                                  % torch.cuda.device_count())
        mesh = pm.make_mesh(pm.visible_devices(
            opts.device, cards_per_process=opts.cards))
        if opts.device == "cpu":
            mesh.exchange = True  # the CPU shards stand for cards
        if not (mesh.exchange and mesh.spans_processes):
            raise AssertionError(f"{mesh} does not exchange across "
                                 "processes")
        with open(opts.data, "rb") as f:
            data = pickle.load(f)
        t0 = time.perf_counter()
        res = mesh_round.run_checks(mesh, data, checks, opts.reps)
        res["extra"]["seconds"] = time.perf_counter() - t0
        res["extra"]["mesh"] = {
            "shape": mesh.shape, "size": mesh.size, "rank": mesh.rank,
            "cards": [(p, str(d)) for p, d in mesh.card_keys],
            "bus_ids": (bus_ids(mesh.cards) if opts.device == "cuda"
                        else [])}
        with open(Path(opts.out) / f"rank{opts.rank}.pkl", "wb") as f:
            pickle.dump(res, f, pickle.HIGHEST_PROTOCOL)
        dist.barrier()
        mesh.close()
        print(f"XPROC_OK {mesh_round.digest(res['rep'])} rank={opts.rank} "
              f"world={opts.world}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
