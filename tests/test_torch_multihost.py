"""A mesh of the port spanning OS processes over torch.distributed's gloo
backend, on the CPU: the cases of tests/test_multihost.py on the port.

Each worker (koordinator_tpu_torch/testing/multihost_worker.py, run as
``python -m``) holds a few virtual CPU shard devices; the processes
federate into one 8-shard mesh, run the sharded full-chain step (the
per-pod reductions and winner merges are gloo all-reduces across the
process boundary) and the 2-D score matrix, and diff against their own
single-device runs. Every process must print the same digest. Each test
has its own timeout, well inside the suite's."""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(num_procs: int, local_devices: int):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("KOORD_TORCH_VIRTUAL_DEVICES", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m",
             "koordinator_tpu_torch.testing.multihost_worker", str(i),
             str(num_procs), str(port), str(local_devices)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO)
        for i in range(num_procs)
    ]
    outs = []
    try:
        for proc in procs:
            try:
                out, err = proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail("multihost worker timed out")
            assert proc.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        # a failed worker must not strand its siblings in the handshake
        for p in procs:
            if p.poll() is None:
                p.kill()
    digests = [line.split()[1] for out in outs for line in out.splitlines()
               if line.startswith("MULTIHOST_OK")]
    assert len(digests) == num_procs, f"missing MULTIHOST_OK lines: {outs}"
    assert len(set(digests)) == 1  # every process computed the same
    return outs


def test_two_process_distributed_full_chain():
    _run_workers(num_procs=2, local_devices=4)


def test_four_process_distributed_2d():
    """4 processes x 2 shards = an 8-shard (pods=2, nodes=4) mesh where
    both batch axes of the score matrix cross process boundaries."""
    outs = _run_workers(num_procs=4, local_devices=2)
    assert any("mesh={'pods': 2, 'nodes': 4}" in o for o in outs), outs


# ---------------------------------------------------------------------------
# a mesh of cards across processes, on the CPU: the card route's wave body
# and the mailboxes' host bookkeeping
# ---------------------------------------------------------------------------

XPROC_TIMEOUT = 90


@pytest.mark.parametrize("world", ["reservations", "claims"])
def test_card_route_wave_body_across_processes(cpu_devices, tmp_path,
                                               world):
    """2 gloo processes x 2 CPU shards with ``exchange`` set: CardBackend's
    wave body runs across the processes (testing/xproc_cards.py running
    testing/mesh_round.run_checks' "worlds": the fused K = 4 step with
    explain "full", then three chained waves with explain "counts"), over a world with reservation rows and
    one with hot claims, its node axis spread so every shard holds real
    nodes. Every output equals the port's single-device steps, and the
    fused rows the JAX package's sharded fused step on 4 virtual CPU
    devices, tolerance 0; both processes print the same digest."""
    import numpy as np

    from koordinator_tpu.parallel import (
        build_sharded_fused_wave_step as ref_sharded_fused,
        make_mesh as ref_make_mesh,
        shard_full_chain_inputs as ref_shard_fc,
    )
    from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
    from koordinator_tpu_torch.testing import mesh_round
    from koordinator_tpu_torch.testing import xproc_cards as xc
    from test_torch_fused_waves import _ref_args, _ref_fc
    from test_torch_parallel import _ref_shard_sides

    data = mesh_round.exchange_batch(
        None, LoadAwareArgs(), 0, 0, None, 0,
        worlds={world: xc.carried_world(world)})
    path = tmp_path / "data.pkl"
    xc.write_data(path, data)
    outs = xc.launch(2, path, tmp_path / "out", ["worlds"], device="cpu",
                     shards=2, timeout_s=XPROC_TIMEOUT)
    assert [o["extra"]["mesh"]["cards"] for o in outs] == [
        [(0, "cpu"), (1, "cpu")]] * 2
    ref = mesh_round.reference(data, ["worlds"], 4, "cpu")
    res = mesh_round.compare(ref, outs, 4)
    assert res["total"] == 0, {k: v for k, v in res["mismatches"].items()
                               if v}
    assert res["digests"] == [res["reference_digest"]]
    assert len(ref["node"]) >= 1
    wfc, wsides, b = data["worlds"][world]
    got = outs[1]["rep"]
    assert (got[f"world.{world}.bind_pods"] >= 0).sum() > 1, "vacuous"
    rm = ref_make_mesh(cpu_devices[:4])
    kw = dict(active_axes=b["active_axes"], prod=b["prod"],
              claims=b["claims"], res=b["res"])
    jax_out = ref_sharded_fused(
        _ref_args(False), b["num_gangs"], b["num_groups"], 4, rm, **kw)(
            ref_shard_fc(_ref_fc(wfc), rm), _ref_shard_sides(wsides, rm, b))
    for k in ("bind_pods", "bind_nodes", "bind_zones", "bind_res",
              "wave_counts"):
        np.testing.assert_array_equal(np.asarray(getattr(jax_out, k)),
                                      got[f"world.{world}.{k}"], err_msg=k)


def test_mailboxes_agree_across_processes():
    """The mailboxes' host bookkeeping across 2 gloo processes, each
    holding one shard of a mesh of cards, with the CUDA calls
    (ops/kernel_common.IPC) replaced by a stand-in that logs them: every
    process begins each launch group at the same flag, restarts together
    (a barrier before zeroing its own boxes and one after), grows together
    (its old mappings closed and a barrier before its old boxes are freed;
    its table lists its own box and the other process's, mapped from that
    process's handle), raises the same ExchangeTimeout where one process
    saw a shard miss, and unmaps and frees everything at close."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (REPO + os.pathsep + os.path.join(REPO, "tests")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "mailboxes", str(r),
         "2", str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO) for r in range(2)]
    outs = []
    try:
        for proc in procs:
            try:
                out, err = proc.communicate(timeout=XPROC_TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail("mailboxes worker timed out")
            assert proc.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    a, b = outs
    assert a["flags"] == b["flags"] and len(a["flags"]) == 6
    assert a["flags"][:3] == [1, 12, 33] and a["flags"][4] == 1  # restart
    assert a["timeout"] == b["timeout"] == {
        "failed_shards": [1], "failed_device_ids": [21],
        "message": a["timeout"]["message"]}
    for r, got in enumerate(outs):
        log = got["log"]
        # grown twice: each time alloc, export, the handles gathered (no
        # process is still in an earlier group), the old mappings closed,
        # a barrier, the old boxes freed, the new ones mapped
        first = log.index(["open", 1 - r, 1])
        assert log[:first] == [["alloc", r, 1], ["export", r, 1],
                               ["gather"], ["barrier"]]
        second = log.index(["alloc", r, 2])
        grow = log[second:second + 8]
        assert grow == [["alloc", r, 2], ["export", r, 2], ["gather"],
                        ["close", 1 - r, 1], ["barrier"], ["free", r, 1],
                        ["open", 1 - r, 2], ["table", got["table"]]]
        assert got["table"] == [[0, 2], [1, 2]]
        # 2 parities x 2 senders x the pairs x 8 bytes
        assert got["bytes"] == [2 * 2 * 16 * 8, 2 * 2 * 24 * 8]
        restart = log.index(["zero", r, 2])
        assert log[restart - 1] == ["barrier"]
        assert log[restart + 1] == ["barrier"]
        assert log[-3:] == [["close", 1 - r, 2], ["barrier"],
                            ["free", r, 2]]


class _FakeIpc:
    """ops/kernel_common.CudaIpc's stand-in: an address is (process,
    generation), and each call is logged."""

    def __init__(self, rank, log):
        self.rank, self.log, self.gen, self.sizes = rank, log, 0, []

    def alloc(self, device, nbytes):
        self.gen += 1
        self.sizes.append(int(nbytes))
        self.log.append(["alloc", self.rank, self.gen])
        return self.rank * 1000 + self.gen

    def export(self, device, ptr):
        self.log.append(["export", ptr // 1000, ptr % 1000])
        return f"{ptr}".encode()

    def open(self, device, handle):
        ptr = int(handle.decode())
        self.log.append(["open", ptr // 1000, ptr % 1000])
        return ptr

    def close(self, device, ptr):
        self.log.append(["close", ptr // 1000, ptr % 1000])

    def free(self, device, ptr):
        self.log.append(["free", ptr // 1000, ptr % 1000])

    def zero(self, device, ptr, nbytes):
        self.log.append(["zero", ptr // 1000, ptr % 1000])


def _mailboxes_worker(rank: int, world: int, port: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from koordinator_tpu_torch.ops import kernel_common as kc

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    log = []
    ipc = kc.IPC = _FakeIpc(rank, log)
    real_barrier = dist.barrier

    def barrier(*a, **k):
        log.append(["barrier"])
        return real_barrier(*a, **k)

    dist.barrier = barrier
    real_gather = dist.all_gather_object

    def gather(*a, **k):
        log.append(["gather"])
        return real_gather(*a, **k)

    dist.all_gather_object = gather
    cpu = torch.device("cpu")
    box = kc.Mailboxes([cpu, cpu], [20, 21], [0, 1])
    assert box.spans and box.cards() == {cpu: [rank]}
    flags = []
    box.ensure(15)  # 16 pairs
    flags.append(box.begin(10))
    box.ensure(12)  # no growth: every process skips alike
    box.ensure(23)  # 24 pairs
    log.append(["table", [[p // 1000, p % 1000]
                          for p in box.tables[cpu].tolist()]])
    table = log[-1][1]
    flags.append(box.begin(20))
    flags.append(box.begin(5))
    box.next_seq = kc.MAX_FLAG - 3
    flags.append(box.begin(1))   # fits: flags up to MAX_FLAG - 2
    flags.append(box.begin(7))   # would pass MAX_FLAG: restart first
    flags.append(box.begin(1))
    if rank == 0:
        box.errs[cpu].fill_(0b10)  # shard 1's entries never came here
    try:
        box.check("round")
    except kc.ExchangeTimeout as exc:
        timeout = {"failed_shards": list(exc.failed_shards),
                   "failed_device_ids": list(exc.failed_device_ids),
                   "message": str(exc)}
    else:
        raise AssertionError("no ExchangeTimeout")
    box.close()
    assert box.entry_pairs == 0 and not box.boxes and not box.opened
    dist.barrier = real_barrier
    dist.all_gather_object = real_gather
    dist.destroy_process_group()
    flags[3] = flags[3] - (kc.MAX_FLAG - 3) + 1000  # as an offset
    print(json.dumps({"flags": flags, "timeout": timeout, "log": log,
                      "table": table, "bytes": ipc.sizes}))


if __name__ == "__main__":
    if sys.argv[1] == "mailboxes":
        _mailboxes_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
