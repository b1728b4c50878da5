"""A mesh of the port spanning OS processes over torch.distributed's gloo
backend, on the CPU: the cases of tests/test_multihost.py on the port.

Each worker (koordinator_tpu_torch/testing/multihost_worker.py, run as
``python -m``) holds a few virtual CPU shard devices; the processes
federate into one 8-shard mesh, run the sharded full-chain step (the
per-pod reductions and winner merges are gloo all-reduces across the
process boundary) and the 2-D score matrix, and diff against their own
single-device runs. Every process must print the same digest. Each test
has its own timeout, well inside the suite's."""

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
