"""The port's torch calls on the cycle's host path, counted.

Each torch call but a metadata read releases the interpreter's lock
around its dispatch and must take it back; beside threads that never
wait (the JAX package's concurrent-scrape case, tests/test_koordwatch.py)
taking it back costs about a switch interval a call. These tests run the
sim's smoke scenario's 14 cycles on the CPU under
testing/scrape_convoy's CallCounter and hold the counts to their budgets:

* the plain round at most 150 calls a valid pod (it made ~511 before
  its per-pod flags, hoisted rows and gathered quota chain);
* the card route's buffers (ops/full_chain_kernel._round_buffers) at most
  30 calls a round on the round's uploaded tensors (246 when packed on
  the device);
* the cycle outside the round at most 60 calls (~113 before the staged
  upload and the host twins of the reject rows).

They also hold the host pack (models/round_pack) to what the device
computes from the same tensors: the records word for word, the node
flags, the reject and gang rows, the pod flags, and the kernel's carried
state. The 14 cycles take about a second.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.models.full_chain import (
    FullChainInputs,
    RoundFlags,
    pod_independent_rows,
)
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops.kernel_common import valid_first
from koordinator_tpu_torch.testing import scrape_convoy

CYCLES = scrape_convoy.CYCLES
PLAIN_CALLS_PER_POD = 150
PACK_CALLS_PER_ROUND = 30
OUTSIDE_CALLS_PER_CYCLE = 60
# the smoke world's weighted score axes after active-axes slicing
WIDX = [0, 1]


def _unpacked(fc) -> FullChainInputs:
    """The same tensors as a FullChainInputs with no host pack."""
    return FullChainInputs(*fc)


def _check_pack(fc) -> dict:
    """The host pack of one uploaded round against the device's own
    computation on its tensors; returns the card route's buffer calls."""
    pack = fc.pack
    plain = _unpacked(fc)
    reject_np, reject_pr, gang_ok = pod_independent_rows(plain)
    for got, want in zip(pack.rows, (reject_np, reject_pr, gang_ok)):
        assert torch.equal(got, want)
    records, n_valid = valid_first(fck.pack_records(plain, gang_ok),
                                   plain.base.pod_valid)
    assert pack.records.dtype == records.dtype == torch.int32
    assert torch.equal(pack.records, records), "records word for word"
    assert torch.equal(pack.n_valid, n_valid)
    assert torch.equal(pack.node_flags,
                       fck.node_flags(plain, reject_np, reject_pr))
    table = RoundFlags._read_table(plain, WIDX, gang_ok)
    w_pos = bool((pack.weights[WIDX] > 0).all())
    assert [tuple(t) for t in table] == [row + (w_pos,)
                                         for row in pack.table]
    counter = scrape_convoy.CallCounter()
    with counter:
        got = fck._round_buffers(fc, WIDX, False)
    want = fck._round_buffers(plain, WIDX, False)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for key, t in want[3].items():
        assert torch.equal(got[3][key].to(t.dtype), t), key
        assert got[3][key].is_contiguous(), key
    assert torch.equal(got[4], want[4])
    return {"calls": counter.n, "pods": int(n_valid)}


@pytest.fixture(scope="module")
def smoke_counts():
    sim = scrape_convoy._simulator(CYCLES, "cpu")
    snap = sim.sched.device_snapshot
    upload = snap.upload
    packed = []

    def upload_and_keep(fc, pack=False):
        out = upload(fc, pack=pack)
        if pack:
            packed.append(out)
        return out

    snap.upload = upload_and_keep
    counter = scrape_convoy.CallCounter()
    rounds0 = scrape_convoy._round_counts()
    per_cycle, checked = [], []
    for cycle in range(CYCLES):
        route0 = dict(counter.by_route)
        with counter:
            sim._run_one_cycle(cycle)
        per_cycle.append({k: counter.by_route[k] - route0[k]
                          for k in scrape_convoy.ROUTES})
        # checked once the cycle is over, before a later upload can
        # scatter into these tensors
        checked += [_check_pack(fc) for fc in packed]
        packed.clear()
    rounds1 = scrape_convoy._round_counts()
    return {"per_cycle": per_cycle, "checked": checked,
            "rounds": rounds1[0] - rounds0[0],
            "pods": rounds1[1] - rounds0[1],
            "report": sim.run_report()}


def test_plain_round_calls_a_pod(smoke_counts):
    pods = smoke_counts["pods"]
    calls = sum(c["round"] for c in smoke_counts["per_cycle"])
    assert smoke_counts["rounds"] == CYCLES and pods > 0
    assert calls / pods <= PLAIN_CALLS_PER_POD, (calls, pods)


def test_card_route_buffers_calls_a_round(smoke_counts):
    checked = smoke_counts["checked"]
    assert len(checked) == CYCLES, "every round uploaded with its pack"
    assert max(c["calls"] for c in checked) <= PACK_CALLS_PER_ROUND, checked


def test_cycle_outside_the_round_calls(smoke_counts):
    outside = [sum(v for k, v in c.items() if k != "round")
               for c in smoke_counts["per_cycle"]]
    assert max(outside) <= OUTSIDE_CALLS_PER_CYCLE, outside
    assert all(c["pack"] == 0 for c in smoke_counts["per_cycle"]), (
        "the CPU runs the plain round, never the card route's buffers")


def test_smoke_cycles_stay_whole(smoke_counts):
    report = smoke_counts["report"]
    assert report.invariant_breaches == []
    assert report.cycle_exceptions == []
    assert report.pods_bound > 0


def test_round_pack_probe_on_the_cpu():
    """testing/round_pack_probe at a small config 4 world on the CPU: the
    card route's buffers from the packed upload equal the device's own,
    within the budget; the plain round runs on the unpacked tensors."""
    from koordinator_tpu_torch.testing import round_pack_probe

    rep = round_pack_probe.probe(n_nodes=12, n_pods=40, device="cpu")
    assert rep["round_buffers_calls"] <= PACK_CALLS_PER_ROUND
    assert rep["round_buffers_calls_unpacked"] > rep["round_buffers_calls"]
    assert rep["pack_stats"]["put"] > 0 and rep["plain_seconds"] > 0
