"""The node-parallel kept-pod replay's decomposition on the CPU.

models/replay_by_node.py ``replay_by_node`` is the plain version of
csrc/replay_by_node.cu: the kept pods bucketed by node, each bucket in
queue order; each quota cell's pods in queue order; the affinity counts
per (term, domain), added once per node. These tests hold it, tolerance 0
on int32 views of every float, against models/fused_waves.replay_kept (the
pod-by-pod loop), against the JAX package's chained wave step carry by
carry (the port's chained step with this replay as its pass 3), and, per
card of a CPU mesh of 2 and 3 shards with the chosen nodes' domains
gathered, against parallel/full_chain_mesh.sharded_replay_kept. The worlds
carry NUMA pods, ports, volumes, a 3-deep quota tree, affinity and anti
terms, prod mode on and off, many pods on one node, and interleaved quota
groups with non-integer requests; a mutation that sums a cell out of queue
order must differ, and counts past 2^24 must raise.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.models import fused_waves as fw
from koordinator_tpu_torch.models import replay_by_node as rbn
from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import (
    permit,
    plain_round,
    resolve_balance_idx,
)
from koordinator_tpu_torch.models.scheduler_model import resolve_weight_idx
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import kernel_common as kc
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.parallel import full_chain_mesh as fcm
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing.mesh_round import virtual_mesh
from koordinator_tpu_torch.testing.synth import mixed_cluster

NODES, PODS = 30, 60  # divisible by 2 and 3 shards


def _bits(t) -> np.ndarray:
    t = torch.as_tensor(t)
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32).numpy()
    return t.numpy()


def _assert_same(got, want, what=""):
    (gs, gz), (ws, wz) = got, want
    assert len(gs) == len(ws) == 11
    for k, (a, b) in enumerate(zip(gs, ws)):
        assert a.dtype == b.dtype, (what, k)
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{what} slot {k}")
    np.testing.assert_array_equal(gz.numpy(), wz.numpy(), err_msg=what)


@functools.lru_cache(maxsize=None)
def _world(seed: int, prod: bool):
    """(fc, chosen, kept, wave-start state) of a mixed cluster's first
    round and Permit, the LoadAware sums non-integer (numpy seeded)."""
    _c, state = mixed_cluster(seed, NODES, PODS)
    args = LoadAwareArgs(score_according_prod_usage=prod)
    fc, _p, _n, _t, _gi, ng, ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    pfc = to_device(fc, "cpu")
    chosen = plain_round(pfc, resolve_weight_idx(args, active), prod,
                         resolve_balance_idx(active))[0]
    kept = permit(pfc, chosen, ng, ngroups) >= 0
    N, R = pfc.base.requested.shape
    rng = np.random.default_rng(seed)
    est = torch.from_numpy(rng.uniform(0, 40, (N, R)).astype(np.float32))
    est_pr = (torch.from_numpy(rng.uniform(0, 20, (N, R)).astype(np.float32))
              if prod else torch.zeros((N, R)))
    state0 = (pfc.base.requested, est, est_pr, pfc.numa_free,
              pfc.bind_free, pfc.quota_used, pfc.aff_count, pfc.anti_cover,
              pfc.aff_exists.to(torch.bool), pfc.port_used, pfc.vol_free)
    return pfc, chosen, kept, state0


def _both(pfc, chosen, kept, state0, prod):
    return (rbn.replay_by_node(pfc, prod, state0, chosen, kept),
            fw.replay_kept(pfc, prod, state0, chosen, kept))


@pytest.mark.parametrize("seed", [3, 7])
@pytest.mark.parametrize("prod", [False, True])
def test_by_node_equals_replay_kept_on_mixed_worlds(seed, prod):
    pfc, chosen, kept, state0 = _world(seed, prod)
    # the world reaches every part of the commit
    T = pfc.aff_dom.shape[1]
    assert int(kept.sum()) > 10 and T > 0
    assert bool((kept & pfc.needs_numa).any())
    assert bool((kept[:, None] & pfc.pod_port_wants).any())
    assert bool((kept[:, None] & pfc.pod_aff_match).any())
    assert pfc.vol_needed.shape[1] > 1
    assert pfc.quota_ancestors.shape[1] >= 3
    assert bool((kept & (pfc.quota_id >= 0)).any())
    if prod:
        assert bool((kept & pfc.base.is_prod).any())
    before = tuple(t.clone() for t in state0)
    got, want = _both(pfc, chosen, kept, state0, prod)
    _assert_same(got, want, f"seed {seed} prod {prod}")
    assert bool((got[1][kept] >= 0).any())  # zones re-picked
    # the input state is not modified
    _assert_same((state0, want[1]), (before, want[1]))


def test_many_pods_on_one_node():
    pfc, chosen, kept, state0 = _world(3, False)
    # every kept pod onto the node with the most NUMA zones' room
    n0 = int(pfc.numa_free.sum(dim=(1, 2)).argmax())
    many = torch.where(kept, torch.tensor(n0, dtype=chosen.dtype), chosen)
    got, want = _both(pfc, many, kept, state0, False)
    _assert_same(got, want, "one node")
    assert int(kept.sum()) > 20


def _interleaved(seed):
    """The mixed world with the kept pods' quota ids interleaved over
    three groups that share the tree's root and their requests
    non-integer: the root's cells add every kept pod's requests."""
    pfc, chosen, kept, state0 = _world(seed, False)
    anc = pfc.quota_ancestors
    depth = (anc >= 0).sum(dim=1)
    deep = torch.nonzero(depth >= 3).flatten()[:3].tolist()
    assert len(deep) == 3
    roots = {int(anc[g][depth[g] - 1]) for g in deep}
    assert len(roots) == 1
    P, R = pfc.requests.shape
    rng = np.random.default_rng(seed + 1)
    qid = pfc.quota_id.clone()
    order = torch.nonzero(kept).flatten().tolist()
    for k, i in enumerate(order):
        qid[i] = deep[k % 3]
    req = torch.from_numpy(
        (rng.uniform(0.01, 3.0, (P, R)) * 10.0 ** rng.integers(
            0, 7, (P, 1))).astype(np.float32))
    return pfc._replace(quota_id=qid, requests=req), chosen, kept, state0


def test_interleaved_quota_groups_and_an_out_of_order_cell(monkeypatch):
    pfc, chosen, kept, state0 = _interleaved(7)
    got, want = _both(pfc, chosen, kept, state0, False)
    _assert_same(got, want, "interleaved")
    # a cell summed out of queue order gives other bits
    real = rbn._cell_sum
    monkeypatch.setattr(rbn, "_cell_sum",
                        lambda acc, vals: real(acc, vals.flip(0)))
    bad = rbn.replay_by_node(pfc, False, state0, chosen, kept)
    assert not np.array_equal(_bits(bad[0][5]), _bits(want[0][5]))


@pytest.mark.parametrize("x", [2.0**24, 0.5])
def test_counts_past_the_exact_range_raise(x):
    pfc, chosen, kept, state0 = _world(3, False)
    # a term some kept pod matches on a node with a domain
    T = pfc.aff_dom.shape[1]
    t = next(t for t in range(T)
             if bool((kept & pfc.pod_aff_match[:, t]
                      & (pfc.aff_dom[chosen.clamp_min(0).long(), t] >= 0))
                     .any()))
    cnt = pfc.aff_count.clone()
    cnt[:, t] = x
    state = state0[:6] + (cnt,) + state0[7:]
    with pytest.raises(ValueError, match="2\\^24"):
        rbn.replay_by_node(pfc, False, state, chosen, kept)
    # the pod-by-pod loop has no such bound
    fw.replay_kept(pfc, False, state, chosen, kept)


# ---------------------------------------------------------------------------
# against the JAX package: the chained wave step, carry by carry
# ---------------------------------------------------------------------------

class _ByNode(fw.WaveBackend):
    """The CPU passes, with replay_by_node as pass 3."""

    def replay(self, fc_carry, chosen, kept, state0, prod_mode):
        return rbn.replay_by_node(fc_carry, prod_mode, state0, chosen, kept)


@pytest.mark.parametrize("world", ["spread", "claims", "prod"])
def test_chained_step_with_by_node_replay_matches_reference(world):
    from test_torch_fused_waves import (
        _args,
        _fc,
        _reference_chain,
        _sides,
        _world_inputs,
    )

    waves = 4
    fc, sides, b = _world_inputs(world)
    step = fw.build_chained_wave_step(
        _args(b["prod"]), b["num_gangs"], b["num_groups"],
        active_axes=b["active_axes"], prod=b["prod"], claims=b["claims"],
        res=b["res"], backend=_ByNode(False))
    tfc, tsides = _fc(fc), _sides(sides)
    carry = fw.initial_wave_carry(tfc, tsides)
    for w, (ref_carry, ref_rows) in enumerate(_reference_chain(world,
                                                               waves)):
        carry, rows = step(tfc, carry, tsides)
        for name, got, want in zip(fw.WAVE_STATE_FIELDS, carry, ref_carry):
            assert (got is None) == (want is None), (w, name)
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"wave {w} {name}")
        for k in ("bind_pods", "bind_nodes", "bind_zones"):
            np.testing.assert_array_equal(getattr(rows, k).numpy(),
                                          ref_rows[k], err_msg=f"{w} {k}")


# ---------------------------------------------------------------------------
# per card of a mesh: the card's rows, the chosen nodes' domains gathered
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cards", [[[0], [1]], [[0], [1, 2]], [[0, 1, 2]]])
def test_per_card_by_node_equals_sharded_replay_kept(cards):
    depth = sum(len(ks) for ks in cards)
    pfc, chosen, kept, state0 = _world(7, False)
    node_slots = fcm._STATE_NODE_SLOTS

    def rows(x, lo, hi):
        return x[lo:hi]

    # the real nodes only (the padded rows would not split in 3)
    pfc = fcm.node_rows(pfc, 0, NODES)
    state0 = tuple(rows(x, 0, NODES) if i in node_slots else x
                   for i, x in enumerate(state0))
    per = NODES // depth
    T = pfc.aff_dom.shape[1]
    g = chosen.clamp_min(0).long()
    assert int(g[kept].max()) < NODES
    dom = torch.where(kept[:, None], pfc.aff_dom[g], 0.0)
    mesh = virtual_mesh(depth, "cpu")
    fcs = {k: fcm.node_rows(pfc, k * per, (k + 1) * per)
           for k in range(depth)}
    states = {k: tuple(rows(x, k * per, (k + 1) * per) if i in node_slots
                       else x for i, x in enumerate(state0))
              for k in range(depth)}
    want_states, want_zones = fcm.sharded_replay_kept(
        fcs, mesh, per, False, states, chosen, kept)
    single, single_zones = fw.replay_kept(pfc, False, state0, chosen, kept)
    for ks in cards:
        lo, hi = ks[0] * per, (ks[-1] + 1) * per
        view = fcm.node_rows(pfc, lo, hi)
        st = tuple(rows(x, lo, hi) if i in node_slots else x
                   for i, x in enumerate(state0))
        got, zones = rbn.replay_by_node(view, False, st, chosen, kept,
                                        shards=ks, per=per, dom_rows=dom)
        on_card = kept & (g // per >= ks[0]) & (g // per <= ks[-1])
        np.testing.assert_array_equal(
            zones.numpy(), torch.where(on_card, want_zones, -1).numpy())
        np.testing.assert_array_equal(
            zones.numpy(), torch.where(on_card, single_zones, -1).numpy())
        for i in range(11):
            if i in node_slots:
                want = torch.cat([want_states[k][i] for k in ks])
                np.testing.assert_array_equal(_bits(got[i]),
                                              _bits(single[i][lo:hi]))
            else:
                want = want_states[ks[0]][i]
                np.testing.assert_array_equal(_bits(got[i]),
                                              _bits(single[i]))
            np.testing.assert_array_equal(_bits(got[i]), _bits(want),
                                          err_msg=f"{cards} {ks} slot {i}")
    assert T > 0


# ---------------------------------------------------------------------------
# the kernel's Python side
# ---------------------------------------------------------------------------

def _constants(source):
    src = (kc.CSRC_DIR / source).read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"\b(k\w+)\s*=\s*(\d+)u?\b", src)}


def test_replay_constants_mirror_the_source():
    c = _constants(fck.REPLAY_SOURCE)
    assert (c["kListPerThread"], c["kPodsPerThread"], c["kNodeBits"],
            c["kMaxAxes"]) == (
        fck.REPLAY_LIST_PER_THREAD, fck.REPLAY_PODS_PER_THREAD,
        fck.REPLAY_NODE_BITS, fck.REPLAY_MAX_AXES)
    assert fck.REPLAY_MAX_AXES == fck.MAX_WEIGHTS
    assert (c["kErrBound"], c["kErrDomain"]) == (fck.REPLAY_ERR_BOUND,
                                                 fck.REPLAY_ERR_DOMAIN)
    # a node block's rows fit an entry's node bits
    assert max(fck.REPLAY_THREADS) < 1 << fck.REPLAY_NODE_BITS
    src = (kc.CSRC_DIR / fck.REPLAY_SOURCE).read_text()
    assert "__launch_bounds__(256)" in src
    assert max(fck.REPLAY_THREADS) == 256


def test_replay_block_fits_shared_memory():
    # config 4's shape (R = 3, two zones, a few ports, 100 quota groups)
    nt = fck.replay_threads(3, 2, 8, 100)
    assert nt == 256
    assert fck.replay_smem_bytes(nt, 3, 2, 8, 100) <= kc.SMEM_BUDGET_BYTES
    # the node role: the prefix scratch, the list and its segments, the
    # 3R + KR + 2 + PT rows
    take = [(256 // 32 + 1) * 4, 16 * 256 * 4, 16 * 256 * 4,
            (9 + 6 + 2 + 8) * 256 * 4]
    assert fck.replay_smem_bytes(256, 3, 2, 8, 100) == sum(
        (n + 15) & ~15 for n in take)
    # a wide shape takes fewer rows a block; past every size it raises
    wide = fck.replay_threads(16, 8, 400, 100)
    assert wide < 256
    assert fck.replay_smem_bytes(wide, 16, 8, 400, 100) <= (
        kc.SMEM_BUDGET_BYTES)
    with pytest.raises(kc.KernelContractError, match="shared memory"):
        fck.replay_threads(16, 8, 8000, 100)


def test_replay_wrappers_refuse_cpu_tensors():
    pfc, chosen, kept, state0 = _world(3, False)
    before = (fck.replay_launches, fck.xchg_replay_launches)
    with pytest.raises(ValueError, match="CUDA"):
        fck.full_chain_replay(pfc, chosen, kept, state0, False)
    with pytest.raises(ValueError, match="CUDA"):
        fck.full_chain_replay_cards(
            [(pfc, [0], chosen, kept, state0, None)], False, 1)
    assert (fck.replay_launches, fck.xchg_replay_launches) == before
