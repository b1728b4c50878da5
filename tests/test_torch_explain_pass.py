"""The stage-count pass's inputs and steps, on the CPU, against the plain
counts and the JAX package's explain_stage_counts.

The CUDA pass (csrc/explain_counts.cu) reads the full-chain round's own
packed records (valid pods first, each naming its row) and node flags, or
packs them itself when called alone; ops/explain_kernel.counts_from_pack is
its plain version on those same inputs. Here both packs, run through it,
equal models/full_chain.explain_stage_counts on the inputs and the JAX
package's function, on the synth and the cross-feature (mixed) worlds of
tests/test_torch_explain.py, at the cycle-start and a perturbed state. The
per-card route (explain_counts_shards: the minima only where the batch has
terms, each shard's counts added into one buffer, the verdicts from the
first shard) runs its plain steps on the CPU and equals
parallel/full_chain_mesh.sharded_stage_counts at D = 2 and 3, in a world
with spread terms (mixed) and one without (synth). Counts are integers:
every comparison is exact.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_explain import _packed, _perturbed_state, _ref_counts

from koordinator_tpu_torch.models import fused_waves as fw
from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import (
    cycle_start_state,
    explain_stage_counts,
    resolve_balance_idx,
    resolve_weight_idx,
)
from koordinator_tpu_torch.ops import explain_kernel as ek
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops.kernel_common import (
    CSRC_DIR,
    REC_POD,
    SMEM_BUDGET_BYTES,
    KernelContractError,
)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.parallel.full_chain_mesh import (
    node_rows,
    sharded_stage_counts,
)
from koordinator_tpu_torch.testing.mesh_round import _padded_fc, virtual_mesh

WORLDS = ("synth", "mixed")


def _state(fc, pfc, kind):
    if kind == "cycle-start":
        return cycle_start_state(pfc)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in _perturbed_state(fc))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("state_kind", ["cycle-start", "perturbed"])
def test_pass_on_the_rounds_pack_equals_its_own_pack(world, state_kind):
    fc, _ng, _ngroups, n_real = _packed(world)
    pfc = to_device(fc, "cpu")
    P = pfc.base.fit_requests.shape[0]
    # every third pod outside pod_valid, so that the round's valid-first
    # records are a true reordering (the counts cover every pod row)
    pfc = pfc._replace(base=pfc.base._replace(
        pod_valid=pfc.base.pod_valid & (torch.arange(P) % 3 != 0)))
    state = _state(fc, pfc, state_kind)
    records, n_valid, flags = fck.round_pack(pfc)
    assert int(n_valid) == int(pfc.base.pod_valid.sum())
    assert not torch.equal(records[:, REC_POD], torch.arange(
        P, dtype=torch.int32))
    own = ek.pack_for(pfc)
    assert torch.equal(own.records[:, REC_POD],
                       torch.arange(P, dtype=torch.int32))
    round_pack = ek.Pack(records, flags)
    ref = _ref_counts(fc, tuple(np.asarray(t) for t in state), n_real)
    for nr in (n_real, n_real - 3):
        want = explain_stage_counts(pfc, state, nr).numpy()
        if nr == n_real:
            np.testing.assert_array_equal(want, ref)
        for pack in (round_pack, own):
            got = ek.counts_from_pack(pfc, state, nr, pack)
            assert got.dtype == torch.uint32
            np.testing.assert_array_equal(got.numpy(), want)
            # the wrapper's CPU route with a pack is that plain version
            np.testing.assert_array_equal(
                ek.explain_counts(pfc, state, nr, pack=pack).numpy(), want)
    assert ref.sum() > 0


def test_a_pack_that_lost_a_field_is_caught():
    """counts_from_pack reads the pods from the records alone: a record
    whose fit requests were zeroed counts fewer Fit rejections."""
    fc, _ng, _ngroups, n_real = _packed("mixed")
    pfc = to_device(fc, "cpu")
    state = _state(fc, pfc, "perturbed")
    records, _n, flags = fck.round_pack(pfc)
    lay = fck.record_layout(*(fck._dims(pfc)[k] for k in
                              ("R", "T", "PT", "VG")))
    broken = records.clone()
    broken[:, lay["off_fit"]:lay["off_req"]] = 0
    want = explain_stage_counts(pfc, state, n_real)
    got = ek.counts_from_pack(pfc, state, n_real, ek.Pack(broken, flags))
    assert int(want[:, 2].to(torch.int64).sum()) > 0
    assert int(got[:, 2].to(torch.int64).sum()) == 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("depth", [2, 3])
def test_shard_pass_steps_equal_sharded_stage_counts(world, depth):
    fc, _ng, _ngroups, n_real = _packed(world)
    mesh = virtual_mesh(depth, "cpu")
    pfc = to_device(_padded_fc(fc, mesh), "cpu")
    per = pfc.base.allocatable.shape[0] // depth
    views = {k: node_rows(pfc, k * per, (k + 1) * per) for k in range(depth)}
    states = {k: cycle_start_state(v) for k, v in views.items()}
    has_spread = bool((pfc.pod_spread_skew > 0).any())
    assert has_spread == (world == "mixed")
    want = sharded_stage_counts(views, states, mesh, per, n_real)
    got = ek.explain_counts_shards(
        [(views[k], states[k], k * per) for k in range(depth)], n_real)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # and the one-device counts on the padded batch
    np.testing.assert_array_equal(
        got.numpy(),
        explain_stage_counts(pfc, cycle_start_state(pfc), n_real).numpy())


def test_wave_backend_counts_beside_its_round():
    """The wave step's pass 1 with its counts (WaveBackend.round_counts)
    on the CPU: the plain round and the plain counts, as separately."""
    fc, _ng, _ngroups, n_real = _packed("mixed")
    pfc = to_device(fc, "cpu")
    args = LoadAwareArgs()
    wi, bi = resolve_weight_idx(args, None), resolve_balance_idx(None)
    backend = fw.WaveBackend(False)
    (chosen, state), counts = backend.round_counts(
        pfc, wi, False, bi, False, n_real)
    want = backend.round(pfc, wi, False, bi, False)
    assert torch.equal(chosen, want[0]) and (chosen >= 0).any()
    for a, b in zip(state, want[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    np.testing.assert_array_equal(
        counts.numpy(),
        explain_stage_counts(pfc, cycle_start_state(pfc), n_real).numpy())


def _source():
    return (Path(CSRC_DIR) / ek.SOURCE).read_text()


def test_explain_params_mirror_the_kernel():
    src = _source()
    body = re.search(r"struct ExplainParams \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if decl.strip():
            first, *rest = decl.split(",")
            names += [first.split()[-1].lstrip("*")] + [r.strip() for r in rest]
    assert names == [f for f, _ in ek._Params._fields_]
    assert names[-4:] == ["tile", "splits", "accumulate", "write_flags"]
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kMaxThreads"] == ek.MAX_THREADS == max(ek.TILES)
    assert all(t % 32 == 0 for t in ek.TILES)  # whole warps
    words = re.search(r"explain_tile_words\(int R, int K, int T,\s*int PT\) "
                      r"\{\s*return ([^;]*);", src).group(1)
    assert words == "2 * R + K * R + 2 + 3 * T + PT + 5"
    assert ek.tile_words(3, 2, 0, 0) == 2 * 3 + 6 + 2 + 5


def test_plan_fills_the_card_and_refuses_what_does_not_fit():
    stride = fck.record_layout(3, 0, 0, 1)["rec_stride"]
    target = ek.BLOCKS_PER_SM * 132
    for P in (10240, 1280):
        tile, splits, nbytes = ek.plan(P, 5000, 3, 2, 0, 0, stride, 132)
        assert nbytes == ek.smem_bytes(3, 2, 0, 0, stride, tile)
        assert nbytes <= SMEM_BUDGET_BYTES
        tiles = -(-5000 // tile)
        per = -(-tiles // splits)
        # the grid reaches the target, and no split is empty
        assert -(-P // tile) * splits >= target
        assert (splits - 1) * per < tiles <= splits * per
    # wide terms shrink the tile; records past the budget raise
    wide = fck.record_layout(3, 100, 32, 1)["rec_stride"]
    tile, _s, nbytes = ek.plan(64, 640, 3, 2, 100, 32, wide, 132)
    assert tile < 256 and nbytes <= SMEM_BUDGET_BYTES
    with pytest.raises(KernelContractError, match="shared memory"):
        ek.plan(64, 640, 3, 2, 0, 0, 2000, 132)


def test_explain_ab_refuses_without_cuda(monkeypatch, capsys, tmp_path):
    from koordinator_tpu_torch.testing import explain_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert explain_ab.main() == 2
    assert "CUDA is not available" in capsys.readouterr().err
    # every variant's edit still applies to the sources
    monkeypatch.setattr(explain_ab, "VARIANT_DIR", tmp_path)
    trees = explain_ab.variant_trees()
    assert sorted(trees) == sorted(explain_ab.VARIANTS)
    assert "(live ? tid : 0)" in (
        trees["record_order"] / ek.SOURCE).read_text()
