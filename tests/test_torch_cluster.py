"""The Python side of the kernels' cluster design, on the CPU (no nvcc runs
here): the node partition, the pod-record packers, the shared-memory
estimates and the state selection, the blocked argmax the kernels merge
across blocks, and the constants and structs the CUDA sources share with
their wrappers. The kernels themselves run in chip_smoke.py on the card."""

import re

import numpy as np
import pytest
import torch

from test_torch_kernel import _struct_fields

from koordinator_tpu_torch.models.convert import (
    schedule_inputs_from_numpy,
    to_device,
)
from koordinator_tpu_torch.models.full_chain import (
    build_best_full_chain_step,
    pod_independent_rows,
    resolve_weight_idx,
)
from koordinator_tpu_torch.models.scheduler_model import (
    build_best_schedule_step,
)
from koordinator_tpu_torch.ops import explain_kernel as ek
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import kernel_common as kc
from koordinator_tpu_torch.ops import schedule_kernel as sk
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.ops.quota import MAX_QUOTA_DEPTH
from koordinator_tpu_torch.scheduler.sidecar import SidecarServer
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing import (
    loadaware_inputs,
    mixed_cluster,
    synth_cluster,
    synth_full_cluster,
)

# (nodes, cluster size): N < C, N = 1, a ragged last block, the main path's
# 5120 at 16 and at 1 (several nodes per thread), and a 100k-node batch
PARTITIONS = [(3, 16), (1, 16), (1, 1), (1000, 16), (1023, 8), (5120, 16),
              (5120, 1), (5120, 2), (100_000, 16)]


@pytest.mark.parametrize("n_nodes,cluster", PARTITIONS)
def test_node_partition(n_nodes, cluster):
    plan = kc.cluster_plan(n_nodes, cluster)
    assert plan.block_threads <= 1024 and plan.block_threads % 32 == 0
    assert plan.node_threads + 32 == plan.block_threads
    block, thread = kc.node_owner(n_nodes, plan)
    assert ((block >= 0) & (block < cluster)).all()
    assert ((thread >= 0) & (thread < plan.node_threads)).all()
    # each block owns one contiguous slice of at most Nb nodes, as the
    # kernels compute it: [min(b * Nb, N), min((b + 1) * Nb, N))
    for b in range(cluster):
        lo = min(b * plan.nodes_per_block, n_nodes)
        hi = min(lo + plan.nodes_per_block, n_nodes)
        owned = torch.nonzero(block == b).flatten()
        assert owned.tolist() == list(range(lo, hi))
        # local node j belongs to thread j mod node_threads
        assert (thread[owned] == (owned - lo) % plan.node_threads).all()
    # every node has exactly one owner; where the slice fits the threads,
    # each thread owns at most one node
    pairs = block * plan.node_threads * 1_000_000 + thread * 1_000_000 \
        + torch.arange(n_nodes)
    assert torch.unique(pairs).numel() == n_nodes
    per_thread = torch.bincount(block * plan.node_threads + thread)
    if plan.nodes_per_block <= kc.MAX_NODE_THREADS:
        assert per_thread.max() == 1
    else:
        assert per_thread.max() == -(-plan.nodes_per_block
                                     // plan.node_threads)


def test_main_path_gives_each_thread_one_node():
    plan = kc.cluster_plan(5120, kc.CLUSTER_SIZE)
    assert plan == kc.ClusterPlan(16, 320, 320, 352)
    assert kc.cluster_plan(100_000).block_threads == kc.MAX_NODE_THREADS + 32


def _full_chain_fc(kind, seed):
    args = LoadAwareArgs()
    if kind == "synth":
        _, state = synth_full_cluster(24, 48, seed=seed)
    else:
        _, state = mixed_cluster(seed, 30, 50)
    fc, _p, _n, _t, _g, ng, ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(fc)
    return args, to_device(fc, "cpu"), ng, ngroups, active


def _bits_equal(a, b):
    if b.dtype.is_floating_point:
        return torch.equal(a.contiguous().view(torch.int32),
                           b.to(torch.float32).contiguous().view(torch.int32))
    return torch.equal(a.to(b.dtype), b)


@pytest.mark.parametrize("kind,seed", [("synth", 0), ("synth", 3),
                                       ("mixed", 101), ("mixed", 707)])
def test_full_chain_records_round_trip(kind, seed):
    _args, fc, _ng, _ngroups, _active = _full_chain_fc(kind, seed)
    _rnp, _rpr, gang_ok = pod_independent_rows(fc)
    rec = fck.pack_records(fc, gang_ok)
    d = fck._dims(fc)
    lay = fck.record_layout(d["R"], d["T"], d["PT"], d["VG"])
    assert rec.dtype == torch.int32
    assert rec.shape == (d["P"], lay["rec_stride"])
    assert lay["rec_stride"] % 4 == 0  # 16-byte rows for the bulk copy
    back = fck.unpack_records(rec, d["R"], d["T"], d["PT"], d["VG"])
    assert torch.equal(back.pop("pod"), torch.arange(d["P"],
                                                     dtype=torch.int32))
    assert _bits_equal(back.pop("gang_ok"), gang_ok)
    for name, value in back.items():
        ref = getattr(fc.base, name) if name in fc.base._fields \
            else getattr(fc, name)
        assert _bits_equal(value, ref), name
    if kind == "mixed":  # the configuration carries every optional field
        assert min(d["T"], d["PT"]) > 0 and d["VG"] > 1


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_schedule_records_round_trip(seed):
    args = LoadAwareArgs()
    inputs = schedule_inputs_from_numpy(loadaware_inputs(
        synth_cluster(num_nodes=20, num_pods=40, seed=seed), args)._asdict(),
        "cpu")
    rec = sk.pack_records(inputs)
    P, R = inputs.fit_requests.shape
    assert rec.shape == (P, sk.record_layout(R)["rec_stride"])
    back = sk.unpack_records(rec, R)
    assert torch.equal(back.pop("pod"), torch.arange(P, dtype=torch.int32))
    assert torch.equal(back.pop("fit_axes"), inputs.fit_requests > 0)
    for name, value in back.items():
        assert _bits_equal(value, getattr(inputs, name)), name
    # the listed axes ascend, so the Fit visits them in axis order
    words = rec[:, sk.REC_AXES:sk.REC_HEADER].to(torch.int64) & 0xFFFFFFFF
    axes = ((words[:, :, None] >> (8 * torch.arange(4))) & 0xFF).reshape(P, -1)
    nfit = rec[:, kc.REC_FLAGS] >> 8
    for p in range(P):
        listed = axes[p, :nfit[p]].tolist()
        assert listed == sorted(listed)


def test_valid_first_keeps_queue_order():
    valid = torch.tensor([True, False, True, True, False, True])
    rec = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    out, n_valid = kc.valid_first(rec, valid)
    assert n_valid.tolist() == [4]
    assert out[:, 0].tolist() == [0, 4, 6, 10, 2, 8]


def test_pack_bits_round_trip():
    rng = np.random.default_rng(5)
    for T in (0, 1, 31, 32, 33, 70):
        mask = torch.from_numpy(rng.random((9, T)) < 0.5)
        words = kc.pack_bits(mask)
        assert words.shape == (9, -(-T // 32)) and words.dtype == torch.int32
        assert torch.equal(kc.unpack_bits(words, T), mask)


def _main_shapes():
    # BASELINE config 4 after active-axis reduction: R=3, K=2, G=100, W=2
    return dict(n_nodes=5120, R=3, W=2, K=2, G=100, D=MAX_QUOTA_DEPTH, T=0,
                PT=0, VG=1)


def test_estimate_smem_bytes_main_path_fits_and_100k_does_not():
    fc_shape = _main_shapes()
    assert fck.estimate_smem_bytes(**fc_shape) <= kc.SMEM_BUDGET_BYTES
    assert sk.estimate_smem_bytes(5120, 14, 2) <= kc.SMEM_BUDGET_BYTES
    big = dict(fc_shape, n_nodes=100_000)
    assert fck.estimate_smem_bytes(**big) > kc.SMEM_BUDGET_BYTES
    assert sk.estimate_smem_bytes(100_000, 14, 2) > kc.SMEM_BUDGET_BYTES
    # the device-memory state keeps only the ring and the partials
    assert fck.estimate_smem_bytes(**big, state="global") < 48 * 1024
    assert sk.estimate_smem_bytes(100_000, 14, 2, state="global") < 48 * 1024
    assert kc.choose_state(fck.estimate_smem_bytes(**big)) == "global"


def test_state_selection_reads_only_shapes():
    args, fc, ng, ngroups, active = _full_chain_fc("synth", 0)
    wi = resolve_weight_idx(args, active)
    before = (fck.launches, sk.launches)
    assert fck.state_for(fc, wi)[0] == "smem"
    state, plan, nbytes = fck.state_for(fc, wi, smem_budget_bytes=0)
    assert state == "global" and nbytes == fck.estimate_smem_bytes(
        fc.base.allocatable.shape[0], fc.base.fit_requests.shape[1], len(wi),
        fc.numa_free.shape[1], *fc.quota_ancestors.shape,
        fc.aff_dom.shape[1], fc.port_used.shape[1], fc.vol_needed.shape[1],
        state="global")
    assert plan == kc.cluster_plan(fc.base.allocatable.shape[0])
    inputs = schedule_inputs_from_numpy(loadaware_inputs(
        synth_cluster(num_nodes=8, num_pods=16, seed=0), args)._asdict(),
        "cpu")
    assert sk.state_for(inputs, (0, 1))[0] == "smem"
    assert sk.state_for(inputs, (0, 1), smem_budget_bytes=0)[0] == "global"
    # on the CPU the selectors take the plain round, whatever the budget
    step = build_best_full_chain_step(args, ng, ngroups, active_axes=active,
                                      smem_budget_bytes=0)
    step(fc)
    assert step.last_backend == "serial" and step.last_state is None
    la = build_best_schedule_step(args, device="cpu", smem_budget_bytes=0)
    la(inputs)
    assert la.last_backend == "serial" and la.last_state is None
    assert (fck.launches, sk.launches) == before


@pytest.mark.parametrize("seed", range(6))
def test_blocked_argmax_is_first_maximum(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    # tie-heavy: a few score levels, infeasible nodes at -1
    score = torch.from_numpy(rng.integers(-1, 3, n).astype(np.float32))
    expect = int(torch.argmax(score))
    for cluster in (1, 2, 4, 16):
        plan = kc.cluster_plan(n, cluster)
        for _ in range(3):
            order = rng.permutation(cluster).tolist()
            assert kc.blocked_argmax(score, plan, order) == expect


def test_blocked_argmax_several_nodes_per_thread():
    # 5000 nodes on one block: 992 threads, up to 6 nodes each
    score = torch.zeros(5000)
    score[[17, 1009, 4999]] = 2.0
    assert kc.blocked_argmax(score, kc.cluster_plan(5000, 1)) == 17


def _constants(source):
    """name -> value of every integer constexpr in csrc/<source>."""
    src = (kc.CSRC_DIR / source).read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"\b(k\w+)\s*=\s*(\d+)u?\b", src)}


def test_shared_constants_mirror_source():
    c = _constants("kernel_common.cuh")
    assert c["kRingStages"] == kc.RING_STAGES
    assert c["kMaxBlockThreads"] == kc.MAX_NODE_THREADS + 32
    assert (c["kRecFlags"], c["kRecPod"]) == (kc.REC_FLAGS, kc.REC_POD)
    for name in ("PROD", "DS", "VALID", "GANG_OK", "NUMA", "BIND",
                 "FULL_PCPUS"):
        cname = "kPod" + "".join(w.capitalize() for w in name.split("_"))
        assert c[cname] == getattr(kc, "POD_" + name), cname
    for name, cname in (("OK", "kNodeOk"), ("SCORE_VALID", "kNodeScoreValid"),
                        ("REJECT_NP", "kNodeRejectNp"),
                        ("REJECT_PR", "kNodeRejectPr"),
                        ("HAS_TOPO", "kNodeHasTopo")):
        assert c[cname] == getattr(kc, "NODE_" + name), cname
    # the pod record's words past the header live in the Filter chain's
    # header, which the full chain and the explain pass share
    f = _constants("filter_chain.cuh")
    assert [f[k] for k in ("kRecCores", "kRecTaint", "kRecQuota", "kRecPref",
                           "kRecPpref", "kRecImg")] == [
        fck.REC_CORES, fck.REC_TAINT, fck.REC_QUOTA, fck.REC_PREF,
        fck.REC_PPREF, fck.REC_IMG]
    assert _constants(sk.SOURCE)["kRecAxes"] == sk.REC_AXES


@pytest.mark.parametrize("module,struct", [(fck, "FullChainParams"),
                                           (sk, "ScheduleStepParams"),
                                           (ek, "ExplainParams")])
def test_params_structs_mirror_sources(module, struct):
    assert _struct_fields(module.SOURCE, struct) == [
        f for f, _ in module._Params._fields_]


def test_sidecar_timings_on_cpu():
    args, fc, ng, ngroups, active = _full_chain_fc("synth", 1)
    server = SidecarServer(device="cpu")
    plain = server.schedule_batch(fc, args, ng, ngroups, active)
    timings = {}
    timed = server.schedule_batch(fc, args, ng, ngroups, active,
                                  timings=timings)
    for a, b in zip(plain, timed):
        np.testing.assert_array_equal(a, b)
    assert set(timings) == {"upload", "round", "readback"}
    assert all(v >= 0 for v in timings.values())


def test_pod_trace_phases_from_stamps():
    from koordinator_tpu_torch.testing import pod_trace

    pods = 5
    trace = np.zeros(pod_trace.TRACE_PODS * pod_trace.TRACE_SLOTS,
                     dtype=np.int64)
    t = trace.reshape(pod_trace.TRACE_PODS, pod_trace.TRACE_SLOTS)
    for u in range(pods):  # slots 0..5 at +0, +100, +110, +400, +430, +450
        t[u, :6] = 1000 + 500 * u + np.array([0, 100, 110, 400, 430, 450])
    t[2, 5] = 0  # pod 2 bound nowhere: no reserve stamp
    out = pod_trace.phases(trace, pods)
    assert out["node_loop"] == 100 and out["publish"] == 10
    assert out["merge_wait"] == 290 and out["merge"] == 30
    assert out["reserve"] == 20 and out["pod"] == 500
    assert out["record_wait"] == 50 and out["pods_bound"] == 4


def test_build_defines_key_the_library():
    before = kc._source_digest(fck.SOURCE)
    kc.BUILD_DEFINES = ("KOORD_TRACE",)
    try:
        assert kc._source_digest(fck.SOURCE) != before
    finally:
        kc.BUILD_DEFINES = ()
    assert kc._source_digest(fck.SOURCE) == before


def test_card_scripts_refuse_without_cuda(monkeypatch, capsys):
    from koordinator_tpu_torch.testing import kernel_ab, node_sweep, pod_trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script in (node_sweep, kernel_ab, pod_trace):
        assert script.main() == 2
    assert "CUDA is not available" in capsys.readouterr().err
