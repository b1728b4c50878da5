"""Wrapper of the full-chain CUDA kernel (csrc/full_chain.cu).

Replaces the TPU kernel of koordinator_tpu/ops/pallas_full_chain.py. The
wrapper computes the pod-independent rows in plain torch (LoadAware node
rejects, per-pod gang validity), packs every per-pod input into one record
per pod (valid pods first) and the node flags into one byte per node,
allocates the carried state and outputs with torch.empty/clone, checks every
tensor, and launches one thread-block cluster on the current stream
(csrc/kernel_common.cuh, "The cluster design"). The gang Permit barrier runs
afterwards in plain torch, as the JAX package runs it in XLA after the
Pallas call.

`estimate_smem_bytes` is the counterpart of the TPU kernel's
`estimate_vmem_bytes`: the shared memory one block takes, from the shapes
alone. Where the shared-memory layout exceeds the budget, the same kernel
keeps its carried state in device memory (`last_launch["state"]` says
which).

`launches` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch.models.full_chain import (
    permit,
    pod_independent_rows,
    resolve_balance_idx,
    resolve_weight_idx,
)
from koordinator_tpu_torch.ops.kernel_common import (
    CLUSTER_SIZE,
    NODE_HAS_TOPO,
    NODE_OK,
    NODE_REJECT_NP,
    NODE_REJECT_PR,
    NODE_SCORE_VALID,
    POD_BIND,
    POD_DS,
    POD_FULL_PCPUS,
    POD_GANG_OK,
    POD_NUMA,
    POD_PROD,
    POD_VALID,
    REC_FLAGS,
    REC_POD,
    RING_STAGES,
    SyncClock,
    check_tensor,
    choose_state,
    cluster_plan,
    f32_words,
    load_library,
    pack_bits,
    smem_take,
    unpack_bits,
    valid_first,
    words_f32,
)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs

SOURCE = "full_chain.cu"
MAX_WEIGHTS = 16
# pod record words after the header (csrc/full_chain.cu kRec*)
REC_CORES, REC_TAINT, REC_QUOTA, REC_PREF, REC_PPREF, REC_IMG = 2, 3, 4, 5, 6, 7
REC_HEADER = 8

launches = 0
last_launch: dict = {}

_P = ctypes.c_void_p
_PTR_FIELDS = (
    "records", "n_valid",
    "alloc", "term_np", "term_pr", "node_flags", "cpc", "policy",
    "taint_group", "vol_group", "aff_dom", "pref_scores", "img_scores",
    "ppref_w", "weights", "anc", "runtime", "quota_init", "aff_exists0",
    "requested", "delta_np", "delta_pr", "numa", "bind_free", "vol_free",
    "port_used", "aff_count", "anti_cover", "quota_blocks", "chosen",
)
_INT_FIELDS = (
    "P", "N", "R", "K", "G", "D", "T", "S", "S2", "ppref_stride", "PT", "SI",
    "VG", "prod_mode", "bal_c", "bal_m", "n_widx",
    "rec_stride", "off_fit", "off_req", "off_est", "off_aff", "off_anti",
    "off_match", "off_skew", "off_ports", "off_vol",
    "cluster_size", "nodes_per_block", "node_threads", "state_in_smem",
)


class _Params(ctypes.Structure):
    """Mirror of FullChainParams in csrc/full_chain.cu, field for field."""

    _fields_ = ([(f, _P) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int) for f in _INT_FIELDS]
                + [("widx", ctypes.c_int * MAX_WEIGHTS)])


def _lib():
    lib = load_library(SOURCE)
    if not getattr(lib, "_koord_bound", False):
        lib.full_chain_params_size.restype = ctypes.c_int
        lib.full_chain_smem_bytes.restype = ctypes.c_longlong
        lib.full_chain_smem_bytes.argtypes = [ctypes.POINTER(_Params)]
        lib.full_chain_instance.restype = ctypes.c_int
        lib.full_chain_instance.argtypes = [ctypes.POINTER(_Params)]
        lib.full_chain_launch.restype = ctypes.c_int
        lib.full_chain_launch.argtypes = [ctypes.POINTER(_Params),
                                          ctypes.c_void_p]
        size = lib.full_chain_params_size()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"FullChainParams layout mismatch: C {size} bytes, "
                f"ctypes {ctypes.sizeof(_Params)}")
        lib._koord_bound = True
    return lib


def record_layout(R: int, T: int, PT: int, VG: int) -> dict:
    """Word offsets of one pod's record: the header (flags, queue index,
    cores, taint mask, quota/pref/ppref/image ids), then fit requests,
    requests and estimates [R], the required-affinity, anti-affinity and
    match bits [ceil(T / 32)] each, the spread skews [T], the port bits
    [ceil(PT / 32)] and the volume needs [VG]; the stride is a multiple of
    4 words, as the bulk copy wants 16-byte rows."""
    tw, pw = -(-T // 32), -(-PT // 32)
    off = {"off_fit": REC_HEADER}
    off["off_req"] = off["off_fit"] + R
    off["off_est"] = off["off_req"] + R
    off["off_aff"] = off["off_est"] + R
    off["off_anti"] = off["off_aff"] + tw
    off["off_match"] = off["off_anti"] + tw
    off["off_skew"] = off["off_match"] + tw
    off["off_ports"] = off["off_skew"] + T
    off["off_vol"] = off["off_ports"] + pw
    off["rec_stride"] = 4 * -(-(off["off_vol"] + VG) // 4)
    return off


def _dims(fc):
    inputs = fc.base
    P, R = inputs.fit_requests.shape
    T = fc.aff_dom.shape[1]
    G, D = fc.quota_ancestors.shape
    return dict(P=P, N=inputs.allocatable.shape[0], R=R,
                K=fc.numa_free.shape[1], G=G, D=D, T=T,
                S=fc.pref_scores.shape[1], S2=fc.ppref_w.shape[0] if T else 0,
                PT=fc.port_used.shape[1], SI=fc.img_scores.shape[1],
                VG=fc.vol_needed.shape[1])


def pack_records(fc, gang_ok) -> torch.Tensor:
    """[P, rec_stride] int32: every per-pod input of the round, one record
    per pod in queue order (record_layout), on the inputs' device."""
    inputs = fc.base
    d = _dims(fc)
    P, R, T, PT, VG = d["P"], d["R"], d["T"], d["PT"], d["VG"]
    lay = record_layout(R, T, PT, VG)
    dev = inputs.fit_requests.device
    i32 = torch.int32
    rec = torch.zeros((P, lay["rec_stride"]), dtype=i32, device=dev)
    flags = torch.zeros(P, dtype=i32, device=dev)
    for bit, col in ((POD_PROD, inputs.is_prod), (POD_DS, inputs.is_daemonset),
                     (POD_VALID, inputs.pod_valid), (POD_GANG_OK, gang_ok),
                     (POD_NUMA, fc.needs_numa), (POD_BIND, fc.needs_bind),
                     (POD_FULL_PCPUS, fc.full_pcpus)):
        flags |= col.to(torch.bool).to(i32) * bit
    rec[:, REC_FLAGS] = flags
    rec[:, REC_POD] = torch.arange(P, dtype=i32, device=dev)
    rec[:, REC_CORES] = f32_words(fc.cores_needed[:, None])[:, 0]
    rec[:, REC_TAINT] = f32_words(fc.pod_taint_mask[:, None])[:, 0]
    rec[:, REC_QUOTA] = fc.quota_id.to(i32)
    rec[:, REC_PREF] = fc.pod_pref_id.to(i32)
    rec[:, REC_PPREF] = fc.pod_ppref_id.to(i32)
    rec[:, REC_IMG] = fc.pod_img_id.to(i32)
    tw, pw = -(-T // 32), -(-PT // 32)
    for key, width, words in (
            ("off_fit", R, f32_words(inputs.fit_requests)),
            ("off_req", R, f32_words(fc.requests)),
            ("off_est", R, f32_words(inputs.estimated)),
            ("off_aff", tw, pack_bits(fc.pod_aff_req.to(torch.bool))),
            ("off_anti", tw, pack_bits(fc.pod_anti_req.to(torch.bool))),
            ("off_match", tw, pack_bits(fc.pod_aff_match.to(torch.bool))),
            ("off_skew", T, f32_words(fc.pod_spread_skew)),
            ("off_ports", pw, pack_bits(fc.pod_port_wants.to(torch.bool))),
            ("off_vol", VG, f32_words(fc.vol_needed))):
        rec[:, lay[key]:lay[key] + width] = words
    return rec


def unpack_records(rec: torch.Tensor, R: int, T: int, PT: int,
                   VG: int) -> dict:
    """Inverse of pack_records: the per-pod fields by their FullChainInputs
    names (``gang_ok`` for the gang validity the wrapper folds in, ``pod``
    for the queue index)."""
    lay = record_layout(R, T, PT, VG)
    flags = rec[:, REC_FLAGS]

    def flag(bit):
        return (flags & bit) != 0

    def f32(key, width):
        return words_f32(rec[:, lay[key]:lay[key] + width])

    def bits(key, width):
        return unpack_bits(rec[:, lay[key]:lay[key] + -(-width // 32)], width)

    return {
        "is_prod": flag(POD_PROD), "is_daemonset": flag(POD_DS),
        "pod_valid": flag(POD_VALID), "gang_ok": flag(POD_GANG_OK),
        "needs_numa": flag(POD_NUMA), "needs_bind": flag(POD_BIND),
        "full_pcpus": flag(POD_FULL_PCPUS),
        "pod": rec[:, REC_POD],
        "cores_needed": words_f32(rec[:, REC_CORES:REC_CORES + 1])[:, 0],
        "pod_taint_mask": words_f32(rec[:, REC_TAINT:REC_TAINT + 1])[:, 0],
        "quota_id": rec[:, REC_QUOTA], "pod_pref_id": rec[:, REC_PREF],
        "pod_ppref_id": rec[:, REC_PPREF], "pod_img_id": rec[:, REC_IMG],
        "fit_requests": f32("off_fit", R), "requests": f32("off_req", R),
        "estimated": f32("off_est", R),
        "pod_aff_req": bits("off_aff", T), "pod_anti_req": bits("off_anti", T),
        "pod_aff_match": bits("off_match", T),
        "pod_spread_skew": f32("off_skew", T),
        "pod_port_wants": bits("off_ports", PT),
        "vol_needed": f32("off_vol", VG),
    }


def node_flags(fc, reject_np, reject_pr) -> torch.Tensor:
    """[N] uint8: the node flag bits the kernel tests (NODE_*)."""
    inputs = fc.base
    flags = torch.zeros(inputs.node_ok.shape[0], dtype=torch.int32,
                        device=inputs.node_ok.device)
    for bit, col in ((NODE_OK, inputs.node_ok),
                     (NODE_SCORE_VALID, inputs.la_score_valid),
                     (NODE_REJECT_NP, reject_np), (NODE_REJECT_PR, reject_pr),
                     (NODE_HAS_TOPO, fc.has_topology)):
        flags |= col.to(torch.bool).to(torch.int32) * bit
    return flags.to(torch.uint8)


def estimate_smem_bytes(n_nodes: int, R: int, W: int, K: int, G: int,
                        D: int, T: int, PT: int, VG: int,
                        cluster_size: int = CLUSTER_SIZE,
                        state: str = "smem") -> int:
    """Dynamic shared memory of one block, from the shapes alone (csrc/
    full_chain.cu fc_smem_layout): the mbarriers, the record ring, the
    warps' and blocks' argmax partials, the reduction partials, the
    admission and affinity flags; in the "smem" state also the quota copy
    (usage, runtime, ancestors) and the block's node slice: the carried
    rows (requested, two deltas, NUMA zones, bindable cpus, volume
    headroom, ports, affinity counts and covers), allocatable and the two
    terms, and the node flags."""
    plan = cluster_plan(n_nodes, cluster_size)
    nw, nb, Q = plan.node_threads // 32, plan.nodes_per_block, T + 2
    stride = record_layout(R, T, PT, VG)["rec_stride"]
    regions = [(RING_STAGES + 2) * 8, RING_STAGES * stride * 4, 2 * nw * 8,
               2 * cluster_size * 8, 2 * Q * nw * 4, (nw + 1) * Q * 4, 2 * 4,
               max(T, 1) * 4]
    if state == "smem":
        node_floats = (R + 2 * W + K * R + 2 + PT + 2 * T) + (R + 2 * W)
        regions += [G * R * 4, G * R * 4, G * D * 4, node_floats * nb * 4, nb]
    at = 0
    for nbytes in regions:
        _, at = smem_take(at, nbytes)
    return at


def state_for(fc, weight_idx, smem_budget_bytes=None,
              cluster_size: int = CLUSTER_SIZE):
    """(state, plan, smem bytes per block) of a launch over ``fc``: the
    shared-memory state where its layout fits the budget, else device
    memory. Reads shapes only, so it runs on any device."""
    d = _dims(fc)
    shape = dict(n_nodes=d["N"], R=d["R"], W=len(weight_idx), K=d["K"],
                 G=d["G"], D=d["D"], T=d["T"], PT=d["PT"], VG=d["VG"],
                 cluster_size=cluster_size)
    state = choose_state(estimate_smem_bytes(**shape), smem_budget_bytes)
    return (state, cluster_plan(d["N"], cluster_size),
            estimate_smem_bytes(**shape, state=state))


def full_chain_round(fc, weight_idx, prod_mode: bool, bal_idx, *,
                     cluster_size: int = CLUSTER_SIZE,
                     smem_budget_bytes=None):
    """One round in the kernel: FullChainInputs (CUDA tensors) ->
    (chosen[P] int32 before Permit, requested[N, R], quota_used[G, R]).
    Raises for tensors anywhere but on the card."""
    global launches, last_launch
    inputs = fc.base
    if not inputs.allocatable.is_cuda:
        raise ValueError("full_chain_round launches the CUDA kernel and takes "
                         f"CUDA tensors, got {inputs.allocatable.device}")
    if len(weight_idx) > MAX_WEIGHTS:
        raise ValueError(f"at most {MAX_WEIGHTS} weighted axes")
    d = _dims(fc)
    P, N, R, K, G, D, T = (d[k] for k in "PNRKGDT")
    S, PT, SI, VG = d["S"], d["PT"], d["SI"], d["VG"]
    widx = list(weight_idx)
    W = len(widx)
    state, plan, smem_bytes = state_for(fc, widx, smem_budget_bytes,
                                        cluster_size)
    lay = record_layout(R, T, PT, VG)

    reject_np, reject_pr, gang_ok = pod_independent_rows(fc)
    records, n_valid = valid_first(pack_records(fc, gang_ok),
                                   inputs.pod_valid)
    u8, f32, i32 = torch.uint8, torch.float32, torch.int32

    def b(t):
        return t.to(u8).contiguous()

    dev = inputs.allocatable.device
    # carried state: the round's own copies, updated in place by the kernel
    requested = inputs.requested.to(f32).clone()
    quota_blocks = torch.empty((cluster_size, G, R), dtype=f32, device=dev)
    chosen = torch.full((P,), -1, dtype=i32, device=dev)
    args = {
        "records": (records, i32, (P, lay["rec_stride"])),
        "n_valid": (n_valid, i32, (1,)),
        "alloc": (inputs.allocatable, f32, (N, R)),
        "term_np": (inputs.la_term_nonprod[:, widx].contiguous(), f32, (N, W)),
        "term_pr": (inputs.la_term_prod[:, widx].contiguous(), f32, (N, W)),
        "node_flags": (node_flags(fc, reject_np, reject_pr), u8, (N,)),
        "cpc": (fc.cpus_per_core, f32, (N,)),
        "policy": (fc.numa_policy, i32, (N,)),
        "taint_group": (fc.node_taint_group, i32, (N,)),
        "vol_group": (fc.node_vol_group, i32, (N,)),
        "aff_dom": (fc.aff_dom, f32, (N, T)),
        "pref_scores": (fc.pref_scores, f32, (N, S)),
        "img_scores": (fc.img_scores, f32, (N, SI)),
        "ppref_w": (fc.ppref_w, f32, tuple(fc.ppref_w.shape)),
        "weights": (inputs.weights, f32, (R,)),
        "anc": (fc.quota_ancestors, i32, (G, D)),
        "runtime": (fc.quota_runtime, f32, (G, R)),
        "quota_init": (fc.quota_used.to(f32).contiguous(), f32, (G, R)),
        "aff_exists0": (b(fc.aff_exists), u8, (T,)),
        "requested": (requested, f32, (N, R)),
        "delta_np": (torch.zeros((N, W), dtype=f32, device=dev), f32, (N, W)),
        "delta_pr": (torch.zeros((N, W), dtype=f32, device=dev), f32, (N, W)),
        "numa": (fc.numa_free.to(f32).clone(), f32, (N, K, R)),
        "bind_free": (fc.bind_free.to(f32).clone(), f32, (N,)),
        "vol_free": (fc.vol_free.to(f32).clone(), f32, (N,)),
        "port_used": (fc.port_used.to(f32).clone(), f32, (N, PT)),
        "aff_count": (fc.aff_count.to(f32).clone(), f32, (N, T)),
        "anti_cover": (fc.anti_cover.to(f32).clone(), f32, (N, T)),
        "quota_blocks": (quota_blocks, f32, (cluster_size, G, R)),
        "chosen": (chosen, i32, (P,)),
    }
    params = _Params()
    for name in _PTR_FIELDS:
        t, dtype, shape = args[name]
        setattr(params, name, check_tensor(name, t, dtype, shape))
    sizes = dict(d, ppref_stride=fc.ppref_w.shape[1],
                 prod_mode=int(bool(prod_mode)), bal_c=int(bal_idx[0]),
                 bal_m=int(bal_idx[1]), n_widx=W, **lay,
                 cluster_size=cluster_size,
                 nodes_per_block=plan.nodes_per_block,
                 node_threads=plan.node_threads,
                 state_in_smem=int(state == "smem"))
    for name in _INT_FIELDS:
        setattr(params, name, sizes[name])
    for j, r in enumerate(widx):
        params.widx[j] = int(r)

    lib = _lib()
    c_bytes = lib.full_chain_smem_bytes(ctypes.byref(params))
    if c_bytes != smem_bytes:
        raise RuntimeError(f"estimate_smem_bytes says {smem_bytes} bytes, "
                           f"the kernel's layout {c_bytes}")
    # The temporaries above may be freed before the kernel ends: the caching
    # allocator hands their memory only to later work on this same stream.
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.full_chain_launch(ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"full_chain kernel launch failed: cudaError {err} "
                           f"(cluster of {cluster_size} x "
                           f"{plan.block_threads} threads, {smem_bytes} B "
                           "of shared memory per block)")
    launches += 1
    instance = ("common" if lib.full_chain_instance(ctypes.byref(params))
                else "generic")
    last_launch = {"state": state, "instance": instance,
                   "cluster_size": cluster_size,
                   "block_threads": plan.block_threads,
                   "nodes_per_block": plan.nodes_per_block,
                   "smem_bytes_per_block": smem_bytes}
    return chosen, requested, quota_blocks[0]


def build_cuda_full_chain_step(args: LoadAwareArgs, num_gangs: int,
                               num_groups: int, active_axes=None,
                               smem_budget_bytes=None):
    """FullChainInputs (CUDA tensors) -> (chosen[P], requested[N, R],
    quota_used[G, R]): the kernel's round, then the gang Permit barrier.
    Same contract as models.full_chain.build_full_chain_step.
    ``step.last_state`` is the state the last round kept ("smem" or
    "global"). With a ``timings`` dict the step synchronises after the
    round (wrapper and kernel) and after Permit and records their
    seconds."""
    weight_idx = resolve_weight_idx(args, active_axes)
    bal_idx = resolve_balance_idx(active_axes)
    prod_mode = args.score_according_prod_usage

    def step(fc, timings=None):
        clock = SyncClock(timings, fc.base.allocatable.device)
        chosen, requested, quota_used = full_chain_round(
            fc, weight_idx, prod_mode, bal_idx,
            smem_budget_bytes=smem_budget_bytes)
        step.last_state = last_launch["state"]
        clock.lap("round")
        out = permit(fc, chosen, num_gangs, num_groups)
        clock.lap("permit")
        return out, requested, quota_used

    step.last_backend = "cuda"
    step.last_state = None
    return step

