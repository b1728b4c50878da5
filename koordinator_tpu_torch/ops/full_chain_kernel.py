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

`full_chain_replay` launches the node-parallel replay (csrc/
replay_by_node.cu): the fused waves' kept-only replay (models/fused_waves.py,
pass 3), which commits the pods that survived the gang Permit onto the nodes
pass 1 chose, from the wave-start state, through the round's own Reserve
code (filter_chain.cuh commit_node). Its plain version is
models/replay_by_node.py, the same decomposition in plain torch: each
node's pods in queue order, each quota cell's pods in queue order, and the
affinity counts per (term, domain) added once.

`full_chain_round(..., terms=True)` launches the terms instance
(koordexplain "full"): the same round, also writing each pod's
decision-time score terms ([P, 5] f32, models/full_chain.EXPLAIN_TERMS).
`full_chain_round(..., counts_n_real=n)` also runs the stage-count pass of
ops/explain_kernel.py at the inputs' own state, on the round's packed
records and node flags, on a side stream beside the round (joined before
it returns); `build_cuda_full_chain_step(explain=...)` takes its stage
counts from there.

`full_chain_round_cards` and `full_chain_replay_cards` launch the
instances over a mesh of cards (csrc/kernel_common.cuh, "The exchange"):
each card's launch runs its shards as clusters, on that card's rows only;
the round's clusters exchange their stats and winners through the mesh's
mailboxes (ops/kernel_common.Mailboxes); the replay needs no exchange, each
card replaying the kept pods onto its own rows.
Every card's launch is queued before any is waited on, and a card whose
entries never arrive ends the others' rounds with ExchangeTimeout.

`launches` counts the round's launches (the terms instance's included),
`terms_launches` the terms instance's and `replay_launches` the replay's,
so a run can show that its main path went through the kernel;
`xchg_launches`, `xchg_terms_launches` and `xchg_replay_launches` count
the mesh-of-cards instances' launches, one per card.
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch.models.full_chain import (
    EXPLAIN_TERMS,
    NUM_EXPLAIN_STAGES,
    ExplainOut,
    permit,
    pod_independent_rows,
    resolve_balance_idx,
    resolve_weight_idx,
)
from koordinator_tpu_torch.ops.kernel_common import (
    CLUSTER_SIZE,
    MAX_LOCAL_SHARDS,
    NODE_HAS_TOPO,
    NODE_OK,
    NODE_REJECT_NP,
    NODE_REJECT_PR,
    NODE_SCORE_VALID,
    MAX_SHARDS,
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
    SMEM_BUDGET_BYTES,
    KernelContractError,
    Mailboxes,
    SyncClock,
    _Xchg,
    check_tensor,
    choose_state,
    cluster_plan,
    exchange_pairs,
    f32_words,
    launch_device,
    launch_error,
    load_library,
    metadata_only,
    on_device,
    pack_bits,
    smem_take,
    unpack_bits,
    valid_first,
    words_f32,
)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs

SOURCE = "full_chain.cu"
REPLAY_SOURCE = "replay_by_node.cu"
MAX_WEIGHTS = 16
NUM_TERMS = len(EXPLAIN_TERMS)
# pod record words after the header (csrc/full_chain.cu kRec*)
REC_CORES, REC_TAINT, REC_QUOTA, REC_PREF, REC_PPREF, REC_IMG = 2, 3, 4, 5, 6, 7
REC_HEADER = 8

launches = 0
terms_launches = 0
replay_launches = 0
xchg_launches = 0
xchg_terms_launches = 0
xchg_replay_launches = 0
last_launch: dict = {}
# the winner's exchange payload words ahead of its aff_dom row, and the
# merged result's (csrc/full_chain.cu kWinHead, kResHead)
WIN_HEAD, RES_HEAD = 6, 8

_P = ctypes.c_void_p
_PTR_FIELDS = (
    "records", "n_valid",
    "alloc", "term_np", "term_pr", "node_flags", "cpc", "policy",
    "taint_group", "vol_group", "aff_dom", "pref_scores", "img_scores",
    "ppref_w", "weights", "anc", "runtime", "quota_init", "aff_exists0",
    "requested", "delta_np", "delta_pr", "numa", "bind_free", "vol_free",
    "port_used", "aff_count", "anti_cover", "quota_blocks", "chosen",
    "aff_exists_out", "terms",
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
                + [("widx", ctypes.c_int * MAX_WEIGHTS), ("x", _Xchg)])


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
        lib.full_chain_max_clusters.restype = ctypes.c_int
        lib.full_chain_max_clusters.argtypes = [ctypes.POINTER(_Params)]
        lib.full_chain_payload_words.restype = ctypes.c_int
        lib.full_chain_payload_words.argtypes = [ctypes.c_int]
        lib.koord_enable_peer.restype = ctypes.c_int
        lib.koord_enable_peer.argtypes = [ctypes.c_int]
        size = lib.full_chain_params_size()
        if size != ctypes.sizeof(_Params):
            raise KernelContractError(
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


def round_pack(fc):
    """(records, n_valid, node flags) as a round packs them for the kernel:
    pack_records with the valid pods first (valid_first) and node_flags,
    on the inputs' device."""
    reject_np, reject_pr, gang_ok = pod_independent_rows(fc)
    records, n_valid = valid_first(pack_records(fc, gang_ok),
                                   fc.base.pod_valid)
    return records, n_valid, node_flags(fc, reject_np, reject_pr)


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


def payload_words(T: int) -> int:
    """32-bit payload words of one mailbox entry of the round over a mesh
    of cards (csrc/full_chain.cu full_chain_payload_words): the winner's
    score, global index, runner-up and three terms, then its aff_dom row;
    the stats entry's T + 2 words are never more."""
    return WIN_HEAD + int(T)


def result_words(T: int) -> int:
    """32-bit words of one merged exchange result in shared memory (even,
    csrc/full_chain.cu fc_result_words)."""
    return (RES_HEAD + int(T) + 1) & ~1


def estimate_smem_bytes(n_nodes: int, R: int, W: int, K: int, G: int,
                        D: int, T: int, PT: int, VG: int,
                        cluster_size: int = CLUSTER_SIZE,
                        state: str = "smem", exchange: bool = False) -> int:
    """Dynamic shared memory of one block, from the shapes alone (csrc/
    full_chain.cu fc_smem_layout): the mbarriers, the record ring, the
    warps' and blocks' argmax partials, the reduction partials, the
    admission and affinity flags; in the "smem" state also the quota copy
    (usage, runtime, ancestors) and the block's node slice: the carried
    rows (requested, two deltas, NUMA zones, bindable cpus, volume
    headroom, ports, affinity counts and covers), allocatable and the two
    terms, and the node flags. The terms instance's runner-up partials
    (per warp and per block) are in every layout; the round over a mesh of
    cards (``exchange``, ``n_nodes`` one shard's rows) adds its exchange
    mbarriers and results and the polling warp's staging area (the
    winner's pairs for each possible shard)."""
    plan = cluster_plan(n_nodes, cluster_size)
    nw, nb, Q = plan.node_threads // 32, plan.nodes_per_block, T + 2
    stride = record_layout(R, T, PT, VG)["rec_stride"]
    regions = [(RING_STAGES + 2) * 8, RING_STAGES * stride * 4, 2 * nw * 8,
               2 * cluster_size * 8, 2 * Q * nw * 4, (nw + 1) * Q * 4, 2 * 4,
               max(T, 1) * 4, 2 * nw * 4, 2 * cluster_size * 8]
    if exchange:
        xw = result_words(T)
        regions += [2 * 8, 2 * xw * 4,
                    MAX_SHARDS * exchange_pairs(payload_words(T)) * 4]
    if state == "smem":
        node_floats = (R + 2 * W + K * R + 2 + PT + 2 * T) + (R + 2 * W)
        regions += [G * R * 4, G * R * 4, G * D * 4, node_floats * nb * 4, nb]
    at = 0
    for nbytes in regions:
        _, at = smem_take(at, nbytes)
    return at


def state_for(fc, weight_idx, smem_budget_bytes=None,
              cluster_size: int = CLUSTER_SIZE, shards: int = 1,
              exchange: bool = False):
    """(state, plan, smem bytes per block) of a launch over ``fc``: the
    shared-memory state where its layout fits the budget, else device
    memory. ``shards``: the launch's clusters over a mesh of cards, each
    over N / shards rows; ``exchange``: the round's exchange regions.
    Reads shapes only, so it runs on any device."""
    d = _dims(fc)
    n_nodes = d["N"] // int(shards)
    shape = dict(n_nodes=n_nodes, R=d["R"], W=len(weight_idx), K=d["K"],
                 G=d["G"], D=d["D"], T=d["T"], PT=d["PT"], VG=d["VG"],
                 cluster_size=cluster_size, exchange=exchange)
    state = choose_state(estimate_smem_bytes(**shape), smem_budget_bytes)
    smem = estimate_smem_bytes(**shape, state=state)
    if smem > SMEM_BUDGET_BYTES:
        # the record ring alone outgrows a block: no state fits (a claim
        # world's volume view adds a word per node column to every record:
        # N on one device, the card's rows on a mesh of cards)
        stride = record_layout(d["R"], d["T"], d["PT"], d["VG"])["rec_stride"]
        raise KernelContractError(
            f"a pod record of {stride} words needs {smem} B of shared "
            f"memory per block, above the {SMEM_BUDGET_BYTES} B a block "
            "may take")
    return state, cluster_plan(n_nodes, cluster_size), smem


def _launch(fc, widx, prod_mode: bool, bal_idx, records, n_valid, flags,
            state, chosen, cluster_size: int, smem_budget_bytes, terms=None,
            xchg=None):
    """Check every tensor, fill FullChainParams and launch on the current
    stream of the tensors' card. ``state`` holds the carried tensors the
    kernel updates in place (requested, delta_np, delta_pr, numa,
    bind_free, vol_free, port_used, aff_count, anti_cover) and the
    read-only quota_init, aff_exists0, term_np and term_pr. ``terms``
    ([P, 5] f32, zeros) selects the terms instance, which fills it.
    ``xchg`` (a koord::Xchg) selects the instance over a mesh of cards: the
    launch's xchg.L shards as clusters, each over N / L rows, with the
    largest cluster size up to ``cluster_size`` at which the card holds
    all of them at once. Returns (quota_blocks, aff_exists_out)."""
    global last_launch
    # metadata only, but for the two allocations: the launch's shapes,
    # checks and pointers dispatch no op
    with metadata_only():
        inputs = fc.base
        if len(widx) > MAX_WEIGHTS:
            raise ValueError(f"at most {MAX_WEIGHTS} weighted axes")
        d = _dims(fc)
        P, N, R, K, G, D, T = (d[k] for k in "PNRKGDT")
        S, PT, SI, VG = d["S"], d["PT"], d["SI"], d["VG"]
        W = len(widx)
        shards = xchg.L if xchg is not None else 1
        if N % shards:
            raise ValueError(f"{N} rows do not split into {shards} shards")
        exchange = xchg is not None
        lay = record_layout(R, T, PT, VG)
        u8, f32, i32 = torch.uint8, torch.float32, torch.int32
        dev = launch_device(inputs.allocatable)
    quota_blocks = torch.empty((shards * cluster_size, G, R), dtype=f32,
                               device=dev)
    aff_exists_out = torch.zeros(T, dtype=u8, device=dev)
    with metadata_only():
        args = {
            "records": (records, i32, (P, lay["rec_stride"])),
            "n_valid": (n_valid, i32, (1,)),
            "alloc": (inputs.allocatable, f32, (N, R)),
            "term_np": (state["term_np"], f32, (N, W)),
            "term_pr": (state["term_pr"], f32, (N, W)),
            "node_flags": (flags, u8, (N,)),
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
            "quota_init": (state["quota_init"], f32, (G, R)),
            "aff_exists0": (state["aff_exists0"], u8, (T,)),
            "requested": (state["requested"], f32, (N, R)),
            "delta_np": (state["delta_np"], f32, (N, W)),
            "delta_pr": (state["delta_pr"], f32, (N, W)),
            "numa": (state["numa"], f32, (N, K, R)),
            "bind_free": (state["bind_free"], f32, (N,)),
            "vol_free": (state["vol_free"], f32, (N,)),
            "port_used": (state["port_used"], f32, (N, PT)),
            "aff_count": (state["aff_count"], f32, (N, T)),
            "anti_cover": (state["anti_cover"], f32, (N, T)),
            "quota_blocks": (quota_blocks, f32, (shards * cluster_size, G, R)),
            "chosen": (chosen, i32, (P,)),
            "aff_exists_out": (aff_exists_out, u8, (T,)),
            "terms": (terms, f32, (P, NUM_TERMS)),
        }
        params = _Params()
        for name in _PTR_FIELDS:
            t, dtype, shape = args[name]
            # a field the launch's mode does not use stays a null pointer
            setattr(params, name,
                    None if t is None else check_tensor(name, t, dtype, shape))
        if xchg is not None:
            params.x = xchg
        what = "terms round" if terms is not None else "round"
        if xchg is not None:
            what += f" over {shards} shard(s) of a mesh of cards"
        lib = _lib()
        # one device: the given cluster size; a mesh of cards: the largest
        # whose clusters the card holds together
        sizes_tried = ([cluster_size] if xchg is None else
                       [c for c in (16, 8, 4, 2, 1) if c <= cluster_size])
        with on_device(dev):
            for c_size in sizes_tried:
                kind, plan, smem_bytes = state_for(
                    fc, widx, smem_budget_bytes, c_size, shards, exchange)
                sizes = dict(d, ppref_stride=fc.ppref_w.shape[1],
                             prod_mode=int(bool(prod_mode)),
                             bal_c=int(bal_idx[0]), bal_m=int(bal_idx[1]),
                             n_widx=W, **lay, cluster_size=c_size,
                             nodes_per_block=plan.nodes_per_block,
                             node_threads=plan.node_threads,
                             state_in_smem=int(kind == "smem"))
                for name in _INT_FIELDS:
                    setattr(params, name, sizes[name])
                for j, r in enumerate(widx):
                    params.widx[j] = int(r)
                if xchg is None:
                    break
                held = lib.full_chain_max_clusters(ctypes.byref(params))
                if held < 0:
                    raise launch_error(f"full_chain {what}", -held,
                                       "the occupancy query")
                if held >= shards:
                    break
            else:
                raise KernelContractError(
                    f"full_chain {what}: the card holds fewer than {shards} "
                    f"clusters at every cluster size up to {cluster_size}")
            c_bytes = lib.full_chain_smem_bytes(ctypes.byref(params))
            if c_bytes != smem_bytes:
                raise KernelContractError(
                    f"estimate_smem_bytes says {smem_bytes} bytes, "
                    f"the kernel's layout {c_bytes}")
            # The temporaries above may be freed before the kernel ends: the
            # caching allocator hands their memory only to later work on this
            # same stream.
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.full_chain_launch(ctypes.byref(params),
                                        ctypes.c_void_p(stream))
        if err != 0:
            raise launch_error(f"full_chain {what}", err,
                               f"{shards} cluster(s) of {c_size} x "
                               f"{plan.block_threads} threads, {smem_bytes} B "
                               "of shared memory per block")
        instance = ("common" if lib.full_chain_instance(ctypes.byref(params))
                    else "generic")
        last_launch = {"state": kind, "instance": instance,
                       "cluster_size": c_size,
                       "block_threads": plan.block_threads,
                       "nodes_per_block": plan.nodes_per_block,
                       "smem_bytes_per_block": smem_bytes, "mode": what,
                       "shards": shards}
    return quota_blocks, aff_exists_out


def _require_cuda(fn: str, fc) -> None:
    if not fc.base.allocatable.is_cuda:
        raise ValueError(f"{fn} launches the CUDA kernel and takes CUDA "
                         f"tensors, got {fc.base.allocatable.device}")


def full_chain_round(fc, weight_idx, prod_mode: bool, bal_idx, *,
                     cluster_size: int = CLUSTER_SIZE,
                     smem_budget_bytes=None, terms: bool = False,
                     counts_n_real=None):
    """One round in the kernel: FullChainInputs (CUDA tensors) ->
    (chosen[P] int32 before Permit, requested[N, R], quota_used[G, R]),
    and with ``terms`` (the terms instance) a 4th item, the [P, 5] f32
    koordexplain terms rows (0 for pods outside pod_valid). Raises for
    tensors anywhere but on the card.

    With ``counts_n_real`` a last item, the [P, 11] uint32 stage counts
    at ``fc``'s own state over its first ``counts_n_real`` nodes (ops/
    explain_kernel.py): the pass reads the round's packed records and node
    flags and runs on a side stream beside the round (it depends on
    nothing the round writes), on the SMs the round's one cluster leaves
    idle; the current stream waits for it before this returns."""
    global launches, terms_launches
    _require_cuda("full_chain_round", fc)
    widx = list(weight_idx)
    records, n_valid, flags, state, chosen, rows = _round_buffers(
        fc, widx, terms)
    # the pass waits for the packing only: recorded before the round is
    # queued, so that the round's cluster takes its SMs first
    packed = (torch.cuda.current_stream(records.device).record_event()
              if counts_n_real is not None else None)
    quota_blocks, _exists = _launch(
        fc, widx, prod_mode, bal_idx, records, n_valid, flags, state, chosen,
        cluster_size, smem_budget_bytes, terms=rows)
    launches += 1
    beside = None
    if counts_n_real is not None:
        beside = _counts_beside(fc, records, flags, state["aff_exists0"],
                                counts_n_real, packed)
    out = (chosen, state["requested"], quota_blocks[0])
    if terms:
        terms_launches += 1
        out += (rows,)
    if beside is None:
        return out
    counts, side = beside
    torch.cuda.current_stream(counts.device).wait_stream(side)
    return out + (counts,)


def _counts_beside(fc, records, flags, aff_exists, n_real, packed):
    """Launch the stage-count pass over ``fc`` on the card's side stream,
    once the current stream has reached the event ``packed`` (the packing
    done): (counts, side stream). Every tensor it reads was made on the
    current stream, which waits for the side stream before any of them is
    freed; the counts are allocated there too."""
    from koordinator_tpu_torch.ops.explain_kernel import Pack, explain_counts

    dev = launch_device(fc.base.allocatable)
    side = torch.cuda.Stream(dev)  # one of the card's pooled streams
    counts = torch.empty((fc.base.fit_requests.shape[0], NUM_EXPLAIN_STAGES),
                         dtype=torch.uint32, device=dev)
    state = (fc.base.requested, fc.numa_free, fc.bind_free, fc.quota_used,
             fc.aff_count, fc.anti_cover, aff_exists, fc.port_used,
             fc.vol_free)
    side.wait_event(packed)
    with torch.cuda.stream(side):
        explain_counts(fc, state, n_real, pack=Pack(records, flags),
                       out=counts)
    return counts, side


def _round_buffers(fc, widx, terms: bool):
    """(records, n_valid, flags, state, chosen, rows) of a round over
    ``fc``: the packed records (valid pods first) and node flags, the
    kernel's carried state (the round's own copies, updated in place), the
    chosen vector (-1 preset) and the terms rows (zeros, None without
    ``terms``)."""
    inputs = fc.base
    P, N = inputs.fit_requests.shape[0], inputs.allocatable.shape[0]
    W = len(widx)
    f32, dev = torch.float32, inputs.allocatable.device
    pack = getattr(fc, "pack", None)
    if pack is not None:
        return _packed_buffers(fc, pack, widx, terms)
    records, n_valid, flags = round_pack(fc)
    # carried state: the round's own copies, updated in place by the kernel
    state = {
        "term_np": inputs.la_term_nonprod[:, widx].contiguous(),
        "term_pr": inputs.la_term_prod[:, widx].contiguous(),
        "quota_init": fc.quota_used.to(f32).contiguous(),
        "aff_exists0": fc.aff_exists.to(torch.uint8).contiguous(),
        "requested": inputs.requested.to(f32).clone(),
        "delta_np": torch.zeros((N, W), dtype=f32, device=dev),
        "delta_pr": torch.zeros((N, W), dtype=f32, device=dev),
        "numa": fc.numa_free.to(f32).clone(),
        "bind_free": fc.bind_free.to(f32).clone(),
        "vol_free": fc.vol_free.to(f32).clone(),
        "port_used": fc.port_used.to(f32).clone(),
        "aff_count": fc.aff_count.to(f32).clone(),
        "anti_cover": fc.anti_cover.to(f32).clone(),
    }
    chosen = torch.full((P,), -1, dtype=torch.int32, device=dev)
    rows = (torch.zeros((P, NUM_TERMS), dtype=f32, device=dev) if terms
            else None)
    return records, n_valid, flags, state, chosen, rows


def _packed_buffers(fc, pack, widx, terms: bool):
    """_round_buffers from an uploaded round's host pack (models/
    round_pack): the records, their count, the node flags and aff_exists
    as the upload moved them, and the carried state as views of one clone
    of the pack's flat base, the two LoadAware deltas from its zeros."""
    inputs = fc.base
    with metadata_only():
        P, R = inputs.fit_requests.shape
        N, K = fc.numa_free.shape[:2]
        T, PT = fc.aff_dom.shape[1], fc.port_used.shape[1]
        dev = inputs.allocatable.device
    W = len(widx)
    sizes = list(pack.carry_sizes)
    zeros = sizes.pop()
    carry = torch.split(pack.carry0.clone(),
                        sizes + [N * W, N * W, zeros - 2 * N * W])
    state = {
        "term_np": inputs.la_term_nonprod[:, widx],
        "term_pr": inputs.la_term_prod[:, widx],
        "quota_init": fc.quota_used,
        "aff_exists0": pack.aff_exists,
        "requested": carry[0].view(N, R),
        "numa": carry[1].view(N, K, R),
        "bind_free": carry[2],
        "vol_free": carry[3],
        "port_used": carry[4].view(N, PT),
        "aff_count": carry[5].view(N, T),
        "anti_cover": carry[6].view(N, T),
        "delta_np": carry[7].view(N, W),
        "delta_pr": carry[8].view(N, W),
    }
    chosen = torch.full((P,), -1, dtype=torch.int32, device=dev)
    rows = (torch.zeros((P, NUM_TERMS), dtype=torch.float32, device=dev)
            if terms else None)
    return pack.records, pack.n_valid, pack.node_flags, state, chosen, rows


# ---------------------------------------------------------------------------
# the kept-pod replay (csrc/replay_by_node.cu; its plain version is
# models/replay_by_node.py)
# ---------------------------------------------------------------------------

# csrc/replay_by_node.cu kListPerThread, kPodsPerThread, kNodeBits,
# kMaxAxes, kErr*
REPLAY_LIST_PER_THREAD, REPLAY_PODS_PER_THREAD, REPLAY_NODE_BITS = 16, 8, 9
REPLAY_MAX_AXES = 16
REPLAY_ERR_BOUND, REPLAY_ERR_DOMAIN = 1, 2
REPLAY_THREADS = (256, 128, 64, 32)  # node rows of a block, largest first
last_replay: dict = {}

_REPLAY_PTR_FIELDS = (
    "kept", "chosen", "fit_req", "req", "est", "is_prod", "needs_numa",
    "needs_bind", "cores", "quota_id", "match", "anti", "wants",
    "vol_needed", "dom_rows",
    "policy", "vol_group", "aff_dom", "anc",
    "requested", "est_sum", "est_pr", "numa", "bind_free", "vol_free",
    "port_used", "aff_count", "anti_cover", "quota", "exists",
    "o_requested", "o_est_sum", "o_est_pr", "o_numa", "o_bind_free",
    "o_vol_free", "o_port_used", "o_aff_count", "o_anti_cover", "o_quota",
    "o_exists", "zones", "scratch",
)
_REPLAY_INT_FIELDS = ("P", "N", "R", "K", "T", "PT", "VG", "G", "D",
                      "prod_mode", "ndom", "node_threads", "per", "L")


class _ReplayParams(ctypes.Structure):
    """Mirror of ReplayParams in csrc/replay_by_node.cu, field for field."""

    _fields_ = ([(f, _P) for f in _REPLAY_PTR_FIELDS]
                + [(f, ctypes.c_int) for f in _REPLAY_INT_FIELDS]
                + [("shard", ctypes.c_int * MAX_LOCAL_SHARDS)])


def _replay_lib():
    lib = load_library(REPLAY_SOURCE)
    if not getattr(lib, "_koord_bound", False):
        lib.replay_params_size.restype = ctypes.c_int
        lib.replay_smem_bytes.restype = ctypes.c_longlong
        lib.replay_smem_bytes.argtypes = [ctypes.POINTER(_ReplayParams)]
        lib.replay_instance.restype = ctypes.c_int
        lib.replay_instance.argtypes = [ctypes.POINTER(_ReplayParams)]
        lib.replay_launch.restype = ctypes.c_int
        lib.replay_launch.argtypes = [ctypes.POINTER(_ReplayParams),
                                      ctypes.c_void_p]
        size = lib.replay_params_size()
        if size != ctypes.sizeof(_ReplayParams):
            raise KernelContractError(
                f"ReplayParams layout mismatch: C {size} bytes, ctypes "
                f"{ctypes.sizeof(_ReplayParams)}")
        lib._koord_bound = True
    return lib


def replay_smem_bytes(node_threads: int, R: int, K: int, PT: int,
                      G: int) -> int:
    """Dynamic shared memory of one block of the replay's node kernel
    (csrc/replay_by_node.cu rp_smem_layout): the prefix scratch, then the
    larger of a node block's bucket list, its per-node segments and rows
    (requested, the two LoadAware sums, NUMA zones, bindable cpus, volume
    headroom, ports) and a quota block's multiplicities and staged
    requests."""
    nt = int(node_threads)
    _, at = smem_take(0, (nt // 32 + 1) * 4)
    role = at
    _, at = smem_take(at, REPLAY_LIST_PER_THREAD * nt * 4)  # the list
    _, at = smem_take(at, REPLAY_LIST_PER_THREAD * nt * 4)  # its segments
    _, node_end = smem_take(at, (3 * R + K * R + 2 + PT) * nt * 4)
    _, at = smem_take(role, max(G, 1) * 4)
    _, at = smem_take(at, max(R, 1) * REPLAY_PODS_PER_THREAD * nt * 4)
    return max(at, node_end)


def replay_threads(R: int, K: int, PT: int, G: int) -> int:
    """Node rows (and threads) of one replay block: the most of
    REPLAY_THREADS whose shared memory fits a block; raises where none
    does."""
    for nt in REPLAY_THREADS:
        if replay_smem_bytes(nt, R, K, PT, G) <= SMEM_BUDGET_BYTES:
            return nt
    raise KernelContractError(
        f"the replay's node rows (R={R}, K={K}, PT={PT}) and quota groups "
        f"(G={G}) need more than the {SMEM_BUDGET_BYTES} B of shared memory "
        f"a block may take at {REPLAY_THREADS[-1]} rows a block")


def _u8(t: torch.Tensor) -> torch.Tensor:
    """A bool (or 0/1) tensor as contiguous uint8, a view where it can be."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t.to(torch.uint8)


def _replay_launch(fc, chosen, kept, state, prod_mode: bool, shards, per: int,
                   ndom: int, dom_rows=None):
    """Check every tensor, fill ReplayParams and launch the replay over
    ``fc``'s rows (``shards``' rows side by side, ``per`` each) on the
    tensors' card. Returns (the state after the replay, the 11-tuple
    layout; zones[P])."""
    global last_replay
    inputs = fc.base
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    K, T = fc.numa_free.shape[1], fc.aff_dom.shape[1]
    PT, VG = fc.port_used.shape[1], fc.vol_needed.shape[1]
    G, D = fc.quota_ancestors.shape
    if P >= 1 << (31 - REPLAY_NODE_BITS):
        raise KernelContractError(f"the replay takes fewer than "
                                  f"{1 << (31 - REPLAY_NODE_BITS)} pods, "
                                  f"got {P}")
    if N < 1:
        raise KernelContractError("the replay takes at least one node row")
    if R > REPLAY_MAX_AXES:
        raise KernelContractError(f"the replay takes at most "
                                  f"{REPLAY_MAX_AXES} resource axes, got {R}")
    (requested, est_sum, est_pr, numa_free, bind_free, quota_used,
     aff_count, anti_cover, aff_exists, port_used, vol_free) = state
    dev = launch_device(inputs.allocatable, chosen, kept, dom_rows)
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8

    def f(t):
        return t.to(f32).contiguous()

    def new(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    out = {"o_requested": new(N, R), "o_est_sum": new(N, R),
           "o_est_pr": new(N, R), "o_numa": new(N, K, R),
           "o_bind_free": new(N), "o_vol_free": new(N),
           "o_port_used": new(N, PT), "o_aff_count": new(N, T),
           "o_anti_cover": new(N, T), "o_quota": new(G, R)}
    o_exists = torch.empty(T, dtype=torch.bool, device=dev)
    zones = torch.empty(P, dtype=i32, device=dev)
    scratch = torch.empty(2 * T * ndom + T + 1, dtype=i32, device=dev)
    args = {
        "kept": (_u8(kept), u8, (P,)),
        "chosen": (chosen.to(i32).contiguous(), i32, (P,)),
        "fit_req": (f(inputs.fit_requests), f32, (P, R)),
        "req": (f(fc.requests), f32, (P, R)),
        "est": (f(inputs.estimated), f32, (P, R)),
        "is_prod": (_u8(inputs.is_prod), u8, (P,)),
        "needs_numa": (_u8(fc.needs_numa), u8, (P,)),
        "needs_bind": (_u8(fc.needs_bind), u8, (P,)),
        "cores": (f(fc.cores_needed), f32, (P,)),
        "quota_id": (fc.quota_id.to(i32).contiguous(), i32, (P,)),
        "match": (_u8(fc.pod_aff_match), u8, (P, T)),
        "anti": (_u8(fc.pod_anti_req), u8, (P, T)),
        "wants": (_u8(fc.pod_port_wants), u8, (P, PT)),
        "vol_needed": (f(fc.vol_needed), f32, (P, VG)),
        "dom_rows": (None if dom_rows is None else f(dom_rows), f32, (P, T)),
        "policy": (fc.numa_policy.to(i32).contiguous(), i32, (N,)),
        "vol_group": (fc.node_vol_group.to(i32).contiguous(), i32, (N,)),
        "aff_dom": (f(fc.aff_dom), f32, (N, T)),
        "anc": (fc.quota_ancestors.to(i32).contiguous(), i32, (G, D)),
        "requested": (f(requested), f32, (N, R)),
        "est_sum": (f(est_sum), f32, (N, R)),
        "est_pr": (None if est_pr is None else f(est_pr), f32, (N, R)),
        "numa": (f(numa_free), f32, (N, K, R)),
        "bind_free": (f(bind_free), f32, (N,)),
        "vol_free": (f(vol_free), f32, (N,)),
        "port_used": (f(port_used), f32, (N, PT)),
        "aff_count": (f(aff_count), f32, (N, T)),
        "anti_cover": (f(anti_cover), f32, (N, T)),
        "quota": (f(quota_used), f32, (G, R)),
        "exists": (_u8(aff_exists), u8, (T,)),
        **{k: (v, f32, tuple(v.shape)) for k, v in out.items()},
        "o_exists": (o_exists, torch.bool, (T,)),
        "zones": (zones, i32, (P,)),
        "scratch": (scratch, i32, tuple(scratch.shape)),
    }
    params = _ReplayParams()
    for name in _REPLAY_PTR_FIELDS:
        t, dtype, shape = args[name]
        setattr(params, name,
                None if t is None else check_tensor(name, t, dtype, shape))
    nt = replay_threads(R, K, PT, G)
    sizes = dict(P=P, N=N, R=R, K=K, T=T, PT=PT, VG=VG, G=G, D=D,
                 prod_mode=int(bool(prod_mode)), ndom=int(ndom),
                 node_threads=nt, per=int(per), L=len(shards))
    for name in _REPLAY_INT_FIELDS:
        setattr(params, name, sizes[name])
    if not 1 <= len(shards) <= MAX_LOCAL_SHARDS:
        raise ValueError(f"a launch runs 1..{MAX_LOCAL_SHARDS} shards, "
                         f"got {len(shards)}")
    for j, k in enumerate(shards):
        params.shard[j] = int(k)
    smem = replay_smem_bytes(nt, R, K, PT, G)
    lib = _replay_lib()
    with on_device(dev):
        c_bytes = lib.replay_smem_bytes(ctypes.byref(params))
        if c_bytes != smem:
            raise KernelContractError(
                f"replay_smem_bytes says {smem} bytes, the kernel's layout "
                f"{c_bytes}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.replay_launch(ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise launch_error("replay", err,
                           f"{-(-N // nt)} node blocks and {G} quota blocks "
                           f"of {nt} threads, {smem} B of shared memory per "
                           "block")
    instance = ("common" if lib.replay_instance(ctypes.byref(params))
                else "generic")
    last_replay = {"instance": instance, "node_threads": nt,
                   "node_blocks": -(-N // nt),
                   "quota_blocks": G, "smem_bytes_per_block": smem,
                   "shards": len(shards), "errors": scratch[-1:]}
    state_out = (out["o_requested"], out["o_est_sum"], out["o_est_pr"],
                 out["o_numa"], out["o_bind_free"], out["o_quota"],
                 out["o_aff_count"], out["o_anti_cover"], o_exists,
                 out["o_port_used"], out["o_vol_free"])
    return state_out, zones


def replay_errors(launch=None) -> int:
    """The error bits of a replay launch (``last_replay`` when None; a
    sync): REPLAY_ERR_BOUND where a count passed the exact range and the
    kernel added its ones one by one (the outputs stay exact),
    REPLAY_ERR_DOMAIN where a kept pod's domain id was not a dense id below
    the mesh's node count, against the encoder's contract: that pod was
    counted in no domain."""
    launch = last_replay if launch is None else launch
    return int(launch["errors"].item()) & 0xFFFFFFFF


def full_chain_replay(fc_carry, chosen, kept, state, prod_mode: bool):
    """The fused waves' kept-only replay in the node-parallel kernel.

    ``fc_carry`` is the dispatch's FullChainInputs with reservation rows in
    their carry form (models/fused_waves._carry_fc_variants), ``chosen``
    [P] int32 pass 1's node per pod, ``kept`` [P] bool the pods that
    survived Permit, and ``state`` the wave-start 11-tuple (requested,
    est_sum, est_sum_prod or None, numa_free, bind_free, quota_used,
    aff_count, anti_cover, aff_exists, port_used, vol_free), all CUDA
    tensors, none of them modified. The kernel reads the per-pod fields of
    ``fc_carry`` as they are (no records are packed) and finds the kept
    pods itself: nothing waits for the card.

    Returns (the state after committing every kept pod, each node's in
    queue order, in the same layout with est_sum_prod zeros outside prod
    mode; zones[P] int32, the zone re-picked per kept pod, -1 elsewhere),
    new tensors equal, bit for bit, to the plain ``replay_kept``'s and
    ``replay_by_node``'s. The LoadAware sums are carried on every resource
    axis (the weights' axes being only what the round scores). Raises for
    tensors anywhere but on the card."""
    global replay_launches
    _require_cuda("full_chain_replay", fc_carry)
    N = fc_carry.base.allocatable.shape[0]
    out = _replay_launch(fc_carry, chosen, kept, state, prod_mode, [0], N, N)
    replay_launches += 1
    return out


# ---------------------------------------------------------------------------
# the instances over a mesh of cards
# ---------------------------------------------------------------------------

def enable_peer_access(cards) -> None:
    """Peer access on between every ordered pair of ``cards`` (CUDA
    devices), so that each card's kernels reach every other card's
    mailboxes. The caller has checked torch.cuda.can_device_access_peer
    (parallel/mesh.Mesh.check_peer_access); a refusal here raises."""
    lib = _lib()
    for a in cards:
        for b in cards:
            if a == b:
                continue
            with on_device(a):
                err = lib.koord_enable_peer(int(b.index))
            if err != 0:
                raise launch_error(
                    f"peer access from {a} to {b}", err,
                    "cudaDeviceEnablePeerAccess")


def full_chain_round_cards(cards, weight_idx, prod_mode: bool, bal_idx,
                           box: Mailboxes, *, terms: bool = False,
                           smem_budget_bytes=None):
    """One round over a mesh of cards in the exchange instance.

    ``cards``: [(fc, shards)] per card, ``fc`` the card's FullChainInputs
    (its shards' node rows side by side in shard order, each shard ``per``
    rows; the pod fields, alike on every card, but for a hot-claim world's
    volume view, which is the card's own [P, rows] columns with one group
    per row), ``shards`` their indices in the mesh; ``box`` the mesh's
    Mailboxes. Every card's launch is
    queued before any is waited on; then each card's error word is read,
    and a shard whose entries never arrived raises ExchangeTimeout.
    Returns, per card, what full_chain_round returns for that card's rows:
    (chosen[P] with global node indices, requested of its rows, quota_used
    [, terms rows])."""
    global xchg_launches, xchg_terms_launches
    widx = list(weight_idx)
    T = cards[0][0].aff_dom.shape[1]
    P = cards[0][0].base.fit_requests.shape[0]
    lib = _lib()
    if lib.full_chain_payload_words(T) != payload_words(T):
        raise KernelContractError("the mailbox payload layout disagrees "
                                  "with the kernel's")
    box.ensure(payload_words(T))
    ready = []
    for fc, shards in cards:
        _require_cuda("full_chain_round_cards", fc)
        dev = launch_device(fc.base.allocatable)
        with on_device(dev):
            ready.append((fc, shards, dev, _round_buffers(fc, widx, terms)))
    # two exchanges per pod at most: the stats and the winner
    flag0 = box.begin(2 * P)
    per = cards[0][0].base.allocatable.shape[0] // len(cards[0][1])
    out = []
    for fc, shards, dev, (records, n_valid, flags, state, chosen,
                          rows) in ready:
        quota_blocks, _exists = _launch(
            fc, widx, prod_mode, bal_idx, records, n_valid, flags, state,
            chosen, CLUSTER_SIZE, smem_budget_bytes, terms=rows,
            xchg=box.xchg(dev, shards, per, flag0))
        item = (chosen, state["requested"], quota_blocks[0])
        out.append(item + ((rows,) if terms else ()))
        xchg_launches += 1
        if terms:
            xchg_terms_launches += 1
    box.check("full_chain round over a mesh of cards")
    return out


def full_chain_replay_cards(cards, prod_mode: bool, n_shards: int):
    """The kept-only replay over a mesh of cards: each card replays the
    kept pods onto its own rows in the node-parallel kernel, with no
    exchange.

    ``cards``: [(fc_carry, shards, chosen, kept, state, dom_rows)] per
    card, all on that card: the card's FullChainInputs in carry form (its
    shards' rows side by side), their shard indices, pass 1's global node
    per pod, the kept mask, the card's wave-start 11-tuple (as
    full_chain_replay's) and the [P, T] aff_dom rows of each kept pod's
    chosen node, gathered from the owners. Returns, per card, (state',
    zones[P]) with the zone of each kept pod whose node the card holds, -1
    elsewhere."""
    global xchg_replay_launches
    out = []
    for fc, shards, chosen, kept, state, dom_rows in cards:
        _require_cuda("full_chain_replay_cards", fc)
        per = fc.base.allocatable.shape[0] // len(shards)
        out.append(_replay_launch(fc, chosen, kept, state, prod_mode, shards,
                                  per, n_shards * per, dom_rows=dom_rows))
        xchg_replay_launches += 1
    return out


def build_cuda_full_chain_step(args: LoadAwareArgs, num_gangs: int,
                               num_groups: int, active_axes=None,
                               smem_budget_bytes=None, explain=None):
    """FullChainInputs (CUDA tensors) -> (chosen[P], requested[N, R],
    quota_used[G, R]): the kernel's round, then the gang Permit barrier.
    Same contract as models.full_chain.build_full_chain_step.
    ``step.last_state`` is the state the last round kept ("smem" or
    "global"). With a ``timings`` dict the step synchronises after the
    round (wrapper and kernel) and after Permit and records their
    seconds.

    ``explain`` ("counts" | "full"): the step takes the extra ``n_real``
    and returns ExplainOut as a 4th output — the stage counts at the
    cycle-start state from the CUDA pass of ops/explain_kernel.py, run on
    the round's packed records beside the round (full_chain_round's
    ``counts_n_real``, inside its ``round`` lap), and at "full" the terms
    instance's rows."""
    weight_idx = resolve_weight_idx(args, active_axes)
    bal_idx = resolve_balance_idx(active_axes)
    prod_mode = args.score_according_prod_usage
    full = explain == "full"

    def run(fc, n_real, timings):
        clock = SyncClock(timings, fc.base.allocatable.device)
        out = full_chain_round(
            fc, weight_idx, prod_mode, bal_idx,
            smem_budget_bytes=smem_budget_bytes, terms=full,
            counts_n_real=n_real)
        chosen, requested, quota_used = out[:3]
        step.last_state = last_launch["state"]
        clock.lap("round")
        chosen = permit(fc, chosen, num_gangs, num_groups)
        clock.lap("permit")
        if explain is None:
            return chosen, requested, quota_used
        return (chosen, requested, quota_used,
                ExplainOut(out[-1], out[3] if full else None))

    if explain is None:
        def step(fc, timings=None):
            return run(fc, None, timings)
    else:
        def step(fc, n_real, timings=None):
            return run(fc, n_real, timings)

    step.last_backend = "cuda"
    step.last_state = None
    return step

