"""Wrapper of the LoadAware-only round's CUDA kernel (csrc/schedule_step.cu).

Replaces the TPU kernel of koordinator_tpu/ops/pallas_step.py. The wrapper
computes the LoadAware reject rows in plain torch (as the Pallas wrapper
computes them outside its kernel) and folds them with the other node flags
into one byte per node, hands the node arrays to the kernel axis-major
([axis, N]) with the LoadAware terms and deltas cut to the weighted axes,
packs each pod into one record (flags, the axes it requests, its requests
and estimates; valid pods first), checks every tensor, and launches one
thread-block cluster on the current stream (csrc/kernel_common.cuh, "The
cluster design"). `requested` comes back in the JAX layout, [N, R].

`estimate_smem_bytes` is the counterpart of the TPU kernel's
`estimate_vmem_bytes`: the shared memory one block takes, from the shapes
alone; past the budget the same kernel keeps its carried state in device
memory (`last_launch["state"]`).

`schedule_round_cards` launches the exchange instance over a mesh of
cards (csrc/kernel_common.cuh, "The exchange"): each card's launch runs its
shards as clusters over its own rows, the per-pod winners exchanged through
the mesh's mailboxes (ops/kernel_common.Mailboxes).

`launches` counts the kernel's launches and `xchg_launches` the exchange
instance's (one per card), so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch.models.scheduler_model import node_rejects
from koordinator_tpu_torch.ops.kernel_common import (
    CLUSTER_SIZE,
    NODE_OK,
    NODE_REJECT_NP,
    NODE_REJECT_PR,
    NODE_SCORE_VALID,
    POD_DS,
    POD_PROD,
    POD_VALID,
    REC_FLAGS,
    REC_POD,
    RING_STAGES,
    KernelContractError,
    Mailboxes,
    _Xchg,
    check_tensor,
    choose_state,
    cluster_plan,
    f32_words,
    launch_device,
    launch_error,
    load_library,
    on_device,
    smem_take,
    valid_first,
    words_f32,
)

SOURCE = "schedule_step.cu"
MAX_AXES = 16
MAX_WEIGHTS = 16
REC_AXES = 2  # 4 words: the axes a pod requests, one byte each
REC_HEADER = REC_AXES + MAX_AXES // 4

launches = 0
xchg_launches = 0
last_launch: dict = {}
PAYLOAD_WORDS = 2  # an exchange entry: score, global index
RESULT_WORDS = 4   # a merged result: status, global index, score, spare

_P = ctypes.c_void_p
_PTR_FIELDS = (
    "records", "n_valid",
    "alloc", "term_np", "term_pr", "node_flags", "weights",
    "requested", "delta_np", "delta_pr", "chosen",
)
_INT_FIELDS = (
    "P", "N", "R", "prod_mode", "n_widx",
    "rec_stride", "off_fit", "off_est",
    "cluster_size", "nodes_per_block", "node_threads", "state_in_smem",
)


class _Params(ctypes.Structure):
    """Mirror of ScheduleStepParams in csrc/schedule_step.cu, field for
    field."""

    _fields_ = ([(f, _P) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int) for f in _INT_FIELDS]
                + [("widx", ctypes.c_int * MAX_WEIGHTS), ("x", _Xchg)])


def _lib():
    lib = load_library(SOURCE)
    if not getattr(lib, "_koord_bound", False):
        lib.schedule_step_params_size.restype = ctypes.c_int
        lib.schedule_step_smem_bytes.restype = ctypes.c_longlong
        lib.schedule_step_smem_bytes.argtypes = [ctypes.POINTER(_Params)]
        lib.schedule_step_instance.restype = ctypes.c_int
        lib.schedule_step_instance.argtypes = [ctypes.POINTER(_Params)]
        lib.schedule_step_launch.restype = ctypes.c_int
        lib.schedule_step_launch.argtypes = [ctypes.POINTER(_Params),
                                             ctypes.c_void_p]
        lib.schedule_step_max_clusters.restype = ctypes.c_int
        lib.schedule_step_max_clusters.argtypes = [ctypes.POINTER(_Params)]
        lib.schedule_step_payload_words.restype = ctypes.c_int
        size = lib.schedule_step_params_size()
        if size != ctypes.sizeof(_Params):
            raise KernelContractError(
                f"ScheduleStepParams layout mismatch: C {size} bytes, "
                f"ctypes {ctypes.sizeof(_Params)}")
        lib._koord_bound = True
    return lib


def record_layout(R: int) -> dict:
    """Word offsets of one pod's record: flags with the number of requested
    axes in bits 8.., the queue index, the requested axes (one byte each,
    ascending), then fit requests and estimates [R]; a multiple of 4
    words."""
    off_fit = REC_HEADER
    off_est = off_fit + R
    return {"off_fit": off_fit, "off_est": off_est,
            "rec_stride": 4 * -(-(off_est + R) // 4)}


def pack_records(inputs) -> torch.Tensor:
    """[P, rec_stride] int32: every per-pod input of the round, one record
    per pod in queue order (record_layout), on the inputs' device."""
    P, R = inputs.fit_requests.shape
    if R > MAX_AXES:
        raise ValueError(f"at most {MAX_AXES} axes")
    lay = record_layout(R)
    dev = inputs.fit_requests.device
    i32 = torch.int32
    # Fit skips the axes the pod does not request
    wants = inputs.fit_requests > 0
    nfit = wants.to(i32).sum(dim=1)
    # the requested axes first, ascending; the rest after them
    axes = torch.argsort((~wants).to(torch.int8), dim=1, stable=True)
    axes = torch.cat([axes, torch.zeros((P, MAX_AXES - R), dtype=axes.dtype,
                                        device=dev)], dim=1)
    axes = torch.where(torch.arange(MAX_AXES, device=dev) < nfit[:, None],
                       axes, 0).to(torch.int64)
    shifts = 8 * torch.arange(4, dtype=torch.int64, device=dev)
    words = (axes.view(P, MAX_AXES // 4, 4) << shifts).sum(dim=2)
    words = torch.where(words >= 2**31, words - 2**32, words).to(i32)
    flags = torch.zeros(P, dtype=i32, device=dev)
    for bit, col in ((POD_PROD, inputs.is_prod),
                     (POD_DS, inputs.is_daemonset),
                     (POD_VALID, inputs.pod_valid)):
        flags |= col.to(torch.bool).to(i32) * bit
    rec = torch.zeros((P, lay["rec_stride"]), dtype=i32, device=dev)
    rec[:, REC_FLAGS] = flags | (nfit << 8)
    rec[:, REC_POD] = torch.arange(P, dtype=i32, device=dev)
    rec[:, REC_AXES:REC_HEADER] = words
    rec[:, lay["off_fit"]:lay["off_fit"] + R] = f32_words(inputs.fit_requests)
    rec[:, lay["off_est"]:lay["off_est"] + R] = f32_words(inputs.estimated)
    return rec


def unpack_records(rec: torch.Tensor, R: int) -> dict:
    """Inverse of pack_records: the per-pod ScheduleInputs fields by name,
    ``pod`` (queue index) and ``fit_axes`` ([P, R] bool, the axes the
    record lists for the Fit)."""
    lay = record_layout(R)
    flags = rec[:, REC_FLAGS]
    nfit = flags >> 8
    words = rec[:, REC_AXES:REC_HEADER].to(torch.int64) & 0xFFFFFFFF
    shifts = 8 * torch.arange(4, dtype=torch.int64, device=rec.device)
    axes = ((words[:, :, None] >> shifts) & 0xFF).reshape(rec.shape[0], -1)
    listed = torch.arange(MAX_AXES, device=rec.device) < nfit[:, None]
    fit_axes = torch.zeros((rec.shape[0], R), dtype=torch.bool,
                           device=rec.device)
    for k in range(MAX_AXES):
        on = listed[:, k]
        fit_axes[on, axes[on, k]] = True
    return {
        "is_prod": (flags & POD_PROD) != 0,
        "is_daemonset": (flags & POD_DS) != 0,
        "pod_valid": (flags & POD_VALID) != 0,
        "pod": rec[:, REC_POD],
        "fit_axes": fit_axes,
        "fit_requests": words_f32(rec[:, lay["off_fit"]:lay["off_fit"] + R]),
        "estimated": words_f32(rec[:, lay["off_est"]:lay["off_est"] + R]),
    }


def node_flags(inputs, reject_np, reject_pr) -> torch.Tensor:
    """[N] uint8: the node flag bits the kernel tests (NODE_*)."""
    flags = torch.zeros(inputs.node_ok.shape[0], dtype=torch.int32,
                        device=inputs.node_ok.device)
    for bit, col in ((NODE_OK, inputs.node_ok),
                     (NODE_SCORE_VALID, inputs.la_score_valid),
                     (NODE_REJECT_NP, reject_np), (NODE_REJECT_PR, reject_pr)):
        flags |= col.to(torch.bool).to(torch.int32) * bit
    return flags.to(torch.uint8)


def estimate_smem_bytes(n_nodes: int, R: int, W: int,
                        cluster_size: int = CLUSTER_SIZE,
                        state: str = "smem", exchange: bool = False) -> int:
    """Dynamic shared memory of one block, from the shapes alone (csrc/
    schedule_step.cu ss_smem_layout): the mbarriers, the record ring, the
    warps' and blocks' argmax partials; over a mesh of cards
    (``exchange``, ``n_nodes`` one shard's rows) the exchange's mbarriers
    and results; in the "smem" state also the block's node slice of
    requested, the two deltas, allocatable, the two terms and the
    flags."""
    plan = cluster_plan(n_nodes, cluster_size)
    nw, nb = plan.node_threads // 32, plan.nodes_per_block
    regions = [(RING_STAGES + 2) * 8,
               RING_STAGES * record_layout(R)["rec_stride"] * 4, 2 * nw * 8,
               2 * cluster_size * 8]
    if exchange:
        regions += [2 * 8, 2 * RESULT_WORDS * 4, RESULT_WORDS * 4]
    if state == "smem":
        regions += [(2 * R + 4 * W) * nb * 4, nb]
    at = 0
    for nbytes in regions:
        _, at = smem_take(at, nbytes)
    return at


def state_for(inputs, weight_idx, smem_budget_bytes=None,
              cluster_size: int = CLUSTER_SIZE, shards: int = 1,
              exchange: bool = False):
    """(state, plan, smem bytes per block) of a launch over ``inputs``
    (``exchange``: the exchange instance, its ``shards`` clusters each over
    N / shards rows). Reads shapes only, so it runs on any device."""
    N, R = inputs.allocatable.shape
    n = N // int(shards)
    shape = dict(n_nodes=n, R=R, W=len(weight_idx), cluster_size=cluster_size,
                 exchange=exchange)
    state = choose_state(estimate_smem_bytes(**shape), smem_budget_bytes)
    return (state, cluster_plan(n, cluster_size),
            estimate_smem_bytes(**shape, state=state))


def schedule_round(inputs, weight_idx, prod_mode: bool, *,
                   cluster_size: int = CLUSTER_SIZE, smem_budget_bytes=None):
    """One round in the kernel: ScheduleInputs (CUDA tensors) ->
    (chosen[P] int32, requested[N, R] f32). Raises for tensors anywhere but
    on the card."""
    global launches
    if not inputs.allocatable.is_cuda:
        raise ValueError("schedule_round launches the CUDA kernel and takes "
                         f"CUDA tensors, got {inputs.allocatable.device}")
    buf = _buffers(inputs, weight_idx)
    _launch(inputs, weight_idx, prod_mode, buf, cluster_size,
            smem_budget_bytes)
    launches += 1
    return buf["chosen"][0], buf["requested"][0].t().contiguous()


def schedule_round_cards(cards, weight_idx, prod_mode: bool, box: Mailboxes,
                         *, smem_budget_bytes=None):
    """One round over a mesh of cards in the exchange instance:
    ``cards`` [(inputs, shards)] per card, ``inputs`` the card's
    ScheduleInputs (its shards' node rows side by side in shard order; the
    pod fields), ``shards`` their mesh indices; ``box`` the mesh's
    Mailboxes. Every card's launch is queued before any is waited on;
    then a shard whose entries never arrived raises ExchangeTimeout.
    Returns, per card, (chosen[P] with global node indices, requested of
    its rows [n, R])."""
    global xchg_launches
    for inputs, _shards in cards:
        if not inputs.allocatable.is_cuda:
            raise ValueError("schedule_round_cards takes CUDA tensors, got "
                             f"{inputs.allocatable.device}")
    if _lib().schedule_step_payload_words() != PAYLOAD_WORDS:
        raise KernelContractError("the mailbox payload layout disagrees "
                                  "with the kernel's")
    box.ensure(PAYLOAD_WORDS)
    ready = []
    for inputs, shards in cards:
        dev = launch_device(inputs.allocatable)
        with on_device(dev):
            ready.append((inputs, shards, dev,
                          _buffers(inputs, weight_idx)))
    seq0 = box.begin(cards[0][0].fit_requests.shape[0])
    per = cards[0][0].allocatable.shape[0] // len(cards[0][1])
    for inputs, shards, dev, buf in ready:
        _launch(inputs, weight_idx, prod_mode, buf, CLUSTER_SIZE,
                smem_budget_bytes, xchg=box.xchg(dev, shards, per, seq0))
        xchg_launches += 1
    box.check("schedule_step round over a mesh of cards")
    return [(buf["chosen"][0], buf["requested"][0].t().contiguous())
            for _inputs, _shards, _dev, buf in ready]


def _buffers(inputs, weight_idx) -> dict:
    """name -> (tensor, dtype, shape) of a launch over ``inputs``: the
    packed records (valid pods first), the axis-major node arrays and the
    carried state (the round's own copies, updated in place)."""
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    W = len(weight_idx)
    if R > MAX_AXES or W > MAX_WEIGHTS:
        raise ValueError(f"at most {MAX_AXES} axes and {MAX_WEIGHTS} "
                         "weighted axes")
    lay = record_layout(R)
    reject_np, reject_pr = node_rejects(inputs)
    u8, f32, i32 = torch.uint8, torch.float32, torch.int32
    dev = inputs.allocatable.device
    widx = list(weight_idx)
    records, n_valid = valid_first(pack_records(inputs), inputs.pod_valid)

    def axis_major(t):  # [N, k] -> [k, N]
        return t.to(f32).t().contiguous()

    return {
        "records": (records, i32, (P, lay["rec_stride"])),
        "n_valid": (n_valid, i32, (1,)),
        "alloc": (axis_major(inputs.allocatable), f32, (R, N)),
        "term_np": (axis_major(inputs.la_term_nonprod[:, widx]), f32, (W, N)),
        "term_pr": (axis_major(inputs.la_term_prod[:, widx]), f32, (W, N)),
        "node_flags": (node_flags(inputs, reject_np, reject_pr), u8, (N,)),
        "weights": (inputs.weights, f32, (R,)),
        "requested": (axis_major(inputs.requested), f32, (R, N)),
        "delta_np": (torch.zeros((W, N), dtype=f32, device=dev), f32, (W, N)),
        "delta_pr": (torch.zeros((W, N), dtype=f32, device=dev), f32, (W, N)),
        "chosen": (torch.full((P,), -1, dtype=i32, device=dev), i32, (P,)),
    }


def _launch(inputs, weight_idx, prod_mode: bool, args: dict,
            cluster_size: int, smem_budget_bytes, xchg=None) -> None:
    """Check every tensor of ``args`` (_buffers), fill ScheduleStepParams
    and launch on the current stream of the tensors' card; ``xchg`` (a
    koord::Xchg) selects the exchange instance, its xchg.L shards as
    clusters at the largest cluster size up to ``cluster_size`` whose
    clusters the card holds together."""
    global last_launch
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    W = len(weight_idx)
    shards = xchg.L if xchg is not None else 1
    if N % shards:
        raise ValueError(f"{N} rows do not split into {shards} shards")
    lay = record_layout(R)
    dev = launch_device(inputs.allocatable)
    params = _Params()
    for name in _PTR_FIELDS:
        t, dtype, shape = args[name]
        setattr(params, name, check_tensor(name, t, dtype, shape))
    if xchg is not None:
        params.x = xchg
    for j, r in enumerate(weight_idx):
        params.widx[j] = int(r)
    what = ("schedule_step kernel" if xchg is None else
            f"schedule_step kernel over {shards} shard(s) of a mesh of cards")
    lib = _lib()
    sizes_tried = ([cluster_size] if xchg is None else
                   [c for c in (16, 8, 4, 2, 1) if c <= cluster_size])
    with on_device(dev):
        for c_size in sizes_tried:
            state, plan, smem_bytes = state_for(
                inputs, weight_idx, smem_budget_bytes, c_size, shards,
                exchange=xchg is not None)
            sizes = dict(P=P, N=N, R=R, prod_mode=int(bool(prod_mode)),
                         n_widx=W, **lay, cluster_size=c_size,
                         nodes_per_block=plan.nodes_per_block,
                         node_threads=plan.node_threads,
                         state_in_smem=int(state == "smem"))
            for name in _INT_FIELDS:
                setattr(params, name, sizes[name])
            if xchg is None:
                break
            held = lib.schedule_step_max_clusters(ctypes.byref(params))
            if held < 0:
                raise launch_error(what, -held, "the occupancy query")
            if held >= shards:
                break
        else:
            raise KernelContractError(
                f"{what}: the card holds fewer than {shards} clusters at "
                f"every cluster size up to {cluster_size}")
        c_bytes = lib.schedule_step_smem_bytes(ctypes.byref(params))
        if c_bytes != smem_bytes:
            raise KernelContractError(
                f"estimate_smem_bytes says {smem_bytes} bytes, "
                f"the kernel's layout {c_bytes}")
        # The temporaries of _buffers may be freed before the kernel ends:
        # the caching allocator hands their memory only to later work on
        # this same stream.
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.schedule_step_launch(ctypes.byref(params),
                                       ctypes.c_void_p(stream))
    if err != 0:
        raise launch_error(what, err,
                           f"{shards} cluster(s) of {c_size} x "
                           f"{plan.block_threads} threads, {smem_bytes} B "
                           "of shared memory per block")
    instance = ("common" if lib.schedule_step_instance(ctypes.byref(params))
                else "generic")
    last_launch = {"state": state, "instance": instance,
                   "cluster_size": c_size,
                   "block_threads": plan.block_threads,
                   "nodes_per_block": plan.nodes_per_block,
                   "smem_bytes_per_block": smem_bytes, "shards": shards}
