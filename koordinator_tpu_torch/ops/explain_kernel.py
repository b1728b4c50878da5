"""Wrapper of koordexplain's stage-count pass (csrc/explain_counts.cu).

Replaces the jax.vmap of explain_stage_counts in the JAX package's
models/full_chain.py (and its per-wave call in models/fused_waves.py), which
XLA runs there: for every pod and every real node, the round's Filter chain
at a frozen state, counted per stage, plus the pod's gang and quota
verdicts, as [P, 11] uint32.

``explain_counts`` packs the pod records as the full-chain round does
(ops/full_chain_kernel.pack_records, in queue order, every pod row) and the
node flag bytes, checks every tensor and launches one block per pod on the
current stream. For tensors on the CPU it returns the plain version,
models/full_chain.explain_stage_counts; for CUDA tensors it launches the
kernel or raises. ``launches`` counts the launches.

``explain_counts_shards`` is the pass over a mesh of cards: each shard's
rows counted on its own card, against the spread minima over every shard
(a first launch per shard writes its minima, the wrapper takes their
minimum), the integer counts summed over the shards. ``shard_launches``
counts its launches (two per shard where the pods have spread terms).
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch.models.full_chain import (
    NUM_EXPLAIN_STAGES,
    explain_stage_counts,
    pod_independent_rows,
)
from koordinator_tpu_torch.ops.kernel_common import (
    KernelContractError,
    check_tensor,
    launch_device,
    launch_error,
    load_library,
    on_device,
)

SOURCE = "explain_counts.cu"
THREADS = 256  # csrc/explain_counts.cu kThreads
DEFAULT_SMEM_BYTES = 48 * 1024  # a launch without the opt-in attribute

launches = 0
shard_launches = 0
last_launch: dict = {}

_P = ctypes.c_void_p
_PTR_FIELDS = (
    "records", "alloc", "requested", "node_flags", "cpc", "policy",
    "taint_group", "vol_group", "aff_dom", "numa", "bind_free", "vol_free",
    "port_used", "aff_count", "anti_cover", "aff_exists", "anc", "runtime",
    "quota_used", "counts", "spread_in", "spread_out",
)
_INT_FIELDS = (
    "P", "N", "R", "K", "G", "D", "T", "PT", "n_real",
    "rec_stride", "off_fit", "off_req", "off_est", "off_aff", "off_anti",
    "off_match", "off_skew", "off_ports", "off_vol",
)


class _Params(ctypes.Structure):
    """Mirror of ExplainParams in csrc/explain_counts.cu, field for field."""

    _fields_ = ([(f, _P) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int) for f in _INT_FIELDS])


def _lib():
    lib = load_library(SOURCE)
    if not getattr(lib, "_koord_bound", False):
        lib.explain_params_size.restype = ctypes.c_int
        lib.explain_instance.restype = ctypes.c_int
        lib.explain_instance.argtypes = [ctypes.POINTER(_Params)]
        lib.explain_launch.restype = ctypes.c_int
        lib.explain_launch.argtypes = [ctypes.POINTER(_Params),
                                       ctypes.c_void_p]
        size = lib.explain_params_size()
        if size != ctypes.sizeof(_Params):
            raise KernelContractError(
                f"ExplainParams layout mismatch: C {size} bytes, "
                f"ctypes {ctypes.sizeof(_Params)}")
        lib._koord_bound = True
    return lib


def smem_bytes(T: int) -> int:
    """Dynamic shared memory of one block (csrc/explain_counts.cu
    explain_smem_bytes): the exists flags, the spread minima and the
    warps' partial minima per term, the stage counters."""
    return (2 + THREADS // 32) * max(T, 1) * 4 + 16 * 4


def explain_counts(fc, filter_state, n_real) -> torch.Tensor:
    """[P, NUM_EXPLAIN_STAGES] uint32 stage counts of every pod of ``fc``
    at the frozen ``filter_state`` (models/full_chain.explain_stage_counts'
    9-tuple) over the first ``n_real`` nodes: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    global launches
    if not fc.base.allocatable.is_cuda:
        return explain_stage_counts(fc, filter_state, n_real)
    out = _launch(fc, filter_state, int(n_real))
    launches += 1
    return out


def explain_counts_shards(shards, n_real) -> torch.Tensor:
    """The stage counts over a mesh of cards: ``shards`` [(fc, filter_state,
    first)] per shard, each on its card (the shard's rows and the pod
    fields; ``first`` its first global row), ``n_real`` the mesh's real
    nodes. Each shard counts its own real rows against the spread minima
    over every shard; the node stages' counts are summed over the shards
    (integers: exact), the gang and quota verdicts taken from the first.
    Returns [P, NUM_EXPLAIN_STAGES] uint32 on the first shard's card."""
    global shard_launches
    from koordinator_tpu_torch.models.full_chain import EXPLAIN_STAGE_GANG

    fc0 = shards[0][0]
    dev0 = launch_device(fc0.base.allocatable)
    P, T = fc0.base.fit_requests.shape[0], fc0.aff_dom.shape[1]
    mins = None
    if T > 0:
        parts = []
        for fc, state, _first in shards:
            out = torch.empty((P, T), dtype=torch.float32,
                              device=fc.base.allocatable.device)
            _launch(fc, state, 0, spread_out=out)
            parts.append(out)
            shard_launches += 1
        mins = torch.stack([m.to(dev0) for m in parts]).amin(dim=0)
    total = None
    for fc, state, first in shards:
        per = fc.base.allocatable.shape[0]
        n_loc = max(0, min(per, int(n_real) - int(first)))
        spread_in = (mins.to(fc.base.allocatable.device)
                     if mins is not None else None)
        c = _launch(fc, state, n_loc, spread_in=spread_in)
        shard_launches += 1
        c = c.to(dev0).to(torch.int64)
        if total is None:
            total = c
        else:
            total[:, :EXPLAIN_STAGE_GANG] += c[:, :EXPLAIN_STAGE_GANG]
    return total.to(torch.uint32)


def _launch(fc, filter_state, n_real: int, spread_in=None,
            spread_out=None):
    """One launch over ``fc``'s rows: the counts, or with ``spread_out``
    ([P, T] f32) only the spread minima of its rows; ``spread_in`` the
    minima to count against instead of its own."""
    global last_launch
    from koordinator_tpu_torch.ops.full_chain_kernel import (
        _dims,
        node_flags,
        pack_records,
        record_layout,
    )

    (requested, numa_free, bind_free, quota_used, aff_count, anti_cover,
     aff_exists, port_used, vol_free) = filter_state
    inputs = fc.base
    d = _dims(fc)
    P, N, R, K, G, D, T = (d[k] for k in "PNRKGDT")
    PT, VG = d["PT"], d["VG"]
    nbytes = smem_bytes(T)
    if nbytes > DEFAULT_SMEM_BYTES:
        raise KernelContractError(
            f"explain_counts: {T} affinity terms need {nbytes} B of shared "
            f"memory per block, above the {DEFAULT_SMEM_BYTES} B it takes")
    reject_np, reject_pr, gang_ok = pod_independent_rows(fc)
    records = pack_records(fc, gang_ok)
    lay = record_layout(R, T, PT, VG)
    dev = launch_device(inputs.allocatable)
    out = torch.empty((P, NUM_EXPLAIN_STAGES), dtype=torch.uint32,
                      device=dev)
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8

    def f(t):
        return t.to(f32).contiguous()

    args = {
        "records": (records, i32, (P, lay["rec_stride"])),
        "alloc": (f(inputs.allocatable), f32, (N, R)),
        "requested": (f(requested), f32, (N, R)),
        "node_flags": (node_flags(fc, reject_np, reject_pr), u8, (N,)),
        "cpc": (f(fc.cpus_per_core), f32, (N,)),
        "policy": (fc.numa_policy.to(i32).contiguous(), i32, (N,)),
        "taint_group": (fc.node_taint_group.to(i32).contiguous(), i32,
                        (N,)),
        "vol_group": (fc.node_vol_group.to(i32).contiguous(), i32, (N,)),
        "aff_dom": (f(fc.aff_dom), f32, (N, T)),
        "numa": (f(numa_free), f32, (N, K, R)),
        "bind_free": (f(bind_free), f32, (N,)),
        "vol_free": (f(vol_free), f32, (N,)),
        "port_used": (f(port_used), f32, (N, PT)),
        "aff_count": (f(aff_count), f32, (N, T)),
        "anti_cover": (f(anti_cover), f32, (N, T)),
        "aff_exists": (aff_exists.to(u8).contiguous(), u8, (T,)),
        "anc": (fc.quota_ancestors.to(i32).contiguous(), i32, (G, D)),
        "runtime": (f(fc.quota_runtime), f32, (G, R)),
        "quota_used": (f(quota_used), f32, (G, R)),
        "counts": (out, torch.uint32, (P, NUM_EXPLAIN_STAGES)),
        "spread_in": (spread_in, f32, (P, T)),
        "spread_out": (spread_out, f32, (P, T)),
    }
    params = _Params()
    for name in _PTR_FIELDS:
        t, dtype, shape = args[name]
        setattr(params, name,
                None if t is None else check_tensor(name, t, dtype, shape))
    sizes = dict(d, n_real=max(0, min(n_real, N)), **lay)
    for name in _INT_FIELDS:
        setattr(params, name, sizes[name])
    lib = _lib()
    # The temporaries above may be freed before the kernel ends: the caching
    # allocator hands their memory only to later work on this same stream.
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.explain_launch(ctypes.byref(params),
                                 ctypes.c_void_p(stream))
    if err != 0:
        raise launch_error("explain_counts", err,
                           f"{P} blocks x {THREADS} threads, {nbytes} B of "
                           "shared memory per block")
    last_launch = {
        "instance": ("common" if lib.explain_instance(ctypes.byref(params))
                     else "generic"),
        "blocks": P, "block_threads": THREADS, "smem_bytes_per_block": nbytes,
    }
    return out if spread_out is None else spread_out
