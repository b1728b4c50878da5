"""Wrapper of koordexplain's stage-count pass (csrc/explain_counts.cu).

Replaces the jax.vmap of explain_stage_counts in the JAX package's
models/full_chain.py (and its per-wave call in models/fused_waves.py), which
XLA runs there: for every pod and every real node, the round's Filter chain
at a frozen state, counted per stage, plus the pod's gang and quota
verdicts, as [P, 11] uint32.

``explain_counts`` launches the pass on the current stream. It takes the
full-chain round's own packed records and node flags (``pack``, what
ops/full_chain_kernel.full_chain_round packs for kernel 1 on the same
inputs, valid pods first: each record names its row) and reads the frozen
state tensors as they are; called without ``pack`` it packs them itself
(ops/full_chain_kernel.pack_records and node_flags, in queue order) and
counts that in ``self_packs``. Where the batch has affinity terms a first
launch of the kernel writes the spread minima (``minima_launches``). For
tensors on the CPU it returns the plain version, models/full_chain.
explain_stage_counts (counts_from_pack on a given pack); for CUDA tensors
it launches the kernel or raises. ``launches`` counts the counting
launches.

``explain_counts_shards`` is the pass over a mesh of cards: each shard's
rows counted on its own card against the spread minima over every shard,
the node stages' counts added into one buffer on the first card. Where the
batch has affinity terms each shard first adds its rows' minima into one
buffer there (an atomic min); the cards' streams wait on each other through
events, so the host neither reads nor sums anything. ``shard_launches``
counts its launches (two per shard where T > 0).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional

import torch

from koordinator_tpu_torch.models.full_chain import (
    EXPLAIN_STAGE_GANG,
    NUM_EXPLAIN_STAGES,
    explain_spread_minima,
    explain_stage_counts,
    pod_independent_rows,
)
from koordinator_tpu_torch.ops.kernel_common import (
    SMEM_BUDGET_BYTES,
    KernelContractError,
    check_tensor,
    launch_device,
    launch_error,
    load_library,
    on_device,
    smem_take,
)

SOURCE = "explain_counts.cu"
MAX_THREADS = 256  # csrc/explain_counts.cu kMaxThreads
# pods of a group = nodes of a tile = threads of a block, widest first
TILES = (256, 128, 64, 32)
BLOCKS_PER_SM = 16  # the grid's target: this many blocks per SM

launches = 0
minima_launches = 0
shard_launches = 0
self_packs = 0
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
    "tile", "splits", "accumulate", "write_flags",
)


class _Params(ctypes.Structure):
    """Mirror of ExplainParams in csrc/explain_counts.cu, field for field."""

    _fields_ = ([(f, _P) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int) for f in _INT_FIELDS])


class Pack(NamedTuple):
    """The round's packed inputs that the pass reads: ``records`` [P,
    rec_stride] int32 (ops/full_chain_kernel.pack_records, rows in any
    order) and ``node_flags`` [N] uint8 (node_flags)."""

    records: torch.Tensor
    node_flags: torch.Tensor


def _lib():
    lib = load_library(SOURCE)
    if not getattr(lib, "_koord_bound", False):
        lib.explain_params_size.restype = ctypes.c_int
        lib.explain_smem_bytes.restype = ctypes.c_longlong
        lib.explain_smem_bytes.argtypes = [ctypes.POINTER(_Params)]
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


def tile_words(R: int, K: int, T: int, PT: int) -> int:
    """4-byte words of one node's rows in a tile (csrc/explain_counts.cu
    explain_tile_words)."""
    return 2 * R + K * R + 2 + 3 * T + PT + 5


def smem_bytes(R: int, K: int, T: int, PT: int, rec_stride: int,
               tile: int) -> int:
    """Dynamic shared memory of one block (csrc/explain_counts.cu
    explain_layout): the group's records, the pods' order over the threads
    and the buckets' fill counters, the exists flags, the spread minima per
    pod and term, the node tile."""
    Tp = max(int(T), 1)
    at = 0
    for nbytes in (tile * rec_stride * 4, tile * 4 + 4 * 4, Tp * 4,
                   tile * Tp * 4, tile * tile_words(R, K, T, PT) * 4):
        _, at = smem_take(at, nbytes)
    return at


def plan(P: int, n_hi: int, R: int, K: int, T: int, PT: int,
         rec_stride: int, sms: int):
    """(tile, splits, smem bytes) of a launch. The tile (pods of a group,
    nodes of a tile): the widest whose block fits in shared memory and
    whose grid can reach BLOCKS_PER_SM blocks an SM, else the narrowest
    that fits; then the node splits that bring the grid to that target,
    each split a whole number of tiles and none empty. Raises
    KernelContractError where the narrowest group's records and tile do
    not fit."""
    target = BLOCKS_PER_SM * int(sms)
    fits = [t for t in TILES
            if smem_bytes(R, K, T, PT, rec_stride, t) <= SMEM_BUDGET_BYTES]
    if not fits:
        t = TILES[-1]
        raise KernelContractError(
            f"explain_counts: {t} pod records of {rec_stride} words and a "
            f"tile of {t} nodes ({tile_words(R, K, T, PT)} words a node) "
            f"need {smem_bytes(R, K, T, PT, rec_stride, t)} B of shared "
            f"memory per block, above the {SMEM_BUDGET_BYTES} B a block "
            "may take")
    tile = next((t for t in fits
                 if -(-int(P) // t) * -(-int(n_hi) // t) >= target),
                fits[-1])
    groups = max(1, -(-int(P) // tile))
    tiles = max(1, -(-int(n_hi) // tile))
    per = max(1, tiles // -(-target // groups))
    return tile, -(-tiles // per), smem_bytes(R, K, T, PT, rec_stride, tile)


def pack_for(fc, records=None) -> Pack:
    """The pass's own pack of ``fc``: the records in queue order (or the
    given ``records``, packed from the same pod fields) and the node flags,
    as the full-chain round packs them."""
    global self_packs
    from koordinator_tpu_torch.ops.full_chain_kernel import (
        node_flags,
        pack_records,
    )

    reject_np, reject_pr, gang_ok = pod_independent_rows(fc)
    if records is None:
        records = pack_records(fc, gang_ok)
        self_packs += 1
    return Pack(records, node_flags(fc, reject_np, reject_pr))


def _pod_key(fc) -> tuple:
    """The identities of every pod field pack_records reads: shards that
    share them (node_rows views of one batch) share one record pack."""
    b = fc.base
    return tuple(id(t) for t in (
        b.fit_requests, b.estimated, b.is_prod, b.is_daemonset, b.pod_valid,
        fc.gang_id, fc.gang_valid, fc.needs_numa, fc.needs_bind,
        fc.full_pcpus, fc.cores_needed, fc.pod_taint_mask, fc.quota_id,
        fc.pod_pref_id, fc.pod_ppref_id, fc.pod_img_id, fc.requests,
        fc.pod_aff_req, fc.pod_anti_req, fc.pod_aff_match,
        fc.pod_spread_skew, fc.pod_port_wants, fc.vol_needed))


def explain_counts(fc, filter_state, n_real, *, pack: Optional[Pack] = None,
                   out=None) -> torch.Tensor:
    """[P, NUM_EXPLAIN_STAGES] uint32 stage counts of every pod of ``fc``
    at the frozen ``filter_state`` (models/full_chain.explain_stage_counts'
    9-tuple) over the first ``n_real`` nodes: the kernel for CUDA
    tensors, on ``pack`` (the round's; packed here when None) into ``out``
    when given; the plain version for CPU tensors."""
    global launches, minima_launches
    if not fc.base.allocatable.is_cuda:
        if pack is None:
            return explain_stage_counts(fc, filter_state, n_real)
        return counts_from_pack(fc, filter_state, n_real, pack)
    if pack is None:
        pack = pack_for(fc)
    dev = launch_device(fc.base.allocatable)
    P, T = fc.base.fit_requests.shape[0], fc.aff_dom.shape[1]
    if out is None:
        out = torch.empty((P, NUM_EXPLAIN_STAGES), dtype=torch.uint32,
                          device=dev)
    mins = None
    if T > 0:
        # the spread minima first, over every row
        mins = torch.full((P, T), float("inf"), dtype=torch.float32,
                          device=dev)
        _launch(fc, filter_state, 0, pack, spread_out=mins)
        minima_launches += 1
    _launch(fc, filter_state, int(n_real), pack, counts=out, spread_in=mins)
    launches += 1
    return out


def counts_from_pack(fc, filter_state, n_real, pack: Pack,
                     spread_min=None) -> torch.Tensor:
    """The plain version on what the kernel reads: every per-pod field
    from ``pack``'s records (ops/full_chain_kernel.unpack_records, each
    row put back at the queue index it names), the node rows the flags
    hold (node_ok, the LoadAware rejects, has_topology) from its node
    flags, the rest from ``fc``; then models/full_chain.
    explain_stage_counts. Equal to it on ``fc`` itself exactly when the
    pack holds what the pass needs, in any row order."""
    from koordinator_tpu_torch.ops.full_chain_kernel import (
        _dims,
        unpack_records,
    )
    from koordinator_tpu_torch.ops.kernel_common import (
        NODE_HAS_TOPO,
        NODE_OK,
        NODE_REJECT_NP,
        NODE_REJECT_PR,
    )

    d = _dims(fc)
    f = unpack_records(pack.records, d["R"], d["T"], d["PT"], d["VG"])
    order = torch.argsort(f["pod"].long())
    f = {k: v[order] for k, v in f.items()}
    flags = pack.node_flags.to(torch.int32)

    def flag(bit):
        return (flags & bit) != 0

    base = fc.base._replace(
        fit_requests=f["fit_requests"], estimated=f["estimated"],
        is_prod=f["is_prod"], is_daemonset=f["is_daemonset"],
        pod_valid=f["pod_valid"], node_ok=flag(NODE_OK))
    pod = {k: f[k] for k in (
        "requests", "cores_needed", "pod_taint_mask", "quota_id",
        "pod_aff_req", "pod_anti_req", "pod_aff_match", "pod_spread_skew",
        "pod_port_wants", "vol_needed", "needs_numa", "needs_bind",
        "full_pcpus")}
    fc_p = fc._replace(base=base, has_topology=flag(NODE_HAS_TOPO), **pod)
    return explain_stage_counts(
        fc_p, filter_state, n_real, spread_min=spread_min,
        rows=(flag(NODE_REJECT_NP), flag(NODE_REJECT_PR), f["gang_ok"]))


def _streams_wait(waiting, on) -> None:
    """Each device of ``waiting`` holds its current stream until the work
    queued so far on the current stream of every other device of ``on``
    has run (a device's own stream is ordered already). No host sync."""
    if len(set(waiting) | set(on)) == 1 or next(iter(on)).type != "cuda":
        return
    events = {}
    for d in on:
        with on_device(d):
            events[d] = torch.cuda.current_stream(d).record_event()
    for d in waiting:
        with on_device(d):
            stream = torch.cuda.current_stream(d)
            for e_dev, ev in events.items():
                if e_dev != d:
                    stream.wait_event(ev)


def explain_counts_shards(shards, n_real, mesh=None) -> torch.Tensor:
    """The stage counts over a mesh of cards: ``shards`` [(fc, filter_state,
    first)] per shard, each on its card (the shard's rows and the pod
    fields; ``first`` its first global row), ``n_real`` the mesh's real
    nodes. Each shard counts its own real rows against the spread minima
    over every shard, adding its node stages' counts into one buffer on
    the first shard's card (integers: exact); the first shard writes the
    gang and quota verdicts. Shards that share their pod fields (views of
    one batch on one card) share one pack of the records. Returns [P,
    NUM_EXPLAIN_STAGES] uint32 on the first shard's card. On the CPU the
    same steps run in their plain versions (counts_from_pack and
    explain_spread_minima per shard). Where ``mesh`` (parallel/mesh.Mesh)
    spans processes, ``shards`` are this process's: the minima are
    reduced over the processes (a min), only the process holding shard 0
    writes the verdicts, and the counts are summed over the processes (an
    int64 sum of integers: exact in any order)."""
    global shard_launches
    spans = mesh is not None and mesh.spans_processes
    first_here = not spans or mesh.local(0)
    fc0 = shards[0][0]
    cuda = fc0.base.allocatable.is_cuda
    dev0 = fc0.base.allocatable.device
    P, T = fc0.base.fit_requests.shape[0], fc0.aff_dom.shape[1]
    devs = list(dict.fromkeys(fc.base.allocatable.device
                              for fc, _s, _f in shards))
    if cuda and len(devs) > 1:
        from koordinator_tpu_torch.ops.full_chain_kernel import (
            enable_peer_access,
        )

        enable_peer_access(devs)
    packs, records = [], {}
    for fc, _state, _first in shards:
        with _on(fc.base.allocatable.device):
            pack = pack_for(fc, records.get(_pod_key(fc)))
        records[_pod_key(fc)] = pack.records
        packs.append(pack)
    with _on(dev0):
        out = torch.zeros((P, NUM_EXPLAIN_STAGES), dtype=torch.int32,
                          device=dev0)
        # only where the batch has terms: none has a positive skew else
        mins = (torch.full((P, T), float("inf"), dtype=torch.float32,
                           device=dev0) if T > 0 else None)
    _streams_wait(devs, devs)
    if mins is not None:
        # every shard's rows (padded ones too) into the mesh's minima
        for (fc, state, _first), pack in zip(shards, packs):
            if cuda:
                _launch(fc, state, 0, pack, spread_out=mins)
                shard_launches += 1
            else:
                torch.minimum(mins, explain_spread_minima(fc, state[4]),
                              out=mins)
        _streams_wait(devs, devs)
        if spans:
            with _on(dev0):
                mesh.all_reduce(mins, "min")
    for k, ((fc, state, first), pack) in enumerate(zip(shards, packs)):
        per = fc.base.allocatable.shape[0]
        n_loc = max(0, min(per, int(n_real) - int(first)))
        if cuda:
            _launch(fc, state, n_loc, pack, counts=out.view(torch.uint32),
                    spread_in=mins, accumulate=True,
                    write_flags=k == 0 and first_here)
            shard_launches += 1
            continue
        c = counts_from_pack(fc, state, n_loc, pack,
                             spread_min=mins).to(torch.int64)
        out[:, :EXPLAIN_STAGE_GANG] += c[:, :EXPLAIN_STAGE_GANG].to(
            torch.int32)
        if k == 0 and first_here:
            out[:, EXPLAIN_STAGE_GANG:] = c[:, EXPLAIN_STAGE_GANG:].to(
                torch.int32)
    _streams_wait([dev0], devs)
    if spans:
        with _on(dev0):
            out = mesh.all_reduce(out.to(torch.int64), "sum").to(torch.int32)
    return out.view(torch.uint32)


def _on(dev: torch.device):
    """on_device for a card, nothing for the CPU."""
    return on_device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(fc, filter_state, n_real: int, pack: Pack, counts=None,
            spread_in=None, spread_out=None, accumulate: bool = False,
            write_flags: bool = True):
    """One launch over ``fc``'s rows on the current stream of their card:
    the counts into ``counts`` (zeroed by the launch unless
    ``accumulate``), or with ``spread_out`` ([P, T] f32, +inf to start)
    only the minima of its rows added in; ``spread_in`` the minima to count
    against instead of its own sweep. ``counts``, ``spread_in`` and
    ``spread_out`` may lie on another card of the mesh (peer access)."""
    global last_launch
    from koordinator_tpu_torch.ops.full_chain_kernel import (
        _dims,
        record_layout,
    )

    (requested, numa_free, bind_free, quota_used, aff_count, anti_cover,
     aff_exists, port_used, vol_free) = filter_state
    inputs = fc.base
    d = _dims(fc)
    P, N, R, K, G, D, T = (d[k] for k in "PNRKGDT")
    PT, VG = d["PT"], d["VG"]
    lay = record_layout(R, T, PT, VG)
    stride = lay["rec_stride"]
    if pack.records.data_ptr() % 16:
        raise KernelContractError("explain_counts: the records must start "
                                  "on a 16-byte boundary")
    dev = launch_device(inputs.allocatable)
    n_real = max(0, min(n_real, N))
    tile, splits, nbytes = plan(P, N if spread_out is not None else n_real,
                                R, K, T, PT, stride, _sms(dev))
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    if aff_exists.dtype == torch.bool:
        aff_exists = aff_exists.view(u8)
    args = {
        "records": (pack.records, i32, (P, stride)),
        "alloc": (inputs.allocatable, f32, (N, R)),
        "requested": (requested, f32, (N, R)),
        "node_flags": (pack.node_flags, u8, (N,)),
        "cpc": (fc.cpus_per_core, f32, (N,)),
        "policy": (fc.numa_policy, i32, (N,)),
        "taint_group": (fc.node_taint_group, i32, (N,)),
        "vol_group": (fc.node_vol_group, i32, (N,)),
        "aff_dom": (fc.aff_dom, f32, (N, T)),
        "numa": (numa_free, f32, (N, K, R)),
        "bind_free": (bind_free, f32, (N,)),
        "vol_free": (vol_free, f32, (N,)),
        "port_used": (port_used, f32, (N, PT)),
        "aff_count": (aff_count, f32, (N, T)),
        "anti_cover": (anti_cover, f32, (N, T)),
        "aff_exists": (aff_exists, u8, (T,)),
        "anc": (fc.quota_ancestors, i32, (G, D)),
        "runtime": (fc.quota_runtime, f32, (G, R)),
        "quota_used": (quota_used, f32, (G, R)),
        "counts": (counts, torch.uint32, (P, NUM_EXPLAIN_STAGES)),
        "spread_in": (spread_in, f32, (P, T)),
        "spread_out": (spread_out, f32, (P, T)),
    }
    params = _Params()
    for name in _PTR_FIELDS:
        t, dtype, shape = args[name]
        setattr(params, name,
                None if t is None else check_tensor(name, t, dtype, shape))
    sizes = dict(d, n_real=n_real, **lay, tile=tile, splits=splits,
                 accumulate=int(accumulate), write_flags=int(write_flags))
    for name in _INT_FIELDS:
        setattr(params, name, sizes[name])
    lib = _lib()
    c_bytes = lib.explain_smem_bytes(ctypes.byref(params))
    if c_bytes != nbytes:
        raise KernelContractError(f"explain_counts: smem_bytes says {nbytes} "
                                  f"bytes, the kernel's layout {c_bytes}")
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.explain_launch(ctypes.byref(params),
                                 ctypes.c_void_p(stream))
    blocks = -(-P // tile) * splits
    if err != 0:
        raise launch_error("explain_counts", err,
                           f"{blocks} blocks x {tile} threads, {nbytes} B "
                           "of shared memory per block")
    last_launch = {
        "instance": ("common" if lib.explain_instance(ctypes.byref(params))
                     else "generic"),
        "blocks": blocks, "block_threads": tile, "splits": splits,
        "smem_bytes_per_block": nbytes,
        "mode": ("minima" if spread_out is not None else
                 "accumulate" if accumulate else "counts"),
    }
    return counts if spread_out is None else spread_out
