"""Mesh layout and sharded scheduling steps, in torch.

The port's counterpart of the JAX package's parallel/mesh.py. A mesh is a
2-D grid ("pods", "nodes") of shard devices; node-state arrays shard over
ALL of them (flat), pod arrays replicate. Two shardings cover the compute:

  1. serial-parity step: the node axis of [N, ...] arrays split into D
     contiguous shards; each pod's filter/score rows are computed per shard
     and the winners merge by (score, lowest global index), so bindings
     equal the single-device round at any mesh size. Shards of one card
     share it, so there the step gathers the node axis (``gather``) and
     launches the single-device kernel; shards on several cards keep their
     rows on their own cards and run the kernels' exchange instances
     (``Mesh.exchange``).
  2. score matrix: the [P, N] matrix split over both mesh axes.

A ``MeshDevice`` is the counterpart of a ``jax.Device``: an integer id, the
torch device its shard lives on and the process that holds it. Every
visible device (the card, or the CPU) appears as
``KOORD_TORCH_VIRTUAL_DEVICES`` shard devices (unset: 1), the counterpart
of XLA's ``--xla_force_host_platform_device_count``: D shards may share one
device. A mesh may also span OS processes over ``torch.distributed``'s gloo
backend (the caller initialises the process group); then each process
holds only its own shards, and the cross-shard merges are all-reduces.

A ``ShardedTensor`` is an explicit list of per-shard tensors (one per mesh
device, flat order; None for a shard another process holds) with the
global shape and the spec. Padding follows the JAX package: ``np.pad`` of
the global array first (``pad_for_sharding``), then the split, so shard s
of a node-axis array holds global rows [s * per, (s + 1) * per). A
replicated array keeps one copy per distinct device, shared by the shards
on that device.

A mesh whose shards sit on two or more cards of one process exchanges
(``Mesh.exchange``): its scheduling steps launch the kernels' exchange
instances on each card over that card's rows, and per pod the cards swap
their bests through mailboxes in each other's memory (ops/kernel_common.py
"The exchange"), with peer access on between every pair of cards; no node
row is gathered onto another card. A mesh of shards on ONE card (or the
CPU) does not exchange: there the steps gather, as above. Testing code may
set ``exchange`` on a one-card mesh, whose shards then run the exchange
instances as clusters of one launch. A mesh of cards held by several
processes is refused (CROSS_PROCESS_CARDS).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.models.convert import as_tensor, check_device
from koordinator_tpu_torch.models.scheduler_model import (
    ScheduleInputs,
    build_score_matrix,
    resolve_weight_idx,
)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs

logger = logging.getLogger(__name__)

# shard devices each visible device appears as (unset: 1)
VIRTUAL_DEVICES_ENV = "KOORD_TORCH_VIRTUAL_DEVICES"
CROSS_PROCESS_CARDS = ("a mesh of cards held by several processes needs its "
                       "per-pod exchange to cross processes, which the "
                       "port does not have: its cards' mailboxes are in "
                       "one process's reach only")


class MeshDevice(NamedTuple):
    """One shard device: ``id`` (unique in the mesh), the torch ``device``
    its shard lives on and the ``process`` (torch.distributed rank) that
    holds it."""

    id: int
    device: torch.device
    process: int = 0


def virtual_split() -> int:
    """Shard devices per visible device (KOORD_TORCH_VIRTUAL_DEVICES)."""
    raw = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if not raw:
        return 1
    n = int(raw)
    if n < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV}={raw!r} must be >= 1")
    return n


def _process_group():
    """(rank, world size) of an initialised torch.distributed group, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def visible_devices(device="cuda") -> List[MeshDevice]:
    """Every shard device: each visible device of ``device``'s type (every
    card for "cuda", the host for "cpu") split into virtual_split() shard
    devices; with an initialised process group, every process's shards in
    rank order (each process sees ``device`` only)."""
    dev = check_device(device)
    n = virtual_split()
    rank, world = _process_group()
    if world > 1:
        local = (torch.device("cuda", torch.cuda.current_device())
                 if dev.type == "cuda" else torch.device("cpu"))
        return [MeshDevice(r * n + k, local if r == rank else dev, r)
                for r in range(world) for k in range(n)]
    if dev.type == "cuda":
        cards = [torch.device("cuda", c)
                 for c in range(torch.cuda.device_count())]
    else:
        cards = [torch.device("cpu")]
    return [MeshDevice(c * n + k, d, 0)
            for c, d in enumerate(cards) for k in range(n)]


class Mesh:
    """2-D mesh ("pods", "nodes") of shard devices. ``devices`` is the
    numpy object array of MeshDevices, as ``jax.sharding.Mesh`` has it."""

    axis_names = ("pods", "nodes")

    def __init__(self, devices: np.ndarray) -> None:
        self.devices = devices
        flat = list(devices.flat)
        cards = {d.device for d in flat if d.device.type == "cuda"}
        procs = {d.process for d in flat}
        if cards and len(procs) > 1:
            raise NotImplementedError(CROSS_PROCESS_CARDS)
        self.rank, self.world = _process_group()
        self.spans_processes = len(procs) > 1
        # the exchange route: shards on two or more cards (testing code may
        # set it on a one-card mesh); building the mesh touches no card
        self.exchange = len(cards) > 1
        self._mailboxes = None

    @property
    def cards(self) -> List[torch.device]:
        """The distinct devices of the mesh's shards, in shard order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d.device not in out:
                out.append(d.device)
        return out

    def check_peer_access(self) -> None:
        """Raise, naming the pair, unless every card of the mesh can reach
        every other card's memory (torch.cuda.can_device_access_peer): the
        exchange's mailboxes need it, and no other route is taken."""
        cards = [c for c in self.cards if c.type == "cuda"]
        for a in cards:
            for b in cards:
                if a != b and not torch.cuda.can_device_access_peer(a, b):
                    raise RuntimeError(
                        f"a mesh of cards needs peer access between every "
                        f"pair of its cards: {a} cannot reach {b}")

    def mailboxes(self):
        """The exchange's mailboxes (ops/kernel_common.Mailboxes), made at
        first use: peer access checked and turned on for every pair of
        cards, then one mailbox per shard on its card."""
        if self._mailboxes is None:
            from koordinator_tpu_torch.ops.full_chain_kernel import (
                enable_peer_access,
            )
            from koordinator_tpu_torch.ops.kernel_common import Mailboxes

            self.check_peer_access()
            if len(self.cards) > 1:
                enable_peer_access(self.cards)
            flat = self.flat
            self._mailboxes = Mailboxes([d.device for d in flat],
                                        [d.id for d in flat])
        return self._mailboxes

    def card_shards(self) -> List[Tuple[torch.device, List[int]]]:
        """(device, its shards in shard order) of every device of the
        mesh, in the order of their first shard."""
        groups: Dict[torch.device, List[int]] = {}
        for k, d in enumerate(self.flat):
            groups.setdefault(d.device, []).append(k)
        return list(groups.items())

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> List[MeshDevice]:
        return list(self.devices.flat)

    def local(self, k: int) -> bool:
        """Whether this process holds shard ``k``."""
        return self.devices.flat[k].process == self.rank

    @property
    def tag(self) -> Tuple[int, ...]:
        return tuple(d.id for d in self.devices.flat)

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced ("min" | "max" | "sum") over the processes of a
        mesh that spans them (gloo), in place; ``t`` itself otherwise.
        Min and max are exact under any split; "sum" is used only on
        integers."""
        if not self.spans_processes:
            return t
        import torch.distributed as dist

        ops = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
               "sum": dist.ReduceOp.SUM}
        dist.all_reduce(t, op=ops[op])
        return t

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ids={list(self.tag)})"


def make_mesh(devices: Optional[Sequence[MeshDevice]] = None,
              device="cuda") -> Mesh:
    """2-D mesh ("pods", "nodes"); the nodes axis gets the larger factor
    (node count exceeds pending-pod count in the target configs)."""
    devices = list(devices if devices is not None
                   else visible_devices(device))
    n = len(devices)
    pods_dim = 1
    for f in range(int(np.sqrt(n)), 0, -1):
        if n % f == 0:
            pods_dim = f
            break
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):  # element-wise: a device is a tuple
        arr[i] = d
    return Mesh(arr.reshape(pods_dim, n // pods_dim))


def mesh_from_env(env_value=None, device="cuda") -> Optional[Mesh]:
    """KOORD_TPU_MESH=<ndev>|auto selects mesh-backed dispatch
    (scheduler/cycle.py): "auto" takes every visible shard device, an
    integer a prefix of them. Unset/0/off and "auto" with fewer than two
    visible return None — the single-device path. "1" pins a 1-device
    mesh. A request for more devices than exist raises (a silently smaller
    mesh would make capacity planning lie)."""
    raw = (os.environ.get("KOORD_TPU_MESH", "") if env_value is None
           else str(env_value)).strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return None
    devices = visible_devices(device)
    if raw == "auto":
        if len(devices) < 2:
            return None
        return make_mesh(devices)
    try:
        n = int(raw)
    except ValueError:
        logger.warning("KOORD_TPU_MESH=%r not an int or 'auto'; "
                       "mesh dispatch stays off", raw)
        return None
    if n <= 1:
        # a 1-device mesh is still a valid mesh (the parity gates use it);
        # pin it explicitly with KOORD_TPU_MESH=1
        if raw == "1":
            return make_mesh(devices[:1])
        return None
    if n > len(devices):
        raise ValueError(
            f"KOORD_TPU_MESH={n} but only {len(devices)} devices visible")
    return make_mesh(devices[:n])


def surviving_submesh(mesh: Mesh, lost_device_ids) -> Optional[Mesh]:
    """The partial-mesh rung's submesh: the configured mesh minus the
    devices a dispatch fault was attributed to, re-factored 2-D by
    ``make_mesh``, on the configured mesh's route (``exchange``).
    Non-divisible node axes re-pad on upload, so any survivor count is a
    valid mesh. None when nothing survives (the scheduler records losses
    only while survivors remain)."""
    lost = {int(i) for i in lost_device_ids}
    survivors = [d for d in mesh.devices.flat if d.id not in lost]
    if not survivors:
        return None
    sub = make_mesh(survivors)
    # a mesh of cards keeps its route: the survivors of one card run the
    # exchange instances as clusters of one launch
    sub.exchange = sub.exchange or mesh.exchange
    return sub


class PartitionSpec(tuple):
    """Per-dimension mesh axes (None, an axis name or a tuple of names),
    as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


P = PartitionSpec


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: PartitionSpec

    @property
    def replicated(self) -> bool:
        return all(e is None for e in self.spec)


def _node_axis_spec(mesh: Mesh, flat: bool) -> PartitionSpec:
    # serial mode shards nodes over every device (both mesh axes)
    return P(("pods", "nodes")) if flat else P("nodes")


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _shard_counts(sharding: NamedSharding, ndim: int) -> Tuple[int, ...]:
    """Shards per dimension a NamedSharding splits an ndim-array into."""
    sizes = sharding.mesh.shape
    counts = []
    for d in range(ndim):
        entry = sharding.spec[d] if d < len(sharding.spec) else None
        f = 1
        for ax in _axes(entry):
            f *= sizes[ax]
        counts.append(f)
    return tuple(counts)


def _shard_position(sharding: NamedSharding, k: int, d: int) -> int:
    """Shard k's block index along dimension d (mesh axes in row-major
    order over the named ones)."""
    entry = sharding.spec[d] if d < len(sharding.spec) else None
    coord = dict(zip(Mesh.axis_names,
                     np.unravel_index(k, sharding.mesh.devices.shape)))
    sizes = sharding.mesh.shape
    pos = 0
    for ax in _axes(entry):
        pos = pos * sizes[ax] + int(coord[ax])
    return pos


def shard_index(sharding: NamedSharding, shape, k: int) -> Tuple[slice, ...]:
    """The global slice that shard k holds of an array of ``shape``
    (padded to the shard counts)."""
    counts = _shard_counts(sharding, len(shape))
    out = []
    for d, (size, c) in enumerate(zip(shape, counts)):
        per = size // c
        pos = _shard_position(sharding, k, d) if c > 1 else 0
        out.append(slice(pos * per, (pos + 1) * per))
    return tuple(out)


def pad_for_sharding(arr: np.ndarray, sharding: NamedSharding) -> np.ndarray:
    """Zero-pad each sharded dimension up to the next multiple of its shard
    count, so callers never pre-quantize axis sizes to the mesh factor.
    Zero rows reproduce the snapshot's own bucket-pad rows (node_ok,
    allocatable and pod_valid all zero: infeasible everywhere). Divisible
    shapes pass through untouched (no copy)."""
    arr = np.asarray(arr)
    counts = _shard_counts(sharding, arr.ndim)
    widths = []
    needs = False
    for size, c in zip(arr.shape, counts):
        pad = (-size) % c
        widths.append((0, pad))
        needs = needs or pad > 0
    if not needs:
        return arr
    return np.pad(arr, widths)


class ShardedTensor:
    """An array on a mesh: ``shards[k]`` is shard k's tensor on the k-th
    mesh device (None where another process holds it), ``shape`` the
    global (padded) shape. ``np.asarray`` assembles it on the host (the
    readback); every shard must then be held by this process, unless the
    array is replicated."""

    def __init__(self, shards: List[Optional[torch.Tensor]], shape,
                 sharding: NamedSharding) -> None:
        self.shards = shards
        self.shape = torch.Size(shape)
        self.sharding = sharding
        first = next(t for t in shards if t is not None)
        self.dtype = first.dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def replicated(self) -> bool:
        return self.sharding.replicated

    def index(self, k: int) -> Tuple[slice, ...]:
        return shard_index(self.sharding, tuple(self.shape), k)

    def local(self) -> torch.Tensor:
        """One shard this process holds (a replica for a replicated
        array)."""
        return next(t for t in self.shards if t is not None)

    @property
    def node_dim(self) -> int:
        """The dimension the array is split along: 0 for the node-axis
        arrays, 1 for a [P, N] array whose node axis is its second."""
        return next(d for d, e in enumerate(self.sharding.spec)
                    if e is not None)

    def clone(self) -> "ShardedTensor":
        """Each shard's own copy, in the same sharding."""
        return ShardedTensor(
            [None if t is None else t.clone() for t in self.shards],
            self.shape, self.sharding)

    @property
    def addressable_shards(self):
        """(MeshDevice, tensor, global index) of every shard this process
        holds."""
        devs = self.mesh.flat
        return [(devs[k], t, self.index(k))
                for k, t in enumerate(self.shards) if t is not None]

    def numpy(self) -> np.ndarray:
        if self.replicated:
            return self.local().cpu().numpy()
        if any(t is None for t in self.shards):
            raise ValueError("a sharded array spanning processes is read "
                             "back only where every shard is held")
        first = self.local().cpu().numpy()
        out = np.empty(tuple(self.shape), dtype=first.dtype)
        for k, t in enumerate(self.shards):
            out[self.index(k)] = t.cpu().numpy()
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    def __add__(self, other: "ShardedTensor") -> "ShardedTensor":
        """Shard by shard, with an array of the same sharding."""
        if not isinstance(other, ShardedTensor) or (
                other.sharding.spec != self.sharding.spec
                or other.shape[0] != self.shape[0]):
            return NotImplemented
        return ShardedTensor(
            [None if a is None else a + b
             for a, b in zip(self.shards, other.shards)],
            self.shape, self.sharding)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"spec={self.sharding.spec}, shards={len(self.shards)})")


def replicate(t: torch.Tensor, mesh: Mesh) -> ShardedTensor:
    """A replicated ShardedTensor of ``t``: one copy per distinct device of
    the mesh's local shards (``t`` itself on its own device)."""
    copies: Dict[torch.device, torch.Tensor] = {t.device: t}
    shards: List[Optional[torch.Tensor]] = []
    for k, d in enumerate(mesh.flat):
        if not mesh.local(k):
            shards.append(None)
            continue
        if d.device not in copies:
            copies[d.device] = t.to(d.device)
        shards.append(copies[d.device])
    return ShardedTensor(shards, t.shape, NamedSharding(mesh, P()))


def from_shards(shards: List[Optional[torch.Tensor]], mesh: Mesh,
                spec: PartitionSpec, dim: int = 0) -> ShardedTensor:
    """A node-axis ShardedTensor from per-shard tensors split along
    ``dim`` (``spec``'s sharded entry)."""
    first = next(t for t in shards if t is not None)
    shape = list(first.shape)
    shape[dim] *= len(shards)
    return ShardedTensor(list(shards), shape, NamedSharding(mesh, spec))


def gather(x):
    """The whole array of ``x``: a node-sharded ShardedTensor's shards
    concatenated in shard order (the flat node sharding's dimension 0;
    across the processes of a mesh that spans them, a gloo all-gather), a
    replicated one's local copy; anything else as it is. One card holds
    every shard of a mesh on the card, so there this is a torch.cat on
    the card; on a mesh of cards each card's rows are copied to the first
    shard's card (the rebalance and colo passes' gathers; the scheduling
    steps never gather there)."""
    if not isinstance(x, ShardedTensor):
        return x
    if x.replicated:
        return x.local()
    parts = [t for t in x.shards if t is not None]
    first = parts[0].device
    return cat_over_processes(
        x.mesh, torch.cat([t.to(first) for t in parts]))


def cat_over_processes(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """``local`` (this process's shards' rows, side by side) followed by
    every other process's, in shard order: a gloo all-gather on a mesh
    that spans processes, ``local`` itself otherwise."""
    if not mesh.spans_processes:
        return local
    import torch.distributed as dist

    parts = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def gather_tree(nt):
    """``nt`` (a NamedTuple of ShardedTensors, nested NamedTuples, tensors
    or None) with every ShardedTensor gathered."""
    if isinstance(nt, tuple) and hasattr(nt, "_fields"):
        return type(nt)(*(gather_tree(v) for v in nt))
    return gather(nt)


def split_nodes(t: torch.Tensor, mesh: Mesh) -> ShardedTensor:
    """A whole [N, ...] tensor in the flat node sharding: shard k a view of
    rows [k * per, (k + 1) * per) (None for another process's shard)."""
    per = t.shape[0] // mesh.size
    return from_shards([t[k * per:(k + 1) * per] if mesh.local(k) else None
                        for k in range(mesh.size)], mesh,
                       _node_axis_spec(mesh, flat=True))


def put_on_mesh(arr, sharding: NamedSharding) -> ShardedTensor:
    """Place host data on a (possibly multi-process) sharding, zero-padding
    non-divisible sharded axes (``pad_for_sharding``), with the dtype the
    single-device upload gives (models/convert.as_tensor). A mesh that
    spans processes materializes only this process's shards from the
    (identically computed) host array."""
    mesh = sharding.mesh
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = pad_for_sharding(np.asarray(arr), sharding)
    if sharding.replicated:
        first = next(k for k in range(mesh.size) if mesh.local(k))
        return replicate(as_tensor(arr, mesh.flat[first].device), mesh)
    shards: List[Optional[torch.Tensor]] = []
    for k, d in enumerate(mesh.flat):
        if not mesh.local(k):
            shards.append(None)
            continue
        idx = shard_index(sharding, arr.shape, k)
        shards.append(as_tensor(np.ascontiguousarray(arr[idx]), d.device))
    return ShardedTensor(shards, arr.shape, sharding)


def merge_readback(*arrays) -> Tuple[List[np.ndarray], Dict[int, int]]:
    """Materialize step outputs to host numpy, merging from the per-shard
    buffers, and account the bytes each mesh device holds for them.

    The sharded steps return their compacted readback outputs replicated,
    so one copy is read; the per-shard byte map feeds the
    ``koord_scheduler_mesh_readback_bytes`` gauges. Blocking is intended:
    this is the mesh path's designated sync point."""
    out: List[np.ndarray] = []
    per_shard: Dict[int, int] = {}
    for arr in arrays:
        if isinstance(arr, ShardedTensor):
            for dev, t, _idx in arr.addressable_shards:
                per_shard[dev.id] = (per_shard.get(dev.id, 0)
                                     + t.numel() * t.element_size())
            out.append(arr.numpy())
        elif isinstance(arr, torch.Tensor):
            out.append(arr.cpu().numpy())
        else:
            out.append(np.asarray(arr))
    return out, per_shard


def mesh_row_layout(mesh: Mesh, n_real: int, n_padded: int) -> List[int]:
    """REAL (unpadded) node rows owned by each shard of the flat node
    sharding, in device order. With the node axis padded to ``n_padded``
    over D devices each shard owns n_padded // D rows; trailing shards may
    hold only pad rows."""
    ndev = mesh.size
    per = n_padded // ndev if ndev else 0
    return [max(0, min(per, n_real - i * per)) for i in range(ndev)]


_SCHEDULE_POD_FIELDS = frozenset({
    "fit_requests", "estimated", "is_prod", "is_daemonset", "pod_valid",
    "weights"})


def shard_inputs_nodewise(inputs: ScheduleInputs,
                          mesh: Mesh) -> ScheduleInputs:
    """Sharding for the serial-parity step: node arrays sharded over all
    devices, pod arrays and weights replicated."""
    node_spec = _node_axis_spec(mesh, flat=True)

    def put(name, arr):
        spec = P() if name in _SCHEDULE_POD_FIELDS else node_spec
        return put_on_mesh(arr, NamedSharding(mesh, spec))

    return ScheduleInputs(**{k: put(k, v)
                             for k, v in inputs._asdict().items()})


def shard_inputs_2d(inputs: ScheduleInputs, mesh: Mesh) -> ScheduleInputs:
    """Sharding for the one-shot matrix: pods over "pods", nodes over
    "nodes"."""
    def put(name, arr):
        if name == "weights":
            spec = P()
        elif name in _SCHEDULE_POD_FIELDS:
            spec = P("pods")
        else:
            spec = P("nodes")
        return put_on_mesh(arr, NamedSharding(mesh, spec))

    return ScheduleInputs(**{k: put(k, v)
                             for k, v in inputs._asdict().items()})


def shard_views(nt, mesh: Mesh):
    """[(k, view)] for every shard k this process holds: ``nt`` (a
    NamedTuple of ShardedTensors, nested NamedTuples, tensors or None)
    with each ShardedTensor replaced by its shard k tensor."""
    def view(x, k):
        if isinstance(x, ShardedTensor):
            return x.shards[k]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(view(v, k) for v in x))
        return x

    return [(k, view(nt, k)) for k in range(mesh.size) if mesh.local(k)]


class WinnerMerge:
    """The per-pod cross-shard select: each shard's (best score, lowest
    local index) merges into the global (max score, lowest global index),
    first over this process's shards, then over processes (two
    all-reduces). Exact under any split."""

    def __init__(self, mesh: Mesh, per: int) -> None:
        self.mesh = mesh
        self.per = per

    def merge(self, bests) -> Tuple[torch.Tensor, int]:
        """``bests``: [(k, score 0-d, local index 0-d)] of the local
        shards, ascending k. Returns (best score 0-d, global index)."""
        vals = torch.stack([v for _k, v, _b in bests])
        j = int(torch.argmax(vals))  # the lowest shard at the max
        k, v, b = bests[j]
        g = k * self.per + int(b)
        if not self.mesh.spans_processes:
            return v, g
        v_all = self.mesh.all_reduce(v.reshape(1).clone(), "max")
        cand = torch.tensor([g if bool(v == v_all[0]) else 2**62],
                            dtype=torch.int64)
        g_all = int(self.mesh.all_reduce(cand, "min")[0])
        return v_all[0], g_all


def build_sharded_schedule_step(args: LoadAwareArgs, mesh: Mesh):
    """The serial-parity LoadAware step over ``mesh``: node-sharded
    ScheduleInputs (shard_inputs_nodewise) -> (chosen[P] int32 replicated,
    requested[N, R] node-sharded). Shards of one card gather the node
    fields (``gather``) and launch kernel 2 (ops/schedule_kernel.py
    ``schedule_round``) on them, then split ``requested`` back into its
    shards; a mesh of cards (``mesh.exchange``) launches kernel 2's
    exchange instance on each card over its own rows
    (``schedule_round_cards``); shards on the CPU run the plain sharded
    round: per pod, each shard evaluates its rows, the winners merge by
    (score, lowest global index) and the owning shard commits."""
    weight_idx = resolve_weight_idx(args)
    prod_mode = args.score_according_prod_usage

    def step(inputs: ScheduleInputs):
        if inputs.allocatable.local().is_cuda and mesh.exchange:
            step.last_backend = "cuda-exchange"
            return _exchange_schedule(inputs, mesh, weight_idx, prod_mode)
        if inputs.allocatable.local().is_cuda:
            from koordinator_tpu_torch.ops.schedule_kernel import (
                schedule_round,
            )

            step.last_backend = "cuda"
            chosen, requested = schedule_round(gather_tree(inputs),
                                               weight_idx, prod_mode)
            return replicate(chosen, mesh), split_nodes(requested, mesh)
        step.last_backend = "serial"
        return _plain_sharded_schedule(inputs, mesh, weight_idx, prod_mode)

    step.last_backend = None
    return step


def card_view(nt, shards: Sequence[int], device: torch.device):
    """One card's view of ``nt`` (a NamedTuple of ShardedTensors, nested
    NamedTuples, tensors or None) for its ``shards``: a node-sharded array
    its shards' rows side by side (the one shard's tensor itself where the
    card holds one; side by side along the node axis, the second for a
    [P, N] array), a replicated one the copy on the card, a plain tensor
    copied to the card."""
    def view(x):
        if isinstance(x, ShardedTensor):
            if x.replicated:
                return x.shards[shards[0]]
            parts = [x.shards[k] for k in shards]
            return (parts[0] if len(parts) == 1
                    else torch.cat(parts, dim=x.node_dim))
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(view(v) for v in x))
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return x

    return view(nt)


def split_card_rows(t: torch.Tensor, n: int,
                    dim: int = 0) -> List[torch.Tensor]:
    """A card's n * per rows (along ``dim``) back into its ``n`` shards'
    views."""
    per = t.shape[dim] // n
    return [t.narrow(dim, j * per, per) for j in range(n)]


def _exchange_schedule(inputs: ScheduleInputs, mesh: Mesh, weight_idx,
                       prod_mode: bool):
    """Kernel 2's exchange instance over a mesh of cards: each card's
    launch over its own shards' rows, the winners exchanged per pod."""
    from koordinator_tpu_torch.ops.schedule_kernel import (
        schedule_round_cards,
    )

    groups = mesh.card_shards()
    cards = [(card_view(inputs, ks, dev), ks) for dev, ks in groups]
    outs = schedule_round_cards(cards, weight_idx, prod_mode,
                                mesh.mailboxes())
    shards: List[Optional[torch.Tensor]] = [None] * mesh.size
    for (_dev, ks), (_chosen, requested) in zip(groups, outs):
        for k, t in zip(ks, split_card_rows(requested, len(ks))):
            shards[k] = t
    spec = _node_axis_spec(mesh, flat=True)
    return replicate(outs[0][0], mesh), from_shards(shards, mesh, spec)


def _plain_sharded_schedule(inputs: ScheduleInputs, mesh: Mesh, weight_idx,
                            prod_mode: bool):
    """The plain LoadAware round over the shards (the JAX package's
    build_schedule_step, sharded)."""
    from koordinator_tpu_torch.models.scheduler_model import (
        _score_row,
        node_rejects,
    )
    from koordinator_tpu_torch.ops.fit import fit_ok_row

    views = shard_views(inputs, mesh)
    per = inputs.allocatable.shape[0] // mesh.size
    merge = WinnerMerge(mesh, per)
    f32 = torch.float32
    P_, R = inputs.fit_requests.shape
    state = {}
    for k, v in views:
        rnp, rpr = node_rejects(v)
        dev = v.allocatable.device
        state[k] = (v, rnp, rpr, v.requested.to(f32).clone(),
                    torch.zeros((per, R), dtype=f32, device=dev),
                    torch.zeros((per, R), dtype=f32, device=dev))
    pod = views[0][1]
    chosen = torch.full((P_,), -1, dtype=torch.int32,
                        device=pod.fit_requests.device)
    for i in range(P_):
        req = pod.fit_requests[i]
        est = pod.estimated[i]
        is_prod_i = pod.is_prod[i]
        bests = []
        for k, (v, rnp, rpr, requested, dnp, dpr) in state.items():
            fit = fit_ok_row(req, v.allocatable, requested)
            la_ok = v.is_daemonset[i] | ~torch.where(is_prod_i, rpr, rnp)
            feasible = v.node_ok & fit & la_ok
            score = _score_row(est, is_prod_i, v, dnp, dpr, weight_idx,
                               prod_mode)
            score = torch.where(feasible, score, -1.0)
            b = torch.argmax(score)
            bests.append((k, score[b], b))
        best_v, g = merge.merge(bests)
        found = (best_v >= 0.0) & pod.pod_valid[i]
        owner, b = divmod(g, per)
        if owner in state:
            v, _rnp, _rpr, requested, dnp, dpr = state[owner]
            fnd = found.to(f32)
            requested[b] = requested[b] + fnd * req
            dnp[b] = dnp[b] + fnd * est
            if prod_mode:
                dpr[b] = dpr[b] + fnd * (
                    torch.where(is_prod_i, 1.0, 0.0) * est)
        chosen[i] = torch.where(found, torch.tensor(g, dtype=torch.int32),
                                -1)
    spec = _node_axis_spec(mesh, flat=True)
    shards = [state[k][3] if k in state else None for k in range(mesh.size)]
    return replicate(chosen, mesh), from_shards(shards, mesh, spec)


def build_sharded_score_matrix(args: LoadAwareArgs, mesh: Mesh):
    """The one-shot [P, N] (feasible, score) over the 2-D mesh: each shard
    computes its (pod block, node block) from its inputs; both outputs are
    sharded P("pods", "nodes")."""
    fn = build_score_matrix(args)

    def step(inputs: ScheduleInputs):
        feas, score = [], []
        for k in range(mesh.size):
            if not mesh.local(k):
                feas.append(None)
                score.append(None)
                continue
            view = ScheduleInputs(*(x.shards[k] for x in inputs))
            f, s = fn(view)
            feas.append(f)
            score.append(s)
        shape = (inputs.fit_requests.shape[0], inputs.allocatable.shape[0])
        out = NamedSharding(mesh, P("pods", "nodes"))
        return ShardedTensor(feas, shape, out), ShardedTensor(score, shape,
                                                              out)

    return step


__all__ = [
    "MeshDevice", "Mesh", "NamedSharding", "PartitionSpec", "ShardedTensor",
    "build_sharded_schedule_step", "card_view",
    "build_sharded_score_matrix", "make_mesh", "merge_readback",
    "mesh_from_env", "mesh_row_layout", "pad_for_sharding", "put_on_mesh",
    "shard_inputs_2d", "shard_inputs_nodewise", "surviving_submesh",
    "visible_devices",
]
