"""Shared pieces of the port's hand-written kernels.

Counterpart of koordinator_tpu/ops/pallas_common.py. The device-side helpers
live in csrc/kernel_common.cuh; their plain torch forms are here, next to the
build machinery every CUDA kernel of the port uses: `nvcc` compiles a source
of csrc/ into a shared library with a plain C interface, at first use, into
build/kernels/ at the root of the checkout, and `ctypes` loads it. Nothing
is built when a module is imported, so the package imports where there is no
`nvcc` and no card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
IPC_SOURCE = "ipc.cu"  # the mailboxes' CUDA IPC calls (CudaIpc)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # XLA does not contract a*b+c into an FMA; nvcc does by default
    "--fmad=false",
    # compile a source's kernel instances on every core: full_chain.cu's 24
    # instances took 36-39 s in one thread, 19 s split (H100 machine, 8
    # cores, nvcc 12.9)
    "--split-compile=0",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def safe_reciprocal(cap: torch.Tensor) -> torch.Tensor:
    """f32 1/cap with 0 for cap <= 0. The balanced-allocation score computes
    f = min(used * safe_reciprocal(cap), 1) in every implementation, so
    bit-parity holds while the per-pod division rows disappear."""
    return torch.where(cap > 0, 1.0 / torch.where(cap > 0, cap, 1.0), 0.0)


class KernelContractError(RuntimeError):
    """A hand-written kernel could not be built or launched, or its
    wrapper's contract with the C side failed: nvcc missing or failing, a
    struct or shared-memory layout that disagrees with the wrapper, a pod
    record that outgrows a block, any nonzero cudaError of a launch. Not
    a device fault: the scheduler's degradation ladder lets it through
    (scheduler/degrade.py), since no retry and no host pass can fix it."""


def launch_error(what: str, err: int, detail: str) -> KernelContractError:
    """The exception for a nonzero cudaError_t from a launch."""
    return KernelContractError(
        f"{what} launch failed: cudaError {err} ({detail})")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelContractError("nvcc not found: the CUDA kernels build on a "
                              "machine with the CUDA toolkit")


_LIBS: Dict[str, ctypes.CDLL] = {}  # koordlint: guarded-by(_LIBS_LOCK)
# one build-and-load at a time in a process: a background warm-up ladder
# and the cycle thread may both reach a kernel first, and two builds of
# one source would write the same temporary file
_LIBS_LOCK = threading.Lock()
BUILD_LOG: Dict[str, Dict[str, object]] = {}
# Macros every build defines, e.g. ("KOORD_TRACE",) for testing/pod_trace.py;
# set before the first kernel is built.
BUILD_DEFINES: Tuple[str, ...] = ()


def _source_digest(source: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(repr(BUILD_DEFINES).encode())
    return h.hexdigest()[:16]


def build_libraries(*sources: str) -> Dict[str, Path]:
    """Compile each csrc/<source> (with the shared headers) into
    build/kernels/lib<stem>-<digest>.so unless that file exists, one `nvcc`
    per source, all started together. The digest covers the sources, so an
    edited kernel never loads a stale library. Records each build's seconds
    and ptxas report in BUILD_LOG; raises if any build fails."""
    outs: Dict[str, Path] = {}
    running = []
    for source in sources:
        stem = Path(source).stem
        out = BUILD_DIR / f"lib{stem}-{_source_digest(source)}.so"
        outs[source] = out
        if out.exists():
            BUILD_LOG.setdefault(stem, {"seconds": 0.0, "cached": True,
                                        "ptxas": ""})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS,
               *(f"-D{name}" for name in BUILD_DEFINES),
               "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, stem, proc, tmp, out, time.perf_counter()))
    failed = []
    for source, stem, proc, tmp, out, t0 in running:
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source} ({proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[stem] = {"seconds": seconds, "cached": False,
                           "ptxas": log.strip()}
    if failed:
        raise KernelContractError("\n".join(failed))
    return outs


def load_library(source: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<source>, built on first use."""
    # the double-checked fast path: a loaded library is never replaced,
    # and dict.get is atomic under the GIL
    lib = _LIBS.get(source)  # koordlint: disable=unguarded-shared-field
    if lib is None:
        with _LIBS_LOCK:
            lib = _LIBS.get(source)
            if lib is None:
                lib = ctypes.CDLL(str(build_libraries(source)[source]))
                _LIBS[source] = lib
    return lib


# ---------------------------------------------------------------------------
# The cluster design of both rounds (csrc/kernel_common.cuh): one launch is
# one thread-block cluster; each block owns a contiguous slice of the nodes,
# each of its node threads the slice's nodes j = t (mod node_threads); the
# last warp of a block is the control warp. The kernels take the plan from
# here, so the partition below is the one they run.
# ---------------------------------------------------------------------------

CLUSTER_SIZE = 16  # blocks (SMs) per round; the H100 places one such cluster
MAX_NODE_THREADS = 480  # 15 node warps + the control warp = 512 threads
SMEM_BUDGET_BYTES = 232448  # dynamic shared memory a block may take (227 KB)
RING_STAGES = 4  # pod records in flight (kernel_common.cuh kRingStages)

# pod record header and flag bits (kernel_common.cuh kRec*, kPod*)
REC_FLAGS, REC_POD = 0, 1
POD_PROD, POD_DS, POD_VALID, POD_GANG_OK = 1, 2, 4, 8
POD_NUMA, POD_BIND, POD_FULL_PCPUS = 16, 32, 64
# node flag bits (kernel_common.cuh kNode*)
NODE_OK, NODE_SCORE_VALID, NODE_REJECT_NP, NODE_REJECT_PR = 1, 2, 4, 8
NODE_HAS_TOPO = 16


class ClusterPlan(NamedTuple):
    cluster_size: int     # blocks in the cluster
    nodes_per_block: int  # Nb: block b owns [b * Nb, min((b + 1) * Nb, N))
    node_threads: int     # threads of a block that own nodes
    block_threads: int    # node threads + the control warp


def cluster_plan(n_nodes: int,
                 cluster_size: int = CLUSTER_SIZE) -> ClusterPlan:
    """The partition of ``n_nodes`` over a cluster: each block gets
    ceil(N / C) nodes and enough whole warps to give each thread one node
    where that takes at most MAX_NODE_THREADS threads."""
    if cluster_size < 1 or cluster_size > 16:
        raise ValueError(f"cluster size {cluster_size} not in 1..16")
    nb = max(1, -(-int(n_nodes) // cluster_size))
    node_threads = min(MAX_NODE_THREADS, 32 * -(-nb // 32))
    return ClusterPlan(cluster_size, nb, node_threads, node_threads + 32)


def node_owner(n_nodes: int, plan: ClusterPlan):
    """(block[N], thread[N]): the block and the thread that own each node."""
    n = torch.arange(int(n_nodes))
    block = n // plan.nodes_per_block
    thread = (n - block * plan.nodes_per_block) % plan.node_threads
    return block, thread


def blocked_argmax(score: torch.Tensor, plan: ClusterPlan,
                   rank_order=None) -> int:
    """The kernels' argmax, in plain torch: each thread keeps the first best
    of the nodes it owns in ascending order, each warp and then each block
    merges its threads' bests, and the blocks' bests are merged in
    ``rank_order`` (any permutation of the ranks) by the lowest-index rule.
    Returns the index of ``score``'s first maximum, as torch.argmax."""
    block, thread = node_owner(score.shape[0], plan)
    none = (float("-inf"), 2**31 - 1)
    # each thread: a strict compare over its nodes in ascending order
    parts = [[none] * plan.node_threads for _ in range(plan.cluster_size)]
    for n, (b, t) in enumerate(zip(block.tolist(), thread.tolist())):
        if float(score[n]) > parts[b][t][0]:
            parts[b][t] = (float(score[n]), n)
    ranks = range(plan.cluster_size) if rank_order is None else rank_order
    best = none
    for b in ranks:
        for part in parts[b]:
            best = argmax_merge(best, part)
    return best[1]


def argmax_merge(a, b):
    """The lowest-index rule on (score, node) pairs (kernel_common.cuh
    warp_argmax): the higher score, or the lower node on a tie."""
    if b[0] > a[0] or (b[0] == a[0] and b[1] < a[1]):
        return b
    return a


def smem_take(at: int, nbytes: int) -> Tuple[int, int]:
    """(offset, next offset) of a 16-aligned shared-memory region, as
    kernel_common.cuh smem_take."""
    return at, (at + nbytes + 15) & ~15


def f32_words(t: torch.Tensor) -> torch.Tensor:
    """[P, k] float values as their int32 bit patterns."""
    return t.to(torch.float32).contiguous().view(torch.int32)


def words_f32(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous().view(torch.float32)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """[P, T] bool -> [P, ceil(T / 32)] int32: bit t of row p at word t // 32,
    bit t % 32 (kernel_common.cuh bit_at)."""
    P, T = mask.shape
    nw = -(-T // 32)
    padded = torch.zeros((P, nw * 32), dtype=torch.int64, device=mask.device)
    padded[:, :T] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (padded.view(P, nw, 32) << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(words: torch.Tensor, T: int) -> torch.Tensor:
    """Inverse of pack_bits."""
    P = words.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(P, -1)[:, :T].to(torch.bool)


def valid_first(records: torch.Tensor, valid: torch.Tensor):
    """(records with the valid pods first, in queue order; their count as a
    [1] int32 tensor). No host sync: the kernel reads the count itself."""
    order = torch.argsort((~valid.to(torch.bool)).to(torch.int8), stable=True)
    n_valid = valid.to(torch.int32).sum().reshape(1).to(torch.int32)
    return records.index_select(0, order).contiguous(), n_valid


def choose_state(smem_bytes: int, smem_budget_bytes=None) -> str:
    """"smem" when the shared-memory layout fits the budget (the card's
    227 KB per block when None), else "global": the same kernel with its
    carried state in device memory. Reads sizes only."""
    budget = SMEM_BUDGET_BYTES if smem_budget_bytes is None \
        else int(smem_budget_bytes)
    return "smem" if smem_bytes <= budget else "global"


class SyncClock:
    """Seconds between synchronised points of a call, into ``timings`` when
    it is a dict; with None it does nothing, and never synchronises."""

    def __init__(self, timings=None, device=None):
        self.timings = timings
        self.cuda = device is None or torch.device(device).type == "cuda"
        self.t0 = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.timings[name] = now - self.t0
        self.t0 = now

    def restart(self) -> None:
        self.t0 = time.perf_counter()


def launch_device(*tensors) -> torch.device:
    """The one CUDA device every given tensor (None skipped) lies on: a
    kernel launches there. Raises for tensors on different devices."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"a launch takes tensors on one device, got "
                         f"{sorted(str(d) for d in devs)}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


@contextlib.contextmanager
def on_device(dev: torch.device):
    """The block with ``dev`` as the current CUDA device: a launch sets its
    shared-memory attribute, checks its occupancy and runs there."""
    with torch.cuda.device(dev):
        yield


# ---------------------------------------------------------------------------
# The exchange between the shards of a mesh of cards (csrc/kernel_common.cuh
# "The exchange"): one mailbox per shard on its card, [2 parities][D
# senders][entry_pairs] int64 pairs, each pair one 32-bit payload word (low
# half) under the exchange's 32-bit flag (high half), written by one 64-bit
# store; a table of every shard's mailbox address on each card; an error
# word per card, where a launch leaves the bits of the shards whose entries
# never arrived.
# ---------------------------------------------------------------------------

MAX_LOCAL_SHARDS = 8   # clusters of one launch (kMaxLocalShards)
MAX_SHARDS = 32        # shards of a mesh of cards (kMaxShards)
EXCHANGE_TIMEOUT_S = 2.0  # the wait for one exchange before the round ends
MAX_FLAG = 2**32 - 1   # flags are 32-bit and never 0


class _Xchg(ctypes.Structure):
    """Mirror of koord::Xchg in csrc/kernel_common.cuh, field for field."""

    _fields_ = [("boxes", ctypes.c_void_p), ("err", ctypes.c_void_p),
                ("timeout_ns", ctypes.c_longlong), ("flag0", ctypes.c_uint),
                ("D", ctypes.c_int), ("L", ctypes.c_int), ("per", ctypes.c_int),
                ("entry_pairs", ctypes.c_int),
                ("shard", ctypes.c_int * MAX_LOCAL_SHARDS)]


def exchange_pairs(payload_words: int) -> int:
    """8-byte pairs an exchange of ``payload_words`` words stores and reads:
    one per word, rounded up to an even count for the 16-byte loads
    (kernel_common.cuh xpairs); also the entry width of a mailbox whose
    widest exchange has that payload."""
    return (int(payload_words) + 1) & ~1


def mailbox_shape(n_shards: int, payload_words: int) -> Tuple[int, int, int]:
    """[parities, senders, pairs] of one shard's mailbox."""
    return (2, int(n_shards), exchange_pairs(payload_words))


class ExchangeTimeout(RuntimeError):
    """An exchange launch ended because entries of some shards never
    arrived within the time limit: their cards are lost or never launched.
    A device fault (scheduler/degrade.is_device_fault) naming those shards'
    mesh devices in ``failed_device_ids``, so the ladder runs the surviving
    submesh."""

    def __init__(self, what: str, failed_shards: Sequence[int],
                 failed_device_ids: Sequence[int]) -> None:
        self.failed_shards = tuple(int(k) for k in failed_shards)
        self.failed_device_ids = tuple(int(i) for i in failed_device_ids)
        super().__init__(
            f"{what}: no entry from shard(s) {list(self.failed_shards)} "
            f"(mesh devices {list(self.failed_device_ids)}) within the "
            "exchange's time limit")


class CudaIpc:
    """The CUDA calls of mailboxes that several processes share
    (csrc/ipc.cu), each on the given card; each raises KernelContractError
    on a nonzero cudaError. Mailboxes reach them through the module's
    ``IPC``, which the CPU tests replace by a stand-in."""

    def _lib(self) -> ctypes.CDLL:
        lib = load_library(IPC_SOURCE)
        if not getattr(lib, "_koord_bound", False):
            P, PP = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
            for name, args in (
                    ("koord_ipc_alloc", [ctypes.c_longlong, PP]),
                    ("koord_ipc_free", [P]), ("koord_ipc_export", [P, P]),
                    ("koord_ipc_open", [P, PP]), ("koord_ipc_close", [P]),
                    ("koord_ipc_zero", [P, ctypes.c_longlong]),
                    ("koord_pci_bus_id", [ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_int])):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = args
            lib.koord_ipc_handle_bytes.restype = ctypes.c_int
            lib._koord_bound = True
        return lib

    def _call(self, what: str, device: torch.device, fn, *args) -> None:
        with on_device(device):
            err = fn(*args)
        if err != 0:
            raise KernelContractError(
                f"{what} on {device} failed: cudaError {err}")

    def alloc(self, device: torch.device, nbytes: int) -> int:
        """``nbytes`` of device memory on ``device``, zeroed: its address."""
        ptr = ctypes.c_void_p()
        self._call("cudaMalloc of a mailbox", device,
                   self._lib().koord_ipc_alloc, int(nbytes),
                   ctypes.byref(ptr))
        return int(ptr.value)

    def free(self, device: torch.device, ptr: int) -> None:
        self._call("cudaFree of a mailbox", device, self._lib().koord_ipc_free,
                   ctypes.c_void_p(ptr))

    def export(self, device: torch.device, ptr: int) -> bytes:
        lib = self._lib()
        out = ctypes.create_string_buffer(lib.koord_ipc_handle_bytes())
        self._call("cudaIpcGetMemHandle", device, lib.koord_ipc_export,
                   ctypes.c_void_p(ptr), out)
        return out.raw

    def open(self, device: torch.device, handle: bytes) -> int:
        """Another process's allocation mapped for ``device``: its address
        here (peer access turned on where it lies on another card)."""
        ptr = ctypes.c_void_p()
        buf = ctypes.create_string_buffer(bytes(handle), len(handle))
        self._call("cudaIpcOpenMemHandle of another process's mailbox",
                   device, self._lib().koord_ipc_open, buf,
                   ctypes.byref(ptr))
        return int(ptr.value)

    def close(self, device: torch.device, ptr: int) -> None:
        self._call("cudaIpcCloseMemHandle", device,
                   self._lib().koord_ipc_close, ctypes.c_void_p(ptr))

    def zero(self, device: torch.device, ptr: int, nbytes: int) -> None:
        """``nbytes`` at ``ptr`` zeroed after the card's queued work, and
        the zeroing finished."""
        self._call("zeroing a mailbox", device, self._lib().koord_ipc_zero,
                   ctypes.c_void_p(ptr), int(nbytes))

    def bus_id(self, device: torch.device) -> str:
        """The card's PCI bus id, as every process names it."""
        out = ctypes.create_string_buffer(32)
        self._call("cudaDeviceGetPCIBusId", device,
                   self._lib().koord_pci_bus_id, int(device.index), out, 32)
        return out.value.decode()


IPC = CudaIpc()


def _dist():
    import torch.distributed as dist

    return dist


class _Box(NamedTuple):
    """One shard's mailbox in the process that holds the shard: its card,
    its address, and the tensor that holds it (a mesh of one process) or
    None (cudaMalloc'd for CUDA IPC; IPC.free frees it)."""

    device: torch.device
    address: int
    tensor: Optional[torch.Tensor]


class Mailboxes:
    """The exchange's buffers for one mesh of cards: ``devices[k]`` the
    card of shard k, ``device_ids[k]`` its mesh device id, ``processes[k]``
    the process (torch.distributed rank) that holds it (default: all this
    one). Buffers are made at first use and grown for a wider payload. The
    flags count up from launch group to launch group (``next_seq``, the
    next group's first flag) and are never 0; a group whose flags would
    pass MAX_FLAG first zeroes every mailbox, waits for that on each card,
    and starts the count again at 1, so no stale entry can hold a flag
    still to come. One launch group runs at a time on a mesh's mailboxes
    (the Scheduler's cycle thread; warm-up only builds mesh steps): two at
    once would overwrite each other's entries and time out.

    ``boxes`` holds this process's shards' mailboxes, one record a shard:
    tensors in a mesh of one process. Across processes (``spans``) each
    process allocates its own shards' mailboxes with cudaMalloc (``IPC``)
    instead, exports their handles, gathers
    every other process's over the default process group (gloo) and maps
    them for each of its cards; its cards' tables list every shard's
    mailbox at the addresses mapped here. Then ``ensure``, ``restart`` and
    ``check`` are collective: every process calls them at the same point,
    as every process runs the same launch groups. ``begin`` gives every
    process the same first flag by construction (the same groups, the
    same restarts). ``close`` (collective too) unmaps and frees them."""

    def __init__(self, devices: Sequence[torch.device],
                 device_ids: Sequence[int],
                 processes: Optional[Sequence[int]] = None) -> None:
        if not 1 <= len(devices) <= MAX_SHARDS:
            raise ValueError(f"a mesh of cards holds 1..{MAX_SHARDS} "
                             f"shards, got {len(devices)}")
        self.devices = [torch.device(d) for d in devices]
        self.device_ids = [int(i) for i in device_ids]
        self.processes = ([0] * len(self.devices) if processes is None
                          else [int(p) for p in processes])
        self.spans = len(set(self.processes)) > 1
        self.rank = (_dist().get_rank() if self.spans
                     else self.processes[0])
        self.entry_pairs = 0
        # this process's shards' mailboxes, and (card, address) of every
        # mapping of another process's
        self.boxes: Dict[int, _Box] = {}
        self.opened: List[Tuple[torch.device, int]] = []
        self.tables: Dict[torch.device, torch.Tensor] = {}
        self.errs: Dict[torch.device, torch.Tensor] = {}
        self.next_seq = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    def cards(self) -> Dict[torch.device, List[int]]:
        """Each card of this process, with its shards in shard order."""
        out: Dict[torch.device, List[int]] = {}
        for k, d in enumerate(self.devices):
            if self.processes[k] == self.rank:
                out.setdefault(d, []).append(k)
        return out

    def _box_bytes(self) -> int:
        return 2 * self.size * self.entry_pairs * 8

    def ensure(self, payload_words: int) -> None:
        """Mailboxes wide enough for ``payload_words``: grown (and the
        tables and error words made anew) where they are narrower.
        Across processes each process makes its own shards' boxes,
        gathers every process's handles (no launch of an earlier group
        runs anywhere past this point), releases the old boxes and maps
        the others' new ones for each of its cards."""
        pairs = exchange_pairs(payload_words)
        if pairs <= self.entry_pairs:
            return
        nbytes = 2 * self.size * pairs * 8
        cards = self.cards()
        if self.spans:
            new = {k: _Box(d, IPC.alloc(d, nbytes), None)
                   for d, ks in cards.items() for k in ks}
            dist = _dist()
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, {
                k: IPC.export(b.device, b.address) for k, b in new.items()})
            self._release()
            theirs = {k: h for part in every for k, h in part.items()
                      if k not in new}
        else:
            shape = mailbox_shape(self.size, payload_words)
            new = {}
            for k, d in enumerate(self.devices):
                t = torch.zeros(shape, dtype=torch.int64, device=d)
                new[k] = _Box(d, t.data_ptr(), t)
            theirs = {}
        if sorted(list(theirs) + list(new)) != list(range(self.size)):
            raise KernelContractError(
                f"the processes' mailboxes cover shards "
                f"{sorted(list(theirs) + list(new))}, not 0..{self.size - 1}")
        self.boxes = new
        for card in cards:
            ptrs = []
            for k in range(self.size):
                if k in new:
                    ptrs.append(new[k].address)
                    continue
                p = IPC.open(card, theirs[k])
                self.opened.append((card, p))
                ptrs.append(p)
            self.tables[card] = torch.tensor(ptrs, dtype=torch.int64,
                                             device=card)
        self.errs = {d: torch.zeros(1, dtype=torch.int32, device=d)
                     for d in cards}
        self.entry_pairs = pairs

    def _release(self) -> None:
        """Drop this process's mailboxes; across processes, close its
        mappings of the others' first, wait until every process has
        closed its own, then free its cudaMalloc'd boxes."""
        for card, p in self.opened:
            IPC.close(card, p)
        self.opened = []
        if self.spans:
            _dist().barrier()
        for b in self.boxes.values():
            if b.tensor is None:
                IPC.free(b.device, b.address)
        self.boxes = {}

    def close(self) -> None:
        """Unmap and free the mailboxes (collective across processes); the
        next exchange makes them again."""
        if self.entry_pairs:
            self._release()
            self.tables, self.errs = {}, {}
            self.entry_pairs = 0
            self.next_seq = 1

    def begin(self, exchanges: int) -> int:
        """The first flag of a launch group that runs at most
        ``exchanges`` exchanges (flags flag0 .. flag0 + exchanges - 1, all
        in 1..MAX_FLAG); the error words start at 0."""
        exchanges = int(exchanges)
        if exchanges + 1 > MAX_FLAG:
            raise ValueError(f"{exchanges} exchanges do not fit the 32-bit "
                             "flags of one launch group")
        if self.next_seq + exchanges > MAX_FLAG:
            self.restart()
        flag0 = self.next_seq
        self.next_seq += exchanges + 1
        for e in self.errs.values():
            e.zero_()
        return flag0

    def restart(self) -> None:
        """Zero every mailbox and start the flags again at 1. Every card
        is synchronised after its zeroing, so no launch of the next group
        (whose writes reach other cards' mailboxes) runs before every
        mailbox is clean; the last group's launches have all ended by
        then, as each card's zeroing is queued after its own. Across
        processes a barrier comes first (every process's last group has
        ended) and one last (every mailbox is clean)."""
        if self.spans:
            _dist().barrier()
        for b in self.boxes.values():
            if b.tensor is None:
                IPC.zero(b.device, b.address, self._box_bytes())
            else:
                b.tensor.zero_()
        for d in self.cards():
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        if self.spans:
            _dist().barrier()
        self.next_seq = 1

    def xchg(self, card: torch.device, shards: Sequence[int], per: int,
             flag0: int) -> _Xchg:
        """The koord::Xchg of ``card``'s launch over its ``shards``, its
        first flag ``flag0`` (begin's)."""
        x = Mailboxes.local(self.size, shards, per)
        x.boxes = self.tables[card].data_ptr()
        x.err = self.errs[card].data_ptr()
        x.flag0 = int(flag0)
        x.timeout_ns = int(EXCHANGE_TIMEOUT_S * 1e9)
        x.entry_pairs = self.entry_pairs
        return x

    @staticmethod
    def local(n_shards: int, shards: Sequence[int], per: int) -> _Xchg:
        """The koord::Xchg of a launch over ``shards`` with no mailboxes
        yet."""
        if not 1 <= len(shards) <= MAX_LOCAL_SHARDS:
            raise ValueError(f"a launch runs 1..{MAX_LOCAL_SHARDS} shards, "
                             f"got {len(shards)}")
        x = _Xchg()
        x.D, x.L, x.per = int(n_shards), len(shards), int(per)
        for j, k in enumerate(shards):
            x.shard[j] = int(k)
        return x

    def check(self, what: str) -> None:
        """Read every card's error word (a sync on each card) and raise
        ExchangeTimeout naming the shards that never arrived; across
        processes the shards any process missed (a gloo MAX over a [D]
        0/1 vector), so every process raises the same."""
        missing = 0
        for e in self.errs.values():
            missing |= int(e.item()) & 0xFFFFFFFF
        if self.spans:
            dist = _dist()
            bits = torch.tensor([missing >> k & 1 for k in range(self.size)],
                                dtype=torch.int32)
            dist.all_reduce(bits, op=dist.ReduceOp.MAX)
            missing = sum(int(b) << k for k, b in enumerate(bits.tolist()))
        if missing:
            shards = [k for k in range(self.size) if missing >> k & 1]
            raise ExchangeTimeout(what, shards,
                                  [self.device_ids[k] for k in shards])


def metadata_only():
    """A block that reads tensors' own metadata (shape, dtype, strides,
    device, data pointer) with __torch_function__ off: a launch reads raw
    storage, so no tensor subclass or function mode may stand between it
    and what the tensor is, and none of these reads dispatches an op."""
    return torch._C.DisableTorchFunction()


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Tuple[int, ...]) -> int:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``; returns its data pointer for a kernel launch. Reads
    metadata only (metadata_only)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    with metadata_only():
        return _check_meta(name, t, dtype, shape)


def _check_meta(name: str, t: torch.Tensor, dtype: torch.dtype,
                shape: Tuple[int, ...]) -> int:
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one on "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()
