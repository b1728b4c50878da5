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

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # XLA does not contract a*b+c into an FMA; nvcc does by default
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def safe_reciprocal(cap: torch.Tensor) -> torch.Tensor:
    """f32 1/cap with 0 for cap <= 0. The balanced-allocation score computes
    f = min(used * safe_reciprocal(cap), 1) in every implementation, so
    bit-parity holds while the per-pod division rows disappear."""
    return torch.where(cap > 0, 1.0 / torch.where(cap > 0, cap, 1.0), 0.0)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


_LIBS: Dict[str, ctypes.CDLL] = {}
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
        raise RuntimeError("\n".join(failed))
    return outs


def load_library(source: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<source>, built on first use."""
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


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Tuple[int, ...]) -> int:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``; returns its data pointer for a kernel launch."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
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
