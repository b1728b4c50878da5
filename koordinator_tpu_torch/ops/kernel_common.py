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
from typing import Dict, Tuple

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


def _source_digest(source: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
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
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / source)]
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
