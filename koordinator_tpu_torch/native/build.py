"""Build the port's native sources into build/native/ at first use.

Each output's name carries a digest of its sources and flags, so an edited
source never loads a stale build; a build writes a temporary file and
renames it into place, so two processes building at once cannot tear it,
and one lock keeps a process's threads from building the same output
twice. A failed build raises NativeBuildError with the compiler's output.

    libkoordfloor-<digest>.so     g++ -O2 -fPIC -shared -ffp-contract=off
                                  -fno-fast-math serial_floor.cpp
    libkoordperf-<digest>.so      g++ -O2 -fPIC -shared perf_reader.cpp
    koord_sidecar_client-<digest> protoc --cpp_out of scheduler/sidecar.proto,
                                  then g++ sidecar_client.cpp sidecar.pb.cc
                                  -lprotobuf
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

NATIVE_DIR = Path(__file__).resolve().parent
PROTO = NATIVE_DIR.parent / "scheduler" / "sidecar.proto"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

# The serial floor must be bit-exact against the numpy float32 oracle: no
# FMA contraction, no fast-math reassociation.
FLOOR_FLAGS = ("-O2", "-fPIC", "-Wall", "-shared", "-ffp-contract=off",
               "-fno-fast-math")
PERF_FLAGS = ("-O2", "-fPIC", "-Wall", "-shared")
CLIENT_FLAGS = ("-O2", "-Wall")

_BUILD_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    """A native source could not be built: the tool is missing or failed
    (the message carries its output)."""


def digest(paths: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(repr(tuple(flags)).encode())
    return h.hexdigest()[:16]


def _run(cmd: Sequence[str], what: str, timeout: int = 300) -> None:
    if shutil.which(cmd[0]) is None:
        raise NativeBuildError(f"{what}: {cmd[0]} not found")
    proc = subprocess.run(list(cmd), capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"{what} failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")


def _build_library(stem: str, source: Path, flags: Sequence[str],
                   build_dir: Path) -> Path:
    """build_dir/<stem>-<digest>.so from ``source``, compiled unless it
    exists."""
    out = build_dir / f"{stem}-{digest([source], flags)}.so"
    with _BUILD_LOCK:
        if not out.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = build_dir / f"{out.name}.{os.getpid()}.tmp"
            _run(["g++", *flags, "-o", str(tmp), str(source)],
                 f"building {source.name}")
            os.replace(tmp, out)
    return out


def build_floor(source: Path = NATIVE_DIR / "serial_floor.cpp",
                build_dir: Path = BUILD_DIR) -> Path:
    """build/native/libkoordfloor-<digest>.so from ``source``."""
    return _build_library("libkoordfloor", source, FLOOR_FLAGS, build_dir)


def build_perf(source: Path = NATIVE_DIR / "perf_reader.cpp",
               build_dir: Path = BUILD_DIR) -> Path:
    """build/native/libkoordperf-<digest>.so from ``source``: the perf
    counter reader of the koordlet's CPI collector (native/perf.py)."""
    return _build_library("libkoordperf", source, PERF_FLAGS, build_dir)


def build_sidecar_client(build_dir: Path = BUILD_DIR) -> Path:
    """build/native/koord_sidecar_client-<digest>: the C++ sidecar client
    over ``protoc --cpp_out`` of the port's sidecar.proto, compiled unless
    it exists. Needs protoc, g++ and the libprotobuf headers and library."""
    source = NATIVE_DIR / "sidecar_client.cpp"
    out = build_dir / (
        f"koord_sidecar_client-{digest([source, PROTO], CLIENT_FLAGS)}")
    with _BUILD_LOCK:
        if not out.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=build_dir) as gen:
                _run(["protoc", f"--cpp_out={gen}", f"-I{PROTO.parent}",
                      str(PROTO)], "generating sidecar.pb.cc")
                tmp = build_dir / f"{out.name}.{os.getpid()}.tmp"
                _run(["g++", *CLIENT_FLAGS, f"-I{gen}", "-o", str(tmp),
                      str(source), os.path.join(gen, "sidecar.pb.cc"),
                      "-lprotobuf"], "building sidecar_client.cpp")
                os.replace(tmp, out)
    return out
