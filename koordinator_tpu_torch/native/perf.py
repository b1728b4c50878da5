"""ctypes binding for the native perf counter reader (libkoordperf).

Python side of the reference's libpfm4 cgo component (perf_group_linux.go):
opens a cycles+instructions group per cgroup (or the current process), reads
cumulative counters, computes CPI. The library is built from the tracked
``perf_reader.cpp`` into build/native/ at first use (native/build.py, keyed
by digest); a failed build raises ``NativeBuildError``. Where the kernel
denies perf_event_open (containers commonly set perf_event_paranoid),
`available()` is False and the CPI collector stays off, matching the
Libpfm4/CPICollector feature-gate behavior."""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Tuple

from koordinator_tpu_torch.native.build import build_perf

_lib: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()  # one build and load of _lib per process


def build() -> Path:
    """The library's path under build/native/, compiled unless it exists.
    Raises NativeBuildError when the compiler is missing or fails."""
    return build_perf()


def _load() -> ctypes.CDLL:
    """The loaded library, built at first use. Raises when it cannot be
    built or loaded: a missing library is a fault, not a host policy."""
    global _lib
    with _LOAD_LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.koordperf_open_group.restype = ctypes.c_long
        lib.koordperf_open_group.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.koordperf_read.restype = ctypes.c_int
        lib.koordperf_read.argtypes = [
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.koordperf_close.restype = None
        lib.koordperf_close.argtypes = [ctypes.c_long]
        _lib = lib
        return lib


class PerfGroup:
    """One cycles+instructions counter group."""

    def __init__(self, handle: int):
        self._handle = handle

    @staticmethod
    def open_self(cpu: int = -1) -> Optional["PerfGroup"]:
        """Counters for the current process (any cpu); None where the
        kernel denies perf events."""
        handle = _load().koordperf_open_group(0, cpu, 0)
        return PerfGroup(handle) if handle > 0 else None

    @staticmethod
    def open_cgroup(cgroup_dir: str, cpu: int = 0) -> Optional["PerfGroup"]:
        """Counters for a cgroup (per-cpu, as perf requires for cgroup mode)."""
        lib = _load()
        try:
            fd = os.open(cgroup_dir, os.O_RDONLY)
        except OSError:
            return None
        handle = lib.koordperf_open_group(fd, cpu, 1)
        os.close(fd)
        return PerfGroup(handle) if handle > 0 else None

    def read(self) -> Optional[Tuple[int, int]]:
        """(cycles, instructions), cumulative since open."""
        if self._handle <= 0:
            return None
        lib = _load()
        cycles = ctypes.c_uint64()
        instructions = ctypes.c_uint64()
        rc = lib.koordperf_read(
            self._handle, ctypes.byref(cycles), ctypes.byref(instructions)
        )
        if rc != 0:
            return None
        return cycles.value, instructions.value

    def cpi(self) -> Optional[float]:
        sample = self.read()
        if not sample or sample[1] == 0:
            return None
        return sample[0] / sample[1]

    def close(self) -> None:
        if self._handle > 0:
            _load().koordperf_close(self._handle)
            self._handle = 0


def available() -> bool:
    """True when the kernel permits perf events. Builds and loads the
    library first, and raises when that fails."""
    g = PerfGroup.open_self()
    if g is None:
        return False
    ok = g.read() is not None
    g.close()
    return ok


class CgroupPerfReader:
    """Per-pod CPI sampler used by the performance collector
    (metricsadvisor.collect_performance): one perf group per pod cgroup,
    per-tick (cycles, instructions) deltas. `gc(live_keys)` closes groups for
    departed pods — without it, pod churn leaks perf-event fds until EMFILE."""

    def __init__(self, config):
        self.config = config
        self.groups = {}
        self.last = {}

    def __call__(self, pod):
        from koordinator_tpu_torch.koordlet.metricsadvisor import pod_qos_dir

        rel = self.config.pod_relative_path(
            pod_qos_dir(pod), pod.meta.uid or pod.meta.name
        )
        path = self.config.cgroup_file_path(rel, "cpu.max")
        cgroup_dir = os.path.dirname(path)
        key = pod.meta.key
        if key not in self.groups:
            g = PerfGroup.open_cgroup(cgroup_dir)
            if g is None:
                return None
            self.groups[key] = g
        sample = self.groups[key].read()
        if sample is None:
            return None
        prev = self.last.get(key, (0, 0))
        self.last[key] = sample
        return (sample[0] - prev[0], sample[1] - prev[1])

    def gc(self, live_keys) -> None:
        live = set(live_keys)
        for key in list(self.groups):
            if key not in live:
                self.groups.pop(key).close()
                self.last.pop(key, None)

    def close(self) -> None:
        self.gc(())


def build_cgroup_perf_reader(config):
    """CgroupPerfReader, or None when perf is unusable on this host."""
    if not available():
        return None
    return CgroupPerfReader(config)
