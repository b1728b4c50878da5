"""Core-scheduling cookie interface (prctl PR_SCHED_CORE).

Analog of reference `pkg/koordlet/util/system/core_sched.go` +
`core_sched_linux.go`: assign SMT-core-scheduling cookies so tasks of
different trust domains (e.g. BE vs LS pods) never share a physical core's
hyperthreads simultaneously.

Two implementations behind one interface:
  * `SystemCoreSched` — real prctl(2) via ctypes (PR_SCHED_CORE=62), used on
    kernels >= 5.14 with CONFIG_SCHED_CORE
  * `FakeCoreSched` — in-memory cookie table for tests and non-Linux hosts

The runtimehooks `coresched` hook drives this: new BE container -> create a
cookie on its first task, share it to the rest of the pod's tasks.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Dict, List, Optional

# prctl constants (linux/prctl.h)
PR_SCHED_CORE = 62
PR_SCHED_CORE_GET = 0
PR_SCHED_CORE_CREATE = 1
PR_SCHED_CORE_SHARE_TO = 2
PR_SCHED_CORE_SHARE_FROM = 3

PIDTYPE_PID = 0
PIDTYPE_TGID = 1
PIDTYPE_PGID = 2


class CoreSchedInterface:
    def supported(self) -> bool:
        raise NotImplementedError

    def get_cookie(self, pid: int) -> Optional[int]:
        raise NotImplementedError

    def create_cookie(self, pid: int, pid_type: int = PIDTYPE_PID) -> bool:
        """Assign a fresh random cookie to pid (kernel generates the value)."""
        raise NotImplementedError

    def share_from(self, from_pid: int, to_pids: List[int]) -> List[int]:
        """Copy from_pid's cookie onto each of to_pids; returns pids that failed."""
        raise NotImplementedError

    def clear_cookie(self, pid: int) -> bool:
        raise NotImplementedError


class SystemCoreSched(CoreSchedInterface):
    """prctl(2)-backed cookies. Degrades to unsupported on any failure."""

    def __init__(self) -> None:
        self._libc = None
        try:
            libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
            libc.prctl  # symbol lookup raises on non-Linux libc
            self._libc = libc
        except (OSError, AttributeError, TypeError):
            self._libc = None

    def _prctl(self, op: int, pid: int, pid_type: int, arg: int) -> int:
        if self._libc is None:
            return -1
        return self._libc.prctl(
            PR_SCHED_CORE, ctypes.c_ulong(op), ctypes.c_ulong(pid),
            ctypes.c_ulong(pid_type), ctypes.c_ulong(arg))

    def supported(self) -> bool:
        if self._libc is None:
            return False
        # PR_SCHED_CORE_GET on self: ENOMEM/EINVAL on old kernels, 0 on new
        cookie = ctypes.c_ulong(0)
        try:
            rc = self._libc.prctl(
                PR_SCHED_CORE, PR_SCHED_CORE_GET, 0, PIDTYPE_PID,
                ctypes.byref(cookie))
        except (OSError, ctypes.ArgumentError):
            return False
        return rc == 0

    def get_cookie(self, pid: int) -> Optional[int]:
        if self._libc is None:
            return None
        cookie = ctypes.c_ulong(0)
        rc = self._libc.prctl(
            PR_SCHED_CORE, PR_SCHED_CORE_GET, pid, PIDTYPE_PID,
            ctypes.byref(cookie))
        return int(cookie.value) if rc == 0 else None

    def create_cookie(self, pid: int, pid_type: int = PIDTYPE_PID) -> bool:
        return self._prctl(PR_SCHED_CORE_CREATE, pid, pid_type, 0) == 0

    def share_from(self, from_pid: int, to_pids: List[int]) -> List[int]:
        """SHARE_TO pushes the *calling task's* cookie onto a target, so the
        copy must run on a helper task that first pulls from_pid's cookie via
        SHARE_FROM (the reference's dedicated-thread dance). Python threads
        are distinct kernel tasks, so a short-lived thread serves as the
        helper without disturbing the agent's own (zero) cookie."""
        import threading

        failed: List[int] = list(to_pids)

        def _dance() -> None:
            if self._prctl(PR_SCHED_CORE_SHARE_FROM, from_pid, PIDTYPE_PID, 0) != 0:
                return
            failed.clear()
            for pid in to_pids:
                if self._prctl(PR_SCHED_CORE_SHARE_TO, pid, PIDTYPE_PID, 0) != 0:
                    failed.append(pid)

        t = threading.Thread(target=_dance, name="coresched-share")
        t.start()
        t.join()
        return failed

    def clear_cookie(self, pid: int) -> bool:
        """Push the agent's own zero cookie onto pid (SHARE_TO from a
        clean task clears); the koordlet main thread never takes a cookie."""
        return self._prctl(PR_SCHED_CORE_SHARE_TO, pid, PIDTYPE_PID, 0) == 0


class FakeCoreSched(CoreSchedInterface):
    """Deterministic in-memory cookie table (test double)."""

    def __init__(self) -> None:
        self.cookies: Dict[int, int] = {}
        self._next = 1

    def supported(self) -> bool:
        return True

    def get_cookie(self, pid: int) -> Optional[int]:
        return self.cookies.get(pid, 0)

    def create_cookie(self, pid: int, pid_type: int = PIDTYPE_PID) -> bool:
        self.cookies[pid] = self._next
        self._next += 1
        return True

    def share_from(self, from_pid: int, to_pids: List[int]) -> List[int]:
        src = self.cookies.get(from_pid)
        if src is None:
            return list(to_pids)
        for pid in to_pids:
            self.cookies[pid] = src
        return []

    def clear_cookie(self, pid: int) -> bool:
        self.cookies[pid] = 0
        return True


def default_interface() -> CoreSchedInterface:
    """The real prctl interface. Callers must check supported() and degrade
    explicitly — substituting the in-memory fake here would report phantom
    isolation success on kernels without PR_SCHED_CORE. Tests use
    FakeCoreSched directly."""
    return SystemCoreSched()
