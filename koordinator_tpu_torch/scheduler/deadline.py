"""Dispatch deadline watchdog: bound the device window in wall time.

A dead device raises and the degradation ladder (scheduler/degrade.py)
absorbs it. A SLOW-not-dead device is worse: the readback
``block_until_ready`` simply never returns, nothing raises, and the
whole scheduling cycle wedges behind a single sick chip — the failure
mode ROADMAP calls out for the fault catalog. ``KOORD_TPU_CYCLE_
DEADLINE_MS`` cannot help (it fires AFTER the cycle completes, which a
hung sync never does).

``DeadlineWatchdog.run(fn, path)`` executes the designated blocking
readback ``fn`` on a worker thread and waits ``deadline_seconds``:

  * in time -> the result (or the worker's exception) passes through
    unchanged, same thread-visible semantics as calling ``fn`` inline;
  * overrun -> the overrun callback fires (metrics + flight dump) and
    :class:`DispatchDeadlineExceeded` raises into the dispatch window,
    where the ladder treats it exactly like a raised device fault —
    retry once, then demote. The worker keeps draining the slow sync in
    the background; the owner must ABANDON the device state it was
    syncing (the scheduler rebuilds its DeviceSnapshot; the shared
    rebalance mirror leaves its dispatch window open so donation never
    re-arms under the still-running program) instead of blocking on it.

With no deadline configured (the default) ``run`` calls ``fn`` inline —
zero threads, zero overhead, byte-identical behavior.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class DispatchDeadlineExceeded(RuntimeError):
    """A monitored device sync overran its deadline. Raised into the
    dispatch window strictly before any binding of that window applies,
    so the ladder may retry/demote; carries the path label for the
    ``koord_scheduler_dispatch_deadline_overruns_total`` counter."""

    def __init__(self, path: str, deadline_seconds: float) -> None:
        super().__init__(
            f"{path} dispatch exceeded the "
            f"{deadline_seconds * 1000.0:.0f}ms device deadline")
        self.path = path
        self.deadline_seconds = deadline_seconds


def dispatch_deadline_from_env() -> Optional[float]:
    """KOORD_TPU_DISPATCH_DEADLINE_MS=N bounds every device window
    (serial, fused/chained waves, mesh merge, the rebalance pass) in
    wall time; an overrun demotes the ladder instead of wedging the
    cycle. Unset/0 disables (the default). Distinct from
    KOORD_TPU_CYCLE_DEADLINE_MS, which is dump-only and measures the
    COMPLETED cycle. Returns seconds or None."""
    raw = os.environ.get("KOORD_TPU_DISPATCH_DEADLINE_MS", "").strip()
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        logger.warning("KOORD_TPU_DISPATCH_DEADLINE_MS=%r not a number; "
                       "dispatch deadline off", raw)
        return None
    return ms / 1000.0 if ms > 0 else None


def deadline_seconds_from(ms, default_env: bool = True) -> Optional[float]:
    """Resolve a deadline argument: None reads the env (when asked),
    <=0 pins it off, >0 is milliseconds."""
    if ms is None:
        return dispatch_deadline_from_env() if default_env else None
    ms = float(ms)
    return ms / 1000.0 if ms > 0 else None


class DeadlineWatchdog:
    """Monitored-sync runner for one dispatch owner (scheduler or
    rebalancer). Stateless between runs except the overrun counter;
    every ``run`` spawns its own worker, so an abandoned slow sync never
    blocks the next window's watchdog."""

    def __init__(self, deadline_seconds: Optional[float] = None,
                 on_overrun: Optional[Callable[[str], None]] = None) -> None:
        self.deadline_seconds = deadline_seconds
        self.on_overrun = on_overrun
        self._lock = threading.Lock()
        self.overruns = 0  # koordlint: guarded-by(_lock)

    def run(self, fn: Callable[[], object], path: str):
        """Run the blocking sync ``fn`` under the deadline. No deadline
        configured: calls inline (no thread)."""
        deadline = self.deadline_seconds
        if deadline is None:
            return fn()
        box: dict = {}
        done = threading.Event()

        def worker() -> None:
            try:
                box["result"] = fn()
            except BaseException as exc:  # delivered to the waiter
                box["error"] = exc
            finally:
                done.set()

        t = threading.Thread(target=worker, daemon=True,
                             name=f"koord-dispatch-sync-{path}")
        t.start()
        if done.wait(deadline):
            err = box.get("error")
            if err is not None:
                raise err
            return box["result"]
        with self._lock:
            self.overruns += 1
        logger.warning(
            "%s dispatch overran the %.0fms device deadline; abandoning "
            "the in-flight window (the worker drains it in the "
            "background)", path, deadline * 1000.0)
        if self.on_overrun is not None:
            self.on_overrun(path)
        raise DispatchDeadlineExceeded(path, deadline)
