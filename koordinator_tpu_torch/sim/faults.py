"""Fault injection: the plan, the dispatch hooks, and the faulty store.

A :class:`FaultPlan` is a schedule of :class:`Fault` entries, armed by
the simulator at the start of each sim cycle:

  * ``kind="dispatch"`` — the scheduler's ``fault_injector`` hook raises
    :class:`InjectedFault` from inside the device-dispatch window for
    the next ``count`` attempts, exercising the degradation ladder
    (scheduler/degrade.py) exactly like a real device fault. Two
    failing attempts demote one rung (retry-once policy), so ``count``
    is the demotion depth dial: 2 = one rung, 8 = all the way to the
    pure-host fallback.
  * ``kind="device_loss"`` — like ``dispatch``, but the raised
    fault NAMES the dead mesh devices
    (``devices=(6, 7)``): the failure is attributable, so the ladder's
    partial-mesh rung (koordguard) sheds only those devices and keeps
    dispatching on the surviving submesh.
  * ``kind="latency"`` — the next ``count`` MONITORED readback syncs
    sleep ``delay_ms`` before completing: a slow-not-dead device. With
    ``KOORD_TPU_DISPATCH_DEADLINE_MS`` armed below the delay, the
    dispatch watchdog (scheduler/deadline.py) abandons the window and
    the ladder demotes instead of the cycle wedging.
  * ``kind="oom_upload"`` — the next ``count`` DeviceSnapshot field
    uploads raise a RESOURCE_EXHAUSTED-shaped allocation failure, which
    snapshot_cache classifies as a ladder-demotable device fault
    (DeviceAllocationError), not a cycle exception.
  * ``kind="store_write"`` — the next ``count`` store writes issued by
    the SCHEDULER (the simulator wraps only the scheduler's store view
    in :class:`FaultyStore`; its own churn mutations never fail) raise.
    This lands mid-bind or in the condition writer — paths the ladder
    deliberately does not absorb — so it pins that an unhandled cycle
    exception flight-dumps, re-raises, and the next cycle carries on.
  * ``kind="sidecar"`` — installs a dead in-process sidecar client stub
    (every RPC raises) for ``count`` cycles, exercising the sidecar's
    own local-step fallback path.

A ``device_loss`` fault needs a scheduler on a mesh (the scenario's
``mesh``: that many virtual shards of the sim's device, sim/harness.py);
the ids it names are the shard devices' (parallel/mesh.py MeshDevice.id).

Everything is deterministic: faults fire at fixed cycles with fixed
budgets, no randomness. The latency sleep is real wall time but the sim
clock is synthetic, so binding decisions (and the binding log) stay
byte-stable as long as ``delay_ms`` clears the armed deadline with
margin.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

FAULT_KINDS = ("dispatch", "device_loss", "latency", "oom_upload",
               "store_write", "sidecar")


class InjectedFault(RuntimeError):
    """The exception every injected fault raises — distinguishable from
    real bugs in sim reports."""


class DeviceLossFault(InjectedFault):
    """A dispatch fault attributable to specific mesh devices — carries
    ``failed_device_ids``, the attribute
    scheduler/degrade.attributable_device_ids reads to engage the
    partial-mesh rung."""

    def __init__(self, message: str, device_ids) -> None:
        super().__init__(message)
        self.failed_device_ids = frozenset(int(i) for i in device_ids)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: at sim cycle ``cycle``, arm ``count`` units
    of ``kind`` failure. ``devices`` names the dead mesh device ids for
    ``device_loss``; ``delay_ms`` is the injected sync latency for
    ``latency``."""

    cycle: int
    kind: str              # see FAULT_KINDS
    count: int = 1
    message: str = "injected fault"
    devices: Tuple[int, ...] = ()
    delay_ms: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.cycle < 0 or self.count < 1:
            raise ValueError("fault cycle must be >= 0 and count >= 1")
        if self.kind == "device_loss" and not self.devices:
            raise ValueError("device_loss faults must name their devices")
        if self.kind == "latency" and self.delay_ms <= 0:
            raise ValueError("latency faults need delay_ms > 0")


class FaultPlan:
    """Armed budgets per fault kind, advanced cycle by cycle. The
    simulator owns the lifecycle: ``begin_cycle`` arms the entries
    scheduled for that cycle, the hooks consume budget as they fire."""

    def __init__(self, faults: Sequence[Fault] = ()) -> None:
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self._budget: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._message: Dict[str, str] = {}
        self._devices: Tuple[int, ...] = ()
        self._delay_ms: float = 0.0
        self.injected: List[dict] = []  # what actually fired, per kind
        self._cycle = -1

    def begin_cycle(self, cycle: int) -> None:
        self._cycle = cycle
        for f in self.faults:
            if f.cycle == cycle:
                self._budget[f.kind] += f.count
                self._message[f.kind] = f.message
                if f.kind == "device_loss":
                    self._devices = f.devices
                if f.kind == "latency":
                    self._delay_ms = f.delay_ms

    def budget(self, kind: str) -> int:
        return self._budget[kind]

    def _consume(self, kind: str, detail: str) -> str:
        self._budget[kind] -= 1
        self.injected.append(
            {"cycle": self._cycle, "kind": kind, "detail": detail})
        return (f"{self._message.get(kind, 'injected fault')} "
                f"({kind}: {detail})")

    def _fire(self, kind: str, detail: str) -> None:
        raise InjectedFault(self._consume(kind, detail))

    # ---- scheduler.fault_injector hook --------------------------------
    def dispatch_hook(self, stage: str) -> None:
        """Installed as ``Scheduler.fault_injector``; raises while the
        dispatch (or attributable device-loss) budget lasts."""
        if self._budget["device_loss"] > 0:
            raise DeviceLossFault(
                self._consume("device_loss",
                              f"{stage} devices={list(self._devices)}"),
                self._devices)
        if self._budget["dispatch"] > 0:
            self._fire("dispatch", stage)

    # ---- scheduler.sync_delay_injector hook ---------------------------
    def sync_delay_hook(self) -> None:
        """Installed as ``Scheduler.sync_delay_injector`` (and the
        rebalancer's): sleeps inside the monitored readback while the
        latency budget lasts — the slow-not-dead device."""
        if self._budget["latency"] > 0:
            import time

            self._consume("latency", f"sleep {self._delay_ms:.0f}ms")
            time.sleep(self._delay_ms / 1000.0)

    # ---- DeviceSnapshot.fault_injector hook ---------------------------
    def upload_hook(self, field: str) -> None:
        """Installed as ``Scheduler.upload_fault_injector``; raises a
        RESOURCE_EXHAUSTED-shaped allocation failure while the
        oom_upload budget lasts (snapshot_cache classifies it as a
        device fault)."""
        if self._budget["oom_upload"] > 0:
            raise InjectedFault(
                "RESOURCE_EXHAUSTED: out of memory allocating device "
                "buffer (" + self._consume("oom_upload", field) + ")")

    # ---- store-write hook ---------------------------------------------
    def store_write_hook(self, kind: str, key: str) -> None:
        if self._budget["store_write"] > 0:
            self._fire("store_write", f"{kind} {key}")

    # ---- sidecar ------------------------------------------------------
    def sidecar_armed(self) -> bool:
        """True while a sidecar fault cycle is active; the simulator
        swaps a dead client stub in/out of the scheduler. Consumes one
        budget unit per armed cycle."""
        if self._budget["sidecar"] > 0:
            self._budget["sidecar"] -= 1
            self.injected.append(
                {"cycle": self._cycle, "kind": "sidecar", "detail": "stub"})
            return True
        return False


class DeadSidecarClient:
    """A sidecar client whose every RPC raises a channel-level transport
    failure: what a timed-out / crashed gRPC peer looks like to
    schedule_batch_or_fallback, which must degrade to the local step
    (scheduler/sidecar.py catches ConnectionError/OSError)."""

    def schedule_batch(self, request):
        raise ConnectionError("sidecar timeout (injected)")

    def close(self) -> None:
        pass


class FaultyStore:
    """The scheduler's store view with write faults: forwards everything
    to the real store, but ``update``/``add``/``delete`` consult the
    plan first. Only the scheduler holds this wrapper — the simulator's
    own churn mutations go to the inner store directly.

    The view also RECORDS every watch registered through it so the
    crash-restart event can ``sever()`` them: the apiserver dropping a
    dead client's watch connections. A severed view's handlers stop
    receiving events; the fresh scheduler's own subscriptions replay
    list-then-watch from the surviving store."""

    def __init__(self, inner, plan: FaultPlan) -> None:
        # bypass __setattr__-free plain attributes; no locking needed,
        # the sim drives a single cycle thread
        self._inner = inner
        self._plan = plan
        self._subs: List[tuple] = []  # (kind, handler) watches registered

    def subscribe(self, kind: str, handler, replay: bool = True) -> None:
        self._subs.append((kind, handler))
        return self._inner.subscribe(kind, handler, replay=replay)

    def sever(self) -> None:
        """Crash teardown: unsubscribe every watch this view's owner
        registered. The dead scheduler's informers, plugins and
        snapshot cache stop consuming events from the surviving store."""
        for kind, handler in self._subs:
            self._inner.unsubscribe(kind, handler)
        self._subs = []

    def update(self, kind: str, obj):
        self._plan.store_write_hook(kind, getattr(
            getattr(obj, "meta", None), "key", "?"))
        return self._inner.update(kind, obj)

    def add(self, kind: str, obj):
        self._plan.store_write_hook(kind, getattr(
            getattr(obj, "meta", None), "key", "?"))
        return self._inner.add(kind, obj)

    def delete(self, kind: str, key: str):
        self._plan.store_write_hook(kind, key)
        return self._inner.delete(kind, key)

    def update_many(self, kind: str, objs):
        """Batched writes keep PER-OBJECT fault semantics: a store-write
        fault armed mid-batch leaves the earlier objects applied, exactly
        like N sequential updates — the reconcile-after-wreck path in the
        harness depends on partially-applied batches being visible."""
        return [self.update(kind, obj) for obj in objs]

    def __getattr__(self, name):
        return getattr(self._inner, name)
