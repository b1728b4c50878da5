"""Leader election: active/standby control-plane replicas.

Analog of client-go `leaderelection` as used by every koordinator binary
(`cmd/koord-scheduler/app/server.go:227-256`, koord-manager, descheduler):
replicas race to hold a Lease object in the store; only the holder runs its
control loops. The lease is renewed every tick; when the holder stops
renewing (crash, partition), a standby acquires it after lease_duration and
takes over. Optimistic concurrency (the store's resourceVersion CAS) decides
races exactly the way the apiserver does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from koordinator_tpu_torch.api.objects import ObjectMeta
from koordinator_tpu_torch.client.store import (
    KIND_LEASE,
    ConflictError,
    ObjectStore,
)


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease subset."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_seconds: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0

    def expired(self, now: float) -> bool:
        return now >= self.renew_time + self.lease_duration_seconds


class LeaderElector:
    """tryAcquireOrRenew loop (client-go leaderelection.go semantics):
    call tick(now) on retry_period; it returns whether this replica leads.

    on_started_leading / on_stopped_leading fire on transitions, mirroring
    LeaderCallbacks (server.go:228-247). The reference process exits when it
    loses the lease; here the callback owner decides (tests keep the object
    alive to observe failover)."""

    def __init__(
        self,
        store: ObjectStore,
        lease_name: str,
        identity: str,
        lease_duration_seconds: float = 15.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        self.store = store
        self.lease_name = lease_name
        self.identity = identity
        self.lease_duration = lease_duration_seconds
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False

    @property
    def is_leader(self) -> bool:
        return self._leading

    def _set_leading(self, leading: bool) -> bool:
        if leading and not self._leading:
            self._leading = True
            if self.on_started_leading:
                self.on_started_leading()
        elif not leading and self._leading:
            self._leading = False
            if self.on_stopped_leading:
                self.on_stopped_leading()
        return self._leading

    def tick(self, now: Optional[float] = None) -> bool:
        """One tryAcquireOrRenew round; returns leadership after the round."""
        now = time.time() if now is None else now
        lease: Optional[Lease] = self.store.get(KIND_LEASE, f"/{self.lease_name}")
        if lease is None:
            fresh = Lease(
                meta=ObjectMeta(name=self.lease_name, namespace=""),
                holder_identity=self.identity,
                lease_duration_seconds=self.lease_duration,
                acquire_time=now,
                renew_time=now,
            )
            try:
                self.store.add(KIND_LEASE, fresh)
            except ValueError:
                return self._set_leading(False)  # lost the creation race
            return self._set_leading(True)

        if lease.holder_identity == self.identity:
            # renew via CAS: a conflict means another replica took over
            import copy

            renewed = copy.deepcopy(lease)
            renewed.renew_time = now
            try:
                self.store.update(
                    KIND_LEASE, renewed,
                    expect_rv=lease.meta.resource_version,
                )
            except ConflictError:
                return self._set_leading(False)
            return self._set_leading(True)

        if not lease.expired(now):
            return self._set_leading(False)

        # expired foreign lease: try to take it over
        import copy

        taken = copy.deepcopy(lease)
        taken.holder_identity = self.identity
        taken.acquire_time = now
        taken.renew_time = now
        taken.lease_transitions += 1
        try:
            self.store.update(
                KIND_LEASE, taken, expect_rv=lease.meta.resource_version
            )
        except ConflictError:
            return self._set_leading(False)  # another standby won the race
        return self._set_leading(True)

    def release(self, now: Optional[float] = None) -> None:
        """Voluntary hand-off (ReleaseOnCancel): zero the renew time so a
        standby acquires immediately."""
        now = time.time() if now is None else now
        lease: Optional[Lease] = self.store.get(KIND_LEASE, f"/{self.lease_name}")
        if lease is None or lease.holder_identity != self.identity:
            return
        import copy

        released = copy.deepcopy(lease)
        released.renew_time = now - self.lease_duration
        try:
            self.store.update(
                KIND_LEASE, released, expect_rv=lease.meta.resource_version
            )
        except ConflictError:
            pass
        self._set_leading(False)


class ElectedRunner:
    """Run a control loop only while holding the lease — the active/standby
    wrapper every control-plane binary uses (server.go:227-256). run_fn fires
    each tick only on the current leader."""

    def __init__(self, elector: LeaderElector, run_fn: Callable[[float], None]):
        self.elector = elector
        self.run_fn = run_fn
        self.runs = 0

    def tick(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        if self.elector.tick(now):
            self.run_fn(now)
            self.runs += 1
            return True
        return False
