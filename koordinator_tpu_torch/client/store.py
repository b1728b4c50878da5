"""Typed object store with watch semantics.

Collections keyed by object kind; each add/update/delete bumps a global
resourceVersion and fans out to informer subscribers (synchronously, in registration
order — matching client-go's single event-handler goroutine per informer). Optimistic
concurrency: `update` can require the caller's resourceVersion to match (the analog
of an apiserver 409), which the scheduler's assume/bind path relies on.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional


class EventType(enum.Enum):
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


Handler = Callable[[EventType, Any, Optional[Any]], None]  # (event, obj, old_obj)


class ConflictError(Exception):
    """Optimistic-concurrency conflict (apiserver 409 analog)."""


@dataclass
class _Collection:
    objects: Dict[str, Any] = field(default_factory=dict)
    handlers: List[Handler] = field(default_factory=list)


# Canonical kind names used across the framework.
KIND_POD = "Pod"
KIND_NODE = "Node"
KIND_NODE_METRIC = "NodeMetric"
KIND_NODE_SLO = "NodeSLO"
KIND_RESERVATION = "Reservation"
KIND_POD_GROUP = "PodGroup"
KIND_ELASTIC_QUOTA = "ElasticQuota"
KIND_DEVICE = "Device"
KIND_NODE_TOPOLOGY = "NodeResourceTopology"
KIND_POD_MIGRATION_JOB = "PodMigrationJob"
KIND_COLOCATION_PROFILE = "ClusterColocationProfile"
KIND_QUOTA_PROFILE = "ElasticQuotaProfile"
KIND_CONFIG_MAP = "ConfigMap"
KIND_PDB = "PodDisruptionBudget"
KIND_LEASE = "Lease"  # coordination.k8s.io leader-election lease
KIND_PVC = "PersistentVolumeClaim"
KIND_PV = "PersistentVolume"
KIND_STORAGECLASS = "StorageClass"
KIND_NAMESPACE = "Namespace"

ALL_KINDS = (
    KIND_POD,
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_NODE_SLO,
    KIND_RESERVATION,
    KIND_POD_GROUP,
    KIND_ELASTIC_QUOTA,
    KIND_DEVICE,
    KIND_NODE_TOPOLOGY,
    KIND_POD_MIGRATION_JOB,
    KIND_COLOCATION_PROFILE,
    KIND_QUOTA_PROFILE,
    KIND_CONFIG_MAP,
    KIND_PDB,
    KIND_LEASE,
    KIND_PVC,
    KIND_PV,
    KIND_STORAGECLASS,
    KIND_NAMESPACE,
)


def _key_of(obj: Any) -> str:
    meta = getattr(obj, "meta", None)
    if meta is None:
        raise TypeError(f"object {obj!r} has no .meta")
    return meta.key


class ObjectStore:
    """The cluster-wide bus: all durable state lives here (SURVEY.md section 5.4)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._rv = 0  # global mutation counter (see resource_version)
        self._collections: Dict[str, _Collection] = {k: _Collection() for k in ALL_KINDS}
        # admission interceptors (apiserver -> webhook call path): named so a
        # standby replica installing the same server is idempotent
        self._admission: Dict[str, Any] = {}

    def set_admission(self, name: str, fn) -> None:
        """Install an admission interceptor `fn(kind, obj, old=None,
        delete=False)` run before every add/update/delete; raising rejects
        the operation (the store's analog of registering a webhook with the
        apiserver). Passing None removes it."""
        with self._lock:
            if fn is None:
                self._admission.pop(name, None)
            else:
                self._admission[name] = fn

    def _admit(self, kind: str, obj: Any, old: Any = None,
               delete: bool = False) -> None:
        with self._lock:
            interceptors = list(self._admission.values())
        for fn in interceptors:
            fn(kind, obj, old=old, delete=delete)

    # -- accessors -----------------------------------------------------------
    def get(self, kind: str, key: str) -> Optional[Any]:
        with self._lock:
            return self._collections[kind].objects.get(key)

    def list(self, kind: str) -> List[Any]:
        with self._lock:
            return list(self._collections[kind].objects.values())

    def __len__(self) -> int:
        with self._lock:
            return sum(len(c.objects) for c in self._collections.values())

    # -- mutators ------------------------------------------------------------
    @property
    def resource_version(self) -> int:
        """Global mutation counter: bumps on every add/update/delete.
        Cheap cache-invalidation key for derived indexes."""
        with self._lock:
            return self._rv

    def add(self, kind: str, obj: Any) -> Any:
        self._admit(kind, obj)
        with self._lock:
            key = _key_of(obj)
            col = self._collections[kind]
            if key in col.objects:
                raise ValueError(f"{kind} {key} already exists")
            self._rv += 1
            obj.meta.resource_version = self._rv
            col.objects[key] = obj
            handlers = list(col.handlers)
        self._notify(handlers, EventType.ADDED, obj, None)
        return obj

    def update(self, kind: str, obj: Any, expect_rv: Optional[int] = None) -> Any:
        self._admit(kind, obj, old=self.get(kind, _key_of(obj)))
        with self._lock:
            key = _key_of(obj)
            col = self._collections[kind]
            old = col.objects.get(key)
            if old is None:
                raise KeyError(f"{kind} {key} not found")
            if expect_rv is not None and old.meta.resource_version != expect_rv:
                raise ConflictError(
                    f"{kind} {key}: rv {old.meta.resource_version} != expected {expect_rv}"
                )
            self._rv += 1
            obj.meta.resource_version = self._rv
            col.objects[key] = obj
            handlers = list(col.handlers)
        self._notify(handlers, EventType.MODIFIED, obj, old)
        return obj

    def update_many(self, kind: str, objs: List[Any]) -> List[Any]:
        """Vectorized update transaction: N updates of one kind under
        TWO lock acquisitions (admission pre-read + apply) instead of
        2N+. Each object still gets its own resourceVersion bump and its
        own MODIFIED event (handlers receive the identical (obj, old)
        pairs, in order, that N sequential ``update`` calls would
        deliver — only the lock round-trips are amortized; a mid-batch
        failure (missing key, admission rejection) applies and notifies
        the prefix, then raises, exactly like the sequential loop. One
        batching departure: admission interceptors see the pre-batch
        ``old`` side, not the just-applied prefix). The
        scheduler's wave-replay batches (bind patches per wave, the
        deferred condition flush) route through this so a K-wave dispatch
        pays one store transaction per batch instead of one per pod."""
        if not objs:
            return objs
        with self._lock:  # one locked pre-read for the admission olds
            col = self._collections[kind]
            olds = [col.objects.get(_key_of(obj)) for obj in objs]
        admitted: List[Any] = []
        failure: Optional[Exception] = None
        for obj, old in zip(objs, olds):
            try:
                self._admit(kind, obj, old=old)
            except Exception as exc:  # admission rejection: stop where
                failure = exc         # the sequential loop would
                break
            admitted.append(obj)
        events: List[tuple] = []
        with self._lock:
            col = self._collections[kind]
            for obj in admitted:
                key = _key_of(obj)
                old = col.objects.get(key)
                if old is None:
                    # stop exactly where N sequential updates would: the
                    # applied prefix keeps its rv bumps AND (below) its
                    # MODIFIED events before the KeyError surfaces
                    failure = KeyError(f"{kind} {key} not found")
                    break
                self._rv += 1
                obj.meta.resource_version = self._rv
                col.objects[key] = obj
                events.append((obj, old))
            handlers = list(col.handlers)
        for obj, old in events:
            self._notify(handlers, EventType.MODIFIED, obj, old)
        if failure is not None:
            raise failure
        return objs

    def upsert(self, kind: str, obj: Any) -> Any:
        with self._lock:
            exists = _key_of(obj) in self._collections[kind].objects
        return self.update(kind, obj) if exists else self.add(kind, obj)

    def delete(self, kind: str, key: str) -> Optional[Any]:
        existing = self.get(kind, key)
        if existing is not None:
            self._admit(kind, existing, delete=True)
        with self._lock:
            col = self._collections[kind]
            old = col.objects.pop(key, None)
            if old is None:
                return None
            self._rv += 1
            handlers = list(col.handlers)
        self._notify(handlers, EventType.DELETED, old, old)
        return old

    # -- watch ---------------------------------------------------------------
    def subscribe(self, kind: str, handler: Handler, replay: bool = True) -> None:
        """Register a handler; with replay=True, existing objects are delivered as
        ADDED first (informer list-then-watch semantics)."""
        with self._lock:
            existing = list(self._collections[kind].objects.values())
            self._collections[kind].handlers.append(handler)
        if replay:
            for obj in existing:
                handler(EventType.ADDED, obj, None)

    def unsubscribe(self, kind: str, handler: Handler) -> None:
        """Drop a watch handler registered by subscribe (no-op when it
        was never registered). The apiserver analog of a client's watch
        connection closing — crash-restart teardown severs a dead
        consumer's handlers so they stop receiving events."""
        with self._lock:
            handlers = self._collections[kind].handlers
            if handler in handlers:
                handlers.remove(handler)

    @staticmethod
    def _notify(handlers: Iterable[Handler], ev: EventType, obj: Any, old: Any) -> None:
        for h in handlers:
            h(ev, obj, old)


class Informer:
    """Thin lister façade over one collection (client-go lister analog)."""

    def __init__(self, store: ObjectStore, kind: str):
        self._store = store
        self._kind = kind

    def get(self, key: str) -> Optional[Any]:
        return self._store.get(self._kind, key)

    def list(self) -> List[Any]:
        return self._store.list(self._kind)

    def on_event(self, handler: Handler, replay: bool = True) -> None:
        self._store.subscribe(self._kind, handler, replay=replay)
