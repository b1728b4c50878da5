"""koord-manager: one composed control-plane runner.

Analog of the koord-manager binary (`cmd/koord-manager/main.go` +
`options/controllers.go:34-39`): a single process that installs the
nodemetric / noderesource / nodeslo / quota-profile controllers and the
admission webhook server, with every controller gated behind ONE leader
lease — standby replicas serve webhooks but run no control loops, exactly
like controller-runtime managers with LeaderElection enabled.

The webhook installs into the ObjectStore's admission-interceptor seam
(`store.set_admission`) immediately at construction on every replica:
admission is load-balanced across replicas in the reference too, so it is
NOT election-gated.

koordcolo (colo/): with ``KOORD_TPU_COLO=on`` (the default) the
noderesource reconcile runs as the DEVICE colo pass — the slo-controller
overcommit formula plus the elastic-quota runtime fold as one tensor
pass on ``device`` ("cuda" unless the caller asks for the CPU; without
CUDA, "cuda" raises), ladder-protected with the retained host
controllers as the fallback oracle. A co-located ``scheduler`` wires the
pack into the SnapshotCache's existing subscriptions, the uploads into
the scheduler's device mirror, and the pass onto the scheduler's device;
standalone managers own their pack, quota plugin and mirror. ``host``
pins the host oracles (the A/B twin), ``off`` detaches the colo
subsystem entirely. Every controller reconcile is instrumented in the
manager's Registry (manager_metrics) and the manager carries a Tracer +
flight ring. A co-located reconciler runs on the scheduler's configured
mesh; a standalone one reads ``KOORD_TPU_MESH`` (parallel/mesh.py).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from koordinator_tpu_torch import manager_metrics
from koordinator_tpu_torch.client.leaderelection import ElectedRunner, LeaderElector
from koordinator_tpu_torch.client.store import ObjectStore
from koordinator_tpu_torch.obs import Tracer
from koordinator_tpu_torch.quotacontroller import QuotaProfileController
from koordinator_tpu_torch.slocontroller import (
    NodeMetricController,
    NodeResourceController,
    NodeSLOController,
)
from koordinator_tpu_torch.utils.sloconfig import ColocationConfig
from koordinator_tpu_torch.webhook import AdmissionServer

MANAGER_LEASE = "koord-manager"


class Manager:
    """Composed koord-manager replica. `tick(now)` renews/acquires the lease
    and, while leading, reconciles every installed controller once."""

    def __init__(
        self,
        store: ObjectStore,
        identity: str = "koord-manager-0",
        config: Optional[ColocationConfig] = None,
        lease_duration_seconds: float = 15.0,
        scheduler=None,
        colo: Optional[str] = None,
        device="cuda",
    ) -> None:
        from koordinator_tpu_torch.colo.reconciler import colo_from_env

        self.store = store
        self.identity = identity
        self.scheduler = scheduler
        # the torch device of a standalone colo pass; a co-located one
        # runs on the scheduler's device
        self.device = device
        self.tracer = Tracer()
        self.webhook = AdmissionServer(store)
        # webhooks are served by every replica (leader or not)
        store.set_admission("koord-manager-webhook", self.webhook.admit)
        self.controllers = {
            "nodemetric": NodeMetricController(store, config),
            "noderesource": NodeResourceController(store, config),
            "nodeslo": NodeSLOController(store),
            "quotaprofile": QuotaProfileController(store),
        }
        self.colo_mode = colo_from_env() if colo is None else colo
        if self.colo_mode not in ("on", "off", "host"):
            raise ValueError(
                f"colo must be 'on', 'off' or 'host'; "
                f"got {self.colo_mode!r}")
        self.colo = None
        if self.colo_mode != "off":
            self.colo = self._build_colo()
        self.elector = LeaderElector(
            store, MANAGER_LEASE, identity,
            lease_duration_seconds=lease_duration_seconds)
        self._runner = ElectedRunner(self.elector, self._reconcile_all)
        self.last_changes: Dict[str, int] = {}
        self.reconcile_rounds = 0

    def _build_colo(self):
        """Wire the DeviceColoReconciler: pack from the co-located
        scheduler's SnapshotCache (one event stream, three consumers)
        and uploads through its DeviceSnapshot, or standalone pack +
        quota plugin when the manager runs alone. A co-located
        reconciler inherits the scheduler's device and RESOLVED dispatch
        deadline (the koordguard determinism discipline)."""
        from koordinator_tpu_torch.colo.pack import ColoPack
        from koordinator_tpu_torch.colo.reconciler import DeviceColoReconciler

        controller = self.controllers["noderesource"]
        config_source = controller.config_source
        scheduler = self.scheduler
        if scheduler is not None and scheduler.snapshot_cache is not None:
            pack = scheduler.snapshot_cache.colo_pack(config_source)
        else:
            pack = ColoPack(self.store, config_source, subscribe=True)
        quota_plugin = (scheduler.extender.plugin("ElasticQuota")
                        if scheduler is not None else None)
        if quota_plugin is None:
            from koordinator_tpu_torch.scheduler.plugins.elasticquota import (
                ElasticQuotaPlugin,
            )

            quota_plugin = ElasticQuotaPlugin()
            quota_plugin.register(self.store)
        if scheduler is not None:
            device = scheduler.device
            mesh = getattr(scheduler, "_configured_mesh", None)
            getter = lambda: scheduler.device_snapshot  # noqa: E731
            dl = getattr(scheduler, "dispatch_deadline_seconds", None)
            deadline_ms = dl * 1000.0 if dl else 0
        else:
            from koordinator_tpu_torch.scheduler.cycle import resolve_mesh

            device = self.device
            mesh = resolve_mesh(None, device)
            getter = None
            deadline_ms = None
        return DeviceColoReconciler(
            self.store, controller, quota_plugin, pack,
            device=device, mesh=mesh, snapshot_getter=getter,
            dispatch_deadline_ms=deadline_ms,
            tracer=self.tracer,
            engine=("on" if self.colo_mode == "on" else "host"),
            # koordwatch: the co-located colo pass records into the
            # SCHEDULER's device timeline — one device, one ring, one
            # decision-id sequence across all three consumers
            timeline=getattr(scheduler, "timeline", None))

    @property
    def is_leader(self) -> bool:
        return self.elector.is_leader

    def _reconcile_one(self, name: str, now: float) -> int:
        t0 = time.perf_counter()
        if name == "noderesource":
            if self.colo is not None:
                changes = self.colo.reconcile(now)
            else:
                # KOORD_TPU_COLO=off: the legacy reconcile still gets
                # its per-controller span (it is the one you are most
                # likely tracing during a colo incident)
                with self.tracer.span(name):
                    changes = self.controllers[name].reconcile(now)
        else:
            with self.tracer.span(name):
                changes = self.controllers[name].reconcile()
        manager_metrics.RECONCILE_SECONDS.observe(
            time.perf_counter() - t0, controller=name)
        manager_metrics.RECONCILES_TOTAL.inc(controller=name)
        return changes

    def _reconcile_all(self, now: float) -> None:
        self.last_changes = {
            name: self._reconcile_one(name, now)
            for name in ("nodemetric", "noderesource", "nodeslo",
                         "quotaprofile")
        }
        self.reconcile_rounds += 1

    def tick(self, now: Optional[float] = None) -> bool:
        """One manager round: returns True iff this replica led and ran."""
        return self._runner.tick(time.time() if now is None else now)

    def health_snapshot(self) -> dict:
        """Liveness payload for the ObsServer /healthz surface: lease
        state, reconcile rounds, and the colo ladder under "degraded"
        (the same key the scheduler serves, so one probe grammar covers
        the binaries)."""
        out = {
            "is_leader": self.is_leader,
            "reconcile_rounds": self.reconcile_rounds,
            "colo_mode": self.colo_mode,
        }
        if self.colo is not None:
            out["degraded"] = self.colo.ladder.snapshot()
            out["colo_engine"] = self.colo.last_pass_stats.get(
                "engine", "none")
        return out

    def stop(self, now: Optional[float] = None) -> None:
        """Graceful shutdown: release the lease (ReleaseOnCancel) and
        uninstall this replica's webhook."""
        self.elector.release(time.time() if now is None else now)
        self.store.set_admission("koord-manager-webhook", None)
