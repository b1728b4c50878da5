"""Descheduler profile runner.

Analog of reference `pkg/descheduler/descheduler.go` + `pkg/descheduler/profile/`:
each configured profile owns a plugin set (Deschedule/Balance/Evict/Filter,
framework/types.go:32-110) and runs every interval — Deschedule plugins first,
then Balance plugins — followed by the migration controller that executes the
PodMigrationJob CRs the plugins created (reserve-then-evict)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import koordinator_tpu_torch.descheduler.plugins_k8s  # noqa: F401  (registers plugins)
from koordinator_tpu_torch.client.store import ObjectStore
from koordinator_tpu_torch.descheduler import metrics as descheduler_metrics
from koordinator_tpu_torch.descheduler.framework import Profile, ProfileConfig
from koordinator_tpu_torch.descheduler.lownodeload import LowNodeLoadArgs
from koordinator_tpu_torch.descheduler.migration import MigrationController

DEFAULT_PROFILE = ProfileConfig(
    name="koord-descheduler",
    balance=["LowNodeLoad"],
)


class Descheduler:
    def __init__(
        self,
        store: ObjectStore,
        low_node_load_args: Optional[LowNodeLoadArgs] = None,
        profiles: Optional[List[ProfileConfig]] = None,
        elector=None,
        scheduler=None,
        rebalance: Optional[str] = None,
        device="cuda",
    ):
        self.store = store
        # the torch device of a standalone rebalancer's private mirror; a
        # co-located one runs on the scheduler's device
        self.device = device
        # active/standby gating (cmd/koord-descheduler mirrors the scheduler's
        # leader election): with an elector, run_once acts only on the leader
        self.elector = elector
        if profiles is None:
            profiles = [DEFAULT_PROFILE]
        if low_node_load_args is not None:
            import dataclasses

            profiles = [
                dataclasses.replace(
                    p,
                    plugin_args={
                        **p.plugin_args,
                        "LowNodeLoad": dataclasses.asdict(low_node_load_args),
                    },
                )
                if "LowNodeLoad" in p.balance
                else p
                for p in profiles
            ]
        self.profiles = [Profile(cfg, store) for cfg in profiles]
        self.migration = MigrationController(store)
        # ---- koordbalance wiring (balance/): the descheduler as the
        # SECOND consumer of the scheduler's snapshot. With a co-located
        # `scheduler`, LowNodeLoad's packed view comes from the
        # scheduler's SnapshotCache subscription chain (one encode) and
        # the device pass uploads through the scheduler's DeviceSnapshot
        # (one mirror). KOORD_TPU_REBALANCE=on|off|host picks the
        # engine; "on" (default) attaches the DeviceRebalancer with the
        # host-oracle fallback ladder underneath.
        from koordinator_tpu_torch.balance.rebalancer import rebalance_from_env

        self.scheduler = scheduler
        self.rebalance_mode = (rebalance_from_env() if rebalance is None
                               else rebalance)
        if self.rebalance_mode not in ("on", "off", "host"):
            raise ValueError(
                f"rebalance must be 'on', 'off' or 'host'; "
                f"got {self.rebalance_mode!r}")
        self.rebalancer = None
        self._wire_rebalance()

    def _wire_rebalance(self) -> None:
        from koordinator_tpu_torch.balance.rebalancer import DeviceRebalancer

        snapshot_cache = (getattr(self.scheduler, "snapshot_cache", None)
                          if self.scheduler is not None else None)
        for profile in self.profiles:
            for plugin in profile.balance_plugins:
                if plugin.name != "LowNodeLoad":
                    continue
                plugin.enabled = self.rebalance_mode != "off"
                inner = plugin.inner
                if snapshot_cache is not None:
                    inner.pack_cache = snapshot_cache.rebalance_pack(
                        inner.args.node_metric_expiration_seconds)
                if self.rebalance_mode != "on":
                    continue
                if self.rebalancer is None:
                    if self.scheduler is not None:
                        getter = lambda: self.scheduler.device_snapshot  # noqa: E731
                        # a co-located rebalancer shares the scheduler's
                        # RESOLVED deadline (koordguard): a sim that
                        # pins the scheduler's deadline off must not
                        # have the rebalance pass re-read the env and
                        # demote non-deterministically
                        dl = getattr(self.scheduler,
                                     "dispatch_deadline_seconds", None)
                        deadline_ms = dl * 1000.0 if dl else 0
                        self.rebalancer = DeviceRebalancer(
                            device=self.scheduler.device,
                            snapshot_getter=getter,
                            dispatch_deadline_ms=deadline_ms,
                            # koordwatch: the co-located pass records
                            # into the SCHEDULER's device timeline —
                            # one device, one ring, one id sequence
                            timeline=getattr(self.scheduler,
                                             "timeline", None))
                    else:
                        self.rebalancer = DeviceRebalancer(
                            device=self.device, snapshot_getter=None)
                inner.attach_device(self.rebalancer)

    def run_once(self, now: Optional[float] = None) -> dict:
        from koordinator_tpu_torch.client.store import KIND_POD_MIGRATION_JOB

        now = time.time() if now is None else now
        if self.elector is not None and not self.elector.tick(now):
            return {"skipped_not_leader": True, "jobs_created": 0,
                    "migration_transitions": 0, "profiles": {}, "evicted": {}}
        t_start = time.perf_counter()
        statuses: Dict[str, Dict[str, Optional[str]]] = {}
        evicted_before = {
            p.config.name: p.handle.evicted_count for p in self.profiles
        }
        jobs_before = len(self.store.list(KIND_POD_MIGRATION_JOB))
        for profile in self.profiles:
            statuses[profile.config.name] = {
                name: s.err for name, s in profile.run(now).items()
            }
        jobs_created = len(self.store.list(KIND_POD_MIGRATION_JOB)) - jobs_before
        transitions = self.migration.reconcile(now)
        evicted = {
            p.config.name: p.handle.evicted_count - evicted_before[p.config.name]
            for p in self.profiles
        }
        descheduler_metrics.CYCLE_SECONDS.observe(
            time.perf_counter() - t_start)
        if jobs_created:
            descheduler_metrics.MIGRATION_JOBS_CREATED_TOTAL.inc(jobs_created)
        if transitions:
            descheduler_metrics.MIGRATION_TRANSITIONS_TOTAL.inc(transitions)
        for profile_name, delta in evicted.items():
            if delta:
                descheduler_metrics.PODS_EVICTED_TOTAL.inc(
                    delta, profile=profile_name)
        return {
            "jobs_created": jobs_created,
            "migration_transitions": transitions,
            "profiles": statuses,
            "evicted": evicted,
        }
