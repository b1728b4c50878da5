"""Coscheduling plugin host side: the gang cache.

Reference `plugins/coscheduling/core/gang_cache.go` + `gang.go`: gangs come from
PodGroup CRs or pod annotations; track member counts, assumed (bound) members,
schedule-cycle state, and gang-groups (annotation listing gangs that must be
co-admitted). The Permit barrier itself is the device-side post-pass
(ops/gang.py); this cache feeds it."""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.objects import Pod, PodGroup
from koordinator_tpu_torch.client.store import (
    KIND_POD,
    KIND_POD_GROUP,
    EventType,
    ObjectStore,
)
from koordinator_tpu_torch.scheduler.frameworkext import CycleContext, Plugin

ANNOTATION_GANG_GROUPS = "gang.scheduling.koordinator.sh/groups"


class CoschedulingPlugin(Plugin):
    name = "Coscheduling"

    def __init__(self, default_timeout_seconds: float = 600.0) -> None:
        self.pod_groups: Dict[str, PodGroup] = {}
        self.assumed: Dict[str, int] = {}     # gang -> bound member count
        self.members: Dict[str, int] = {}     # gang -> known member count
        # CoschedulingArgs.defaultTimeout: used when the PodGroup doesn't set
        # its own scheduleTimeoutSeconds
        self.default_timeout_seconds = default_timeout_seconds
        # gangs that reached min-member at least once: a running gang that
        # loses a member must NOT be timeout-failed (it is rescheduling, not
        # stuck); rebuilt from observed Scheduled phase after restart
        self._ever_scheduled: set = set()

    def register(self, store: ObjectStore) -> None:
        store.subscribe(KIND_POD_GROUP, self._on_pod_group)
        store.subscribe(KIND_POD, self._on_pod)

    def services(self):
        """frameworkext services endpoints (/apis/v1/plugins/Coscheduling/...)."""
        return {
            "gangs": lambda: {
                name: {
                    "min_member": pg.min_member,
                    "members": self.members.get(name, 0),
                    "assumed": self.assumed.get(name, 0),
                }
                for name, pg in sorted(self.pod_groups.items())
            }
        }

    def _on_pod_group(self, ev: EventType, pg: PodGroup, old) -> None:
        # keyed by the namespaced gang identity (core.go GetGangFullName):
        # same-named gangs in different namespaces are distinct gangs
        if ev is EventType.DELETED:
            self.pod_groups.pop(pg.meta.key, None)
            # a recreated gang with the same name is a fresh gang: it must be
            # timeout-eligible again (also bounds the latch set's growth)
            self._ever_scheduled.discard(pg.meta.key)
        else:
            self.pod_groups[pg.meta.key] = pg

    def _on_pod(self, ev: EventType, pod: Pod, old) -> None:
        gang = pod.gang_key
        if not gang:
            return
        if ev is EventType.ADDED:
            self.members[gang] = self.members.get(gang, 0) + 1
            if pod.is_assigned and not pod.is_terminated:
                self.assumed[gang] = self.assumed.get(gang, 0) + 1
        elif ev is EventType.MODIFIED:
            was = old is not None and old.is_assigned and not old.is_terminated
            now = pod.is_assigned and not pod.is_terminated
            if now and not was:
                self.assumed[gang] = self.assumed.get(gang, 0) + 1
            elif was and not now:
                self.assumed[gang] = max(0, self.assumed.get(gang, 0) - 1)
        elif ev is EventType.DELETED:
            self.members[gang] = max(0, self.members.get(gang, 0) - 1)
            if pod.is_assigned and not pod.is_terminated:
                self.assumed[gang] = max(0, self.assumed.get(gang, 0) - 1)

    def gang_groups(self, gang_name: str) -> List[str]:
        """Gangs co-admitted with this one (annotation on the PodGroup)."""
        pg = self.pod_groups.get(gang_name)
        if pg is None:
            return [gang_name]
        raw = pg.meta.annotations.get(ANNOTATION_GANG_GROUPS)
        if not raw:
            return [gang_name]
        try:
            groups = json.loads(raw)
            return list(groups) if groups else [gang_name]
        except (ValueError, TypeError):
            return [gang_name]

    def update_pod_group_status(self, store: ObjectStore,
                                now: Optional[float] = None) -> None:
        """PodGroup status controller analog (controller/podgroup.go:55-313):
        phase progression Pending -> Scheduling -> Scheduled, plus timeout —
        a gang that hasn't reached min-member within its schedule timeout
        (from creation) is marked Failed, and stays Failed (terminal)."""
        import time as _time

        now = _time.time() if now is None else now
        for pg in self.pod_groups.values():
            name = pg.meta.key
            scheduled = self.assumed.get(name, 0)
            if pg.phase == "Scheduled":  # restart recovery of the latch
                self._ever_scheduled.add(name)
            timeout = pg.schedule_timeout_seconds or self.default_timeout_seconds
            if scheduled >= pg.min_member:
                phase = "Scheduled"
                self._ever_scheduled.add(name)
            elif name in self._ever_scheduled:
                # once-scheduled gangs are rescheduling, never timeout-failed
                phase = "Scheduling" if scheduled else "Pending"
            elif pg.phase == "Failed":
                phase = "Failed"
            elif (timeout > 0 and pg.meta.creation_timestamp
                  and now - pg.meta.creation_timestamp > timeout):
                phase = "Failed"
            elif scheduled:
                phase = "Scheduling"
            else:
                phase = "Pending"
            if pg.scheduled != scheduled or pg.phase != phase:
                pg.scheduled, pg.phase = scheduled, phase
                store.update(KIND_POD_GROUP, pg)

    def timed_out_gangs(self) -> List[str]:
        """Gangs whose PodGroup is terminally Failed — the cycle driver
        excludes their pods from admission (permit timeout rejection)."""
        return [name for name, pg in self.pod_groups.items()
                if pg.phase == "Failed"]
