"""Graceful-degradation ladder for the device dispatch.

One transient device error used to kill the whole scheduler: the cycle
driver re-raised any dispatch failure (the flight recorder kept the
wreck, but the process was done binding pods). A shared-cluster
scheduler must instead *shed capability, not availability* — the same
stance the reference takes for a missing NodeMetric (degrade, don't
block) and the sidecar takes for a dead gRPC socket (fall back to the
in-process step).

The ladder orders the dispatch's optional machinery by how much it buys
vs how much surface it exposes, and walks DOWN one rung at a time when
dispatch attempts keep failing:

  level 0  full            — everything as configured
  level 1  partial-mesh    — mesh dispatch on the SURVIVING submesh: a
                             fault attributable to specific mesh devices
                             sheds only those devices (koordguard) — the
                             snapshot/step cache rebuild on the smaller
                             mesh instead of collapsing to single-device
  level 2  no-mesh         — mesh dispatch off, single-device buffers
  level 3  serial-waves    — fused multi-wave off, K pinned to 1
  level 4  no-explain      — koordexplain attribution off
  level 5  host-fallback   — no device dispatch at all: a pure-host
                             numpy scheduling pass built on the diagnose
                             oracle (scheduler/diagnose.py), the proof
                             that every modeled predicate evaluates on
                             host

The partial-mesh rung exists only for failures that NAME their dead
devices (``attributable_device_ids``): an anonymous dispatch fault
cannot pick survivors and skips straight past it. A further attributable
fault while already AT partial-mesh shrinks the submesh in place (a
same-level transition) instead of dropping the whole mesh; re-promotion
to ``full`` always probes the FULL configured mesh back — a still-dead
device re-records itself when the probe fails.

Policy (scheduler/cycle.py wires it around both the serial and fused
dispatch windows, strictly BEFORE any binding is applied, so a failed
attempt is always safe to re-run):

  * first failure in a scheduling pass: retry once at the same level;
  * further failures: demote to the next rung that actually changes
    behavior for this scheduler's configuration (a no-mesh rung is
    meaningless when no mesh was configured, so it is skipped);
  * every transition is observable: ``koord_scheduler_degraded_level``
    gauge, ``koord_scheduler_dispatch_retries_total{stage}`` counters,
    a loud log line and a flight-recorder dump;
  * after ``promote_after`` consecutive clean cycles the ladder probes
    one rung UP. A probe that fails (a demotion during the probation
    window that follows every promotion) doubles ``promote_after`` —
    exponential backoff, capped — and surviving probation resets it.

Rungs below host-fallback do not exist: if the host pass itself raises,
the failure propagates as an unhandled cycle exception (flight recorder
``cycle_exception`` trigger) — the ladder is exhausted and something is
wrong beyond the device.

The port's one departure from the reference's ladder: it absorbs only
the recognised device faults (``is_device_fault``): an injected fault
(sim/faults.py), a device allocation failure and a dispatch deadline
overrun. Everything else a dispatch window raises passes through
unchanged, as a failed in-window store write does: a kernel build,
contract or launch failure (``ops/kernel_common.KernelContractError``:
nvcc missing or failing, a pod record that outgrows a block, any nonzero
cudaError of a launch), a wrapper's own argument check, a kernel library
that fails to load, an asynchronous CUDA error at readback (the port's
kernel faulting) and a path this slice of the port leaves out
(NotImplementedError). The ladder never retries them and never sheds to
the host fallback because of them — a retry cannot fix them, and a host
pass that still binds pods would hide a broken kernel. The reference's
XLA has no such failure mode at dispatch. The same holds for the
koordexplain passes (ops/explain_kernel.py, the full-chain kernel's terms
instance): a failure of theirs that is not a device fault is not demoted
away to the no-explain rung.

The mesh rungs are live where a mesh is configured (KOORD_TPU_MESH or
``Scheduler(mesh=)``, parallel/mesh.py: D virtual shards of the card, of
the CPU, or shards across processes over gloo): a fault naming shard
devices runs the surviving submesh (partial-mesh), an anonymous one drops
the mesh (no-mesh). Without a mesh the live rungs are full ->
serial-waves -> no-explain -> host-fallback, and a scheduler skips the
waves and explain rungs where those are off.

The host fallback trades scoring fidelity for survival: it binds only
plain pods (gang and quota admission need the batched kernel's atomic
barriers, so those pods stay queued until re-promotion), picks the
feasible node with the lowest post-placement utilization, and advances
the same host state mirror the fused-wave replay uses — capacity,
hostPort, CSI-volume, NUMA and affinity invariants hold exactly
(tests/test_sim.py churns it against the store-level invariant checker).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

LEVEL_FULL = 0
LEVEL_PARTIAL_MESH = 1
LEVEL_NO_MESH = 2
LEVEL_SERIAL_WAVES = 3
LEVEL_NO_EXPLAIN = 4
LEVEL_HOST_FALLBACK = 5

LEVEL_NAMES = ("full", "partial-mesh", "no-mesh", "serial-waves",
               "no-explain", "host-fallback")


def attributable_device_ids(exc: BaseException) -> frozenset:
    """Mesh device ids a dispatch failure NAMES as failed, or an empty
    set. Read from the exception's ``failed_device_ids`` attribute — the
    sim's device-loss fault carries it, and a runtime integration can
    attach the same attribute after parsing a device error. Only an
    attributable failure can engage the partial-mesh rung: anonymous
    faults cannot pick survivors. A mesh of cards' exchange timeout
    (ops/kernel_common.ExchangeTimeout) names the lost card's shards."""
    ids = getattr(exc, "failed_device_ids", None)
    if not ids:
        return frozenset()
    try:
        return frozenset(int(i) for i in ids)
    except (TypeError, ValueError):
        return frozenset()


def is_device_fault(exc: BaseException) -> bool:
    """May the ladder absorb this dispatch-window failure? Only a
    recognised device fault: an injected one (sim/faults.InjectedFault),
    a device allocation failure (scheduler/snapshot_cache.
    DeviceAllocationError, or torch's own out-of-memory error), a
    deadline overrun (scheduler/deadline.DispatchDeadlineExceeded) or a
    mesh of cards' exchange that timed out on a lost card
    (ops/kernel_common.ExchangeTimeout, which names the card's shards).
    Every other failure propagates out of the cycle (module docstring)."""
    import torch

    from koordinator_tpu_torch.ops.kernel_common import ExchangeTimeout
    from koordinator_tpu_torch.scheduler.deadline import (
        DispatchDeadlineExceeded,
    )
    from koordinator_tpu_torch.scheduler.snapshot_cache import (
        DeviceAllocationError,
    )
    from koordinator_tpu_torch.sim.faults import InjectedFault

    return isinstance(exc, (InjectedFault, DeviceAllocationError,
                            torch.cuda.OutOfMemoryError,
                            DispatchDeadlineExceeded, ExchangeTimeout))


class FusedDispatchDemoted(Exception):
    """Control flow, not an error: the fused dispatch window failed and
    the ladder demoted below fused waves — the cycle driver must re-run
    this scheduling pass through the serial path. Raised strictly before
    any binding of the failed dispatch was applied."""


def _rung_changes_behavior(level: int, features: Dict[str, bool]) -> bool:
    """Does demoting INTO ``level`` change anything for a scheduler with
    these configured features? Skipping no-op rungs keeps the ladder from
    burning retry budget on demotions that would fail identically."""
    if level == LEVEL_PARTIAL_MESH:
        # only meaningful when a mesh is configured AND the failure at
        # hand named dead devices with at least one survivor (the owner
        # sets this per failure — see Scheduler._on_dispatch_failure)
        return features.get("partial_mesh", False)
    if level == LEVEL_NO_MESH:
        return features.get("mesh", False)
    if level == LEVEL_SERIAL_WAVES:
        return features.get("waves", False)
    if level == LEVEL_NO_EXPLAIN:
        return features.get("explain", False)
    return True  # full and host-fallback always mean something


class DegradationLadder:
    """Demotion/re-promotion state machine for the dispatch path.

    Single-threaded by design: every method is called from the cycle
    thread only (the scheduler exposes read snapshots to other threads).
    ``observer`` (set by the owner) receives every transition record —
    the scheduler uses it to move the gauge, log, and dump the flight
    recorder.
    """

    def __init__(self, promote_after: int = 16,
                 max_promote_after: int = 512) -> None:
        if promote_after < 1:
            raise ValueError("promote_after must be >= 1")
        self.level = LEVEL_FULL
        self.promote_after = promote_after
        self._base_promote_after = promote_after
        self._max_promote_after = max(promote_after, max_promote_after)
        self.transitions: List[dict] = []
        self.observer: Optional[Callable[[dict], None]] = None
        self._clean = 0
        self._retried = False       # retry budget used this pass
        self._failed_this_cycle = False
        self._probation_left = 0    # cycles left in post-promotion probation
        self._seq = 0               # cycles observed (transition stamps)
        # features are only known at failure time (the owner passes
        # them); the promotion mirror reuses the last view. A ladder
        # that never failed never promotes, so {} is never consulted.
        self._features_seen: Dict[str, bool] = {}

    # ------------------------------------------------------------------
    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self.level]

    def snapshot(self) -> dict:
        """Read-only state for health/report surfaces. Read cross-thread
        (ObsServer /healthz) while the cycle thread transitions: the
        single read of ``level`` keeps level/level_name from tearing
        against a concurrent demotion; the remaining counters are
        monotonic and benign to race."""
        lvl = self.level
        return {
            "level": lvl,
            "level_name": LEVEL_NAMES[lvl],
            "clean_cycles": self._clean,
            "promote_after": self.promote_after,
            "transitions": len(self.transitions),
        }

    # ------------------------------------------------------------------
    def begin_pass(self) -> None:
        """Arm one retry for the scheduling pass starting now."""
        self._retried = False

    def on_failure(self, features: Dict[str, bool],
                   error: Optional[str] = None) -> str:
        """A dispatch attempt failed (before any binding was applied).
        Returns "retry" (re-run at the same level), "demoted" (settings
        changed — re-apply and re-run), or "exhausted" (already at the
        bottom rung; the caller re-raises)."""
        self._failed_this_cycle = True
        self._clean = 0
        self._features_seen = dict(features)
        if not self._retried:
            self._retried = True
            return "retry"
        target = None
        if (self.level == LEVEL_PARTIAL_MESH
                and features.get("partial_mesh_shrink", False)):
            # already on a submesh and the new failure named MORE dead
            # devices: shed those too (a same-level transition — the
            # observer re-applies settings and rebuilds the smaller
            # submesh) instead of dropping the whole mesh
            target = LEVEL_PARTIAL_MESH
        else:
            for lvl in range(self.level + 1, LEVEL_HOST_FALLBACK + 1):
                if _rung_changes_behavior(lvl, features):
                    target = lvl
                    break
        if target is None:
            return "exhausted"
        if self._probation_left > 0:
            # the re-promotion probe failed: back off exponentially
            self.promote_after = min(self.promote_after * 2,
                                     self._max_promote_after)
            self._probation_left = 0
        self._transition(target, f"dispatch failure: {error}")
        self._retried = False  # one fresh retry at the new level
        return "demoted"

    def note_cycle(self) -> None:
        """End of a completed cycle. Counts clean cycles toward the
        re-promotion probe and retires probation windows."""
        self._seq += 1
        if self._failed_this_cycle:
            self._failed_this_cycle = False
            return
        if self._probation_left > 0:
            self._probation_left -= 1
            if self._probation_left == 0:
                # the promoted level survived probation: forget the backoff
                self.promote_after = self._base_promote_after
        if self.level == LEVEL_FULL:
            return
        self._clean += 1
        if self._clean < self.promote_after:
            return
        # probe one rung up, skipping rungs that changed nothing on the
        # way down (their feature was never configured); features do not
        # change over a scheduler's lifetime, so the mirror of the
        # demotion skip is exact
        target = LEVEL_FULL
        for lvl in range(self.level - 1, LEVEL_FULL, -1):
            if _rung_changes_behavior(lvl, self._features_seen):
                target = lvl
                break
        self._transition(target, f"{self._clean} clean cycles")
        self._clean = 0
        self._probation_left = self._base_promote_after

    def _transition(self, to_level: int, reason: str) -> None:
        record = {
            "seq": self._seq,
            "from_level": self.level,
            "from": LEVEL_NAMES[self.level],
            "to_level": to_level,
            "to": LEVEL_NAMES[to_level],
            "reason": str(reason),
        }
        self.level = to_level
        self.transitions.append(record)
        if self.observer is not None:
            self.observer(record)


# ---------------------------------------------------------------------------
# host-fallback scheduling pass (the bottom rung)
# ---------------------------------------------------------------------------


def _fallback_shared_state(fc, n_real: int) -> dict:
    """shared_state for the host pass. The LoadAware reject rows are a
    compiled-op call — exactly the machinery that may be broken when the
    ladder reaches this rung — so a failure there degrades to "no
    load-aware filtering" (a softer placement policy, never an invariant:
    capacity/ports/volumes/NUMA all stay host-checked)."""
    from koordinator_tpu_torch.scheduler.diagnose import shared_state

    try:
        return shared_state(fc, n_real)
    except Exception as exc:
        logger.warning("host fallback: load-aware reject rows unavailable "
                       "(%s: %s); skipping the load threshold stage",
                       type(exc).__name__, exc)
        inputs = fc.base
        return {
            "alloc": np.asarray(inputs.allocatable, np.float32)[:n_real],
            "requested": np.asarray(inputs.requested, np.float32)[:n_real],
            "node_ok": np.asarray(inputs.node_ok, bool)[:n_real],
            "rej_np": np.zeros(n_real, bool),
            "rej_pr": np.zeros(n_real, bool),
        }


def host_fallback_schedule(fc, pods, n_real: int) -> np.ndarray:
    """Pure-host numpy scheduling pass: the ladder's last rung.

    Greedy in packed (queue) order, the serial bind-loop contract. Each
    pod's feasibility is evaluated with the diagnose oracle's predicates
    (scheduler/diagnose.host_feasible_mask) against a host state mirror
    advanced after every placement (the fused-wave replay's
    _WaveStateMirror), so in-batch hostPort/capacity/volume/NUMA
    contention is respected. Node choice is the feasible node with the
    lowest post-placement utilization (max over requested axes) —
    survival-mode balance, NOT the kernel's score chain; re-promotion
    restores scoring fidelity.

    Gang and quota pods are left unchosen (-1): their all-or-nothing /
    runtime-quota admission lives in the batched kernel's atomic
    barriers, and binding them greedily could violate exactly the
    invariants this mode exists to protect. They stay queued and bind on
    re-promotion.

    ``fc`` is the host (numpy) pack the dispatch uploads from, never the
    uploaded tensors: a CUDA tensor has no ``np.asarray``.

    Returns a chosen-node vector shaped like the kernel's readback
    (len(pods.keys), int32, -1 = unbound).
    """
    from koordinator_tpu_torch.scheduler.cycle import _WaveStateMirror
    from koordinator_tpu_torch.scheduler.diagnose import host_feasible_mask

    keys = pods.keys
    chosen = np.full(len(keys), -1, np.int32)
    if n_real <= 0 or not len(keys):
        return chosen
    mirror = _WaveStateMirror(fc)
    shared = _fallback_shared_state(fc, n_real)
    alloc = shared["alloc"]
    gang_id = np.asarray(fc.gang_id)
    quota_id = np.asarray(fc.quota_id)
    fit_requests = np.asarray(fc.base.fit_requests, np.float32)
    needs_numa = np.asarray(fc.needs_numa, bool)
    numa_policy = np.asarray(fc.numa_policy)
    requests = np.asarray(fc.requests, np.float32)
    # the patched view only changes when a placement commits; rebuilding
    # it lazily keeps the copy traffic O(commits), not O(pods) — most
    # iterations of a saturated queue commit nothing, and this is the
    # survival mode that must stay cheap
    fc_patched = None
    for i in range(len(keys)):
        if pods.unschedulable_reasons.get(i) is not None:
            continue  # encoding-budget overflow: no node can fix it
        if int(gang_id[i]) >= 0 or int(quota_id[i]) >= 0:
            continue  # kernel-only admission; stays pending
        if fc_patched is None:
            fc_patched = mirror.patched_fc()
        shared_i = dict(shared)
        shared_i["requested"] = mirror.requested[:n_real]
        feasible = host_feasible_mask(fc_patched, i, n_real,
                                      shared=shared_i)
        if not feasible.any():
            continue
        fit_req = fit_requests[i]
        after = mirror.requested[:n_real] + fit_req[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            util = np.where(alloc > 0, after / alloc, 0.0)
        score = util.max(axis=1)
        score[~feasible] = np.inf
        node = int(np.argmin(score))
        zone = -1
        if needs_numa[i] and int(numa_policy[node]) == 1:
            # SingleNUMANode policy: the mirror must charge ONE zone, the
            # first that fits whole — what the plugin's Reserve will pick
            req = requests[i]
            for k in range(mirror.numa_free.shape[1]):
                if bool(((req <= 0)
                         | (req <= mirror.numa_free[node, k])).all()):
                    zone = k
                    break
            if zone < 0:
                continue  # per-zone fit raced away; leave pending
        chosen[i] = node
        mirror.commit(i, node, zone)
        fc_patched = None  # state advanced: rebuild before the next read
    return chosen
