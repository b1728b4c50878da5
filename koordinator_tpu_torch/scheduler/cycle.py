"""The scheduling cycle driver: the rebuild's scheduleOne loop, in the port.

Where the reference runs one pod at a time through Go plugin dispatch
(frameworkext/framework_extender_factory.go:156-185), this driver drains the
whole pending queue per cycle:

  1. collect pending pods + unscheduled Reservation CRs (reservations ride the
     same queue as pseudo-pods, eventhandlers/reservation_handler.go semantics)
  2. reservation nomination pre-pass: pods matching an Available reservation are
     host-assigned to its node (the nominator prefers reservations; reserved
     resources are owner-restricted, so they bypass the open-capacity kernel)
  3. snapshot (incremental through SnapshotCache) -> device mirror
     (DeviceSnapshot) -> one full-chain round (the CUDA kernel on the card,
     the plain torch round on the CPU) -> gang Permit -> one readback
  4. per binding in queue order: plugin Reserve hooks (cpuset take, device pick)
     -> PreBind annotation accumulation -> single store patch (defaultprebind)
  5. Reserve failure vetoes the binding (unreserve earlier plugins); the pod
     stays pending for the next cycle — mirroring the reference's assume/bind
     error path; unbound pods get PodScheduled=False with the per-stage
     diagnosis, and PostFilter preemption reruns the pass once.

A port of the JAX package's ``Scheduler``. A cycle whose wave depth
resolves to 1 dispatches one round (serial dispatch); a depth K > 1 (the
default ``waves="auto"`` picks K = 8 at >= 4096 pending pods, 4 at >= 1024,
2 at >= 256) runs the fused multi-wave dispatch (models/fused_waves.py):
K dependent rounds on the device, replayed on the host as K logical
cycles. With ``replay_overlap`` on (the default) the waves are a chain of
one-wave dispatches, and the host replays wave w while the device runs
wave w+1; off, all K waves run in one call before the replay. Either way
the bindings, conditions, gang and quota writes are those of K serial
cycles, and the JAX package's byte for byte (tests/test_torch_cycle.py,
tests/test_torch_cycle_waves.py). With ``sidecar_address`` every cycle
sends its batch over gRPC to a ScheduleBatch server (scheduler/sidecar.py,
the single-round protocol: waves and explain demote, reasons "sidecar" and
"explain-sidecar"), and a transport failure runs the Scheduler's own step
on its device, counted in ``sidecar_fallbacks``. With ``mesh`` (or
KOORD_TPU_MESH=<n>|auto, parallel/mesh.py) the node axis shards over a mesh
of shard devices (virtual shards of the card or the CPU, or shards across
processes over gloo): the DeviceSnapshot uploads sharded, the sharded
steps (parallel/full_chain_mesh.py; on the card the node fields gathered
into kernel 1) run every dispatch shape, and the readback merges per shard,
with bindings equal to the single-device path's. The ladder's partial-mesh
and no-mesh rungs reconfigure it. A sidecar turns the mesh off.

koordexplain (``explain="counts"|"full"`` or KOORD_TPU_EXPLAIN) rides every
dispatch: the per-stage reject counts of every pod (per wave on the fused
paths) and, at "full", the decision-time score terms come back with the
bindings, and the unschedulable messages become a formatter over the
counts (scheduler/diagnose.format_stage_counts) instead of the host
recompute. On the card the counts come from the CUDA pass of
ops/explain_kernel.py and the terms from the full-chain kernel's terms
instance, never from the plain round; bindings are byte-identical to
explain off. ``explain_record(pod)`` serves /explain (obs/server.py).

A failed dispatch window meets the degradation ladder
(scheduler/degrade.py), as in the JAX package: on a device fault it
retries once, then demotes the fused waves to serial dispatch, then to a
pure-host pass, and clean cycles promote it back. Any other failure (a
kernel build, contract or launch failure, a failed store write) passes
through the ladder and out of ``run_cycle``.

Steps are cached per scheduler by shape signature (P/N/G buckets, gangs,
groups, active axes; the fused step also by K and its side inputs).
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

from koordinator_tpu_torch.api.objects import (
    ObjectMeta,
    Pod,
    PodSpec,
    Reservation,
)
from koordinator_tpu_torch.api.resources import NUM_RESOURCES, PACK_SCALE
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    KIND_PV,
    KIND_PVC,
    KIND_RESERVATION,
    KIND_STORAGECLASS,
    ObjectStore,
)
from koordinator_tpu_torch.models.convert import check_device, to_device
from koordinator_tpu_torch.models.full_chain import (
    EXPLAIN_STAGE_KEYS,
    EXPLAIN_TERMS,
    build_best_full_chain_step,
)
from koordinator_tpu_torch.models.fused_waves import (
    MAX_WAVES,
    ClaimSides,
    ProdSides,
    ResSides,
    WaveSideInputs,
    initial_wave_carry,
)
from koordinator_tpu_torch.obs import Tracer
from koordinator_tpu_torch.ops.fit import with_pod_count
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.ops.volumes import (
    analyze_pending_claims,
    attached_claim_sets,
    build_claim_pack,
    host_effective_vol_needed,
)
from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
from koordinator_tpu_torch.scheduler.deadline import (
    DeadlineWatchdog,
    DispatchDeadlineExceeded,
    deadline_seconds_from,
)
from koordinator_tpu_torch.scheduler.degrade import (
    LEVEL_FULL,
    LEVEL_HOST_FALLBACK,
    LEVEL_NO_EXPLAIN,
    LEVEL_NO_MESH,
    LEVEL_PARTIAL_MESH,
    LEVEL_SERIAL_WAVES,
    DegradationLadder,
    FusedDispatchDemoted,
    attributable_device_ids,
    host_fallback_schedule,
    is_device_fault,
)
from koordinator_tpu_torch.scheduler.frameworkext import (
    BindResult,
    CycleContext,
    CycleResult,
    FrameworkExtender,
    ScoreTransformer,
)
from koordinator_tpu_torch.scheduler.diagnose import format_stage_counts
from koordinator_tpu_torch.scheduler.sidecar import (
    SidecarClient,
    schedule_batch_or_fallback,
)
from koordinator_tpu_torch.scheduler.plugins import DEFAULT_PLUGINS
from koordinator_tpu_torch.scheduler.snapshot import (
    ClusterState,
    build_full_chain_inputs,
    reduce_to_active_axes,
)

RESERVATION_POD_PREFIX = "__reservation__/"

# koordwatch demotion registry: every reason a cycle can run below its
# configured wave/explain/mesh level (_note_demotion refuses any other).
DEMOTION_REASONS = frozenset({
    # wave-depth demotions (_effective_waves)
    "ladder-serial-waves",      # degradation ladder at/below serial rung
    "sidecar",                  # the gRPC sidecar protocol is single-round
    "non-expressible-transformer",  # a ScoreTransformer without device_pass
    "claim-entangled",          # unbound-WFFC claim interference or claim
                                # factorization budget overflow (ops/volumes)
    # koordexplain demotions
    "explain-sidecar",
    "explain-ladder",
    # per-cycle mesh reconfiguration accounting
    "mesh-off",
    "partial-mesh",
})
RETIRED_DEMOTION_REASONS = frozenset({
    "pending-reservations",     # carried: reservation rows + in-dispatch
                                # nomination (models/fused_waves.py)
    "claim-pods",               # carried: hot-claim columns (ops/volumes.py)
    "prod-usage-score",         # carried: est_sum_prod + la_adj_prod split
    "score-transformer",        # expressible transformers run as tensor
                                # passes; the rest demote as
                                # non-expressible-transformer
})

# failure reasons whose condition message is recomputed from the packed
# batch (scheduler/diagnose.py); the deferral path keeps the batch alive
# only when one of these is present — the two sites must stay in sync
DIAGNOSED_REASONS = ("no feasible node", "admission rejected")


def waves_from_env():
    """KOORD_TPU_WAVES=K pins the fused multi-wave depth (K rounds per
    device dispatch, models/fused_waves.py); "auto" (the default) picks K
    from the pending-queue depth, K=1 being the exact serial path."""
    raw = os.environ.get("KOORD_TPU_WAVES", "auto").strip().lower()
    if raw in ("", "auto"):
        return "auto"
    try:
        return max(1, min(int(raw), MAX_WAVES))
    except ValueError:
        logger.warning("KOORD_TPU_WAVES=%r not an int; using auto", raw)
        return "auto"


def explain_from_env():
    """KOORD_TPU_EXPLAIN=off|counts|full gates koordexplain decision
    attribution (models/full_chain.explain_stage_counts): "counts" emits
    the per-pod per-stage rejected-node counts in the scheduling dispatch
    (diagnose becomes a pure formatter over them), "full" adds the winning
    node's per-plugin score terms + runner-up for bound pods. Returns
    None (off), "counts" or "full"."""
    raw = os.environ.get("KOORD_TPU_EXPLAIN", "off").strip().lower()
    if raw in ("", "off", "0", "false", "no"):
        return None
    if raw in ("counts", "on", "1", "true"):
        return "counts"
    if raw == "full":
        return "full"
    logger.warning("KOORD_TPU_EXPLAIN=%r unknown; explain stays off", raw)
    return None


def replay_overlap_from_env() -> bool:
    """KOORD_TPU_REPLAY_OVERLAP=0 selects the byte-exact serial-replay
    twin: a fused multi-wave cycle runs all K waves in one call and
    replays them on the host after its readback, and the deferred-
    condition flush keeps per-pod store writes (event granularity
    included). Default on: the waves run as a chain of one-wave
    dispatches, wave w+1 dispatched before wave w's rows are read back so
    the host replay of wave w overlaps the device's wave w+1, each wave's
    bind patches land as ONE store transaction, and one flush lands as
    ONE ``store.update_many`` transaction."""
    return os.environ.get("KOORD_TPU_REPLAY_OVERLAP", "1") != "0"


def pack_overlap_from_env() -> bool:
    """KOORD_TPU_PACK_OVERLAP=0 keeps the incremental pack strictly in
    the inter-window gap (the byte-parity twin). Default on: cycle N's
    device window pre-packs the next cycle's candidate pod rows into the
    pack memo (snapshot.py
    prepack_pending_rows) while the device runs — rows dirtied later in
    the window reconcile through the (key, resourceVersion) memo keys,
    so the produced ScheduleInputs are byte-identical either way
    (scheduler/pipeline_parity.run_pack_overlap_parity gates it)."""
    return os.environ.get("KOORD_TPU_PACK_OVERLAP", "1") != "0"


def cycle_deadline_from_env():
    """KOORD_TPU_CYCLE_DEADLINE_MS=N arms the flight recorder's
    deadline-overrun trigger: a cycle slower than N ms dumps the ring.
    Unset/0 disables (the default)."""
    raw = os.environ.get("KOORD_TPU_CYCLE_DEADLINE_MS", "").strip()
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        logger.warning("KOORD_TPU_CYCLE_DEADLINE_MS=%r not a number; "
                       "deadline trigger off", raw)
        return None
    return ms / 1000.0 if ms > 0 else None


def watch_from_env() -> bool:
    """KOORD_TPU_WATCH=0 turns koordwatch off (see the canonical helper
    in obs/timeline.py — shared with the standalone rebalance/colo
    timelines so the kill switch covers every consumer)."""
    from koordinator_tpu_torch.obs.timeline import watch_from_env as _watch

    return _watch()


def _auto_waves(queue_depth: int) -> int:
    """Depth-based auto-K: the fused dispatch amortizes the fixed
    dispatch+readback overhead over K dependent rounds, but each extra
    wave costs real device work, so shallow queues (where one round
    drains everything bindable and the fixed overhead is small relative
    to host work anyway) stay serial. Powers of two only, so the
    compile cache sees at most 4 distinct K values."""
    if queue_depth >= 4096:
        return 8
    if queue_depth >= 1024:
        return 4
    if queue_depth >= 256:
        return 2
    return 1


class _HostWriteFailure(Exception):
    """Wraps a store/host failure raised INSIDE a ladder-wrapped dispatch
    window (the pipelined in-window deferred flush). Not a device fault:
    the ladder must not absorb it (shedding device capability cannot fix
    a store write), so the window unwraps and re-raises the original as
    an unhandled cycle exception (flight recorder ``cycle_exception``
    trigger)."""


class _DeferredFlushTxn:
    """Read-your-writes view for one deferred-condition flush: patches
    accumulate here and land as ONE ``store.update_many`` transaction
    (the vectorized store write the wave-replay batching promises),
    while later entries in the same flush still see earlier entries'
    patches — the sequential supersede/idempotence semantics of per-pod
    writes are preserved exactly; only the per-pod lock round-trips and
    duplicate MODIFIED events for re-verdicted pods are gone."""

    def __init__(self, store: ObjectStore) -> None:
        self._store = store
        self.pending: Dict[str, Pod] = {}

    def get(self, key: str) -> Optional[Pod]:
        obj = self.pending.get(key)
        return obj if obj is not None else self._store.get(KIND_POD, key)

    def put(self, obj: Pod) -> None:
        self.pending[obj.meta.key] = obj

    def flush(self) -> None:
        if self.pending:
            self._store.update_many(KIND_POD, list(self.pending.values()))
            self.pending.clear()


def _np_spread_fill(row: np.ndarray, req: np.ndarray, zone: int) -> None:
    """In-place numpy replica of ops/numa.numa_spread_fill on one node's
    [K, R] free block: all from ``zone`` when single-numa, else the
    lowest-zones-first waterfall. Same float32 operations in the same
    order as the kernel, so the mirror cannot drift by a ULP."""
    if zone >= 0:
        row[zone] -= req
        return
    remaining = req.astype(np.float32, copy=True)
    for k in range(row.shape[0]):
        take = np.minimum(row[k], remaining)
        row[k] = row[k] - take
        remaining = remaining - take


class _WaveStateMirror:
    """Host numpy replica of the fused kernel's carried node/quota state
    (models/fused_waves.py), advanced wave by wave with the read-back
    bindings. Feeds per-wave unschedulability diagnosis
    (scheduler/diagnose.py) the SAME wave-start state serial cycle w's
    packed batch would contain — a pod that stays unbound across waves
    must report cycle-w's per-stage counts, not cycle-1's."""

    def __init__(self, fc, claims=None, res_alloc=None) -> None:
        self._fc = fc
        # carried-state twins: the hot-claim pack (ops/volumes.py
        # ClaimPack, host arrays) and the reservation rows' packed
        # allocatable vectors — None when the dispatch carries neither
        self._claims = claims
        self._res_alloc = (np.asarray(res_alloc, np.float32)
                           if res_alloc is not None else None)
        self.requested = np.array(fc.base.requested, np.float32, copy=True)
        self.quota_used = np.array(fc.quota_used, np.float32, copy=True)
        self.numa_free = np.array(fc.numa_free, np.float32, copy=True)
        self.bind_free = np.array(fc.bind_free, np.float32, copy=True)
        self.port_used = np.array(fc.port_used, np.float32, copy=True)
        self.vol_free = np.array(fc.vol_free, np.float32, copy=True)
        self.aff_count = np.array(fc.aff_count, np.float32, copy=True)
        self.anti_cover = np.array(fc.anti_cover, np.float32, copy=True)
        self.aff_exists = np.array(fc.aff_exists, bool, copy=True)
        # static per-pod gathers
        self._fit_requests = np.asarray(fc.base.fit_requests, np.float32)
        self._requests = np.asarray(fc.requests, np.float32)
        self._needs_numa = np.asarray(fc.needs_numa, bool)
        self._needs_bind = np.asarray(fc.needs_bind, bool)
        self._cores = np.asarray(fc.cores_needed, np.float32)
        self._wants = np.asarray(fc.pod_port_wants, bool)
        self._vol_needed = np.asarray(fc.vol_needed, np.float32)
        self._vol_group = np.asarray(fc.node_vol_group)
        self._quota_id = np.asarray(fc.quota_id)
        self._ancestors = np.asarray(fc.quota_ancestors)
        self._aff_dom = np.asarray(fc.aff_dom, np.float32)
        self._aff_match = np.asarray(fc.pod_aff_match, bool)
        self._anti_req = np.asarray(fc.pod_anti_req, bool)
        if self._claims is not None:
            n = self.requested.shape[0]
            self._claim_new = np.zeros((n, self._claims.n_claims),
                                       np.float32)
            self._vol_new = np.zeros(n, np.float32)
            self._vol_free0 = np.array(fc.vol_free, np.float32, copy=True)

    def commit(self, i: int, node: int, zone: int) -> None:
        """Apply one kernel-committed binding, mirroring
        commit_pod_state's kept-only replay form."""
        self.requested[node] += self._fit_requests[i]
        self._commit_footprint(i, node, zone)
        if self._claims is None:
            # exemption-free batches: the running count IS the attached-
            # set rebuild (every claim unique — ops/volumes.py)
            self.vol_free[node] -= self._vol_needed[i][self._vol_group[node]]
        else:
            # hot claims: track set growth; end_wave() rebuilds vol_free
            cp = self._claims
            self._claim_new[node] = np.maximum(
                self._claim_new[node],
                cp.pod_claim[i] * (1.0 - cp.covered0[node]))
            self._vol_new[node] += cp.pod_nonhot[i]

    def commit_reservation(self, slot: int, node: int) -> None:
        """A reservation pseudo-pod row bound: the CR holds capacity but
        is not a pod — next-wave state carries the restore transformer's
        allocatable add only (no pod-count slot, no estimate, no NUMA or
        affinity footprint)."""
        self.requested[node] += self._res_alloc[slot]

    def commit_nominated(self, i: int, node: int, zone: int) -> None:
        """A pod nominated onto an Available reservation: its usage
        lives inside the reservation's already-counted footprint, so the
        node's requested row is untouched; NUMA/cpuset/affinity effects
        apply like any bind."""
        self._commit_footprint(i, node, zone)

    def apply_succeed(self, consumer_row: int, slot: int,
                      node: int) -> None:
        """The reconcile's consumed-allocate-once transition, one wave
        after the consumption: the reservation stops being counted and
        its consumer falls back to direct accounting."""
        self.requested[node] = (
            (self.requested[node] - self._res_alloc[slot])
            + self._fit_requests[consumer_row])

    def end_wave(self) -> None:
        """Wave-boundary claim rebuild: vol_free recomputed set-wise
        from the dispatch-start value (integer-exact, like the host's
        limit - len(attached) recompute)."""
        if self._claims is not None:
            self.vol_free = (self._vol_free0 - self._vol_new
                             - self._claim_new.sum(axis=1))

    def _commit_footprint(self, i: int, node: int, zone: int) -> None:
        req = self._requests[i]
        if self._needs_numa[i]:
            _np_spread_fill(self.numa_free[node], req, zone)
        if self._needs_bind[i]:
            self.bind_free[node] -= self._cores[i]
        if self._wants.shape[1]:
            self.port_used[node] = np.maximum(
                self.port_used[node],
                self._wants[i].astype(np.float32))
        qid = int(self._quota_id[i])
        if qid >= 0:
            for g in self._ancestors[qid]:
                if g >= 0:
                    self.quota_used[g] += req
        for t in range(self._aff_dom.shape[1]):
            dom = self._aff_dom[node, t]
            if self._aff_match[i, t]:
                self.aff_exists[t] = True
                if dom >= 0:
                    self.aff_count[self._aff_dom[:, t] == dom, t] += 1.0
            if self._anti_req[i, t] and dom >= 0:
                self.anti_cover[self._aff_dom[:, t] == dom, t] += 1.0

    def patched_fc(self):
        """A FullChainInputs view with the mirror's CURRENT state frozen
        in (copies: the deferred-diagnosis queue may hold it while later
        waves advance the mirror)."""
        fc = self._fc
        patched = fc._replace(
            base=fc.base._replace(requested=self.requested.copy()),
            quota_used=self.quota_used.copy(),
            numa_free=self.numa_free.copy(),
            bind_free=self.bind_free.copy(),
            port_used=self.port_used.copy(),
            vol_free=self.vol_free.copy(),
            aff_count=self.aff_count.copy(),
            anti_cover=self.anti_cover.copy(),
            aff_exists=self.aff_exists.copy(),
        )
        if self._claims is not None:
            # the per-(pod, node) effective volume view at current claim
            # state — what the regrouped [P, VG'] gather would produce
            patched = patched._replace(
                vol_needed=host_effective_vol_needed(
                    fc.vol_needed, fc.node_vol_group,
                    self._claims.pod_claim, self._claim_new),
                node_vol_group=np.arange(
                    self.requested.shape[0], dtype=np.int32))
        return patched


def _apply_mirror_op(mirror: _WaveStateMirror, op: Tuple) -> None:
    """Replay one typed wave-state mirror op (the lazy backlog entries
    the fused replay accumulates): pod/nominated/reservation commits,
    the delayed Succeeded transition, and the wave-boundary claim
    rebuild — in the exact order the device carry applied them."""
    kind = op[0]
    if kind == "pod":
        mirror.commit(op[1], op[2], op[3])
    elif kind == "nom":
        mirror.commit_nominated(op[1], op[2], op[3])
    elif kind == "res":
        mirror.commit_reservation(op[1], op[2])
    elif kind == "succ":
        mirror.apply_succeed(op[1], op[2], op[3])
    elif kind == "wave_end":
        mirror.end_wave()
    else:  # pragma: no cover - programming error
        raise ValueError(f"unknown mirror op {kind!r}")


def resolve_mesh(mesh, device):
    """``mesh=`` of a Scheduler, DeviceRebalancer or DeviceColoReconciler:
    None reads KOORD_TPU_MESH, an int or string is parsed as it
    (parallel/mesh.mesh_from_env, over ``device``'s shard devices), a
    Mesh is taken as it is."""
    from koordinator_tpu_torch.parallel.mesh import mesh_from_env

    if mesh is None:
        return mesh_from_env(device=device)
    if isinstance(mesh, (int, str)):
        return mesh_from_env(env_value=mesh, device=device)
    return mesh


def _local(t):
    """A tensor this process holds: a replicated mesh output's local
    replica (parallel/mesh.ShardedTensor), or the tensor itself."""
    return t.local() if hasattr(t, "local") else t


def _host(t) -> np.ndarray:
    """A step output as host numpy, through one replica under a mesh."""
    return _local(t).cpu().numpy()


class Scheduler:
    """koord-scheduler analog: batched cycles against the object store.

    ``device`` is where rounds run: "cuda" (the default; the CUDA kernel)
    or "cpu" (the plain torch round). Asking for CUDA where there is none
    raises."""

    def __init__(
        self,
        store: ObjectStore,
        args: Optional[LoadAwareArgs] = None,
        scheduler_name: str = "koord-scheduler",
        config: Optional["SchedulerConfiguration"] = None,
        elector=None,
        sidecar_address: Optional[str] = None,
        waves=None,
        explain=None,
        mesh=None,
        ladder=None,
        replay_overlap=None,
        dispatch_deadline_ms=None,
        watch=None,
        pack_overlap=None,
        warmup=None,
        device="cuda",
    ):
        from koordinator_tpu_torch.scheduler.config import SchedulerConfiguration
        from koordinator_tpu_torch.scheduler.plugins.reservation import (
            ReservationController,
        )

        import dataclasses as _dc

        self.device = check_device(device)
        # the host event loop may offload the kernel pass to a gRPC
        # sidecar (the Go<->sidecar integration shape); a transport failure
        # runs this Scheduler's own step on its device instead, never
        # wedging the cycle (_dispatch_sidecar)
        self._sidecar_client = (
            SidecarClient(sidecar_address) if sidecar_address else None)
        self.sidecar_fallbacks = 0
        # mesh-backed dispatch (KOORD_TPU_MESH=<ndev>|auto): node-state
        # tensors shard over the mesh (parallel/mesh.py), each pod's rows
        # compute per shard and the winners merge across shards. The
        # sidecar RPC protocol is single-device, so a sidecar turns the
        # mesh off, as in the JAX package.
        if self._sidecar_client is None:
            from koordinator_tpu_torch.parallel.mesh import (
                refuse_scheduler_across_processes,
            )

            self.mesh = resolve_mesh(mesh, self.device)
            refuse_scheduler_across_processes(self.mesh, "the Scheduler")
        else:
            if (mesh if mesh is not None
                    else os.environ.get("KOORD_TPU_MESH", "")) not in (
                        "", "0", "off"):
                logger.warning("KOORD_TPU_MESH ignored: the sidecar RPC "
                               "protocol is single-device")
            self.mesh = None
        scheduler_metrics.MESH_DEVICES.set(
            float(self.mesh.size) if self.mesh is not None else 0.0)
        # koordguard: failures that name mesh devices demote mesh ->
        # partial mesh (the survivors), anonymous ones mesh -> no mesh;
        # clean cycles probe back up. Devices shed by attributable faults
        # accumulate in _lost_device_ids until a promotion to full probes
        # the whole mesh back.
        self._configured_mesh = self.mesh
        # (real nodes, padded node axis) of the last dispatch's upload:
        # the mesh readback's shard-imbalance input
        self._node_rows = (0, 0)
        self._lost_device_ids: set = set()
        self._submesh_cache: Dict[frozenset, object] = {}
        # koordexplain (KOORD_TPU_EXPLAIN): None=off, "counts", "full".
        # Unknown strings fail loudly, as in the JAX package.
        if explain not in (None, "off", "counts", "full"):
            raise ValueError(
                f"explain must be None, 'off', 'counts' or 'full'; "
                f"got {explain!r}")
        self.explain_spec = (explain_from_env() if explain is None
                             else (None if explain == "off" else explain))
        # fused multi-wave depth: K rounds per device dispatch. "auto"
        # picks from queue depth per cycle (_effective_waves); an int pins
        # it.
        self.waves_spec = waves_from_env() if waves is None else waves
        # koordwatch: this cycle's demotion reasons (reset per cycle)
        self._cycle_demotions: List[str] = []
        # the claim analysis _effective_waves stashes for the dispatch's
        # side-input encode (None: no claim-carrying pod)
        self._claim_analysis = None
        # a fused dispatch queues its logical cycles' condition writes on
        # the deferred machinery and flushes them once at its end
        self._defer_condition_writes = False

        base = config or SchedulerConfiguration()
        # explicit args win over config (older call sites pass args directly);
        # keep a private copy so the caller's config object is never mutated,
        # and validate what will actually be used
        self.config = (_dc.replace(base, load_aware=args)
                       if args is not None else base)
        self.config.validate()
        self.store = store
        self.args = self.config.load_aware
        self.scheduler_name = scheduler_name
        self.extender = FrameworkExtender(store)
        numa_args = self.config.node_numa_resource
        plugin_kwargs = {
            "NodeNUMAResource": dict(
                max_ref_count=numa_args.max_ref_count,
                default_cpu_bind_policy=numa_args.default_cpu_bind_policy,
                numa_allocate_strategy=numa_args.numa_allocate_strategy,
            ),
            "Coscheduling": dict(
                default_timeout_seconds=self.config.coscheduling.default_timeout_seconds,
            ),
            "DeviceShare": dict(
                scoring_strategy=self.config.device_share.scoring_strategy,
            ),
        }
        for cls in DEFAULT_PLUGINS:
            plugin = cls(**plugin_kwargs.get(cls.name, {}))
            self.extender.register_plugin(plugin)
        # DeviceShare contributes NUMA hints to the shared topology admit
        # (GetPodTopologyHints, deviceshare/topology_hint.go:33)
        numa_plugin = self.extender.plugin("NodeNUMAResource")
        device_plugin = self.extender.plugin("DeviceShare")
        if numa_plugin is not None and device_plugin is not None:
            numa_plugin.topology_manager.register_provider(device_plugin)
        res_plugin = self.extender.plugin("Reservation")
        self.reservation_controller = (
            ReservationController(
                res_plugin, store,
                self.config.reservation.gc_duration_seconds)
            if res_plugin else None
        )
        if res_plugin is not None:
            from koordinator_tpu_torch.scheduler.plugins.reservation import (
                ReservationRestoreTransformer,
            )

            self.extender.register_transformer(
                ReservationRestoreTransformer(store)
            )
        quota_plugin = self.extender.plugin("ElasticQuota")
        self.quota_revoke_controller = (
            quota_plugin.revoke_controller(store, self.config.elastic_quota)
            if quota_plugin else None
        )
        from koordinator_tpu_torch.scheduler.preempt import QuotaPreemptor

        self.preemptor = (
            QuotaPreemptor(store, quota_plugin) if quota_plugin else None
        )
        # active/standby gating (cmd/koord-scheduler/app/server.go:227-256):
        # with an elector, a cycle runs only while this replica holds the lease
        self.elector = elector
        # koordtrace: every cycle emits a root span with the per-stage
        # split (snapshot/encode/kernel/bind)
        self.tracer = Tracer()
        # the step memo, keyed by shape signature; one per scheduler, so
        # no step is ever shared between two schedulers. It is shared with
        # the background warm-up ladder, whose thread replays rungs through
        # the same _get_*step chokepoints while the cycle thread
        # dispatches: the lock covers only the dict probes, never a step
        # build (a racing miss costs one duplicate build, last write wins)
        self._step_lock = threading.Lock()
        # koordlint: guarded-by(_step_lock)
        self._step_cache: Dict[Tuple, object] = {}
        # per-thread: whether this thread's most recent _get_*step call
        # built a fresh step (the background ladder's misses must not leak
        # into the cycle thread's compiled-dispatch attribution)
        self._step_tls = threading.local()
        # cumulative wall seconds of pack/encode work and of compile work
        # (step builds + the kernel windows of freshly built steps, where
        # a kernel library loads, + the warm-up ladder's zero calls); the
        # sim's crash-restart report splits its recovery wall clock with
        # these. Lock-guarded: the background ladder adds from its thread
        self._wall_lock = threading.Lock()
        self.pack_wall_seconds = 0.0     # koordlint: guarded-by(_wall_lock)
        self.compile_wall_seconds = 0.0  # koordlint: guarded-by(_wall_lock)
        # warm-up (scheduler/warmup.py): KOORD_TPU_COMPILE_CACHE_DIR arms
        # the rung index; the ladder (started at the END of construction)
        # replays recorded rungs so a restarted scheduler's first cycle is
        # an in-memory step-cache hit with the card's first-call costs paid
        from koordinator_tpu_torch.scheduler.warmup import (
            compile_cache_dir_from_env,
            configure_compile_cache,
            warmup_mode_from_env,
        )

        self.compile_cache_dir = configure_compile_cache()
        self._warmup_mode = (warmup_mode_from_env() if warmup is None
                             else warmup)
        if self._warmup_mode == "auto":
            # keyed on the ENV knob, not the process-wide dir: a test (or
            # co-resident tool) that armed the index for itself must not
            # opt every later Scheduler into a background ladder
            self._warmup_mode = ("background"
                                 if compile_cache_dir_from_env()
                                 else "off")
        self.warmup = None
        # steady-state compile guard: armed when warm-up completes, dropped
        # on every ladder transition (those legitimately re-key the step
        # cache). A miss while armed counts and calls compile_miss_hook.
        # Single-writer bool handoff (the ladder thread arms it once, the
        # cycle thread reads/clears): deliberately lock-free
        self._steady_state = False   # koordlint: guarded-by(none)
        self.compile_miss_hook = None
        # the backend of the last dispatch ("cuda" or "serial") and the
        # count of dispatch windows: one kernel launch per window on the
        # card, which is how a run shows the cycle went through the kernel
        self.last_backend: Optional[str] = None
        self.dispatches = 0
        # pack/device overlap (KOORD_TPU_PACK_OVERLAP): pre-pack the
        # next cycle's candidate pod rows inside this cycle's device
        # window. An explicit argument pins it (the parity twins need it).
        self.pack_overlap = (pack_overlap_from_env()
                             if pack_overlap is None else bool(pack_overlap))
        # parity/test hook: called with the post-reduce host
        # FullChainInputs at the end of every encode
        self.encode_observer = None
        # overlapped wave replay (KOORD_TPU_REPLAY_OVERLAP): fused waves as
        # a chain of one-wave dispatches replayed while the next runs, and
        # one store transaction per flush; 0 is the single-call twin with
        # per-pod writes
        self.replay_overlap = (replay_overlap_from_env()
                               if replay_overlap is None
                               else bool(replay_overlap))
        # cycle flight recorder (obs/flight.py): decision records for the
        # last N cycles, dumped on deadline overrun / unhandled cycle
        # exception / HTTP demand
        from koordinator_tpu_torch.obs.flight import FlightRecorder
        from koordinator_tpu_torch.obs.timeline import DeviceTimeline

        self.flight = FlightRecorder(
            dump_counter=scheduler_metrics.FLIGHT_DUMPS)
        # koordwatch: the device timeline. KOORD_TPU_WATCH=0 (or
        # watch=False) is the kill switch — decision ids keep minting
        # but the ring stops recording.
        self.watch_enabled = (watch_from_env() if watch is None
                              else bool(watch))
        self.timeline = DeviceTimeline(
            window_histogram=scheduler_metrics.DEVICE_WINDOW_SECONDS,
            idle_gauge=scheduler_metrics.DEVICE_IDLE_FRACTION,
            enabled=self.watch_enabled)
        # per-cycle koordwatch state, reset at run_cycle start: the
        # decision ids of this cycle's device windows and the id of the
        # window currently open (stamped onto /explain attribution)
        self._cycle_decision_ids: List[str] = []
        self._current_decision_id: Optional[str] = None
        self.cycle_deadline_seconds = cycle_deadline_from_env()
        self._cycle_counter = 0
        # koordguard dispatch deadline (scheduler/deadline.py,
        # KOORD_TPU_DISPATCH_DEADLINE_MS): the designated readback sync
        # runs under the watchdog; an overrun counts, flight-dumps and
        # raises out of the cycle. None/0 (the default) keeps it inline.
        self.dispatch_deadline_seconds = deadline_seconds_from(
            dispatch_deadline_ms)
        self.dispatch_watchdog = DeadlineWatchdog(
            self.dispatch_deadline_seconds,
            on_overrun=self._on_deadline_overrun)
        # graceful-degradation ladder (scheduler/degrade.py): dispatch
        # failures demote fused waves -> serial waves -> the pure-host
        # fallback instead of killing the scheduler; clean cycles probe
        # back up. With a mesh configured, device faults first shed the
        # named shard devices (partial-mesh), then the mesh (no-mesh).
        self.ladder = ladder if ladder is not None else DegradationLadder()
        self.ladder.observer = self._on_ladder_transition
        scheduler_metrics.DEGRADED_LEVEL.set(float(self.ladder.level))
        # sim/test failure-injection hook: a callable(stage) invoked at the
        # top of every device-dispatch window ("serial"/"fused"); raising
        # from it exercises the ladder exactly like a real device fault
        # (sim/faults.FaultPlan arms it)
        self.fault_injector = None
        # test latency hook: a callable() invoked inside every monitored
        # readback sync — sleeping in it is a slow-not-dead device
        self.sync_delay_injector = None
        # test upload-failure hook, propagated onto every DeviceSnapshot
        # this scheduler builds (see the property below)
        self._upload_fault_injector = None
        # pipelined-cycle mode (CyclePipeline): diagnose/condition writes
        # for unbound pods are deferred into the NEXT cycle's kernel
        # window so host work overlaps device execution. Off by default —
        # plain run_cycle callers keep the strictly serial path.
        self.pipeline_mode = False
        # (items, last-batch tuple, now) per deferral
        self._deferred_diagnose: List[Tuple[list, object, float]] = []
        self._flushed_this_cycle = False
        # last DeviceSnapshot stats snapshot, for counter deltas
        self._upload_stats_last: Dict[str, int] = {}
        # chained waves abandoned by a deadline overrun: their pinned rows
        # and events stay referenced until the events complete
        self._abandoned_waves: List[Tuple] = []
        # liveness for health_snapshot: (wall clock, waves) of the last
        # completed cycle, read from other threads
        self._health_lock = threading.Lock()
        # koordlint: guarded-by(_health_lock)
        self._last_cycle_end: Optional[Tuple[float, int]] = None
        # /explain surface state: written by the cycle thread, read by the
        # ObsServer's handler threads (the most recent decision
        # attribution per pod key, capped at 4096 entries)
        # koordlint: guarded-by(_health_lock)
        self.explain_index: Dict[str, dict] = {}
        # this cycle's koordexplain attribution, reset per cycle: unbound
        # pods' verdict entries and bound pods' terms rows
        self._cycle_attrib: Dict[str, dict] = {}
        self._cycle_terms: Dict[str, dict] = {}
        # the packed batch of the last pass (fc, key -> row, n_nodes) for
        # end-of-cycle unschedulability diagnosis
        self._last_batch = None
        # admission grouping of the last encode: raw arrays, with the
        # dict view materialized lazily on the preemption path
        self._last_admission_raw = None
        self._last_admission = None
        # DefaultPreemption's attempted-latch and its cycle clock
        self._preempt_attempted: Dict[str, int] = {}
        self._cycle_seq = 0
        # incremental snapshot packing (SURVEY 7: caches become
        # device-resident arrays updated by deltas) — event-driven memos
        # replacing the per-cycle cluster walks, and the device mirror
        # uploading only what changed; gate off for the rebuild-everything
        # behavior (every cycle then uploads in full, as the sidecar does)
        from koordinator_tpu_torch.utils.features import SCHEDULER_GATES

        self.snapshot_cache = None
        self.device_snapshot = None
        if SCHEDULER_GATES.enabled("IncrementalSnapshot"):
            from koordinator_tpu_torch.scheduler.snapshot_cache import (
                SnapshotCache,
            )

            self.snapshot_cache = SnapshotCache(
                store,
                loadaware_plugin=self.extender.plugin("LoadAwareScheduling"),
                numa_plugin=self.extender.plugin("NodeNUMAResource"),
            )
            self.device_snapshot = self._new_device_snapshot()
        if self.device_snapshot is None and self.mesh is not None:
            # the mesh path needs the device mirror even without the
            # incremental-snapshot gate: it owns the sharded upload
            self.device_snapshot = self._new_device_snapshot()
        # warm-up ladder LAST: it replays rungs through _get_*step, which
        # reads the final transformer registrations
        if self._warmup_mode != "off" and self.compile_cache_dir:
            from koordinator_tpu_torch.scheduler.warmup import WarmupRunner

            self.warmup = WarmupRunner(
                self, background=self._warmup_mode == "background")
            self.warmup.start()

    # ------------------------------------------------------------------
    def note_warmup_complete(self, stats: Dict) -> None:
        """The warm-up ladder finished: arm the steady-state compile guard
        — from here on, a step-cache miss in the hot path is flagged until
        a ladder transition legitimately re-keys the cache. The guard arms
        only when the ladder actually COVERED something (a first boot
        against an empty index promised nothing)."""
        scheduler_metrics.WARMUP_COMPLETE.set(1.0)
        self._steady_state = (
            stats.get("warmed", 0) + stats.get("built", 0)) > 0
        logger.info(
            "warm-up ladder complete: %d/%d rungs warmed in %.2fs "
            "(%d skipped, %d failed, %d invalidated)",
            stats["warmed"], stats["rungs"], stats["seconds"],
            stats["skipped"], stats["failed"], stats["invalidated"])

    def _add_compile_wall(self, seconds: float) -> None:
        with self._wall_lock:
            self.compile_wall_seconds += seconds

    def _add_pack_wall(self, seconds: float) -> None:
        with self._wall_lock:
            self.pack_wall_seconds += seconds

    @property
    def _last_step_compiled(self) -> bool:
        """Whether THIS thread's most recent _get_*step call built a fresh
        step (thread-local: the background warm-up ladder's misses must
        never leak into the cycle thread's attribution)."""
        return getattr(self._step_tls, "compiled", False)

    @_last_step_compiled.setter
    def _last_step_compiled(self, value: bool) -> None:
        self._step_tls.compiled = bool(value)

    def _note_compile_miss(self, key: Tuple) -> None:
        """Step-cache miss accounting, with the steady-state flagging the
        warm-up contract promises (a warm restart binds its first pod with
        ZERO of these)."""
        self._last_step_compiled = True
        scheduler_metrics.COMPILE_CACHE_MISSES.inc()
        if self._steady_state:
            scheduler_metrics.STEADY_STATE_COMPILES.inc()
            hook = self.compile_miss_hook
            if hook is not None:
                hook(key)

    def _record_step_compile(self, kind: str, meta: Dict, args: Tuple) -> None:
        """Record a freshly built rung into the warm-up index (a no-op
        without a cache dir). Best-effort by contract — the index is for
        the NEXT process."""
        if self.compile_cache_dir is None:
            return
        from koordinator_tpu_torch.scheduler.warmup import record_step_compile

        record_step_compile(kind, meta, args, self.compile_cache_dir)

    def _step_meta(self, signature: Tuple, ng: int, ngroups: int, active,
                   explain, **extra) -> Dict:
        meta = {
            "signature": [int(x) for x in signature],
            "ng": int(ng), "ngroups": int(ngroups),
            "active": [int(a) for a in active],
            "explain": explain,
            "mesh_tag": [int(i) for i in self._mesh_tag()],
            # config the step structure bakes in: a replaying scheduler
            # whose prod split or transformer registrations differ would
            # build a different carry than the recorded specs — warm-up
            # must skip such rungs, not trip over them
            "prod": bool(self.args.score_according_prod_usage),
            "score_tag": [[name, int(epoch)]
                          for name, epoch in self._score_pass_tag()],
        }
        meta.update(extra)
        return meta

    # ------------------------------------------------------------------
    def _new_device_snapshot(self):
        """Build a DeviceSnapshot on this scheduler's device (under its
        current mesh) with the upload-failure hook propagated."""
        from koordinator_tpu_torch.scheduler.snapshot_cache import DeviceSnapshot

        snap = DeviceSnapshot(device=self.device, mesh=self.mesh)
        snap.fault_injector = self._upload_fault_injector
        return snap

    @property
    def upload_fault_injector(self):
        return self._upload_fault_injector

    @upload_fault_injector.setter
    def upload_fault_injector(self, fn) -> None:
        self._upload_fault_injector = fn
        if self.device_snapshot is not None:
            self.device_snapshot.fault_injector = fn

    def _note_demotion(self, reason: str, value):
        """THE demotion chokepoint (koordwatch): every branch that runs a
        cycle below its configured wave level routes its fallback value
        through here — ``return self._note_demotion("reason", 1)`` — so
        no demotion is silent. Counted once per cycle per reason. The
        reason must be registered (DEMOTION_REASONS); retired reasons can
        never silently come back."""
        if reason not in DEMOTION_REASONS:
            raise ValueError(
                f"unregistered demotion reason {reason!r}"
                + (" (RETIRED — the fused path carries this state now)"
                   if reason in RETIRED_DEMOTION_REASONS else
                   "; add it to DEMOTION_REASONS"))
        if self.watch_enabled and reason not in self._cycle_demotions:
            self._cycle_demotions.append(reason)
            scheduler_metrics.WAVE_DEMOTIONS.inc(reason=reason)
        return value

    def _window_path(self, base: str) -> str:
        """The timeline path label for a dispatch window: the mesh
        placement wins over the program shape."""
        return "mesh" if self.mesh is not None else base

    def _open_window(self, base: str):
        """Open a device-timeline window for one dispatch pass; the
        minted decision id joins spans, flight records and /explain."""
        win = self.timeline.open("scheduler", self._window_path(base))
        self._current_decision_id = win.decision_id
        self._cycle_decision_ids.append(win.decision_id)
        return win

    def _close_window(self, win, attempts: int, had_deadline: bool,
                      level0: int, end_mono=None) -> None:
        """Record a completed dispatch window. Outcome precedence:
        deadline (a monitored sync was abandoned this pass) > demoted
        (the ladder moved down) > retried (same level, second attempt)
        > clean."""
        outcome = ("deadline" if had_deadline
                   else "demoted" if self.ladder.level > level0
                   else "retried" if attempts else "clean")
        self.timeline.close(win, outcome, end_mono=end_mono)

    # ------------------------------------------------------------------
    # degradation ladder (scheduler/degrade.py)
    # ------------------------------------------------------------------
    def _ladder_features(self) -> Dict[str, bool]:
        """Which ladder rungs actually change behavior for this
        scheduler's configuration — demotion and re-promotion both skip
        rungs whose feature was never on. On one GPU that leaves full ->
        serial-waves -> no-explain -> host-fallback, skipping the rungs of
        waves and explain where they are off (waves=1, explain off: full
        -> host-fallback). A sidecar turns both off: its protocol is
        single-round and ships only the chosen vector."""
        waves_capable = (self.waves_spec == "auto"
                         or (isinstance(self.waves_spec, int)
                             and self.waves_spec > 1))
        return {
            "mesh": self._configured_mesh is not None,
            "waves": waves_capable and self._sidecar_client is None,
            "explain": (self.explain_spec is not None
                        and self._sidecar_client is None),
        }

    def _on_ladder_transition(self, record: dict) -> None:
        """Every ladder transition is observable: gauge, loud log, the
        effective settings re-applied, and a flight-recorder dump (the
        preceding cycles' decision records ARE the incident context)."""
        scheduler_metrics.DEGRADED_LEVEL.set(float(record["to_level"]))
        # a ladder transition legitimately re-keys the step cache (the
        # explain level): drop the steady-state compile guard — it re-arms
        # only with the next warm-up ladder (a restart)
        self._steady_state = False
        log = (logger.warning if record["to_level"] > record["from_level"]
               else logger.info)
        log("dispatch degradation ladder: %s -> %s (%s)",
            record["from"], record["to"], record["reason"])
        if record["to_level"] == LEVEL_FULL:
            # re-promotion probes the FULL configured mesh back: the
            # lost-device set resets, and a still-dead device re-records
            # itself when the probe's dispatch fails attributably
            self._lost_device_ids = set()
        self._apply_degraded_level()
        self.flight.dump("degradation")

    def _partial_mesh(self):
        """The surviving submesh for the partial-mesh rung: the
        configured mesh minus every device id shed so far. Cached per
        lost set, so _apply_degraded_level's identity compare sees a
        stable Mesh while the set is unchanged."""
        from koordinator_tpu_torch.parallel.mesh import surviving_submesh

        key = frozenset(self._lost_device_ids)
        hit = self._submesh_cache.get(key)
        if hit is None:
            # never None-valued: _on_dispatch_failure records losses only
            # while survivors remain, so the submesh is non-empty
            hit = surviving_submesh(self._configured_mesh, key)
            self._submesh_cache[key] = hit
        return hit

    def _apply_degraded_level(self) -> None:
        """Reconcile the mesh with the ladder level (the waves/explain
        rungs are consulted per cycle by _effective_waves/_effective_
        explain; the mesh owns device buffers, so it reconfigures here).
        The partial-mesh rung runs the surviving submesh — the snapshot
        and the step cache rebuild against it, re-padding through the
        normal upload. Idempotent and cheap when nothing changed."""
        if self.ladder.level >= LEVEL_NO_MESH:
            want_mesh = None
        elif (self.ladder.level == LEVEL_PARTIAL_MESH
                and self._configured_mesh is not None):
            want_mesh = self._partial_mesh()
        else:
            want_mesh = self._configured_mesh
        if want_mesh is self.mesh:
            return
        self.mesh = want_mesh
        scheduler_metrics.MESH_DEVICES.set(
            float(want_mesh.size) if want_mesh is not None else 0.0)
        # rebuild the device mirror for the new placement: the next upload
        # repopulates it (one cycle of full puts, then steady-state
        # reuse); the stats baseline resets with it
        if self.snapshot_cache is not None or want_mesh is not None:
            self.device_snapshot = self._new_device_snapshot()
        else:
            self.device_snapshot = None
        self._upload_stats_last = {}

    def _on_deadline_overrun(self, path: str) -> None:
        """The dispatch watchdog abandoned a monitored sync: count it and
        dump the flight ring (reason dispatch_deadline) — the
        DispatchDeadlineExceeded it raises right after lands in the
        dispatch window's failure handler, which abandons the device
        state and feeds the ladder like any raised fault."""
        scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.inc(path=path)
        self.flight.dump("dispatch_deadline")

    def _abandon_device_state(self) -> None:
        """A deadline overrun left a round running against the mirror's
        tensors. Never block on it: the mirror is replaced wholesale, and
        the next upload repopulates the fresh one through full puts."""
        if self.device_snapshot is None:
            return
        self.device_snapshot = self._new_device_snapshot()
        self._upload_stats_last = {}

    def _window_failure(self, stage: str, exc: Exception) -> None:
        """Classify a dispatch window's failure, after the window's own
        clean-up. A failed in-window store write (unwrapped: see
        _HostWriteFailure) and anything that is not a device fault
        (degrade.is_device_fault: a kernel build, contract or launch
        failure, a left-out path) propagate untouched. A device fault
        feeds the ladder: returns when a retry or a demotion was
        arranged, re-raises when the ladder is exhausted, and raises
        FusedDispatchDemoted when a fused window was demoted below fused
        waves — no binding was applied, and the cycle driver re-runs the
        pass serially."""
        if isinstance(exc, _HostWriteFailure):
            raise exc.__cause__
        if not is_device_fault(exc):
            raise exc
        self._on_dispatch_failure(stage, exc)
        if stage == "fused" and self.ladder.level >= LEVEL_SERIAL_WAVES:
            raise FusedDispatchDemoted() from exc

    def _on_dispatch_failure(self, stage: str, exc: Exception) -> None:
        """A device-dispatch attempt failed before any binding was
        applied. Count it, consult the ladder; returns normally when a
        retry or demotion was arranged (the caller re-runs its dispatch
        window), re-raises when the ladder is exhausted."""
        scheduler_metrics.DISPATCH_RETRIES.inc(stage=stage)
        if isinstance(exc, DispatchDeadlineExceeded):
            # slow-not-dead device: the in-flight window was abandoned,
            # so the retry/demoted re-run must upload into a fresh mirror
            # the slow round does not read
            self._abandon_device_state()
        features = self._ladder_features()
        # koordguard partial-mesh: a failure that NAMES dead mesh devices
        # engages the partial-mesh rung — record the loss first (the
        # transition observer rebuilds the submesh), then let the ladder
        # pick the rung. A repeat loss while already at partial-mesh
        # shrinks the submesh in place.
        ids = attributable_device_ids(exc)
        if ids and self._configured_mesh is not None:
            all_ids = {d.id for d in self._configured_mesh.devices.flat}
            named = ids & all_ids
            fresh = named - self._lost_device_ids
            survivors = all_ids - self._lost_device_ids - named
            if named and survivors:
                # engaged whenever the failure NAMES devices with
                # survivors left — including the second attempt of the
                # same fault, whose ids the retry already recorded
                self._lost_device_ids |= fresh
                features["partial_mesh"] = True
                if (self.ladder.level == LEVEL_PARTIAL_MESH
                        and self.mesh is not None
                        and named & {d.id for d in self.mesh.devices.flat}):
                    # the loss names a device still in the ACTIVE
                    # submesh: shrink in place (both attempts of the
                    # fault must see the flag; the submesh rebuilds only
                    # on the ladder transition)
                    features["partial_mesh_shrink"] = True
                if fresh:
                    logger.warning(
                        "%s dispatch failure attributed to device(s) %s; "
                        "%d of %d mesh devices survive", stage,
                        sorted(fresh), len(survivors), len(all_ids))
        elif ids:
            logger.warning("%s dispatch failure names device(s) %s; no "
                           "mesh to shed them from", stage, sorted(ids))
        action = self.ladder.on_failure(
            features, error=f"{type(exc).__name__}: {exc}")
        if action == "exhausted":
            raise exc
        if action == "retry":
            logger.warning(
                "%s dispatch failed (%s: %s); retrying once at ladder "
                "level %s", stage, type(exc).__name__, exc,
                self.ladder.level_name)
        # "demoted": the transition observer already re-applied settings

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _pending_queue(self, now: float) -> Tuple[List[Pod], Dict[str, Reservation]]:
        pods = [
            p
            for p in self.store.list(KIND_POD)
            if not p.is_assigned
            and not p.is_terminated
            and p.spec.scheduler_name == self.scheduler_name
        ]
        reservations: Dict[str, Reservation] = {}
        for res in self.store.list(KIND_RESERVATION):
            if res.phase == "Pending" and not res.node_name and not res.is_expired(now):
                pseudo = Pod(
                    meta=ObjectMeta(
                        name=res.meta.name,
                        namespace="__reservation__",
                        creation_timestamp=res.meta.creation_timestamp,
                    ),
                    spec=PodSpec(
                        priority=(
                            res.template.priority
                            if res.template.priority is not None
                            else 9500
                        ),
                        requests=res.template.requests,
                        limits=res.template.limits,
                    ),
                )
                pods.append(pseudo)
                reservations[pseudo.meta.key] = res
        # pending-queue visibility (koordwatch, pre-work for the ROADMAP
        # admission/queueing item): the depth this cycle drains and every
        # entry's enqueue-to-dispatch age. creation_timestamp is the
        # enqueue instant for both real pods and reservation pseudo-pods.
        if self.watch_enabled:
            scheduler_metrics.PENDING_QUEUE_DEPTH.set(float(len(pods)))
            for p in pods:
                created = p.meta.creation_timestamp or now
                scheduler_metrics.QUEUE_WAIT_SECONDS.observe(
                    max(0.0, now - created))
        return pods, reservations

    def _process_resizes(self, now: float, result: CycleResult) -> None:
        """In-place pod resize (KEP-1287 shape; reference gates it behind
        the ResizePod feature and runs Reserve + ResizePod instead of a
        scheduling pass): an assigned pod carrying spec.resize_requests is
        granted when its node still fits the DELTA against every other
        assigned pod's requests; otherwise it stays pending and retries
        next cycle. cpuset-bound (LSE/LSR integer-cpu) pods are refused —
        their core allocation would need a release/re-take, which in-place
        resize cannot do safely."""
        import dataclasses

        from koordinator_tpu_torch.scheduler.snapshot import _pod_cpuset_flags

        candidates = [
            p for p in self.store.list(KIND_POD)
            if p.is_assigned and not p.is_terminated
            and p.spec.resize_requests is not None
            and p.spec.scheduler_name == self.scheduler_name
        ]
        if not candidates:
            return
        assigned = self._assigned_requests()
        # Available reservations HOLD capacity the batch pass counts via
        # ReservationRestoreTransformer — the resize fit base must count it
        # too, or a granted resize overcommits against a reservation whose
        # owner binds later
        for res in self.store.list(KIND_RESERVATION):
            if res.is_available and not res.is_expired(now) and res.node_name:
                vec = res.allocatable.to_vector()
                assigned[res.node_name] = (
                    assigned.get(res.node_name, np.zeros_like(vec)) + vec)
        nodes = {n.meta.name: n for n in self.store.list(KIND_NODE)}
        numa_plugin = self.extender.plugin("NodeNUMAResource")
        from koordinator_tpu_torch.scheduler.topologymanager import (
            POLICY_SINGLE_NUMA_NODE,
        )
        for pod in candidates:
            node = nodes.get(pod.spec.node_name)
            if node is None:
                result.resize_pending.append(pod.meta.key)
                self.extender.error_handlers.dispatch(
                    pod, "resize target node not found")
                continue
            # cpuset guard on BOTH shapes: the old allocation AND what the
            # pod would become (a resize to integer-cpu LSR must not dodge
            # the cpuset release/re-take it cannot do in place)
            needs_bind_old, _c, _f = _pod_cpuset_flags(pod)
            resized_view = dataclasses.replace(
                pod, spec=dataclasses.replace(
                    pod.spec, requests=pod.spec.resize_requests))
            needs_bind_new, _c, _f = _pod_cpuset_flags(resized_view)
            if needs_bind_old or needs_bind_new:
                result.resize_pending.append(pod.meta.key)
                self.extender.error_handlers.dispatch(
                    pod, "in-place resize unsupported for cpuset-bound pods")
                continue
            # SingleNUMANode-policy nodes account per-zone state the
            # whole-node delta check below cannot see: a granted resize
            # could overcommit a zone the batch pass believes free.
            # Refuse, the same stance as cpuset-bound pods.
            if numa_plugin is not None:
                topo = numa_plugin.topologies.get(pod.spec.node_name)
                if (topo is not None and topo.zones
                        and numa_plugin.node_policy(pod.spec.node_name)
                        == POLICY_SINGLE_NUMA_NODE):
                    result.resize_pending.append(pod.meta.key)
                    self.extender.error_handlers.dispatch(
                        pod, "in-place resize unsupported on "
                             "SingleNUMANode-policy nodes")
                    continue
            new_vec = pod.spec.resize_requests.to_vector()
            old_vec = pod.spec.requests.to_vector()
            others = (assigned.get(pod.spec.node_name,
                                   np.zeros_like(new_vec)) - old_vec)
            # the SAME trimmed allocatable the batch kernel fits against
            # (node-reservation annotation trims — ops/estimator.py); raw
            # status.allocatable would grant resizes into reserved cores
            from koordinator_tpu_torch.ops.estimator import (
                estimate_node_allocatable,
            )

            alloc = estimate_node_allocatable(node)
            need = new_vec > 0
            if np.any(need & (others + new_vec > alloc)):
                result.resize_pending.append(pod.meta.key)
                self.extender.error_handlers.dispatch(
                    pod, "resize does not fit the node")
                continue
            pod.spec.requests = pod.spec.resize_requests
            pod.spec.resize_requests = None
            self.store.update(KIND_POD, pod)
            # the node's fit base shifts for later candidates on it
            assigned[pod.spec.node_name] = others + new_vec
            result.resized.append(pod.meta.key)

    def _assigned_requests(self) -> Dict[str, np.ndarray]:
        """Base fit state per node: every assigned pod's requests. Reservation
        accounting (reserved capacity + double-count restore) is layered on by
        ReservationRestoreTransformer via the declared before-Filter extension
        point — a custom transformer can rewrite the same view.

        Rebuilt per cycle (robust against in-place object mutation), but as
        ONE wire-matrix fill + scale + segment-sum instead of per-pod vector
        allocations. With the incremental snapshot cache the sums are
        event-maintained instead (same values; test_snapshot_cache.py)."""
        if self.snapshot_cache is not None:
            return self.snapshot_cache.assigned_requests()
        assigned = [
            p for p in self.store.list(KIND_POD)
            if p.is_assigned and not p.is_terminated
        ]
        if not assigned:
            return {}
        node_ids: Dict[str, int] = {}
        rows = np.zeros(len(assigned), np.int64)
        wire = np.zeros((len(assigned), NUM_RESOURCES), np.float64)
        for i, pod in enumerate(assigned):
            pod.spec.requests.fill_wire_row(wire[i])
            rows[i] = node_ids.setdefault(pod.spec.node_name, len(node_ids))
        packed = with_pod_count((wire / PACK_SCALE).astype(np.float32))
        sums = np.zeros((len(node_ids), NUM_RESOURCES), np.float32)
        np.add.at(sums, rows, packed)
        return {node: sums[i] for node, i in node_ids.items()}

    def _cluster_state(self, pending: List[Pod], now: float) -> ClusterState:
        la = self.extender.plugin("LoadAwareScheduling")
        numa = self.extender.plugin("NodeNUMAResource")
        quota = self.extender.plugin("ElasticQuota")
        gang = self.extender.plugin("Coscheduling")
        return ClusterState(
            nodes=[n for n in self.store.list(KIND_NODE) if not n.unschedulable],
            pending_pods=pending,
            node_metrics={
                m.meta.name: m for m in self.store.list(KIND_NODE_METRIC)
            },
            pods_by_key={p.meta.key: p for p in self.store.list(KIND_POD)},
            assigned=la.assigned_view() if la else {},
            assigned_requests=self._assigned_requests(),
            topologies=dict(numa.topologies) if numa else {},
            cpu_states=dict(numa.cpu_states) if numa else {},
            numa_allocated=dict(numa.numa_allocated) if numa else {},
            quotas=quota.quota_list() if quota else [],
            pod_groups=list(gang.pod_groups.values()) if gang else [],
            gang_assumed=dict(gang.assumed) if gang else {},
            pvcs={c.meta.key: c for c in self.store.list(KIND_PVC)},
            pvs={v.meta.name: v for v in self.store.list(KIND_PV)},
            storage_classes={
                s.meta.name: s
                for s in self.store.list(KIND_STORAGECLASS)
            },
            now=now,
        )


    def _mesh_tag(self) -> Tuple:
        """Step-cache key component for the mesh placement. Device IDS,
        not just the count: the partial-mesh rung can produce two
        same-size submeshes over different survivors across one
        scheduler lifetime, and a step built for the old mesh must never
        serve the new one."""
        if self.mesh is None:
            return ()
        return self.mesh.tag

    def _get_step(self, signature: Tuple, ng: int, ngroups: int,
                  active, explain=None) -> object:
        # a shape-signature miss builds the step; on the card the kernel
        # library loads at the step's first call, in the NEXT kernel span,
        # which is why the kernel span carries compiled="1" on that cycle
        key = (signature, ng, ngroups, tuple(active), explain,
               self._mesh_tag())
        mesh = self.mesh
        if mesh is not None:
            from koordinator_tpu_torch.parallel.full_chain_mesh import (
                build_sharded_full_chain_step,
            )

            return self._cached_step(
                key, lambda: build_sharded_full_chain_step(
                    self.args, ng, ngroups, mesh, active_axes=active,
                    explain=explain))
        return self._cached_step(key, lambda: build_best_full_chain_step(
            self.args, ng, ngroups, active_axes=active, explain=explain))

    def _cached_step(self, key: Tuple, build) -> object:
        """The step memo: a hit, or ``build()`` timed by a ``compile``
        span and cached under ``key``."""
        with self._step_lock:
            step = self._step_cache.get(key)
        if step is not None:
            self._last_step_compiled = False
            scheduler_metrics.COMPILE_CACHE_HITS.inc()
            return step
        self._note_compile_miss(key)
        with self.tracer.span("compile", signature=str(key)) as csp:
            step = build()
        self._add_compile_wall(csp.duration_seconds)
        with self._step_lock:
            self._step_cache[key] = step
        return step

    def _device_score_passes(self) -> Tuple:
        """Registered ScoreTransformers' device tensor passes, in
        registration order (the host before_score order). The fused path
        only runs when EVERY ScoreTransformer is device-expressible
        (_effective_waves demotes otherwise)."""
        return tuple(
            t.device_pass for t in self.extender.transformers
            if isinstance(t, ScoreTransformer)
            and getattr(t, "device_pass", None) is not None)

    def _score_pass_tag(self) -> Tuple:
        """Step-cache key component for the transformer passes a wave
        step runs: a registration or a declared parameter change
        (``device_epoch``) must miss the cache."""
        return tuple(
            (t.name, getattr(t, "device_epoch", 0))
            for t in self.extender.transformers
            if isinstance(t, ScoreTransformer)
            and getattr(t, "device_pass", None) is not None)

    def _get_fused_step(self, signature: Tuple, ng: int, ngroups: int,
                        active, waves: int, explain=None,
                        sides_tag: Tuple = (0, 0)) -> object:
        """The single-call K-wave step (replay overlap off)."""
        from koordinator_tpu_torch.models.fused_waves import (
            build_fused_wave_step,
        )

        nc, nres = sides_tag
        key = ("fused", waves, signature, ng, ngroups, tuple(active),
               explain, self._mesh_tag(), sides_tag, self._score_pass_tag())
        mesh = self.mesh
        if mesh is not None:
            from koordinator_tpu_torch.parallel.full_chain_mesh import (
                build_sharded_fused_wave_step,
            )

            build_fused_wave_step = functools.partial(  # noqa: F811
                build_sharded_fused_wave_step, mesh=mesh)
        return self._cached_step(key, lambda: build_fused_wave_step(
            self.args, ng, ngroups, waves=waves, active_axes=active,
            explain=explain,
            prod=self.args.score_according_prod_usage, claims=nc > 0,
            res=nres > 0, score_passes=self._device_score_passes()))

    def _get_chain_step(self, signature: Tuple, ng: int, ngroups: int,
                        active, explain=None,
                        sides_tag: Tuple = (0, 0)) -> object:
        """The chained per-wave step (overlapped replay). No wave depth in
        the cache key: one step serves every K."""
        from koordinator_tpu_torch.models.fused_waves import (
            build_chained_wave_step,
        )

        nc, nres = sides_tag
        key = ("chain", signature, ng, ngroups, tuple(active), explain,
               self._mesh_tag(), sides_tag, self._score_pass_tag())
        mesh = self.mesh
        if mesh is not None:
            from koordinator_tpu_torch.parallel.full_chain_mesh import (
                build_sharded_chained_wave_step,
            )

            build_chained_wave_step = functools.partial(  # noqa: F811
                build_sharded_chained_wave_step, mesh=mesh)
        return self._cached_step(key, lambda: build_chained_wave_step(
            self.args, ng, ngroups, active_axes=active, explain=explain,
            prod=self.args.score_according_prod_usage, claims=nc > 0,
            res=nres > 0, score_passes=self._device_score_passes()))

    def _effective_explain(self):
        """This cycle's koordexplain level. The sidecar path demotes to
        off: the RPC protocol ships only the chosen vector, so attribution
        falls back to the host recompute. The degradation ladder's
        no-explain rung (and below) pins it off too. Every demotion routes
        through the koordwatch chokepoint."""
        if self.explain_spec is None:
            return self.explain_spec  # nothing configured: not a demotion
        if self._sidecar_client is not None:
            return self._note_demotion("explain-sidecar", None)
        if self.ladder.level >= LEVEL_NO_EXPLAIN:
            return self._note_demotion("explain-ladder", None)
        return self.explain_spec

    def _analyze_claims(self, pending: List[Pod]):
        """The batch's claim structure (ops/volumes.analyze_pending_claims)
        for the fused path: None when no pending pod carries claims. The
        analysis is stashed for the dispatch's side-input encode so the
        hot-claim factorization is computed exactly once per cycle."""
        carriers = [p for p in pending if p.spec.pvc_names]
        if not carriers:
            return None
        # volume-aware mode (real PVC/PV/StorageClass objects, the SHARED
        # gate in ops/volumes.py): a bind can rewrite another pending
        # pod's CLASSIFICATION through the store — count the pods whose
        # claims are unbound/missing, the only channel such a rewrite can
        # travel
        from koordinator_tpu_torch.ops.volumes import store_volume_aware

        volume_aware = store_volume_aware(self.store)
        unbound = 0
        if volume_aware:
            for pod in carriers:
                for claim in pod.spec.pvc_names:
                    pvc = self.store.get(
                        KIND_PVC, f"{pod.meta.namespace}/{claim}")
                    if pvc is None or not pvc.is_bound:
                        unbound += 1
                        break
                if unbound >= 2:
                    break
        attached = (self.snapshot_cache.attached_sets()
                    if self.snapshot_cache is not None
                    else attached_claim_sets(self.store))
        return analyze_pending_claims(
            pending, attached, volume_aware=volume_aware,
            unbound_claim_pods=unbound)

    def _effective_waves(self, pending: List[Pod],
                         pending_reservations: Dict[str, Reservation],
                         override=None) -> int:
        """Resolve this cycle's fused-wave depth. Pending Reservation CRs,
        claim-carrying pods, prod-usage scoring and device-expressible
        ScoreTransformers all ride the fused path as carried state; only
        genuinely non-expressible residues demote to K=1 (the exact serial
        path): a ScoreTransformer without ``device_pass`` and claim
        entanglement, plus the degradation ladder at or below its
        serial-waves rung and the single-round sidecar protocol."""
        self._claim_analysis = None
        spec = self.waves_spec if override is None else override
        k = _auto_waves(len(pending)) if spec == "auto" else int(spec)
        k = max(1, min(k, MAX_WAVES))
        if k == 1:
            return k  # resolved to serial by spec/depth: not a demotion
        if self.ladder.level >= LEVEL_SERIAL_WAVES:
            # degradation ladder: fused dispatch demoted off
            return self._note_demotion("ladder-serial-waves", 1)
        if self._sidecar_client is not None:
            # the sidecar RPC protocol is single-round
            return self._note_demotion("sidecar", 1)
        if any(isinstance(t, ScoreTransformer)
               and getattr(t, "device_pass", None) is None
               for t in self.extender.transformers):
            # a host-only ScoreTransformer may rewrite any packed field
            # AFTER the build; the fused waves rebuild the score terms from
            # carried state every wave, which would silently discard the
            # rewrite
            return self._note_demotion("non-expressible-transformer", 1)
        analysis = self._analyze_claims(pending)
        if analysis is not None and analysis.entangled is not None:
            # the narrow claim residue: classification drift through the
            # PV/PVC objects or a factorization-budget overflow
            return self._note_demotion("claim-entangled", 1)
        self._claim_analysis = analysis
        return k

    # ------------------------------------------------------------------
    def run_cycle(self, now: Optional[float] = None,
                  waves=None) -> CycleResult:
        now = time.time() if now is None else now
        if self.elector is not None and not self.elector.tick(now):
            return CycleResult(skipped_not_leader=True)
        # the retry budget is armed per dispatch window, not per cycle: a
        # cycle can open several (initial pass, preemption retry, the
        # serial re-run after a fused demotion), each with its own
        # retry-once before demoting
        self._cycle_demotions = []
        self._cycle_decision_ids = []
        self._current_decision_id = None
        self._cycle_attrib = {}
        self._cycle_terms = {}
        self._apply_degraded_level()
        # koordwatch mesh accounting: a cycle dispatching below the
        # CONFIGURED mesh placement (the ladder's no-mesh reconfiguration,
        # or the partial-mesh submesh) is a demoted cycle
        if (self._configured_mesh is not None
                and self.mesh is not self._configured_mesh):
            self._note_demotion(
                "mesh-off" if self.mesh is None else "partial-mesh", None)
        result = CycleResult()
        carried_deferred = bool(self._deferred_diagnose)
        self._flushed_this_cycle = False
        self._cycle_counter += 1
        flight_base = self._flight_metric_base()
        root = None
        # root span: the ONE place the cycle duration is stamped. Every
        # early-return path inside the traced body (empty queue, pre-pass
        # binds everything, full pass) exits through the span's finally,
        # so no return path can ship a zero duration.
        try:
            with self.tracer.span("cycle") as root:
                self._run_cycle_traced(now, result, waves_override=waves)
                # a cycle with no kernel window (empty queue) never reached
                # the overlap flush: drain carried-over deferred writes here
                # so they cannot linger unboundedly — without device work
                # to overlap, flushing now IS the serial timing
                if (self.pipeline_mode and carried_deferred
                        and not self._flushed_this_cycle
                        and self._deferred_diagnose):
                    self.flush_deferred()
        except Exception as exc:
            # flight-recorder trigger: an unhandled cycle exception leaves
            # the wreck behind — the partial result, the span tree and the
            # preceding cycles in the ring — then re-raises unchanged
            result.duration_seconds = (root.duration_seconds
                                       if root is not None else 0.0)
            result.demotions = list(self._cycle_demotions)
            result.decision_ids = list(self._cycle_decision_ids)
            self.flight.record_cycle(self._flight_record(
                result, now, root, flight_base,
                error=f"{type(exc).__name__}: {exc}"))
            self.flight.dump("cycle_exception")
            raise
        result.duration_seconds = root.duration_seconds
        result.demotions = list(self._cycle_demotions)
        result.decision_ids = list(self._cycle_decision_ids)
        scheduler_metrics.CYCLE_SECONDS.observe(result.duration_seconds)
        if result.duration_seconds > 0:
            # device-busy fraction of this cycle (the "is the device the
            # bottleneck yet" gauge), clamped against timer skew
            scheduler_metrics.PIPELINE_OCCUPANCY.set(min(
                1.0, result.device_busy_seconds / result.duration_seconds))
        if result.bound:
            scheduler_metrics.PODS_BOUND_TOTAL.inc(len(result.bound))
        self.extender.monitor.record(result)
        self._finish_cycle_obs(result, now, root, flight_base)
        # a completed cycle feeds the ladder's clean-cycle counter (a
        # cycle that needed retries/demotions does not count as clean);
        # enough clean cycles probe one rung back up
        self.ladder.note_cycle()
        return result

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _flight_metric_base(self) -> Dict[str, float]:
        """Cycle-start counter values, so the flight record carries per-
        cycle METRIC DELTAS instead of meaningless cumulative totals."""
        return {
            "pods_bound": scheduler_metrics.PODS_BOUND_TOTAL.get() or 0.0,
            "compile_cache_misses":
                scheduler_metrics.COMPILE_CACHE_MISSES.get() or 0.0,
            "readback_bytes": scheduler_metrics.READBACK_BYTES.get() or 0.0,
            "explain_readback_bytes":
                scheduler_metrics.EXPLAIN_READBACK_BYTES.get() or 0.0,
        }

    def _flight_record(self, result: CycleResult, now: float, root,
                       base: Dict[str, float], error=None) -> dict:
        """One flight-recorder cycle record (obs/flight.py schema)."""
        from koordinator_tpu_torch.obs.flight import FLIGHT_SCHEMA_VERSION

        end = self._flight_metric_base()
        bound = []
        for b in result.bound:
            entry: Dict[str, object] = {"pod": b.pod_key, "node": b.node_name}
            terms = self._cycle_terms.get(b.pod_key)
            if terms is not None:
                entry["terms"] = terms
            bound.append(entry)

        def unbound(keys: List[str]) -> List[dict]:
            out = []
            for key in keys:
                entry: Dict[str, object] = {"pod": key}
                attrib = self._cycle_attrib.get(key)
                if attrib:
                    for field in ("reason", "stages", "message"):
                        if field in attrib:
                            entry[field] = attrib[field]
                out.append(entry)
            return out

        record = {
            "v": FLIGHT_SCHEMA_VERSION,
            "kind": "cycle",
            "seq": self._cycle_counter,
            "ts": float(now),
            "duration_ms": result.duration_seconds * 1000.0,
            "waves": int(result.waves),
            "bound": bound,
            "failed": unbound(result.failed),
            "rejected": unbound(result.rejected),
            "preempted": list(result.preempted_victims),
            # koordwatch: the cycle's structured demotion reasons and
            # the decision ids of its device windows (joinable against
            # the timeline bundle and the kernel spans' decision_id)
            "demotions": list(result.demotions),
            "decision_ids": list(result.decision_ids),
            "metrics": {k: end[k] - base.get(k, 0.0) for k in end},
            "spans": ([s.to_record() for s in root.walk()]
                      if root is not None else []),
        }
        if error is not None:
            record["error"] = str(error)
        return record

    def _finish_cycle_obs(self, result: CycleResult, now: float, root,
                          flight_base: Dict[str, float]) -> None:
        """Post-cycle koordexplain bookkeeping: bound-pod attribution, the
        /explain index, the flight ring, liveness state and the deadline
        trigger."""
        if self.explain_spec is not None:
            for b in result.bound:
                rec: Dict[str, object] = {"verdict": "bound",
                                          "node": b.node_name}
                if self._current_decision_id is not None:
                    # koordwatch decision correlation: /explain output
                    # joins the timeline window that bound the pod
                    rec["decision_id"] = self._current_decision_id
                terms = self._cycle_terms.get(b.pod_key)
                if terms is not None:
                    rec["terms"] = terms
                    # margin vs the runner-up node; meaningful only when a
                    # feasible runner-up existed (runner_up >= 0)
                    rec["margin"] = terms["best_score"] - terms["runner_up"]
                self._cycle_attrib[b.pod_key] = rec
            with self._health_lock:
                for key, rec in self._cycle_attrib.items():
                    rec = dict(rec)
                    rec["cycle"] = self._cycle_counter
                    rec["ts"] = float(now)
                    # pop-then-insert keeps dict order = recency, so the
                    # cap below evicts the genuinely oldest records
                    self.explain_index.pop(key, None)
                    self.explain_index[key] = rec
                overflow = len(self.explain_index) - 4096
                if overflow > 0:
                    # dict preserves insertion order: drop the oldest
                    for key in list(self.explain_index)[:overflow]:
                        del self.explain_index[key]
        self.flight.record_cycle(
            self._flight_record(result, now, root, flight_base))
        with self._health_lock:
            self._last_cycle_end = (time.time(), int(result.waves))
        if (self.cycle_deadline_seconds is not None
                and result.duration_seconds > self.cycle_deadline_seconds):
            self.flight.dump("deadline_overrun")

    def health_snapshot(self) -> Dict[str, object]:
        """The /healthz payload: last-completed-cycle age + wave count —
        a stale-cycle liveness signal instead of a bare 200 — plus the
        degradation-ladder state: a scheduler surviving at a demoted
        rung must not look identical to a healthy one on its liveness
        probe."""
        with self._health_lock:
            last = self._last_cycle_end
            cycles = self._cycle_counter
        degraded = self.ladder.snapshot()
        if last is None:
            return {"status": "ok", "cycles": 0, "degraded": degraded}
        end_wall, waves = last
        return {
            "status": "ok",
            "cycles": cycles,
            "last_cycle_age_seconds": max(0.0, time.time() - end_wall),
            "last_cycle_waves": waves,
            "degraded": degraded,
        }

    def explain_record(self, pod_key: str) -> Optional[dict]:
        """The /explain?pod= payload: the pod's most recent decision
        attribution, or None."""
        with self._health_lock:
            rec = self.explain_index.get(pod_key)
            return dict(rec) if rec is not None else None

    def _run_cycle_traced(self, now: float, result: CycleResult,
                          waves_override=None) -> None:
        # [ResizePod gate] in-place resize of assigned pods, before the
        # batch pass sees their requests (frameworkext factory
        # RunReservePluginsReserve + RunResizePod analog)
        from koordinator_tpu_torch.utils.features import SCHEDULER_GATES

        if SCHEDULER_GATES.enabled("ResizePod"):
            self._process_resizes(now, result)
        res_plugin = self.extender.plugin("Reservation")
        if self.reservation_controller is not None:
            self.reservation_controller.reconcile(now)
        if self.quota_revoke_controller is not None:
            self.quota_revoke_controller.reconcile(now)
        pending, pending_reservations = self._pending_queue(now)
        # permit-timeout rejection: pods of terminally-failed gangs never
        # re-enter admission (gang.go WaitingPods timeout semantics)
        gang_plugin = self.extender.plugin("Coscheduling")
        if gang_plugin is not None:
            gang_plugin.update_pod_group_status(self.store, now)
            dead_gangs = set(gang_plugin.timed_out_gangs())
            if dead_gangs:
                kept = []
                timed_out: List[Tuple[Pod, str]] = []
                for pod in pending:
                    if pod.gang_key in dead_gangs:
                        result.rejected.append(pod.meta.key)
                        self.extender.error_handlers.dispatch(
                            pod, "gang schedule timeout")
                        timed_out.append((pod, "gang schedule timeout"))
                    else:
                        kept.append(pod)
                pending = kept
                # these pods never reach the batch pass, so the terminal
                # reason must land on their status here (the end-of-cycle
                # writer only sees batch-pass failures)
                self._write_unschedulable_conditions([], timed_out, now)
        if not pending:
            return

        # ---- per-pod view transforms (BeforePreFilter) run before ANY
        # scheduling decision — the nomination pre-pass must see the same
        # views the kernel pass packs; originals are kept for the
        # preemption retry, which re-transforms from scratch
        ctx = CycleContext(now=now)
        originals = {p.meta.key: p for p in pending}
        pending = self.extender.transform_before_prefilter(pending, ctx)

        # ---- reservation nomination pre-pass. Gang/quota pods are excluded:
        # their admission barriers live in the batched kernel, and binding them
        # here would bypass min-member and quota checks. So are pods whose
        # placement the kernel Filter chain must vet — hostPorts, CSI
        # volume claims, inter-pod (anti-)affinity, topology spread: the
        # nominator checks only the reservation's resource fit, and with
        # descheduler-issued migration reservations (owner-matched to a
        # whole workload) a port-carrying replica nominated onto the
        # reserved node could double-bind a hostPort the kernel would
        # have rejected (the koordbalance drain-storm scenario caught
        # exactly that). Such pods schedule through the kernel, which
        # still counts reserved capacity via the restore transformer.
        with self.tracer.span("reservation_prepass") as presp:
            remaining: List[Pod] = []
            nominated = 0
            for pod in pending:
                if (
                    pod.meta.key in pending_reservations
                    or res_plugin is None
                    or pod.gang_name
                    or pod.quota_name
                    or pod.spec.host_ports
                    or pod.spec.pvc_names
                    or pod.spec.pod_affinity
                    or pod.spec.pod_anti_affinity
                    or pod.spec.topology_spread
                ):
                    remaining.append(pod)
                    continue
                res = res_plugin.nominate(pod, now)
                if res is None:
                    remaining.append(pod)
                    continue
                err = self._reserve_and_bind(pod, res.node_name, ctx, result,
                                             via_reservation=res)
                if err:
                    remaining.append(pod)
                else:
                    nominated += 1
            presp.attributes["nominated"] = str(nominated)
        pending = remaining
        if not pending:
            return

        # ---- fused multi-wave path: K dependent rounds per dispatch,
        # replayed host-side as logical cycles (byte-identical to K
        # sequential single-round cycles — pipeline_parity gates it)
        k_waves = self._effective_waves(pending, pending_reservations,
                                        waves_override)
        if k_waves > 1:
            try:
                # _fused_wave_cycles refreshes pod-group status at the end
                # of every logical cycle — no trailing refresh here, or a
                # fused K-cycle would walk the groups K+1 times where K
                # serial cycles walk them K times
                self._fused_wave_cycles(pending, now, ctx, result,
                                        pending_reservations, originals,
                                        k_waves)
                return
            except FusedDispatchDemoted:
                # the fused dispatch window failed before ANY binding was
                # applied and the ladder demoted below fused waves: fall
                # through and run this same pass through the serial path
                # at the demoted settings
                pass

        # ---- batched kernel pass
        rejected_pods, failed_pods = self._batch_pass(
            pending, now, ctx, result, pending_reservations
        )

        any_victims = self._post_filter_preempt(
            rejected_pods, failed_pods, result)
        if any_victims:
            # retry transforms from the ORIGINAL queued pods, not the
            # already-transformed views — a non-idempotent rewrite would
            # otherwise apply twice (BeforePreFilter runs per attempt on
            # the queued pod in the reference too)
            retry = self.extender.transform_before_prefilter(
                [
                    originals.get(p.meta.key, p)
                    for p in rejected_pods + [p for p, _ in failed_pods]
                ],
                ctx,
            )
            rejected_pods, failed_pods = self._batch_pass(
                retry, now, ctx, result, pending_reservations
            )
        for b in result.bound:
            self._preempt_attempted.pop(b.pod_key, None)

        for pod in rejected_pods:
            result.rejected.append(pod.meta.key)
            self.extender.error_handlers.dispatch(pod, "admission rejected")
        for pod, reason in failed_pods:
            result.failed.append(pod.meta.key)
            self.extender.error_handlers.dispatch(pod, reason)
        # pod-status propagation (upstream PodScheduled=False/Unschedulable
        # with the per-stage message): the reason becomes store-visible on
        # the pod object, not just the failure trail
        self._write_unschedulable_conditions(
            rejected_pods, failed_pods, now)
        # the packed batch is only needed within this cycle; don't pin
        # tens of MB of host arrays across idle periods
        self._last_batch = None

        if gang_plugin is not None:
            gang_plugin.update_pod_group_status(self.store, now)

    # ------------------------------------------------------------------
    def _post_filter_preempt(self, rejected_pods: List[Pod],
                             failed_pods: List[Tuple[Pod, str]],
                             result: CycleResult) -> bool:
        """PostFilter preemption for ONE logical scheduling cycle: the
        shared block behind both the serial flow and every fused-wave
        logical cycle, so their preemption cadence can never drift.
        Advances the cycle sequence (the rotation/latch clock) and returns
        whether any victims were evicted (the caller reruns the kernel
        then, exactly as the reference's nominate-then-reschedule).

        ElasticQuota preemption (preempt.go): quota-rejected non-gang pods
        try to reclaim from lower-priority same-group members.
        DefaultPreemption (the vendored kube fallback): pods with no
        feasible node try priority preemption; victims terminate
        synchronously and the kernel rerun is the real gate. The
        attempted-latch stops a pod the kernel STILL rejects (e.g.
        spread/NUMA constraints the host dry-run cannot see) from
        draining a fresh victim set EVERY cycle: a latched pod may retry
        only every PREEMPT_RETRY_CYCLES (cluster state may have unblocked
        it by then — bounded drain instead of either extreme). Keys of
        pods that bound or left the queue are dropped each cycle."""
        any_victims = False
        if self.preemptor is not None and rejected_pods:
            quota_rejected = [
                p for p in rejected_pods if p.quota_name and not p.gang_name
            ]
            for round_ in self.preemptor.post_filter(quota_rejected):
                any_victims = True
                result.preempted_victims.extend(round_.victim_keys)
        PREEMPT_RETRY_CYCLES = 5
        attempted = self._preempt_attempted
        self._cycle_seq += 1
        still_failed_keys = {p.meta.key for p, _ in failed_pods}
        for key in [k for k in attempted if k not in still_failed_keys]:
            del attempted[key]
        no_fit = [
            p for p, reason in failed_pods
            if reason == "no feasible node" and not p.gang_name
            and self._cycle_seq - attempted.get(p.meta.key, -10**9)
            >= PREEMPT_RETRY_CYCLES
        ]
        if no_fit:
            from koordinator_tpu_torch.scheduler.preempt import DefaultPreemption

            preempter = DefaultPreemption(
                self.store,
                kernel_admission=self._resolve_admission(),
                attempt_seed=self._cycle_seq,
            )
            for round_ in preempter.post_filter(no_fit):
                any_victims = True
                attempted[round_.preemptor_key] = self._cycle_seq
                result.preempted_victims.extend(round_.victim_keys)
        return any_victims

    # ------------------------------------------------------------------
    def _write_unschedulable_conditions(
        self,
        rejected_pods: List[Pod],
        failed_pods: List[Tuple[Pod, str]],
        now: float,
    ) -> None:
        """PodScheduled=False/Unschedulable on every pod ending the cycle
        unbound. Specific reasons (encoding overflow, volume PreFilter,
        Reserve vetoes) pass through verbatim; generic kernel rejections
        get the per-stage breakdown from scheduler/diagnose.py. Idempotent:
        an unchanged condition writes nothing (no store churn, no snapshot
        cache invalidation for permanently-pending pods)."""
        last = self._last_batch
        items = list(failed_pods) + [
            (p, "admission rejected") for p in rejected_pods]
        if not items:
            return
        messages = self._capture_attribution(items, last)
        if self.pipeline_mode or self._defer_condition_writes:
            # pipelined cycle: the writes run inside the NEXT cycle's
            # kernel window (flush_deferred), overlapping device work; a
            # fused dispatch flushes its logical cycles' writes at its end.
            # `now` and the packed batch are captured here, so the
            # diagnosis content is byte-identical to the serial path.
            # Only generic kernel rejections consult the packed batch —
            # drop it when no item needs it, so a deferred entry does not
            # pin the fc arrays the `_last_batch = None` release below
            # exists to free. (Streaming use bounds the pinning to one
            # cycle anyway: the next kernel window or a kernel-less cycle
            # drains the queue; idle drivers must call flush().)
            if not any(r in DIAGNOSED_REASONS for _p, r in items):
                last = None
            elif last is not None and last[3] is not None:
                # kernel-emitted counts captured: the deferred formatter
                # needs only (index, n_nodes, counts) — never pin the
                # packed fc arrays across the deferral
                last = (None, last[1], last[2], last[3])
            self._deferred_diagnose.append((items, last, now, messages))
            scheduler_metrics.DIAGNOSE_DEFERRED_TOTAL.inc(len(items))
            scheduler_metrics.DIAGNOSE_DEFERRED_DEPTH.set(
                float(len(self._deferred_diagnose)))
            return
        with self.tracer.span("diagnose", pods=str(len(items))):
            self._diagnose_and_write(items, last, now, messages=messages)

    def _stash_terms(self, keys, chosen_mask, terms_np) -> None:
        """KOORD_TPU_EXPLAIN=full: per-pod decision-time score attribution
        rows for pods the kernel chose a node for. Only pods that finish
        the cycle BOUND are surfaced (a Reserve veto leaves the row
        unread)."""
        for i, key in enumerate(keys):
            if bool(chosen_mask[i]):
                row = terms_np[i]
                self._cycle_terms[key] = {
                    name: float(row[j])
                    for j, name in enumerate(EXPLAIN_TERMS)
                }

    def _capture_attribution(self, items, last) -> Optional[Dict[str, str]]:
        """koordexplain capture, at verdict time (NOT at deferred-flush
        time, so pipeline mode cannot skew metrics or the flight record):
        per-stage rejection counters + the /explain and flight-recorder
        attribution entries for pods ending this logical cycle unbound.
        Returns the formatted message per pod key so the condition writer
        never formats the same counts twice. No-op (None) when the
        dispatch emitted no counts (explain off, or demoted off)."""
        if self.explain_spec is None:
            return None
        counts = last[3] if last is not None else None
        messages: Dict[str, str] = {}
        for pod, reason in items:
            entry: Dict[str, object] = {"verdict": "unschedulable",
                                        "reason": reason}
            if self._current_decision_id is not None:
                # koordwatch: join the verdict to its device window
                entry["decision_id"] = self._current_decision_id
            if counts is not None and reason in DIAGNOSED_REASONS:
                j = last[1].get(pod.meta.key)
                if j is not None:
                    row = counts[j]
                    stages = {}
                    for stage_key, c in zip(EXPLAIN_STAGE_KEYS, row):
                        if int(c):
                            stages[stage_key] = int(c)
                            scheduler_metrics.FILTER_REJECTIONS.inc(
                                int(c), stage=stage_key)
                    entry["stages"] = stages
                    msg = format_stage_counts(row, last[2])
                    entry["message"] = msg
                    messages[pod.meta.key] = msg
            self._cycle_attrib[pod.meta.key] = entry
        return messages or None

    def _flush_deferred_in_window(self) -> None:
        """flush_deferred from inside a ladder-wrapped dispatch window:
        tag host/store-side failures so the ladder's except does not
        mistake them for device failures (see _HostWriteFailure)."""
        try:
            self.flush_deferred()
        except Exception as exc:
            raise _HostWriteFailure() from exc

    def _prepack_in_window(self) -> None:
        """Pack/device overlap (KOORD_TPU_PACK_OVERLAP): pre-pack the
        NEXT cycle's candidate pod rows into the pack memo while the
        device executes this cycle's kernel — the store-delta snapshot
        is taken HERE, at dispatch time, after the deferred flush bumped
        the condition-written pods. Rows dirtied later in the window
        (bind patches from the in-flight replay, watch events) simply
        miss the (key, resourceVersion) memo keys at the real pack and
        re-pack there, so the produced ScheduleInputs are byte-identical
        to the non-overlapped pack by construction (gated by
        scheduler/pipeline_parity.run_pack_overlap_parity, run by
        tests/test_torch_cycle_waves.py and chip_smoke.py's pack_overlap
        phase, and by the JAX package's tests/test_pack_overlap.py cases
        on the port, tests/test_torch_ref_pack_overlap.py, the
        mid-window-mutation case among them).

        Purely a memo warm: a failure here costs nothing but the
        overlap — the next cycle packs in the gap exactly as before —
        so it is caught and logged, never raised.

        A registered BeforePreFilter view transform disables the
        pre-pack: the real pack consumes TRANSFORMED pod views that
        keep the store resourceVersion, so a pre-packed raw row would
        be a (key, rv) hit serving untransformed bytes — the same
        cannot-see-the-rewrite stance as the fused path's host-only
        transformer demotion."""
        if not self.pack_overlap or self.snapshot_cache is None:
            return
        from koordinator_tpu_torch.scheduler.frameworkext import (
            PreFilterTransformer,
        )

        if any(isinstance(t, PreFilterTransformer)
               and type(t).before_prefilter
               is not PreFilterTransformer.before_prefilter
               for t in self.extender.transformers):
            return
        try:
            from koordinator_tpu_torch.scheduler.snapshot import (
                prepack_pending_rows,
            )

            with self.tracer.span("prepack") as sp:
                pods = [
                    p for p in self.store.list(KIND_POD)
                    if not p.is_assigned and not p.is_terminated
                    and p.spec.scheduler_name == self.scheduler_name
                ]
                n = prepack_pending_rows(self.snapshot_cache, pods,
                                         self.args)
                sp.attributes["rows"] = str(n)
            if n:
                scheduler_metrics.PREPACK_ROWS.inc(n)
        except Exception:
            # a pre-pack wreck may have left HALF-updated memo rows
            # (resourceVersion bumped before every column refreshed) —
            # rows the next build would serve as hits with stale bytes.
            # Poison the memo wholesale: the next pack runs the cold
            # path (bit-identical by the snapshot-cache contract) and
            # rebuilds it; one expensive build buys back correctness.
            self.snapshot_cache.pack_memo = None
            self.snapshot_cache.pack_memo_prev = None
            logger.exception("in-window pre-pack failed; pack memo "
                             "dropped — the next cycle repacks cold in "
                             "the gap")

    def flush_deferred(self) -> None:
        """Drain deferred diagnose/condition work (pipeline mode). Runs in
        the next cycle's kernel window — host work the device never waits
        on — and from CyclePipeline.flush() at end of stream. FIFO order
        preserves the serial path's write sequence when a pod accumulates
        verdicts across cycles."""
        self._flushed_this_cycle = True
        # overlapped-replay mode batches the whole flush into one store
        # transaction; overlap=0 keeps the per-pod writes of the parity
        # twin byte-for-byte (event granularity included)
        txn = (_DeferredFlushTxn(self.store)
               if self.replay_overlap and self._deferred_diagnose else None)
        while self._deferred_diagnose:
            items, last, now, messages = self._deferred_diagnose.pop(0)
            with self.tracer.span("diagnose", pods=str(len(items)),
                                  deferred="1"):
                self._diagnose_and_write(items, last, now, deferred=True,
                                         messages=messages, txn=txn)
        if txn is not None and txn.pending:
            with self.tracer.span("store_flush",
                                  writes=str(len(txn.pending))):
                txn.flush()
        scheduler_metrics.DIAGNOSE_DEFERRED_DEPTH.set(
            float(len(self._deferred_diagnose)))

    def _diagnose_and_write(self, items, last, now: float,
                            deferred: bool = False, messages=None,
                            txn: Optional[_DeferredFlushTxn] = None) -> None:
        from koordinator_tpu_torch.scheduler.diagnose import (
            diagnose_unbound,
            shared_state,
        )

        shared = None  # node-level diagnosis state, built once per cycle
        for pod, reason in items:
            msg = reason
            if messages is not None and pod.meta.key in messages:
                # koordexplain: _capture_attribution already formatted the
                # dispatch's counts at verdict time — reuse, don't
                # recompute
                msg = messages[pod.meta.key]
            elif last is not None and reason in DIAGNOSED_REASONS:
                fc, index, n_nodes, counts = last
                j = index.get(pod.meta.key)
                if j is not None:
                    try:
                        if counts is not None:
                            # koordexplain: a pure formatter over the
                            # dispatch's stage counts, no host recompute
                            msg = format_stage_counts(counts[j], n_nodes)
                        elif fc is not None:
                            # the host-numpy recompute over the batch the
                            # round consumed: the parity oracle, and the
                            # path explain-off keeps
                            if shared is None:
                                shared = shared_state(fc, n_nodes)
                            msg = diagnose_unbound(fc, j, n_nodes,
                                                   shared=shared)
                    except Exception:  # diagnosis must never wedge a cycle
                        logger.exception(
                            "unschedulability diagnosis failed for %s",
                            pod.meta.key)
            stored = (txn.get(pod.meta.key) if txn is not None
                      else self.store.get(KIND_POD, pod.meta.key))
            if stored is None:  # reservation pseudo-pods, raced deletions
                continue
            if deferred:
                # the flush runs after later store activity; two ways the
                # verdict can be superseded, both of which the serial path
                # resolved by writing BEFORE that activity:
                #  * the pod was bound (next cycle's nomination pre-pass):
                #    serial's transient False was overwritten by the
                #    bind's PodScheduled=True — skipping converges;
                #  * the pod was deleted and RECREATED under the same key
                #    (stable StatefulSet-style names, fresh uid): serial
                #    stamped the old incarnation; the new pod must wait
                #    for its own verdict.
                if stored.is_assigned:
                    continue
                if (stored.meta.uid and pod.meta.uid
                        and stored.meta.uid != pod.meta.uid):
                    continue
                # uid-less objects (bare test fixtures): creation time is
                # the remaining identity signal — a recreated incarnation
                # carries a fresh timestamp, the same incarnation never
                # changes its own
                if (stored.meta.creation_timestamp
                        != pod.meta.creation_timestamp):
                    continue
            cur = stored.get_condition("PodScheduled")
            if cur is not None and (cur.status, cur.message) == ("False", msg):
                continue
            patched = stored.patch_copy()
            patched.set_condition(
                "PodScheduled", "False", "Unschedulable", msg, now)
            if txn is not None:
                txn.put(patched)
            else:
                self.store.update(KIND_POD, patched)

    # ------------------------------------------------------------------
    def _resolve_admission(self):
        """The (node -> group, pod key -> mask) dicts host-side dry-runs
        consult. Built lazily from the raw arrays the last encode stashed:
        materializing 10k-entry dicts on every cycle charged the hot path
        for a mapping only the (rare) preemption path reads."""
        raw = self._last_admission_raw
        if raw is None:
            return None
        if self._last_admission is None:
            node_group_arr, node_names, pod_mask_arr, pod_keys = raw
            self._last_admission = (
                {n: int(node_group_arr[i]) for i, n in enumerate(node_names)},
                {key: int(pod_mask_arr[i])
                 for i, key in enumerate(pod_keys)},
            )
        return self._last_admission

    def _encode_batch(self, pending: List[Pod], now: float,
                      ctx: CycleContext, transform_score: bool = True):
        """Snapshot + encode: store objects -> packed FullChainInputs.
        Returns (fc, pods, nodes, ng, ngroups, active) or None when no
        schedulable node exists. Shared by the serial and fused paths.

        ``transform_score=False`` (the fused dispatchers): registered
        ScoreTransformers are NOT applied host-side — the wave step
        applies their device passes to every wave's rebuilt inputs
        instead (applying both would transform twice)."""
        # pods arrive already view-transformed (run_cycle runs BeforePreFilter
        # ahead of the nomination pre-pass); here the state-level transformer
        # chain runs: ClusterState rewrites, then packed-input rewrites
        t_pack = time.perf_counter()
        with self.tracer.span("snapshot") as ssp:
            state = self._cluster_state(pending, now)
            self.extender.transform_after_prefilter(state, ctx)
            self.extender.transform_before_filter(state, ctx)
            ssp.attributes["nodes"] = str(len(state.nodes))
            ssp.attributes["pods"] = str(len(pending))
        if not state.nodes:
            self._add_pack_wall(time.perf_counter() - t_pack)
            return None
        with self.tracer.span("encode"):
            cs = (self.snapshot_cache.stats
                  if self.snapshot_cache is not None else None)
            hits0 = cs["pod_row_hits"] if cs is not None else 0
            miss0 = cs["pod_row_misses"] if cs is not None else 0
            with self.tracer.span("pack_incremental") as pis:
                fc, pods, nodes, tree, gang_index, ng, ngroups = (
                    build_full_chain_inputs(
                        state, self.args, cache=self.snapshot_cache
                    ))
            if cs is not None:
                reused = cs["pod_row_hits"] - hits0
                repacked = cs["pod_row_misses"] - miss0
                pis.attributes["rows_reused"] = str(reused)
                pis.attributes["rows_repacked"] = str(repacked)
                scheduler_metrics.PACK_ROWS_REUSED.inc(reused)
                scheduler_metrics.PACK_ROWS_REPACKED.inc(repacked)
            # stash the admission grouping this kernel pass used so
            # host-side dry-runs (DefaultPreemption) consult the SAME
            # encoding — the raw label check can be more permissive when
            # the signature budget overflowed, and the dry-run must never
            # accept a node the kernel cannot bind (it would evict victims
            # in vain). Raw arrays only: _resolve_admission materializes
            # the dicts on the (rare) preemption path instead of charging
            # every cycle for them.
            self._last_admission_raw = (
                np.asarray(fc.node_taint_group),
                [n.meta.name for n in state.nodes],
                np.asarray(fc.pod_taint_mask),
                list(pods.keys),
            )
            self._last_admission = None
            if transform_score:
                fc = self.extender.transform_before_score(fc, ctx)
            fc, active = reduce_to_active_axes(fc)
            # keep the packed batch for end-of-cycle unschedulability
            # diagnosis (scheduler/diagnose.py reads the same arrays the
            # kernel consumed); a retry pass overwrites this with the
            # final batch. 4th slot: the dispatch's explain counts,
            # filled after the dispatch when explain is on
            self._last_batch = (
                fc, {key: j for j, key in enumerate(pods.keys)},
                len(state.nodes), None)
        self._add_pack_wall(time.perf_counter() - t_pack)
        if self.encode_observer is not None:
            # parity/test hook: the post-reduce host arrays — the
            # ScheduleInputs level the pack-overlap byte-parity gates on
            self.encode_observer(fc)
        return fc, pods, nodes, ng, ngroups, active

    def _record_upload_deltas(self) -> None:
        """DeviceSnapshot stats -> per-cycle counter deltas."""
        ds = self.device_snapshot.stats
        prev_ds = self._upload_stats_last
        for key, counter in (
            ("reused", scheduler_metrics.UPLOAD_FIELDS_REUSED),
            ("scattered", scheduler_metrics.UPLOAD_FIELDS_SCATTERED),
            ("put", scheduler_metrics.UPLOAD_FIELDS_PUT),
            ("bytes_scattered", scheduler_metrics.UPLOAD_BYTES_SCATTERED),
            ("bytes_put", scheduler_metrics.UPLOAD_BYTES_PUT),
        ):
            counter.inc(ds[key] - prev_ds.get(key, 0))
        self._upload_stats_last = dict(ds)


    def _readback_sync(self, *tensors, path: str = "serial"):
        """The designated host sync point: materialize the round's outputs,
        MONITORED by the dispatch-deadline watchdog (koordguard). With a
        deadline armed the blocking body runs on a watchdog worker; an
        overrun raises DispatchDeadlineExceeded into the dispatch window,
        whose ladder retries or demotes, instead of wedging the cycle
        behind a slow-not-dead device. The default no-deadline path is
        inline."""
        return self.dispatch_watchdog.run(
            lambda: self._readback_sync_now(*tensors), path)

    def _readback_sync_now(self, *tensors):
        """The blocking readback body: ``.cpu().numpy()`` of each tensor.
        On a watchdog worker thread the CUDA device is set first (a new
        thread starts on device 0). Mesh mode routes through the
        per-shard merge (parallel/mesh.merge_readback) and its
        observability."""
        import torch

        if self.sync_delay_injector is not None:
            # latency injection: a slow-not-dead device is a sync that
            # takes too long, exactly where the watchdog watches
            self.sync_delay_injector()
        if self.mesh is not None:
            return self._mesh_merge_readback(*tensors)
        out = []
        for t in tensors:
            if t.is_cuda:
                torch.cuda.set_device(t.device)
            out.append(t.cpu().numpy())
        return out

    def _mesh_merge_readback(self, *arrays):
        """Mesh-branch readback: merge the (replicated) compacted output
        buffers from the per-shard copies (parallel/mesh.merge_readback),
        then surface how the dispatch split across the mesh: per-shard
        readback bytes and the real-row imbalance gauges, and a
        ``shard[i]`` marker span per device under the kernel span.
        ``_node_rows`` is the dispatch's (real nodes, padded node axis).
        Under a deadline the body runs on the watchdog's worker, whose
        spans land as detached roots, as in the JAX package."""
        import torch

        from koordinator_tpu_torch.parallel.mesh import (
            merge_readback,
            mesh_row_layout,
        )

        for a in arrays:
            t = a.local() if hasattr(a, "local") else a
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.set_device(t.device)
        out, per_shard = merge_readback(*arrays)
        n_real, n_padded = self._node_rows
        rows = mesh_row_layout(self.mesh, n_real, n_padded)
        mean_rows = float(np.mean(rows)) if rows else 0.0
        scheduler_metrics.MESH_SHARD_IMBALANCE.set(
            float(max(rows)) / mean_rows if mean_rows > 0 else 0.0)
        for i, dev in enumerate(self.mesh.devices.flat):
            nbytes = per_shard.get(dev.id, 0)
            scheduler_metrics.MESH_SHARD_READBACK_BYTES.set(
                float(nbytes), shard=str(i))
            with self.tracer.span("shard", index=str(i), rows=str(rows[i]),
                                  readback_bytes=str(nbytes)):
                pass
        return out

    def _batch_pass(
        self,
        pending: List[Pod],
        now: float,
        ctx: CycleContext,
        result: CycleResult,
        pending_reservations: Dict[str, Reservation],
    ) -> Tuple[List[Pod], List[Tuple[Pod, str]]]:
        """One snapshot -> kernel -> bind pass. Appends bindings to `result`
        and returns (rejected_pods, failed) still unbound — `failed` carries
        (pod, reason) so Reserve/PreBind veto reasons survive to dispatch —
        the caller decides whether to retry them (preemption) or record them."""
        rejected_pods: List[Pod] = []
        failed_pods: List[Tuple[Pod, str]] = []
        enc = self._encode_batch(pending, now, ctx)
        if enc is None:
            return rejected_pods, [(p, "no schedulable node") for p in pending]
        fc, pods, nodes, ng, ngroups, active = enc
        if self._sidecar_client is not None:
            chosen = self._dispatch_sidecar(fc, pods, nodes, ng, ngroups,
                                            active, result)
        else:
            chosen = self._dispatch_serial(fc, pods, nodes, ng, ngroups,
                                           active, result)

        # apply bindings in queue order
        with self.tracer.span("bind") as bsp:
            bound_before = len(result.bound)
            by_key = {p.meta.key: p for p in pending}
            for i, key in enumerate(pods.keys):
                node_idx = int(chosen[i])
                pod = by_key[key]
                if node_idx < 0:
                    # encoding-budget overflows carry their own first-class
                    # reason (surfaced via the error-handler event trail
                    # and the overflow metric) and never enter preemption —
                    # no victim set can fix an encoding cut
                    reason = pods.unschedulable_reasons.get(i)
                    if reason is not None:
                        failed_pods.append((pod, reason))
                    elif pod.gang_name or pod.quota_name:
                        rejected_pods.append(pod)
                    else:
                        failed_pods.append((pod, "no feasible node"))
                    continue
                node_name = nodes.names[node_idx]
                reservation = pending_reservations.get(key)
                err = self._reserve_and_bind(
                    pod, node_name, ctx, result, reservation_cr=reservation
                )
                if err:
                    failed_pods.append((pod, err))
            bsp.attributes["bound"] = str(len(result.bound) - bound_before)
        return rejected_pods, failed_pods

    # ------------------------------------------------------------------
    def _dispatch_sidecar(self, fc, pods, nodes, ng, ngroups, active,
                          result: CycleResult) -> np.ndarray:
        """Sidecar-served batch pass: the RPC layer owns its own
        degradation (a transport failure runs this Scheduler's keyed step
        on its device: kernel 1 on the card), so the ladder does not wrap
        this path. ``last_backend`` says "sidecar" for a served batch and
        the local step's backend after a fallback."""
        # the sidecar protocol ships only the chosen vector: explain
        # resolves to off through the koordwatch chokepoint (the reason
        # is accounted, the value is None)
        explain = self._effective_explain()
        step = self._get_step(
            (pods.padded_size, nodes.padded_size, fc.quota_runtime.shape[0]),
            ng, ngroups, active, explain=explain,
        )
        with self.tracer.span(
                "kernel",
                compiled="1" if self._last_step_compiled else "0") as ksp:
            chosen, _, _, used_fallback = schedule_batch_or_fallback(
                self._sidecar_client, fc, ng, ngroups, self.args,
                active_axes=active, local_step=step, device=self.device,
            )
            if used_fallback:
                self.sidecar_fallbacks += 1
                scheduler_metrics.SIDECAR_FALLBACKS.inc()
                self.last_backend = step.last_backend
            else:
                self.last_backend = "sidecar"
        result.kernel_seconds += ksp.duration_seconds
        scheduler_metrics.KERNEL_SECONDS.observe(ksp.duration_seconds)
        return chosen

    def _dispatch_serial(self, fc_host, pods, nodes, ng, ngroups, active,
                         result: CycleResult) -> np.ndarray:
        """The single-round device-dispatch window, wrapped in the
        degradation ladder: upload (through the device mirror, or in full
        without one), one round (the CUDA kernel on the card; gang Permit
        included; under explain the stage-count pass, and at "full" the
        kernel's terms instance), one readback. A device fault anywhere
        between step
        lookup and readback (strictly before any binding) retries once,
        then demotes — finally to the pure-host pass — instead of killing
        the scheduler. ``fc_host`` keeps the host arrays, so every retry
        re-uploads from them against the (possibly rebuilt) mirror. Any
        other failure propagates out of the cycle (_window_failure)."""
        self.ladder.begin_pass()
        # koordwatch device window for this pass: the decision id joins
        # the kernel span, the flight record and /explain; the window
        # records the SUCCESSFUL attempt's dispatch->sync interval
        win = self._open_window("serial")
        attempts = 0
        had_deadline = False
        level0 = self.ladder.level
        while True:
            if self.ladder.level >= LEVEL_HOST_FALLBACK:
                # no device dispatch: the window never completes
                return self._dispatch_host_fallback(fc_host, pods, nodes,
                                                    result)
            explain = self._effective_explain()
            ex_out = None
            try:
                step = self._get_step(
                    (pods.padded_size, nodes.padded_size,
                     fc_host.quota_runtime.shape[0]),
                    ng, ngroups, active, explain=explain,
                )
                with self.tracer.span(
                        "kernel",
                        compiled="1" if self._last_step_compiled else "0",
                        decision_id=win.decision_id) as ksp:
                    snap = self.device_snapshot
                    with self.tracer.span("upload"):
                        if snap is not None:
                            # device-resident steady state: unchanged
                            # fields reuse the previous cycle's tensors,
                            # small row deltas go up as row scatters
                            # (snapshot_cache.DeviceSnapshot); the
                            # round's host pack rides the same transfer
                            fc = snap.upload(fc_host, pack=snap.mesh is None)
                            self._record_upload_deltas()
                        else:
                            fc = to_device(fc_host, self.device)
                    self._node_rows = (len(nodes.names),
                                       int(fc.base.allocatable.shape[0]))
                    if snap is not None:
                        snap.begin_dispatch()
                    if self._last_step_compiled:
                        # the warm-up index: a fresh build's rung (step
                        # meta + call specs) so the NEXT process can
                        # pre-build this exact step
                        self._record_step_compile(
                            "serial",
                            self._step_meta(
                                (pods.padded_size, nodes.padded_size,
                                 fc_host.quota_runtime.shape[0]),
                                ng, ngroups, active, explain),
                            (fc, len(nodes.names))
                            if explain is not None else (fc,))
                    t_dispatch = time.perf_counter()
                    win.mark_dispatch("serial")
                    try:
                        if self.fault_injector is not None:
                            self.fault_injector("serial")
                        if explain is not None:
                            # same dispatch, extra attribution outputs;
                            # n_real masks padded node rows out of the
                            # stage counts
                            chosen, _, _, ex_out = step(fc,
                                                        len(nodes.names))
                        else:
                            chosen, _, _ = step(fc)  # queued — no sync
                        self.last_backend = step.last_backend
                        self.dispatches += 1
                        if self.pipeline_mode:
                            # overlap window: the previous cycle's deferred
                            # host work (unschedulability diagnosis +
                            # condition writes) runs while the device
                            # executes this cycle's round, then the next
                            # cycle's candidate rows pre-pack into the memo
                            # (pack overlap). Host memory only: the
                            # mirror's next scatter waits for the sync.
                            self._flush_deferred_in_window()
                            self._prepack_in_window()
                            with self.tracer.span("overlap_wait"):
                                # the pipeline's single designated sync
                                # point: bind needs the chosen vector,
                                # nothing before does
                                chosen, = self._readback_sync(chosen)
                        else:
                            with self.tracer.span("readback"):
                                chosen, = self._readback_sync(chosen)
                        if ex_out is not None:
                            # the dispatch completed at the chosen sync
                            # above: these copies wait for nothing new
                            with self.tracer.span("readback",
                                                  explain=explain):
                                explain_counts = _host(
                                    ex_out.stage_counts)
                                terms_np = (_host(ex_out.terms)
                                            if ex_out.terms is not None
                                            else None)
                    finally:
                        if snap is not None:
                            snap.end_dispatch()
                    result.device_busy_seconds += (
                        time.perf_counter() - t_dispatch)
                    scheduler_metrics.WAVES_PER_DISPATCH.observe(1.0)
                    scheduler_metrics.READBACK_BYTES.inc(int(chosen.nbytes))
                    if ex_out is not None:
                        ex_bytes = explain_counts.nbytes
                        if terms_np is not None:
                            ex_bytes += terms_np.nbytes
                            self._stash_terms(pods.keys, chosen >= 0,
                                              terms_np)
                        scheduler_metrics.EXPLAIN_READBACK_BYTES.inc(
                            int(ex_bytes))
                        fc_lb, idx_lb, n_lb, _ = self._last_batch
                        self._last_batch = (fc_lb, idx_lb, n_lb,
                                            explain_counts)
                result.kernel_seconds += ksp.duration_seconds
                scheduler_metrics.KERNEL_SECONDS.observe(
                    ksp.duration_seconds)
                if self._last_step_compiled:
                    # the kernel library loaded in this window: its wall
                    # is compile time for the restart attribution split
                    self._add_compile_wall(ksp.duration_seconds)
                self._close_window(win, attempts, had_deadline, level0)
                return chosen
            except Exception as exc:
                # retry or demote (settings re-applied by the transition
                # observer), or re-raise
                self._window_failure("serial", exc)
                attempts += 1
                had_deadline |= isinstance(exc, DispatchDeadlineExceeded)

    def _dispatch_host_fallback(self, fc_host, pods, nodes,
                                result: CycleResult) -> np.ndarray:
        """The ladder's bottom rung: no device dispatch at all — a
        pure-host numpy scheduling pass over the diagnose oracle
        (scheduler/degrade.host_fallback_schedule) on the host pack. A
        failure here has no deeper rung to absorb it and propagates as an
        unhandled cycle exception (flight recorder ``cycle_exception``
        trigger). ``_last_batch`` keeps the host arrays, so
        unschedulability diagnosis runs through the host recompute
        unchanged."""
        with self.tracer.span("kernel", host_fallback="1") as ksp:
            chosen = host_fallback_schedule(fc_host, pods,
                                            len(nodes.names))
        self.last_backend = "host-fallback"
        result.kernel_seconds += ksp.duration_seconds
        scheduler_metrics.KERNEL_SECONDS.observe(ksp.duration_seconds)
        return chosen

    # ------------------------------------------------------------------
    # fused multi-wave dispatch (models/fused_waves.py)
    # ------------------------------------------------------------------
    def _fused_wave_cycles(
        self,
        pending: List[Pod],
        now: float,
        ctx: CycleContext,
        result: CycleResult,
        pending_reservations: Dict[str, Reservation],
        originals: Dict[str, Pod],
        k_waves: int,
    ) -> None:
        """K scheduling rounds per device dispatch, replayed host-side as
        logical cycles (models/fused_waves.py has the step's contract).
        Each logical cycle w binds wave w's pods, runs the SAME preemption
        block serial cycle w would (_post_filter_preempt — including its
        per-cycle rotation clock), and writes conditions diagnosed against
        wave-w-start state (a host numpy mirror advanced with the read-back
        bindings). A Reserve veto or a preemption retry truncates: the
        device state beyond that wave assumed a world that didn't happen,
        so the remaining rounds fall to the next cycle. result.waves
        reports the logical cycles completed.

        Condition writes are BATCHED per dispatch: each logical cycle's
        verdicts are captured at verdict time (same packed state, same
        ``now``) but queue on the deferred machinery; the dispatch drains
        them in one flush at the end (pipeline mode keeps deferring into
        the next kernel window). The supersede guards in
        ``_diagnose_and_write`` make the late writes converge to exactly
        the serial end state."""
        self._defer_condition_writes = True
        try:
            dispatch = (self._fused_wave_dispatch_overlap
                        if self.replay_overlap
                        else self._fused_wave_dispatch)
            dispatch(pending, now, ctx, result,
                     pending_reservations, originals, k_waves)
        finally:
            self._defer_condition_writes = False
            if not self.pipeline_mode and self._deferred_diagnose:
                # ONE store-write flush for the whole dispatch (pipeline
                # mode leaves the queue for the next kernel window)
                self.flush_deferred()

    def _fused_no_node_cycles(self, pending: List[Pod], now: float,
                              result: CycleResult, k_waves: int) -> None:
        """The serial early-return (no schedulable node), repeated K
        times: every logical cycle re-dispatches the same verdicts
        (idempotent condition writes, per-cycle failure-trail events —
        exactly what K no-node serial cycles produce)."""
        failed = [(p, "no schedulable node") for p in pending]
        gang_plugin = self.extender.plugin("Coscheduling")
        for _w in range(k_waves):
            self._post_filter_preempt([], failed, result)
            for pod, reason in failed:
                result.failed.append(pod.meta.key)
                self.extender.error_handlers.dispatch(pod, reason)
            self._write_unschedulable_conditions([], failed, now)
            result.waves += 1
            if gang_plugin is not None:
                gang_plugin.update_pod_group_status(self.store, now)

    def _encode_wave_sides(self, fc_host, pods, nodes, pending: List[Pod],
                           pending_reservations: Dict[str, Reservation],
                           active, now: float):
        """Build one dispatch's WaveSideInputs (host arrays) + the replay
        context: the LoadAware term splits, the hot-claim factorization
        (ops/volumes.py) and the packed reservation rows (owner-match
        columns, allocatable remainders, nomination eligibility) the
        wave pre-passes consume. Returns (fields dict for upload,
        assembler, replay context dict)."""
        ex = nodes.extras
        axis_idx = np.asarray(active)

        def take(name):
            return np.ascontiguousarray(np.take(ex[name], axis_idx,
                                                axis=-1))

        fields = {"la_est_nonprod": take("la_est_nonprod"),
                  "la_adj_nonprod": take("la_adj_nonprod")}
        prod = self.args.score_according_prod_usage
        if prod:
            fields["la_est_prod"] = take("la_est_prod")
            fields["la_adj_prod"] = take("la_adj_prod")
        n_pad = int(np.shape(fc_host.base.allocatable)[0])
        p_pad = pods.padded_size
        claim_pack = None
        analysis = self._claim_analysis
        if analysis is not None and analysis.hot:
            # the attached view rides the analysis (stashed at
            # _effective_waves time — never materialized twice per cycle)
            attached = (analysis.attached if analysis.attached is not None
                        else attached_claim_sets(self.store))
            claim_pack = build_claim_pack(
                analysis, pods.keys, nodes.names, attached, p_pad, n_pad)
        if claim_pack is not None:
            fields["claim_pod"] = claim_pack.pod_claim
            fields["claim_nonhot"] = claim_pack.pod_nonhot
            fields["claim_covered0"] = claim_pack.covered0
        res_slots: List[Reservation] = []
        res_ctx: Dict[str, object] = {"claim_pack": claim_pack,
                                      "res_slots": res_slots,
                                      "res_slot_of": {},
                                      "res_alloc": None, "res_once": None}
        res_plugin = self.extender.plugin("Reservation")
        slot_keys = [k for k in pods.keys if k in pending_reservations]
        if slot_keys:
            nres = len(slot_keys)
            row_index = {key: i for i, key in enumerate(pods.keys)}
            row_of = np.full(nres, -1, np.int32)
            pod_slot = np.full(p_pad, -1, np.int32)
            alloc = np.zeros((nres, len(axis_idx)), np.float32)
            once = np.zeros(nres, np.float32)
            expired = np.zeros(nres, bool)
            for j, key in enumerate(slot_keys):
                res = pending_reservations[key]
                res_slots.append(res)
                row = row_index[key]
                row_of[j] = row
                pod_slot[row] = j
                alloc[j] = res.template.requests.to_vector()[axis_idx]
                once[j] = 1.0 if res.allocate_once else 0.0
                expired[j] = res.is_expired(now)
            # the host nominator's preference: earliest created wins
            order = sorted(
                range(nres),
                key=lambda j: (res_slots[j].meta.creation_timestamp,
                               res_slots[j].meta.name))
            rank = np.zeros(nres, np.int32)
            for pos, j in enumerate(order):
                rank[j] = pos
            owner_match = np.zeros((p_pad, nres), bool)
            nominate_ok = np.zeros(p_pad, bool)
            if res_plugin is not None:
                by_key = {p.meta.key: p for p in pending}
                for i, key in enumerate(pods.keys):
                    if key in pending_reservations:
                        continue
                    pod = by_key.get(key)
                    if pod is None:
                        continue
                    spec = pod.spec
                    # the host pre-pass eligibility class (run_cycle's
                    # nomination loop): gang/quota admission lives in the
                    # kernel, and hostPort/PVC/affinity/spread placement
                    # must pass the Filter chain
                    if (pod.gang_name or pod.quota_name
                            or spec.host_ports or spec.pvc_names
                            or spec.pod_affinity or spec.pod_anti_affinity
                            or spec.topology_spread):
                        continue
                    nominate_ok[i] = True
                    for j, rkey in enumerate(slot_keys):
                        owner_match[i, j] = (
                            not expired[j]
                            and pending_reservations[rkey].matches(pod))
            fields["res_owner_match"] = owner_match
            fields["res_rank"] = rank
            fields["res_alloc"] = alloc
            fields["res_once"] = once
            fields["res_row_of"] = row_of
            fields["res_pod_slot"] = pod_slot
            fields["res_nominate_ok"] = nominate_ok
            res_ctx["res_alloc"] = alloc
            res_ctx["res_once"] = once
            res_ctx["res_slot_of"] = {k: j for j, k in
                                      enumerate(slot_keys)}

        def assemble(up: Dict[str, object]) -> WaveSideInputs:
            return WaveSideInputs(
                la_est=up["la_est_nonprod"],
                la_adj=up["la_adj_nonprod"],
                prod=(ProdSides(est=up["la_est_prod"],
                                adj=up["la_adj_prod"]) if prod else None),
                claims=(ClaimSides(pod_claim=up["claim_pod"],
                                   pod_nonhot=up["claim_nonhot"],
                                   covered0=up["claim_covered0"])
                        if claim_pack is not None else None),
                res=(ResSides(owner_match=up["res_owner_match"],
                              rank=up["res_rank"],
                              alloc=up["res_alloc"],
                              once=up["res_once"],
                              row_of=up["res_row_of"],
                              pod_slot=up["res_pod_slot"],
                              nominate_ok=up["res_nominate_ok"])
                     if slot_keys else None),
            )

        res_ctx["tag"] = (
            claim_pack.n_claims if claim_pack is not None else 0,
            len(slot_keys))
        return fields, assemble, res_ctx

    def _upload_wave_inputs(self, fc_host, side_fields, assemble):
        """The dispatch's inputs on the device: the batch and the side
        arrays through the mirror's reuse/scatter/put machinery, or in
        full without a mirror. Returns (fc, sides)."""
        from koordinator_tpu_torch.models.convert import as_tensor

        snap = self.device_snapshot
        with self.tracer.span("upload"):
            if snap is not None:
                fc = snap.upload(fc_host)
                up = snap.upload_fields(side_fields)
                self._record_upload_deltas()
            else:
                fc = to_device(fc_host, self.device)
                up = {k: as_tensor(v, self.device)
                      for k, v in side_fields.items()}
        return fc, assemble(up)

    def _new_wave_mirror(self, fc_host, res_ctx) -> "_WaveStateMirror":
        return _WaveStateMirror(fc_host, claims=res_ctx["claim_pack"],
                                res_alloc=res_ctx["res_alloc"])

    def _replay_nominated_binds(self, seg_rows, pod_of, nodes, res_ctx,
                                ctx, result: CycleResult,
                                failed_pods: List[Tuple[Pod, str]],
                                txn=None):
        """Replay ONE wave's in-dispatch nominations host-side, FIRST — the
        serial pre-pass position: via-reservation Reserve hooks +
        consume(). ``pod_of`` resolves a packed row to its Pod. Returns
        (veto, bound_rows, failed_rows, mirror_ops, succ_next_ops) — ONE
        implementation for both the fused and the overlapped-chain replay.
        A Reserve veto truncates the dispatch (the next dispatch's host
        pre-pass re-runs the pod: one lost cycle)."""
        res_slots = res_ctx["res_slots"]
        res_once = res_ctx["res_once"]
        veto = False
        bound_rows: set = set()
        failed_rows: set = set()
        mirror_ops: List[Tuple] = []
        succ_next: List[Tuple] = []
        for row, node_idx, zone, slot in seg_rows:
            if slot < 0:
                continue
            pod = pod_of(row)
            res = res_slots[slot]
            err = self._reserve_and_bind(
                pod, nodes.names[node_idx], ctx, result,
                via_reservation=res, txn=txn)
            if err:
                failed_pods.append((pod, err))
                failed_rows.add(row)
                veto = True
            else:
                bound_rows.add(row)
                mirror_ops.append(("nom", row, node_idx, zone))
                if res_once is not None and res_once[slot] > 0:
                    # the reconcile's Succeeded transition lands one wave
                    # later — both on device and in the mirror
                    succ_next.append(("succ", row, slot, node_idx))
        return veto, bound_rows, failed_rows, mirror_ops, succ_next

    def _fused_wave_dispatch(
        self,
        pending: List[Pod],
        now: float,
        ctx: CycleContext,
        result: CycleResult,
        pending_reservations: Dict[str, Reservation],
        originals: Dict[str, Pod],
        k_waves: int,
    ) -> None:
        """The single-call fused dispatch (replay overlap off, the
        byte-exact twin): all K waves in one step call, one readback, then
        the host replay of every wave as a logical cycle."""
        result.waves = 0
        # transform_score=False: registered ScoreTransformers run as
        # passes on every wave's rebuilt inputs — the host before_score
        # must NOT also apply at encode
        enc = self._encode_batch(pending, now, ctx, transform_score=False)
        if enc is None:
            self._fused_no_node_cycles(pending, now, result, k_waves)
            return
        fc, pods, nodes, ng, ngroups, active = enc
        fc_host = fc  # the pre-upload host arrays feed the wave mirror
        side_fields, assemble_sides, res_ctx = self._encode_wave_sides(
            fc_host, pods, nodes, pending, pending_reservations, active,
            now)
        # ---- the fused dispatch window, wrapped in the degradation
        # ladder: a failure between step lookup and readback (strictly
        # before any binding is replayed) retries once, then demotes — a
        # demotion below fused waves raises FusedDispatchDemoted and the
        # cycle driver re-runs this pass through the serial path.
        # `fc_host`/`side_fields` hold the host arrays, so a retry
        # re-uploads from scratch.
        self.ladder.begin_pass()
        win = self._open_window("fused")
        attempts = 0
        had_deadline = False
        level0 = self.ladder.level
        while True:
            explain = self._effective_explain()
            ex_out = None
            try:
                step = self._get_fused_step(
                    (pods.padded_size, nodes.padded_size,
                     fc_host.quota_runtime.shape[0]),
                    ng, ngroups, active, k_waves, explain=explain,
                    sides_tag=res_ctx["tag"])
                snap = self.device_snapshot
                with self.tracer.span(
                        "kernel",
                        compiled="1" if self._last_step_compiled else "0",
                        waves=str(k_waves),
                        decision_id=win.decision_id) as ksp:
                    fc, sides = self._upload_wave_inputs(
                        fc_host, side_fields, assemble_sides)
                    self._node_rows = (len(nodes.names),
                                       int(fc.base.allocatable.shape[0]))
                    if snap is not None:
                        snap.begin_dispatch()
                    if self._last_step_compiled:
                        self._record_step_compile(
                            "fused",
                            self._step_meta(
                                (pods.padded_size, nodes.padded_size,
                                 fc_host.quota_runtime.shape[0]),
                                ng, ngroups, active, explain,
                                waves=int(k_waves),
                                sides_tag=list(res_ctx["tag"])),
                            (fc, sides, len(nodes.names))
                            if explain is not None else (fc, sides))
                    t_dispatch = time.perf_counter()
                    win.mark_dispatch("fused")
                    try:
                        if self.fault_injector is not None:
                            self.fault_injector("fused")
                        # the step runs every wave to the fixpoint,
                        # reading each wave's count as it goes
                        if explain is not None:
                            out, ex_out = step(fc, sides, len(nodes.names))
                        else:
                            out = step(fc, sides)
                        self.last_backend = (
                            "cuda" if _local(fc.base.allocatable).is_cuda
                            else "serial")
                        self.dispatches += 1
                        compacted = (out.bind_pods, out.bind_nodes,
                                     out.bind_zones, out.bind_res,
                                     out.wave_counts)
                        if self.pipeline_mode:
                            self._flush_deferred_in_window()
                            self._prepack_in_window()
                            with self.tracer.span("overlap_wait"):
                                (bind_pods, bind_nodes, bind_zones,
                                 bind_res, wave_counts) = (
                                     self._readback_sync(*compacted,
                                                         path="fused"))
                        else:
                            with self.tracer.span("readback"):
                                (bind_pods, bind_nodes, bind_zones,
                                 bind_res, wave_counts) = (
                                     self._readback_sync(*compacted,
                                                         path="fused"))
                        waves_run = out.waves_run
                        explain_counts = terms_np = None
                        if ex_out is not None:
                            # the dispatch completed at the sync above
                            with self.tracer.span("readback",
                                                  explain=explain):
                                explain_counts = _host(
                                    ex_out.stage_counts)
                                terms_np = (_host(ex_out.terms)
                                            if ex_out.terms is not None
                                            else None)
                    finally:
                        if snap is not None:
                            snap.end_dispatch()
                    result.device_busy_seconds += (
                        time.perf_counter() - t_dispatch)
                    scheduler_metrics.WAVES_PER_DISPATCH.observe(
                        float(waves_run))
                    scheduler_metrics.READBACK_BYTES.inc(
                        int(bind_pods.nbytes + bind_nodes.nbytes
                            + bind_zones.nbytes + bind_res.nbytes
                            + wave_counts.nbytes))
                    if explain_counts is not None:
                        ex_bytes = explain_counts.nbytes
                        if terms_np is not None:
                            ex_bytes += terms_np.nbytes
                            kept_mask = np.zeros(len(pods.keys), bool)
                            # nominated rows (res >= 0) carry no term
                            # rows — the serial twin's pre-pass binds
                            # never reach the kernel's attribution
                            kept_mask[bind_pods[(bind_pods >= 0)
                                                & (bind_res < 0)]] = True
                            self._stash_terms(pods.keys, kept_mask,
                                              terms_np)
                        scheduler_metrics.EXPLAIN_READBACK_BYTES.inc(
                            int(ex_bytes))
                    for w in range(waves_run):
                        # retrospective per-wave markers under the kernel
                        # span: how the dispatch's work split across the
                        # fused rounds
                        with self.tracer.span(
                                "wave", index=str(w),
                                bound=str(int(wave_counts[w]))):
                            pass
                break
            except Exception as exc:
                self._window_failure("fused", exc)
                attempts += 1
                had_deadline |= isinstance(exc, DispatchDeadlineExceeded)
        result.kernel_seconds += ksp.duration_seconds
        scheduler_metrics.KERNEL_SECONDS.observe(ksp.duration_seconds)
        if self._last_step_compiled:
            self._add_compile_wall(ksp.duration_seconds)
        self._close_window(win, attempts, had_deadline, level0)

        # ---- replay the waves as logical cycles. The state mirror is
        # LAZY: it only exists to diagnose unbound pods against wave-w
        # state, so the happy path never pays the array copies or the
        # per-binding numpy replay — typed mirror ops accumulate in a
        # backlog that the first diagnosable wave replays in order.
        mirror: Optional[_WaveStateMirror] = None
        mirror_backlog: List[Tuple] = []

        def mirror_apply(ops) -> None:
            if mirror is None:
                mirror_backlog.extend(ops)
            else:
                for op in ops:
                    _apply_mirror_op(mirror, op)

        def mirror_state() -> _WaveStateMirror:
            nonlocal mirror
            if mirror is None:
                mirror = self._new_wave_mirror(fc_host, res_ctx)
                for op in mirror_backlog:
                    _apply_mirror_op(mirror, op)
                mirror_backlog.clear()
            return mirror

        index = {key: j for j, key in enumerate(pods.keys)}
        by_key = {p.meta.key: p for p in pending}
        keys = pods.keys
        bound_mask = np.zeros(len(keys), bool)
        gang_plugin = self.extender.plugin("Coscheduling")
        pos = 0
        pending_succ: List[Tuple] = []
        for w in range(k_waves):
            n_w = int(wave_counts[w]) if w < waves_run else 0
            seg_rows = list(zip(bind_pods[pos:pos + n_w].tolist(),
                                bind_nodes[pos:pos + n_w].tolist(),
                                bind_zones[pos:pos + n_w].tolist(),
                                bind_res[pos:pos + n_w].tolist()))
            pos += n_w
            rejected_pods: List[Pod] = []
            failed_pods: List[Tuple[Pod, str]] = []
            kernel_ops: List[Tuple] = []
            # the reconcile's Succeeded transition from the previous
            # wave's allocate-once consumption applies at this wave's
            # start — before any of this wave's binds touch the mirror
            if explain_counts is None and pending_succ:
                mirror_apply(pending_succ)
            pending_succ = []
            with self.tracer.span("bind", wave=str(w)) as bsp:
                bound_before = len(result.bound)
                # nominated binds first (the serial pre-pass position)
                (veto, nom_bound, nom_failed, nom_ops,
                 pending_succ) = self._replay_nominated_binds(
                    seg_rows, lambda row: by_key[keys[row]], nodes,
                    res_ctx, ctx, result, failed_pods)
                for row in nom_bound:
                    bound_mask[row] = True
                nominated = nom_bound | nom_failed
                if explain_counts is None and nom_ops:
                    # nominations are pre-pass state: serial cycle w
                    # packed its batch AFTER them, so this wave's
                    # diagnosis state includes them
                    mirror_apply(nom_ops)
                bind_of = {row: (node_idx, zone)
                           for row, node_idx, zone, slot in seg_rows
                           if slot < 0}
                # one walk in packed (queue) order, the serial bind-loop
                # contract: bind-or-classify each still-pending pod
                for i, key in enumerate(keys):
                    if bound_mask[i] or i in nominated:
                        continue  # bound earlier, or handled above
                    pod = by_key[key]
                    ent = bind_of.get(i)
                    if ent is not None:
                        node_idx, zone = ent
                        reservation = pending_reservations.get(key)
                        err = self._reserve_and_bind(
                            pod, nodes.names[node_idx], ctx, result,
                            reservation_cr=reservation)
                        if err:
                            failed_pods.append((pod, err))
                            veto = True
                        else:
                            bound_mask[i] = True
                            if reservation is not None:
                                kernel_ops.append(
                                    ("res",
                                     int(res_ctx["res_slot_of"][key]),
                                     node_idx))
                            else:
                                kernel_ops.append(("pod", i, node_idx,
                                                   zone))
                        continue
                    reason = pods.unschedulable_reasons.get(i)
                    if reason is not None:
                        failed_pods.append((pod, reason))
                    elif pod.gang_name or pod.quota_name:
                        rejected_pods.append(pod)
                    else:
                        failed_pods.append((pod, "no feasible node"))
                bsp.attributes["bound"] = str(
                    len(result.bound) - bound_before)
            # diagnosis for THIS logical cycle reads wave-w-START state
            # (serial cycle w packed its batch before its kernel ran); the
            # mirror still holds it — advance happens below. With the
            # dispatch's counts the mirror is bypassed entirely: every
            # wave was attributed at its wave-start state
            if any(r in DIAGNOSED_REASONS for _p, r in failed_pods) or (
                    rejected_pods):
                if explain_counts is not None:
                    # waves >= waves_run reuse the last EXECUTED wave's
                    # row: a zero-commit early exit proves the state (and
                    # hence the counts) is a fixpoint
                    counts_w = explain_counts[min(w, waves_run - 1)]
                    self._last_batch = (None, index, len(nodes.names),
                                        counts_w)
                else:
                    self._last_batch = (mirror_state().patched_fc(), index,
                                        len(nodes.names), None)
            truncate = veto
            any_victims = self._post_filter_preempt(
                rejected_pods, failed_pods, result)
            if any_victims:
                # serial cycle w's in-cycle kernel rerun after evictions:
                # a fresh SINGLE-round pass over the still-unbound pods
                # (the device's later waves assumed no evictions — drop
                # them and let the next cycle continue the budget)
                retry = self.extender.transform_before_prefilter(
                    [
                        originals.get(p.meta.key, p)
                        for p in rejected_pods
                        + [p for p, _ in failed_pods]
                    ],
                    ctx,
                )
                rejected_pods, failed_pods = self._batch_pass(
                    retry, now, ctx, result, pending_reservations
                )
                truncate = True
            for b in result.bound:
                self._preempt_attempted.pop(b.pod_key, None)
            for pod in rejected_pods:
                result.rejected.append(pod.meta.key)
                self.extender.error_handlers.dispatch(
                    pod, "admission rejected")
            for pod, reason in failed_pods:
                result.failed.append(pod.meta.key)
                self.extender.error_handlers.dispatch(pod, reason)
            self._write_unschedulable_conditions(
                rejected_pods, failed_pods, now)
            result.waves += 1
            if gang_plugin is not None:
                gang_plugin.update_pod_group_status(self.store, now)
            if truncate:
                break
            # advance the mirror with the device's view of this wave's
            # commits + the wave-boundary claim rebuild, so the next
            # logical cycle diagnoses against the state serial cycle w+1
            # would have packed (the dispatch's counts make the mirror
            # unnecessary: each wave carries its own attribution)
            if explain_counts is None:
                mirror_apply(kernel_ops + [("wave_end",)])
        self._last_batch = None

    # ------------------------------------------------------------------
    # overlapped wave replay (KOORD_TPU_REPLAY_OVERLAP, the default)
    # ------------------------------------------------------------------
    def _initial_chain_carry(self, fc, sides, explain=None):
        """Wave-0 carried state for the chained dispatch, from the same
        device-resident arrays the single-call step starts from; under a
        mesh the node-axis slots stay the uploaded shards and the rest
        replicate (parallel/full_chain_mesh.wave_carry_shardings)."""
        if self.mesh is not None:
            from koordinator_tpu_torch.parallel.full_chain_mesh import (
                initial_sharded_wave_carry,
            )

            return initial_sharded_wave_carry(fc, sides, self.mesh,
                                              explain=explain)
        return initial_wave_carry(fc, sides, explain=explain)

    def _dispatch_chain_wave(self, step, fc, carry, sides, n_real=None,
                             explain=None):
        """Dispatch ONE chained wave. Returns (next carry, handle), with
        nothing synced: on the card the wave's rows (pods, nodes, zones,
        reservation slots, count, and under explain the wave's [P, 11]
        stage counts: one int32 vector) are queued for copy into pinned
        host memory right behind the wave's launches, and an event
        recorded after the copy, so that ``_sync_wave_rows`` waits for
        this wave and no later one. A second event, recorded before the
        wave's first launch, times the wave on the device."""
        import torch

        start = None
        if _local(fc.base.allocatable).is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        parts = []
        if explain is not None:
            carry, rows, counts_row = step(fc, carry, sides, n_real)
            parts = [_local(counts_row).view(torch.int32).reshape(-1)]
        else:
            carry, rows = step(fc, carry, sides)
        # under a mesh the rows come back replicated: one replica is read
        # (the per-shard accounting of the chained path's readback rides
        # the fused path's merge)
        rows = type(rows)(*(_local(t) for t in rows))
        packed = torch.cat([*rows[:4], rows.count.reshape(1), *parts])
        n_counts = int(parts[0].numel()) if parts else 0
        if start is None:
            return carry, (packed, None, None, None, n_counts)
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        return carry, (host, start, done, packed.device, n_counts)

    def _sync_wave_rows(self, handle, monitored: bool = True):
        """Materialize one wave's compacted readback — the per-wave
        designated sync point of the overlapped replay. Returns host
        arrays (pods, nodes, zones, res, count, device ms or None, the
        wave's [P, 11] uint32 stage counts or None).

        ``monitored=False`` (the replay phase, wave >= 2) runs the sync
        INLINE, outside the deadline watchdog: those syncs happen after
        binds applied, where a DispatchDeadlineExceeded could only escape
        as a cycle exception; the deadline window is wave 1's readback."""
        host, start, done, device, n_counts = handle

        def body():
            import torch

            if self.sync_delay_injector is not None:
                self.sync_delay_injector()
            if done is not None:
                # a watchdog worker thread starts on device 0
                torch.cuda.set_device(device)
                done.synchronize()
            return host.numpy()

        arr = (self.dispatch_watchdog.run(body, "fused") if monitored
               else body())
        P = (arr.shape[0] - 1 - n_counts) // 4
        scheduler_metrics.READBACK_BYTES.inc(int((4 * P + 1) * 4))
        rows = arr[:4 * P].reshape(4, P)
        counts = None
        if n_counts:
            counts = arr[4 * P + 1:].view(np.uint32).reshape(P, -1)
            scheduler_metrics.EXPLAIN_READBACK_BYTES.inc(int(counts.nbytes))
        device_ms = start.elapsed_time(done) if done is not None else None
        return (rows[0], rows[1], rows[2], rows[3], int(arr[4 * P]),
                device_ms, counts)

    def _drain_abandoned_wave(self, handle) -> None:
        """A truncation (Reserve veto, preemption retry) dropped a
        dispatched-but-unconsumed wave: wait for it before the dispatch
        window closes, so the mirror never scatters in place into a
        tensor the wave still reads. A deliberate wait for a result we
        discard: the wave's event, nothing later on the stream."""
        done = handle[2]
        if done is not None:
            done.synchronize()

    def _keep_abandoned_wave(self, handle) -> None:
        """A deadline overrun abandoned a chained wave still running on
        the card: keep its pinned host rows and events referenced until
        its event completes (pruned here, on the next abandon), so no
        copy lands in memory that was handed back."""
        self._abandoned_waves = [h for h in self._abandoned_waves
                                 if not h[2].query()]
        if handle is not None and handle[2] is not None:
            self._abandoned_waves.append(handle)

    def _abort_chain_window(self, handle, window_open: bool) -> None:
        """Tear down the chain dispatch window on a host-side failure:
        wave 1 may still be executing, and end_dispatch must not let the
        mirror scatter in place while it reads the tensors."""
        if handle is not None:
            try:
                self._drain_abandoned_wave(handle)
            except Exception:
                # the wave itself wrecked: the ORIGINAL failure is the
                # evidence being raised
                logger.exception("abandoned chain wave failed while "
                                 "draining")
        if window_open:
            self.device_snapshot.end_dispatch()

    def _fused_wave_dispatch_overlap(
        self,
        pending: List[Pod],
        now: float,
        ctx: CycleContext,
        result: CycleResult,
        pending_reservations: Dict[str, Reservation],
        originals: Dict[str, Pod],
        k_waves: int,
    ) -> None:
        """The overlapped-replay fused dispatch: K waves as a CHAIN of
        one-wave dispatches (models/fused_waves.py build_chained_wave_step
        — one step serves every K), with wave w+1 dispatched BEFORE wave
        w's rows are read back, so the host-side replay of logical cycle w
        — bind/classify over the still-pending slice, PostFilter
        preemption, condition-write capture — runs while the device
        executes wave w+1. Outcomes are byte-identical to the single-call
        twin (replay_overlap=False) and to K serial cycles."""
        result.waves = 0
        enc = self._encode_batch(pending, now, ctx, transform_score=False)
        if enc is None:
            self._fused_no_node_cycles(pending, now, result, k_waves)
            return
        fc, pods, nodes, ng, ngroups, active = enc
        fc_host = fc  # the pre-upload host arrays feed the wave mirror
        side_fields, assemble_sides, res_ctx = self._encode_wave_sides(
            fc_host, pods, nodes, pending, pending_reservations, active,
            now)
        # ---- ladder-wrapped dispatch window: step lookup, upload, the
        # wave-1 dispatch and its readback — strictly before any binding
        self.ladder.begin_pass()
        win = self._open_window("chained")
        attempts = 0
        had_deadline = False
        level0 = self.ladder.level
        window_open = False
        handle0 = None  # wave 1 in flight: drained before the window closes
        n_real = len(nodes.names)
        while True:
            explain = self._effective_explain()
            try:
                step = self._get_chain_step(
                    (pods.padded_size, nodes.padded_size,
                     fc_host.quota_runtime.shape[0]),
                    ng, ngroups, active, explain=explain,
                    sides_tag=res_ctx["tag"])
                with self.tracer.span(
                        "kernel",
                        compiled="1" if self._last_step_compiled else "0",
                        waves=str(k_waves), overlap="1",
                        decision_id=win.decision_id):
                    fc, sides = self._upload_wave_inputs(
                        fc_host, side_fields, assemble_sides)
                    if self.device_snapshot is not None:
                        self.device_snapshot.begin_dispatch()
                        window_open = True
                    chain_compiled = self._last_step_compiled
                    t_dispatch = time.perf_counter()
                    win.mark_dispatch("chained")
                    if self.fault_injector is not None:
                        self.fault_injector("fused")
                    carry = self._initial_chain_carry(fc, sides, explain)
                    if chain_compiled:
                        self._record_step_compile(
                            "chain",
                            self._step_meta(
                                (pods.padded_size, nodes.padded_size,
                                 fc_host.quota_runtime.shape[0]),
                                ng, ngroups, active, explain,
                                sides_tag=list(res_ctx["tag"])),
                            (fc, carry, sides, n_real)
                            if explain is not None
                            else (fc, carry, sides))
                    carry, handle0 = self._dispatch_chain_wave(
                        step, fc, carry, sides, n_real, explain)
                    self.last_backend = (
                        "cuda" if _local(fc.base.allocatable).is_cuda
                        else "serial")
                    self.dispatches += 1
                    if self.pipeline_mode:
                        # the previous cycle's deferred host work drains
                        # while the device runs wave 1
                        self._flush_deferred_in_window()
                    # pack overlap: wave 1 is in flight — pre-pack the next
                    # cycle's rows before blocking on it
                    self._prepack_in_window()
                    with self.tracer.span("overlap_wait"):
                        synced = self._sync_wave_rows(handle0)
                break
            except Exception as exc:
                if isinstance(exc, DispatchDeadlineExceeded):
                    # the slow wave is exactly what we are escaping: never
                    # drain it here (that blocks as long as the overrun).
                    # The old mirror is replaced in _on_dispatch_failure,
                    # and the wave's pinned rows and events are kept
                    # until it ends.
                    self._keep_abandoned_wave(handle0)
                else:
                    self._abort_chain_window(handle0, window_open)
                handle0, window_open = None, False
                self._window_failure("fused", exc)
                attempts += 1
                had_deadline |= isinstance(exc, DispatchDeadlineExceeded)
        try:
            executed, t_last_sync = self._replay_wave_chain(
                step, fc, fc_host, carry, sides, res_ctx, synced,
                n_real, pods, nodes, pending, now, ctx, result,
                pending_reservations, originals, k_waves, explain)
        finally:
            if window_open:
                self.device_snapshot.end_dispatch()
        # kernel time = the CHAIN's dispatch->last-sync window, the same
        # quantity the single-call twin's kernel span measures
        window_seconds = t_last_sync - t_dispatch
        result.kernel_seconds += window_seconds
        scheduler_metrics.KERNEL_SECONDS.observe(window_seconds)
        if chain_compiled:
            self._add_compile_wall(window_seconds)
        result.device_busy_seconds += window_seconds
        scheduler_metrics.WAVES_PER_DISPATCH.observe(float(executed))
        # the timeline window closes at the chain's LAST device sync
        self._close_window(win, attempts, had_deadline, level0,
                           end_mono=t_last_sync)
        self._last_batch = None

    def _replay_wave_chain(
        self,
        step,
        fc,
        fc_host,
        carry,
        sides,
        res_ctx,
        synced,
        n_real: int,
        pods,
        nodes,
        pending: List[Pod],
        now: float,
        ctx: CycleContext,
        result: CycleResult,
        pending_reservations: Dict[str, Reservation],
        originals: Dict[str, Pod],
        k_waves: int,
        explain=None,
    ) -> Tuple[int, float]:
        """Consume the wave chain: one logical cycle per wave, the replay
        of wave w overlapping device execution of wave w+1. Returns (wave
        bodies consumed device-side, clock of the last device sync).

        Packed-order work is amortized per DISPATCH: the classification
        of every pod (encoding-overflow reason, gang/quota membership,
        plain no-fit) is static for the dispatch, so each wave walks only
        the still-pending slice, and a fixpoint repeat — a wave the device
        did not run, re-verdicting the same pods at the same wave-start
        state — reuses the previous wave's lists. Store writes: the wave's
        bind patches land as ONE update_many transaction before
        preemption or gang status reads the store (span ``store_flush``);
        condition writes queue on the deferred machinery with
        byte-identical repeats deduped."""
        keys = pods.keys
        by_key = {p.meta.key: p for p in pending}
        index = {key: j for j, key in enumerate(keys)}
        # per-dispatch precompute: the static (pod, verdict) partition
        _REJECT = object()
        pending_rows: List[Tuple[int, Pod, object]] = []
        for i, key in enumerate(keys):
            pod = by_key[key]
            reason = pods.unschedulable_reasons.get(i)
            if reason is None and (pod.gang_name or pod.quota_name):
                pending_rows.append((i, pod, _REJECT))
            else:
                pending_rows.append(
                    (i, pod, reason or "no feasible node"))
        gang_plugin = self.extender.plugin("Coscheduling")

        mirror: Optional[_WaveStateMirror] = None
        mirror_backlog: List[Tuple] = []

        def mirror_apply(ops) -> None:
            if mirror is None:
                mirror_backlog.extend(ops)
            else:
                for op in ops:
                    _apply_mirror_op(mirror, op)

        def mirror_state() -> _WaveStateMirror:
            nonlocal mirror
            if mirror is None:
                mirror = self._new_wave_mirror(fc_host, res_ctx)
                for op in mirror_backlog:
                    _apply_mirror_op(mirror, op)
                mirror_backlog.clear()
            return mirror

        executed = 1           # wave bodies whose readback we consumed
        t_last_sync = time.perf_counter()
        # fixpoint-repeat caches: valid while no wave commits/vetoes and
        # preemption stays victim-less (any of those invalidates)
        reuse_lists = None     # (rejected_pods, failed_pods)
        reuse_attrib = None    # [(pod key, /explain attribution entry)]
        in_flight = None       # handle of wave w+1
        # explain=full bookkeeping mirroring the serial twin's masking:
        # term rows belong to DEVICE-kept pods (the chain's bind rows),
        # and a preemption-retry pass stashes its own kernel's rows for
        # the pods it re-ran — the end-of-chain stash must not clobber
        # those (the serial twin stashes chain rows BEFORE the replay,
        # so its retry stash wins by order)
        device_kept = (np.zeros(len(keys), bool)
                       if explain == "full" else None)
        retried_keys: set = set()
        pending_succ: List[Tuple] = []
        try:
            with self.tracer.span("replay_drain",
                                  waves=str(k_waves)) as dsp:
                for w in range(k_waves):
                    if synced is not None:
                        (pods_w, nodes_w, zones_w, res_w, cnt_w, dev_ms,
                         crow_w) = synced
                        seg_rows = list(zip(pods_w[:cnt_w].tolist(),
                                            nodes_w[:cnt_w].tolist(),
                                            zones_w[:cnt_w].tolist(),
                                            res_w[:cnt_w].tolist()))
                    else:
                        seg_rows, cnt_w, dev_ms, crow_w = [], 0, None, None
                    # one-ahead: launch wave w+1 BEFORE replaying wave w —
                    # the device works through it while the host replays
                    # (a known fixpoint dispatches nothing)
                    if (synced is not None and cnt_w > 0
                            and w + 1 < k_waves):
                        carry, in_flight = self._dispatch_chain_wave(
                            step, fc, carry, sides, n_real, explain)
                    else:
                        in_flight = None
                    if device_kept is not None and cnt_w:
                        # nominated rows (res >= 0) have no term rows —
                        # the serial twin's pre-pass binds never reach
                        # the kernel's attribution either
                        device_kept[[row for row, _n, _z, slot
                                     in seg_rows if slot < 0]] = True
                    replay_out: Dict[str, object] = {
                        "apply_succ": pending_succ}
                    truncate = self._replay_logical_cycle(
                        w, seg_rows, cnt_w, dev_ms, crow_w, pending_rows,
                        mirror_state, mirror_apply, res_ctx, index,
                        n_real, nodes, now, ctx, result,
                        pending_reservations, originals, explain,
                        reuse_lists, reuse_attrib, replay_out)
                    pending_succ = replay_out.get("pending_succ", [])
                    pending_rows = replay_out["pending_rows"]
                    reuse_lists = replay_out["reuse_lists"]
                    reuse_attrib = replay_out["reuse_attrib"]
                    retried_keys.update(replay_out.get("retried_keys",
                                                       ()))
                    result.waves += 1
                    if gang_plugin is not None:
                        gang_plugin.update_pod_group_status(self.store,
                                                            now)
                    if truncate:
                        break
                    # advance the mirror with the device's committed rows
                    # + the wave-boundary claim rebuild, so the next
                    # logical cycle diagnoses at wave-(w+1)-start state
                    # (the dispatch's counts make the mirror unnecessary;
                    # nominated/succeed ops were applied pre-diagnosis
                    # inside the replay)
                    if explain is None:
                        ops = replay_out.get("kernel_mirror_ops", [])
                        if cnt_w or ops:
                            mirror_apply(list(ops) + [("wave_end",)])
                    if in_flight is not None:
                        handle, in_flight = in_flight, None
                        with self.tracer.span("overlap_wait",
                                              wave=str(w + 1)):
                            # post-bind: inline, unmonitored
                            synced = self._sync_wave_rows(
                                handle, monitored=False)
                        t_last_sync = time.perf_counter()
                        executed += 1
                    else:
                        synced = None
                dsp.attributes["cycles"] = str(result.waves)
        finally:
            if in_flight is not None:
                # a truncation (or a replay wreck mid-flight) left wave
                # w+1 dispatched and unread: wait for it before the
                # dispatch window can close behind us. Guarded — a device
                # fault in the DISCARDED wave must not replace the
                # in-flight replay exception during unwind.
                try:
                    self._drain_abandoned_wave(in_flight)
                    executed += 1
                except Exception:
                    logger.exception("abandoned chain wave failed "
                                     "while draining")
                t_last_sync = time.perf_counter()
        if explain == "full":
            # decision-time score terms ride the carried state; the last
            # dispatched wave's carry holds the kept-wave-wins rows. The
            # chain completed at the syncs/drain above — this copy waits
            # for nothing new. The mask is the serial twin's: DEVICE-kept
            # rows (not result.bound — a preemption retry's host rebind
            # has no chain row), minus the pods a retry pass re-ran (its
            # kernel already stashed their rows; in the serial twin that
            # stash comes after the chain's and wins by order).
            terms_np = _host(carry[-1])
            scheduler_metrics.EXPLAIN_READBACK_BYTES.inc(
                int(terms_np.nbytes))
            kept_mask = device_kept
            for key in retried_keys:
                j = index.get(key)
                if j is not None:
                    kept_mask[j] = False
            self._stash_terms(keys, kept_mask, terms_np)
        return executed, t_last_sync

    def _replay_logical_cycle(
        self,
        w: int,
        seg_rows,
        cnt_w: int,
        device_ms,
        crow_w,
        pending_rows,
        mirror_state,
        mirror_apply,
        res_ctx,
        index,
        n_real: int,
        nodes,
        now: float,
        ctx: CycleContext,
        result: CycleResult,
        pending_reservations: Dict[str, Reservation],
        originals: Dict[str, Pod],
        explain,
        reuse_lists,
        reuse_attrib,
        out: dict,
    ) -> bool:
        """Replay ONE logical cycle of the overlapped chain (nominated
        via-reservation binds first — the serial pre-pass position — then
        bind/classify in packed order, PostFilter preemption, failure
        records, condition capture). Returns whether the dispatch
        truncates; the updated pending slice, the fixpoint-reuse cache,
        the kernel mirror ops and the delayed Succeeded transitions ride
        ``out``. A pending row's verdict is a string (the static failure
        reason) or the chain's reject sentinel (any non-string: gang/quota
        admission rejection). ``device_ms`` (the wave's time on the card,
        CUDA events) is stamped on the wave's span; ``crow_w`` is the
        wave's stage counts under explain (None otherwise), which replace
        the host mirror for the wave's diagnosis."""
        rejected_pods: List[Pod] = []
        failed_pods: List[Tuple[Pod, str]] = []
        kernel_ops: List[Tuple] = []
        veto = False
        fresh = True
        txn: List[tuple] = []  # (patched, live pod, annotations, node)
        with self.tracer.span("wave_replay", index=str(w)) as wsp:
            if device_ms is not None:
                wsp.attributes["device_ms"] = repr(device_ms)
            bound_before = len(result.bound)
            # the previous wave's allocate-once consumption lands its
            # Succeeded transition at THIS wave's start (pass 0a)
            if explain is None and out.get("apply_succ"):
                mirror_apply(out["apply_succ"])
            if cnt_w == 0 and reuse_lists is not None:
                # fixpoint repeat: same pending slice, same wave-start
                # state — the previous wave's partition IS this wave's
                rejected_pods, failed_pods = reuse_lists
                fresh = False
            else:
                pod_of_row = {i: pod for i, pod, _v in pending_rows}
                bound_mask: Dict[int, bool] = {}
                nom_failed: set = set()
                if any(slot >= 0 for _i, _n, _z, slot in seg_rows):
                    (nveto, nom_bound, nom_failed, nom_ops,
                     succ_ops) = self._replay_nominated_binds(
                        seg_rows, pod_of_row.__getitem__, nodes,
                        res_ctx, ctx, result, failed_pods, txn=txn)
                    veto |= nveto
                    for row in nom_bound:
                        bound_mask[row] = True
                    if explain is None and nom_ops:
                        mirror_apply(nom_ops)
                    if succ_ops:
                        out.setdefault("pending_succ", []).extend(
                            succ_ops)
                bind_of = {row: (node_idx, zone)
                           for row, node_idx, zone, slot in seg_rows
                           if slot < 0}
                still: List[Tuple[int, Pod, object]] = []
                for ent in pending_rows:
                    i, pod, verdict = ent
                    if bound_mask.get(i):
                        continue  # nominated above: bound, not pending
                    if i in nom_failed:
                        still.append(ent)  # veto: stays pending
                        continue
                    bnd = bind_of.get(i) if cnt_w else None
                    if bnd is not None:
                        node_idx, zone = bnd
                        key = pod.meta.key
                        reservation = pending_reservations.get(key)
                        err = self._reserve_and_bind(
                            pod, nodes.names[node_idx], ctx, result,
                            reservation_cr=reservation, txn=txn)
                        if err:
                            failed_pods.append((pod, err))
                            veto = True
                            still.append(ent)
                        elif reservation is not None:
                            kernel_ops.append(
                                ("res", int(res_ctx["res_slot_of"][key]),
                                 node_idx))
                        else:
                            kernel_ops.append(("pod", i, node_idx, zone))
                        continue
                    still.append(ent)
                    if isinstance(verdict, str):
                        failed_pods.append((pod, verdict))
                    else:
                        rejected_pods.append(pod)
                pending_rows = still
            if txn:
                with self.tracer.span("store_flush",
                                      writes=str(len(txn))):
                    # the wave's bind patches: ONE store transaction,
                    # applied before preemption/gang status reads; the
                    # live queue objects turn coherent right after, as the
                    # serial per-pod write would have left them.
                    # THE designated batched flush site of the replay
                    # koordlint: disable=store-write-in-wave-replay-loop
                    self.store.update_many(KIND_POD, [t[0] for t in txn])
                for _patched, live, annotations, node_name in txn:
                    live.meta.annotations.update(annotations)
                    live.spec.node_name = node_name

            if fresh and (rejected_pods or any(
                    r in DIAGNOSED_REASONS for _p, r in failed_pods)):
                if explain is not None:
                    self._last_batch = (None, index, n_real, crow_w)
                else:
                    self._last_batch = (mirror_state().patched_fc(), index,
                                        n_real, None)
            truncate = veto
            any_victims = self._post_filter_preempt(
                rejected_pods, failed_pods, result)
            if any_victims:
                retry = self.extender.transform_before_prefilter(
                    [
                        originals.get(p.meta.key, p)
                        for p in rejected_pods
                        + [p for p, _ in failed_pods]
                    ],
                    ctx,
                )
                rejected_pods, failed_pods = self._batch_pass(
                    retry, now, ctx, result, pending_reservations
                )
                out["retried_keys"] = [p.meta.key for p in retry]
                truncate = True
                fresh = True
            for b in result.bound[bound_before:]:
                self._preempt_attempted.pop(b.pod_key, None)
            for pod in rejected_pods:
                result.rejected.append(pod.meta.key)
                self.extender.error_handlers.dispatch(
                    pod, "admission rejected")
            for pod, reason in failed_pods:
                result.failed.append(pod.meta.key)
                self.extender.error_handlers.dispatch(pod, reason)
            if fresh:
                self._write_unschedulable_conditions(
                    rejected_pods, failed_pods, now)
            elif reuse_attrib:
                # the repeat's attribution is per logical cycle, exactly
                # like K serial cycles — re-apply the cached entries and
                # stage counters; the byte-identical deferred store
                # write is deduped (its flush was a proven no-op)
                for key, entry in reuse_attrib:
                    self._cycle_attrib[key] = entry
                    for stage_key, c in entry.get("stages", {}).items():
                        scheduler_metrics.FILTER_REJECTIONS.inc(
                            c, stage=stage_key)
            # set LAST so a preemption-retry pass's rebinds count toward
            # this logical cycle's replay span, as they are bound in it
            wsp.attributes["bound"] = str(len(result.bound) - bound_before)
        reuse_ok = cnt_w == 0 and not veto and not any_victims
        if reuse_ok and fresh:
            reuse_lists = (rejected_pods, failed_pods)
            if self.explain_spec is not None:
                reuse_attrib = [
                    (p.meta.key, self._cycle_attrib[p.meta.key])
                    for p in rejected_pods + [fp for fp, _r in failed_pods]
                    if p.meta.key in self._cycle_attrib
                ]
            else:
                reuse_attrib = None
        elif not reuse_ok:
            reuse_lists = None
            reuse_attrib = None
        out["pending_rows"] = pending_rows
        out["reuse_lists"] = reuse_lists
        out["reuse_attrib"] = reuse_attrib
        out["kernel_mirror_ops"] = kernel_ops
        return truncate

    # ------------------------------------------------------------------
    def _reserve_and_bind(
        self,
        pod: Pod,
        node_name: str,
        ctx: CycleContext,
        result: CycleResult,
        via_reservation: Optional[Reservation] = None,
        reservation_cr: Optional[Reservation] = None,
        txn: Optional[list] = None,
    ) -> Optional[str]:
        """Reserve hooks -> PreBind -> Bind; returns error to leave pod
        pending. ``txn`` (overlapped wave replay) collects the bind's
        store patch instead of writing it immediately — the wave flushes
        the whole batch as one store transaction before anything
        (preemption dry-runs, gang status) reads the store."""
        if reservation_cr is not None:
            # binding a Reservation CR itself: no plugin reserve (it only holds
            # capacity), just set status (reservation plugin Bind, plugin.go:596).
            # Allocatable comes from the CR's own template, NOT the pseudo-pod,
            # which may be a cycle-local transformer view that must not persist
            reservation_cr.node_name = node_name
            reservation_cr.phase = "Available"
            reservation_cr.allocatable = reservation_cr.template.requests.copy()
            self.store.update(KIND_RESERVATION, reservation_cr)
            result.bound.append(
                BindResult(RESERVATION_POD_PREFIX + reservation_cr.meta.name,
                           node_name)
            )
            return None

        with self.tracer.span("bind_pod", pod=pod.meta.key,
                              node=node_name) as psp:
            with self.tracer.span("reserve"):
                done: List = []
                for plugin in self.extender.plugins:
                    err = plugin.reserve(pod, node_name, ctx)
                    if err:
                        for p in reversed(done):
                            p.unreserve(pod, node_name, ctx)
                        psp.attributes["veto"] = plugin.name
                        return f"{plugin.name}: {err}"
                    done.append(plugin)
                if via_reservation is not None:
                    res_plugin = self.extender.plugin("Reservation")
                    res_plugin.consume(pod, via_reservation, ctx)

            with self.tracer.span("prebind"):
                annotations: Dict[str, str] = {}
                for plugin in self.extender.plugins:
                    plugin.pre_bind(pod, node_name, ctx, annotations)
                prebind = self.extender.plugin("DefaultPreBind")
                prebind.apply_patch(pod, node_name, annotations, now=ctx.now,
                                    txn=txn)
        result.bound.append(BindResult(pod.meta.key, node_name, annotations))
        return None


# ---------------------------------------------------------------------------
# pipelined cycle driver
# ---------------------------------------------------------------------------

def pipeline_enabled_from_env() -> bool:
    """KOORD_TPU_PIPELINE=0 restores the strictly serial cycle."""
    return os.environ.get("KOORD_TPU_PIPELINE", "1") != "0"


class CyclePipeline:
    """Pipelined cycle driver: overlap host work with device execution.

    Wraps a Scheduler for a STREAM of cycles (the input-pipeline shape from
    the training world — keep the accelerator fed). Three hand-off points
    change relative to the serial path, none of which changes results:

      1. the kernel dispatch is non-blocking — no ``.cpu()`` readback
         until the bind loop actually needs the chosen vector;
      2. unschedulability diagnosis + PodScheduled condition writes for
         cycle N run inside cycle N+1's kernel window (``flush_deferred``),
         while the device executes — content is captured at cycle N (same
         packed batch, same ``now``), so the writes are byte-identical;
      3. ``flush()`` drains whatever the last cycle deferred.

    Bind order, CRD writes and unschedulable conditions end up byte-for-
    byte what the serial path produces (tests/test_torch_cycle.py runs
    both paths against the JAX package's and diffs the store).
    ``KOORD_TPU_PIPELINE=0`` (or ``enabled=False``) falls back to the
    serial single-threaded path exactly.
    """

    def __init__(self, scheduler: Scheduler,
                 enabled: Optional[bool] = None) -> None:
        self.scheduler = scheduler
        self.enabled = (pipeline_enabled_from_env()
                        if enabled is None else bool(enabled))
        scheduler.pipeline_mode = self.enabled

    def run_cycle(self, now: Optional[float] = None,
                  waves=None) -> CycleResult:
        return self.scheduler.run_cycle(now=now, waves=waves)

    def flush(self) -> None:
        """Drain deferred condition writes (call at end of stream)."""
        self.scheduler.flush_deferred()

    def __enter__(self) -> "CyclePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()
