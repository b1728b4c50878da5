"""LowNodeLoad: utilization-based rebalancing.

Analog of reference `pkg/descheduler/framework/plugins/loadaware/low_node_load.go`
+ `utilization_util.go`: classify nodes by MEASURED utilization (NodeMetric CR)
into low (below lowThresholds on every resource) and high (above highThresholds
on any); evict movable pods from high nodes while capacity remains on low nodes.

Two engines over one packed view (balance/pack.RebalancePack — the
event-maintained arrays, shared with the scheduler's SnapshotCache when
both run in one process):

  * ``select_victims_host`` — the host numpy oracle: one stable lexsort
    + per-segment freed-prefix math. It is the plain version the device
    pass is held against, and the ladder's host rung.
  * the device pass (balance/step.py via an attached
    :class:`~koordinator_tpu_torch.balance.rebalancer.DeviceRebalancer`)
    — the same classification + selection as one batched tensor pass on
    the device mirror, decision-parity gated by
    ``pipeline_parity.run_rebalance_parity``, with the degradation ladder
    falling back to the host oracle on device faults.

`KOORD_TPU_REBALANCE=on|off|host` picks the engine at the Descheduler
level (descheduler/descheduler.py wires the rebalancer in); a bare
``LowNodeLoad(store)`` stays pure host. Its ``device=`` argument is the
JAX package's name for an attached DeviceRebalancer, not a torch
device: the torch device is the rebalancer's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.api.objects import Node, NodeMetric, Pod, PodMigrationJob, ObjectMeta
from koordinator_tpu_torch.api.resources import (
    NUM_RESOURCES,
    RESOURCE_INDEX,
    ResourceName,
)
from koordinator_tpu_torch.balance.pack import RebalancePack, has_pdb_like_guard
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    KIND_POD_MIGRATION_JOB,
    ObjectStore,
)
from koordinator_tpu_torch.obs import Tracer

CPU = RESOURCE_INDEX[ResourceName.CPU]
MEM = RESOURCE_INDEX[ResourceName.MEMORY]


@dataclass
class LowNodeLoadArgs:
    low_thresholds: Dict[str, float] = field(
        default_factory=lambda: {ResourceName.CPU: 45.0, ResourceName.MEMORY: 55.0}
    )
    high_thresholds: Dict[str, float] = field(
        default_factory=lambda: {ResourceName.CPU: 70.0, ResourceName.MEMORY: 80.0}
    )
    max_pods_to_evict_per_node: int = 5
    node_metric_expiration_seconds: float = 300.0


def classify_nodes(
    usage_percent: np.ndarray,   # [N, R] measured utilization percent
    has_metric: np.ndarray,      # [N]
    low_thr: np.ndarray,         # [R] (0 = unchecked)
    high_thr: np.ndarray,        # [R]
) -> Tuple[np.ndarray, np.ndarray]:
    """(is_low[N], is_high[N]) — vectorized utilization_util.go classification."""
    checked = low_thr > 0
    low = np.all(~checked | (usage_percent < low_thr), axis=-1) & has_metric
    checked_h = high_thr > 0
    high = np.any(checked_h & (usage_percent > high_thr), axis=-1) & has_metric
    return low & ~high, high


class LowNodeLoad:
    name = "LowNodeLoad"

    def __init__(self, store: ObjectStore, args: Optional[LowNodeLoadArgs] = None,
                 incremental: bool = True, pack: Optional[RebalancePack] = None,
                 device=None):
        self.store = store
        self.args = args or LowNodeLoadArgs()
        # the packed view: an explicitly shared pack (SnapshotCache
        # deployments — one encode, two consumers) wins; otherwise the
        # per-store singleton, created LAZILY on the first view so the
        # Descheduler can swap the shared pack in post-construction
        # without having orphaned a store-subscribed singleton;
        # incremental=False keeps the cold walk
        self.pack_cache: Optional[RebalancePack] = pack
        self._lazy_pack = incremental and pack is None
        # DeviceRebalancer (balance/rebalancer.py): None = host oracle
        self.device = None
        self.tracer = Tracer()
        self.last_pass_stats: Dict[str, object] = {}
        if device is not None:
            self.attach_device(device)

    def attach_device(self, device) -> None:
        """Wire a DeviceRebalancer in; its tracer becomes the plugin's
        so classify/score/readback land under the ``rebalance`` root."""
        self.device = device
        self.tracer = device.tracer

    def _thr_vec(self, thr: Dict[str, float]) -> np.ndarray:
        v = np.zeros(NUM_RESOURCES, np.float32)
        for name, t in thr.items():
            v[RESOURCE_INDEX[name]] = t
        return v

    def _cold_view(self, now: float):
        """Walk-everything packing (incremental=False path); same array
        contract as RebalancePack.view."""
        nodes: List[Node] = self.store.list(KIND_NODE)
        N = len(nodes)
        alloc = np.zeros((N, NUM_RESOURCES), np.float32)
        usage_pct = np.zeros((N, NUM_RESOURCES), np.float32)
        has_metric = np.zeros(N, bool)
        node_idx = {}
        for i, node in enumerate(nodes):
            node_idx[node.meta.name] = i
            alloc[i] = node.allocatable.to_vector()
            nm: Optional[NodeMetric] = self.store.get(
                KIND_NODE_METRIC, f"/{node.meta.name}")
            if nm is None or nm.update_time <= 0:
                continue
            if now - nm.update_time >= self.args.node_metric_expiration_seconds:
                continue
            usage = nm.node_metric.node_usage.to_vector()
            a = alloc[i]
            with np.errstate(divide="ignore", invalid="ignore"):
                usage_pct[i] = np.where(
                    a > 0, usage * 100.0 / np.maximum(a, 1e-9), 0.0)
            has_metric[i] = True
        pods = [p for p in self.store.list(KIND_POD)
                if p.is_assigned and not p.is_terminated]
        return {
            "alloc": alloc,
            "usage_pct": usage_pct,
            "has_metric": has_metric,
            "pod_alive": np.ones(len(pods), bool),
            "pod_node": np.asarray(
                [node_idx.get(p.spec.node_name, -1) for p in pods],
                np.int64),
            "pod_prio": np.asarray(
                [p.spec.priority or 0 for p in pods], np.int64),
            "pod_cpu": np.asarray(
                [p.spec.requests[ResourceName.CPU] for p in pods],
                np.float32),
            "pod_req": (np.stack([p.spec.requests.to_vector() for p in pods])
                        if pods else np.zeros((0, NUM_RESOURCES), np.float32)),
            "pod_movable": np.asarray(
                [p.meta.owner_kind != "DaemonSet"
                 and not has_pdb_like_guard(p) for p in pods], bool),
        }, pods

    def _view(self, now: float):
        if self.pack_cache is None and self._lazy_pack:
            self.pack_cache = RebalancePack.for_store(
                self.store, self.args.node_metric_expiration_seconds)
        if self.pack_cache is not None:
            return self.pack_cache.view(now), self.pack_cache.pod_ref
        v, pods_cold = self._cold_view(now)
        return v, pods_cold

    def select_victims(self, now: Optional[float] = None):
        """The TIMED rebalance pass: pure array math on the packed view.
        Returns (picked slot indices, slot->Pod source, view) — victim
        materialization, PodMigrationJob construction and store writes all
        happen in balance(), outside this pass, exactly as the reference's
        job creation is API-server work outside utilization_util.go's
        math (and the C++ floor's output is victim flags, not objects).
        With a DeviceRebalancer attached the pass runs on device
        (decision-identical; ladder falls back to the host oracle)."""
        now = time.time() if now is None else now
        v, pods_src = self._view(now)
        if v["alloc"].shape[0] == 0:
            self.last_pass_stats = {"engine": "host", "candidates": 0,
                                    "victims": 0}
            return np.zeros(0, np.int64), pods_src, v
        if self.device is not None:
            picked, stats = self.device.select_victims(self, v, now)
            self.last_pass_stats = stats
            return picked, pods_src, v
        t0 = time.perf_counter()
        with self.tracer.span("score", host="1"):
            picked = self.select_victims_host(v)
        from koordinator_tpu_torch.descheduler import metrics as dm

        dm.REBALANCE_PASS_SECONDS.observe(time.perf_counter() - t0)
        cands = int(self.last_pass_stats.get("candidates", 0))
        if cands:
            dm.REBALANCE_CANDIDATES.inc(cands)
        if picked.size:
            dm.REBALANCE_VICTIMS.inc(int(picked.size))
        return picked, pods_src, v

    def select_victims_host(self, v: dict) -> np.ndarray:
        """The host numpy oracle over a packed view: classification +
        the vectorized greedy victim selection. The device pass's
        decision reference (see module doc); also sets
        ``last_pass_stats``."""
        empty = np.zeros(0, np.int64)
        self.last_pass_stats = {"engine": "host", "candidates": 0,
                                "victims": 0}
        if v["alloc"].shape[0] == 0:
            return empty
        is_low, is_high = classify_nodes(
            v["usage_pct"], v["has_metric"],
            self._thr_vec(self.args.low_thresholds),
            self._thr_vec(self.args.high_thresholds),
        )
        if not is_high.any() or not is_low.any():
            return empty

        # ---- victim selection, vectorized: one stable lexsort over
        # (node, priority asc, cpu desc) + per-segment exclusive prefix of
        # freed requests replaces the reference's per-node Go loops. The
        # greedy serial rule "take sorted candidates while the node stays
        # over any checked high threshold, capped per node" becomes:
        # candidate k is selected iff rank < cap AND every earlier
        # candidate in its segment kept the node over (prefix-AND via a
        # cumsum-of-failures == 0 test). Victim sets are identical to the
        # serial pass (bench.py --chain rebalance diffs them vs the C++
        # floor every run).
        target_pct = self._thr_vec(self.args.high_thresholds)
        usage_pct = v["usage_pct"]
        over_gate = (usage_pct - target_pct[None, :] > 0).any(axis=1)
        node_ok = is_high & over_gate
        cand_mask = (v["pod_alive"] & v["pod_movable"]
                     & (v["pod_node"] >= 0)
                     & node_ok[np.maximum(v["pod_node"], 0)])
        cand = np.nonzero(cand_mask)[0]
        self.last_pass_stats["candidates"] = int(cand.size)
        if cand.size == 0:
            return empty
        node_arr = v["pod_node"][cand]
        prio = v["pod_prio"][cand]
        cpu = v["pod_cpu"][cand]
        C = cand.size
        # (node, prio asc, cpu desc) order: when the key ranges fit one
        # int64 (the overwhelmingly common case — node ids, bounded
        # priorities, milli-cpu), ONE stable argsort of a composite key
        # replaces np.lexsort's three passes; the exact lexsort stays as
        # the general fallback
        cpu_i = cpu.astype(np.int64)
        pmin = int(prio.min()) if C else 0
        pspan = int(prio.max()) - pmin + 1 if C else 1
        cspan = int(cpu_i.max()) + 1 if C else 1
        nspan = int(node_arr.max()) + 1 if C else 1
        if (np.all(cpu_i == cpu)
                and float(nspan) * pspan * cspan < float(2 ** 62)):
            key = ((node_arr * pspan + (prio - pmin)) * cspan
                   + (cspan - 1 - cpu_i))
            order = np.argsort(key, kind="stable")
        else:
            order = np.lexsort((-cpu, prio, node_arr))
        node_s = node_arr[order]
        seg_start = np.zeros(C, bool)
        seg_start[0] = True
        seg_start[1:] = node_s[1:] != node_s[:-1]
        starts = np.nonzero(seg_start)[0]
        seg_id = np.cumsum(seg_start) - 1
        # only the CHECKED axes (high_thr > 0 — cpu+mem by default) enter
        # the freed/still-over math: slicing the request matrix to them
        # cuts the heavy [C, R] traffic ~5x at R=10
        chk = np.nonzero(target_pct > 0)[0]
        # exclusive freed-requests prefix per segment as ONE global float64
        # cumsum minus segment offsets. float64 accumulation mirrors the
        # C++ floor (double) and the reference's int64 quantity math; for
        # the integer-valued packed requests the kernel discipline already
        # requires, the re-association is exact, so victim parity holds.
        reqs_s = v["pod_req"][np.ix_(cand[order], chk)].astype(np.float64)
        gcum = np.cumsum(reqs_s, axis=0)
        excl = np.concatenate(
            [np.zeros((1, reqs_s.shape[1])), gcum[:-1]], axis=0)
        freed_excl = excl - excl[starts][seg_id]
        rank = np.arange(C) - starts[seg_id]
        # still-over in MULTIPLY form: usage - freed*100/alloc > thr
        # <=> freed*100 < (usage - thr) * alloc for alloc > 0. The rhs is
        # precomputed per NODE ([N, chk], tiny) instead of per candidate,
        # and the division disappears; the C++ floor computes the identical
        # double expression, so the comparison is bit-deterministic on both
        # sides. The device pass (balance/step.py) ships the same rhs as
        # two float32 limbs and decides the identical comparison.
        alloc_chk = np.maximum(v["alloc"][:, chk], np.float32(1e-9))
        rhs = ((usage_pct[:, chk].astype(np.float64)
                - target_pct[chk].astype(np.float64))
               * alloc_chk.astype(np.float64))
        still_over = (freed_excl * 100.0 < rhs[node_s]).any(axis=1)
        fails = np.cumsum(~still_over)
        seg_off = np.concatenate(([0], fails[starts[1:] - 1]))
        prefix_ok = (fails - seg_off[seg_id]) == 0
        selected = prefix_ok & (rank < self.args.max_pods_to_evict_per_node)
        picked = cand[order[np.nonzero(selected)[0]]]
        self.last_pass_stats["victims"] = int(picked.size)
        return picked

    def balance(self, now: Optional[float] = None) -> List[PodMigrationJob]:
        from koordinator_tpu_torch.api.objects import ANNOTATION_DECISION_ID

        now = time.time() if now is None else now
        with self.tracer.span("rebalance"):
            picked, pods_src, _v = self.select_victims(now)
            # koordwatch decision correlation: the pass's decision id
            # (minted per device/host rebalance window) rides every job
            # it issued, and the migration controller copies it onto the
            # replacement Reservation — flight records, timeline windows
            # and store objects join on it
            decision_id = self.last_pass_stats.get("decision_id")
            jobs: List[PodMigrationJob] = []
            with self.tracer.span("migrate",
                                  victims=str(int(len(picked)))):
                for k in picked:
                    pod = pods_src[k]
                    job = PodMigrationJob(
                        meta=ObjectMeta(
                            name=f"migrate-{pod.meta.namespace}-{pod.meta.name}",
                            namespace="koordinator-system",
                            creation_timestamp=now,
                            annotations=(
                                {ANNOTATION_DECISION_ID: str(decision_id)}
                                if decision_id else {}),
                        ),
                        pod_namespace=pod.meta.namespace,
                        pod_name=pod.meta.name,
                        mode="ReservationFirst",
                    )
                    if self.store.get(KIND_POD_MIGRATION_JOB,
                                      job.meta.key) is None:
                        self.store.add(KIND_POD_MIGRATION_JOB, job)
                        jobs.append(job)
        return jobs


def pack_floor_inputs(store: ObjectStore, plugin: LowNodeLoad,
                      now: float):
    """Pack the store into the arrays `native.floor.lownodeload_floor_native`
    consumes, with the SAME classification inputs balance() sees. One home
    for this encoding, so the compiled floor and the plugin can never drift
    onto different encodings silently (the JAX package's
    descheduler/lownodeload.py pack_floor_inputs, copied).

    Returns (pods list, dict of keyword arrays for the floor call)."""
    nodes = store.list(KIND_NODE)
    node_idx = {n.meta.name: i for i, n in enumerate(nodes)}
    alloc = np.stack([n.allocatable.to_vector() for n in nodes])
    usage_pct = np.zeros_like(alloc, np.float32)
    has_metric = np.zeros(len(nodes), np.int32)
    for i, node in enumerate(nodes):
        nm = store.get(KIND_NODE_METRIC, f"/{node.meta.name}")
        if nm is None or nm.update_time <= 0:
            continue
        if now - nm.update_time >= plugin.args.node_metric_expiration_seconds:
            continue
        a = alloc[i]
        u = nm.node_metric.node_usage.to_vector()
        usage_pct[i] = np.where(a > 0, u * 100.0 / np.maximum(a, 1e-9), 0.0)
        has_metric[i] = 1
    pods = [p for p in store.list(KIND_POD)
            if p.is_assigned and not p.is_terminated]
    pod_req = np.stack([p.spec.requests.to_vector() for p in pods]) \
        if pods else np.zeros((0, NUM_RESOURCES), np.float32)
    arrays = dict(
        alloc=alloc,
        usage_pct=usage_pct,
        has_metric=has_metric,
        low_thr=plugin._thr_vec(plugin.args.low_thresholds),
        high_thr=plugin._thr_vec(plugin.args.high_thresholds),
        pod_node=np.asarray(
            [node_idx.get(p.spec.node_name, -1) for p in pods], np.int32),
        pod_prio=np.asarray([p.spec.priority or 0 for p in pods], np.int32),
        pod_req=pod_req,
        movable=np.asarray(
            [p.meta.owner_kind != "DaemonSet" and not has_pdb_like_guard(p)
             for p in pods], np.int32),
        pod_sort_cpu=np.asarray(
            [p.spec.requests[ResourceName.CPU] for p in pods], np.float32),
        max_evict_per_node=plugin.args.max_pods_to_evict_per_node,
    )
    return pods, arrays
