"""Host->device packing: cluster snapshots as static-shaped arrays.

The analog of the scheduler's cache/snapshot layer (nodeInfo snapshots + the
LoadAware podAssignCache, reference `plugins/loadaware/pod_assign_cache.go`), lowered
to bucketed, padded tensors:

  PodBatch  : pending pods   [P, ...]   (P padded to a bucket size)
  NodeBatch : cluster nodes  [N, ...]   (N padded)

Bucketing keeps jit recompilation amortized while pods/nodes churn (SURVEY.md
section 7 "hard parts: dynamic shapes"). Padding rows carry valid=False and are
masked inside every kernel.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.api.objects import Node, NodeMetric, Pod
from koordinator_tpu_torch.api.priority import PriorityClass
from koordinator_tpu_torch.api.resources import NUM_RESOURCES, PACK_SCALE
from koordinator_tpu_torch.ops.estimator import (
    estimate_node_allocatable,
    estimate_pods_used_batch,
)

MIN_BUCKET = 16


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    """Bucketed padding size >= n (>= minimum). Up to 1024 buckets are powers
    of two; above that the granularity is pow2/8 (e.g. 10k pods -> 10240, 5k
    nodes -> 5120, not 16384/8192). Padded rows are dead work for every kernel
    — at the 10k x 5k north-star config pow2 padding would cost 2.56x compute
    for zero extra recompiles in steady state. Coarse-grained buckets (<= 8
    per doubling, all multiples of 256, so lane/sublane tiling is preserved)
    keep churn-driven recompiles amortized while capping dead rows at one
    granule (< 25% of the padded size, vs up to ~100% for pow2)."""
    b = minimum
    while b < n:
        b *= 2
    if b <= 1024:
        return b
    g = b // 8
    return max(-(-n // g) * g, minimum)


@dataclass
class PodBatch:
    """Packed pending pods. Row order IS the scheduling order (priority queue
    order: priority desc, then creation/sub-priority), so kernels that honor the
    serial contract iterate rows in order."""

    keys: List[str]                      # len = num_valid
    requests: np.ndarray                 # [P, R] float32 packed units
    estimated: np.ndarray                # [P, R] estimator output (native axes)
    priority: np.ndarray                 # [P] int32 numeric pod priority
    qos: np.ndarray                      # [P] int32 QoSClass
    prio_class: np.ndarray               # [P] int32 PriorityClass
    is_prod: np.ndarray                  # [P] bool (priority class == PROD)
    is_daemonset: np.ndarray             # [P] bool (owner kind DaemonSet)
    gang_id: np.ndarray                  # [P] int32, -1 = no gang
    quota_id: np.ndarray                 # [P] int32, -1 = no quota group
    valid: np.ndarray                    # [P] bool
    # row -> reason for pods the ENCODING marked unschedulable this round
    # (term/slot budget overflow) — the cycle driver surfaces these as
    # first-class failure events instead of a generic "no feasible node"
    unschedulable_reasons: Dict[int, str] = field(default_factory=dict)
    # incremental-pack bookkeeping (cache builds only): row i was gathered
    # from row reused_src[i] of the previous build's memo (-1 = repacked
    # from the object). Downstream per-pod loops (snapshot.py flags/masks)
    # use the same mapping to gather THEIR cached columns.
    reused_src: Optional[np.ndarray] = None          # [num_valid] int64
    gang_keys: Optional[np.ndarray] = None           # [num_valid] object, "" = none
    quota_names: Optional[np.ndarray] = None         # [num_valid] object, "" = none
    # the pod objects in packed (queue) order — lets the snapshot builder
    # index pods without re-walking key properties; NOT retained across
    # cycles (the batch itself is cycle-local)
    objs: Optional[List[Pod]] = None

    @property
    def num_valid(self) -> int:
        return len(self.keys)

    @property
    def padded_size(self) -> int:
        return self.requests.shape[0]


@dataclass
class NodeBatch:
    """Packed node-side state. Per-node vectors precomputed on host from Node +
    NodeMetric + plugin caches; kernels combine them with PodBatch rows."""

    names: List[str]
    allocatable: np.ndarray              # [N, R] estimator EstimateNode
    requested: np.ndarray                # [N, R] sum of assigned pod requests (Fit state)
    valid: np.ndarray                    # [N] bool
    # LoadAware terms (built by ops.loadaware.build_loadaware_node_state)
    extras: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def num_valid(self) -> int:
        return len(self.names)

    @property
    def padded_size(self) -> int:
        return self.allocatable.shape[0]


def queue_key_for(pod: Pod, gang_sort: Dict[str, Tuple[float, str]]) -> tuple:
    """The scheduling-queue sort key (PrioritySort + coscheduling Less)
    for one pod under a gang grouping map — ONE implementation shared by
    pack_pods and the in-window pre-pack (prepack_memo_rows), so a
    pre-packed queue-key tuple can never drift from the cold fill."""
    group_time, group_key = gang_sort.get(
        pod.gang_key,
        (pod.meta.creation_timestamp, pod.meta.key),
    )
    return (
        -(pod.spec.priority or 0),
        -pod.sub_priority,
        group_time,
        group_key,
        pod.meta.creation_timestamp,
        pod.meta.key,
    )


def prepack_memo_rows(
    cache,
    pods: Sequence[Pod],
    resource_weights: Dict[str, int],
    scaling_factors: Dict[str, int],
) -> List[Tuple[int, Pod]]:
    """Pack/device overlap: refresh the pack memo's packed-row
    columns for every pod whose (key, resourceVersion) is stale or
    absent, IN PLACE — changed keys update their existing row, new keys
    append — so the next ``pack_pods`` gathers them as hits instead of
    paying the per-object Python in the inter-window gap. Queue-key
    tuples are computed under the memo's OWN gang grouping (exactly the
    tuples ``same_gs`` reuse requires); the estimator runs the same
    batched call the cold fill uses on the same packed rows, so every
    written bit equals what the next build's miss path would write.

    Returns the (memo row, pod) pairs refreshed — the snapshot layer
    fills its flag/sel columns for the same rows."""
    memo = cache.pack_memo if cache is not None else None
    if memo is None or "req_wire" not in memo:
        return []
    row_of = memo["row_of"]
    rv = memo["rv"]
    qk = memo["qk"]
    gang_sort = memo["gang_sort"]
    todo: List[Tuple[Optional[int], Pod]] = []
    for pod in pods:
        j = row_of.get(pod.meta.key)
        if j is not None and rv[j] == pod.meta.resource_version:
            continue
        todo.append((j, pod))
    if not todo:
        return []
    n_new = sum(1 for j, _p in todo if j is None)
    if n_new:
        for col, fill in (("req_wire", 0.0), ("lim_wire", 0.0),
                          ("prio", 0), ("qos", 5), ("pcls", 0),
                          ("prod", False), ("ds", False), ("est", 0.0),
                          ("gang_key", ""), ("quota_name", "")):
            arr = memo[col]
            pad = np.full((n_new,) + arr.shape[1:], fill, arr.dtype)
            memo[col] = np.concatenate([arr, pad])
    nxt = len(rv)
    placed: List[Tuple[int, Pod]] = []
    for j, pod in todo:
        if j is None:
            j = nxt
            nxt += 1
            row_of[pod.meta.key] = j
            rv.append(pod.meta.resource_version)
            qk.append(None)
        else:
            rv[j] = pod.meta.resource_version
        qk[j] = queue_key_for(pod, gang_sort)
        memo["req_wire"][j] = 0.0
        memo["lim_wire"][j] = 0.0
        pod.spec.requests.fill_wire_row(memo["req_wire"][j])
        pod.spec.limits.fill_wire_row(memo["lim_wire"][j])
        memo["prio"][j] = pod.spec.priority or 0
        memo["qos"][j] = int(pod.qos_class)
        cls = pod.priority_class
        memo["pcls"][j] = int(cls)
        memo["prod"][j] = cls in (PriorityClass.PROD, PriorityClass.NONE)
        memo["ds"][j] = pod.meta.owner_kind == "DaemonSet"
        memo["gang_key"][j] = pod.gang_key
        memo["quota_name"][j] = pod.quota_name
        placed.append((j, pod))
    idx = np.asarray([j for j, _p in placed])
    req = (memo["req_wire"][idx] / PACK_SCALE).astype(np.float32)
    lim = (memo["lim_wire"][idx] / PACK_SCALE).astype(np.float32)
    memo["est"][idx] = estimate_pods_used_batch(
        req, lim, memo["pcls"][idx], resource_weights, scaling_factors)
    cache.stats["pod_rows_prepacked"] = (
        cache.stats.get("pod_rows_prepacked", 0) + len(placed))
    return placed


def pack_pods(
    pods: Sequence[Pod],
    resource_weights: Dict[str, int],
    scaling_factors: Dict[str, int],
    gang_ids: Optional[Dict[str, int]] = None,
    quota_ids: Optional[Dict[str, int]] = None,
    pad_to: Optional[int] = None,
    gang_sort: Optional[Dict[str, Tuple[float, str]]] = None,
    cache=None,
) -> PodBatch:
    """Pack pods in scheduling-queue order (kube-scheduler PrioritySort +
    coscheduling Less, coscheduling.go:118): priority desc, sub-priority
    desc, then the GANG GROUP's identity — members of one gang sort by their
    gang's creation time and name, so a gang schedules contiguously instead
    of interleaving with unrelated pods — then pod creation time asc, key
    asc. ``gang_sort`` maps gang name -> (gang creation time, gang key);
    gangless pods (and unknown gangs) group as themselves.

    With a SnapshotCache attached, packing is INCREMENTAL: the previous
    build's packed rows (and queue-key tuples) live in ``cache.pack_memo``
    keyed by (pod key, resourceVersion); rows whose source object did not
    change are gathered with batched fancy indexing — one numpy op per
    field — and only dirty rows pay the per-object Python fill. The cached
    path produces bit-identical arrays to the cold path (the memo stores
    exactly the rows the cold fill writes)."""
    gang_sort = gang_sort or {}
    n_in = len(pods)
    prev = cache.pack_memo if cache is not None else None
    # cached queue-key tuples are only valid if the gang grouping map they
    # were built with is unchanged (gang creation/identity feeds the order)
    same_gs = prev is not None and prev["gang_sort"] == gang_sort

    def queue_key_of(pod):
        return queue_key_for(pod, gang_sort)

    # one pass: key/rv lookup against the memo + queue-key tuples (cached
    # tuples reused; this loop is the only O(P) Python the warm path pays).
    # rv/qk live as plain Python lists — per-element numpy scalar reads
    # would triple the loop's cost.
    keys_in: List[str] = [None] * n_in
    rvs_in: List[int] = [0] * n_in
    src_in = np.full(n_in, -1, np.int64)
    qk_in: List[tuple] = [None] * n_in
    if prev is not None:
        row_of_get = prev["row_of"].get
        prev_rv = prev["rv"]
        prev_qk = prev["qk"]
        for i, pod in enumerate(pods):
            meta = pod.meta
            k = meta.key
            rv = meta.resource_version
            keys_in[i] = k
            rvs_in[i] = rv
            j = row_of_get(k)
            if j is not None and prev_rv[j] == rv:
                src_in[i] = j
                if same_gs:
                    qk_in[i] = prev_qk[j]
                    continue
            qk_in[i] = queue_key_of(pod)
    else:
        for i, pod in enumerate(pods):
            meta = pod.meta
            keys_in[i] = meta.key
            rvs_in[i] = meta.resource_version
            qk_in[i] = queue_key_of(pod)
    order = sorted(range(n_in), key=qk_in.__getitem__)
    pods = [pods[i] for i in order]
    n = n_in
    p = pad_to or bucket_size(n)
    order_np = np.asarray(order, np.int64) if n else np.zeros(0, np.int64)
    src = src_in[order_np]
    keys_arr = [keys_in[i] for i in order]
    # wire-unit matrices filled in one pass (no per-pod vector allocations),
    # packed with a single vectorized scale
    req_wire = np.zeros((p, NUM_RESOURCES), np.float64)
    lim_wire = np.zeros((p, NUM_RESOURCES), np.float64)
    prio = np.zeros(p, np.int32)
    qos = np.full(p, 5, np.int32)  # QoSClass.NONE
    pcls = np.full(p, int(PriorityClass.NONE), np.int32)
    prod = np.zeros(p, bool)
    ds = np.zeros(p, bool)
    gang = np.full(p, -1, np.int32)
    quota = np.full(p, -1, np.int32)
    valid = np.zeros(p, bool)
    est = np.zeros((p, NUM_RESOURCES), np.float32)
    gang_col = np.full(n, "", object)
    quota_col = np.full(n, "", object)
    hit = np.nonzero(src >= 0)[0]
    if hit.size:
        hsrc = src[hit]
        req_wire[hit] = prev["req_wire"][hsrc]
        lim_wire[hit] = prev["lim_wire"][hsrc]
        prio[hit] = prev["prio"][hsrc]
        qos[hit] = prev["qos"][hsrc]
        pcls[hit] = prev["pcls"][hsrc]
        prod[hit] = prev["prod"][hsrc]
        ds[hit] = prev["ds"][hsrc]
        est[hit] = prev["est"][hsrc]
        gang_col[hit] = prev["gang_key"][hsrc]
        quota_col[hit] = prev["quota_name"][hsrc]
    misses = np.nonzero(src < 0)[0]
    for i in misses:
        pod = pods[i]
        pod.spec.requests.fill_wire_row(req_wire[i])
        pod.spec.limits.fill_wire_row(lim_wire[i])
        prio[i] = pod.spec.priority or 0
        qos[i] = int(pod.qos_class)
        cls = pod.priority_class
        pcls[i] = int(cls)
        # GetPodPriorityClassWithDefault: pods outside koordinator bands
        # default to PROD semantics in LoadAware's prod checks
        prod[i] = cls in (PriorityClass.PROD, PriorityClass.NONE)
        ds[i] = pod.meta.owner_kind == "DaemonSet"
        gang_col[i] = pod.gang_key
        quota_col[i] = pod.quota_name
    valid[:n] = True
    # gang/quota id resolution: unique-name factorization instead of a
    # per-pod dict lookup (the id maps are small; the columns are cached)
    if gang_ids is not None:
        fill_ids_from_names(gang, gang_col, gang_ids)
    if quota_ids is not None:
        fill_ids_from_names(quota, quota_col, quota_ids)
    req = (req_wire / PACK_SCALE).astype(np.float32)
    lim = (lim_wire / PACK_SCALE).astype(np.float32)
    # estimate only rows not served from the cache: padding must carry
    # zeros, never the 250-milli/200-MiB defaults the estimator assigns
    # empty requests
    if cache is None:
        if n:
            est[:n] = estimate_pods_used_batch(
                req[:n], lim[:n], pcls[:n], resource_weights, scaling_factors
            )
    elif misses.size:
        est[misses] = estimate_pods_used_batch(
            req[misses], lim[misses], pcls[misses],
            resource_weights, scaling_factors
        )
    if cache is not None:
        cache.stats["pod_row_hits"] += int(hit.size)
        cache.stats["pod_row_misses"] += int(misses.size)
        # rotate the memo: the OLD one stays visible (pack_memo_prev) so
        # build_full_chain_inputs can gather its flag/mask columns with the
        # same reused_src mapping before storing the new columns
        cache.pack_memo_prev = prev
        cache.pack_memo = {
            "gang_sort": dict(gang_sort),
            "row_of": {k: i for i, k in enumerate(keys_arr)},
            "rv": [rvs_in[i] for i in order],
            "qk": [qk_in[i] for i in order],
            "req_wire": req_wire[:n].copy(),
            "lim_wire": lim_wire[:n].copy(),
            "prio": prio[:n].copy(), "qos": qos[:n].copy(),
            "pcls": pcls[:n].copy(), "prod": prod[:n].copy(),
            "ds": ds[:n].copy(), "est": est[:n].copy(),
            "gang_key": gang_col.copy(), "quota_name": quota_col.copy(),
        }
    return PodBatch(
        keys=keys_arr,
        requests=req,
        estimated=est,
        priority=prio,
        qos=qos,
        prio_class=pcls,
        is_prod=prod,
        is_daemonset=ds,
        gang_id=gang,
        quota_id=quota,
        valid=valid,
        reused_src=src if cache is not None else None,
        gang_keys=gang_col,
        quota_names=quota_col,
        objs=pods,
    )


def fill_ids_from_names(out: np.ndarray, names: np.ndarray,
                         id_map: Dict[str, int]) -> None:
    """out[i] = id_map.get(names[i], -1) for named rows, vectorized through
    a unique-name factorization ("" rows keep -1)."""
    if not names.size or not id_map:
        return
    named = np.nonzero(names != "")[0]
    if not named.size:
        return
    uniq, inv = np.unique(names[named].astype(str), return_inverse=True)
    ids = np.asarray([id_map.get(u, -1) for u in uniq], np.int32)
    out[named] = ids[inv]


def pack_nodes(
    nodes: Sequence[Node],
    assigned_requests: Optional[Dict[str, np.ndarray]] = None,
    pad_to: Optional[int] = None,
) -> NodeBatch:
    """Pack node allocatable + current requested (the NodeResourcesFit state)."""
    n = len(nodes)
    size = pad_to or bucket_size(n)
    alloc = np.zeros((size, NUM_RESOURCES), np.float32)
    requested = np.zeros((size, NUM_RESOURCES), np.float32)
    valid = np.zeros(size, bool)
    for i, node in enumerate(nodes):
        alloc[i] = estimate_node_allocatable(node)
        if assigned_requests is not None:
            vec = assigned_requests.get(node.meta.name)
            if vec is not None:
                requested[i] = vec
        valid[i] = True
    return NodeBatch(
        names=[nd.meta.name for nd in nodes],
        allocatable=alloc,
        requested=requested,
        valid=valid,
    )


def metric_age(node_metric: Optional[NodeMetric], now: Optional[float] = None) -> float:
    if node_metric is None or node_metric.update_time <= 0:
        return float("inf")
    return (time.time() if now is None else now) - node_metric.update_time
