"""LoadAware scheduling: vectorized filter + score.

Reference: `pkg/scheduler/plugins/loadaware/load_aware.go` —
  Filter (:123-171): reject nodes whose measured utilization (NodeMetric CR; instant
    or aggregated percentile) crosses per-resource thresholds; DaemonSet pods,
    metric-less nodes, and (optionally) expired metrics skip the check; prod pods
    check prod-tier pod usage when prod thresholds are configured (:226-255).
  Score (:269-335): least-allocated over estimatedUsed = estimator(pending pod)
    + sum(estimated usage of recently-assigned pods not yet visible in metrics)
    + adjusted measured node usage (estimated pods' actual usage deducted).

Host/device split: everything that depends only on (node, NodeMetric,
assign-cache) is precomputed per node on the host into [N, R] numpy arrays
(`build_loadaware_node_state`, a copy of the JAX package's); the per-node
reject rows (`loadaware_node_reject`) and the one-shot [P, N] filter and
score (`loadaware_filter`, `loadaware_score_terms`) are torch over those
arrays, on the device the round runs on.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.api.objects import Node, NodeMetric, Pod
from koordinator_tpu_torch.api.priority import PriorityClass
from koordinator_tpu_torch.api.resources import (
    NUM_RESOURCES,
    RESOURCE_INDEX,
    ResourceName,
)
from koordinator_tpu_torch.ops.common import go_round, least_requested_score
from koordinator_tpu_torch.ops.estimator import estimate_pod_used

ANNOTATION_CUSTOM_USAGE_THRESHOLDS = "scheduling.koordinator.sh/usage-thresholds"
DEFAULT_NODE_METRIC_REPORT_INTERVAL = 60.0


@dataclass
class LoadAwareArgs:
    """LoadAwareSchedulingArgs with the v1beta2 defaults
    (pkg/scheduler/apis/config/v1beta2/defaults.go:32-99)."""

    filter_expired_node_metrics: bool = True
    node_metric_expiration_seconds: float = 180.0
    resource_weights: Dict[str, int] = field(
        default_factory=lambda: {ResourceName.CPU: 1, ResourceName.MEMORY: 1}
    )
    usage_thresholds: Dict[str, int] = field(
        default_factory=lambda: {ResourceName.CPU: 65, ResourceName.MEMORY: 95}
    )
    prod_usage_thresholds: Dict[str, int] = field(default_factory=dict)
    score_according_prod_usage: bool = False
    estimated_scaling_factors: Dict[str, int] = field(
        default_factory=lambda: {ResourceName.CPU: 85, ResourceName.MEMORY: 70}
    )
    # Aggregated (percentile) profile, load_aware.go Aggregated args
    agg_usage_thresholds: Dict[str, int] = field(default_factory=dict)
    agg_usage_aggregation_type: str = ""       # "avg"|"p50"|"p90"|"p95"|"p99"
    agg_usage_duration_seconds: int = 0        # 0 = longest recorded window
    agg_score_aggregation_type: str = ""
    agg_score_duration_seconds: int = 0

    @property
    def filter_with_aggregation(self) -> bool:
        return bool(self.agg_usage_thresholds) and bool(self.agg_usage_aggregation_type)

    @property
    def score_with_aggregation(self) -> bool:
        return bool(self.agg_score_aggregation_type)

    def weight_vector(self) -> np.ndarray:
        w = np.zeros(NUM_RESOURCES, np.float32)
        for name, weight in self.resource_weights.items():
            w[RESOURCE_INDEX[name]] = weight
        return w


def _thresholds_vector(thresholds: Dict[str, int]) -> np.ndarray:
    v = np.zeros(NUM_RESOURCES, np.float32)
    for name, t in thresholds.items():
        v[RESOURCE_INDEX[name]] = t
    return v


def _get_aggregated_usage(
    nm: NodeMetric, duration_seconds: int, agg_type: str
) -> Optional[np.ndarray]:
    """getTargetAggregatedUsage (helper.go:58-90): exact duration match, or the
    longest recorded window when no duration is configured; missing type -> None."""
    if not nm.node_metric.aggregated_node_usages:
        return None
    if duration_seconds:
        windows = [duration_seconds] if duration_seconds in nm.node_metric.aggregated_node_usages else []
    else:
        windows = [max(nm.node_metric.aggregated_node_usages.keys())]
    for d in windows:
        usage = nm.node_metric.aggregated_node_usages[d].get(agg_type)
        if usage is not None and usage:
            return usage.to_vector()
    return None


def _custom_profile(
    node: Node, args: LoadAwareArgs
) -> Tuple[Dict[str, int], Dict[str, int], Optional[Tuple[Dict[str, int], str, int]]]:
    """generateUsageThresholdsFilterProfile (helper.go:102-139): node annotation
    overrides cluster args per section; aggregated profile falls back to args."""
    usage_thr, prod_thr = args.usage_thresholds, args.prod_usage_thresholds
    agg: Optional[Tuple[Dict[str, int], str, int]] = None
    if args.filter_with_aggregation:
        agg = (
            args.agg_usage_thresholds,
            args.agg_usage_aggregation_type,
            args.agg_usage_duration_seconds,
        )
    raw = node.meta.annotations.get(ANNOTATION_CUSTOM_USAGE_THRESHOLDS)
    if raw:
        try:
            data = json.loads(raw)
        except (ValueError, TypeError):
            return usage_thr, prod_thr, agg
        if data.get("usageThresholds"):
            usage_thr = {k: int(v) for k, v in data["usageThresholds"].items()}
        if data.get("prodUsageThresholds"):
            prod_thr = {k: int(v) for k, v in data["prodUsageThresholds"].items()}
        custom_agg = data.get("aggregatedUsage")
        if custom_agg and custom_agg.get("usageThresholds") and custom_agg.get(
            "usageAggregationType"
        ):
            agg = (
                {k: int(v) for k, v in custom_agg["usageThresholds"].items()},
                custom_agg["usageAggregationType"],
                int(custom_agg.get("usageAggregatedDurationSeconds", 0) or 0),
            )
    return usage_thr, prod_thr, agg


def _is_prod_with_default(pod: Pod) -> bool:
    """GetPodPriorityClassWithDefault: pods outside koordinator bands behave as
    PROD for the prod-usage checks."""
    return pod.priority_class in (PriorityClass.PROD, PriorityClass.NONE)


def build_loadaware_node_state(
    nodes: Sequence[Node],
    node_metrics: Dict[str, NodeMetric],
    pods_by_key: Dict[str, Pod],
    assigned: Dict[str, List[Tuple[Pod, float]]],
    args: LoadAwareArgs,
    now: float,
    pad_to: int,
) -> Dict[str, np.ndarray]:
    """Precompute per-node LoadAware terms as [N, R] / [N] arrays.

    `assigned` is the podAssignCache view: node -> [(pod, assign_timestamp)] of
    pods Reserved on the node (pod_assign_cache.go). Returns the extras dict to
    attach to NodeBatch.
    """
    n_pad = pad_to
    R = NUM_RESOURCES
    filter_usage = np.zeros((n_pad, R), np.float32)
    has_filter_usage = np.zeros(n_pad, bool)
    filter_thr = np.zeros((n_pad, R), np.float32)
    prod_thr_arr = np.zeros((n_pad, R), np.float32)
    prod_pod_usage = np.zeros((n_pad, R), np.float32)
    term_np = np.zeros((n_pad, R), np.float32)
    term_pr = np.zeros((n_pad, R), np.float32)
    score_valid = np.zeros(n_pad, bool)
    filter_skip = np.zeros(n_pad, bool)
    # the non-prod score term split into its two components, so the fused
    # wave kernel (models/fused_waves.py) can carry the assigned-estimate
    # sum on device and recompute term = est_sum + adjusted per wave with
    # the SAME association a next-cycle host rebuild would produce
    # (term_np == est_np_arr + adj_np_arr holds bit-exactly: the host adds
    # the identical two operands below)
    est_np_arr = np.zeros((n_pad, R), np.float32)
    adj_np_arr = np.zeros((n_pad, R), np.float32)
    # the PROD score term split the same way: term_pr ==
    # est_pr_arr + adj_pr_arr holds bit-exactly because the host below
    # adds exactly those two operands — the fused wave kernel carries the
    # prod assigned-estimate sum on device and recomputes the prod term
    # per wave with the identical two-operand association
    est_pr_arr = np.zeros((n_pad, R), np.float32)
    adj_pr_arr = np.zeros((n_pad, R), np.float32)

    for i, node in enumerate(nodes):
        nm = node_metrics.get(node.meta.name)
        # isNodeMetricExpired (helper.go:36-41)
        expired = (
            nm is None
            or nm.update_time <= 0
            or (
                args.node_metric_expiration_seconds > 0
                and now - nm.update_time >= args.node_metric_expiration_seconds
            )
        )
        if nm is None or (args.filter_expired_node_metrics and expired):
            filter_skip[i] = True  # load_aware.go:135-150: allow without check
        score_valid[i] = nm is not None and not expired
        if nm is None:
            continue

        usage_thr, prod_thr, agg = _custom_profile(node, args)
        if agg is not None:
            agg_thr, agg_type, agg_dur = agg
            filter_thr[i] = _thresholds_vector(agg_thr)
            src = _get_aggregated_usage(nm, agg_dur, agg_type)
        else:
            filter_thr[i] = _thresholds_vector(usage_thr)
            src = nm.node_metric.node_usage.to_vector() if nm.node_metric else None
        if src is not None:
            filter_usage[i] = src
            has_filter_usage[i] = True

        # prod filter (load_aware.go:226-255): requires PodsMetric present
        pod_metrics_prod: Dict[str, np.ndarray] = {}
        pod_metrics_all: Dict[str, np.ndarray] = {}
        for pm in nm.pods_metric:
            key = f"{pm.namespace}/{pm.name}"
            pod = pods_by_key.get(key)
            if pod is None:  # buildPodMetricMap: lister miss -> skip
                continue
            vec = pm.pod_usage.to_vector()
            pod_metrics_all[key] = vec
            if _is_prod_with_default(pod):
                pod_metrics_prod[key] = vec
        if prod_thr and nm.pods_metric:
            prod_thr_arr[i] = _thresholds_vector(prod_thr)
            for vec in pod_metrics_prod.values():
                prod_pod_usage[i] += vec

        # ---- score terms ----
        report_interval = nm.report_interval_seconds or DEFAULT_NODE_METRIC_REPORT_INTERVAL
        if args.score_with_aggregation:
            score_src = _get_aggregated_usage(
                nm, args.agg_score_duration_seconds, args.agg_score_aggregation_type
            )
        else:
            score_src = (
                nm.node_metric.node_usage.to_vector() if nm.node_metric else None
            )

        def assigned_term(
            metrics: Dict[str, np.ndarray], prod_only: bool
        ) -> Tuple[np.ndarray, set]:
            """estimatedAssignedPodUsed (load_aware.go:337-383)."""
            est_sum = np.zeros(R, np.float32)
            est_pods: set = set()
            for pod, ts in assigned.get(node.meta.name, []):
                if prod_only and not _is_prod_with_default(pod):
                    continue
                key = pod.meta.key
                pod_usage = metrics.get(key)
                needs_estimate = (
                    pod_usage is None
                    or ts > nm.update_time  # missedLatestUpdateTime
                    or (ts < nm.update_time and nm.update_time - ts < report_interval)
                    or (args.score_with_aggregation and score_src is None)
                )
                if not needs_estimate:
                    continue
                est = estimate_pod_used(
                    pod, args.resource_weights, args.estimated_scaling_factors
                )
                for native in args.resource_weights:
                    r = RESOURCE_INDEX[native]
                    value = est[r]
                    if pod_usage is not None and pod_usage[r] > value:
                        value = pod_usage[r]
                    est_sum[r] += value
                est_pods.add(key)
            return est_sum, est_pods

        # non-prod branch: node usage minus estimated pods' actual, plus estimates
        est_np, est_pods_np = assigned_term(pod_metrics_all, prod_only=False)
        term = est_np.copy()
        if score_src is not None:
            est_actual = np.zeros(R, np.float32)
            for key in est_pods_np:
                vec = pod_metrics_all.get(key)
                if vec is not None:
                    est_actual += vec
            # quantity.Sub(q) only when quantity >= q (load_aware.go:316-323),
            # decided per-resource on the whole vector
            adjusted = np.where(score_src >= est_actual, score_src - est_actual, score_src)
            term += adjusted
            adj_np_arr[i] = adjusted
        est_np_arr[i] = est_np
        term_np[i] = term

        # prod branch (scoreAccordingProdUsage): prod pod metrics only.
        # The non-estimated prod usages fold into ONE adjusted vector
        # first (their set is static while a dispatch is in flight: a pod
        # bound mid-dispatch has no metrics yet, so it joins the estimate
        # side), then term = est + adjusted — the same two-operand
        # association the nonprod branch established, so the fused wave
        # carry (est fold + one add) reproduces this rebuild bit-for-bit
        if args.score_according_prod_usage:
            est_pr, est_pods_pr = assigned_term(pod_metrics_prod, prod_only=True)
            adjusted_pr = np.zeros(R, np.float32)
            for key, vec in pod_metrics_prod.items():
                if key not in est_pods_pr:  # sumPodUsages excludes estimated pods
                    adjusted_pr += vec
            term_pr[i] = est_pr + adjusted_pr
            est_pr_arr[i] = est_pr
            adj_pr_arr[i] = adjusted_pr

    return {
        "la_filter_usage": filter_usage,
        "la_has_filter_usage": has_filter_usage,
        "la_filter_thresholds": filter_thr,
        "la_prod_thresholds": prod_thr_arr,
        "la_prod_pod_usage": prod_pod_usage,
        "la_term_nonprod": term_np,
        "la_term_prod": term_pr,
        "la_score_valid": score_valid,
        "la_filter_skip": filter_skip,
        # consumed only by the fused wave path (not part of ScheduleInputs)
        "la_est_nonprod": est_np_arr,
        "la_adj_nonprod": adj_np_arr,
        "la_est_prod": est_pr_arr,
        "la_adj_prod": adj_pr_arr,
    }


# ---------------------------------------------------------------------------
# Device half (torch; f32 throughout, as in the JAX package with x64 off)
# ---------------------------------------------------------------------------


def loadaware_node_reject(
    allocatable: torch.Tensor,        # [N, R]
    filter_usage: torch.Tensor,       # [N, R]
    has_filter_usage: torch.Tensor,   # [N] bool
    filter_thresholds: torch.Tensor,  # [N, R]
    prod_thresholds: torch.Tensor,    # [N, R]
    prod_pod_usage: torch.Tensor,     # [N, R]
    filter_skip: torch.Tensor,        # [N] bool
):
    """Per-node reject masks; pod-independent (the pod enters only via
    is_prod/is_daemonset in the round). Returns (reject_nonprod[N],
    reject_prod[N])."""
    checkable = ((filter_thresholds > 0) & (allocatable > 0)
                 & has_filter_usage[:, None])
    ratio = go_round(filter_usage * 100.0 / torch.clamp_min(allocatable, 1e-9))
    reject_np = (checkable & (ratio >= filter_thresholds)).any(dim=-1)
    reject_np = reject_np & ~filter_skip

    prod_checkable = (prod_thresholds > 0) & (allocatable > 0)
    prod_ratio = go_round(
        prod_pod_usage * 100.0 / torch.clamp_min(allocatable, 1e-9))
    reject_prod_only = (prod_checkable & (prod_ratio >= prod_thresholds)).any(
        dim=-1)
    has_prod_thr = (prod_thresholds > 0).any(dim=-1)
    # prod pods use the prod check IFF prod thresholds exist, else the normal
    # one (load_aware.go:152-170); expired/missing metrics skip everything
    reject_prod = torch.where(has_prod_thr, reject_prod_only, reject_np)
    reject_prod = reject_prod & ~filter_skip
    return reject_np, reject_prod


def loadaware_node_reject_np(allocatable, filter_usage, has_filter_usage,
                             filter_thresholds, prod_thresholds,
                             prod_pod_usage, filter_skip):
    """Host-numpy twin of loadaware_node_reject, op for op in f32 (each
    an IEEE-rounded elementwise op, as the torch one's): (reject_nonprod[N],
    reject_prod[N]) bool."""
    f32 = np.float32
    alloc = np.asarray(allocatable, f32)
    thr = np.asarray(filter_thresholds, f32)
    prod_thr = np.asarray(prod_thresholds, f32)
    skip = np.asarray(filter_skip, bool)
    floor_cap = np.maximum(alloc, f32(1e-9))
    checkable = ((thr > 0) & (alloc > 0)
                 & np.asarray(has_filter_usage, bool)[:, None])
    ratio = np.floor(np.asarray(filter_usage, f32) * f32(100.0) / floor_cap
                     + f32(0.5))
    reject_np = (checkable & (ratio >= thr)).any(axis=-1) & ~skip
    prod_checkable = (prod_thr > 0) & (alloc > 0)
    prod_ratio = np.floor(np.asarray(prod_pod_usage, f32) * f32(100.0)
                          / floor_cap + f32(0.5))
    reject_prod_only = (prod_checkable & (prod_ratio >= prod_thr)).any(
        axis=-1)
    has_prod_thr = (prod_thr > 0).any(axis=-1)
    reject_prod = np.where(has_prod_thr, reject_prod_only, reject_np) & ~skip
    return reject_np, reject_prod


def loadaware_filter(
    is_prod: torch.Tensor,         # [P] bool
    is_daemonset: torch.Tensor,    # [P] bool
    reject_nonprod: torch.Tensor,  # [N] bool
    reject_prod: torch.Tensor,     # [N] bool
) -> torch.Tensor:
    """Combine per-node rejects with pod flags -> feasible[P, N]."""
    reject = torch.where(is_prod[:, None], reject_prod[None, :],
                         reject_nonprod[None, :])
    return is_daemonset[:, None] | ~reject


def loadaware_score_terms(
    estimated: torch.Tensor,     # [P, R] estimator output for pending pods
    is_prod: torch.Tensor,       # [P] bool
    term_nonprod: torch.Tensor,  # [N, R]
    term_prod: torch.Tensor,     # [N, R]
    allocatable: torch.Tensor,   # [N, R]
    score_valid: torch.Tensor,   # [N] bool
    weights: torch.Tensor,       # [R]
    score_according_prod_usage: bool,
    weight_idx: Tuple[int, ...],
) -> torch.Tensor:
    """score[P, N]: weighted least-allocated over estimatedUsed
    (load_aware.go:283-335 + :385-397), one weighted axis at a time so that
    no [P, N, R] intermediate is built."""
    wsum = weights.sum()
    acc = torch.zeros((estimated.shape[0], term_nonprod.shape[0]),
                      dtype=torch.float32, device=estimated.device)
    for r in weight_idx:
        if score_according_prod_usage:
            node_term = torch.where(is_prod[:, None], term_prod[None, :, r],
                                    term_nonprod[None, :, r])
        else:
            node_term = term_nonprod[None, :, r]
        used = estimated[:, r][:, None] + node_term
        acc = acc + weights[r] * least_requested_score(
            used, allocatable[None, :, r])
    score = torch.floor(acc / torch.clamp_min(wsum, 1.0))
    return torch.where(score_valid[None, :], score, 0.0)
