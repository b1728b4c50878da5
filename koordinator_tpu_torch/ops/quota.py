"""ElasticQuota: hierarchical runtime-quota redistribution + batched admission.

Reference: `pkg/scheduler/plugins/elasticquota/core/` —
  * runtime_quota_calculator.go:111-168 `redistribution`: per (parent, resource),
    children whose request exceeds effective-min (max(min, guarantee)) start at
    min and share the leftover by sharedWeight in iterated rounds
    (delta = floor(w * leftover / totalW + 0.5), capped at request, excess
    recycled) — a fixed-point water-filling.
  * plugin.go:210-256 + plugin_helper.go:281 `checkQuotaRecursive`: admission
    walks the ancestor chain; every ancestor must satisfy
    used + podRequest <= runtimeQuota on every resource.

Host half (numpy, a copy of the JAX package's): all sibling groups across ALL
parents are processed in one [G] vector per round with segment-sums by parent
id; levels are computed top-down so a child's total is its parent's runtime.
Device half (torch): the per-pod admission and usage rows. Admission uses a fixed-depth ancestor table ancestors[G, D] so the
per-pod check in the serial loop is a gather + compare, and in-batch `used` deltas
are scatter-adds along the chain.

Order-dependent admission (SURVEY.md section 7 hard parts) is preserved by the
serial-parity loop: pods are admitted in queue order against mutating `used`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCES
from koordinator_tpu_torch.ops.common import go_round_np

MAX_QUOTA_DEPTH = 4  # root -> ... -> leaf (reference trees are shallow)


@dataclass
class QuotaTreeArrays:
    """Packed quota tree (host-built, device-consumed)."""

    names: List[str]
    parent: np.ndarray        # [G] int32, -1 for roots
    ancestors: np.ndarray     # [G, D] int32 self-then-ancestors, -1 padded
    min: np.ndarray           # [G, R]
    max: np.ndarray           # [G, R]
    shared_weight: np.ndarray  # [G, R]
    request: np.ndarray       # [G, R] sum of member pod requests
    used: np.ndarray          # [G, R] sum of scheduled member pod requests
    guarantee: np.ndarray     # [G, R]
    allow_lent: np.ndarray    # [G] bool
    level: np.ndarray         # [G] int32 depth (root=0)
    index: Dict[str, int] = field(default_factory=dict)
    # per-group enable flag for min-quota scaling; the reference's manager flag
    # is global-on (group_quota_manager.go:86) but the ScaleMinQuotaManager
    # tracks both categories, so the mask is kept per group
    enable_min_scale: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))


def water_fill_level(
    total: np.ndarray,         # [G, R] available to each group's children
    parent: np.ndarray,        # [G] int32 (-1 roots)
    min_: np.ndarray,          # [G, R]
    guarantee: np.ndarray,     # [G, R]
    request: np.ndarray,       # [G, R]
    shared_weight: np.ndarray,  # [G, R]
    allow_lent: np.ndarray,    # [G]
    level: np.ndarray,         # [G]
    cur_level: int,
    num_groups: int,
) -> np.ndarray:
    """One level of redistribution: returns runtime[G, R] for groups at cur_level
    (other rows zero). `total[g]` must hold the parent's runtime (or cluster total
    for roots).

    Host numpy, NOT a device kernel: the quota tree is control-plane scale
    (G ~ 10^2) and this runs at snapshot-build time on every reconcile — jitting
    it costs 10^4x its runtime in per-shape XLA compiles. The per-pod admission
    side (quota_admit_row / quota_used_add_row) stays in-kernel where the
    pod-axis batching lives."""
    G = parent.shape[0]
    active = (level == cur_level)[:, None]  # [G, 1]
    eff_min = np.maximum(min_, guarantee)
    over = request > eff_min
    base = np.where(over, eff_min, np.where(allow_lent[:, None], request, eff_min))
    base = np.where(active, base, 0.0)

    # roots share the cluster total: they get a common virtual segment id G
    seg = np.where(parent >= 0, parent, G)
    adjustable = over & active & (shared_weight > 0)

    def seg_sum(x):
        out = np.zeros((G + 1, x.shape[1]), x.dtype)
        np.add.at(out, seg, x)
        return out

    spent = seg_sum(base)                       # [G+1, R]
    # per-parent leftover; total is constant within a segment (parent's runtime)
    seg_total = np.full((G + 1, total.shape[1]), -np.inf, total.dtype)
    np.maximum.at(seg_total, seg, np.where(active, total, -np.inf))
    leftover_seg = np.maximum(seg_total - spent, 0.0)
    leftover_seg[~np.isfinite(leftover_seg)] = 0.0

    runtime = base
    for _ in range(num_groups + 2):
        if not adjustable.any() or not (leftover_seg > 0).any():
            break
        w = np.where(adjustable, shared_weight, 0.0)
        wsum = seg_sum(w)[seg]                  # [G, R]
        delta = np.where(
            (wsum > 0) & adjustable,
            go_round_np(shared_weight * leftover_seg[seg] / np.maximum(wsum, 1e-9)),
            0.0,
        )
        new_rt = runtime + delta
        overshoot = np.maximum(new_rt - request, 0.0)
        # only adjustable (over-requesting) rows clamp to request; a non-lent
        # sibling sits at eff_min > request and must keep it
        # (runtime_quota_calculator.go:128-134 keeps runtimeQuota = min there)
        new_rt = np.where(adjustable, np.minimum(new_rt, request), runtime)
        # a child stays adjustable while below its request EVEN if this round's
        # rounded delta was 0 — recycled overshoot must still reach it next
        # round (reference iterationForRedistribution keeps it in `nodes`)
        still = adjustable & (new_rt < request)
        # next round distributes ONLY the overshoot recycled this round
        # (undistributed rounding remainder is dropped, as in the reference)
        leftover_seg = seg_sum(np.where(adjustable, overshoot, 0.0))
        runtime = new_rt
        adjustable = still
    return np.where(active, runtime, 0.0).astype(np.float32)


def scaled_min_level(
    total: np.ndarray,    # [G, R] each group's parent-available total
    parent: np.ndarray,   # [G]
    min_: np.ndarray,     # [G, R] original min
    enable: np.ndarray,   # [G] bool — group participates in scaling
    level: np.ndarray,    # [G]
    cur_level: int,
) -> np.ndarray:
    """AutoScaleMin for groups at cur_level
    (core/scale_minquota_when_over_root_res.go:103-160): per (parent, resource)
    where the children's min sum exceeds the parent's total, enable-scale
    children split max(0, total - disabledSum) proportionally to their original
    min (truncated, as the reference's int64 conversion does); disable-scale
    children always keep their original min."""
    G, R = min_.shape
    active = level == cur_level
    seg = np.where(parent >= 0, parent, G)

    def seg_sum(mask):
        out = np.zeros((G + 1, R), np.float64)
        rows = active & mask
        np.add.at(out, seg[rows], min_[rows])
        return out

    en_sum = seg_sum(enable)
    dis_sum = seg_sum(~enable)
    # per-segment total (constant within a segment: the parent's runtime)
    seg_total = np.full((G + 1, R), -np.inf)
    np.maximum.at(seg_total, seg[active], total[active])
    seg_total[~np.isfinite(seg_total)] = 0.0

    need_scale = (en_sum + dis_sum) > seg_total          # [G+1, R]
    avail = np.maximum(seg_total - dis_sum, 0.0)
    scaled = np.floor(
        avail[seg] * min_ / np.maximum(en_sum[seg], 1e-9)
    )
    use = active[:, None] & enable[:, None] & need_scale[seg]
    return np.where(use, scaled, min_).astype(np.float32)


def compute_runtime_quotas(
    tree: QuotaTreeArrays,
    cluster_total: np.ndarray,
    scale_min_enabled: bool = True,
) -> np.ndarray:
    """Top-down runtime quota for the whole tree: [G, R] float32.

    Level 0 children share cluster_total; level d children share their parent's
    runtime. When scale_min_enabled (the manager default,
    group_quota_manager.go:86), each level's mins are first auto-scaled where
    the siblings' min sum exceeds the parent total. Host numpy (see
    water_fill_level for why)."""
    G = len(tree.names)
    if G == 0:
        return np.zeros((0, NUM_RESOURCES), np.float32)
    parent = tree.parent
    runtime = np.zeros((G, NUM_RESOURCES), np.float32)
    max_level = int(tree.level.max()) if G else 0
    total_row = np.asarray(cluster_total, np.float32)
    enable = (
        tree.enable_min_scale
        if tree.enable_min_scale.shape[0] == G
        else np.ones(G, bool)
    )
    for lvl in range(max_level + 1):
        total = np.where(
            (parent >= 0)[:, None],
            runtime[np.clip(parent, 0, G - 1)],
            total_row[None, :],
        )
        min_eff = (
            scaled_min_level(total, parent, tree.min, enable, tree.level, lvl)
            if scale_min_enabled
            else tree.min
        )
        rt_lvl = water_fill_level(
            total,
            parent,
            min_eff,
            tree.guarantee,
            tree.request,
            tree.shared_weight,
            tree.allow_lent,
            tree.level,
            lvl,
            G,
        )
        runtime = np.where((tree.level == lvl)[:, None], rt_lvl, runtime)
    # cap by max (runtime never exceeds max; reference setClusterTotalResource /
    # quotaInfo semantics)
    return np.minimum(runtime, tree.max).astype(np.float32)


# ---------------------------------------------------------------------------
# Host-side tree construction (GroupQuotaManager analog, group_quota_manager.go)
# ---------------------------------------------------------------------------


def merge_group_request(
    pending_by_quota: Dict[str, np.ndarray],
    used_by_quota: Dict[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """Group request = pending + used: EVERY member pod counts toward the
    group's demand (GroupQuotaManager.updatePodRequestNoLock,
    group_quota_manager.go:184-256), not just the unscheduled ones. Single
    home for the rule — the snapshot builder, preemptor, and revoke
    controller all derive runtime quotas from it."""
    out: Dict[str, np.ndarray] = {k: v.copy() for k, v in pending_by_quota.items()}
    for k, v in used_by_quota.items():
        if k in out:
            out[k] = out[k] + v
        else:
            out[k] = v.copy()
    return out


def build_quota_tree(
    quotas,  # Sequence[ElasticQuota]
    pod_requests_by_quota: Optional[Dict[str, np.ndarray]] = None,
    used_by_quota: Optional[Dict[str, np.ndarray]] = None,
) -> QuotaTreeArrays:
    """Pack ElasticQuota CRs into QuotaTreeArrays (topology rebuild,
    group_quota_manager.go:425-533). Parents referenced by label; missing parents
    become roots. Request/used aggregate child -> parent recursively
    (:184-256)."""
    names = [q.meta.name for q in quotas]
    index = {n: i for i, n in enumerate(names)}
    G = len(names)
    parent = np.full(G, -1, np.int32)
    for i, q in enumerate(quotas):
        p = q.parent
        if p and p in index:
            parent[i] = index[p]
    # levels
    level = np.zeros(G, np.int32)
    for i in range(G):
        g, d = i, 0
        while parent[g] >= 0 and d < MAX_QUOTA_DEPTH:
            g = parent[g]
            d += 1
        level[i] = d
    ancestors = np.full((G, MAX_QUOTA_DEPTH), -1, np.int32)
    for i in range(G):
        g, d = i, 0
        while g >= 0 and d < MAX_QUOTA_DEPTH:
            ancestors[i, d] = g
            g = parent[g]
            d += 1
    min_ = np.zeros((G, NUM_RESOURCES), np.float32)
    max_ = np.zeros((G, NUM_RESOURCES), np.float32)
    weight = np.zeros((G, NUM_RESOURCES), np.float32)
    request = np.zeros((G, NUM_RESOURCES), np.float32)
    used = np.zeros((G, NUM_RESOURCES), np.float32)
    guarantee = np.zeros((G, NUM_RESOURCES), np.float32)
    allow_lent = np.ones(G, bool)
    for i, q in enumerate(quotas):
        min_[i] = q.min.to_vector()
        max_[i] = q.max.to_vector()
        weight[i] = q.shared_weight.to_vector()
        guarantee[i] = q.guaranteed.to_vector()
        allow_lent[i] = q.allow_lent_resource
        if pod_requests_by_quota:
            vec = pod_requests_by_quota.get(q.meta.name)
            if vec is not None:
                request[i] = vec
        if used_by_quota:
            vec = used_by_quota.get(q.meta.name)
            if vec is not None:
                used[i] = vec
    # aggregate request/used up the chain (deltas :184-256). A group's request
    # contribution to its parent is capped at its own max — limitRequest
    # semantics (quota_info.go:196-201, group_quota_manager.go:187) — otherwise
    # an over-max group would soak up leftover its siblings should receive.
    order = np.argsort(-level)
    for i in order:
        request[i] = np.minimum(request[i], max_[i])
        if parent[i] >= 0:
            request[parent[i]] += request[i]
            used[parent[i]] += used[i]
    return QuotaTreeArrays(
        names=names,
        parent=parent,
        ancestors=ancestors,
        min=min_,
        max=max_,
        shared_weight=weight,
        request=request,
        used=used,
        guarantee=guarantee,
        allow_lent=allow_lent,
        level=level,
        index=index,
        enable_min_scale=np.ones(G, bool),
    )


# ---------------------------------------------------------------------------
# Device half: per-pod admission and usage rows (torch)
# ---------------------------------------------------------------------------


def quota_admit_row(
    request: torch.Tensor,     # [R]
    quota_id: torch.Tensor,    # 0-d int32 (-1 = no quota -> admitted)
    ancestors: torch.Tensor,   # [G, D] int32
    used: torch.Tensor,        # [G, R]
    runtime: torch.Tensor,     # [G, R]
) -> torch.Tensor:
    """0-d bool: checkQuotaRecursive along the ancestor chain, the [D]
    chain gathered as one [D, R] block. The verdict is an AND over the
    chain and its axes, exact in any order; each cell's used + request is
    the same f32 add the level-by-level walk makes."""
    chain = ancestors[torch.clamp_min(quota_id, 0).long()]  # [D]
    gg = torch.clamp_min(chain, 0).long()
    fit = ((request <= 0) | (used[gg] + request <= runtime[gg])).all(dim=-1)
    return ((chain < 0) | fit).all() | (quota_id < 0)


def quota_used_add_row(
    used: torch.Tensor,        # [G, R]
    request: torch.Tensor,     # [R]
    quota_id: torch.Tensor,    # 0-d int32
    ancestors: torch.Tensor,   # [G, D] int32
    apply: torch.Tensor,       # 0-d bool
) -> torch.Tensor:
    """Add the request along the ancestor chain when apply is set. The
    [G] multiplicity row sums the chain's [D, G] one-hot rows at once:
    sums of 0s and 1s, exact in any order."""
    G = ancestors.shape[0]
    chain = ancestors[torch.clamp_min(quota_id, 0).long()]
    groups = torch.arange(G, dtype=torch.int32, device=used.device)
    hit = (chain >= 0) & (quota_id >= 0) & apply                  # [D]
    onehot = torch.where(
        hit[:, None], (groups[None, :] == torch.clamp_min(chain, 0)[:, None])
        .to(torch.float32), 0.0).sum(dim=0)
    return used + onehot[:, None] * request[None, :]
