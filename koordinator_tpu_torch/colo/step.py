"""The device colo pass: the control plane's resource model as one tensor
pass on the card.

``build_colo_step`` runs the two koord-manager reconciler families the
device mirror never touched as one pass of PyTorch ops:

  * the slo-controller's NodeResource pipeline — the batch/mid overcommit
    formula of ``slocontroller/noderesource._batch_mid_kernel``, called on
    the card's tensors (the host oracle runs the same function on CPU
    tensors), with the staleness degrade folded in as ``degraded -> zero
    batch/mid rows`` exactly like the host controller's gather;
  * the quota-controller's elastic-quota runtime fairness — the
    ``ops/quota.compute_runtime_quotas`` level fold (auto-scaled mins +
    water-filling redistribution per (parent, resource) segment) expressed
    as segment ops over the packed tree, plus the over-runtime
    revoke-candidate mask the overuse loop consumes.

It repeats the JAX package's step (koordinator_tpu/colo/step.py, a
``jax.jit`` of plain ``jnp`` ops, not a Pallas kernel) field for field and
bit for bit. Decision-parity discipline (gated by
``pipeline_parity.run_colo_parity``):

  * the batch/mid arithmetic is one f32 op sequence on bit-identical
    packed rows, so the ``int()`` writeback truncation lands on the same
    integers;
  * the water-filling rounds are the host's own f32 arithmetic
    (``go_round_np`` is ``floor(x + 0.5)`` on f32 arrays), transcribed
    op for op; segment sums (``index_add_``, atomics on the card) are
    order-free because every packed quota quantity is integer-valued
    (milli-cores / MiB) and the reconciler's eligibility guard bounds
    per-parent sums under 2^24 — the f32 integer-exact envelope. Segment
    maxima (``scatter_reduce`` "amax" into a -inf buffer) are order-free
    anyway. Both scatter into gp + 1 rows: the last row takes the roots
    (no parent) and every row the JAX step's drop-mode scatter would
    drop, so no index falls outside a tensor;
  * the ONE float64 site in the host fold — ``scaled_min_level``'s
    ``floor(avail * min / en_sum)`` — is an exact integer floor-division
    for in-envelope operands, reproduced through an f32 quotient
    candidate plus an exact int64 correction (``_exact_floordiv``);
  * the water-filling loop runs a fixed number of iterations the host
    counts from the packed tree (``water_fill_plan``), so no launch of
    the pass reads a value back: the pass's one sync is the reconciler's
    readback under the dispatch watchdog.

Everything here is tensor ops on the inputs — no host loops over nodes or
quotas, no store reads (koordlint rule ``host-reconcile-in-colo-path``
pins that for this package).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

from koordinator_tpu_torch.api.resources import RESOURCE_INDEX, ResourceName
from koordinator_tpu_torch.ops.quota import MAX_QUOTA_DEPTH

CPU = RESOURCE_INDEX[ResourceName.CPU]
MEM = RESOURCE_INDEX[ResourceName.MEMORY]
BATCH_CPU_AXIS = RESOURCE_INDEX[ResourceName.BATCH_CPU]
BATCH_MEM_AXIS = RESOURCE_INDEX[ResourceName.BATCH_MEMORY]
MID_CPU_AXIS = RESOURCE_INDEX[ResourceName.MID_CPU]
MID_MEM_AXIS = RESOURCE_INDEX[ResourceName.MID_MEMORY]

# the tree levels the fold visits (root level 0 .. MAX_QUOTA_DEPTH)
NUM_LEVELS = MAX_QUOTA_DEPTH + 1

# the step's inputs, in call order
STEP_FIELDS = (
    "capacity", "node_reserved", "system_reserved", "node_used",
    "pod_all_used", "hp_used", "hp_request", "hp_max", "prod_reclaimable",
    "reclaim_pct", "mid_pct", "degraded",
    "q_parent", "q_level", "q_min", "q_max", "q_weight", "q_guarantee",
    "q_request", "q_used", "q_allow_lent", "q_enable_scale", "q_valid",
    "q_total_base")


class ColoOut(NamedTuple):
    """Outputs of one colo pass (tensors on the pass's device until the
    reconciler's readback). Node columns are the 4 allocatable vectors the
    writeback publishes; quota rows carry the runtime matrix and the
    revoke-candidate mask the overuse loop consumes."""

    batch_cpu: object     # [N] f32 — batch-cpu allocatable (milli)
    batch_mem: object     # [N] f32 — batch-memory allocatable (MiB)
    mid_cpu: object       # [N] f32
    mid_mem: object       # [N] f32
    n_degraded: object    # scalar i32 — staleness-degraded real nodes
    runtime: object       # [G, R] f32 — runtime quota per group
    revoke_over: object   # [G, R] f32 — max(used - runtime, 0)
    revoke_mask: object   # [G] bool  — any axis over runtime
    predicted_total: object  # [R] f32 — post-writeback cluster total
    #                          the runtime fold divided (verified by
    #                          the reconciler against the store)


def _seg_sum(x, seg, gp: int):
    """Per-parent sums into gp + 1 rows (the last takes the roots)."""
    import torch

    out = torch.zeros((gp + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, x)


def _seg_max(x, seg, gp: int):
    """Per-parent maxima into gp + 1 rows, -inf where a segment is empty."""
    import torch

    out = torch.full((gp + 1, x.shape[1]), float("-inf"), dtype=x.dtype,
                     device=x.device)
    return out.scatter_reduce_(0, seg[:, None].expand(-1, x.shape[1]), x,
                               "amax", include_self=True)


def _exact_floordiv(a, m, s):
    """``floor(a * m / s)`` computed EXACTLY for integer-valued f32
    operands with ``a, m < 2^24`` and ``m <= s`` wherever the result is
    consumed: an f32 quotient candidate (absolute error <= 3 after
    floor), then a correction over the candidates q0-3 .. q0+3 that keeps
    the largest q with ``a*m - q*s >= 0``. The JAX step forms ``a*m -
    q*s`` in int32 and relies on both products wrapping alike; here it is
    int64, where both products (below 2^48) are exact, so the difference
    is the true remainder with no wrap-around. Rows violating the
    preconditions are masked off by the caller (the reconciler's
    eligibility guard demotes out-of-envelope trees to the host oracle
    before this runs)."""
    import torch

    s1 = torch.clamp_min(s, 1.0)
    q0 = torch.floor(a * m / s1)
    am = a.to(torch.int64) * m.to(torch.int64)
    si = s1.to(torch.int64)
    best = torch.zeros_like(q0)
    # static 7-candidate unroll, not a host data loop
    # koordlint: disable=host-reconcile-in-colo-path
    for off in range(-3, 4):
        q = torch.clamp_min(q0 + off, 0.0)
        k = am - q.to(torch.int64) * si
        best = torch.where(k >= 0, torch.maximum(best, q), best)
    return best


def _scaled_min_level(total, parent, min_, enable, level, cur_level, gp):
    """Device twin of ops/quota.scaled_min_level: AutoScaleMin for the
    groups at ``cur_level``. The host's float64 segment sums are exact
    f32 under the eligibility envelope; the one genuine f64 computation
    (the proportional floor-division) goes through _exact_floordiv."""
    import torch

    active = level == cur_level
    seg = torch.where(parent >= 0, parent, gp).long()

    def seg_sum(mask):
        contrib = torch.where((active & mask)[:, None], min_, 0.0)
        return _seg_sum(contrib, seg, gp)

    en_sum = seg_sum(enable)
    dis_sum = seg_sum(~enable)
    seg_total = _seg_max(torch.where(active[:, None], total, float("-inf")),
                         seg, gp)
    seg_total = torch.where(torch.isfinite(seg_total), seg_total, 0.0)

    need_scale = (en_sum + dis_sum) > seg_total
    avail = torch.clamp_min(seg_total - dis_sum, 0.0)
    scaled = _exact_floordiv(avail[seg], min_, en_sum[seg])
    use = active[:, None] & enable[:, None] & need_scale[seg]
    return torch.where(use, scaled, min_)


def water_fill_plan(q_level, q_weight, q_valid, gp: int) -> tuple:
    """The water-filling iterations each tree level needs, counted on the
    host from the packed quota arrays (numpy): -1 for a level with no
    valid row (the fold skips it: it would change nothing), else
    ``min(b + 1, gp + 2)`` with b the most rows of that level with a
    positive weight on any one axis.

    Why that count is exact: the loop's adjustable set is ``over & active
    & weight > 0``, so per axis it has at most b rows, and the body treats
    the axes independently. On one axis, an iteration that leaves a
    positive leftover clamps at least one adjustable row to its request
    (the leftover is that row's overshoot), and the row leaves the set;
    an iteration that starts with no leftover or no adjustable row
    changes nothing (delta rounds ``0 + 0.5`` down to 0 and nothing
    overshoots). So an axis changes in its first b iterations at most,
    and the state after b or more iterations is the state the JAX step's
    ``lax.while_loop`` stops at (its cap, gp + 2, is never reached
    first). The +1 is a spare."""
    import numpy as np

    lv = np.asarray(q_level)
    sel = np.asarray(q_valid, bool) & (lv >= 0) & (lv < NUM_LEVELS)
    present = np.bincount(lv[sel], minlength=NUM_LEVELS) > 0
    counts = np.zeros((NUM_LEVELS, np.asarray(q_weight).shape[1]), np.int64)
    np.add.at(counts, lv[sel], np.asarray(q_weight)[sel] > 0)
    bound = np.minimum(counts.max(axis=1) + 1, gp + 2)
    return tuple(int(b) if p else -1 for b, p in zip(bound, present))


def _water_fill_level(total, parent, min_, guarantee, request, weight,
                      allow_lent, level, cur_level, gp, iterations: int):
    """Device twin of ops/quota.water_fill_level: one level of the
    iterated redistribution, the host's f32 op sequence transcribed. The
    JAX step stops its ``lax.while_loop`` once no row stays adjustable or
    no leftover remains, a test that would read the card every
    iteration; here the body runs ``iterations`` times, a count the host
    takes from the packed tree (``water_fill_plan`` says why the result
    is the loop's)."""
    import torch

    active = (level == cur_level)[:, None]
    eff_min = torch.maximum(min_, guarantee)
    over = request > eff_min
    base = torch.where(over, eff_min,
                       torch.where(allow_lent[:, None], request, eff_min))
    base = torch.where(active, base, 0.0)
    seg = torch.where(parent >= 0, parent, gp).long()
    adj = over & active & (weight > 0)

    spent = _seg_sum(base, seg, gp)
    seg_total = _seg_max(torch.where(active, total, float("-inf")), seg, gp)
    left = torch.clamp_min(seg_total - spent, 0.0)
    left = torch.where(torch.isfinite(left), left, 0.0)

    runtime = base
    # a fixed iteration count from the host (water_fill_plan), not a loop
    # over nodes or quotas; every op inside is a tensor op
    # koordlint: disable=host-reconcile-in-colo-path
    for _ in range(iterations):
        w = torch.where(adj, weight, 0.0)
        wsum = _seg_sum(w, seg, gp)[seg]
        delta = torch.where(
            (wsum > 0) & adj,
            torch.floor(weight * left[seg] / torch.clamp_min(wsum, 1e-9)
                        + 0.5),
            0.0)
        new_rt = runtime + delta
        overshoot = torch.clamp_min(new_rt - request, 0.0)
        # only adjustable rows clamp to request; a non-lent sibling sits
        # at eff_min > request and must keep it (host comment verbatim)
        new_rt = torch.where(adj, torch.minimum(new_rt, request), runtime)
        still = adj & (new_rt < request)
        left = _seg_sum(torch.where(adj, overshoot, 0.0), seg, gp)
        runtime, adj = new_rt, still
    return torch.where(active, runtime, 0.0)


def device_runtime_quotas(parent, level, q_min, q_max, weight, guarantee,
                          request, enable_scale, allow_lent, q_valid,
                          cluster_total, plan: Sequence[int],
                          scale_min_enabled: bool = True):
    """Device twin of ops/quota.compute_runtime_quotas: the top-down
    level fold over the bounded tree depth (MAX_QUOTA_DEPTH). ``plan``
    is ``water_fill_plan`` of the same arrays."""
    import torch

    gp = parent.shape[0]
    total_row = cluster_total.to(torch.float32)
    pidx = parent.clamp(0, gp - 1).long()
    runtime = torch.zeros_like(q_min)
    # static bounded-depth level loop (the host fold's), not a loop over
    # quotas; every op inside is a tensor op
    # koordlint: disable=host-reconcile-in-colo-path
    for lvl, iterations in enumerate(plan):
        if iterations < 0:
            continue  # no row at this level: the level changes nothing
        total = torch.where((parent >= 0)[:, None], runtime[pidx],
                            total_row[None, :])
        min_eff = (
            _scaled_min_level(total, parent, q_min, enable_scale, level,
                              lvl, gp)
            if scale_min_enabled else q_min)
        rt_lvl = _water_fill_level(total, parent, min_eff, guarantee,
                                   request, weight, allow_lent, level,
                                   lvl, gp, iterations)
        runtime = torch.where((level == lvl)[:, None], rt_lvl, runtime)
    runtime = torch.minimum(runtime, q_max)
    return torch.where(q_valid[:, None], runtime, 0.0)


def build_colo_step(cpu_policy: str, memory_policy: str,
                    scale_min_enabled: bool = True, device="cuda"):
    """The colo pass for a (cpu, memory) calculate-policy pair, on
    ``device``. The policies are host strings: the pick is a column copy
    chosen when the pass runs, as the JAX step's static arguments make it.

    The returned ``step(*arrays, plan=...)`` takes padded tensors on
    ``device``, in ``STEP_FIELDS`` order, and raises for a tensor anywhere
    else (pad nodes: all-zero rows with ``degraded`` False — the batch/mid
    formula yields 0; pad quota rows: ``level`` -1 and ``q_valid`` False —
    never active at any level):

      node axis [N, R] f32: capacity, node_reserved, system_reserved,
        node_used, pod_all_used, hp_used, hp_request, hp_max,
        prod_reclaimable, reclaim_pct, mid_pct; degraded [N] bool
      quota axis: q_parent/q_level [G] i32, q_min/q_max/q_weight/
        q_guarantee/q_request/q_used [G, R] f32, q_allow_lent/
        q_enable_scale/q_valid [G] bool; q_total_base [R] f32

    ``plan`` is ``water_fill_plan`` of the host's quota arrays.
    ``q_total_base`` is the cluster allocatable total with the four
    overcommit axes ZEROED: the runtime fold divides the PREDICTED
    post-writeback total — base axes from the store, batch/mid axes
    re-derived from this pass's own truncated columns — because in the
    host world the noderesource writeback lands BEFORE the revoke loop
    computes runtime, and the device pass must match that ordering
    inside one pass.
    """
    import torch

    from koordinator_tpu_torch.slocontroller.noderesource import (
        _batch_mid_kernel,
    )

    dev = torch.device(device)
    axes = [BATCH_CPU_AXIS, BATCH_MEM_AXIS, MID_CPU_AXIS, MID_MEM_AXIS]

    def step(*args, plan: Sequence[int]):
        if len(args) != len(STEP_FIELDS):
            raise TypeError(f"colo step takes {len(STEP_FIELDS)} arrays, "
                            f"got {len(args)}")
        stray = [f"{name} on {t.device}"
                 for name, t in zip(STEP_FIELDS, args)
                 if t.device.type != dev.type]
        if stray:
            raise ValueError(f"colo step built for {dev}: "
                             + ", ".join(stray))
        (capacity, node_reserved, system_reserved, node_used, pod_all_used,
         hp_used, hp_request, hp_max, prod_reclaimable, reclaim_pct,
         mid_pct, degraded, q_parent, q_level, q_min, q_max, q_weight,
         q_guarantee, q_request, q_used, q_allow_lent, q_enable_scale,
         q_valid, q_total_base) = args
        # ---- batch/mid: the host oracle's own function on these tensors
        batch, mid = _batch_mid_kernel(
            capacity, node_reserved, system_reserved, node_used,
            pod_all_used, hp_used, hp_request, hp_max, prod_reclaimable,
            reclaim_pct, mid_pct, degraded,
            cpu_policy=cpu_policy, memory_policy=memory_policy)

        # ---- predicted post-writeback cluster total: the writeback
        # publishes int(column) per node (truncation = floor for these
        # nonnegative values), so the new overcommit-axis totals are the
        # floored column sums — exact f32 under the eligibility envelope
        cols = torch.stack((batch[:, CPU], batch[:, MEM], mid[:, CPU],
                            mid[:, MEM]), dim=1)
        predicted_total = q_total_base.clone()
        predicted_total[axes] = torch.floor(cols).sum(dim=0)

        # ---- quota runtime fold + the revoke-candidate mask
        runtime = device_runtime_quotas(
            q_parent, q_level, q_min, q_max, q_weight, q_guarantee,
            q_request, q_enable_scale, q_allow_lent, q_valid,
            predicted_total, plan, scale_min_enabled=scale_min_enabled)
        revoke_over = torch.where(q_valid[:, None],
                                  torch.clamp_min(q_used - runtime, 0.0),
                                  0.0)
        revoke_mask = torch.any(revoke_over > 0, dim=-1) & q_valid

        return ColoOut(
            batch_cpu=batch[:, CPU], batch_mem=batch[:, MEM],
            mid_cpu=mid[:, CPU], mid_mem=mid[:, MEM],
            n_degraded=degraded.sum(dtype=torch.int32),
            runtime=runtime, revoke_over=revoke_over,
            revoke_mask=revoke_mask, predicted_total=predicted_total)

    return step
