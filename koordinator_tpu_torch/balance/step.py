"""The rebalance pass: LowNodeLoad as one batched tensor pass on the card.

``build_rebalance_step`` returns node classification, per-node overload
margins and the greedy victim selection over the packed arrays
(balance/pack.py), with the selected (node_idx, pod_idx, score) triples
compacted to the front — the device twin of the host oracle
``LowNodeLoad.select_victims_host`` (descheduler/lownodeload.py), which
stays the reference it is held against. It repeats the JAX package's
step (koordinator_tpu/balance/step.py, a ``jax.jit`` of plain ``jnp``
ops, not a Pallas kernel) as plain PyTorch ops, field for field and bit
for bit:

  * the victim ORDER is the host's stable lexsort (node, priority asc,
    cpu desc, slot order as the tiebreak), reproduced as three chained
    stable argsorts plus a candidates-first pass — a stable sort of the
    full padded axis restricted to candidate rows IS the stable sort of
    the compressed candidate array. The cpu key is ``0.0 - pod_cpu``,
    which turns a 0.0 into +0.0 (``-pod_cpu`` would make it -0.0), so
    the pad rows' zeros tie whatever the sort does with signed zeros;
  * the freed-requests prefix runs as ONE global cumsum minus segment
    offsets. The JAX step accumulates in int32 and relies on modular
    arithmetic; this one accumulates in int64, which gives the same
    per-segment differences whenever a segment's freed total is below
    2^31 (the rebalancer's ``_device_eligible`` guarantees far less) and
    needs no signed wrap-around on the card;
  * the still-over threshold compare reproduces the host's float64
    comparison through a two-limb split: the host precomputes
    rhs = (usage_pct - high_thr) * alloc in float64 per node (tiny
    [N, R]) and ships (hi, lo) float32 limbs; the pass tests
    ``X < hi  or  (X == hi and lo > 0)``, which for the exactly-
    representable integer X = freed*100 decides ``X < rhs_f64`` exactly;
  * the compacted outputs scatter into buffers of length P + 1 whose
    last slot takes every unselected row and is sliced away: no index
    ever falls outside a tensor (the JAX step's drop-mode scatter has no
    torch counterpart, and an out-of-range index on the card is a
    device-side assert).

Everything here is tensor ops on the inputs — no host loops, no store
reads, no sync (koordlint's host-loop-in-rebalance-path pins the first
two for this package). On the card the pass is some fifty small
launches, four of them stable sorts over the padded pod axis.
"""

from __future__ import annotations

from typing import NamedTuple


class RebalanceOut(NamedTuple):
    """Outputs of one rebalance pass (tensors on the pass's device until
    the rebalancer's readback). ``sel_*`` are compacted: the first
    ``sel_count`` entries are the selected victims in host victim order;
    the tail is -1/0 padding."""

    is_low: object       # [N] bool — below low thresholds on every axis
    is_high: object      # [N] bool — above high thresholds on any axis
    margin: object       # [N] f32  — max checked-axis overload (>= 0)
    cand_count: object   # scalar i32 — movable pods on overloaded nodes
    sel_count: object    # scalar i32 — victims selected
    sel_pod: object      # [P] i32  — pack slot index of victim j (-1 pad)
    sel_node: object     # [P] i32  — node index of victim j (-1 pad)
    sel_score: object    # [P] f32  — victim-order key (cpu request)


# the step's inputs, in call order
STEP_FIELDS = ("usage_pct", "has_metric", "low_thr", "high_thr", "rhs_hi",
               "rhs_lo", "pod_node", "pod_prio", "pod_cpu", "pod_req_i",
               "pod_ok")


def build_rebalance_step(max_evict_per_node: int, device="cuda"):
    """The rebalance pass for a per-node eviction cap, on ``device``.

    The returned step takes padded tensors on ``device`` (pad pods:
    ``pod_ok`` False; pad nodes: ``has_metric`` False — both make the
    row inert, the same bucket-pad semantics the scheduler kernels use)
    and raises for a tensor anywhere else:

      usage_pct [N, R] f32, has_metric [N] bool,
      low_thr [R] f32, high_thr [R] f32,
      rhs_hi [N, R] f32, rhs_lo [N, R] f32   (host float64 limb split),
      pod_node [P] i32, pod_prio [P] i32, pod_cpu [P] f32,
      pod_req_i [P, R] i32, pod_ok [P] bool  (alive & movable)
    """
    import torch

    cap = int(max_evict_per_node)
    dev = torch.device(device)

    def step(usage_pct, has_metric, low_thr, high_thr, rhs_hi, rhs_lo,
             pod_node, pod_prio, pod_cpu, pod_req_i, pod_ok):
        args = (usage_pct, has_metric, low_thr, high_thr, rhs_hi, rhs_lo,
                pod_node, pod_prio, pod_cpu, pod_req_i, pod_ok)
        stray = [f"{name} on {t.device}"
                 for name, t in zip(STEP_FIELDS, args)
                 if t.device.type != dev.type]
        if stray:
            raise ValueError(f"rebalance step built for {dev}: "
                             + ", ".join(stray))
        N = usage_pct.shape[0]
        P = pod_node.shape[0]
        # ---- classification (classify_nodes, vectorized identically)
        checked_l = low_thr > 0
        low = torch.all(~checked_l | (usage_pct < low_thr),
                        dim=-1) & has_metric
        checked_h = high_thr > 0
        over = usage_pct - high_thr
        high = torch.any(checked_h & (over > 0.0), dim=-1) & has_metric
        is_low = low & ~high
        is_high = high
        # the max over the checked axes with 0.0 as the identity (the JAX
        # step's max(initial=0.0, where=checked_h))
        margin = torch.where(
            has_metric,
            torch.where(checked_h, over, 0.0).amax(dim=-1).clamp_min(0.0),
            0.0)
        # host early-outs become a pass-wide gate: no high or no low
        # nodes -> zero candidates -> empty selection
        active = torch.any(is_high) & torch.any(is_low)
        # the host's over_gate spans ALL axes (unchecked thresholds are
        # 0, so any positive usage passes) — replicate verbatim
        over_gate = torch.any(over > 0.0, dim=-1)
        node_ok = is_high & over_gate
        node_c = pod_node.long().clamp(0, N - 1)
        cand = pod_ok & (pod_node >= 0) & node_ok[node_c] & active
        cand_count = cand.sum(dtype=torch.int32)

        # ---- victim order: stable lexsort (node, prio asc, cpu desc)
        # over the candidate rows. Least-significant key first, then a
        # candidates-first pass pushes pad/non-candidate rows to the
        # tail without perturbing the candidates' relative order.
        idx = torch.arange(P, dtype=torch.int64, device=pod_node.device)
        order = torch.argsort(0.0 - pod_cpu, stable=True)
        order = order[torch.argsort(pod_prio[order], stable=True)]
        order = order[torch.argsort(pod_node[order], stable=True)]
        order = order[torch.argsort((~cand[order]).to(torch.int32),
                                    stable=True)]
        cs = cand[order]
        node_s = pod_node[order]

        # ---- per-node segments over the sorted candidate prefix
        seg_start = cs & ((idx == 0) | (node_s != torch.roll(node_s, 1)))
        start_pos = torch.cummax(
            torch.where(seg_start, idx, -1), dim=0).values
        sp = start_pos.clamp_min(0)
        rank = idx - start_pos

        # ---- exclusive freed-requests prefix per segment; non-candidate
        # rows contribute zero so the candidate prefix matches the
        # compressed host array (int64: see the module docstring)
        reqs_s = torch.where(cs[:, None], pod_req_i[order].long(), 0)
        gcum = torch.cumsum(reqs_s, dim=0)
        excl = gcum - reqs_s
        freed = excl - excl[sp]
        X = freed.to(torch.float32) * 100.0

        # ---- still-over: the host's float64 "freed*100 < rhs" compare,
        # decided exactly via the (hi, lo) limb split
        ns = node_s.long().clamp(0, N - 1)
        rh = rhs_hi[ns]
        rl = rhs_lo[ns]
        lt = (X < rh) | ((X == rh) & (rl > 0.0))
        still_over = torch.any(lt & checked_h, dim=-1)

        # ---- greedy selection: candidate k is taken iff every earlier
        # candidate in its segment (and k itself) kept the node over,
        # and its rank is under the per-node cap — the prefix-AND as a
        # cumsum-of-failures == 0 test, exactly the host formulation
        fail_i = torch.where(cs, (~still_over).long(), 0)
        fails_g = torch.cumsum(fail_i, dim=0)
        seg_base = fails_g[sp] - fail_i[sp]
        prefix_ok = (fails_g - seg_base) == 0
        selected = cs & prefix_ok & (rank < cap)

        # ---- compacted readback: the selected triples to the front;
        # every other row writes slot P, which is sliced away
        sel_rank = torch.cumsum(selected.long(), dim=0) - 1
        sel_count = selected.sum(dtype=torch.int32)
        tgt = torch.where(selected, sel_rank, P)

        def compact(values, fill):
            buf = torch.full((P + 1,), fill, dtype=values.dtype,
                             device=values.device)
            return buf.index_put_((tgt,), values)[:P]

        sel_pod = compact(order.to(torch.int32), -1)
        sel_node = compact(node_s.to(torch.int32), -1)
        sel_score = compact(pod_cpu[order], 0.0)
        return RebalanceOut(is_low, is_high, margin, cand_count,
                            sel_count, sel_pod, sel_node, sel_score)

    return step


def split_rhs_limbs(usage_pct, alloc, high_thr):
    """Host-side float64 rhs = (usage_pct - high_thr) * max(alloc, 1e-9)
    per node, split into (hi, lo) float32 limbs for the exact device
    compare. Vectorized numpy — tiny [N, R] work, no per-node loop."""
    import numpy as np

    rhs = ((usage_pct.astype(np.float64) - high_thr.astype(np.float64))
           * np.maximum(alloc, np.float32(1e-9)).astype(np.float64))
    hi = rhs.astype(np.float32)
    lo = (rhs - hi.astype(np.float64)).astype(np.float32)
    return hi, lo
