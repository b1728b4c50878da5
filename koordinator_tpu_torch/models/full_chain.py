"""Full plugin-chain scheduling round (BASELINE config 4), in torch.

One round walks the pending pods in queue order; each pod runs

  PreFilter   gang validity (host precompute) + quota admission (order
              dependent: each pod reads the usage the pods before it added)
  Filter      NodeResourcesFit + LoadAware thresholds + cpuset/SMT + NUMA
              admit + taints + NodePorts + CSI volume limit + inter-pod
              affinity, anti-affinity, symmetric anti-affinity and spread
  Score       LoadAware + NodeNUMAResource least-allocated, balanced
              allocation, preferred node affinity, preferred pod affinity
              (max-min normalized), image locality
  Select      lowest-index argmax
  Reserve     Fit requested, LoadAware deltas, NUMA zone free, bindable
              cpus, ports, volume headroom, quota used, affinity counts

against all nodes at once, and the gang Permit barrier runs as a post-pass.
`build_full_chain_step` is the plain version: a Python loop over pods on
tensors, the same operations in the same order as the JAX package's XLA step,
so bindings are bit-identical. `build_best_full_chain_step` picks the CUDA
kernel (ops/full_chain_kernel.py) for tensors on the card and the plain
version for tensors on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from koordinator_tpu_torch.api.resources import RESOURCE_INDEX, ResourceName
from koordinator_tpu_torch.models.scheduler_model import (
    ScheduleInputs,
    _score_row,
    node_rejects,
    resolve_weight_idx,
)
from koordinator_tpu_torch.ops.fit import fit_ok_row
from koordinator_tpu_torch.ops.gang import gang_permit_mask
from koordinator_tpu_torch.ops.kernel_common import SyncClock, safe_reciprocal
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.ops.numa import (
    cpuset_filter_row,
    numa_admit_row,
    numa_score_row,
    numa_spread_fill,
)
from koordinator_tpu_torch.ops.quota import quota_admit_row, quota_used_add_row


class FullChainInputs(NamedTuple):
    """The packed round: numpy from the host pack, torch on the device the
    round runs on. Field meanings follow the JAX package's FullChainInputs."""

    base: ScheduleInputs
    # pods
    requests: torch.Tensor       # [P, R] raw requests (quota/NUMA accounting)
    gang_id: torch.Tensor        # [P] int32
    quota_id: torch.Tensor       # [P] int32
    needs_numa: torch.Tensor     # [P] bool
    needs_bind: torch.Tensor     # [P] bool — requires cpuset binding
    cores_needed: torch.Tensor   # [P] f32 — whole cpus for cpuset pods
    full_pcpus: torch.Tensor     # [P] bool
    pod_taint_mask: torch.Tensor  # [P] f32 bitmask of admitted node groups
    pod_aff_req: torch.Tensor    # [P, T] bool — required pod-affinity terms
    pod_anti_req: torch.Tensor   # [P, T] bool — required anti-affinity terms
    pod_aff_match: torch.Tensor  # [P, T] bool — pod's labels match term
    pod_spread_skew: torch.Tensor  # [P, T] f32 — DoNotSchedule maxSkew
    pod_pref_id: torch.Tensor    # [P] int32 preferred-affinity profile (-1)
    pod_ppref_id: torch.Tensor   # [P] int32 preferred pod-affinity profile
    pod_ppref_mask: torch.Tensor  # [P, T] bool — terms the profile weighs
    pod_port_wants: torch.Tensor  # [P, PT] bool — hostPort slots requested
    vol_needed: torch.Tensor     # [P, VG] f32 — new attachments per group
    pod_img_id: torch.Tensor     # [P] int32 ImageLocality profile (-1)
    # nodes
    node_taint_group: torch.Tensor  # [N] int32 admission-signature group
    aff_dom: torch.Tensor        # [N, T] f32 topology domain id (-1 invalid)
    aff_count: torch.Tensor      # [N, T] f32 matching pods in n's domain
    anti_cover: torch.Tensor     # [N, T] f32 anti-term carriers in domain
    aff_exists: torch.Tensor     # [T] bool — any matching pod anywhere
    pref_scores: torch.Tensor    # [N, S] f32 preferred-node-affinity rows
    port_used: torch.Tensor      # [N, PT] f32 — hostPort slot in use
    vol_free: torch.Tensor       # [N] f32 — attachable CSI volumes left
    node_vol_group: torch.Tensor  # [N] int32 volume-group id
    img_scores: torch.Tensor     # [N, SI] f32 ImageLocality rows
    ppref_w: torch.Tensor        # [max(S2,1), max(T,1)] f32 term weights
    numa_free: torch.Tensor      # [N, K, R]
    numa_capacity: torch.Tensor  # [N, K, R]
    numa_policy: torch.Tensor    # [N] int32
    has_topology: torch.Tensor   # [N] bool
    bind_free: torch.Tensor      # [N] f32
    cpus_per_core: torch.Tensor  # [N] f32
    # quota tree
    quota_ancestors: torch.Tensor  # [G, D] int32
    quota_used: torch.Tensor       # [G, R]
    quota_runtime: torch.Tensor    # [G, R]
    # gangs
    gang_min_member: torch.Tensor  # [NG]
    gang_assumed: torch.Tensor     # [NG]
    gang_valid: torch.Tensor       # [NG] bool (PreFilter validity)
    gang_group_id: torch.Tensor    # [NG] int32


def resolve_balance_idx(active_axes):
    """(cpu_axis, mem_axis) positions after active-axes slicing, for the
    NodeResourcesBalancedAllocation score; (-1, -1) when either axis was
    sliced away (the score contributes 0 then — upstream needs both)."""
    cpu = RESOURCE_INDEX[ResourceName.CPU]
    mem = RESOURCE_INDEX[ResourceName.MEMORY]
    if active_axes is None:
        return cpu, mem
    axes = [int(a) for a in active_axes]
    if cpu in axes and mem in axes:
        return axes.index(cpu), axes.index(mem)
    return -1, -1


def pod_independent_rows(fc: FullChainInputs):
    """The round's rows that no pod's Reserve changes, computed once before
    the pod loop: (reject_nonprod[N], reject_prod[N]) LoadAware threshold
    rejects and gang_pod_ok[P], each pod's gang PreFilter validity."""
    reject_np, reject_prod = node_rejects(fc.base)
    gang_pod_ok = torch.where(
        fc.gang_id >= 0, fc.gang_valid[torch.clamp_min(fc.gang_id, 0).long()],
        True)
    return reject_np, reject_prod, gang_pod_ok


def make_pod_evaluator(fc: FullChainInputs, weight_idx, prod_mode,
                       bal_idx=(-1, -1)):
    """The per-pod PreFilter + Filter + Score + select math of the plain
    round. Returns evaluate(i, *state) -> (found, best, zone_at_best), all
    0-d tensors: nothing is read back to the host, so on the card the loop
    queues its work without a sync per pod."""
    inputs = fc.base
    reject_np, reject_prod, gang_pod_ok = pod_independent_rows(fc)
    T = fc.aff_dom.shape[1]
    PT = fc.port_used.shape[1]
    node_vol_group = fc.node_vol_group.long()
    dom_valid = fc.aff_dom >= 0                                  # [N, T]
    if bal_idx[0] >= 0:
        bal_inv_c, bal_inv_m = (
            safe_reciprocal(inputs.allocatable[:, axis]) for axis in bal_idx)

    def evaluate(i, requested, delta_np, delta_pr, numa_free, bind_free,
                 quota_used, aff_count, anti_cover, aff_exists, port_used,
                 vol_free):
        req_fit = inputs.fit_requests[i]
        req = fc.requests[i]
        est = inputs.estimated[i]
        is_prod_i = inputs.is_prod[i]

        # ---- PreFilter: gang validity + quota admission (order-dependent)
        quota_ok = quota_admit_row(
            req, fc.quota_id[i], fc.quota_ancestors, quota_used,
            fc.quota_runtime)
        admit = gang_pod_ok[i] & quota_ok

        # ---- Filter chain
        fit = fit_ok_row(req_fit, inputs.allocatable, requested)
        la_reject = torch.where(is_prod_i, reject_prod, reject_np)
        la_ok = inputs.is_daemonset[i] | ~la_reject
        cpuset_ok = cpuset_filter_row(
            fc.needs_bind[i], fc.cores_needed[i], fc.full_pcpus[i],
            fc.has_topology, bind_free, fc.cpus_per_core)
        numa_ok, zone = numa_admit_row(
            req, fc.needs_numa[i], numa_free, fc.numa_policy)
        # TaintToleration: the pod's admission bitmask holds the node's group
        taint_ok = ((fc.pod_taint_mask[i].to(torch.int32)
                     >> fc.node_taint_group) & 1) == 1
        # InterPodAffinity: required anti terms see an empty domain; required
        # affinity terms a match in a valid domain, or bootstrap (self-match
        # with no matching pod anywhere); symmetric anti-affinity; spread
        affinity_ok = torch.ones_like(taint_ok)
        for t in range(T):
            count_t = aff_count[:, t]
            dom_valid_t = dom_valid[:, t]
            match_t = fc.pod_aff_match[i, t]
            anti_ok = ~fc.pod_anti_req[i, t] | (count_t <= 0)
            sym_ok = ~match_t | (anti_cover[:, t] <= 0)
            bootstrap = match_t & ~aff_exists[t]
            aff_ok = (~fc.pod_aff_req[i, t] | (dom_valid_t & (count_t > 0))
                      | bootstrap)
            # PodTopologySpread (DoNotSchedule): count + self - min over the
            # domains the pod is eligible for must stay within maxSkew
            skew = fc.pod_spread_skew[i, t]
            self_match = torch.where(match_t, 1.0, 0.0)
            min_count = torch.where(
                dom_valid_t & taint_ok, count_t, float("inf")).min()
            spread_ok = (skew <= 0) | (
                dom_valid_t & (count_t + self_match - min_count <= skew))
            affinity_ok = affinity_ok & anti_ok & sym_ok & aff_ok & spread_ok
        # NodePorts: no requested hostPort slot may already be bound
        ports_ok = torch.ones_like(taint_ok)
        for s in range(PT):
            ports_ok = ports_ok & (
                ~fc.pod_port_wants[i, s] | (port_used[:, s] <= 0))
        # NodeVolumeLimits: new attachments per node volume group
        vn = fc.vol_needed[i][node_vol_group]
        vol_ok = (vn <= 0) | (vol_free >= vn)
        feasible = (inputs.node_ok & fit & la_ok & cpuset_ok & numa_ok
                    & taint_ok & affinity_ok & ports_ok & vol_ok & admit)

        # ---- Score chain (equal plugin weights, each already 0..100)
        la_score = _score_row(est, is_prod_i, inputs, delta_np, delta_pr,
                              weight_idx, prod_mode)
        numa_score = numa_score_row(req, requested, inputs.allocatable,
                                    inputs.weights, weight_idx)
        # NodeResourcesBalancedAllocation: for two axes the std reduces to
        # |fc - fm| / 2; fractions clamp to 1, a zero-capacity axis gives 0
        if bal_idx[0] >= 0:
            ci, mi = bal_idx

            def _frac(axis, inv):
                return torch.clamp_max(
                    (requested[:, axis] + req_fit[axis]) * inv, 1.0)

            std = (_frac(ci, bal_inv_c) - _frac(mi, bal_inv_m)).abs() * 0.5
            numa_score = numa_score + torch.floor((1.0 - std) * 100.0)
        # preferred node affinity: a static profile row (0 without one)
        if fc.pref_scores.shape[1]:
            pid = fc.pod_pref_id[i]
            pref = torch.where(
                pid >= 0, fc.pref_scores[:, torch.clamp_min(pid, 0).long()],
                0.0)
        else:
            pref = torch.zeros_like(la_score)
        # preferred POD affinity: weighted matching-pod counts, max-min
        # normalized over node_ok nodes (upstream NormalizeScore)
        sid2 = fc.pod_ppref_id[i]
        if T and fc.ppref_w.shape[0]:
            w_row = fc.ppref_w[torch.clamp_min(sid2, 0).long(), :T]
            raw = (aff_count * w_row[None, :]).sum(dim=1)
            mx = torch.where(inputs.node_ok, raw, float("-inf")).max()
            mn = torch.where(inputs.node_ok, raw, float("inf")).min()
            norm = torch.where(
                mx > mn, torch.floor((raw - mn) * 100.0 / (mx - mn)), 0.0)
            pref = pref + torch.where(sid2 >= 0, norm, 0.0)
        # ImageLocality: static profile rows, like preferred node affinity
        if fc.img_scores.shape[1]:
            iid = fc.pod_img_id[i]
            pref = pref + torch.where(
                iid >= 0, fc.img_scores[:, torch.clamp_min(iid, 0).long()],
                0.0)
        score = la_score + numa_score + pref
        score = torch.where(feasible, score, -1.0)

        # ---- select: argmax returns the first maximal index (lowest-index
        # tie-break, the binding contract)
        best = torch.argmax(score)
        found = (score[best] >= 0.0) & inputs.pod_valid[i]
        return found, best, zone[best]

    return evaluate


def commit_pod_state(fc: FullChainInputs, prod_mode: bool, state, i, found,
                     best, zone_at_best):
    """Apply pod ``i``'s tentative binding to the round state, in place.

    ``state`` is the 11-tuple (requested, delta_np, delta_pr, numa_free,
    bind_free, quota_used, aff_count, anti_cover, aff_exists, port_used,
    vol_free); every tensor in it is the round's own copy, so updating in
    place saves a copy of each per pod. Returns the state (quota_used is
    replaced, not updated)."""
    inputs = fc.base
    (requested, delta_np, delta_pr, numa_free, bind_free, quota_used,
     aff_count, anti_cover, aff_exists, port_used, vol_free) = state
    T = fc.aff_dom.shape[1]
    PT = fc.port_used.shape[1]
    req_fit = inputs.fit_requests[i]
    req = fc.requests[i]
    est = inputs.estimated[i]
    fnd = found.to(torch.float32)

    requested[best] = requested[best] + fnd * req_fit
    delta_np[best] = delta_np[best] + fnd * est
    if prod_mode:
        delta_pr[best] = delta_pr[best] + fnd * (
            torch.where(inputs.is_prod[i], 1.0, 0.0) * est)
    new_zone_free = numa_spread_fill(numa_free[best], req, zone_at_best)
    apply_numa = found & fc.needs_numa[i]
    numa_free[best] = torch.where(apply_numa, new_zone_free, numa_free[best])
    bind_free[best] = bind_free[best] - fnd * torch.where(
        fc.needs_bind[i], fc.cores_needed[i], 0.0)
    if PT:
        port_used[best] = torch.maximum(
            port_used[best], fnd * fc.pod_port_wants[i].to(torch.float32))
    vol_free[best] = vol_free[best] - fnd * fc.vol_needed[i][
        fc.node_vol_group[best].long()]
    quota_used = quota_used_add_row(
        quota_used, req, fc.quota_id[i], fc.quota_ancestors, found)
    # inter-pod affinity: the placed pod raises the count of every term it
    # matches across the chosen node's whole domain, latches the term's
    # exists flag (even on an unlabeled node), and raises anti_cover for the
    # terms it carries as required anti-affinity
    for t in range(T):
        chosen_dom = fc.aff_dom[best, t]
        in_dom = (chosen_dom >= 0) & (fc.aff_dom[:, t] == chosen_dom)
        match_t = found & fc.pod_aff_match[i, t]
        aff_count[:, t] += (match_t & in_dom).to(torch.float32)
        anti_cover[:, t] += (found & fc.pod_anti_req[i, t] & in_dom).to(
            torch.float32)
        aff_exists[t] = aff_exists[t] | match_t
    return (requested, delta_np, delta_pr, numa_free, bind_free, quota_used,
            aff_count, anti_cover, aff_exists, port_used, vol_free)


def build_full_chain_step(args: LoadAwareArgs, num_gangs: int,
                          num_groups: int, active_axes=None):
    """The plain round: FullChainInputs (torch) -> (chosen[P] int32,
    requested[N, R], quota_used[G, R]) on the inputs' device.

    num_gangs/num_groups size the Permit segment sums. active_axes: when the
    inputs were sliced to the active resource axes
    (snapshot.reduce_to_active_axes), the original axis ids, so the weight
    and balanced-allocation axes map correctly."""
    weight_idx = resolve_weight_idx(args, active_axes)
    bal_idx = resolve_balance_idx(active_axes)
    prod_mode = args.score_according_prod_usage

    def step(fc: FullChainInputs):
        inputs = fc.base
        P, R = inputs.fit_requests.shape
        N = inputs.allocatable.shape[0]
        dev = inputs.allocatable.device
        evaluate = make_pod_evaluator(fc, weight_idx, prod_mode, bal_idx)
        state = (
            inputs.requested.clone(),
            torch.zeros((N, R), dtype=torch.float32, device=dev),
            torch.zeros((N, R), dtype=torch.float32, device=dev),
            fc.numa_free.clone(),
            fc.bind_free.clone(),
            fc.quota_used.clone(),
            fc.aff_count.clone(),
            fc.anti_cover.clone(),
            fc.aff_exists.to(torch.bool).clone(),
            fc.port_used.clone(),
            fc.vol_free.clone(),
        )
        chosen = torch.full((P,), -1, dtype=torch.int32, device=dev)
        for i in range(P):
            found, best, zone_at_best = evaluate(i, *state)
            state = commit_pod_state(fc, prod_mode, state, i, found, best,
                                     zone_at_best)
            chosen[i] = torch.where(found, best.to(torch.int32), -1)
        return permit(fc, chosen, num_gangs, num_groups), state[0], state[5]

    step.last_backend = "serial"
    return step


def permit(fc: FullChainInputs, chosen: torch.Tensor, num_gangs: int,
           num_groups: int) -> torch.Tensor:
    """Gang Permit barrier (all-or-nothing per gang group) over a round's
    tentative bindings."""
    keep = gang_permit_mask(
        chosen, fc.gang_id, fc.gang_min_member, fc.gang_assumed,
        fc.gang_group_id, num_gangs, num_groups)
    return torch.where(keep, chosen, -1)


def build_best_full_chain_step(args: LoadAwareArgs, num_gangs: int,
                               num_groups: int, active_axes=None,
                               kernel: str = "auto", explain=None,
                               smem_budget_bytes=None):
    """Device-aware selector with the plain round's contract: the CUDA
    kernel (ops/full_chain_kernel.py) for inputs on the card, the plain
    round for inputs on the CPU. The choice reads only the inputs' device,
    never their values.

    ``smem_budget_bytes`` is the counterpart of the JAX selector's
    ``vmem_budget_bytes``: the shared memory one block of the kernel's
    cluster may take (None: the card's 227 KB). Where the kernel's
    shared-memory layout (``estimate_smem_bytes``, from the shapes alone)
    exceeds it, the same kernel keeps its carried state in device memory;
    no size sends a CUDA batch to the plain round. ``step.last_state`` says
    which state the last CUDA round kept ("smem" or "global").

    ``kernel="serial"`` forces the plain round on any device; "auto" is the
    selection above. The wave kernel and explain attribution come with a
    later slice of the port."""
    if explain is not None:
        raise NotImplementedError(
            "explain attribution comes with a later slice of the port "
            "(the explain-enabled round and diagnose)")
    if kernel == "wave":
        raise NotImplementedError(
            "kernel='wave' comes with a later slice of the port "
            "(models/wave_chain.py)")
    if kernel not in ("auto", "serial"):
        raise ValueError(f"unknown kernel {kernel!r}")
    plain = build_full_chain_step(args, num_gangs, num_groups,
                                  active_axes=active_axes)
    if kernel == "serial":
        return plain
    from koordinator_tpu_torch.ops.full_chain_kernel import (
        build_cuda_full_chain_step,
    )

    cuda_step = build_cuda_full_chain_step(
        args, num_gangs, num_groups, active_axes=active_axes,
        smem_budget_bytes=smem_budget_bytes)

    def step(fc: FullChainInputs, timings=None):
        """``timings``: a dict that the round fills with the seconds of
        its stages (round, and permit for the kernel's round),
        synchronising between them."""
        if fc.base.allocatable.is_cuda:
            step.last_backend = "cuda"
            out = cuda_step(fc, timings=timings)
            step.last_state = cuda_step.last_state
            return out
        step.last_backend = "serial"
        step.last_state = None
        clock = SyncClock(timings, fc.base.allocatable.device)
        out = plain(fc)
        clock.lap("round")
        return out

    step.last_backend = None
    step.last_state = None
    return step
