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

koordexplain attribution (``explain="counts"|"full"``) adds outputs only:
the per-stage reject counts of every pod at the cycle-start state
(``explain_stage_counts``; on the card the CUDA pass of
ops/explain_kernel.py) and, at "full", each pod's decision-time score terms
(on the card the full-chain kernel's terms instance). Bindings stay
byte-identical to explain off.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from koordinator_tpu_torch.api.resources import RESOURCE_INDEX, ResourceName
from koordinator_tpu_torch.models.scheduler_model import (
    ScheduleInputs,
    node_rejects,
    resolve_weight_idx,
)
from koordinator_tpu_torch.ops.common import MAX_NODE_SCORE
from koordinator_tpu_torch.ops.fit import fit_ok_row
from koordinator_tpu_torch.ops.gang import gang_permit_mask
from koordinator_tpu_torch.ops.kernel_common import SyncClock, safe_reciprocal
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.ops.numa import (
    POLICY_NONE,
    POLICY_SINGLE_NUMA_NODE,
    cpuset_filter_row,
    numa_admit_row,
    numa_spread_fill,
    zone_total,
)
from koordinator_tpu_torch.ops.quota import quota_admit_row, quota_used_add_row

# koordexplain: the per-filter-stage reject taxonomy shared by the
# attribution pass (explain_stage_counts and its CUDA pass,
# csrc/explain_counts.cu), the host-numpy oracle (scheduler/diagnose.py
# host_stage_counts) and the /explain surfaces. ORDER IS LOAD-BEARING: it is
# the insertion order of diagnose.py's reasons dict, and format_stage_counts
# relies on a stable sort over it to reproduce the message tie-break
# byte-for-byte; csrc/filter_chain.cuh's stage bits follow it too.
EXPLAIN_STAGES = (
    "node not schedulable",
    "taint/selector/volume-topology mismatch",
    "insufficient resources",
    "node load over threshold",
    "hostPort in use",
    "CSI volume limit exceeded",
    "insufficient bindable CPUs",
    "NUMA topology cannot fit",
    "affinity/anti-affinity/spread mismatch",
)
# prometheus-safe stage keys for koord_scheduler_filter_rejections_total
EXPLAIN_STAGE_KEYS = (
    "node_not_schedulable",
    "taint_selector_volume_topology",
    "insufficient_resources",
    "node_load_over_threshold",
    "host_port_in_use",
    "csi_volume_limit",
    "insufficient_bindable_cpus",
    "numa_topology",
    "affinity_spread",
    "gang_not_satisfied",
    "quota_exhausted",
)
# pod-level PreFilter verdict slots appended after the per-node stages
# (0/1 flags, not node counts — they reproduce diagnose.py's early returns)
EXPLAIN_STAGE_GANG = len(EXPLAIN_STAGES)
EXPLAIN_STAGE_QUOTA = len(EXPLAIN_STAGES) + 1
NUM_EXPLAIN_STAGES = len(EXPLAIN_STAGES) + 2

# per-plugin score-term slots of ExplainOut.terms rows (the "full" level)
EXPLAIN_TERMS = ("LoadAware", "NodeNUMAResource", "Preferred",
                 "best_score", "runner_up")

# plain rounds run and the valid pods they walked (testing/scrape_convoy
# reads them to give the plain round's torch calls a pod)
plain_rounds = 0
plain_pods = 0


class ExplainOut(NamedTuple):
    """Attribution readback riding the scheduling dispatch.

    ``stage_counts``: [P, NUM_EXPLAIN_STAGES] uint32 per-pod rejected-node
    counts over the REAL (unpadded) nodes, evaluated at cycle-start state —
    the same state scheduler/diagnose.py reads — plus the two pod-level
    PreFilter verdict slots (0/1). The fused wave step emits [K, P, ...],
    one row per wave at wave-start state. ``terms``: [P, len(EXPLAIN_TERMS)]
    f32 decision-time score attribution (None below the "full" level):
    the winning node's LoadAware, NodeNUMAResource (with balanced
    allocation) and preferred (node affinity, pod affinity, image
    locality) terms, the best score and the runner-up score (-1 when no
    feasible runner-up). Rows of pods outside ``pod_valid`` are 0: no
    round evaluates them."""

    stage_counts: torch.Tensor
    terms: Optional[torch.Tensor]


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
    rejects and gang_pod_ok[P], each pod's gang PreFilter validity. An
    uploaded round's host pack (models/round_pack) holds them already."""
    pack = getattr(fc, "pack", None)
    if pack is not None:
        return pack.rows
    reject_np, reject_prod = node_rejects(fc.base)
    gang_pod_ok = torch.where(
        fc.gang_id >= 0, fc.gang_valid[torch.clamp_min(fc.gang_id, 0).long()],
        True)
    return reject_np, reject_prod, gang_pod_ok


class PodFlags(NamedTuple):
    """One pod's facts, as RoundFlags reads them to the host."""

    valid: bool     # pod_valid
    quota: bool     # quota_id >= 0: the quota chain runs
    numa: bool      # needs_numa: NUMA admission and its zone commit run
    bind: bool      # needs_bind: the cpuset filter and its commit run
    ports: bool     # some hostPort slot wanted
    vol: bool       # some volume need other than +0.0
    anti: bool      # some required anti-affinity term
    match: bool     # matches some term (symmetric anti-affinity)
    aff_req: bool   # some required affinity term
    spread: bool    # some term with maxSkew not <= 0 (spread)
    ppref: bool     # a preferred pod-affinity profile
    prod: bool      # is_prod
    gang_ok: bool   # gang PreFilter validity
    finite: bool    # every f32 request, estimate and need finite
    clean: bool     # the round's, on every row: see RoundFlags
    w_pos: bool     # the round's: every weighted score axis weighs > 0


class RoundFlags:
    """What the plain round knows before its pod loop.

    ``pod``: each pod's PodFlags, from an uploaded round's host pack
    (models/round_pack), or else read to the host with one ``tolist`` a
    round (the round's one sync; it used to read the valid list instead).
    ``clean``: no quota_used, aff_count or anti_cover cell is -0.0, and no
    port_used cell has its sign bit set or is NaN. Commits only add to
    these rows, and an f32 sum is -0.0 only when both terms are, so they
    stay so through the round.

    The rows no commit changes, computed once a round: the LoadAware
    rejects and gang validity (``rows``, pod_independent_rows), the [P, N]
    taint rows and static Filter verdict (node_ok, LoadAware, taints), the
    [P, N] preferred-node and image rows, and the per-pod gathers of the
    quota chain, fit and score axes. make_pod_evaluator and
    commit_pod_state take them (``flags=``) and skip, in Python, every
    term whose result for a pod is a known identity; each skip says why
    it is exact."""

    @staticmethod
    def _read_table(fc: FullChainInputs, widx, gang_ok) -> list:
        """Each pod's PodFlags from the device, in one stacked tolist."""
        inputs = fc.base
        P = inputs.pod_valid.shape[0]
        vol = fc.vol_needed
        finite = torch.isfinite(torch.cat(
            [inputs.fit_requests, fc.requests, inputs.estimated, vol,
             fc.cores_needed[:, None]], dim=1)).all(dim=1)
        counts = torch.cat([fc.quota_used.reshape(-1),
                            fc.aff_count.reshape(-1),
                            fc.anti_cover.reshape(-1)])
        dirty = ((torch.signbit(counts) & (counts == 0)).any()
                 | (torch.signbit(fc.port_used)
                    | torch.isnan(fc.port_used)).any())
        w_pos = (inputs.weights[widx] > 0).all()
        table = torch.stack([
            inputs.pod_valid, fc.quota_id >= 0, fc.needs_numa, fc.needs_bind,
            fc.pod_port_wants.any(dim=1),
            ~((vol == 0) & ~torch.signbit(vol)).all(dim=1),
            fc.pod_anti_req.any(dim=1), fc.pod_aff_match.any(dim=1),
            fc.pod_aff_req.any(dim=1),
            (~(fc.pod_spread_skew <= 0)).any(dim=1),
            fc.pod_ppref_id >= 0, inputs.is_prod, gang_ok, finite,
            (~dirty).expand(P), w_pos.expand(P)], dim=1).tolist()
        return [PodFlags(*map(bool, row)) for row in table]

    def __init__(self, fc: FullChainInputs, weight_idx, bal_idx):
        inputs = fc.base
        P, N = inputs.pod_valid.shape[0], inputs.allocatable.shape[0]
        T = fc.aff_dom.shape[1]
        K = fc.numa_free.shape[1]
        f32, dev = torch.float32, inputs.allocatable.device
        widx = list(weight_idx)
        self.rows = pod_independent_rows(fc)
        reject_np, reject_prod, gang_ok = self.rows
        pack = getattr(fc, "pack", None)
        if pack is not None:
            # the host pack's table (models/round_pack.pod_flag_table_np,
            # the same columns from the same host arrays): no sync
            w_pos = bool((pack.weights[widx] > 0).all())
            self.pod = [PodFlags(*row, w_pos) for row in pack.table]
        else:
            self.pod = self._read_table(fc, widx, gang_ok)
        on = [any(col) for col in zip(*(p for p in self.pod if p.valid))]
        on = PodFlags(*on) if on else PodFlags(*[False] * len(PodFlags._fields))

        # TaintToleration: bit node_taint_group of the pod's admission mask
        self.taint = ((fc.pod_taint_mask.to(torch.int32)[:, None]
                       >> fc.node_taint_group[None, :]) & 1) == 1
        la_reject = torch.where(inputs.is_prod[:, None], reject_prod[None, :],
                                reject_np[None, :])
        self.static = (inputs.node_ok[None, :] & self.taint
                       & (inputs.is_daemonset[:, None] | ~la_reject))
        self.fit_nonpos = inputs.fit_requests <= 0
        self.req_nonpos = fc.requests <= 0
        self.est_w = inputs.estimated[:, widx]
        self.req_w = fc.requests[:, widx]
        self.fit_bal = (inputs.fit_requests[:, list(bal_idx)]
                        if bal_idx[0] >= 0 else None)
        # preferred node affinity and image locality: static profile rows
        # (0 without one), the preferred pod-affinity term between them
        ppref_on = bool(T and fc.ppref_w.shape[0])
        if fc.pref_scores.shape[1]:
            pid = fc.pod_pref_id
            self.pref = torch.where(
                (pid >= 0)[:, None],
                fc.pref_scores[:, torch.clamp_min(pid, 0).long()].T, 0.0)
        else:
            self.pref = torch.zeros((1, N), dtype=f32, device=dev).expand(
                P, N)
        pref = self.pref
        if ppref_on:
            # a pod with no profile adds where(sid2 >= 0, norm, 0.0), +0.0
            pref = pref + 0.0
            if on.ppref:
                self.ppref_w = fc.ppref_w[
                    torch.clamp_min(fc.pod_ppref_id, 0).long(), :T]
        self.img = None
        if fc.img_scores.shape[1]:
            iid = fc.pod_img_id
            self.img = torch.where(
                (iid >= 0)[:, None],
                fc.img_scores[:, torch.clamp_min(iid, 0).long()].T, 0.0)
            pref = pref + self.img
        # a pod without a preferred pod-affinity profile: the whole term
        self.pref_static = pref
        if on.quota:
            # each pod's quota chain: its cells, their runtime rows and its
            # [G] multiplicities (quota_used_add_row's onehot)
            G = fc.quota_ancestors.shape[0]
            chain = fc.quota_ancestors[
                torch.clamp_min(fc.quota_id, 0).long()]
            self.chain_gg = torch.clamp_min(chain, 0).long()      # [P, D]
            self.chain_neg = chain < 0
            self.runtime_chain = fc.quota_runtime[self.chain_gg]  # [P, D, R]
            hit = (chain >= 0) & (fc.quota_id >= 0)[:, None]
            groups = torch.arange(G, dtype=torch.int32, device=dev)
            self.onehot = torch.where(
                hit[:, :, None],
                (groups == self.chain_gg[:, :, None]).to(f32),
                0.0).sum(dim=1)                                    # [P, G]
        if on.numa:
            self.single = fc.numa_policy == POLICY_SINGLE_NUMA_NODE
            self.pol_none = fc.numa_policy == POLICY_NONE
            self.one_zone = K == 1
            self.zone0 = torch.zeros((), dtype=torch.int32, device=dev)
        if T and (on.anti or on.match or on.aff_req):
            self.dom_valid = fc.aff_dom >= 0
        self.false = torch.zeros((), dtype=torch.bool, device=dev)
        self.no_zone = torch.full((), -1, dtype=torch.int32, device=dev)


def make_pod_evaluator(fc: FullChainInputs, weight_idx, prod_mode,
                       bal_idx=(-1, -1), explain_terms: bool = False,
                       wave_rows: bool = False, shard_rows: bool = False,
                       flags: Optional[RoundFlags] = None):
    """The per-pod PreFilter + Filter + Score + select math of the plain
    round. Returns evaluate(i, *state) -> (found, best, zone_at_best), all
    0-d tensors: nothing is read back to the host, so on the card the loop
    queues its work without a sync per pod.

    With ``wave_rows`` (the wave-parallel round, models/wave_chain.py)
    evaluate appends (admit, score, bal_row, best_score), as the JAX
    package's evaluator returns them: the pod-level PreFilter verdict, the
    feasibility-masked [N] score, the unmasked [N] balanced-allocation term
    (zeros when the axes were sliced away) and the best score; the wave
    step vmaps it over a window of pods.

    With ``explain_terms`` (explain="full") evaluate appends the pod's
    attribution row, [EXPLAIN_TERMS] f32: the winning node's la_score,
    numa_score and pref terms, the best score and the runner-up
    max(max over n != best of the masked score, -1). With no feasible node
    the argmax still names the first index at the maximum (node 0) and the
    row holds that node's terms, as the JAX package's does.

    The round's only reductions over nodes are the spread minima and the
    preferred pod-affinity max/min: ``evaluate.node_stats(i, aff_count)``
    returns them ([T + 2]: per term the minimum count over the domains the
    pod may use, then the max and min of the weighted counts over node_ok
    nodes) and ``evaluate(..., stats=)`` takes them from outside. A sharded
    round (parallel/full_chain_mesh.py) reduces each shard's node_stats
    over the mesh, exact for a min and a max, and with ``shard_rows``
    evaluate returns the shard's rows, (admit, masked score[N], zone[N],
    la_score[N], numa_score[N], pref[N]), for the cross-shard select. The
    pod-level verdict reads only replicated state: ``evaluate.pod_admit(i,
    quota_used)`` computes it once for every shard (``admit=``).

    With ``flags`` (RoundFlags, the plain round's) evaluate takes a valid
    pod's index as a Python int, reads the rows no commit changes from
    ``flags`` and skips every Filter stage and score term that is a known
    identity for the pod. The [N, T] affinity block and the [N, W] score
    columns are computed whole in every mode: each is elementwise, and
    the only sums, over the weight axes, keep their order."""
    inputs = fc.base
    if flags is not None and (wave_rows or shard_rows):
        raise ValueError("flags= serves the plain round only")
    reject_np, reject_prod, gang_pod_ok = (
        pod_independent_rows(fc) if flags is None else flags.rows)
    T = fc.aff_dom.shape[1]
    N = inputs.allocatable.shape[0]
    dev = inputs.allocatable.device
    node_vol_group = fc.node_vol_group.long()
    dom_valid = fc.aff_dom >= 0                                  # [N, T]
    if explain_terms:
        node_ids = torch.arange(N, device=dev)
    # the weighted score axes as [N, 1, W] columns (score_rows' block is
    # [N, 2, W]); the weight sum over all R
    widx = list(weight_idx)
    alloc_w = inputs.allocatable[:, widx][:, None, :]
    cap_pos_w = alloc_w > 0
    safe_cap_w = torch.where(cap_pos_w, alloc_w, 1.0)
    w_w = inputs.weights[widx]
    w_den = torch.clamp_min(inputs.weights.sum(), 1.0)
    zero_n2 = torch.zeros((N, 2), dtype=torch.float32, device=dev)
    term_np_w = inputs.la_term_nonprod[:, widx]
    term_pr_w = inputs.la_term_prod[:, widx] if prod_mode else None
    bal_on = bal_idx[0] >= 0
    if bal_on:
        bal_cols = list(bal_idx)
        bal_inv = torch.stack(
            [safe_reciprocal(inputs.allocatable[:, a]) for a in bal_idx], 1)

    ppref_on = bool(T and fc.ppref_w.shape[0])

    def score_rows(base, est_w, requested, req_w, fit_bal, w_pos):
        # LoadAware (_score_row: est + (term + in-round delta)) and
        # NodeNUMAResource least-allocated (numa_score_row: requested +
        # request) as one [N, 2, W] block of ops/common.
        # least_requested_score, then floor(sum_r w_r * score_r / sum w)
        # for each, the sum in axis order from +0.0 as both add. A weight
        # > 0 times the where (+0.0, or the floor of a quotient >= +0.0)
        # is never -0.0: with ``w_pos`` (every weight > 0) the leading
        # +0.0 + x is x, and for W <= 2 the sum is one add in any order.
        # Then NodeResourcesBalancedAllocation (bal_row; None when its axes
        # were sliced away): for two axes the std reduces to |fc - fm| / 2;
        # fractions clamp to 1, a zero-capacity axis gives 0.
        used = torch.stack([est_w + base, requested[:, widx] + req_w], 1)
        raw = torch.floor((alloc_w - used) * MAX_NODE_SCORE / safe_cap_w)
        s = w_w * torch.where(cap_pos_w & (used <= alloc_w), raw, 0.0)
        if w_pos and len(widx) <= 2:
            acc = s.sum(dim=2)
        else:
            acc = zero_n2
            for j in range(len(widx)):
                acc = s[:, :, j] if w_pos and j == 0 else acc + s[:, :, j]
        both = torch.floor(acc / w_den)
        la_score = torch.where(inputs.la_score_valid, both[:, 0], 0.0)
        numa_score, bal_row = both[:, 1], None
        if bal_on:
            frac = torch.clamp_max(
                (requested[:, bal_cols] + fit_bal) * bal_inv, 1.0)
            std = (frac[:, 0] - frac[:, 1]).abs() * 0.5
            bal_row = torch.floor((1.0 - std) * 100.0)
            numa_score = numa_score + bal_row
        return la_score, numa_score, bal_row

    def taint_row(i):
        # TaintToleration: the pod's admission bitmask holds the node's group
        return ((fc.pod_taint_mask[i].to(torch.int32)
                 >> fc.node_taint_group) & 1) == 1

    def ppref_raw(w_row, aff_count):
        return (aff_count * w_row[None, :]).sum(dim=1)

    def ppref_w_row(i):
        return fc.ppref_w[torch.clamp_min(fc.pod_ppref_id[i], 0).long(), :T]

    def stats_of(aff_count, taint_ok, raw):
        # per term the minimum count over the valid, taint-admitted domains
        # (a min is exact in any order), then the ppref max and min
        mins = torch.amin(torch.where(dom_valid & taint_ok[:, None],
                                      aff_count, float("inf")), dim=0)
        if raw is not None:
            ext = torch.stack([
                torch.where(inputs.node_ok, raw, float("-inf")).max(),
                torch.where(inputs.node_ok, raw, float("inf")).min()])
        else:
            inf = torch.tensor(float("inf"), device=aff_count.device)
            ext = torch.stack([-inf, inf])
        return torch.cat([mins, ext])

    def node_stats(i, aff_count, taint_ok=None):
        if taint_ok is None:
            taint_ok = taint_row(i)
        raw = ppref_raw(ppref_w_row(i), aff_count) if ppref_on else None
        return stats_of(aff_count, taint_ok, raw)

    def ppref_norm(raw, stats):
        # preferred POD affinity: weighted matching-pod counts, max-min
        # normalized over node_ok nodes (upstream NormalizeScore)
        mx, mn = stats[T], stats[T + 1]
        return torch.where(
            mx > mn, torch.floor((raw - mn) * 100.0 / (mx - mn)), 0.0)

    def affinity_ok(i, stats, aff_count, anti_cover, aff_exists):
        # InterPodAffinity: required anti terms see an empty domain;
        # required affinity terms a match in a valid domain, or bootstrap
        # (self-match with no matching pod anywhere); symmetric
        # anti-affinity; PodTopologySpread (DoNotSchedule): count + self -
        # min over the domains the pod is eligible for within maxSkew. The
        # [N, T] block elementwise, then an AND over the terms.
        match = fc.pod_aff_match[i]
        anti_ok = ~fc.pod_anti_req[i] | (aff_count <= 0)
        sym_ok = ~match | (anti_cover <= 0)
        bootstrap = match & ~aff_exists
        aff_ok = (~fc.pod_aff_req[i] | (dom_valid & (aff_count > 0))
                  | bootstrap)
        skew = fc.pod_spread_skew[i]
        self_match = torch.where(match, 1.0, 0.0)
        spread_ok = (skew <= 0) | (
            dom_valid & (aff_count + self_match - stats[:T] <= skew))
        return (anti_ok & sym_ok & aff_ok & spread_ok).all(dim=1)

    def ports_ok(i, port_used):
        # NodePorts: no requested hostPort slot may already be bound
        return (~fc.pod_port_wants[i] | (port_used <= 0)).all(dim=1)

    def vol_ok(i, vol_free):
        # NodeVolumeLimits: new attachments per node volume group
        vn = fc.vol_needed[i][node_vol_group]
        return (vn <= 0) | (vol_free >= vn)

    def pod_admit(i, quota_used):
        # ---- PreFilter: gang validity + quota admission (order-dependent)
        quota_ok = quota_admit_row(
            fc.requests[i], fc.quota_id[i], fc.quota_ancestors, quota_used,
            fc.quota_runtime)
        return gang_pod_ok[i] & quota_ok

    def select(i, score, la_score, numa_score, pref, zone):
        # argmax returns the first maximal index (lowest-index tie-break,
        # the binding contract)
        best = torch.argmax(score)
        found = score[best] >= 0.0
        if flags is None:
            found = found & inputs.pod_valid[i]
        zone_b = flags.no_zone if zone is None else zone[best]
        if explain_terms:
            runner = torch.clamp_min(torch.where(
                node_ids == best, float("-inf"), score).max(), -1.0)
            terms = torch.stack([la_score[best], numa_score[best],
                                 pref[best], score[best], runner])
            return found, best, zone_b, terms
        return found, best, zone_b

    def evaluate(i, requested, delta_np, delta_pr, numa_free, bind_free,
                 quota_used, aff_count, anti_cover, aff_exists, port_used,
                 vol_free, stats=None, admit=None):
        req_fit = inputs.fit_requests[i]
        req = fc.requests[i]
        if admit is None:
            admit = pod_admit(i, quota_used)

        # ---- Filter chain
        fit = fit_ok_row(req_fit, inputs.allocatable, requested)
        la_reject = torch.where(inputs.is_prod[i], reject_prod, reject_np)
        la_ok = inputs.is_daemonset[i] | ~la_reject
        cpuset_ok = cpuset_filter_row(
            fc.needs_bind[i], fc.cores_needed[i], fc.full_pcpus[i],
            fc.has_topology, bind_free, fc.cpus_per_core)
        numa_ok, zone = numa_admit_row(
            req, fc.needs_numa[i], numa_free, fc.numa_policy)
        taint_ok = taint_row(i)
        raw = ppref_raw(ppref_w_row(i), aff_count) if ppref_on else None
        if stats is None:
            stats = stats_of(aff_count, taint_ok, raw)
        feasible = (inputs.node_ok & fit & la_ok & cpuset_ok & numa_ok
                    & taint_ok
                    & affinity_ok(i, stats, aff_count, anti_cover, aff_exists)
                    & ports_ok(i, port_used) & vol_ok(i, vol_free) & admit)

        # ---- Score chain (equal plugin weights, each already 0..100)
        base = term_np_w + delta_np[:, widx]
        if prod_mode:
            base = torch.where(inputs.is_prod[i],
                               term_pr_w + delta_pr[:, widx], base)
        la_score, numa_score, bal_row = score_rows(
            base, inputs.estimated[i][widx], requested, req[widx],
            req_fit[bal_cols] if bal_on else None, False)
        if bal_row is None:
            bal_row = torch.zeros_like(numa_score)
        # preferred node affinity: a static profile row (0 without one)
        if fc.pref_scores.shape[1]:
            pid = fc.pod_pref_id[i]
            pref = torch.where(
                pid >= 0, fc.pref_scores[:, torch.clamp_min(pid, 0).long()],
                0.0)
        else:
            pref = torch.zeros_like(la_score)
        if ppref_on:
            pref = pref + torch.where(fc.pod_ppref_id[i] >= 0,
                                      ppref_norm(raw, stats), 0.0)
        # ImageLocality: static profile rows, like preferred node affinity
        if fc.img_scores.shape[1]:
            iid = fc.pod_img_id[i]
            pref = pref + torch.where(
                iid >= 0, fc.img_scores[:, torch.clamp_min(iid, 0).long()],
                0.0)
        score = la_score + numa_score + pref
        score = torch.where(feasible, score, -1.0)

        if shard_rows:
            return admit, score, zone, la_score, numa_score, pref
        out = select(i, score, la_score, numa_score, pref, zone)
        if wave_rows and not explain_terms:
            return out + (admit, score, bal_row, score[out[1]])
        return out

    def numa_flagged(i, numa_free):
        # numa_admit_row for a pod with needs_numa: its ``| ~needs_numa``
        # and ``& needs_numa`` are identities
        fits_zone = (flags.req_nonpos[i]
                     | (fc.requests[i] <= numa_free)).all(dim=-1)  # [N, K]
        if numa_free.shape[1] == 1:
            # one zone: the zone total is that zone, so fits_total is
            # fits_zone[:, 0] and so is any_zone; the lowest fitting zone
            # is 0. where(single, any_zone, fits_total) is then either.
            any_zone = fits_zone[:, 0]
            return (any_zone | flags.pol_none,
                    torch.where(flags.single & any_zone, flags.zone0, -1))
        fits_total = (flags.req_nonpos[i] | (
            fc.requests[i] <= zone_total(numa_free))).all(dim=-1)
        any_zone = fits_zone.any(dim=-1)
        first_zone = fits_zone.to(torch.int32).argmax(dim=-1).to(torch.int32)
        ok = torch.where(flags.single, any_zone, fits_total) | flags.pol_none
        return ok, torch.where(flags.single & any_zone, first_zone, -1)

    def affinity_flagged(i, fl, aff_count, anti_cover, aff_exists, mins):
        # affinity_ok's [N, T] block with only the verdicts that can
        # reject: without an anti term ~pod_anti_req is all true; without
        # a match sym_ok is all true and bootstrap all false; without an
        # affinity term aff_ok is all true; with every maxSkew <= 0 so is
        # spread_ok
        ok = None

        def both(a, b):
            return b if a is None else a & b

        if fl.anti:
            ok = both(ok, ~fc.pod_anti_req[i] | (aff_count <= 0))
        if fl.match:
            ok = both(ok, ~fc.pod_aff_match[i] | (anti_cover <= 0))
        if fl.aff_req:
            bootstrap = fc.pod_aff_match[i] & ~aff_exists
            ok = both(ok, ~fc.pod_aff_req[i]
                      | (flags.dom_valid & (aff_count > 0)) | bootstrap)
        if fl.spread:
            skew = fc.pod_spread_skew[i]
            self_match = torch.where(fc.pod_aff_match[i], 1.0, 0.0)
            ok = both(ok, (skew <= 0) | (
                dom_valid & (aff_count + self_match - mins <= skew)))
        return ok.all(dim=1)

    def evaluate_flagged(i, requested, delta_np, delta_pr, numa_free,
                         bind_free, quota_used, aff_count, anti_cover,
                         aff_exists, port_used, vol_free):
        # Each Filter stage skipped below is all-true for this pod, so an
        # AND with it is the identity: its flag says the stage's every
        # input that could reject is off (no quota: ``| (quota_id < 0)``;
        # no NUMA need: ``| ~needs_numa``; no binding: ``| ~needs_bind``;
        # no term: every term's verdict; no port; every volume need +0.0,
        # so ``vn <= 0``). A valid pod's ``& pod_valid[i]`` is & True.
        fl = flags.pod[i]
        req_fit = inputs.fit_requests[i]
        feasible = flags.static[i] & (
            flags.fit_nonpos[i]
            | (requested + req_fit <= inputs.allocatable)).all(dim=-1)
        if fl.quota:
            # quota_admit_row on the pod's gathered [D, R] chain
            qfit = (flags.req_nonpos[i]
                    | (quota_used[flags.chain_gg[i]] + fc.requests[i]
                       <= flags.runtime_chain[i])).all(dim=-1)
            feasible = feasible & (flags.chain_neg[i] | qfit).all()
        if not fl.gang_ok:
            feasible = feasible & flags.false
        if fl.bind:
            feasible = feasible & cpuset_filter_row(
                fc.needs_bind[i], fc.cores_needed[i], fc.full_pcpus[i],
                fc.has_topology, bind_free, fc.cpus_per_core)
        zone = None
        if fl.numa:
            numa_ok, zone = numa_flagged(i, numa_free)
            feasible = feasible & numa_ok
        need_ppref = ppref_on and fl.ppref
        if fl.spread or need_ppref:
            raw = (ppref_raw(flags.ppref_w[i], aff_count) if need_ppref
                   else None)
            stats = stats_of(aff_count, flags.taint[i], raw)
        if fl.anti or fl.match or fl.aff_req or fl.spread:
            feasible = feasible & affinity_flagged(
                i, fl, aff_count, anti_cover, aff_exists,
                stats[:T] if fl.spread else None)
        if fl.ports:
            feasible = feasible & ports_ok(i, port_used)
        if fl.vol:
            feasible = feasible & vol_ok(i, vol_free)

        # a prod pod in prod mode: where(is_prod, prod, nonprod) picks prod
        if prod_mode and fl.prod:
            base = term_pr_w + delta_pr[:, widx]
        else:
            base = term_np_w + delta_np[:, widx]
        la_score, numa_score, _ = score_rows(
            base, flags.est_w[i], requested, flags.req_w[i],
            flags.fit_bal[i] if bal_on else None, fl.w_pos)
        if need_ppref:
            # where(sid2 >= 0, norm, 0.0) is norm for a pod with a profile
            pref = flags.pref[i] + ppref_norm(raw, stats)
            if flags.img is not None:
                pref = pref + flags.img[i]
        else:
            pref = flags.pref_static[i]
        score = torch.where(feasible, la_score + numa_score + pref, -1.0)
        return select(i, score, la_score, numa_score, pref, zone)

    if flags is not None:
        evaluate = evaluate_flagged
    evaluate.node_stats = node_stats
    evaluate.pod_admit = pod_admit
    return evaluate


def commit_node_rows(fc: FullChainInputs, prod_mode: bool, state, i, found,
                     best, zone_at_best, flags: Optional[RoundFlags] = None
                     ) -> None:
    """The node rows of pod ``i``'s commit onto node ``best``, in place:
    requested, the LoadAware deltas, the NUMA zones (``zone_at_best``, or
    the lowest-zones-first fill), bindable cpus, ports and volume headroom
    (the owner-node part of csrc/filter_chain.cuh commit_node). ``state``
    is commit_pod_state's 11-tuple. ``flags``: the plain round's
    RoundFlags, whose known identities are skipped."""
    inputs = fc.base
    (requested, delta_np, delta_pr, numa_free, bind_free, _quota_used,
     _aff_count, _anti_cover, _aff_exists, port_used, vol_free) = state
    fl = None if flags is None else flags.pod[i]
    PT = fc.port_used.shape[1]
    fnd = found.to(torch.float32)

    requested[best] = requested[best] + fnd * inputs.fit_requests[i]
    est = fnd * inputs.estimated[i]
    delta_np[best] = delta_np[best] + est
    if prod_mode:
        if fl is None or not fl.finite:
            delta_pr[best] = delta_pr[best] + fnd * (
                torch.where(inputs.is_prod[i], 1.0, 0.0)
                * inputs.estimated[i])
        elif fl.prod:
            # where(is_prod, 1.0, 0.0) * est is est: 1.0 * x == x
            delta_pr[best] = delta_pr[best] + est
        # else: a non-prod pod with finite estimates adds +-0.0; delta_pr
        # starts at +0.0 and only adds, so it holds no -0.0: x + 0 == x
    if fl is None:
        new_zone_free = numa_spread_fill(numa_free[best], fc.requests[i],
                                         zone_at_best)
        apply_numa = found & fc.needs_numa[i]
        numa_free[best] = torch.where(apply_numa, new_zone_free,
                                      numa_free[best])
    elif fl.numa:
        # apply_numa = found & True. One zone: numa_spread_fill's
        # single-zone row is nf - 1.0 * req = nf - req, its waterfall
        # nf - minimum(nf, req).
        nf = numa_free[best]
        req = fc.requests[i]
        if flags.one_zone:
            new = torch.where(zone_at_best >= 0, nf - req,
                              nf - torch.minimum(nf, req))
        else:
            new = numa_spread_fill(nf, req, zone_at_best)
        numa_free[best] = torch.where(found, new, nf)
    # else: apply_numa is found & False; the where keeps the row
    if fl is None or fl.bind:
        bind_free[best] = bind_free[best] - fnd * torch.where(
            fc.needs_bind[i], fc.cores_needed[i], 0.0)
    # else: fnd * where(False, ., 0.0) is +0.0, and x - (+0.0) == x
    if PT and (fl is None or fl.ports or not fl.clean):
        port_used[best] = torch.maximum(
            port_used[best], fnd * fc.pod_port_wants[i].to(torch.float32))
    # else: maximum(x, +0.0) == x for x without its sign bit, not NaN
    if fl is None or fl.vol:
        vol_free[best] = vol_free[best] - fnd * fc.vol_needed[i][
            fc.node_vol_group[best].long()]
    # else: every need is +0.0, fnd * (+0.0) is +0.0, and x - (+0.0) == x


def commit_pod_state(fc: FullChainInputs, prod_mode: bool, state, i, found,
                     best, zone_at_best, flags: Optional[RoundFlags] = None):
    """Apply pod ``i``'s tentative binding to the round state, in place.

    ``state`` is the 11-tuple (requested, delta_np, delta_pr, numa_free,
    bind_free, quota_used, aff_count, anti_cover, aff_exists, port_used,
    vol_free); every tensor in it is the round's own copy, so updating in
    place saves a copy of each per pod. Returns the state (quota_used is
    replaced, not updated). On a mesh (parallel/full_chain_mesh.py) the
    shard owning ``best`` commits here and every other shard applies
    ``_commit_affinity`` over its own nodes. ``flags``: the plain round's
    RoundFlags, whose known identities are skipped."""
    (requested, delta_np, delta_pr, numa_free, bind_free, quota_used,
     aff_count, anti_cover, aff_exists, port_used, vol_free) = state
    T = fc.aff_dom.shape[1]
    fl = None if flags is None else flags.pod[i]
    commit_node_rows(fc, prod_mode, state, i, found, best, zone_at_best,
                     flags)
    if fl is not None and fl.quota:
        # quota_used_add_row: the chain's multiplicities where found
        quota_used = quota_used + torch.where(
            found, flags.onehot[i], 0.0)[:, None] * fc.requests[i][None, :]
    elif fl is None or not (fl.finite and fl.clean):
        quota_used = quota_used_add_row(
            quota_used, fc.requests[i], fc.quota_id[i], fc.quota_ancestors,
            found)
    # else: no quota adds 0 * request, +-0.0, to cells that hold no -0.0
    if T and (fl is None or not fl.clean):
        _commit_affinity(fc, i, found, fc.aff_dom[best], aff_count,
                         anti_cover, aff_exists)
    elif T and (fl.match or fl.anti):
        # _commit_affinity without the rows that add +0.0: a term the pod
        # does not match adds nothing to the counts, one it does not carry
        # nothing to the covers (cells that hold no -0.0), and ORs False
        in_dom = flags.dom_valid[best] & (fc.aff_dom == fc.aff_dom[best])
        if fl.match:
            match = found & fc.pod_aff_match[i]
            aff_count += (match & in_dom).to(torch.float32)
            aff_exists |= match
        if fl.anti:
            anti_cover += (found & fc.pod_anti_req[i] & in_dom).to(
                torch.float32)
    # else: a pod that matches no term and carries no anti term adds +0.0
    # to counts and covers that hold no -0.0, and ORs False into aff_exists
    return (requested, delta_np, delta_pr, numa_free, bind_free, quota_used,
            aff_count, anti_cover, aff_exists, port_used, vol_free)


def _commit_affinity(fc: FullChainInputs, i, found, chosen_dom, aff_count,
                     anti_cover, aff_exists) -> None:
    """Inter-pod affinity: the placed pod raises the count of every term it
    matches across the chosen node's whole domain (``chosen_dom`` [T], its
    aff_dom row), latches the term's exists flag (even on an unlabeled
    node), and raises anti_cover for the terms it carries as required
    anti-affinity. The [N, T] block at once: each cell adds 0 or 1."""
    if not fc.aff_dom.shape[1]:
        return
    in_dom = (chosen_dom >= 0) & (fc.aff_dom == chosen_dom)       # [N, T]
    match = found & fc.pod_aff_match[i]
    aff_count += (match & in_dom).to(torch.float32)
    anti_cover += (found & fc.pod_anti_req[i] & in_dom).to(torch.float32)
    aff_exists |= match


def plain_round(fc: FullChainInputs, weight_idx, prod_mode: bool, bal_idx,
                terms: bool = False):
    """The serial round's loop in plain torch: each valid pod, in queue
    order, is evaluated at the running state and commits its tentative
    binding. Returns (chosen[P] int32 before Permit, the final 11-tuple
    state of commit_pod_state), and with ``terms`` a third item, the
    [P, len(EXPLAIN_TERMS)] f32 attribution rows (0 outside pod_valid).
    Pods outside ``pod_valid`` are skipped: their evaluation finds nothing
    and their commit changes nothing. The round reads its RoundFlags to
    the host once, before the loop, and writes chosen (and the rows) once,
    after it."""
    global plain_rounds, plain_pods
    inputs = fc.base
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    dev = inputs.allocatable.device
    flags = RoundFlags(fc, weight_idx, bal_idx)
    evaluate = make_pod_evaluator(fc, weight_idx, prod_mode, bal_idx,
                                  explain_terms=terms, flags=flags)
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
    valid = [i for i, fl in enumerate(flags.pod) if fl.valid]
    plain_rounds += 1
    plain_pods += len(valid)
    founds, bests, term_rows = [], [], []
    for i in valid:
        out = evaluate(i, *state)
        found, best, zone_at_best = out[:3]
        if terms:
            term_rows.append(out[3])
        state = commit_pod_state(fc, prod_mode, state, i, found, best,
                                 zone_at_best, flags)
        founds.append(found)
        bests.append(best)
    chosen = torch.full((P,), -1, dtype=torch.int32, device=dev)
    rows = (torch.zeros((P, len(EXPLAIN_TERMS)), dtype=torch.float32,
                        device=dev) if terms else None)
    if valid:
        at = torch.tensor(valid, dtype=torch.int64, device=dev)
        chosen[at] = torch.where(torch.stack(founds),
                                 torch.stack(bests).to(torch.int32), -1)
        if terms:
            rows[at] = torch.stack(term_rows)
    if terms:
        return chosen, state, rows
    return chosen, state


def _count_chunk(n_nodes: int, width: int) -> int:
    """Pods per chunk of the plain counts: about 4M elements of the
    widest [pods, N, width] intermediate."""
    return max(1, (1 << 22) // max(1, n_nodes * max(1, width)))


def explain_spread_minima(fc: FullChainInputs, aff_count) -> torch.Tensor:
    """[P, T] f32: per pod and term, the minimum matching count over this
    ``fc``'s nodes in the domains the pod may use (valid domain, taint
    admitted) — the spread minima explain_stage_counts reads. A mesh takes
    the minimum of its shards' rows (exact)."""
    P = fc.base.fit_requests.shape[0]
    N, T = fc.aff_dom.shape
    dom_valid = fc.aff_dom >= 0
    out = torch.full((P, T), float("inf"), dtype=torch.float32,
                     device=aff_count.device)
    step = _count_chunk(N, 1)
    for c0 in range(0, P, step):
        sl = slice(c0, min(c0 + step, P))
        taint_ok = ((fc.pod_taint_mask[sl].to(torch.int32)[:, None]
                     >> fc.node_taint_group[None]) & 1) == 1
        for t in range(T):
            out[sl, t] = torch.where(
                dom_valid[:, t][None] & taint_ok, aff_count[:, t][None],
                float("inf")).min(dim=1)[0]
    return out


def explain_stage_counts(fc: FullChainInputs, filter_state,
                         n_real, spread_min=None, rows=None) -> torch.Tensor:
    """[P, NUM_EXPLAIN_STAGES] uint32: per-pod rejected-node counts at the
    frozen ``filter_state`` — the (requested, numa_free, bind_free,
    quota_used, aff_count, anti_cover, aff_exists, port_used, vol_free)
    9-tuple — over the first ``n_real`` (unpadded) nodes, plus the two
    pod-level PreFilter verdict flags (gang, quota), for every pod row.

    The plain version of the CUDA pass (ops/explain_kernel.py): the
    round's Filter predicates of make_pod_evaluator, vectorised over the
    nodes and chunked over the pods, counted per stage in EXPLAIN_STAGES
    order. The spread filter's minimum runs over every node, padded ones
    included, as the round's does; only the counts stop at ``n_real``.
    ``spread_min`` ([P, T], explain_spread_minima over every node) replaces
    that minimum: a shard counts its own rows against the mesh's minima.
    ``rows`` (reject_np[N], reject_prod[N], gang_pod_ok[P]) replaces
    pod_independent_rows(fc): what a caller read from packed inputs."""
    (requested, numa_free, bind_free, quota_used, aff_count, anti_cover,
     aff_exists, port_used, vol_free) = filter_state
    inputs = fc.base
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    K = numa_free.shape[1]
    T = fc.aff_dom.shape[1]
    PT = port_used.shape[1]
    dev = inputs.allocatable.device
    reject_np, reject_prod, gang_pod_ok = (
        pod_independent_rows(fc) if rows is None else rows)
    real = torch.arange(N, device=dev) < int(n_real)
    dom_valid = fc.aff_dom >= 0                                   # [N, T]
    total_free = zone_total(numa_free)                            # [N, R]
    single = fc.numa_policy == POLICY_SINGLE_NUMA_NODE            # [N]
    pol_none = fc.numa_policy == POLICY_NONE
    cpc = torch.clamp_min(fc.cpus_per_core, 1.0)
    aff_exists = aff_exists.to(torch.bool)
    vol_group = fc.node_vol_group.long()
    chain_all = fc.quota_ancestors[torch.clamp_min(fc.quota_id, 0).long()]
    D = fc.quota_ancestors.shape[1]
    step = _count_chunk(N, max(R, K * R))
    out = torch.zeros((P, NUM_EXPLAIN_STAGES), dtype=torch.int64,
                      device=dev)
    for c0 in range(0, P, step):
        sl = slice(c0, min(c0 + step, P))
        need = inputs.fit_requests[sl][:, None, :]                # [C, 1, R]
        req = fc.requests[sl]                                     # [C, R]
        fit = ((need <= 0)
               | (requested[None] + need <= inputs.allocatable[None])
               ).all(dim=-1)
        is_prod = inputs.is_prod[sl][:, None]
        la_ok = inputs.is_daemonset[sl][:, None] | ~torch.where(
            is_prod, reject_prod[None], reject_np[None])
        cores = fc.cores_needed[sl][:, None]
        rem = torch.remainder(cores, cpc[None])
        smt_ok = ~fc.full_pcpus[sl][:, None] | (rem.abs() < 0.5)
        cpuset_ok = (fc.has_topology[None] & smt_ok
                     & (cores <= bind_free[None])) | ~fc.needs_bind[sl][:, None]
        rq = req[:, None, None, :]
        fits_zone = ((rq <= 0) | (rq <= numa_free[None])).all(dim=-1)
        fits_total = ((req[:, None, :] <= 0)
                      | (req[:, None, :] <= total_free[None])).all(dim=-1)
        numa_ok = (torch.where(single[None], fits_zone.any(dim=-1),
                               fits_total)
                   | pol_none[None] | ~fc.needs_numa[sl][:, None])
        taint_ok = ((fc.pod_taint_mask[sl].to(torch.int32)[:, None]
                     >> fc.node_taint_group[None]) & 1) == 1
        affinity_ok = torch.ones_like(taint_ok)
        for t in range(T):
            count_t = aff_count[:, t][None]
            dom_t = dom_valid[:, t][None]
            match_t = fc.pod_aff_match[sl, t].to(torch.bool)[:, None]
            anti_ok = ~fc.pod_anti_req[sl, t].to(torch.bool)[:, None] | (
                count_t <= 0)
            sym_ok = ~match_t | (anti_cover[:, t][None] <= 0)
            bootstrap = match_t & ~aff_exists[t]
            aff_ok = (~fc.pod_aff_req[sl, t].to(torch.bool)[:, None]
                      | (dom_t & (count_t > 0)) | bootstrap)
            skew = fc.pod_spread_skew[sl, t][:, None]
            self_match = torch.where(match_t, 1.0, 0.0)
            if spread_min is None:
                min_count = torch.where(
                    dom_t & taint_ok, count_t,
                    float("inf")).min(dim=1, keepdim=True)[0]
            else:
                min_count = spread_min[sl, t][:, None]
            spread_ok = (skew <= 0) | (
                dom_t & (count_t + self_match - min_count <= skew))
            affinity_ok = affinity_ok & anti_ok & sym_ok & aff_ok & spread_ok
        ports_ok = torch.ones_like(taint_ok)
        for s_ in range(PT):
            ports_ok = ports_ok & (
                ~fc.pod_port_wants[sl, s_].to(torch.bool)[:, None]
                | (port_used[:, s_] <= 0)[None])
        vn = fc.vol_needed[sl][:, vol_group]                      # [C, N]
        vol_ok = (vn <= 0) | (vol_free[None] >= vn)
        quota_ok = torch.ones(req.shape[0], dtype=torch.bool, device=dev)
        chain = chain_all[sl]
        for d in range(D):
            g = chain[:, d]
            gg = torch.clamp_min(g, 0).long()
            qfit = ((req <= 0) | (quota_used[gg] + req
                                  <= fc.quota_runtime[gg])).all(dim=-1)
            quota_ok = quota_ok & ((g < 0) | qfit)
        quota_ok = quota_ok | (fc.quota_id[sl] < 0)
        bads = (~inputs.node_ok[None].expand_as(taint_ok), ~taint_ok, ~fit,
                ~la_ok, ~ports_ok, ~vol_ok, ~cpuset_ok, ~numa_ok,
                ~affinity_ok)
        for k, bad in enumerate(bads):
            out[sl, k] = (bad & real[None]).sum(dim=1)
        out[sl, EXPLAIN_STAGE_GANG] = (~gang_pod_ok[sl]).to(torch.int64)
        out[sl, EXPLAIN_STAGE_QUOTA] = (~quota_ok).to(torch.int64)
    return out.to(torch.uint32)


def cycle_start_state(fc: FullChainInputs):
    """The 9-tuple explain_stage_counts reads, at the inputs' own state:
    the state a serial cycle's packed batch holds before its round."""
    return (fc.base.requested, fc.numa_free, fc.bind_free, fc.quota_used,
            fc.aff_count, fc.anti_cover, fc.aff_exists.to(torch.bool),
            fc.port_used, fc.vol_free)


def _check_explain(explain) -> None:
    if explain not in (None, "counts", "full"):
        raise ValueError(
            f"explain must be None, 'counts' or 'full'; got {explain!r}")


def build_full_chain_step(args: LoadAwareArgs, num_gangs: int,
                          num_groups: int, active_axes=None, explain=None):
    """The plain round: FullChainInputs (torch) -> (chosen[P] int32,
    requested[N, R], quota_used[G, R]) on the inputs' device.

    num_gangs/num_groups size the Permit segment sums. active_axes: when the
    inputs were sliced to the active resource axes
    (snapshot.reduce_to_active_axes), the original axis ids, so the weight
    and balanced-allocation axes map correctly.

    explain: None (the plain step above), "counts" or "full". An explain
    step takes an extra ``n_real`` (the real node count: padding must not
    inflate counts) and returns a 4th output, ExplainOut: the stage counts
    at CYCLE-START state (the inputs' own state, after Permit as the JAX
    package orders it) and, at "full", the terms rows. The decisions are
    untouched."""
    _check_explain(explain)
    weight_idx = resolve_weight_idx(args, active_axes)
    bal_idx = resolve_balance_idx(active_axes)
    prod_mode = args.score_according_prod_usage
    full = explain == "full"

    def run(fc: FullChainInputs, n_real):
        out = plain_round(fc, weight_idx, prod_mode, bal_idx, terms=full)
        chosen, state = out[0], out[1]
        chosen = permit(fc, chosen, num_gangs, num_groups)
        if explain is None:
            return chosen, state[0], state[5]
        counts = explain_stage_counts(fc, cycle_start_state(fc), n_real)
        return (chosen, state[0], state[5],
                ExplainOut(counts, out[2] if full else None))

    if explain is None:
        def step(fc: FullChainInputs):
            return run(fc, None)
    else:
        def step(fc: FullChainInputs, n_real):
            return run(fc, n_real)

    step.last_backend = "serial"
    return step


def permit(fc: FullChainInputs, chosen: torch.Tensor, num_gangs: int,
           num_groups: int) -> torch.Tensor:
    """Gang Permit barrier (all-or-nothing per gang group) over a round's
    tentative bindings."""
    pack = getattr(fc, "pack", None)
    if pack is not None and not pack.any_gang:
        # no valid pod is in a gang: every pod keeps its binding (keep is
        # True outside gangs; a pod outside pod_valid chose -1 anyway)
        return chosen
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

    ``kernel="serial"`` forces the plain round on any device; "wave" the
    wave-parallel round (models/wave_chain.py: plain PyTorch on the inputs'
    device, ``last_backend`` "wave"; it emits no attribution, so an
    explain step takes the selection below instead, as the JAX package
    pins explain off its wave kernel); "auto" is the selection above.

    ``explain`` ("counts" | "full", koordexplain): the step takes the extra
    ``n_real`` and returns ExplainOut as its 4th output, as
    build_full_chain_step does. Here the port departs from the JAX
    package, which pins explain to its XLA serial step (``last_backend``
    "xla"): on the card explain runs the kernels — the stage counts in the
    CUDA pass of ops/explain_kernel.py, the terms in the full-chain
    kernel's terms instance — and ``last_backend`` says "cuda"; on the CPU
    it runs the plain step ("serial"). No size sends a CUDA batch to the
    plain round or the plain counts."""
    _check_explain(explain)
    if kernel not in ("auto", "serial", "wave"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel == "wave" and explain is None:
        from koordinator_tpu_torch.models.wave_chain import (
            build_wave_full_chain_step,
        )

        return build_wave_full_chain_step(args, num_gangs, num_groups,
                                          active_axes=active_axes)
    plain = build_full_chain_step(args, num_gangs, num_groups,
                                  active_axes=active_axes, explain=explain)
    if kernel == "serial":
        return plain
    from koordinator_tpu_torch.ops.full_chain_kernel import (
        build_cuda_full_chain_step,
    )

    cuda_step = build_cuda_full_chain_step(
        args, num_gangs, num_groups, active_axes=active_axes,
        smem_budget_bytes=smem_budget_bytes, explain=explain)

    def run(fc: FullChainInputs, extra, timings):
        if fc.base.allocatable.is_cuda:
            step.last_backend = "cuda"
            out = cuda_step(fc, *extra, timings=timings)
            step.last_state = cuda_step.last_state
            return out
        step.last_backend = "serial"
        step.last_state = None
        clock = SyncClock(timings, fc.base.allocatable.device)
        out = plain(fc, *extra)
        clock.lap("round")
        return out

    if explain is None:
        def step(fc: FullChainInputs, timings=None):
            """``timings``: a dict that the round fills with the seconds
            of its stages (round, and permit for the kernel's round),
            synchronising between them."""
            return run(fc, (), timings)
    else:
        def step(fc: FullChainInputs, n_real, timings=None):
            return run(fc, (n_real,), timings)

    step.last_backend = None
    step.last_state = None
    return step
