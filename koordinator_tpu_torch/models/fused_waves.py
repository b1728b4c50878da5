"""Fused multi-wave scheduling: K dependent rounds per device dispatch.

One dispatch runs up to K WAVES, where wave w is exactly the scheduling
round serial cycle w would run (the JAX package's models/fused_waves.py has
the contract; this module keeps its names and its pass order):

  wave body =
    0. carried-transition pre-passes, only while Pending reservations ride
       the batch: the reservation reconcile's consumed-allocate-once
       transition (0a) and the nomination pre-pass (0b), owner pods
       binding onto reservations that became Available in an EARLIER wave
       of the dispatch;
    1. evaluation pass: the serial full-chain round over the still-active
       pods at the carried state, producing tentative bindings (only the
       node per pod is used; the round's state is thrown away);
    2. gang Permit against the CARRIED assumed counters;
    3. kept-only replay: the next wave's state is rebuilt from the
       wave-start state by committing ONLY the pods that survived Permit,
       in queue order, with the NUMA zone re-picked under the replay state.
       Reservation pseudo-pod rows commit their CARRY form (the allocatable
       vector the restore transformer would add; no pod-count slot, no
       LoadAware estimate, no NUMA or affinity footprint).
    then the wave boundary: the claim columns, reservation rows becoming
    Available, the gang counters, the assigned mask.

Carried state (``WAVE_STATE_FIELDS``) stays on the inputs' device between
waves; feature-absent slots are None.

For CUDA tensors pass 1 is the full-chain kernel (ops/full_chain_kernel.py
``full_chain_round``) over ``fc_w`` and pass 3 the node-parallel replay
(``full_chain_replay``); Permit and the boundary are torch on the card, and
a wave queues its work without a host sync. Pre-passes 0a/0b are torch on
the card's tensors, a loop over pods that reads each decision back: slow at
a large P, and run only while reservations ride the batch. For CPU tensors
pass 1 is the plain round's loop (models/full_chain.py) and pass 3 the
plain ``replay_kept``. The choice reads only the inputs' device, unless
the caller hands the body its own passes (``WaveBackend``): the mesh of
cards' exchange route (parallel/full_chain_mesh.py) runs the same body
with its node-axis state on the cards' shards.

Two dispatch shapes share the one wave body (``_make_wave_body``):

  * ``build_fused_wave_step``: all K waves in one call, compacted
    (pod, node, zone, reservation) rows at the end. It reads each wave's
    count (4 bytes) to stop at the fixpoint: a wave that commits nothing
    (and leaves no carried transition pending) proves the next would
    commit nothing again, and ``waves_run`` says how many ran.
  * ``build_chained_wave_step``: ONE wave per call with the carry staying
    on the device, so the Scheduler can dispatch wave w+1 before it
    reads wave w's rows back and replay wave w on the host meanwhile.

koordexplain (``explain="counts"|"full"``) adds outputs only: each wave's
stage counts at its wave-START state (after the pre-passes: the state
serial cycle w's packed batch holds), from the CUDA pass of
ops/explain_kernel.py on the card (``WaveBackend.round_counts``: on pass
1's packed records, beside pass 1) and the plain explain_stage_counts on
the CPU; and at "full" the pass-1 terms rows, carried in the ``ex_terms``
slot after WAVE_STATE_FIELDS, where the wave that finally keeps a pod
writes its row (pass 1 in the full-chain kernel's terms instance on the
card). The replay pass evaluates nothing and does not change.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from koordinator_tpu_torch.models.full_chain import (
    EXPLAIN_TERMS,
    NUM_EXPLAIN_STAGES,
    ExplainOut,
    FullChainInputs,
    _check_explain,
    commit_pod_state,
    cycle_start_state,
    plain_round,
    resolve_balance_idx,
)
from koordinator_tpu_torch.models.scheduler_model import resolve_weight_idx
from koordinator_tpu_torch.ops.gang import gang_permit_mask
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.ops.numa import numa_zone_for_node
from koordinator_tpu_torch.ops.volumes import (
    advance_claim_state,
    effective_vol_needed,
)

MAX_WAVES = 8  # bounds the step-cache key space; auto-K never exceeds it

# carried wave state: the chain step's explicit carry, built by
# initial_wave_carry and threaded back in unchanged. Slots whose feature is
# off for the dispatch (no prod scoring / no hot claims / no pending
# reservation CRs) carry None.
WAVE_STATE_FIELDS = (
    "assigned", "requested", "est_sum", "numa_free", "bind_free",
    "quota_used", "aff_count", "anti_cover", "aff_exists", "port_used",
    "vol_free", "gang_assumed",
    "est_sum_prod",   # [N, R] prod assigned-estimate sum (prod mode only)
    "claim_new",      # [N, NC] hot claims newly attached per node
    "vol_new",        # [N] non-hot new attachments per node
    "res_avail",      # [NRES] reservation row became Available in-dispatch
    "res_remain",     # [NRES, R] packed allocatable remainder
    "res_node",       # [NRES] int32 node the row bound to (-1 pending)
    "res_succ",       # [NRES] int32 consumer pod row whose allocate-once
                      # consumption applies the Succeeded transition at
                      # the NEXT wave boundary (-1 none)
)
NUM_WAVE_STATE = len(WAVE_STATE_FIELDS)

# the JAX package's out-block offsets after the carry (its while_loop
# carry layout); the port returns the out block as WaveChainOut /
# FusedWaveOut fields instead
_OUT_PODS = NUM_WAVE_STATE
_OUT_NODES = NUM_WAVE_STATE + 1
_OUT_ZONES = NUM_WAVE_STATE + 2
_OUT_RES = NUM_WAVE_STATE + 3
_N_OUT = NUM_WAVE_STATE + 4
_WAVE_COUNTS = NUM_WAVE_STATE + 5

# nomination rank sentinel
_RANK_INF = 2**31 - 1


class ProdSides(NamedTuple):
    """scoreAccordingProdUsage term split (ops/loadaware.py exports)."""

    est: Any   # [N, R] la_est_prod — prod assigned-estimate sum at start
    adj: Any   # [N, R] la_adj_prod — non-estimated prod usage, static


class ClaimSides(NamedTuple):
    """Hot-claim factorization (ops/volumes.build_claim_pack)."""

    pod_claim: Any   # [P, NC] f32 0/1 — pod references hot claim c
    pod_nonhot: Any  # [P] f32 — the pod's non-hot distinct-claim count
    covered0: Any    # [N, NC] f32 0/1 — attached on node at dispatch start


class ResSides(NamedTuple):
    """Pending-reservation rows riding the batch (one per Reservation CR
    pseudo-pod; scheduler/cycle.py builds these in packed order)."""

    owner_match: Any  # [P, NRES] bool — res.matches(pod), host precompute
    rank: Any         # [NRES] int32 nomination preference (creation order)
    alloc: Any        # [NRES, R] f32 packed template requests (the
                      # restore-transformer add vector; no pod-count slot)
    once: Any         # [NRES] f32 0/1 allocate_once
    row_of: Any       # [NRES] int32 pseudo-pod row of each reservation
    pod_slot: Any     # [P] int32 reservation slot of a pseudo-pod row (-1)
    nominate_ok: Any  # [P] bool — host pre-pass eligibility class


class WaveSideInputs(NamedTuple):
    """Per-dispatch side operands of the fused/chained wave steps.
    ``prod``/``claims``/``res`` are None when the feature is absent."""

    la_est: Any                     # [N, R] la_est_nonprod
    la_adj: Any                     # [N, R] la_adj_nonprod
    prod: Optional[ProdSides] = None
    claims: Optional[ClaimSides] = None
    res: Optional[ResSides] = None


class FusedWaveOut(NamedTuple):
    """Compacted readback of one fused dispatch."""

    bind_pods: torch.Tensor    # [P] int32 pod rows in bind order, -1 pad
    bind_nodes: torch.Tensor   # [P] int32 node index per binding
    bind_zones: torch.Tensor   # [P] int32 replay-state NUMA zone (-1 spread)
    bind_res: torch.Tensor     # [P] int32 reservation slot consumed via
    #     in-dispatch nomination (-1 = plain kernel bind)
    wave_counts: torch.Tensor  # [K] int32 bindings committed per wave
    waves_run: int             # wave bodies actually executed


class WaveChainOut(NamedTuple):
    """Compacted readback of ONE chained wave dispatch."""

    bind_pods: torch.Tensor   # [P] int32 this wave's pod rows in bind order
    bind_nodes: torch.Tensor  # [P] int32 node index per binding
    bind_zones: torch.Tensor  # [P] int32 replay-state NUMA zone (-1 spread)
    bind_res: torch.Tensor    # [P] int32 nomination reservation slot (-1)
    count: torch.Tensor       # 0-d int32 bindings this wave (0 = fixpoint)


def plain_sides(la_est, la_adj) -> WaveSideInputs:
    """The featureless side tuple (tests, benches): nonprod split only."""
    return WaveSideInputs(la_est=la_est, la_adj=la_adj)


def _check_wave_args(args: LoadAwareArgs, sides_prod: bool) -> None:
    if args.score_according_prod_usage != sides_prod:
        raise ValueError(
            "WaveSideInputs.prod must be supplied exactly when "
            "score_according_prod_usage is on (the prod term split "
            "la_est_prod/la_adj_prod rides the carry)")


def _carry_fc_variants(fc: FullChainInputs, sides: WaveSideInputs):
    """The per-row-kind input variants of the kept-only replay and the
    nomination pre-pass.

    ``fc_carry``: reservation pseudo-pod rows commit their CARRY form — the
    packed allocatable vector (what the restore transformer adds at the
    next serial rebuild: no pod-count slot), no LoadAware estimate, no NUMA
    fill, no affinity footprint — a bound CR holds capacity but is not a
    pod. ``fc_nom``: nominated pods commit everything EXCEPT the node's
    requested row — a consumer's usage lives inside the reservation's
    already-counted footprint."""
    inputs = fc.base
    if sides.res is None:
        fc_carry = fc
    else:
        slot = sides.res.pod_slot
        is_res = slot >= 0
        alloc_rows = sides.res.alloc[torch.clamp_min(slot, 0).long()]
        fc_carry = fc._replace(
            base=inputs._replace(
                fit_requests=torch.where(is_res[:, None], alloc_rows,
                                         inputs.fit_requests),
                estimated=torch.where(is_res[:, None], 0.0,
                                      inputs.estimated),
            ),
            needs_numa=fc.needs_numa & ~is_res,
            pod_aff_match=fc.pod_aff_match & ~is_res[:, None],
            pod_anti_req=fc.pod_anti_req & ~is_res[:, None],
        )
    fc_nom = fc._replace(
        base=inputs._replace(
            fit_requests=torch.zeros_like(inputs.fit_requests)))
    return fc_carry, fc_nom


class WaveBackend:
    """The wave body's node-axis passes: ``round`` is pass 1 (chosen [P]
    first, the terms rows last under ``terms``), ``replay`` pass 3
    ((state', zones)), ``counts`` the stage counts at a state and
    ``zeros`` node-axis f32 zeros shaped like a state row; and the pieces
    that index node rows by a global node index or rewrite every node row
    at once: ``succeeded_fold`` (pass 0a), ``nominate`` (pass 0b's commit
    of one nomination), ``claim_view`` and ``advance_claims`` (the hot
    claims' volume view and wave-boundary update) and ``score_passes``.
    This one runs them on the inputs' device: the kernels for CUDA
    tensors, the plain passes for CPU tensors."""

    def __init__(self, cuda: bool) -> None:
        self.cuda = cuda

    def round(self, fc_k, weight_idx, prod_mode, bal_idx, terms: bool):
        if self.cuda:
            from koordinator_tpu_torch.ops.full_chain_kernel import (
                full_chain_round,
            )

            return full_chain_round(fc_k, weight_idx, prod_mode, bal_idx,
                                    terms=terms)
        return plain_round(fc_k, weight_idx, prod_mode, bal_idx,
                           terms=terms)

    def replay(self, fc_carry, chosen, kept, state0, prod_mode):
        if self.cuda:
            from koordinator_tpu_torch.ops.full_chain_kernel import (
                full_chain_replay,
            )

            return full_chain_replay(fc_carry, chosen, kept, state0,
                                     prod_mode)
        return replay_kept(fc_carry, prod_mode, state0, chosen, kept)

    def counts(self, fc_k, state, n_real):
        from koordinator_tpu_torch.ops.explain_kernel import explain_counts

        return explain_counts(fc_k, state, n_real)

    def round_counts(self, fc_k, weight_idx, prod_mode, bal_idx,
                     terms: bool, n_real):
        """(pass 1's outputs, the wave's stage counts at ``fc_k``'s own
        state). On the card the pass takes the round's packed records and
        runs beside it (full_chain_round's ``counts_n_real``)."""
        if self.cuda:
            from koordinator_tpu_torch.ops.full_chain_kernel import (
                full_chain_round,
            )

            out = full_chain_round(fc_k, weight_idx, prod_mode, bal_idx,
                                   terms=terms, counts_n_real=n_real)
            return out[:-1], out[-1]
        counts = self.counts(fc_k, cycle_start_state(fc_k), n_real)
        return self.round(fc_k, weight_idx, prod_mode, bal_idx,
                          terms), counts

    def zeros(self, like):
        return torch.zeros(tuple(like.shape), dtype=torch.float32,
                           device=like.device)

    def succeeded_fold(self, requested, res_succ, res_node, fit_requests,
                       alloc):
        """Pass 0a: each allocate-once row consumed a wave ago adds its
        consumer's fit requests less the row's allocatable to its node's
        requested row. Integer-valued packed units: exact in any
        grouping."""
        requested = requested.clone()
        for r in torch.nonzero(res_succ >= 0).flatten().tolist():
            p = int(res_succ[r])
            noden = max(int(res_node[r]), 0)
            delta = fit_requests[p] - alloc[r]
            requested[noden] = requested[noden] + 1.0 * delta
        return requested

    def nominate(self, fc, fc_nom, prod_mode, chain, i, noden):
        """Pass 0b's commit of pod ``i`` onto node ``noden`` (0-d): the
        NUMA zone picked under ``chain`` (the 11-tuple, updated in place),
        then everything but the node's requested row. Returns (chain,
        zone)."""
        zone = numa_zone_for_node(fc.requests[i], fc.needs_numa[i],
                                  chain[3][noden], fc.numa_policy[noden])
        found = torch.ones((), dtype=torch.bool, device=zone.device)
        chain = commit_pod_state(fc_nom, prod_mode, chain, i, found, noden,
                                 zone)
        return chain, zone

    def claim_view(self, fc, claims, claim_new):
        """(vol_needed, node_vol_group) of a wave: the per-(pod, node)
        volume view at the wave-start claim state, one group per node."""
        N = fc.base.allocatable.shape[0]
        return (effective_vol_needed(fc.vol_needed, fc.node_vol_group,
                                     claims.pod_claim, claim_new),
                torch.arange(N, dtype=torch.int32,
                             device=fc.base.fit_requests.device))

    def advance_claims(self, chosen, kept, claims, claim_new, vol_new,
                       vol_free0):
        """The wave boundary's claim state (ops/volumes.advance_claim_state):
        (claim_new', vol_new', vol_free')."""
        return advance_claim_state(chosen, kept, claims.pod_claim,
                                   claims.pod_nonhot, claims.covered0,
                                   claim_new, vol_new, vol_free0)

    def score_passes(self, fc_w, passes):
        """The device-expressible ScoreTransformers' passes over a wave's
        inputs, in order."""
        for tf in passes:
            fc_w = tf(fc_w)
        return fc_w


def _round_state(requested, delta_np, delta_pr, numa_free, bind_free,
                 quota_used, aff_count, anti_cover, aff_exists, port_used,
                 vol_free):
    """A private copy of the 11-tuple the round and the replay update in
    place (models/full_chain.commit_pod_state's layout)."""
    return tuple(t.clone() for t in (
        requested, delta_np, delta_pr, numa_free, bind_free, quota_used,
        aff_count, anti_cover, aff_exists, port_used, vol_free))


def replay_kept(fc_carry: FullChainInputs, prod_mode: bool, state, chosen,
                kept):
    """Pass 3 in plain torch: commit the kept pods in queue order onto
    their chosen nodes from ``state`` (the 11-tuple, not modified), the
    NUMA zone re-picked under the replay state. Returns (state', zones[P]
    int32, -1 outside the kept pods). The loop of commit_pod_state the JAX
    package runs as a fori_loop; pods not kept commit nothing there and are
    skipped here."""
    P = chosen.shape[0]
    dev = chosen.device
    st = _round_state(*state)
    zones = torch.full((P,), -1, dtype=torch.int32, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    for i in torch.nonzero(kept).flatten().tolist():
        best = torch.clamp_min(chosen[i], 0).long()
        zone = numa_zone_for_node(
            fc_carry.requests[i], fc_carry.needs_numa[i], st[3][best],
            fc_carry.numa_policy[best])
        st = commit_pod_state(fc_carry, prod_mode, st, i, yes, best, zone)
        zones[i] = zone
    return st, zones


def _nomination_prepass(fc, fc_nom, sides, prod_mode, chain, res_avail,
                        res_remain, res_succ, res_node, assigned, backend):
    """Pass 0b: owner pods, in queue order, bind onto reservation rows that
    became Available in an earlier wave of the dispatch, consuming their
    carried remainders; the earliest-created fitting candidate wins (the
    host nominator's sort). Commits everything but the node's requested
    row (``fc_nom``, ``backend.nominate``). The choice reads only the
    pod-level reservation state. Reads each pod's decision back to the
    host.

    Returns (chain, res_avail, res_remain, res_succ, assigned, rows) with
    rows the nominations' (pod, node, zone, slot) in order."""
    inputs = fc.base
    res = sides.res
    dev = inputs.fit_requests.device
    rank_inf = torch.tensor(_RANK_INF, dtype=torch.int32, device=dev)
    res_avail, res_remain = res_avail.clone(), res_remain.clone()
    res_succ, assigned = res_succ.clone(), assigned.clone()
    rows = []
    eligible = res.nominate_ok & ~assigned & inputs.pod_valid
    for i in torch.nonzero(eligible).flatten().tolist():
        req = fc.requests[i]
        fits = ((req[None, :] <= 0) | (req[None, :] <= res_remain)).all(dim=1)
        cand = (res_avail > 0.5) & res.owner_match[i] & fits
        if not bool(cand.any()):
            continue
        r = int(torch.argmin(torch.where(cand, res.rank, rank_inf)))
        noden = torch.clamp_min(res_node[r], 0).long()
        chain, zone = backend.nominate(fc, fc_nom, prod_mode, chain, i,
                                       noden)
        res_remain[r] = res_remain[r] + (-1.0 * req)
        if float(res.once[r]) > 0.5:
            # allocate-once: the consumed row leaves the candidate set and
            # arms the next wave's Succeeded transition
            res_avail[r] = res_avail[r] + (-1.0 * res_avail[r])
            res_succ[r] = i
        assigned[i] = True
        rows.append((i, int(res_node[r]), int(zone), r))
    return chain, res_avail, res_remain, res_succ, assigned, rows


def _make_wave_body(fc: FullChainInputs, sides: WaveSideInputs, weight_idx,
                    bal_idx, num_gangs: int, num_groups: int,
                    prod_mode: bool, score_passes=(), explain=None,
                    n_real=None, backend=None):
    """The ONE wave body both dispatch shapes run: carry (WAVE_STATE_FIELDS
    layout, then ``ex_terms`` under explain "full") -> (carry', WaveChainOut,
    done, counts_w), done a 0-d bool tensor (the fixpoint) and counts_w
    the wave's [P, 11] stage counts at wave-start state (None with explain
    off). Pass 1, pass 3 and the counts are ``backend``'s (WaveBackend
    when None: the kernels for CUDA tensors and the plain versions for CPU
    tensors)."""
    inputs = fc.base
    P, R = inputs.fit_requests.shape
    dev = inputs.fit_requests.device
    if backend is None:
        backend = WaveBackend(inputs.allocatable.is_cuda)
    has_claims = sides.claims is not None
    has_res = sides.res is not None
    fc_carry, fc_nom = _carry_fc_variants(fc, sides)
    i32 = torch.int32
    in_gang = fc.gang_id >= 0
    gang_idx = torch.clamp_min(fc.gang_id, 0).long()

    full = explain == "full"

    def wave_body(carry):
        (assigned, requested, est_sum, numa_free, bind_free, quota_used,
         aff_count, anti_cover, aff_exists, port_used, vol_free,
         gang_assumed, est_sum_prod, claim_new, vol_new, res_avail,
         res_remain, res_node, res_succ) = carry[:NUM_WAVE_STATE]
        ex_terms = carry[NUM_WAVE_STATE] if full else None
        nom_rows = []
        if has_res:
            # ---- pass 0a: the reservation reconcile's Succeeded
            # transition, one wave after an allocate-once consumption: the
            # reservation stops being counted and its consumer falls back
            # to direct accounting — (requested - alloc) + consumer_fit.
            # Integer-valued packed units: exact in any grouping.
            requested = backend.succeeded_fold(
                requested, res_succ, res_node, inputs.fit_requests,
                sides.res.alloc)
            res_succ = torch.full_like(res_succ, -1)
            # ---- pass 0b: the nomination pre-pass over carried
            # reservation state
            est_pr_state = (est_sum_prod if prod_mode
                            else backend.zeros(est_sum))
            chain = _round_state(requested, est_sum, est_pr_state,
                                 numa_free, bind_free, quota_used,
                                 aff_count, anti_cover, aff_exists,
                                 port_used, vol_free)
            (chain, res_avail, res_remain, res_succ, assigned,
             nom_rows) = _nomination_prepass(
                 fc, fc_nom, sides, prod_mode, chain, res_avail, res_remain,
                 res_succ, res_node, assigned, backend)
            (requested, est_sum, est_pr_state, numa_free, bind_free,
             quota_used, aff_count, anti_cover, aff_exists, port_used,
             vol_free) = chain
            if prod_mode:
                est_sum_prod = est_pr_state

        # the round's LoadAware base term, rebuilt-association exact:
        # est_sum folds committed estimates in bind order onto the host's
        # initial sum, then ONE add of the adjusted usage
        term = est_sum + sides.la_adj
        active = inputs.pod_valid & ~assigned
        base_w = inputs._replace(la_term_nonprod=term, pod_valid=active)
        if prod_mode:
            base_w = base_w._replace(
                la_term_prod=est_sum_prod + sides.prod.adj)
        fc_w = fc._replace(base=base_w)
        if has_claims:
            # the per-(pod, node) volume view at wave-start claim state
            vol_needed, vol_group = backend.claim_view(fc, sides.claims,
                                                       claim_new)
            fc_w = fc_w._replace(vol_needed=vol_needed,
                                 node_vol_group=vol_group)
        if score_passes:
            # device-expressible ScoreTransformers (frameworkext.py),
            # re-applied to each wave's rebuilt inputs
            fc_w = backend.score_passes(fc_w, score_passes)

        # ---- pass 1: the serial round at the carried state; only its
        # node per pod is used. fc_w keeps the dispatch-start
        # gang_assumed (the round's gang pre-filter reads that)
        fc_k = fc_w._replace(
            base=fc_w.base._replace(requested=requested),
            numa_free=numa_free, bind_free=bind_free,
            quota_used=quota_used, aff_count=aff_count,
            anti_cover=anti_cover, aff_exists=aff_exists,
            port_used=port_used, vol_free=vol_free)
        if explain is None:
            pass1 = backend.round(fc_k, weight_idx, prod_mode, bal_idx, full)
            counts_w = None
        else:
            # with the per-wave attribution at wave-START state (after the
            # pre-passes): the counts logical cycle w formats for the pods
            # it leaves unbound
            pass1, counts_w = backend.round_counts(
                fc_k, weight_idx, prod_mode, bal_idx, full, n_real)
        chosen = pass1[0]

        # ---- Permit against the CARRIED assumed counters
        keep = gang_permit_mask(chosen, fc.gang_id, fc.gang_min_member,
                                gang_assumed, fc.gang_group_id, num_gangs,
                                num_groups)
        kept = (chosen >= 0) & keep
        if full:
            # the wave that finally KEEPS a pod owns its attribution row
            # (a Permit-reverted choice never persisted host-side)
            ex_terms = torch.where(kept[:, None], pass1[-1], ex_terms)

        # ---- pass 3: kept-only replay from the WAVE-START state;
        # est_sum rides the delta_np slot (est_sum_prod the delta_pr slot)
        # so the fold order matches the assign-cache append order
        state0 = (requested, est_sum,
                  est_sum_prod if prod_mode else backend.zeros(requested),
                  numa_free, bind_free, quota_used, aff_count, anti_cover,
                  aff_exists, port_used, vol_free)
        rout, zones = backend.replay(fc_carry, chosen, kept, state0,
                                     prod_mode)
        (requested, est_sum, est_pr_out, numa_free, bind_free, quota_used,
         aff_count, anti_cover, aff_exists, port_used, vol_free) = rout
        if prod_mode:
            est_sum_prod = est_pr_out

        # ---- the compacted rows: nominations first, then the kept pods
        # in queue order (a scatter into a buffer with one spare slot, so
        # nothing is read back)
        n_nom = len(nom_rows)
        slot = torch.where(kept, n_nom + torch.cumsum(kept.to(i32), 0) - 1,
                           P)
        rows = [torch.full((P + 1,), -1, dtype=i32, device=dev)
                for _ in range(4)]
        pod_ids = torch.arange(P, dtype=i32, device=dev)
        for buf, val in zip(rows[:3], (pod_ids, chosen.to(i32), zones)):
            buf.scatter_(0, slot.long(), val)
        if nom_rows:
            nom = torch.tensor(nom_rows, dtype=i32, device=dev)
            for k, buf in enumerate(rows):
                buf[:n_nom] = nom[:, k]
        rows = [buf[:P] for buf in rows]
        kept_count = kept.to(i32).sum()

        # the vol_needed the passes above used is FROZEN wave-start state;
        # the boundary rebuilds the claim columns and the attachable count
        # set-wise (ops/volumes.py)
        if has_claims:
            claim_new, vol_new, vol_free = backend.advance_claims(
                chosen, kept, sides.claims, claim_new, vol_new, fc.vol_free)
        if has_res:
            # a KEPT reservation pseudo-pod row turned its CR Available on
            # its chosen node: consumable by the NEXT wave's pass 0b
            rowsel = sides.res.row_of
            rowc = torch.clamp_min(rowsel, 0).long()
            became = ((rowsel >= 0) & kept[rowc]).to(torch.float32)
            res_avail = res_avail + became
            res_node = torch.where(became > 0.5, chosen[rowc], res_node)

        gang_assumed = gang_assumed + torch.zeros(
            num_gangs, dtype=torch.float32, device=dev).index_add_(
                0, gang_idx, (kept & in_gang).to(torch.float32))
        assigned = assigned | kept
        count = (kept_count + n_nom).to(i32)
        done = count == 0
        if has_res:
            done = done & ~(res_succ >= 0).any()
        new_carry = (assigned, requested, est_sum, numa_free, bind_free,
                     quota_used, aff_count, anti_cover, aff_exists,
                     port_used, vol_free, gang_assumed,
                     est_sum_prod if prod_mode else None,
                     claim_new if has_claims else None,
                     vol_new if has_claims else None,
                     res_avail if has_res else None,
                     res_remain if has_res else None,
                     res_node if has_res else None,
                     res_succ if has_res else None)
        if full:
            new_carry = new_carry + (ex_terms,)
        return new_carry, WaveChainOut(*rows, count), done, counts_w

    return wave_body


def initial_wave_carry(fc: FullChainInputs, sides: WaveSideInputs,
                       explain=None, backend=None):
    """The wave-0 carry (WAVE_STATE_FIELDS layout), on the inputs' device.
    Feature-absent slots are None. Under explain "full" the carry also
    holds the per-pod terms rows (zeros; the wave that keeps a pod writes
    its row). ``backend`` makes the node-axis zeros (WaveBackend by the
    inputs' device when None)."""
    _check_explain(explain)
    P = fc.base.fit_requests.shape[0]
    dev = fc.base.fit_requests.device
    f32 = torch.float32
    if backend is None:
        backend = WaveBackend(fc.base.allocatable.is_cuda)
    if sides.claims is not None:
        # [N, NC] and [N]: shaped like the dispatch-start coverage and the
        # volume headroom
        claim_new0 = backend.zeros(sides.claims.covered0)
        vol_new0 = backend.zeros(fc.vol_free)
    else:
        claim_new0 = vol_new0 = None
    if sides.res is not None:
        nres = sides.res.rank.shape[0]
        res_avail0 = torch.zeros(nres, dtype=f32, device=dev)
        # a Pending CR entering the batch has nothing allocated yet: the
        # full packed template is the remainder
        res_remain0 = sides.res.alloc.to(f32).clone()
        res_node0 = torch.full((nres,), -1, dtype=torch.int32, device=dev)
        res_succ0 = torch.full((nres,), -1, dtype=torch.int32, device=dev)
    else:
        res_avail0 = res_remain0 = res_node0 = res_succ0 = None
    carry = (
        torch.zeros(P, dtype=torch.bool, device=dev),
        fc.base.requested,
        sides.la_est,
        fc.numa_free,
        fc.bind_free,
        fc.quota_used,
        fc.aff_count,
        fc.anti_cover,
        fc.aff_exists.to(torch.bool),
        fc.port_used,
        fc.vol_free,
        fc.gang_assumed,
        sides.prod.est if sides.prod is not None else None,
        claim_new0,
        vol_new0,
        res_avail0,
        res_remain0,
        res_node0,
        res_succ0,
    )
    if explain == "full":
        carry = carry + (torch.zeros((P, len(EXPLAIN_TERMS)), dtype=f32,
                                     device=dev),)
    return carry


def build_fused_wave_step(args: LoadAwareArgs, num_gangs: int,
                          num_groups: int, waves: int, active_axes=None,
                          explain=None, prod: bool = False,
                          claims: bool = False, res: bool = False,
                          score_passes=(), backend=None):
    """(FullChainInputs, WaveSideInputs) -> FusedWaveOut: up to ``waves``
    waves in one call, on the inputs' device.

    ``sides`` carries the LoadAware nonprod score-term split, sliced to the
    same active axes as the batch, plus the optional prod split, hot-claim
    factorization and reservation rows; ``prod``/``claims``/``res`` pin
    which optional blocks the step expects (the Scheduler keys its step cache
    on them). After each wave the step reads its count back and stops at
    the fixpoint (a wave that commits nothing and leaves no carried
    transition pending), so ``waves_run`` may be below ``waves``; the
    counts of the waves not run are 0.

    ``explain`` ("counts" | "full"): the step takes the extra ``n_real``
    and returns (FusedWaveOut, ExplainOut) with per-WAVE stage counts
    [waves, P, NUM_EXPLAIN_STAGES], each wave's row at its wave-start
    state (the rows of waves not run stay 0), and at "full" the terms
    rows of the wave that kept each pod. ``backend``: the wave body's
    passes (WaveBackend by the inputs' device when None)."""
    if not 1 <= waves <= MAX_WAVES:
        raise ValueError(f"waves must be in [1, {MAX_WAVES}], got {waves}")
    _check_wave_args(args, prod)
    _check_explain(explain)
    weight_idx = resolve_weight_idx(args, active_axes)
    bal_idx = resolve_balance_idx(active_axes)
    prod_mode = args.score_according_prod_usage

    def run(fc: FullChainInputs, sides: WaveSideInputs, n_real):
        P = fc.base.fit_requests.shape[0]
        dev = fc.base.fit_requests.device
        body = _make_wave_body(fc, sides, weight_idx, bal_idx, num_gangs,
                               num_groups, prod_mode,
                               score_passes=score_passes, explain=explain,
                               n_real=n_real, backend=backend)
        carry = initial_wave_carry(fc, sides, explain=explain,
                                   backend=backend)
        out = [torch.full((P,), -1, dtype=torch.int32, device=dev)
               for _ in range(4)]
        counts = torch.zeros(waves, dtype=torch.int32, device=dev)
        ex_counts = (torch.zeros((waves, P, NUM_EXPLAIN_STAGES),
                                 dtype=torch.uint32, device=dev)
                     if explain is not None else None)
        n_out = w = 0
        while w < waves:
            carry, rows, done, counts_w = body(carry)
            if ex_counts is not None:
                ex_counts[w] = counts_w
            # the fixpoint read: this wave's count and done flag
            cnt, fin = (int(v) for v in torch.stack(
                [rows.count, done.to(torch.int32)]).cpu())
            for buf, src in zip(out, rows[:4]):
                buf[n_out:n_out + cnt] = src[:cnt]
            counts[w] = cnt
            n_out += cnt
            w += 1
            if fin:
                break
        fw = FusedWaveOut(*out, wave_counts=counts, waves_run=w)
        if explain is None:
            return fw
        return fw, ExplainOut(
            ex_counts, carry[NUM_WAVE_STATE] if explain == "full" else None)

    if explain is None:
        def step(fc: FullChainInputs, sides: WaveSideInputs):
            return run(fc, sides, None)
    else:
        def step(fc: FullChainInputs, sides: WaveSideInputs, n_real):
            return run(fc, sides, n_real)

    return step


def build_chained_wave_step(args: LoadAwareArgs, num_gangs: int,
                            num_groups: int, active_axes=None, explain=None,
                            prod: bool = False, claims: bool = False,
                            res: bool = False, score_passes=(),
                            backend=None):
    """ONE wave per call, carried state on the inputs' device between calls.

    (FullChainInputs, carry, WaveSideInputs) -> (carry', WaveChainOut),
    where ``carry`` is the initial_wave_carry tuple or a previous call's
    output carry. On the card nothing in a call waits for the device
    (the pre-passes aside, which run only while reservations ride the
    batch): the caller dispatches wave w+1 before reading wave w's rows, so
    the host replay of wave w overlaps the device's work on wave w+1. A
    zero ``count`` is the fixpoint; the Scheduler stops consuming there.
    K-independent: every wave depth shares one step.

    ``explain`` ("counts" | "full"): the step takes the extra ``n_real``
    and returns (carry', WaveChainOut, counts_row[P, S]) — this wave's
    attribution at wave-START state, the row the fused step's [K, P, S]
    buffer holds at index w; at "full" the carry's ``ex_terms`` slot (from
    initial_wave_carry(explain="full")) carries the terms rows.
    ``backend``: the wave body's passes (WaveBackend by the inputs' device
    when None)."""
    _check_wave_args(args, prod)
    _check_explain(explain)
    weight_idx = resolve_weight_idx(args, active_axes)
    bal_idx = resolve_balance_idx(active_axes)
    prod_mode = args.score_according_prod_usage
    width = NUM_WAVE_STATE + (1 if explain == "full" else 0)

    def run(fc: FullChainInputs, carry, sides: WaveSideInputs, n_real):
        body = _make_wave_body(fc, sides, weight_idx, bal_idx, num_gangs,
                               num_groups, prod_mode,
                               score_passes=score_passes, explain=explain,
                               n_real=n_real, backend=backend)
        new_carry, rows, _done, counts_w = body(tuple(carry[:width]))
        if explain is None:
            return new_carry, rows
        return new_carry, rows, counts_w

    if explain is None:
        def step(fc: FullChainInputs, carry, sides: WaveSideInputs):
            return run(fc, carry, sides, None)
    else:
        def step(fc: FullChainInputs, carry, sides: WaveSideInputs,
                 n_real):
            return run(fc, carry, sides, n_real)

    return step
