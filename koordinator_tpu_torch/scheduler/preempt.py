"""ElasticQuota PostFilter preemption.

Reference: `pkg/scheduler/plugins/elasticquota/preempt.go:1-294` (+
`candidate.go`). Semantics kept:

  * canPreempt (preempt.go:276-294): a victim must belong to the SAME quota
    group as the preemptor, have strictly lower priority, and not carry
    `quota.scheduling.koordinator.sh/preemptible: "false"`
    (extension.IsPodNonPreemptible, apis/extension/elastic_quota.go:82-84).
  * usedLimit check (preempt.go:189-200): preemption frees quota `used` until
    used + podRequest <= runtimeQuota holds on EVERY ancestor of the group
    (the same recursive rule the admission kernel enforces, ops/quota.py).
  * minimal victim set with reprieve (preempt.go:154-215): tentatively remove
    all candidates, then re-add ("reprieve") from the most important down while
    the preemptor still fits. PDB-violating candidates are reprieved FIRST so
    the selected victims prefer pods whose budgets have headroom; as in
    upstream preemption, a PDB is advisory here — a violating victim is still
    evicted when no non-violating set suffices.
  * nominated-pod accounting (PostFilterState, plugin.go:57-72): within one
    PostFilter pass, earlier preemptors' requests count as used for later
    ones, so two starved pods in one group each claim their own victims
    instead of the second seeing phantom headroom.

Architecture note: victim selection is host control-plane work
(G ~ 10^2 groups, member lists are small); the *retry* after eviction is the
batched kernel itself — the cycle driver reruns the fused full-chain step once
after a successful preemption round, so a starved min-guaranteed group reclaims
within the same cycle instead of waiting for the next one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.api.objects import QUOTA_DOMAIN_PREFIX, Pod
from koordinator_tpu_torch.api.resources import NUM_RESOURCES
from koordinator_tpu_torch.client.store import KIND_POD, ObjectStore

LABEL_PREEMPTIBLE = QUOTA_DOMAIN_PREFIX + "/preemptible"


def is_pod_non_preemptible(pod: Pod) -> bool:
    """extension.IsPodNonPreemptible (elastic_quota.go:82-84)."""
    return pod.meta.labels.get(LABEL_PREEMPTIBLE, "") == "false"


class GangVictimGuard:
    """Gang all-or-nothing vs preemption.

    Evicting a bound gang member below its PodGroup's min_member
    silently breaks the barrier the admission kernel enforced at bind
    time — the koordsim churn soak caught DefaultPreemption doing
    exactly this to priority-less gang pods (the upstream vendored
    DefaultPreemption has the same hole; the coscheduling plugin only
    protects gangs BEFORE they bind). One guard instance spans a whole
    post_filter call, so victim sets chosen for different preemptors
    share one spare-member ledger:

      * ``protected(pod)`` — the pod's gang has no spare bound members:
        never a candidate;
      * ``admissible(victims)`` — would this victim set overdraw any
        gang's spare count? (two same-gang victims can each look fine
        alone);
      * ``commit(victims)`` — debit the ledger once a round is taken.

    Gangs whose bound count already sits below min_member (external
    lifecycle churn) have no spare either — preemption never makes a
    broken gang worse."""

    def __init__(self, store: ObjectStore, live=None) -> None:
        """``live``: an already-built list of assigned, non-terminated
        pods — callers that just walked the store (post_filter) pass it
        to avoid a second full O(|pods|) scan on the hot path."""
        from koordinator_tpu_torch.client.store import KIND_POD_GROUP

        mins = {g.meta.key: g.min_member
                for g in store.list(KIND_POD_GROUP)}
        if live is None:
            live = (p for p in store.list(KIND_POD)
                    if p.is_assigned and not p.is_terminated)
        bound: dict = {}
        for p in live:
            g = p.gang_key
            if g and g in mins:
                bound[g] = bound.get(g, 0) + 1
        self._spare = {g: bound[g] - mins[g] for g in bound}

    def protected(self, pod: Pod) -> bool:
        g = pod.gang_key
        return g in self._spare and self._spare[g] <= 0

    def admissible(self, victims) -> bool:
        taken: dict = {}
        for v in victims:
            g = v.gang_key
            if g in self._spare:
                taken[g] = taken.get(g, 0) + 1
        return all(self._spare[g] >= n for g, n in taken.items())

    def commit(self, victims) -> None:
        for v in victims:
            g = v.gang_key
            if g in self._spare:
                self._spare[g] -= 1


@dataclass
class PreemptionRound:
    """Outcome of one preemptor's PostFilter attempt."""

    preemptor_key: str
    quota_name: str
    victim_keys: List[str] = field(default_factory=list)


class QuotaPreemptor:
    """PostFilter path: evict lower-priority same-group pods to free quota."""

    def __init__(self, store: ObjectStore, quota_plugin) -> None:
        self.store = store
        self.plugin = quota_plugin

    # -- candidate selection -------------------------------------------
    def _quota_index(self) -> dict:
        """quota name -> assigned live member pods, built in ONE store walk.
        post_filter hands this to every _select_victims call instead of
        re-walking the whole store per rejected pod (at 10k+ pods x dozens
        of rejections that walk dominated the cycle)."""
        index: dict = {}
        for p in self.store.list(KIND_POD):
            q = p.quota_name
            if q and p.is_assigned and not p.is_terminated:
                index.setdefault(q, []).append(p)
        return index

    def _candidates(self, preemptor: Pod, quota_index: dict,
                    gang_guard: Optional["GangVictimGuard"] = None,
                    ) -> List[Pod]:
        """canPreempt filter: live assigned members of the preemptor's quota
        group with strictly lower priority, not marked non-preemptible, and
        not protected by their gang's min_member (GangVictimGuard)."""
        pri = preemptor.spec.priority or 0
        return [
            p
            for p in quota_index.get(preemptor.quota_name, ())
            if not p.is_terminated
            and (p.spec.priority or 0) < pri
            and not is_pod_non_preemptible(p)
            and not (gang_guard is not None and gang_guard.protected(p))
        ]

    @staticmethod
    def _importance_key(pod: Pod):
        """util.MoreImportantPod order: higher priority first, then longer
        running (older) first. Reprieve walks this order, so the final victims
        are the least important members."""
        return (-(pod.spec.priority or 0), pod.meta.creation_timestamp)

    @staticmethod
    def _fits(req: np.ndarray, chain: np.ndarray, used: np.ndarray,
              runtime: np.ndarray, freed: np.ndarray) -> bool:
        """checkQuotaRecursive with `freed` subtracted along the chain."""
        for g in chain:
            if g < 0:
                continue
            avail_used = np.maximum(used[g] - freed, 0.0)
            if ((req > 0) & (avail_used + req > runtime[g])).any():
                return False
        return True

    def _select_victims(
        self,
        preemptor: Pod,
        req: np.ndarray,
        chain: np.ndarray,
        used: np.ndarray,     # [G, R] incl. inflight nominations
        runtime: np.ndarray,  # [G, R]
        quota_index: Optional[dict] = None,
        gang_guard: Optional["GangVictimGuard"] = None,
    ) -> Optional[List[Pod]]:
        """Minimal victim set freeing enough quota, or None if preemption
        cannot help (no candidates / still over limit with all of them gone —
        preempt.go:149-163)."""
        candidates = self._candidates(
            preemptor,
            quota_index if quota_index is not None else self._quota_index(),
            gang_guard=gang_guard)
        if not candidates:
            return None
        freed_all = np.zeros(req.shape, np.float32)
        for c in candidates:
            freed_all += c.spec.requests.to_vector()
        if not self._fits(req, chain, used, runtime, freed_all):
            return None  # even evicting every candidate can't make room

        # classify by PDB headroom with a shared budget across the sorted list
        # (filterPodsWithPDBViolation keeps a pdbsAllowed counter, not a
        # per-pod check — two victims sharing one budget must not both pass)
        ordered = sorted(candidates, key=self._importance_key)
        violating, non_violating = self._split_by_pdb(ordered)

        victims: List[Pod] = []
        freed = freed_all.copy()
        for c in violating + non_violating:
            # reprieve: add c back unless the preemptor then stops fitting
            without = freed - c.spec.requests.to_vector()
            if self._fits(req, chain, used, runtime, without):
                freed = without
            else:
                victims.append(c)
        if victims and gang_guard is not None and (
                not gang_guard.admissible(victims)):
            # the minimal set needs more same-gang victims than the gang
            # has spare bound members: preemption cannot help without
            # breaking all-or-nothing — leave the gang whole
            return None
        return victims or None

    def _split_by_pdb(self, ordered: List[Pod]):
        """Stable split into (violating, non_violating) with shared
        DisruptionsAllowed budgets (preempt.go:219-268) — the module-level
        helpers, budgets computed fresh per call."""
        pdbs, allowed = pdb_disruption_budgets(self.store)
        return split_by_pdb(pdbs, allowed, ordered)

    # -- the PostFilter entry ------------------------------------------
    def post_filter(self, rejected: List[Pod]) -> List[PreemptionRound]:
        """One PostFilter pass over every quota-rejected pod, in queue order.

        The tree snapshot is built once and only rebuilt after a round that
        actually evicted (store `used` changed); earlier preemptors' requests
        ride an inflight ledger so later ones see them as used
        (PostFilterState nominated-pod accounting). The cycle driver reruns
        the batched kernel afterwards — victims terminate synchronously, so
        the retry binds the preemptors."""
        rounds: List[PreemptionRound] = []
        snap = self.plugin.tree_snapshot(self.store)
        if snap is None:
            return rounds
        tree, runtime = snap
        inflight: List[Tuple[str, np.ndarray]] = []  # (quota, request)

        def used_with_inflight() -> np.ndarray:
            extra = tree.used.copy()
            for qname, vec in inflight:
                gid = tree.index.get(qname)
                if gid is None:
                    continue
                for g in tree.ancestors[gid]:
                    if g >= 0:
                        extra[g] += vec
            return extra

        quota_index = self._quota_index()
        gang_guard = GangVictimGuard(self.store)
        for pod in rejected:
            gid = tree.index.get(pod.quota_name)
            if gid is None:
                continue
            chain = tree.ancestors[gid]
            req = pod.spec.requests.to_vector()
            used = used_with_inflight()
            if self._fits(req, chain, used, runtime, np.zeros_like(req)):
                # quota headroom exists. If an earlier round freed it, the pod
                # will bind on retry — account it for later preemptors. With
                # no evictions yet, the rejection wasn't quota-driven (node
                # fit etc.): adding it to the ledger would make later
                # preemptors evict victims for a pod that still can't bind.
                if rounds:
                    inflight.append((pod.quota_name, req))
                continue
            victims = self._select_victims(pod, req, chain, used, runtime,
                                           quota_index=quota_index,
                                           gang_guard=gang_guard)
            if not victims:
                continue
            rounds.append(evict_round(self.store, pod, victims))
            gang_guard.commit(victims)
            inflight.append((pod.quota_name, req))
            # evictions changed store-backed used (and group request):
            # rebuild the snapshot AND the candidate index
            snap = self.plugin.tree_snapshot(self.store)
            if snap is None:
                break
            tree, runtime = snap
            quota_index = self._quota_index()
        return rounds


def pdb_disruption_budgets(store: ObjectStore):
    """(pdbs, allowed): each PDB's DisruptionsAllowed computed once —
    preempt.go:219-268 / upstream filterPodsWithPDBViolation keep a shared
    counter per PDB, so callers hand split_by_pdb a COPY of `allowed`."""
    from koordinator_tpu_torch.client.store import KIND_PDB

    pdbs = list(store.list(KIND_PDB))
    if not pdbs:
        return [], []
    pods = list(store.list(KIND_POD))
    allowed: List[int] = []
    for pdb in pdbs:
        matching = [p for p in pods if pdb.matches(p)]
        healthy = sum(1 for p in matching if p.is_healthy)
        if pdb.min_available is not None:
            allowed.append(healthy - pdb.min_available)
        elif pdb.max_unavailable is not None:
            unavailable = len(matching) - healthy
            allowed.append(pdb.max_unavailable - unavailable)
        else:
            allowed.append(0)
    return pdbs, allowed


def split_by_pdb(pdbs, allowed: List[int], ordered: List[Pod]):
    """Stable split of `ordered` into (violating, non_violating), consuming
    the shared `allowed` budgets in order (the caller passes a copy)."""
    if not pdbs:
        return [], list(ordered)
    violating, non_violating = [], []
    for pod in ordered:
        violated = False
        for i, pdb in enumerate(pdbs):
            # an unhealthy victim consumes no budget and can never
            # violate: evicting it leaves the healthy count unchanged
            if not pdb.matches(pod) or not pod.is_healthy:
                continue
            allowed[i] -= 1
            if allowed[i] < 0:
                violated = True
        (violating if violated else non_violating).append(pod)
    return violating, non_violating


def evict_round(store: ObjectStore, preemptor: Pod,
                victims: List[Pod]) -> PreemptionRound:
    """Terminate the victims and record the round (shared by the quota and
    default preemptors)."""
    from koordinator_tpu_torch.descheduler.evictions import terminate_pod

    round_ = PreemptionRound(preemptor_key=preemptor.meta.key,
                             quota_name=preemptor.quota_name)
    for v in victims:
        terminate_pod(store, v, "koordinator.sh/preempted-by",
                      preemptor.meta.key)
        round_.victim_keys.append(v.meta.key)
    return round_


class DefaultPreemption:
    """Priority (pod-level) preemption — the analog of the vendored
    kube-scheduler DefaultPreemption PostFilter the reference binary ships.

    For each pod that failed Filter on every node, dry-run removing
    lower-priority victims per node host-side — static admission (taints +
    selector/affinity labels), resources (allocatable vs assigned
    requests), and the pod's required (anti-)affinity terms against the
    post-eviction state — reprieving candidates from the most important
    down, PDB-violating ones first, and pick the node upstream's
    pickOneNodeForPreemption would: fewest PDB violations, then lowest max
    victim priority, then smallest priority sum, then fewest victims.
    Earlier preemptors' requests ride a per-node inflight ledger so later
    ones don't count freed space twice. Victims terminate synchronously
    and the cycle driver reruns the batched kernel, which is the REAL
    feasibility gate (NUMA/cpuset/LoadAware/spread re-check there; the
    cycle's attempted-latch stops a pod that still cannot bind from
    draining victims every cycle).

    kernel_admission: the (node_name -> group id, pod key -> group bitmask)
    view of the LAST kernel pass's admission grouping (ops/taints.py). The
    raw label/taint dry-run can be more permissive than the kernel when the
    signature budget overflowed (a node degraded to its label-unknown
    bucket admits no selector pods there) — without this check the dry-run
    would accept a node the kernel can never bind and evict victims in
    vain every retry window."""

    def __init__(self, store: ObjectStore, kernel_admission=None,
                 attempt_seed: int = 0) -> None:
        self.store = store
        self._node_groups, self._pod_masks = kernel_admission or ({}, {})
        # rotates the candidate-sampling window across retry attempts
        # (upstream's random offset analog, deterministic here)
        self.attempt_seed = attempt_seed

    def _static_admission(self, pod: Pod, node) -> bool:
        from koordinator_tpu_torch.ops.taints import (
            required_node_pairs,
            tolerates_taints,
        )

        if node.unschedulable:
            return False
        if not tolerates_taints(pod.spec.tolerations, node.taints):
            return False
        labels = node.meta.labels
        if not all(labels.get(k) == v for k, v in required_node_pairs(pod)):
            return False
        # consult the kernel's admission grouping: the dry-run must never
        # accept a node the batched encoding cannot bind
        gid = self._node_groups.get(node.meta.name)
        mask = self._pod_masks.get(pod.meta.key)
        if gid is not None and mask is not None and not ((mask >> gid) & 1):
            return False
        return True

    @staticmethod
    def _affinity_feasible(pod: Pod, node, survivors: List[Pod],
                           nodes_by_name: Dict[str, object]) -> bool:
        """Required (anti-)affinity dry-run against the post-eviction pod
        set: every anti term has no surviving match in the node's domain,
        every affinity term keeps a match (or bootstraps). Without this, a
        pod blocked by kernel-only constraints would evict victims in vain
        every cycle."""
        from koordinator_tpu_torch.ops.podaffinity import _pod_matches, _term_key

        def domain_match(term, key) -> bool:
            dom = node.meta.labels.get(key)
            if dom is None:
                return False
            for other in survivors:
                onode = nodes_by_name.get(other.spec.node_name)
                if onode is None or onode.meta.labels.get(key) != dom:
                    continue
                if _pod_matches(term, other):
                    return True
            return False

        for raw in pod.spec.pod_anti_affinity:
            if node.meta.labels.get(raw.topology_key) is None:
                continue
            if domain_match(_term_key(raw, pod), raw.topology_key):
                return False
        # SYMMETRIC anti-affinity: a surviving pod CARRYING an anti term the
        # preemptor matches blocks its whole domain (the kernel enforces
        # this via anti_cover — the dry-run must not accept what the kernel
        # will reject, or victims die in vain every retry window)
        for other in survivors:
            for raw in other.spec.pod_anti_affinity:
                dom = node.meta.labels.get(raw.topology_key)
                if dom is None:
                    continue
                onode = nodes_by_name.get(other.spec.node_name)
                if onode is None or onode.meta.labels.get(
                        raw.topology_key) != dom:
                    continue
                if _pod_matches(_term_key(raw, other), pod):
                    return False
        for raw in pod.spec.pod_affinity:
            term = _term_key(raw, pod)
            if any(_pod_matches(term, o) for o in survivors):
                if not domain_match(term, raw.topology_key):
                    return False
            # no match anywhere: feasible only via self-match bootstrap
            elif not _pod_matches(term, pod):
                return False
        return True

    def post_filter(self, failed: List[Pod]) -> List[PreemptionRound]:
        from koordinator_tpu_torch.client.store import KIND_NODE

        nodes = list(self.store.list(KIND_NODE))
        nodes_by_name = {n.meta.name: n for n in nodes}
        live = [p for p in self.store.list(KIND_POD)
                if p.is_assigned and not p.is_terminated]
        by_node: Dict[str, List[Pod]] = {}
        req_of: Dict[str, np.ndarray] = {}
        for p in live:
            by_node.setdefault(p.spec.node_name, []).append(p)
            req_of[p.meta.key] = p.spec.requests.to_vector()
        pdbs, budgets = pdb_disruption_budgets(self.store)
        gang_guard = GangVictimGuard(self.store, live=live)
        evicted: set = set()
        inflight: Dict[str, np.ndarray] = {}  # node -> earlier preemptors' req

        # ---- packed node pre-filter (the dominant cost at scale was the
        # per-(pod, node) Python resource sums: |failed| x |nodes| x
        # |assigned| generator passes). Per node, precompute free capacity
        # and the prefix request sums of its preemptible pods sorted by
        # priority; per failed pod ONE vectorized pass yields the nodes
        # where free + gain(prio) covers the request AND the kernel's
        # admission bit admits the pod. The pre-filter itself is exact (an
        # over-approximation of the inner predicate, so no feasible node is
        # lost); the CANDIDATE CAP below is upstream's sampling semantics,
        # not a pure optimization.
        N = len(nodes)
        R = NUM_RESOURCES
        alloc_arr = np.zeros((N, R))
        unsched_arr = np.zeros(N, bool)
        gid_arr = np.full(N, -1, np.int64)
        for j, node in enumerate(nodes):
            alloc_arr[j] = node.allocatable.to_vector()
            unsched_arr[j] = node.unschedulable
            gid_arr[j] = self._node_groups.get(node.meta.name, -1)
        assigned_sum = np.zeros((N, R))
        node_prios: List[np.ndarray] = [None] * N
        node_prefix: List[np.ndarray] = [None] * N
        node_idx = {n.meta.name: j for j, n in enumerate(nodes)}

        def pack_node(j: int) -> None:
            name = nodes[j].meta.name
            assigned = [p for p in by_node.get(name, [])
                        if p.meta.key not in evicted]
            assigned_sum[j] = (
                np.sum([req_of[p.meta.key] for p in assigned], axis=0)
                if assigned else 0.0)
            cands = sorted(
                (p for p in assigned if not is_pod_non_preemptible(p)
                 and not gang_guard.protected(p)),
                key=lambda p: p.spec.priority or 0)
            node_prios[j] = np.asarray(
                [p.spec.priority or 0 for p in cands], np.int64)
            pref = np.zeros((len(cands) + 1, R))
            for k, p in enumerate(cands):
                pref[k + 1] = pref[k] + req_of[p.meta.key]
            node_prefix[j] = pref

        for j in range(N):
            pack_node(j)

        # ragged-but-flat gather tables (no N x kmax padding — a single
        # hot node with many preemptible pods must not inflate a dense
        # tensor): per-node candidate priorities and prefix sums
        # concatenated with offsets. Rebuilt wholesale after an eviction
        # repacks a node (one concatenate over ~|live| rows, rare).
        gather: Dict[str, np.ndarray] = {}

        def build_gather() -> None:
            offsets = np.zeros(N + 1, np.int64)
            for j in range(N):
                offsets[j + 1] = offsets[j] + node_prios[j].shape[0]
            gather["offsets"] = offsets
            gather["flat_prios"] = (
                np.concatenate(node_prios) if N and offsets[-1]
                else np.zeros(0, np.int64))
            gather["flat_prefix"] = (
                np.concatenate(node_prefix) if N
                else np.zeros((0, R)))
            # prefix rows: node j owns rows [offsets[j] + j,
            # offsets[j+1] + j + 1) — each node contributes k_j + 1 rows
            gather["prefix_base"] = offsets[:-1] + np.arange(N)

        build_gather()

        def feasible_nodes(pod: Pod, req: np.ndarray, prio: int):
            offsets = gather["offsets"]
            below = np.concatenate(
                [[0], np.cumsum(gather["flat_prios"] < prio)])
            counts = below[offsets[1:]] - below[offsets[:-1]]   # [N]
            gain = gather["flat_prefix"][gather["prefix_base"] + counts]
            free = alloc_arr - assigned_sum
            for name, vec in inflight.items():
                free[node_idx[name]] = free[node_idx[name]] - vec
            ok = ~unsched_arr & ((free + gain - req) >= 0).all(axis=1)
            mask = self._pod_masks.get(pod.meta.key)
            if mask is not None:
                known = gid_arr >= 0
                ok &= ~known | (
                    (mask >> np.maximum(gid_arr, 0)) & 1).astype(bool)
            return np.nonzero(ok)[0]

        # pods that can influence an (anti-)affinity dry-run: carriers of
        # anti terms plus (per preemptor, below) pods matching its own
        # terms. _affinity_feasible only ever consults these, so the
        # survivor set passed in shrinks from |live| to |relevant| —
        # everything else cannot change any verdict.
        anti_carriers = [p for p in live if p.spec.pod_anti_affinity]

        def relevant_for(pod: Pod) -> List[Pod]:
            if not (anti_carriers or pod.spec.pod_anti_affinity
                    or pod.spec.pod_affinity):
                return []
            from koordinator_tpu_torch.ops.podaffinity import (
                _pod_matches,
                _term_key,
            )

            terms = [_term_key(t, pod)
                     for t in pod.spec.pod_anti_affinity]
            terms += [_term_key(t, pod) for t in pod.spec.pod_affinity]
            seen = {p.meta.key for p in anti_carriers}
            out = list(anti_carriers)
            if terms:
                for p in live:
                    if p.meta.key in seen:
                        continue
                    if any(_pod_matches(t, p) for t in terms):
                        out.append(p)
                        seen.add(p.meta.key)
            return out

        rounds: List[PreemptionRound] = []
        for pod in failed:
            req = pod.spec.requests.to_vector()
            prio = pod.spec.priority or 0
            best = None  # (score tuple, node, victims)
            feasible = feasible_nodes(pod, req, prio)
            # upstream DefaultPreemption samples candidate nodes instead of
            # dry-running the whole fleet (minCandidateNodesPercentage=10%,
            # floor 100). The window ROTATES per pod and per retry attempt
            # (the deterministic analog of upstream's random offset), so a
            # pod whose first window is blocked by affinity/victim checks
            # reaches different nodes on later cycles instead of replaying
            # the same failures forever.
            # upstream bases the percentage on the WHOLE fleet
            # (minCandidateNodesPercentage of numNodes, floor 100), not on
            # the prefiltered subset — an aggressive prefilter must not
            # shrink the dry-run window below upstream's
            max_candidates = max(100, len(nodes) // 10)
            evaluated = 0
            # every VISITED node counts toward a hard scan bound —
            # admission/recheck failures included. Without it, a fleet
            # where most nodes fail _static_admission still walks every
            # prefiltered node per failed pod, each paying per-node Python
            # sums (the round-5 advisor's unbounded-scan finding); 2x the
            # candidate budget bounds total per-pod work while the
            # rotating window still reaches fresh nodes on later attempts
            visited = 0
            scan_cap = 2 * max_candidates
            relevant = relevant_for(pod)
            if len(feasible):
                # stable hash: Python's builtin str hash is salted per
                # process, which would make replayed cycles preempt
                # different victims than production. The seed advances the
                # window by MAX_CANDIDATES per attempt: a +1 stride would
                # leave a pod behind an admission-failing window waiting
                # ~scan_cap cycles to reach fresh nodes, while any stride
                # LARGER than the minimum consumed window (the evaluated
                # cap can fire after max_candidates nodes) would tile the
                # ring with permanent gaps — stride == min window width
                # guarantees full coverage across attempts for every
                # feasible-set size
                import zlib

                start = (zlib.crc32(pod.meta.key.encode())
                         + self.attempt_seed * max_candidates) % len(feasible)
                feasible = np.roll(feasible, -start)
            for j in feasible:
                if evaluated >= max_candidates or visited >= scan_cap:
                    break
                visited += 1
                node = nodes[j]
                if not self._static_admission(pod, node):
                    continue
                assigned = [p for p in by_node.get(node.meta.name, [])
                            if p.meta.key not in evicted]
                free = (node.allocatable.to_vector()
                        - sum((req_of[p.meta.key] for p in assigned),
                              np.zeros_like(req))
                        - inflight.get(node.meta.name, 0.0))
                candidates = [
                    p for p in assigned
                    if (p.spec.priority or 0) < prio
                    and not is_pod_non_preemptible(p)
                    and not gang_guard.protected(p)
                ]
                gain = sum((req_of[p.meta.key] for p in candidates),
                           np.zeros_like(req))
                if ((free + gain - req) < 0).any():
                    continue
                evaluated += 1
                # reprieve from the most important down, violating first
                ordered = sorted(candidates,
                                 key=QuotaPreemptor._importance_key)
                violating, non_violating = split_by_pdb(
                    pdbs, list(budgets), ordered)
                victims = list(candidates)
                headroom = free + gain - req
                for p in violating + non_violating:
                    vec = req_of[p.meta.key]
                    if ((headroom - vec) >= 0).all():
                        headroom = headroom - vec
                        victims.remove(p)
                if not victims:
                    continue
                if not gang_guard.admissible(victims):
                    # two same-gang victims can each look fine alone but
                    # jointly overdraw the gang's spare members — skip
                    # the node rather than break all-or-nothing
                    continue
                victim_keys = {v.meta.key for v in victims}
                survivors = [
                    p for p in relevant
                    if p.meta.key not in evicted
                    and p.meta.key not in victim_keys
                    and p.meta.key != pod.meta.key
                ]
                if not self._affinity_feasible(pod, node, survivors,
                                               nodes_by_name):
                    continue
                violating_keys = {v.meta.key for v in violating}
                score = (
                    sum(1 for v in victims if v.meta.key in violating_keys),
                    max((v.spec.priority or 0) for v in victims),
                    sum((v.spec.priority or 0) for v in victims),
                    len(victims),
                    node.meta.name,
                )
                if best is None or score < best[0]:
                    best = (score, node, victims)
            if best is None:
                continue
            _, node, victims = best
            rounds.append(evict_round(self.store, pod, victims))
            evicted.update(v.meta.key for v in victims)
            gang_guard.commit(victims)
            inflight[node.meta.name] = (
                inflight.get(node.meta.name, np.zeros_like(req)) + req)
            # the victim node's assigned set shrank: repack its per-node
            # entries, then rebuild the flat gather tables (O(N + sum k)
            # concatenate — evictions are rare)
            pack_node(node_idx[node.meta.name])
            build_gather()
            # evicted victims consumed disruption budget: recompute so a
            # later preemptor's split/ranking sees the debited PDBs
            pdbs, budgets = pdb_disruption_budgets(self.store)
        return rounds
