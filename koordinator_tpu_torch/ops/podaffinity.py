"""Inter-pod (anti-)affinity, batched (requiredDuringScheduling only).

The vendored kube-scheduler's InterPodAffinity plugin evaluates, per
candidate node, whether pods matching a term's label selector exist within
the node's topology domain (core/v1 PodAffinityTerm; the reference binary
ships the plugin as a vendored default). Per-(pod, node, term) set checks
don't batch, so the snapshot factorizes:

  * the pending batch's DISTINCT terms (selector matchLabels, topologyKey)
    become term ids t < T (T is static per batch; real batches carry a
    handful — replica spreads and co-location pairs);
  * every node gets a domain id per term ([N, T], -1 when the node lacks
    the topology label — such nodes are outside every domain, exactly the
    upstream semantics);
  * aff_count [N, T] carries how many matching pods (existing assigned
    pods at snapshot time, plus in-batch placements as the kernel walks)
    live in node n's domain for term t;
  * each pod carries three [T] bool rows: which terms it REQUIRES as
    affinity, which it FORBIDS as anti-affinity, and which its own labels
    MATCH (driving the in-batch count updates and the first-replica
    bootstrap: a required affinity term that matches the pod's own labels
    admits everywhere while no matching pod exists anywhere — the upstream
    special case that lets the first replica of a self-affine set land).

Feasibility per (pod, node): every anti term has count == 0, every
affinity term has (domain valid AND count > 0) or its bootstrap; the
update after a placement increments the chosen node's whole domain row
for every term the placed pod matches.

Anti-affinity is SYMMETRIC upstream (the vendored InterPodAffinity filter
keeps existingAntiAffinityCounts): an EXISTING pod's required anti term
blocks any incoming pod matching that term from the existing pod's whole
topology domain, even when the incoming pod carries no anti term itself.
That rides a second [N, T] state array, anti_cover: how many pods
CARRYING term t as required anti-affinity live in node n's domain.
Existing assigned pods' anti terms are interned into the shared term
space to seed it; a placed pending pod carrying an anti term raises its
domain row as the kernel walks. Feasibility adds: no term the incoming
pod MATCHES may have anti_cover > 0 on the node.

MAX_TERMS = 24 keeps the Pallas encoding exact (the three bool rows ride
one float bitmask each, < 2^24): batches with more distinct terms mark the
EXCESS pods unschedulable for the round (conservative, loudly logged)
rather than silently dropping a constraint. Existing-pod anti terms
beyond the budget likewise mark the pending pods MATCHING them
unschedulable (never admit a co-location upstream would reject).
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np

logger = logging.getLogger(__name__)

MAX_TERMS = 24
# maxSkew cap: the Pallas kernel carries per-(pod, term) skews as 3 bit-plane
# bitmasks, so values clamp to 7 — far beyond practical constraints (the
# upstream default is 1). Clamping happens HERE so every backend (XLA,
# Pallas, wave, oracle, C++ floor) sees the same value and bindings match.
MAX_SKEW = 7

# (namespace set, selector item set, topology key) — terms are namespace
# scoped: an empty PodAffinityTerm.namespaces defaults to the owning pod's
# own namespace, so the same selector in two namespaces is two terms
Term = Tuple[frozenset, frozenset, str]


def _term_key(term, pod) -> Term:
    ns = frozenset(term.namespaces) if term.namespaces else frozenset(
        {pod.meta.namespace})
    return (ns, frozenset(term.selector.items()), term.topology_key)


def _pod_matches(term: Term, pod) -> bool:
    ns, selector, _key = term
    if pod.meta.namespace not in ns:
        return False
    labels = pod.meta.labels
    return all(labels.get(k) == v for k, v in selector)


def _spread_key(con, pod) -> Term:
    """Topology-spread constraints share the affinity term space (identical
    domain/count state); maxSkew rides per (pod, term), so it is NOT part
    of the identity. Spread selectors apply to the pod's own namespace."""
    return (frozenset({pod.meta.namespace}),
            frozenset(con.selector.items()), con.topology_key)


def _terms_of(pod) -> List[Term]:
    """HARD terms only — budget overflow on these marks the pod
    unschedulable. ScheduleAnyway spread is soft and interns with the
    preferences (overflow only drops the score)."""
    out = []
    for term in list(pod.spec.pod_affinity) + list(pod.spec.pod_anti_affinity):
        out.append(_term_key(term, pod))
    for con in pod.spec.topology_spread:
        if con.when_unsatisfiable != "ScheduleAnyway":
            out.append(_spread_key(con, pod))
    return out


def build_affinity_state(pending_pods, nodes, existing_pods, rows=None):
    """-> (terms, ids, aff_dom [N, T] f32, aff_count [N, T] f32,
           anti_cover [N, T] f32, aff_exists [T] bool,
           aff_req [P_valid, T] bool, anti_req [P_valid, T] bool,
           match [P_valid, T] bool, spread_skew [P_valid, T] f32,
           overflow_pod_idx: list[int])

    spread_skew[i, t] > 0 means pod i carries a DoNotSchedule topology
    spread constraint with that maxSkew over term t's domains.

    existing_pods: assigned, non-terminated pods (their labels + node names
    seed the counts; their required ANTI terms are interned too and seed
    anti_cover — the upstream symmetric existingAntiAffinityCounts check).
    aff_exists[t] is True when ANY existing pod matches
    term t — regardless of whether its node carries the topology label —
    driving the first-replica bootstrap exactly as upstream ("no matching
    pod in the cluster"), where counts alone would miss matches on
    unlabeled nodes. Row i of the pod arrays corresponds to
    pending_pods[i]; the caller pads. overflow_pod_idx lists pending pods
    whose terms did not fit MAX_TERMS — they must be marked unschedulable.

    rows: optional indices of pending pods that carry ANY (anti-)affinity /
    spread / preferred-pod-affinity spec — term extraction loops restrict
    to them (a spec-less pod can contribute no term, so the restriction is
    exact); matching against interned terms still scans every pod.
    """
    if rows is None:
        rows = range(len(pending_pods))
    terms: List[Term] = []
    ids = {}
    overflow_pods: List[int] = []
    for i in rows:
        pod = pending_pods[i]
        fits = True
        for term in _terms_of(pod):
            if term in ids:
                continue
            if len(terms) >= MAX_TERMS:
                fits = False
                continue
            ids[term] = len(terms)
            terms.append(term)
        if not fits:
            overflow_pods.append(i)
            logger.warning(
                "pod %s exceeds the %d distinct (anti-)affinity terms the "
                "batch encoding holds; it is unschedulable this round",
                pod.meta.key, MAX_TERMS,
            )
    # existing assigned pods' required anti-affinity terms join the shared
    # space: their domains must gate incoming pods that MATCH them
    # (symmetric anti-affinity). On budget overflow the matching pending
    # pods go unschedulable for the round — conservative, never admitting
    # a co-location the reference's symmetric check would reject.
    existing_anti: List[Tuple[Term, object]] = []  # (term, carrier pod)
    overflow_existing_terms: List[Term] = []
    for epod in existing_pods:
        for raw in epod.spec.pod_anti_affinity:
            key = _term_key(raw, epod)
            existing_anti.append((key, epod))
            if key in ids:
                continue
            if len(terms) >= MAX_TERMS:
                if key not in overflow_existing_terms:
                    overflow_existing_terms.append(key)
                continue
            ids[key] = len(terms)
            terms.append(key)
    if overflow_existing_terms:
        hit = set()
        for i, pod in enumerate(pending_pods):
            if i in hit or i in overflow_pods:
                continue
            if any(_pod_matches(t, pod) for t in overflow_existing_terms):
                hit.add(i)
                overflow_pods.append(i)
        logger.warning(
            "%d existing-pod anti-affinity terms exceed the %d-term batch "
            "budget; %d matching pending pods are unschedulable this round",
            len(overflow_existing_terms), MAX_TERMS, len(hit),
        )
    # preferred pod-affinity terms join the SHARED space (their weighted
    # scores read the same domain counts); budget overflow here only drops
    # the preference — soft scoring degrades, never blocks
    pref_dropped = 0
    for i in rows:
        pod = pending_pods[i]
        soft_keys = [_term_key(raw, pod)
                     for raw in pod.spec.pod_affinity_preferred]
        soft_keys += [_spread_key(con, pod)
                      for con in pod.spec.topology_spread
                      if con.when_unsatisfiable == "ScheduleAnyway"]
        for key in soft_keys:
            if key in ids:
                continue
            if len(terms) >= MAX_TERMS:
                pref_dropped += 1
                continue
            ids[key] = len(terms)
            terms.append(key)
    if pref_dropped:
        logger.warning(
            "preferred pod-affinity terms beyond the %d-term budget: %d "
            "dropped to zero weight this round", MAX_TERMS, pref_dropped)
    T = len(terms)
    N = len(nodes)
    P = len(pending_pods)
    aff_dom = np.full((N, T), -1.0, np.float32)
    aff_count = np.zeros((N, T), np.float32)
    anti_cover = np.zeros((N, T), np.float32)
    aff_exists = np.zeros(T, bool)
    aff_req = np.zeros((P, T), bool)
    anti_req = np.zeros((P, T), bool)
    match = np.zeros((P, T), bool)
    spread_skew = np.zeros((P, T), np.float32)
    if T == 0:
        return (terms, ids, aff_dom, aff_count, anti_cover, aff_exists,
                aff_req, anti_req, match, spread_skew, overflow_pods)

    # domain ids per term: nodes sharing the topology label value
    node_values: List[dict] = []
    for t, (_ns, _sel, key) in enumerate(terms):
        values = {}
        for n, node in enumerate(nodes):
            val = node.meta.labels.get(key)
            if val is not None:
                aff_dom[n, t] = values.setdefault(val, len(values))
        node_values.append(values)
    node_index = {node.meta.name: n for n, node in enumerate(nodes)}

    # seed counts from existing pods: O(E*T) dict accumulation per domain
    # VALUE, then one O(N*T) write — not a [N] mask per matching pod
    dom_counts: List[dict] = [dict() for _ in range(T)]
    for pod in existing_pods:
        for t, term in enumerate(terms):
            if not _pod_matches(term, pod):
                continue
            aff_exists[t] = True
            n = node_index.get(pod.spec.node_name)
            if n is None or aff_dom[n, t] < 0:
                continue
            d = aff_dom[n, t]
            dom_counts[t][d] = dom_counts[t].get(d, 0.0) + 1.0
    for t in range(T):
        if dom_counts[t]:
            col = aff_dom[:, t]
            aff_count[:, t] = np.where(
                col >= 0,
                np.vectorize(lambda d: dom_counts[t].get(d, 0.0))(col),
                0.0,
            )

    # seed anti_cover from existing CARRIERS of interned anti terms: the
    # carrier's node's domain row rises by one per carrier (same per-value
    # accumulation as aff_count, keyed on carrying rather than matching)
    cover_counts: List[dict] = [dict() for _ in range(T)]
    for key, epod in existing_anti:
        t = ids.get(key)
        if t is None:
            continue
        n = node_index.get(epod.spec.node_name)
        if n is None or aff_dom[n, t] < 0:
            continue
        d = aff_dom[n, t]
        cover_counts[t][d] = cover_counts[t].get(d, 0.0) + 1.0
    for t in range(T):
        if cover_counts[t]:
            col = aff_dom[:, t]
            anti_cover[:, t] = np.where(
                col >= 0,
                np.vectorize(lambda d: cover_counts[t].get(d, 0.0))(col),
                0.0,
            )

    for i, pod in enumerate(pending_pods):
        for t, term in enumerate(terms):
            if _pod_matches(term, pod):
                match[i, t] = True
        for term in pod.spec.pod_affinity:
            t = ids.get(_term_key(term, pod))
            if t is not None:
                aff_req[i, t] = True
        for term in pod.spec.pod_anti_affinity:
            t = ids.get(_term_key(term, pod))
            if t is not None:
                anti_req[i, t] = True
        for con in pod.spec.topology_spread:
            t = ids.get(_spread_key(con, pod))
            if t is not None and con.when_unsatisfiable != "ScheduleAnyway":
                spread_skew[i, t] = float(min(max(con.max_skew, 1), MAX_SKEW))
    return (terms, ids, aff_dom, aff_count, anti_cover, aff_exists, aff_req,
            anti_req, match, spread_skew, overflow_pods)


MAX_PREF_PROFILES = 32


def build_preferred_scores(pending_pods, nodes, rows=None):
    """preferredDuringScheduling node affinity, profile-bucketed:

    -> (pref_rows [max(S, 1), N] f32, pod_pref_id [P_valid] int32)

    Pods sharing an identical preferred-term list share a profile; each
    profile's row is the upstream NodeAffinity score — sum of matching term
    weights, normalized to 0..100 over nodes by the framework's
    defaultNormalizeScore (floor semantics) — a STATIC function of node
    labels, so it adds to the kernel score without any in-batch state.
    Batches with more than MAX_PREF_PROFILES distinct profiles drop the
    excess profiles (their pods score 0 preference — soft scoring degrades
    gracefully, loudly logged)."""
    profiles: List[tuple] = []
    ids: dict = {}
    P = len(pending_pods)
    pod_pref_id = np.full(P, -1, np.int32)
    dropped = 0
    for i in (rows if rows is not None else range(P)):
        pod = pending_pods[i]
        terms = tuple(
            (int(t.weight), frozenset(t.labels.items()))
            for t in pod.spec.affinity_preferred if t.labels
        )
        if not terms:
            continue
        sid = ids.get(terms)
        if sid is None:
            if len(profiles) >= MAX_PREF_PROFILES:
                dropped += 1
                continue
            sid = ids[terms] = len(profiles)
            profiles.append(terms)
        pod_pref_id[i] = sid
    if dropped:
        logger.warning(
            "preferred-affinity profile budget exceeded: %d pods keep a "
            "zero preference score this round (max %d distinct profiles)",
            dropped, MAX_PREF_PROFILES,
        )
    S = len(profiles)
    N = len(nodes)
    pref_rows = np.zeros((max(S, 1), N), np.float32)
    if S:
        # one Python pass over nodes per DISTINCT label pair; profile rows
        # compose vectorized (term mask = AND of its pair masks, row = Σ w)
        pair_ids: dict = {}
        for terms in profiles:
            for _w, pairs in terms:
                for kv in pairs:
                    pair_ids.setdefault(kv, len(pair_ids))
        pair_masks = np.zeros((len(pair_ids), N), bool)
        for (k, v), pid in pair_ids.items():
            for n, node in enumerate(nodes):
                if node.meta.labels.get(k) == v:
                    pair_masks[pid, n] = True
        for s, terms in enumerate(profiles):
            row = np.zeros(N, np.float32)
            for w, pairs in terms:
                idx = [pair_ids[kv] for kv in pairs]
                row += np.float32(w) * pair_masks[idx].all(axis=0)
            mx = row.max()
            pref_rows[s] = np.floor(
                row * np.float32(100.0) / np.float32(mx)) if mx > 0 else 0.0
    return pref_rows, pod_pref_id


MAX_PPREF_PROFILES = 16


def build_preferred_pod_profiles(pending_pods, term_ids: dict, T: int,
                                 rows=None):
    """preferredDuringScheduling POD affinity, profile-bucketed over the
    SHARED term space (the counts the required terms maintain are exactly
    the weighted sum's inputs; build_affinity_state interned the terms):

    -> (ppref_w [S2, max(T, 1)] f32 (ZERO rows when no profiles — the
        kernels gate on the shape), pod_ppref_id [P] int32,
        pod_ppref_mask [P, T] bool)

    ppref_w[s] holds the per-term weights of profile s (negative = anti
    preference); pod_ppref_mask marks the terms a pod's profile references
    (the wave kernel's conflict rule). Profiles beyond MAX_PPREF_PROFILES
    are dropped with a warning: soft scoring degrades, never blocks."""
    P = len(pending_pods)
    pod_ppref_id = np.full(P, -1, np.int32)
    profiles: List[tuple] = []
    ids: dict = {}
    dropped = 0
    # spec-less pods contribute no entries; with `rows` (indices of pods
    # carrying any affinity/spread spec) only those rows pay the extraction
    per_pod_terms: List[List[tuple]] = [[] for _ in range(P)]
    for i in (rows if rows is not None else range(P)):
        pod = pending_pods[i]
        entries = []
        for raw in pod.spec.pod_affinity_preferred:
            t = term_ids.get(_term_key(raw, pod))
            if t is None:
                continue  # dropped at intern time (budget), already logged
            # upstream validates weight into 1..100; clamping (with sign
            # preserved for anti preference) also keeps every weighted
            # count sum an exact f32 integer — the bit-parity contract
            w = int(raw.weight)
            w = max(-100, min(w, 100)) or 1
            entries.append((w, t))
        # ScheduleAnyway topology spread scores instead of filtering:
        # emptier domains of the constraint's own term rank higher
        for con in pod.spec.topology_spread:
            if con.when_unsatisfiable != "ScheduleAnyway":
                continue
            t = term_ids.get(_spread_key(con, pod))
            if t is not None:
                entries.append((-1, t))
        per_pod_terms[i] = entries
    for i, entries in enumerate(per_pod_terms):
        if not entries:
            continue
        key = tuple(sorted(entries))
        sid = ids.get(key)
        if sid is None:
            if len(profiles) >= MAX_PPREF_PROFILES:
                dropped += 1
                continue
            sid = ids[key] = len(profiles)
            profiles.append(key)
        pod_ppref_id[i] = sid
    if dropped:
        logger.warning(
            "preferred pod-affinity profile budget exceeded: %d profiles "
            "dropped to zero weight this round", dropped)
    S2 = len(profiles)
    ppref_w = np.zeros((S2, max(T, 1)), np.float32)
    pod_ppref_mask = np.zeros((P, max(T, 1)), bool)
    for s, entries in enumerate(profiles):
        for w, t in entries:
            ppref_w[s, t] += float(w)
    for i, entries in enumerate(per_pod_terms):
        if pod_ppref_id[i] < 0:
            continue
        for _w, t in entries:
            pod_ppref_mask[i, t] = True
    return ppref_w, pod_ppref_id, pod_ppref_mask
