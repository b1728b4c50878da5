"""PVC/volume claim state carried across fused waves.

The volume-group factorization (scheduler/snapshot.py) freezes, per
dispatch, which already-attached claims a node exempts from a pod's new-
attachment count (upstream NodeVolumeLimits' already-attached exemption).
Between SERIAL cycles the factorization is rebuilt from the updated
attached sets, so a claim-carrying pod binding in cycle w changes cycle
w+1's ``vol_needed``/``vol_free`` view — the reason the fused-wave path
historically demoted to K=1 whenever any pending pod carried a PVC
(the dominant demotion of the soak profile: claim-pods 478/1000 cycles,
CHURN_r04/r05).

This module removes that demotion by carrying the claim state on device:

  * ``analyze_pending_claims`` classifies the batch. The common case —
    every pending claim unique to its pod and attached nowhere (the sim's
    ``claim-<uid>`` tokens) — needs NO carried state at all: the kernel's
    existing per-commit ``vol_free`` decrement already reproduces the
    next-cycle host rebuild exactly (unique claims make the attached-SET
    rebuild equal the running count, and the group factorization stays
    VG==1 because bound claims leave the pending universe).
  * claims that CAN interact — shared by several pending pods, or already
    attached on some node (so the exemption can grow mid-dispatch) — are
    the HOT claims. ``build_claim_pack`` factorizes them into per-pod
    membership columns and per-node coverage rows; the wave kernel
    carries ``claim_new`` ([N, NC]: hot claims newly attached per node
    this dispatch) + ``vol_new`` ([N]: non-hot new attachments) in
    WAVE_STATE_FIELDS and, per wave, expands ``vol_needed`` to the
    per-(pod, node) effective count — exactly what the next serial
    cycle's regrouped ``[P, VG']`` gather would produce. ``vol_free`` is
    rebuilt at every wave boundary from the dispatch-start value minus
    the attached-SET growth (all integer-valued f32, so the rebuild is
    exact regardless of association — the packed-units discipline).
  * genuinely non-expressible interference — unbound WaitForFirstConsumer
    claims whose CLASSIFICATION (admission bitmask) another pending pod's
    bind can rewrite through the PV/PVC objects, and factorization-budget
    overflows whose degraded nodes regroup between cycles — demotes
    narrowly (reason ``claim-entangled``), the only claim residue left.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

# hot-claim column budget: one [N] f32 column per hot claim rides the
# wave carry; past the budget the cycle demotes (claim-entangled)
MAX_WAVE_CLAIMS = 128


def store_volume_aware(store) -> bool:
    """THE volume-aware predicate: any PVC/PV/StorageClass object in the
    store turns real volume binding/classification on; a store with none
    of the three is the opaque-token mode where ``pvc_names`` are CSI
    attachment-count tokens. One shared home (the snapshot classification
    gate, VolumeBinding's Reserve, and the fused claim analysis must
    agree — a desynchronized copy would make opaque claim pods immortal
    queue residents)."""
    from koordinator_tpu_torch.client.store import (
        KIND_PV,
        KIND_PVC,
        KIND_STORAGECLASS,
    )

    return bool(store.list(KIND_PVC) or store.list(KIND_PV)
                or store.list(KIND_STORAGECLASS))


def claim_keys_of(pod) -> frozenset:
    """The pod's distinct claim keys, namespaced the way the snapshot's
    attached sets store them."""
    return frozenset(
        f"{pod.meta.namespace}/{c}" for c in pod.spec.pvc_names)


def attached_claim_sets(store) -> Dict[str, Set[str]]:
    """node name -> attached claim keys, from assigned pods (the no-cache
    fallback mirroring scheduler/snapshot.py's scan)."""
    from koordinator_tpu_torch.client.store import KIND_POD

    attached: Dict[str, Set[str]] = {}
    for pod in store.list(KIND_POD):
        if pod.is_assigned and not pod.is_terminated and pod.spec.pvc_names:
            attached.setdefault(pod.spec.node_name, set()).update(
                claim_keys_of(pod))
    return attached


@dataclass
class ClaimAnalysis:
    """What the pending batch's claims require of the fused path."""

    has_claims: bool = False
    # None = fully carriable; else the classification-drift channel that
    # forces the serial path (surfaced in the demotion log)
    entangled: Optional[str] = None
    # hot claims (shared between pending pods, or attached somewhere):
    # these need carried columns; everything else is exemption-free
    hot: frozenset = frozenset()
    # per-pod claim sets, keyed by pod key (reused by build_claim_pack)
    claims_by_key: Optional[Dict[str, frozenset]] = None
    # the attached-claims view the analysis ran against, stashed so the
    # dispatch's side-input encode never re-materializes it
    attached: Optional[Dict[str, Set[str]]] = None


def analyze_pending_claims(pending, attached: Dict[str, Set[str]],
                           volume_aware: bool = False,
                           unbound_claim_pods: int = 0,
                           max_vol_groups: Optional[int] = None,
                           ) -> ClaimAnalysis:
    """Classify the pending batch's claim structure.

    ``attached`` is the node -> attached-claim-keys view the snapshot's
    volume-group factorization consumes. ``volume_aware`` + the count of
    pending pods carrying UNBOUND (or missing) claims gate the
    classification-drift demotion: an unbound WaitForFirstConsumer
    claim's admission alternatives shrink when another pod's bind
    consumes a candidate PV or binds a shared claim — state the kernel
    cannot see — but a SINGLE such pod is safe (its own bind removes it
    from the batch, and nothing else rewrites PV/PVC objects
    mid-dispatch)."""
    from koordinator_tpu_torch.scheduler.snapshot import MAX_VOL_GROUPS

    budget = MAX_VOL_GROUPS if max_vol_groups is None else max_vol_groups
    claims_by_key: Dict[str, frozenset] = {}
    counts: Dict[str, int] = {}
    for pod in pending:
        if not pod.spec.pvc_names:
            continue
        cs = claim_keys_of(pod)
        claims_by_key[pod.meta.key] = cs
        for c in cs:
            counts[c] = counts.get(c, 0) + 1
    if not claims_by_key:
        return ClaimAnalysis()
    if volume_aware and unbound_claim_pods >= 2:
        return ClaimAnalysis(
            has_claims=True,
            entangled="unbound claims on >= 2 pending pods",
            claims_by_key=claims_by_key, attached=attached)
    universe = frozenset(counts)
    shared = {c for c, n in counts.items() if n >= 2}
    attached_hot: Set[str] = set()
    intersections: Set[frozenset] = set()
    for node_set in attached.values():
        s = universe & node_set
        if s:
            attached_hot |= s
            intersections.add(frozenset(s))
    if len(intersections) + 1 > budget:
        # the snapshot's group factorization would overflow its budget:
        # degraded nodes lose the exemption THIS cycle but may regain it
        # next cycle as the universe shrinks — a regrouping the frozen
        # base cannot express
        return ClaimAnalysis(
            has_claims=True,
            entangled="volume-group budget overflow",
            claims_by_key=claims_by_key, attached=attached)
    hot = frozenset(shared | attached_hot)
    if len(hot) > MAX_WAVE_CLAIMS:
        return ClaimAnalysis(
            has_claims=True,
            entangled="hot-claim column budget overflow",
            claims_by_key=claims_by_key, attached=attached)
    return ClaimAnalysis(has_claims=True, hot=hot,
                         claims_by_key=claims_by_key, attached=attached)


@dataclass
class ClaimPack:
    """Packed hot-claim factorization for one dispatch (host numpy;
    scheduler/cycle.py uploads these as fused-wave side inputs)."""

    n_claims: int
    pod_claim: np.ndarray   # [P, NC] f32 0/1 — pod references hot claim c
    pod_nonhot: np.ndarray  # [P] f32 — the pod's NON-hot distinct-claim count
    covered0: np.ndarray    # [N, NC] f32 0/1 — claim attached on node at start


def build_claim_pack(analysis: ClaimAnalysis, pod_keys: Sequence[str],
                     node_names: Sequence[str],
                     attached: Dict[str, Set[str]],
                     p_pad: int, n_pad: int) -> Optional[ClaimPack]:
    """Build the hot-claim side arrays in PACKED row order, or None when
    the batch carries no hot claims (no machinery needed — see module
    doc)."""
    if analysis.entangled is not None or not analysis.hot:
        return None
    hot: List[str] = sorted(analysis.hot)
    cid = {c: j for j, c in enumerate(hot)}
    nc = len(hot)
    pod_claim = np.zeros((p_pad, nc), np.float32)
    pod_nonhot = np.zeros(p_pad, np.float32)
    claims_by_key = analysis.claims_by_key or {}
    for i, key in enumerate(pod_keys):
        cs = claims_by_key.get(key)
        if not cs:
            continue
        nh = 0
        for c in cs:
            j = cid.get(c)
            if j is None:
                nh += 1
            else:
                pod_claim[i, j] = 1.0
        pod_nonhot[i] = float(nh)
    covered0 = np.zeros((n_pad, nc), np.float32)
    for i, name in enumerate(node_names):
        node_set = attached.get(name)
        if not node_set:
            continue
        for c in node_set:
            j = cid.get(c)
            if j is not None:
                covered0[i, j] = 1.0
    return ClaimPack(n_claims=nc, pod_claim=pod_claim,
                     pod_nonhot=pod_nonhot, covered0=covered0)


# ---------------------------------------------------------------------------
# device functions (torch, on the wave state's device)
# ---------------------------------------------------------------------------


def _exact_matmul(a, b):
    """a @ b for small integer-valued f32 operands, exact on any device:
    the product runs in f64 (so no TF32 or reduced-precision setting can
    round it) and every result is an integer below 2^24, which f32 holds
    exactly."""
    return (a.double() @ b.double()).float()


def effective_vol_needed(vol_needed, node_vol_group, pod_claim, claim_new):
    """[P, N] per-(pod, node) NEW-attachment counts at wave-start state:
    the frozen [P, VG] group gather minus the pod's hot claims the node
    newly attached this dispatch (``claim_new`` excludes dispatch-start
    coverage by construction, so nothing is subtracted twice). All
    operands are small integer-valued f32 and the product is exact, so
    the result equals the next serial cycle's regrouped gather
    bit-for-bit."""
    base = vol_needed.index_select(1, node_vol_group.long())    # [P, N]
    overlap = _exact_matmul(pod_claim, claim_new.t())          # [P, N]
    return base - overlap


def advance_claim_state(chosen, committed, pod_claim, pod_nonhot, covered0,
                        claim_new, vol_new, vol_free0):
    """Wave-boundary claim-state update from this wave's committed
    bindings (``committed`` [P] bool, ``chosen`` [P] int32 node per pod).

    Returns (claim_new', vol_new', vol_free') where vol_free' is REBUILT
    set-wise — dispatch-start free minus the union growth — exactly what
    the next serial cycle's ``limit - len(attached)`` recompute yields
    (two committed pods sharing a hot claim on one node decremented it
    twice in-wave, the serial in-cycle behavior; the boundary rebuild
    collapses the double-count the way the host's set rebuild does).
    The per-node sums are ``index_add_`` of 0/1 and small integer
    values: exact in any accumulation order."""
    import torch

    n = covered0.shape[0]
    w = committed.to(torch.float32)
    node = torch.clamp_min(chosen, 0).long()
    gain = torch.zeros((n, pod_claim.shape[1]), dtype=torch.float32,
                       device=pod_claim.device).index_add_(
                           0, node, pod_claim * w[:, None])      # [N, NC]
    fresh = ((gain > 0.5) & (covered0 <= 0.5)
             & (claim_new <= 0.5)).to(torch.float32)
    claim_new2 = claim_new + fresh
    vol_new2 = vol_new + torch.zeros(
        n, dtype=torch.float32, device=pod_nonhot.device).index_add_(
            0, node, pod_nonhot * w)                             # [N]
    vol_free2 = vol_free0 - vol_new2 - claim_new2.sum(dim=1)
    return claim_new2, vol_new2, vol_free2


def host_effective_vol_needed(vol_needed, node_vol_group, pod_claim,
                              claim_new) -> np.ndarray:
    """Numpy twin of ``effective_vol_needed`` for the host wave-state
    mirror (scheduler/cycle._WaveStateMirror): integer-exact, so the
    diagnose oracle sees the same per-(pod, node) counts the kernel
    filtered with."""
    base = np.take(np.asarray(vol_needed, np.float32),
                   np.asarray(node_vol_group), axis=1)
    overlap = np.asarray(pod_claim, np.float32) @ np.asarray(
        claim_new, np.float32).T
    return base - overlap
