"""NUMA topology manager: merge per-provider NUMA hints and admit pods.

Analog of reference `pkg/scheduler/frameworkext/topologymanager/` (manager.go:58,
policy.go:26-224, policy_none.go, policy_best_effort.go, policy_restricted.go,
policy_single_numa_node.go). Hint providers (NodeNUMAResource, DeviceShare)
produce per-resource lists of candidate NUMA affinities; the manager takes the
cross-product across providers/resources, ANDs the masks, and picks the
narrowest preferred merged hint. The policy decides admission:

  none             -> always admit, no affinity
  best-effort      -> always admit, use best merged hint
  restricted       -> admit only if the best merged hint is preferred
  single-numa-node -> consider only single-node (or don't-care) preferred
                      hints; admit only if the result is preferred

In the batched design the device kernel (ops/numa.py) performs the coarse
feasibility cut over all nodes at once; this host module runs the exact
bitmask merge only for the winning (pod, node) pair at Reserve time, mirroring
how the reference runs Admit once per Filter'd node but keeping the hot loop
on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

from koordinator_tpu_torch.utils.bitmask import BitMask

# node label selecting the NUMA topology policy (apis/extension); defined here
# (not in snapshot.py) so both the snapshot packer and host plugins import it
# without a cycle
LABEL_NUMA_TOPOLOGY_POLICY = "node.koordinator.sh/numa-topology-policy"

POLICY_NONE = "none"
POLICY_BEST_EFFORT = "best-effort"
POLICY_RESTRICTED = "restricted"
POLICY_SINGLE_NUMA_NODE = "single-numa-node"

_CANON = {
    "": POLICY_NONE,
    "none": POLICY_NONE,
    "None": POLICY_NONE,
    "best-effort": POLICY_BEST_EFFORT,
    "BestEffort": POLICY_BEST_EFFORT,
    "restricted": POLICY_RESTRICTED,
    "Restricted": POLICY_RESTRICTED,
    "single-numa-node": POLICY_SINGLE_NUMA_NODE,
    "SingleNUMANode": POLICY_SINGLE_NUMA_NODE,
}


def canonical_policy(name: str) -> str:
    return _CANON.get(name, POLICY_NONE)


def resolve_numa_policy(node_labels, kubelet_policy: str) -> str:
    """Label-vs-kubelet-policy precedence, shared by the snapshot packer and
    the host plugin (snapshot.py packs the same rule into the device tensors;
    the two must agree): an explicit label — even an empty one — wins over the
    reported kubelet cpu-manager policy."""
    return canonical_policy(
        node_labels.get(LABEL_NUMA_TOPOLOGY_POLICY, kubelet_policy))


@dataclass
class NUMATopologyHint:
    """One candidate affinity (policy.go:34-42). affinity=None means
    "don't care" (any NUMA node)."""

    affinity: Optional[BitMask] = None
    preferred: bool = True
    score: int = 0

    def is_equal(self, other: "NUMATopologyHint") -> bool:
        if self.preferred != other.preferred:
            return False
        if self.affinity is None or other.affinity is None:
            return self.affinity is other.affinity
        return self.affinity == other.affinity


# providers hand back {resource_name: [hints] | None}; None value = no
# preference for that resource, empty list = no possible placement.
ProviderHints = Optional[Dict[str, Optional[List[NUMATopologyHint]]]]


class NUMATopologyHintProvider(Protocol):
    """manager.go:33-40 NUMATopologyHintProvider."""

    def get_pod_topology_hints(self, pod, node_name: str) -> ProviderHints:
        ...

    def allocate(self, pod, node_name: str, affinity: NUMATopologyHint) -> Optional[str]:
        """Commit an allocation under the merged affinity; error string vetoes."""
        ...


def _filter_providers_hints(
    providers_hints: Sequence[ProviderHints],
) -> List[List[NUMATopologyHint]]:
    """policy.go:94-125: flatten to one hint-list per (provider, resource);
    absent hints become a single preferred don't-care, an explicit empty list
    becomes a single non-preferred don't-care."""
    out: List[List[NUMATopologyHint]] = []
    for hints in providers_hints:
        if not hints:
            out.append([NUMATopologyHint(None, True)])
            continue
        for resource in hints:
            per = hints[resource]
            if per is None:
                out.append([NUMATopologyHint(None, True)])
            elif len(per) == 0:
                out.append([NUMATopologyHint(None, False)])
            else:
                out.append(list(per))
    return out


def _merge_permutation(
    default_affinity: BitMask, permutation: Sequence[NUMATopologyHint]
) -> NUMATopologyHint:
    """policy.go:68-92: AND all masks; preferred iff every hint preferred."""
    preferred = True
    merged = default_affinity
    for hint in permutation:
        mask = hint.affinity if hint.affinity is not None else default_affinity
        merged = merged.and_(mask)
        if not hint.preferred:
            preferred = False
    return NUMATopologyHint(merged, preferred, 0)


def _iter_permutations(hint_lists: List[List[NUMATopologyHint]]):
    """policy.go:207-224 cross-product iteration."""
    if not hint_lists:
        yield []
        return
    stack: List[Tuple[int, List[NUMATopologyHint]]] = [(0, [])]
    while stack:
        i, accum = stack.pop()
        if i == len(hint_lists):
            yield accum
            continue
        for h in reversed(hint_lists[i]):
            stack.append((i + 1, accum + [h]))


def _merge_filtered_hints(
    numa_nodes: Sequence[int], filtered: List[List[NUMATopologyHint]]
) -> NUMATopologyHint:
    """policy.go:127-185: best = narrowest preferred merged hint; score is a
    tie-break at equal width."""
    default_affinity = BitMask(numa_nodes)
    best = NUMATopologyHint(default_affinity, False, 0)
    for permutation in _iter_permutations(filtered):
        merged = _merge_permutation(default_affinity, permutation)
        assert merged.affinity is not None
        if merged.affinity.count() == 0:
            continue
        for h in permutation:
            if h.affinity is not None and merged.affinity == h.affinity:
                if h.score > merged.score:
                    merged.score = h.score
        if merged.preferred and not best.preferred:
            best = merged
            continue
        if not merged.preferred and best.preferred:
            continue
        assert best.affinity is not None
        if not merged.affinity.is_narrower_than(best.affinity):
            if (
                merged.affinity.count() == best.affinity.count()
                and merged.score > best.score
            ):
                best = merged
            continue
        best = merged
    return best


def merge_hints(
    policy: str,
    numa_nodes: Sequence[int],
    providers_hints: Sequence[ProviderHints],
) -> Tuple[NUMATopologyHint, bool]:
    """(best_hint, admit) under the given policy — the four Merge()
    implementations in policy_*.go."""
    policy = canonical_policy(policy)
    if policy == POLICY_NONE:
        return NUMATopologyHint(None, True), True

    filtered = _filter_providers_hints(providers_hints)
    if policy == POLICY_SINGLE_NUMA_NODE:
        # policy_single_numa_node.go:46-62: keep only preferred don't-care or
        # single-node hints before merging.
        filtered = [
            [
                h
                for h in per
                if h.preferred and (h.affinity is None or h.affinity.count() == 1)
            ]
            for per in filtered
        ]
    best = _merge_filtered_hints(numa_nodes, filtered)

    if policy == POLICY_SINGLE_NUMA_NODE:
        default_affinity = BitMask(numa_nodes)
        if best.affinity == default_affinity:
            best = NUMATopologyHint(None, best.preferred, best.score)
        return best, best.preferred
    if policy == POLICY_RESTRICTED:
        return best, best.preferred
    # best-effort
    return best, True


class TopologyManager:
    """manager.go:44-111: gather hints from all providers, merge under the
    node policy, and fan Allocate back out with the winning affinity."""

    def __init__(self, providers: Optional[List[NUMATopologyHintProvider]] = None):
        self.providers: List[NUMATopologyHintProvider] = providers or []

    def register_provider(self, provider: NUMATopologyHintProvider) -> None:
        self.providers.append(provider)

    def admit(
        self, pod, node_name: str, numa_nodes: Sequence[int], policy: str
    ) -> Optional[str]:
        """Returns an error string when the pod cannot be admitted
        (manager.go:58-80); on success fans the winning affinity back out via
        provider Allocate()s (the providers own any durable record of it —
        the reference's Store lives in per-cycle state and dies with it)."""
        providers_hints = [
            p.get_pod_topology_hints(pod, node_name) for p in self.providers
        ]
        best, admit = merge_hints(policy, numa_nodes, providers_hints)
        if not admit:
            return "node(s) NUMA Topology affinity error"
        for p in self.providers:
            err = p.allocate(pod, node_name, best)
            if err:
                return err
        return None


def generate_fit_hints(
    request,  # np-like [R] request vector
    zone_free,  # np-like [K, R] per-zone free
    numa_ids: Sequence[int],
    score_fn=None,
) -> List[NUMATopologyHint]:
    """Hints for a request against per-zone free resources
    (resource_manager.go:418-532): every zone subset whose pooled free covers
    the request is a candidate; preferred iff the subset is minimal-width."""
    import itertools

    k = len(numa_ids)
    fitting: List[Tuple[BitMask, int]] = []
    min_width = k + 1
    for width in range(1, k + 1):
        for combo in itertools.combinations(range(k), width):
            pooled = zone_free[list(combo)].sum(axis=0)
            if all(r <= 0 or r <= f for r, f in zip(request, pooled)):
                mask = BitMask(numa_ids[i] for i in combo)
                fitting.append((mask, width))
                min_width = min(min_width, width)
    hints = []
    for mask, width in fitting:
        score = int(score_fn(mask)) if score_fn else 0
        hints.append(NUMATopologyHint(mask, width == min_width, score))
    return hints
