"""PVC/volume claim helpers: the host half the serial cycle reaches.

The store-level volume-aware gate and the attached-claim view shared by
the snapshot, VolumeBinding's Reserve and the cycle driver. The device
functions that carry claim state across fused waves
(``effective_vol_needed``, ``advance_claim_state``) and the hot-claim
analysis come with the fused-wave slice of the port.
"""

from __future__ import annotations

from typing import Dict, Set


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
