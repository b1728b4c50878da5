"""NodePorts (hostPort conflict) factorization, batched.

The vendored kube-scheduler NodePorts plugin rejects a node when any
existing pod on it already binds a requested hostPort. Per-(pod, node) set
checks don't batch, so the snapshot factorizes: the DISTINCT (protocol,
port) pairs the pending batch requests become slot ids s < PT (real
batches carry a handful — hostPorts are rare and fixed per workload);
every node carries port_used [N, PT] (does an existing/placed pod on node
n bind slot s), every pod carries wants [P, PT]. Feasibility is one
compare per slot: no wanted slot may be in use on the node; the update
after a placement marks the chosen node's wanted slots used.

hostIP scoping is collapsed to the 0.0.0.0 wildcard (a conflict on any IP
blocks the node): conservative — the scheduler refuses placements it
cannot prove safe, never the reverse. Reference semantics:
kube NodePorts Filter via cmd/koord-scheduler/main.go:53-62 (the upstream
scheduler app the reference wraps).

MAX_PORT_SLOTS = 16 keeps the Pallas encoding exact (per-pod wants ride
one float bitmask, < 2^24): batches with more distinct hostPorts mark the
EXCESS pods unschedulable for the round (conservative, loudly logged).
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np

logger = logging.getLogger(__name__)

MAX_PORT_SLOTS = 16

Slot = Tuple[str, int]  # (protocol, hostPort)


def _slots_of(pod) -> List[Slot]:
    return [(proto or "TCP", int(port)) for proto, port in pod.spec.host_ports]


def build_port_state(pending_pods, nodes, existing_pods, rows=None):
    """-> (slots, port_used [N, PT] f32, wants [P, PT] bool,
           overflow_pod_idx list[int])

    existing_pods: assigned non-terminated pods; their hostPorts seed
    port_used on their nodes (only for slots the pending batch requests —
    other ports can never conflict with this batch).

    rows: optional indices of pending pods that declare hostPorts — the
    extraction loops restrict to them (portless pods contribute no slot
    and want nothing, so the restriction is exact)."""
    if rows is None:
        rows = range(len(pending_pods))
    slots: List[Slot] = []
    ids = {}
    overflow: List[int] = []
    for i in rows:
        pod = pending_pods[i]
        fits = True
        for slot in _slots_of(pod):
            if slot in ids:
                continue
            if len(slots) >= MAX_PORT_SLOTS:
                fits = False
                continue
            ids[slot] = len(slots)
            slots.append(slot)
        if not fits:
            overflow.append(i)
            logger.warning(
                "pod %s exceeds the %d distinct hostPort slots the batch "
                "encoding holds; it is unschedulable this round",
                pod.meta.key, MAX_PORT_SLOTS)
    PT = len(slots)
    N = len(nodes)
    P = len(pending_pods)
    port_used = np.zeros((N, PT), np.float32)
    wants = np.zeros((P, PT), bool)
    if PT == 0:
        return slots, port_used, wants, overflow
    node_index = {node.meta.name: n for n, node in enumerate(nodes)}
    for pod in existing_pods:
        n = node_index.get(pod.spec.node_name)
        if n is None:
            continue
        for slot in _slots_of(pod):
            s = ids.get(slot)
            if s is not None:
                port_used[n, s] = 1.0
    for i in rows:
        pod = pending_pods[i]
        for slot in _slots_of(pod):
            s = ids.get(slot)
            if s is not None:
                wants[i, s] = True
    return slots, port_used, wants, overflow


MAX_IMAGE_PROFILES = 32
MAX_IMAGE_SCORE = 100.0
# upstream ImageLocality clamps the contribution window per image
_MIN_IMG = 23 * 1024 * 1024      # minThreshold: 23 MiB
_MAX_IMG = 1000 * 1024 * 1024    # maxContainerThreshold: 1000 MiB


def build_image_scores(pending_pods, nodes, rows=None):
    """ImageLocality score rows, profile-bucketed like preferred affinity:

    -> (img_rows [max(SI, 1), N] f32, pod_img_id [P] int32)

    Pods sharing an identical image list share a profile; a profile's row
    is the upstream ImageLocality score — sum over the pod's images of
    sizeBytes on the node scaled by how widely the image is spread
    (size * nodes_having / N), then normalized into 0..100 over the
    [minThreshold, maxThreshold * num_containers] window — a STATIC
    function of node.images. Batches with more than MAX_IMAGE_PROFILES
    distinct image sets drop the excess (score 0, loudly logged): soft
    scoring degrades, never blocks."""
    profiles: List[tuple] = []
    ids: dict = {}
    P = len(pending_pods)
    N = len(nodes)
    pod_img_id = np.full(P, -1, np.int32)
    dropped = 0
    for i in (rows if rows is not None else range(P)):
        pod = pending_pods[i]
        imgs = tuple(sorted(set(pod.spec.images)))
        if not imgs:
            continue
        sid = ids.get(imgs)
        if sid is None:
            if len(profiles) >= MAX_IMAGE_PROFILES:
                dropped += 1
                continue
            sid = ids[imgs] = len(profiles)
            profiles.append(imgs)
        pod_img_id[i] = sid
    if dropped:
        logger.warning(
            "ImageLocality profile budget exceeded: %d pods keep a zero "
            "image-locality score this round (max %d distinct image sets)",
            dropped, MAX_IMAGE_PROFILES)
    SI = len(profiles)
    img_rows = np.zeros((max(SI, 1), N), np.float32)
    if SI and N:
        # vectorized: ONE [N, I] spread-weighted size matrix over the
        # distinct referenced images, then each profile row is a column-sum
        # (no per-(profile, node, image) Python loops — the snapshot's
        # pack_wire_matrix discipline)
        img_ids: dict = {}
        for imgs in profiles:
            for name in imgs:
                img_ids.setdefault(name, len(img_ids))
        size_mat = np.zeros((N, len(img_ids)), np.float64)
        for n, node in enumerate(nodes):
            for name, size in node.images.items():
                j = img_ids.get(name)
                if j is not None:
                    size_mat[n, j] = size
        have_frac = (size_mat > 0).sum(axis=0) / N          # spread factor
        weighted = size_mat * have_frac[None, :]            # [N, I]
        for s, imgs in enumerate(profiles):
            cols = [img_ids[name] for name in imgs]
            row = weighted[:, cols].sum(axis=1).astype(np.float32)
            lo, hi = _MIN_IMG, _MAX_IMG * max(len(imgs), 1)
            clipped = np.clip(row, lo, hi)
            img_rows[s] = np.floor(
                (clipped - lo) * np.float32(MAX_IMAGE_SCORE) / (hi - lo))
    return img_rows, pod_img_id
