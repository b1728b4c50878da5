"""The round's host pack: what a round reads that the host can make from
the final host arrays, made by the snapshot's upload
(scheduler/snapshot_cache.DeviceSnapshot.upload(..., pack=True)) and moved
in that upload's one transfer a dtype, so that no per-column device op
runs a round.

* the LoadAware reject rows and each pod's gang validity
  (models/full_chain.pod_independent_rows, through the host twin
  ops/loadaware.loadaware_node_reject_np);
* the kernel's pod records, valid pods first, and their count, word for
  word what ops/full_chain_kernel.pack_records and valid_first make, and
  its node flags (node_flags);
* the carried state's flat base: requested, NUMA zones, bindable cpus,
  volume headroom, ports, affinity counts and covers, then zeros for the
  two LoadAware deltas (room for W <= R axes each), which a kernel round
  clones in one copy and views;
* aff_exists as bytes, the kernel's aff_exists0;
* on the host only: each pod's PodFlags but the weights' (the plain
  round's RoundFlags table), the weights, and whether a valid pod is in a
  gang (else Permit is the identity).

A round takes the pack from ``fc.pack`` (PackedInputs); a FullChainInputs
built any other way, or derived from a packed one (``_replace`` makes a
PackedInputs whose ``pack`` is the class's None), has none, and the round
computes the same rows on the device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from koordinator_tpu_torch.models.full_chain import FullChainInputs
from koordinator_tpu_torch.ops.kernel_common import (
    NODE_HAS_TOPO,
    NODE_OK,
    NODE_REJECT_NP,
    NODE_REJECT_PR,
    NODE_SCORE_VALID,
    POD_BIND,
    POD_DS,
    POD_FULL_PCPUS,
    POD_GANG_OK,
    POD_NUMA,
    POD_PROD,
    POD_VALID,
    REC_FLAGS,
    REC_POD,
)
from koordinator_tpu_torch.ops.loadaware import loadaware_node_reject_np

# the device arrays of a pack, in the order the upload stages them
PACK_FIELDS = ("reject_np", "reject_pr", "gang_ok", "records", "n_valid",
               "node_flags", "aff_exists", "carry0")


class PackedInputs(FullChainInputs):
    """A FullChainInputs uploaded with its RoundPack (``pack``). Anything
    made from it by ``_replace`` or the constructor has ``pack`` None."""

    pack = None


class RoundPack:
    """The device arrays of PACK_FIELDS as attributes, and the host-only
    ``table`` (PodFlags rows without ``w_pos``), ``weights`` and
    ``any_gang``; ``carry_sizes`` splits ``carry0``."""

    def __init__(self, arrays: Dict[str, object], host: dict):
        for name in PACK_FIELDS:
            setattr(self, name, arrays[name])
        self.table = host["table"]
        self.weights = host["weights"]
        self.any_gang = host["any_gang"]
        self.carry_sizes = host["carry_sizes"]
        self.rows = (self.reject_np, self.reject_pr, self.gang_ok)


def round_array(value) -> np.ndarray:
    """The host array the upload moves for ``value``: what
    models/convert.as_tensor makes of it (bool stays, floats f32,
    integers int32)."""
    arr = np.asarray(value)
    if arr.dtype == np.bool_:
        return arr
    if np.issubdtype(arr.dtype, np.floating):
        return arr.astype(np.float32, copy=False)
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.int32, copy=False)
    raise TypeError(f"unsupported dtype {arr.dtype}")


def _words(a) -> np.ndarray:
    """f32 values as their int32 bit patterns (kernel_common.f32_words)."""
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _bits(mask: np.ndarray) -> np.ndarray:
    """[P, T] bool -> [P, ceil(T / 32)] int32, bit t of word t // 32
    (kernel_common.pack_bits)."""
    P, T = mask.shape
    nw = -(-T // 32)
    padded = np.zeros((P, nw * 32), np.uint64)
    padded[:, :T] = mask
    shifts = np.arange(32, dtype=np.uint64)
    words = (padded.reshape(P, nw, 32) << shifts).sum(axis=2)
    return words.astype(np.uint32).view(np.int32)


def pack_records_np(fc, gang_ok: np.ndarray) -> np.ndarray:
    """Host twin of ops/full_chain_kernel.pack_records, word for word:
    [P, rec_stride] int32 in queue order. ``fc`` holds round_array
    arrays."""
    from koordinator_tpu_torch.ops.full_chain_kernel import (
        REC_CORES,
        REC_IMG,
        REC_PPREF,
        REC_PREF,
        REC_QUOTA,
        REC_TAINT,
        record_layout,
    )

    inputs = fc.base
    P, R = inputs.fit_requests.shape
    T, PT, VG = fc.aff_dom.shape[1], fc.port_used.shape[1], \
        fc.vol_needed.shape[1]
    lay = record_layout(R, T, PT, VG)
    rec = np.zeros((P, lay["rec_stride"]), np.int32)
    flags = np.zeros(P, np.int32)
    for bit, col in ((POD_PROD, inputs.is_prod), (POD_DS, inputs.is_daemonset),
                     (POD_VALID, inputs.pod_valid), (POD_GANG_OK, gang_ok),
                     (POD_NUMA, fc.needs_numa), (POD_BIND, fc.needs_bind),
                     (POD_FULL_PCPUS, fc.full_pcpus)):
        flags |= col.astype(bool).astype(np.int32) * bit
    rec[:, REC_FLAGS] = flags
    rec[:, REC_POD] = np.arange(P, dtype=np.int32)
    rec[:, REC_CORES] = _words(fc.cores_needed)
    rec[:, REC_TAINT] = _words(fc.pod_taint_mask)
    rec[:, REC_QUOTA] = fc.quota_id
    rec[:, REC_PREF] = fc.pod_pref_id
    rec[:, REC_PPREF] = fc.pod_ppref_id
    rec[:, REC_IMG] = fc.pod_img_id
    tw, pw = -(-T // 32), -(-PT // 32)
    for key, width, words in (
            ("off_fit", R, _words(inputs.fit_requests)),
            ("off_req", R, _words(fc.requests)),
            ("off_est", R, _words(inputs.estimated)),
            ("off_aff", tw, _bits(fc.pod_aff_req.astype(bool))),
            ("off_anti", tw, _bits(fc.pod_anti_req.astype(bool))),
            ("off_match", tw, _bits(fc.pod_aff_match.astype(bool))),
            ("off_skew", T, _words(fc.pod_spread_skew)),
            ("off_ports", pw, _bits(fc.pod_port_wants.astype(bool))),
            ("off_vol", VG, _words(fc.vol_needed))):
        rec[:, lay[key]:lay[key] + width] = words
    return rec


def pod_flag_table_np(fc, gang_ok: np.ndarray) -> List[tuple]:
    """Host twin of models/full_chain.RoundFlags' table: each pod's
    PodFlags but ``w_pos``, from round_array arrays."""
    inputs = fc.base
    P = inputs.pod_valid.shape[0]
    vol = fc.vol_needed
    finite = np.isfinite(np.concatenate(
        [inputs.fit_requests, fc.requests, inputs.estimated, vol,
         fc.cores_needed[:, None]], axis=1)).all(axis=1)
    counts = np.concatenate([fc.quota_used.ravel(), fc.aff_count.ravel(),
                             fc.anti_cover.ravel()])
    dirty = bool((np.signbit(counts) & (counts == 0)).any()
                 | (np.signbit(fc.port_used) | np.isnan(fc.port_used)).any())
    cols = np.stack([
        inputs.pod_valid.astype(bool), fc.quota_id >= 0,
        fc.needs_numa.astype(bool), fc.needs_bind.astype(bool),
        fc.pod_port_wants.astype(bool).any(axis=1),
        ~((vol == 0) & ~np.signbit(vol)).all(axis=1),
        fc.pod_anti_req.astype(bool).any(axis=1),
        fc.pod_aff_match.astype(bool).any(axis=1),
        fc.pod_aff_req.astype(bool).any(axis=1),
        (~(fc.pod_spread_skew <= 0)).any(axis=1),
        fc.pod_ppref_id >= 0, inputs.is_prod.astype(bool), gang_ok, finite,
        np.full(P, not dirty)], axis=1)
    return [tuple(row) for row in cols.tolist()]


def host_pack(fc) -> tuple:
    """(arrays, host) of the round over the host FullChainInputs ``fc``:
    the device arrays of PACK_FIELDS by name, and the host-only values
    RoundPack keeps."""
    base = type(fc.base)(**{k: round_array(v)
                            for k, v in fc.base._asdict().items()})
    fc = type(fc)(base=base, **{k: round_array(v)
                                for k, v in fc._asdict().items()
                                if k != "base"})
    inputs = fc.base
    reject_np, reject_pr = loadaware_node_reject_np(
        inputs.allocatable, inputs.la_filter_usage,
        inputs.la_has_filter_usage, inputs.la_filter_thresholds,
        inputs.la_prod_thresholds, inputs.la_prod_pod_usage,
        inputs.la_filter_skip)
    gid = fc.gang_id
    gang_ok = np.where(gid >= 0, fc.gang_valid[np.maximum(gid, 0)]
                       if fc.gang_valid.size else True, True).astype(bool)
    valid = inputs.pod_valid.astype(bool)
    order = np.argsort((~valid).astype(np.int8), kind="stable")
    node_flags = np.zeros(inputs.node_ok.shape[0], np.int32)
    for bit, col in ((NODE_OK, inputs.node_ok),
                     (NODE_SCORE_VALID, inputs.la_score_valid),
                     (NODE_REJECT_NP, reject_np), (NODE_REJECT_PR, reject_pr),
                     (NODE_HAS_TOPO, fc.has_topology)):
        node_flags |= col.astype(bool).astype(np.int32) * bit
    N, R = inputs.allocatable.shape
    carry = [inputs.requested, fc.numa_free, fc.bind_free, fc.vol_free,
             fc.port_used, fc.aff_count, fc.anti_cover]
    zeros = np.zeros(2 * N * R, np.float32)
    carry0 = np.concatenate([np.ravel(a) for a in carry] + [zeros])
    arrays = {
        "reject_np": reject_np, "reject_pr": reject_pr, "gang_ok": gang_ok,
        "records": pack_records_np(fc, gang_ok)[order],
        "n_valid": np.array([valid.sum()], np.int32),
        "node_flags": node_flags.astype(np.uint8),
        "aff_exists": fc.aff_exists.astype(np.uint8),
        "carry0": carry0,
    }
    host = {"table": pod_flag_table_np(fc, gang_ok),
            "weights": inputs.weights,
            "any_gang": bool((valid & (gid >= 0)).any()),
            "carry_sizes": [int(np.size(a)) for a in carry] + [zeros.size]}
    return arrays, host
