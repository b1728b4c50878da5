"""ctypes binding for the compiled serial scheduling floor (serial_floor.cpp).

`serial_schedule_full_native(fc, args)` runs the same full-chain serial loop
as `scheduler/parity.py::serial_schedule_full` (the scalar transcription of
the reference's per-pod Go chain) but compiled: g++ -O2, no FMA and no
fast-math, so its float32 results stay bit-identical to numpy's and to the
port's plain round. `lownodeload_floor_native` is the LowNodeLoad rebalance
pass's serial floor. chip_smoke.py times both on the card machine's host
against kernel 1 and the device rebalance pass: `vs_compiled_floor` is an
order-of-magnitude proxy for the reference's serial Go scheduler, which the
port does not run.

The library is built at first use into build/native/ (native/build.py). A
failed build, or a library of another ABI, raises: the floor is a
yardstick, and none of its callers falls back to the numpy oracle.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from koordinator_tpu_torch.native.build import NativeBuildError, build_floor

ABI_VERSION = 11

_lib: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()

_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Check the library's ABI and declare both entry points' signatures.
    A stale library built against another argument list would read every
    pointer after the change shifted, so another ABI raises."""
    lib.koord_floor_abi_version.restype = ctypes.c_int
    lib.koord_floor_abi_version.argtypes = []
    abi = lib.koord_floor_abi_version()
    if abi != ABI_VERSION:
        raise NativeBuildError(
            f"serial floor ABI {abi}, the binding expects {ABI_VERSION}")
    lib.koord_serial_full_chain.restype = None
    lib.koord_serial_full_chain.argtypes = (
        [ctypes.c_int] * 16          # P R N K G A NG T S S2 PT SI VG CI MI prod
        + [_F32P] * 3                # fit_requests requests estimated
        + [_I32P] * 7                # is_prod..needs_bind
        + [_F32P] + [_I32P]          # cores_needed full_pcpus
        + [_I32P]                    # pod_taint_mask
        + [_I32P] * 3                # pod_aff_req pod_anti_req pod_aff_match
        + [_I32P]                    # pod_spread_skew [P, T]
        + [_I32P]                    # pod_pref_id [P]
        + [_I32P]                    # pod_ppref_id [P]
        + [_F32P]                    # ppref_w [max(S2,1), max(T,1)]
        + [_I32P] + [_F32P] + [_I32P]  # pod_port_wants vol_needed pod_img_id
        + [_F32P, _F32P] + [_I32P]   # allocatable requested node_ok
        + [_F32P] + [_I32P]          # filter_usage has_filter_usage
        + [_F32P] * 5                # filter_thr prod_thr prod_usage term_np term_pr
        + [_I32P] * 2                # score_valid filter_skip
        + [_F32P]                    # weights
        + [_F32P] + [_I32P] * 2      # numa_free numa_policy has_topology
        + [_F32P] * 2                # bind_free cpus_per_core
        + [_I32P]                    # node_taint_group
        + [_F32P] * 3                # aff_dom aff_count anti_cover
        + [_I32P]                    # aff_exists
        + [_F32P]                    # pref_scores [N, S]
        + [_F32P] * 2 + [_I32P]      # port_used vol_free node_vol_group
        + [_F32P]                    # img_scores
        + [_I32P] + [_F32P] * 2      # ancestors quota_used quota_runtime
        + [_I32P] + [_F32P] * 2      # gang_valid gang_min gang_assumed
        + [_I32P, ctypes.c_int]      # gang_group num_groups
        + [_I32P]                    # chosen (out)
    )
    lib.koord_lownodeload_floor.restype = None
    lib.koord_lownodeload_floor.argtypes = (
        [ctypes.c_int] * 3
        + [_F32P] * 2 + [_I32P]      # alloc usage_pct has_metric
        + [_F32P] * 2                # low_thr high_thr
        + [_I32P] * 2 + [_F32P]      # pod_node pod_prio pod_req
        + [_I32P] + [_F32P]          # movable pod_sort_cpu
        + [ctypes.c_int] + [_I32P]   # max_evict victim(out)
    )
    return lib


def load() -> ctypes.CDLL:
    """The floor library, built from the checkout's source at first use;
    raises NativeBuildError if it cannot be built or has another ABI."""
    global _lib
    if _lib is None:
        with _LOAD_LOCK:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(str(build_floor())))
    return _lib


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), np.float32)


def _i32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), np.int32)


def lownodeload_floor_native(alloc, usage_pct, has_metric, low_thr, high_thr,
                             pod_node, pod_prio, pod_req, movable,
                             pod_sort_cpu, max_evict_per_node: int):
    """Compiled serial floor for the LowNodeLoad rebalance pass: returns
    victim[P] int32 (1 = selected). Same classify/sort/select semantics as
    descheduler/lownodeload.py, executed per node and per pod serially, on
    the arrays of ``descheduler.lownodeload.pack_floor_inputs``."""
    lib = load()
    alloc = _f32(alloc)
    N, R = alloc.shape
    pod_node = _i32(pod_node)
    P = pod_node.shape[0]
    victim = np.zeros(P, np.int32)
    lib.koord_lownodeload_floor(
        N, P, R, alloc, _f32(usage_pct), _i32(has_metric), _f32(low_thr),
        _f32(high_thr), pod_node, _i32(pod_prio), _f32(pod_req),
        _i32(movable), _f32(pod_sort_cpu), int(max_evict_per_node), victim)
    return victim


def serial_schedule_full_native(fc, args, num_groups: int = 0,
                                active_axes=None) -> np.ndarray:
    """Native analog of parity.serial_schedule_full over a FullChainInputs
    of numpy arrays (never mutated): returns chosen[P] int32, gang Permit
    applied. active_axes: original axis ids when fc was sliced (resolves
    the balanced-allocation axes)."""
    from koordinator_tpu_torch.models.full_chain import resolve_balance_idx

    lib = load()
    inputs = fc.base
    fit_requests = _f32(inputs.fit_requests)
    P, R = fit_requests.shape
    allocatable = _f32(inputs.allocatable)
    N = allocatable.shape[0]
    numa_free = _f32(fc.numa_free).copy()
    K = numa_free.shape[1]
    ancestors = _i32(fc.quota_ancestors)
    if ancestors.ndim != 2:
        ancestors = ancestors.reshape(0, 1)
    G, A = ancestors.shape if ancestors.size else (0, 1)
    gang_min = _f32(fc.gang_min_member)
    NG = gang_min.shape[0]
    gang_group = _i32(fc.gang_group_id)
    n_groups = int(num_groups or (int(gang_group.max()) + 1 if NG else 0))
    T = int(np.asarray(fc.aff_dom).shape[1])
    S = int(np.asarray(fc.pref_scores).shape[1])
    S2 = int(np.asarray(fc.ppref_w).shape[0]) if T else 0
    PT = int(np.asarray(fc.port_used).shape[1])
    SI = int(np.asarray(fc.img_scores).shape[1])
    pow_t = (1 << np.arange(max(T, 1), dtype=np.int64))[:T]

    def term_mask(rows) -> np.ndarray:  # [P, T] bool -> [P] int32 bitmask
        if not T:
            return np.zeros(P, np.int32)
        return _i32((np.asarray(rows, bool) * pow_t[None, :]).sum(axis=1))

    if PT:
        pow_s = (1 << np.arange(PT, dtype=np.int64))
        port_mask = _i32(
            (np.asarray(fc.pod_port_wants, bool) * pow_s[None, :]).sum(axis=1))
    else:
        port_mask = np.zeros(P, np.int32)
    bal_ci, bal_mi = resolve_balance_idx(active_axes)
    chosen = np.full(P, -1, np.int32)
    VG = int(np.asarray(fc.vol_needed).shape[1])
    lib.koord_serial_full_chain(
        P, R, N, K, max(G, 0), A, NG, T, S, S2, PT, SI, VG, bal_ci, bal_mi,
        1 if args.score_according_prod_usage else 0,
        fit_requests, _f32(fc.requests), _f32(inputs.estimated),
        _i32(inputs.is_prod), _i32(inputs.is_daemonset),
        _i32(inputs.pod_valid), _i32(fc.gang_id), _i32(fc.quota_id),
        _i32(fc.needs_numa), _i32(fc.needs_bind),
        _f32(fc.cores_needed), _i32(fc.full_pcpus),
        _i32(fc.pod_taint_mask),
        term_mask(fc.pod_aff_req), term_mask(fc.pod_anti_req),
        term_mask(fc.pod_aff_match),
        (_i32(fc.pod_spread_skew) if T
         else np.zeros((P, 1), np.int32)),
        _i32(fc.pod_pref_id),
        _i32(fc.pod_ppref_id),
        (_f32(fc.ppref_w) if S2
         else np.zeros((1, max(T, 1)), np.float32)),
        port_mask, _f32(fc.vol_needed), _i32(fc.pod_img_id),
        allocatable, _f32(inputs.requested).copy(), _i32(inputs.node_ok),
        _f32(inputs.la_filter_usage), _i32(inputs.la_has_filter_usage),
        _f32(inputs.la_filter_thresholds), _f32(inputs.la_prod_thresholds),
        _f32(inputs.la_prod_pod_usage),
        _f32(inputs.la_term_nonprod).copy(), _f32(inputs.la_term_prod).copy(),
        _i32(inputs.la_score_valid), _i32(inputs.la_filter_skip),
        _f32(inputs.weights),
        numa_free, _i32(fc.numa_policy), _i32(fc.has_topology),
        _f32(fc.bind_free).copy(), _f32(fc.cpus_per_core),
        _i32(fc.node_taint_group),
        (_f32(fc.aff_dom) if T
         else np.full((N, 1), -1.0, np.float32)),
        (_f32(fc.aff_count).copy() if T
         else np.zeros((N, 1), np.float32)),
        (_f32(fc.anti_cover).copy() if T
         else np.zeros((N, 1), np.float32)),
        _i32(fc.aff_exists) if T else np.zeros(1, np.int32),
        (_f32(fc.pref_scores) if S
         else np.zeros((N, 1), np.float32)),
        (_f32(fc.port_used).copy() if PT
         else np.zeros((N, 1), np.float32)),
        _f32(fc.vol_free).copy(), _i32(fc.node_vol_group),
        (_f32(fc.img_scores) if SI
         else np.zeros((N, 1), np.float32)),
        ancestors if ancestors.size else np.zeros((1, 1), np.int32),
        _f32(fc.quota_used).copy() if G else np.zeros((1, R), np.float32),
        _f32(fc.quota_runtime) if G else np.zeros((1, R), np.float32),
        _i32(fc.gang_valid) if NG else np.zeros(1, np.int32),
        gang_min if NG else np.zeros(1, np.float32),
        _f32(fc.gang_assumed) if NG else np.zeros(1, np.float32),
        gang_group if NG else np.zeros(1, np.int32),
        n_groups,
        chosen)
    return chosen
