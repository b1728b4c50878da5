"""Serial parity emulator: the reference's per-pod plugin chain, scalar in numpy.

This is the trustworthy oracle of SURVEY.md section 7 ("parity harness ... is the
only trustworthy test"): a direct, unvectorized transcription of the reference's
Filter/Score/Reserve semantics (load_aware.go + kube NodeResourcesFit), operating on
the SAME packed inputs as the batched kernel. The batched step must produce
IDENTICAL bindings on any trace. It is also the measured performance floor standing
in for the reference's serial Go chain (BASELINE.md: baseline must be measured).

Everything here is float32 numpy with the same go_round/floor arithmetic as
ops/common.py so the two paths cannot diverge on rounding.
"""

from __future__ import annotations

from typing import List

import numpy as np

from koordinator_tpu_torch.api.resources import NUM_RESOURCES
from koordinator_tpu_torch.models.scheduler_model import ScheduleInputs
from koordinator_tpu_torch.ops.fit import with_pod_count  # noqa: F401  (packing parity)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs

MAX_NODE_SCORE = 100.0


def _go_round(x: np.float32) -> np.float32:
    return np.float32(np.floor(x + np.float32(0.5)))


def _least_requested(requested: np.float32, capacity: np.float32) -> np.float32:
    if capacity <= 0 or requested > capacity:
        return np.float32(0.0)
    return np.float32(np.floor((capacity - requested) * np.float32(MAX_NODE_SCORE) / capacity))


def serial_schedule(inputs: ScheduleInputs, args: LoadAwareArgs) -> np.ndarray:
    """Schedule the batch pod-by-pod, node-by-node; returns chosen[P] int32."""
    fit_requests = np.asarray(inputs.fit_requests, np.float32)
    estimated = np.asarray(inputs.estimated, np.float32)
    is_prod = np.asarray(inputs.is_prod)
    is_daemonset = np.asarray(inputs.is_daemonset)
    pod_valid = np.asarray(inputs.pod_valid)
    allocatable = np.asarray(inputs.allocatable, np.float32)
    requested = np.array(inputs.requested, np.float32)
    node_ok = np.asarray(inputs.node_ok)
    filter_usage = np.asarray(inputs.la_filter_usage, np.float32)
    has_filter_usage = np.asarray(inputs.la_has_filter_usage)
    filter_thr = np.asarray(inputs.la_filter_thresholds, np.float32)
    prod_thr = np.asarray(inputs.la_prod_thresholds, np.float32)
    prod_usage = np.asarray(inputs.la_prod_pod_usage, np.float32)
    term_np = np.array(inputs.la_term_nonprod, np.float32)
    term_pr = np.array(inputs.la_term_prod, np.float32)
    score_valid = np.asarray(inputs.la_score_valid)
    filter_skip = np.asarray(inputs.la_filter_skip)
    weights = np.asarray(inputs.weights, np.float32)

    P, R = fit_requests.shape
    N = allocatable.shape[0]
    weight_idx = [int(r) for r in np.nonzero(weights)[0]]
    wsum = np.float32(weights.sum())
    prod_mode = args.score_according_prod_usage
    chosen = np.full(P, -1, np.int32)

    def filter_loadaware(p: int, n: int) -> bool:
        # load_aware.go:123-171
        if is_daemonset[p]:
            return True
        if filter_skip[n]:
            # expired or missing NodeMetric: allowed before any profile check
            # (load_aware.go:135-150)
            return True
        prod_configured = bool((prod_thr[n] > 0).any())
        if is_prod[p] and prod_configured:
            # filterProdUsage (load_aware.go:226-255)
            for r in range(R):
                thr = prod_thr[n, r]
                if thr == 0:
                    continue
                total = allocatable[n, r]
                if total == 0:
                    continue
                ratio = _go_round(np.float32(prod_usage[n, r] * 100.0 / total))
                if ratio >= thr:
                    return False
            return True
        if not has_filter_usage[n]:
            return True
        for r in range(R):
            thr = filter_thr[n, r]
            if thr == 0:
                continue
            total = allocatable[n, r]
            if total == 0:
                continue
            ratio = _go_round(np.float32(filter_usage[n, r] * 100.0 / total))
            if ratio >= thr:
                return False
        return True

    def filter_fit(p: int, n: int) -> bool:
        for r in range(R):
            need = fit_requests[p, r]
            if need <= 0:
                continue
            if requested[n, r] + need > allocatable[n, r]:
                return False
        return True

    def score_loadaware(p: int, n: int) -> np.float32:
        # load_aware.go:269-335
        if not score_valid[n]:
            return np.float32(0.0)
        acc = np.float32(0.0)
        use_prod = prod_mode and is_prod[p]
        for r in weight_idx:
            term = term_pr[n, r] if use_prod else term_np[n, r]
            used = np.float32(estimated[p, r] + term)
            acc += np.float32(weights[r]) * _least_requested(used, allocatable[n, r])
        return np.float32(np.floor(acc / max(wsum, np.float32(1.0))))

    for p in range(P):
        if not pod_valid[p]:
            continue
        best_n, best_score = -1, np.float32(-1.0)
        for n in range(N):
            if not node_ok[n]:
                continue
            if not filter_fit(p, n):
                continue
            if not filter_loadaware(p, n):
                continue
            s = score_loadaware(p, n)
            if s > best_score:  # strict: lowest index wins ties
                best_n, best_score = n, s
        if best_n < 0:
            continue
        chosen[p] = best_n
        # Reserve: Fit state + podAssignCache (load_aware.go:263-267)
        requested[best_n] += fit_requests[p]
        term_np[best_n] += estimated[p]
        if prod_mode and is_prod[p]:
            term_pr[best_n] += estimated[p]

    return chosen


def serial_schedule_full(fc, args: LoadAwareArgs,
                         active_axes=None) -> np.ndarray:
    """Scalar full-chain oracle: Fit + LoadAware + NUMA/cpuset + quota admission
    in queue order, then the gang Permit barrier. Mirrors
    models/full_chain.build_full_chain_step exactly (same float32 arithmetic).
    active_axes: the original axis ids when fc was sliced by
    reduce_to_active_axes (resolves the balanced-allocation cpu/mem columns)."""
    chosen = serial_schedule_full_core(fc, args, active_axes=active_axes)
    # ---- gang permit barrier
    gang_id = np.asarray(fc.gang_id)
    gang_min = np.asarray(fc.gang_min_member)
    gang_assumed = np.asarray(fc.gang_assumed)
    gang_group = np.asarray(fc.gang_group_id)
    ng = gang_min.shape[0]
    per_gang = np.zeros(ng)
    for p in range(len(chosen)):
        if gang_id[p] >= 0 and chosen[p] >= 0:
            per_gang[gang_id[p]] += 1
    gang_ok = per_gang + gang_assumed >= gang_min
    group_fail = np.zeros(int(gang_group.max()) + 1 if ng else 1)
    for g in range(ng):
        if not gang_ok[g]:
            group_fail[gang_group[g]] += 1
    for p in range(len(chosen)):
        g = gang_id[p]
        if g >= 0 and (not gang_ok[g] or group_fail[gang_group[g]] > 0):
            chosen[p] = -1
    return chosen


def serial_schedule_full_core(fc, args: LoadAwareArgs,
                              active_axes=None) -> np.ndarray:
    from koordinator_tpu_torch.models.full_chain import resolve_balance_idx

    bal_ci, bal_mi = resolve_balance_idx(active_axes)
    inputs = fc.base
    fit_requests = np.asarray(inputs.fit_requests, np.float32)
    requests = np.asarray(fc.requests, np.float32)
    estimated = np.asarray(inputs.estimated, np.float32)
    is_prod = np.asarray(inputs.is_prod)
    is_daemonset = np.asarray(inputs.is_daemonset)
    pod_valid = np.asarray(inputs.pod_valid)
    allocatable = np.asarray(inputs.allocatable, np.float32)
    requested = np.array(inputs.requested, np.float32)
    node_ok = np.asarray(inputs.node_ok)
    filter_usage = np.asarray(inputs.la_filter_usage, np.float32)
    has_filter_usage = np.asarray(inputs.la_has_filter_usage)
    filter_thr = np.asarray(inputs.la_filter_thresholds, np.float32)
    prod_thr = np.asarray(inputs.la_prod_thresholds, np.float32)
    prod_usage = np.asarray(inputs.la_prod_pod_usage, np.float32)
    term_np = np.array(inputs.la_term_nonprod, np.float32)
    term_pr = np.array(inputs.la_term_prod, np.float32)
    score_valid = np.asarray(inputs.la_score_valid)
    filter_skip = np.asarray(inputs.la_filter_skip)
    weights = np.asarray(inputs.weights, np.float32)
    gang_id = np.asarray(fc.gang_id)
    quota_id = np.asarray(fc.quota_id)
    needs_numa = np.asarray(fc.needs_numa)
    needs_bind = np.asarray(fc.needs_bind)
    cores_needed = np.asarray(fc.cores_needed, np.float32)
    full_pcpus = np.asarray(fc.full_pcpus)
    numa_free = np.array(fc.numa_free, np.float32)
    numa_policy = np.asarray(fc.numa_policy)
    has_topology = np.asarray(fc.has_topology)
    bind_free = np.array(fc.bind_free, np.float32)
    cpus_per_core = np.asarray(fc.cpus_per_core, np.float32)
    ancestors = np.asarray(fc.quota_ancestors)
    quota_used = np.array(fc.quota_used, np.float32)
    quota_runtime = np.asarray(fc.quota_runtime, np.float32)
    gang_valid = np.asarray(fc.gang_valid)
    pod_taint_mask = np.asarray(fc.pod_taint_mask)
    node_taint_group = np.asarray(fc.node_taint_group)
    aff_dom = np.asarray(fc.aff_dom, np.float32)
    aff_count = np.array(fc.aff_count, np.float32)
    anti_cover = np.array(fc.anti_cover, np.float32)
    aff_exists = np.array(fc.aff_exists, bool)
    pod_aff_req = np.asarray(fc.pod_aff_req)
    pod_anti_req = np.asarray(fc.pod_anti_req)
    pod_aff_match = np.asarray(fc.pod_aff_match)
    pod_spread_skew = np.asarray(fc.pod_spread_skew, np.float32)
    pod_pref_id = np.asarray(fc.pod_pref_id)
    pref_scores = np.asarray(fc.pref_scores, np.float32)
    pod_ppref_id = np.asarray(fc.pod_ppref_id)
    ppref_w = np.asarray(fc.ppref_w, np.float32)
    pod_port_wants = np.asarray(fc.pod_port_wants)
    port_used = np.array(fc.port_used, np.float32)
    vol_needed = np.asarray(fc.vol_needed, np.float32)  # [P, VG]
    vol_free = np.array(fc.vol_free, np.float32)
    node_vol_group = np.asarray(fc.node_vol_group, np.int64)
    pod_img_id = np.asarray(fc.pod_img_id)
    img_scores = np.asarray(fc.img_scores, np.float32)
    T = aff_dom.shape[1]
    PT = port_used.shape[1]

    P, R = fit_requests.shape
    N, K, _ = numa_free.shape
    weight_idx = [int(r) for r in np.nonzero(weights)[0]]
    wsum = np.float32(weights.sum())
    prod_mode = args.score_according_prod_usage
    chosen = np.full(P, -1, np.int32)
    POLICY_SINGLE = 1

    def la_filter_ok(p, n):
        if is_daemonset[p]:
            return True
        if filter_skip[n]:
            return True
        prod_configured = bool((prod_thr[n] > 0).any())
        usage, thr = (
            (prod_usage, prod_thr)
            if (is_prod[p] and prod_configured)
            else (filter_usage, filter_thr)
        )
        if usage is filter_usage and not has_filter_usage[n]:
            return True
        for r in range(R):
            if thr[n, r] == 0 or allocatable[n, r] == 0:
                continue
            ratio = _go_round(np.float32(usage[n, r] * 100.0 / allocatable[n, r]))
            if ratio >= thr[n, r]:
                return False
        return True

    for p in range(P):
        if not pod_valid[p]:
            continue
        # PreFilter: gang validity + quota admission
        if gang_id[p] >= 0 and not gang_valid[gang_id[p]]:
            continue
        admit = True
        if quota_id[p] >= 0:
            for g in ancestors[quota_id[p]]:
                if g < 0:
                    continue
                for r in range(R):
                    if requests[p, r] > 0 and (
                        quota_used[g, r] + requests[p, r] > quota_runtime[g, r]
                    ):
                        admit = False
                        break
                if not admit:
                    break
        if not admit:
            continue
        best_n, best_score = -1, np.float32(-1.0)
        best_zone = -1
        # preferred POD affinity: weighted count row + max-min norm, hoisted
        # per pod (counts are frozen during one pod's node scan)
        ppref_norm = None
        if T and pod_ppref_id[p] >= 0:
            w_row = ppref_w[pod_ppref_id[p], :T]
            raw = (aff_count[:, :T] * w_row[None, :]).sum(axis=1,
                                                          dtype=np.float32)
            # max-min over node_ok only (upstream NormalizeScore spans the
            # candidate set; padded rows must not anchor the scale)
            ok_raw = raw[node_ok]
            mx = ok_raw.max() if ok_raw.size else np.float32(0.0)
            mn = ok_raw.min() if ok_raw.size else np.float32(0.0)
            if mx > mn:
                ppref_norm = np.floor(
                    (raw - mn) * np.float32(100.0) / np.float32(mx - mn))
            else:
                ppref_norm = np.zeros_like(raw)
        # spread minimums hoisted per (pod, term): invariant across the node
        # scan, restricted to domains of nodes the pod is ELIGIBLE for
        # (admission bit test), matching the batched evaluators
        spread_min = {}
        if T:
            elig = (
                (int(pod_taint_mask[p]) >> node_taint_group) & 1) > 0  # [N]
            for t in range(T):
                if pod_spread_skew[p, t] > 0:
                    valid = (aff_dom[:, t] >= 0) & elig
                    spread_min[t] = (aff_count[valid, t].min()
                                     if valid.any() else np.inf)
        for n in range(N):
            if not node_ok[n]:
                continue
            # Fit
            if any(
                fit_requests[p, r] > 0
                and requested[n, r] + fit_requests[p, r] > allocatable[n, r]
                for r in range(R)
            ):
                continue
            if not la_filter_ok(p, n):
                continue
            # TaintToleration: group bit test (ops/taints.py)
            if not (int(pod_taint_mask[p]) >> int(node_taint_group[n])) & 1:
                continue
            # InterPodAffinity (ops/podaffinity.py)
            affinity_ok = True
            for t in range(T):
                if pod_anti_req[p, t] and aff_count[n, t] > 0:
                    affinity_ok = False
                    break
                # symmetric anti-affinity: a carrier of anti term t in this
                # node's domain blocks any pod matching t
                if pod_aff_match[p, t] and anti_cover[n, t] > 0:
                    affinity_ok = False
                    break
                if pod_aff_req[p, t]:
                    bootstrap = pod_aff_match[p, t] and not aff_exists[t]
                    if not ((aff_dom[n, t] >= 0 and aff_count[n, t] > 0)
                            or bootstrap):
                        affinity_ok = False
                        break
                skew = pod_spread_skew[p, t]
                if skew > 0:
                    if aff_dom[n, t] < 0:
                        affinity_ok = False
                        break
                    self_match = 1.0 if pod_aff_match[p, t] else 0.0
                    if aff_count[n, t] + self_match - spread_min[t] > skew:
                        affinity_ok = False
                        break
            if not affinity_ok:
                continue
            # NodePorts: no wanted hostPort slot already bound on the node
            if PT and any(
                pod_port_wants[p, s] and port_used[n, s] > 0
                for s in range(PT)
            ):
                continue
            # CSI volume limit (+inf when the node reports none); the node's
            # volume group selects NEW attachments only (already-attached
            # exemption)
            vn = vol_needed[p, node_vol_group[n]]
            if vn > 0 and vol_free[n] < vn:
                continue
            # cpuset filter
            if needs_bind[p]:
                if not has_topology[n]:
                    continue
                if full_pcpus[p] and cores_needed[p] % max(cpus_per_core[n], 1.0) != 0:
                    continue
                if cores_needed[p] > bind_free[n]:
                    continue
            # NUMA admit
            zone = -1
            if needs_numa[p] and numa_policy[n] != 0:
                if numa_policy[n] == POLICY_SINGLE:
                    zone = -1
                    for k in range(K):
                        if all(
                            requests[p, r] <= 0
                            or requests[p, r] <= numa_free[n, k, r]
                            for r in range(R)
                        ):
                            zone = k
                            break
                    if zone < 0:
                        continue
                else:
                    total = numa_free[n].sum(axis=0)
                    if any(
                        requests[p, r] > 0 and requests[p, r] > total[r]
                        for r in range(R)
                    ):
                        continue
            # scores
            use_prod = prod_mode and is_prod[p]
            acc = np.float32(0.0)
            for r in weight_idx:
                term = term_pr[n, r] if use_prod else term_np[n, r]
                acc += np.float32(weights[r]) * _least_requested(
                    np.float32(estimated[p, r] + term), allocatable[n, r]
                )
            la_score = np.float32(np.floor(acc / max(wsum, np.float32(1.0))))
            if not score_valid[n]:
                la_score = np.float32(0.0)
            acc2 = np.float32(0.0)
            for r in weight_idx:
                acc2 += np.float32(weights[r]) * _least_requested(
                    np.float32(requested[n, r] + requests[p, r]), allocatable[n, r]
                )
            numa_score = np.float32(np.floor(acc2 / max(wsum, np.float32(1.0))))
            # NodeResourcesBalancedAllocation: std of the 2 balanced axes'
            # requested fractions == |fc - fm| / 2 (no sqrt)
            if bal_ci >= 0:
                def _frac(axis):
                    cap = allocatable[n, axis]
                    if cap <= 0:
                        return np.float32(0.0)
                    # reciprocal-multiply, NOT division: every impl
                    # (XLA/Pallas/C++) uses used * f32(1/cap) so the
                    # f32 results are bit-identical across the four
                    inv = np.float32(1.0) / cap
                    f = np.float32(
                        (requested[n, axis] + fit_requests[p, axis]) * inv)
                    return min(f, np.float32(1.0))
                std = np.float32(
                    np.abs(_frac(bal_ci) - _frac(bal_mi)) * np.float32(0.5))
                numa_score = numa_score + np.float32(
                    np.floor((np.float32(1.0) - std) * np.float32(100.0)))
            s = la_score + numa_score
            if pod_pref_id[p] >= 0:
                s = s + pref_scores[n, pod_pref_id[p]]
            if ppref_norm is not None:
                s = s + ppref_norm[n]
            if pod_img_id[p] >= 0:
                s = s + img_scores[n, pod_img_id[p]]
            if s > best_score:
                best_n, best_score, best_zone = n, s, zone
        if best_n < 0:
            continue
        chosen[p] = best_n
        requested[best_n] += fit_requests[p]
        term_np[best_n] += estimated[p]
        if prod_mode and is_prod[p]:
            term_pr[best_n] += estimated[p]
        if needs_numa[p]:
            if best_zone >= 0:
                numa_free[best_n, best_zone] -= requests[p]
            else:
                remaining = requests[p].copy()
                for k in range(K):
                    take = np.minimum(numa_free[best_n, k], remaining)
                    numa_free[best_n, k] -= take
                    remaining -= take
        if needs_bind[p]:
            bind_free[best_n] -= cores_needed[p]
        for s in range(PT):
            if pod_port_wants[p, s]:
                port_used[best_n, s] = 1.0
        vn_best = vol_needed[p, node_vol_group[best_n]]
        if vn_best > 0:
            vol_free[best_n] -= vn_best
        if quota_id[p] >= 0:
            for g in ancestors[quota_id[p]]:
                if g >= 0:
                    quota_used[g] += requests[p]
        for t in range(T):
            if pod_aff_match[p, t]:
                aff_exists[t] = True
                if aff_dom[best_n, t] >= 0:
                    dom = aff_dom[:, t] == aff_dom[best_n, t]
                    aff_count[dom, t] += 1.0
            if pod_anti_req[p, t] and aff_dom[best_n, t] >= 0:
                dom = aff_dom[:, t] == aff_dom[best_n, t]
                anti_cover[dom, t] += 1.0
    return chosen


def diff_bindings(chosen_a: np.ndarray, chosen_b: np.ndarray, keys: List[str]) -> List[str]:
    """Human-readable diff of two binding vectors (parity failures)."""
    out = []
    for i, key in enumerate(keys):
        if chosen_a[i] != chosen_b[i]:
            out.append(f"{key}: {int(chosen_a[i])} != {int(chosen_b[i])}")
    return out
