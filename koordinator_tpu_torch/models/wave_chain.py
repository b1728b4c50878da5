"""Wave-parallel full-chain scheduling step: serial bindings, parallel waves.

The serial round (models/full_chain.py) walks pods one at a time because
each binding mutates node/quota state. But the chain's state updates are
MONOTONE: committing a pod only ever (a) raises a node's requested/estimated
usage and shrinks its NUMA/bindable-CPU headroom — so that node's
feasibility and score for later pods can only get WORSE — and (b) raises
quota usage along one ancestor chain — so quota admission can only flip
admit -> reject. Under monotone decay, a pod's serial decision is EXACTLY
its decision against the wave-start state unless something it depends on
was touched earlier in the wave:

  * its argmax node was also chosen by an earlier wave pod, or
  * in-wave quota usage along its ancestor chain flips its admission
    (checked EXACTLY via an in-wave exclusive prefix-sum of ancestor-chain
    additions), or
  * an earlier wave pod changed an inter-pod-affinity count it reads, or
    made the one non-monotone score term (balanced allocation) rise on a
    node enough to reach its best score.

So each wave evaluates a WINDOW of W pods at frozen state — the plain
round's own per-pod evaluator (``make_pod_evaluator``) under
``torch.func.vmap``, so every window is [W, N] work and parity is by
construction — finds the first conflict, commits the clean prefix in one
batch of row scatters, and advances. A copy of the JAX package's
models/wave_chain.py in PyTorch idiom; the step is plain PyTorch on the
inputs' device, like balance/step.py and colo/step.py (the JAX step is
XLA, not Pallas).

Where the port departs from the JAX program, and why the bits stay equal:

  * ``jax.lax.while_loop`` becomes a host loop that reads each wave's cut
    back once (``step.last_pos_reads`` counts the reads; one per wave), so
    a window never walks its pods in Python.
  * The HIGHEST-precision one-hot matmuls of the rollups become row
    scatters (``index_add_`` into an N + 1-row state whose last row takes
    the pods that commit nothing, the drop slot of ``mode="drop"``). The
    node-collision cut commits distinct nodes, so each node row gets at
    most one addend: ``state + row`` exactly, as the matmul's single
    non-zero term gives. The step runs no matmul, so TF32 cannot enter.
  * The quota commit reuses the inclusive cumsum the admission pass saw
    (``incl[cut - 1]``), as the JAX step does: admission and commit can
    never see differently associated sums.

The JAX package documents one theoretical divergence from the serial round
(its wave_chain.py module doc): f32 summation order for a quota group whose
packed usage exceeds 2^24 while sitting within one ULP of its runtime. It
holds here word for word; it is not a port fault.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.models.full_chain import (
    FullChainInputs,
    make_pod_evaluator,
    permit,
    resolve_balance_idx,
)
from koordinator_tpu_torch.models.scheduler_model import resolve_weight_idx
from koordinator_tpu_torch.ops.kernel_common import safe_reciprocal
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.ops.numa import numa_spread_fill
from koordinator_tpu_torch.ops.quota import quota_admit_row

DEFAULT_WAVE = 256


def _exclusive_any(flags: torch.Tensor) -> torch.Tensor:
    """[W, T] bool -> [W, T] bool: whether any earlier row (in window
    order) has the flag set."""
    f = flags.to(torch.int32)
    return (torch.cumsum(f, dim=0) - f) > 0


def _scatter_rows(state_x: torch.Tensor, tgt: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """Add ``rows[w]`` into ``state_x[tgt[w]]`` in place. ``state_x`` has
    one row more than the nodes: pods that commit nothing target it."""
    state_x.index_add_(0, tgt, rows.to(state_x.dtype))


def build_wave_full_chain_step(args: LoadAwareArgs, num_gangs: int,
                               num_groups: int, active_axes=None,
                               wave: int = DEFAULT_WAVE):
    """FullChainInputs (torch) -> (chosen[P] int32, requested[N, R],
    quota_used[G, R]) on the inputs' device, the plain round's contract
    (build_full_chain_step) and its bindings, W pods a wave.

    ``step.last_waves`` and ``step.last_pos_reads`` say how many waves the
    last call ran and how many host reads of the wave cut it made (equal:
    one a wave)."""
    weight_idx = resolve_weight_idx(args, active_axes)
    bal_idx = resolve_balance_idx(active_axes)
    prod_mode = args.score_according_prod_usage
    if wave < 1:
        raise ValueError(f"wave must be >= 1; got {wave}")

    def step(fc: FullChainInputs):
        inputs = fc.base
        P, R = inputs.fit_requests.shape
        N = inputs.allocatable.shape[0]
        G, D = fc.quota_ancestors.shape
        T = fc.aff_dom.shape[1]
        PT = fc.port_used.shape[1]
        dev = inputs.allocatable.device
        W = min(wave, P)
        evaluate = make_pod_evaluator(fc, weight_idx, prod_mode, bal_idx,
                                      wave_rows=True)
        evaluate_w = torch.func.vmap(evaluate, in_dims=(0,) + (None,) * 11)
        admit_w_fn = torch.func.vmap(
            lambda req, qid, used: quota_admit_row(
                req, qid, fc.quota_ancestors, used, fc.quota_runtime))
        fill_w_fn = torch.func.vmap(numa_spread_fill)

        # [G, G] ancestor membership: anc_mask[g, a] == a is on g's chain
        anc = fc.quota_ancestors.long()
        anc_mask = torch.zeros((G, G + 1), dtype=torch.float32, device=dev)
        rows_g = torch.arange(G, device=dev)[:, None].expand(G, D)
        anc_mask.index_put_(
            (rows_g.reshape(-1), torch.where(anc >= 0, anc, G).reshape(-1)),
            torch.ones(G * D, dtype=torch.float32, device=dev),
            accumulate=True)
        anc_mask = anc_mask[:, :G]

        warange = torch.arange(W, device=dev)
        tri_before = warange[None, :] < warange[:, None]  # [w, e]: e < w
        node_vol_group = fc.node_vol_group.long()
        pod_aff_match = fc.pod_aff_match.to(torch.bool)
        pod_anti_req = fc.pod_anti_req.to(torch.bool)
        pod_aff_req = fc.pod_aff_req.to(torch.bool)
        pod_ppref_mask = fc.pod_ppref_mask.to(torch.bool)
        pod_port_wants = fc.pod_port_wants.to(torch.bool)

        def extended(x):
            # the node rows plus the drop slot
            return torch.cat([x, torch.zeros_like(x[:1])])

        requested_x = extended(inputs.requested)
        delta_np_x = extended(torch.zeros((N, R), dtype=torch.float32,
                                          device=dev))
        delta_pr_x = extended(torch.zeros((N, R), dtype=torch.float32,
                                          device=dev))
        numa_free_x = extended(fc.numa_free)
        bind_free_x = extended(fc.bind_free)
        vol_free_x = extended(fc.vol_free)
        port_used = fc.port_used.clone()
        quota_used = fc.quota_used.clone()
        aff_count = fc.aff_count.clone()
        anti_cover = fc.anti_cover.clone()
        aff_exists = fc.aff_exists.to(torch.bool).clone()
        chosen_x = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)

        pos = 0
        reads = 0
        waves = 0
        while pos < P:
            requested = requested_x[:N]
            numa_free = numa_free_x[:N]
            idx = pos + warange
            valid_w = idx < P
            idxc = torch.clamp_max(idx, P - 1)
            (found_w, best_w, zone_w, admit_w, score_w, bal_w,
             maxv_w) = evaluate_w(
                idxc, requested, delta_np_x[:N], delta_pr_x[:N], numa_free,
                bind_free_x[:N], quota_used, aff_count, anti_cover,
                aff_exists, port_used, vol_free_x[:N])
            found_w = found_w & valid_w

            req_w = fc.requests[idxc]                  # [W, R]
            req_fit_w = inputs.fit_requests[idxc]      # [W, R]
            est_w = inputs.estimated[idxc]             # [W, R]
            qid_w = fc.quota_id[idxc]                  # [W]
            has_quota_w = qid_w >= 0

            # ---- exact in-wave quota re-admission: the usage each pod
            # would see serially = wave-start usage + the additions of
            # every found pod before it (exclusive prefix over the window)
            pod_anc_w = anc_mask[torch.clamp_min(qid_w, 0).long()] * (
                (found_w & has_quota_w).to(torch.float32)[:, None])  # [W, G]
            adds = pod_anc_w[:, :, None] * req_w[:, None, :]         # [W, G, R]
            incl = torch.cumsum(adds, dim=0)
            prefix = incl - adds
            admit_prefix_w = admit_w_fn(req_w, qid_w,
                                        quota_used[None] + prefix)
            quota_flip_w = found_w & admit_w & ~admit_prefix_w

            # ---- node collision: an earlier wave pod took this argmax
            node_coll_w = found_w & (
                (best_w[:, None] == best_w[None, :]) & found_w[None, :]
                & tri_before).any(dim=1)

            # ---- affinity conflict: an earlier in-wave pod MATCHING a
            # term this pod reads changes the term's counts (required
            # anti-affinity only decays, so only found pods conflict; the
            # count-sensitive terms conflict once a match committed); an
            # earlier CARRIER of an anti term raises anti_cover for later
            # pods matching it
            if T:
                matched_before = _exclusive_any(
                    pod_aff_match[idxc] & found_w[:, None])
                anti_conf = found_w & (
                    pod_anti_req[idxc] & matched_before).any(dim=1)
                aff_conf = ((pod_aff_req[idxc]
                             | (fc.pod_spread_skew[idxc] > 0)
                             | pod_ppref_mask[idxc])
                            & matched_before).any(dim=1) & valid_w
                carried_before = _exclusive_any(
                    pod_anti_req[idxc] & found_w[:, None])
                sym_conf = found_w & (
                    pod_aff_match[idxc] & carried_before).any(dim=1)
                affinity_conf_w = anti_conf | aff_conf | sym_conf
            else:
                affinity_conf_w = torch.zeros_like(found_w)

            # ---- balanced-allocation conflict: committing pod e can make
            # node n_e MORE balanced and so raise its score for a later
            # pod w. Sound pairwise bound (every other term only decays):
            # frozen_score_w(n_e) - frozen_bal_w(n_e) + exact post-commit
            # bal_w(n_e); conflict when it could reach w's frozen best
            if bal_idx[0] >= 0:
                ci, mi = bal_idx
                alloc = inputs.allocatable
                cap_c = alloc[best_w, ci]
                cap_m = alloc[best_w, mi]
                base_c = requested[best_w, ci] + req_fit_w[:, ci]
                base_m = requested[best_w, mi] + req_fit_w[:, mi]

                def pair_frac(base_e, cap_e, waxis):
                    # the evaluator's reciprocal-multiply form, so the
                    # post-commit bal value is exact
                    inv = safe_reciprocal(cap_e)
                    f = (base_e[None, :] + waxis[:, None]) * inv[None, :]
                    return torch.clamp_max(f, 1.0)

                fpc = pair_frac(base_c, cap_c, req_fit_w[:, ci])  # [W, W]
                fpm = pair_frac(base_m, cap_m, req_fit_w[:, mi])
                bal_pair = torch.floor(
                    (1.0 - (fpc - fpm).abs() * 0.5) * 100.0)      # w x e
                bound = score_w[:, best_w] - bal_w[:, best_w] + bal_pair
                # the found gate: the bal term moves scores, never
                # feasibility, so a not-found pod stays not-found
                bal_conf_w = found_w & (
                    tri_before & found_w[None, :]
                    & (bound >= maxv_w[:, None])).any(dim=1)
            else:
                bal_conf_w = torch.zeros_like(found_w)

            conflict_w = (quota_flip_w | node_coll_w | affinity_conf_w
                          | bal_conf_w)
            cut = torch.where(conflict_w.any(),
                              torch.argmax(conflict_w.to(torch.int32)),
                              W)

            # ---- commit the clean prefix
            commit_w = (warange < cut) & found_w
            tgt = torch.where(commit_w, best_w, N)
            _scatter_rows(requested_x, tgt, req_fit_w)
            _scatter_rows(delta_np_x, tgt, est_w)
            if prod_mode:
                _scatter_rows(
                    delta_pr_x, tgt,
                    torch.where(inputs.is_prod[idxc], 1.0, 0.0)[:, None]
                    * est_w)
            _scatter_rows(bind_free_x, tgt, -torch.where(
                fc.needs_bind[idxc], fc.cores_needed[idxc], 0.0))
            if PT:
                # same-node port conflicts cannot occur within a wave (the
                # node-collision cut commits distinct nodes)
                wants = torch.zeros((N + 1, PT), dtype=torch.float32,
                                    device=dev)
                _scatter_rows(wants, tgt, pod_port_wants[idxc])
                port_used = torch.maximum(port_used, wants[:N])
            # new attachments at the chosen node (the volume-group gather:
            # the already-attached exemption)
            vn_at_best = torch.gather(
                fc.vol_needed[idxc], 1, node_vol_group[best_w][:, None])[:, 0]
            _scatter_rows(vol_free_x, tgt, -vn_at_best)
            new_rows_w = fill_w_fn(numa_free[best_w], req_w, zone_w)
            numa_idx = torch.where(commit_w & fc.needs_numa[idxc], best_w, N)
            numa_free_x.index_copy_(0, numa_idx, new_rows_w)
            # the quota commit from the SAME inclusive cumsum the admission
            # pass consumed: incl[cut - 1], zero when the cut is at 0
            committed_total = torch.where(
                cut > 0, incl[torch.clamp_min(cut - 1, 0)],
                torch.zeros_like(incl[0]))
            quota_used = quota_used + committed_total
            # affinity: every committed pod raises its matched terms'
            # counts (and its carried anti terms' cover) over the chosen
            # node's whole domain
            cm = commit_w.to(torch.float32)
            for t in range(T):
                dom_col = fc.aff_dom[:, t]
                chosen_dom_w = dom_col[best_w]
                in_dom = chosen_dom_w >= 0
                eq = (dom_col[None, :] == chosen_dom_w[:, None]).to(
                    torch.float32)                                # [W, N]
                inc_w = cm * pod_aff_match[idxc, t] * in_dom
                aff_count[:, t] += (inc_w[:, None] * eq).sum(dim=0)
                inc_cov_w = cm * pod_anti_req[idxc, t] * in_dom
                anti_cover[:, t] += (inc_cov_w[:, None] * eq).sum(dim=0)
                aff_exists[t] = aff_exists[t] | (
                    commit_w & pod_aff_match[idxc, t]).any()

            value_w = torch.where(found_w, best_w.to(torch.int32), -1)
            chosen_idx = torch.where((warange < cut) & valid_w, idx, P)
            chosen_x.index_copy_(0, chosen_idx, value_w)
            # the wave's one host read: where the next window starts
            pos += int(cut)
            reads += 1
            waves += 1

        step.last_waves = waves
        step.last_pos_reads = reads
        chosen = permit(fc, chosen_x[:P], num_gangs, num_groups)
        return chosen, requested_x[:N], quota_used

    step.last_backend = "wave"
    step.last_waves = 0
    step.last_pos_reads = 0
    return step
