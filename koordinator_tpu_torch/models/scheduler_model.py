"""The LoadAware-only scheduling round, in torch.

`ScheduleInputs` carries the LoadAware chain's packed arrays (pods [P, ...],
nodes [N, ...]); `make_inputs` builds it from the packed batches as host
numpy. One round walks the pods in queue order; each pod runs Fit, the
LoadAware threshold filter (daemonsets bypass it) and the LoadAware
least-allocated score against every node, takes the lowest-index argmax and
commits it to the round state before the next pod:
  requested[N, R]   NodeResourcesFit accumulated requests
  delta_np[N, R]    in-round LoadAware estimates (all pods)
  delta_pr[N, R]    same, prod pods only (scoreAccordingProdUsage branch)

`build_schedule_step` is the plain version: a Python loop over pods on
tensors, the same operations in the same order as the JAX package's XLA
step, so bindings are bit-identical. `build_best_schedule_step` is the entry
point: it moves the inputs to its device and runs the CUDA kernel
(ops/schedule_kernel.py) there, or the plain version on the CPU.
`build_score_matrix` is the one-shot [P, N] feasibility and score with no
assignment feedback.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.models.convert import (
    check_device,
    schedule_inputs_from_numpy,
)
from koordinator_tpu_torch.ops.common import least_requested_score
from koordinator_tpu_torch.ops.fit import (
    fit_ok_matrix,
    fit_ok_row,
    with_pod_count,
)
from koordinator_tpu_torch.ops.loadaware import (
    LoadAwareArgs,
    loadaware_filter,
    loadaware_node_reject,
    loadaware_score_terms,
)
from koordinator_tpu_torch.ops.packing import NodeBatch, PodBatch


class ScheduleInputs(NamedTuple):
    """LoadAware chain inputs of one round (numpy on the host, torch on the
    device the round runs on)."""

    # pods [P, ...]
    fit_requests: torch.Tensor   # [P, R] requests with pods-axis = 1
    estimated: torch.Tensor      # [P, R]
    is_prod: torch.Tensor        # [P]
    is_daemonset: torch.Tensor   # [P]
    pod_valid: torch.Tensor      # [P]
    # nodes [N, ...]
    allocatable: torch.Tensor    # [N, R]
    requested: torch.Tensor      # [N, R]
    node_ok: torch.Tensor        # [N] valid & schedulable
    la_filter_usage: torch.Tensor
    la_has_filter_usage: torch.Tensor
    la_filter_thresholds: torch.Tensor
    la_prod_thresholds: torch.Tensor
    la_prod_pod_usage: torch.Tensor
    la_term_nonprod: torch.Tensor
    la_term_prod: torch.Tensor
    la_score_valid: torch.Tensor
    la_filter_skip: torch.Tensor
    weights: torch.Tensor        # [R]


def make_inputs(pods: PodBatch, nodes: NodeBatch,
                args: LoadAwareArgs) -> ScheduleInputs:
    """Host numpy throughout: the round uploads once."""
    ex = nodes.extras
    return ScheduleInputs(
        fit_requests=np.asarray(with_pod_count(pods.requests)),
        estimated=np.asarray(pods.estimated),
        is_prod=np.asarray(pods.is_prod),
        is_daemonset=np.asarray(pods.is_daemonset),
        pod_valid=np.asarray(pods.valid),
        allocatable=np.asarray(nodes.allocatable),
        requested=np.asarray(nodes.requested),
        node_ok=np.asarray(nodes.valid),
        la_filter_usage=np.asarray(ex["la_filter_usage"]),
        la_has_filter_usage=np.asarray(ex["la_has_filter_usage"]),
        la_filter_thresholds=np.asarray(ex["la_filter_thresholds"]),
        la_prod_thresholds=np.asarray(ex["la_prod_thresholds"]),
        la_prod_pod_usage=np.asarray(ex["la_prod_pod_usage"]),
        la_term_nonprod=np.asarray(ex["la_term_nonprod"]),
        la_term_prod=np.asarray(ex["la_term_prod"]),
        la_score_valid=np.asarray(ex["la_score_valid"]),
        la_filter_skip=np.asarray(ex["la_filter_skip"]),
        weights=np.asarray(args.weight_vector()),
    )


def _score_row(
    est_row: torch.Tensor,       # [R]
    is_prod_i: torch.Tensor,     # 0-d bool
    inputs: ScheduleInputs,
    delta_np: torch.Tensor,      # [N, R]
    delta_pr: torch.Tensor,      # [N, R]
    weight_idx: Tuple[int, ...],
    prod_mode: bool,
) -> torch.Tensor:
    """[N] LoadAware score of one pod against all nodes, honoring in-round
    deltas: floor(sum_r w_r * leastRequested(est + term + delta) / sum w)."""
    acc = torch.zeros(inputs.allocatable.shape[0], dtype=torch.float32,
                      device=inputs.allocatable.device)
    wsum = inputs.weights.sum()
    for r in weight_idx:
        base_np = inputs.la_term_nonprod[:, r] + delta_np[:, r]
        if prod_mode:
            base = torch.where(
                is_prod_i, inputs.la_term_prod[:, r] + delta_pr[:, r], base_np)
        else:
            base = base_np
        used = est_row[r] + base
        acc = acc + inputs.weights[r] * least_requested_score(
            used, inputs.allocatable[:, r])
    score = torch.floor(acc / torch.clamp_min(wsum, 1.0))
    return torch.where(inputs.la_score_valid, score, 0.0)


def resolve_weight_idx(args: LoadAwareArgs, active_axes=None):
    """The axes the LoadAware score weighs, ascending, after active-axes
    slicing; shared by the plain rounds and the kernels so that all score
    over the same axes."""
    full_weights = args.weight_vector()
    if active_axes is not None:
        full_weights = full_weights[list(active_axes)]
    return tuple(int(i) for i in np.nonzero(full_weights)[0])


def node_rejects(inputs: ScheduleInputs):
    """(reject_nonprod[N], reject_prod[N]): the round's LoadAware threshold
    rows, which no pod's commit changes."""
    return loadaware_node_reject(
        inputs.allocatable,
        inputs.la_filter_usage,
        inputs.la_has_filter_usage,
        inputs.la_filter_thresholds,
        inputs.la_prod_thresholds,
        inputs.la_prod_pod_usage,
        inputs.la_filter_skip,
    )


def build_schedule_step(args: LoadAwareArgs):
    """The plain round: ScheduleInputs (torch) -> (chosen[P] int32,
    requested[N, R] f32) on the inputs' device. chosen[i] is the node of the
    pod at queue position i, or -1."""
    weight_idx = resolve_weight_idx(args)
    prod_mode = args.score_according_prod_usage

    def step(inputs: ScheduleInputs):
        P, R = inputs.fit_requests.shape
        N = inputs.allocatable.shape[0]
        dev = inputs.allocatable.device
        reject_np, reject_prod = node_rejects(inputs)
        # the round's own copies, updated in place pod by pod
        requested = inputs.requested.to(torch.float32).clone()
        delta_np = torch.zeros((N, R), dtype=torch.float32, device=dev)
        delta_pr = torch.zeros((N, R), dtype=torch.float32, device=dev)
        chosen = torch.full((P,), -1, dtype=torch.int32, device=dev)
        for i in range(P):
            req = inputs.fit_requests[i]
            est = inputs.estimated[i]
            is_prod_i = inputs.is_prod[i]
            fit = fit_ok_row(req, inputs.allocatable, requested)
            la_reject = torch.where(is_prod_i, reject_prod, reject_np)
            la_ok = inputs.is_daemonset[i] | ~la_reject
            feasible = inputs.node_ok & fit & la_ok
            score = _score_row(est, is_prod_i, inputs, delta_np, delta_pr,
                               weight_idx, prod_mode)
            score = torch.where(feasible, score, -1.0)
            # argmax returns the first maximal index: the lowest-index
            # tie-break, the binding contract
            best = torch.argmax(score)
            found = (score[best] >= 0.0) & inputs.pod_valid[i]
            fnd = found.to(torch.float32)
            requested[best] = requested[best] + fnd * req
            delta_np[best] = delta_np[best] + fnd * est
            if prod_mode:
                delta_pr[best] = delta_pr[best] + fnd * (
                    torch.where(is_prod_i, 1.0, 0.0) * est)
            chosen[i] = torch.where(found, best.to(torch.int32), -1)
        return chosen, requested

    step.last_backend = "serial"
    return step


def build_best_schedule_step(args: LoadAwareArgs, device="cuda",
                             kernel: str = "auto", smem_budget_bytes=None):
    """The LoadAware round's entry point: ScheduleInputs (numpy arrays or
    tensors) -> (chosen[P] int32, requested[N, R] f32) as tensors on
    ``device``. On CUDA it runs the CUDA kernel, on the CPU the plain round;
    the choice reads only the device the inputs were moved to, never their
    values. ``kernel="serial"`` forces the plain round on any device.
    Asking for CUDA where there is none raises.

    ``smem_budget_bytes`` is the counterpart of the JAX selector's
    ``vmem_budget_bytes``: the shared memory one block of the kernel's
    cluster may take (None: the card's 227 KB). Past it the same kernel
    keeps its carried state in device memory; no size sends a CUDA batch to
    the plain round. ``step.last_state`` says which state the last CUDA
    round kept ("smem" or "global")."""
    if kernel not in ("auto", "serial"):
        raise ValueError(f"unknown kernel {kernel!r}")
    dev = check_device(device)
    plain = build_schedule_step(args)
    weight_idx = resolve_weight_idx(args)
    prod_mode = args.score_according_prod_usage

    from koordinator_tpu_torch.ops import schedule_kernel

    def step(inputs):
        inputs = schedule_inputs_from_numpy(inputs._asdict(), dev)
        if kernel == "auto" and inputs.allocatable.is_cuda:
            step.last_backend = "cuda"
            out = schedule_kernel.schedule_round(
                inputs, weight_idx, prod_mode,
                smem_budget_bytes=smem_budget_bytes)
            step.last_state = schedule_kernel.last_launch["state"]
            return out
        step.last_backend = "serial"
        step.last_state = None
        return plain(inputs)

    step.last_backend = None
    step.last_state = None
    return step


def build_score_matrix(args: LoadAwareArgs):
    """One-shot (feasible[P, N] bool, score[P, N] f32) with no assignment
    feedback, on the inputs' device."""
    prod_mode = args.score_according_prod_usage
    weight_idx = resolve_weight_idx(args)

    def fn(inputs: ScheduleInputs):
        reject_np, reject_prod = node_rejects(inputs)
        la_ok = loadaware_filter(inputs.is_prod, inputs.is_daemonset,
                                 reject_np, reject_prod)
        fit = fit_ok_matrix(inputs.fit_requests, inputs.allocatable,
                            inputs.requested)
        feasible = (la_ok & fit & inputs.node_ok[None, :]
                    & inputs.pod_valid[:, None])
        score = loadaware_score_terms(
            inputs.estimated,
            inputs.is_prod,
            inputs.la_term_nonprod,
            inputs.la_term_prod,
            inputs.allocatable,
            inputs.la_score_valid,
            inputs.weights,
            prod_mode,
            weight_idx,
        )
        return feasible, score

    return fn
