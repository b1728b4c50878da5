"""LoadAware inputs of the scheduling round and the LoadAware score row.

`ScheduleInputs` carries the LoadAware chain's packed arrays (pods [P, ...],
nodes [N, ...]); `make_inputs` builds it from the packed batches as host
numpy; `_score_row` is the LoadAware least-allocated score of one pod against
every node, honoring the in-round assign-cache deltas:
  requested[N, R]   NodeResourcesFit accumulated requests
  delta_np[N, R]    in-round LoadAware estimates (all pods)
  delta_pr[N, R]    same, prod pods only (scoreAccordingProdUsage branch)
The LoadAware-only round itself comes with a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.ops.common import least_requested_score
from koordinator_tpu_torch.ops.fit import with_pod_count
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
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
