"""NodeResourcesFit: the kube-scheduler default fit check, in torch.

Bindings depend on the native Fit filter (requested + request <= allocatable
per resource, pod count included). Axes the pod doesn't request are skipped
(k8s semantics).
"""

from __future__ import annotations

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import RESOURCE_INDEX, ResourceName

PODS_AXIS = RESOURCE_INDEX[ResourceName.PODS]


def with_pod_count(requests: np.ndarray) -> np.ndarray:
    """Return a copy of [P, R] requests with the pods axis set to 1 (every pod
    consumes one pod slot in the Fit check)."""
    out = np.array(requests, copy=True)
    out[:, PODS_AXIS] = 1.0
    return out


def fit_ok_row(
    fit_request: torch.Tensor,   # [R] single pod (pods axis already 1)
    allocatable: torch.Tensor,   # [N, R]
    requested: torch.Tensor,     # [N, R] currently assigned
) -> torch.Tensor:
    """[N] bool: node can fit this pod."""
    need = fit_request[None, :]
    ok = (need <= 0) | (requested + need <= allocatable)
    return ok.all(dim=-1)
