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


def fit_ok_matrix(
    fit_requests: torch.Tensor,  # [P, R]
    allocatable: torch.Tensor,   # [N, R]
    requested: torch.Tensor,     # [N, R]
) -> torch.Tensor:
    """[P, N] bool; computed axis by axis to avoid a [P, N, R]
    intermediate."""
    P, R = fit_requests.shape
    N = allocatable.shape[0]
    ok = torch.ones((P, N), dtype=torch.bool, device=allocatable.device)
    for r in range(R):
        need = fit_requests[:, r][:, None]
        ok_r = (need <= 0) | (requested[None, :, r] + need
                              <= allocatable[None, :, r])
        ok = ok & ok_r
    return ok
