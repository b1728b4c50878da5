"""Carry the round's inputs across: numpy arrays -> the port's tensors.

`schedule_inputs_from_numpy` takes the ScheduleInputs fields as a dict of
numpy arrays and returns the port's ScheduleInputs on ``device``.
`full_chain_inputs_from_numpy` does the same for FullChainInputs — base
fields prefixed ``base.``, the names the JAX package's sidecar wire uses.
`to_device` does it for a FullChainInputs the port's own pack produced.
Booleans stay bool, floats become float32 and integers int32 (the JAX
package runs with x64 off).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def as_tensor(value, device) -> torch.Tensor:
    """One array as a contiguous tensor on ``device`` with the round's
    dtype. Raises for a CUDA device when CUDA is not available."""
    if isinstance(value, torch.Tensor):
        arr = value
    else:
        arr = np.asarray(value)
        if arr.dtype == np.bool_:
            pass
        elif np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32, copy=False)
        elif np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.int32, copy=False)
        else:
            raise TypeError(f"unsupported dtype {arr.dtype}")
        # ascontiguousarray gives a 0-d array one dimension: keep the shape
        arr = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
    if arr.dtype == torch.float64:
        arr = arr.to(torch.float32)
    elif arr.dtype == torch.int64:
        arr = arr.to(torch.int32)
    return arr.to(device).contiguous()


def check_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present when asked
    for (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain round on the CPU")
    return dev


def schedule_inputs_from_numpy(d: Mapping[str, np.ndarray], device):
    """Dict of numpy arrays (or tensors) keyed by the ScheduleInputs field
    names -> the port's ScheduleInputs on ``device``."""
    from koordinator_tpu_torch.models.scheduler_model import ScheduleInputs

    dev = check_device(device)
    return ScheduleInputs(**{name: as_tensor(value, dev)
                             for name, value in d.items()})


def full_chain_inputs_from_numpy(d: Mapping[str, np.ndarray], device):
    """Dict of numpy arrays (``base.<field>`` for ScheduleInputs fields,
    ``<field>`` for the rest) -> the port's FullChainInputs on ``device``."""
    from koordinator_tpu_torch.models.full_chain import FullChainInputs

    dev = check_device(device)
    base: Dict[str, np.ndarray] = {}
    rest: Dict[str, torch.Tensor] = {}
    for name, value in d.items():
        if name.startswith("base."):
            base[name[5:]] = value
        else:
            rest[name] = as_tensor(value, dev)
    return FullChainInputs(base=schedule_inputs_from_numpy(base, dev), **rest)


def to_device(fc, device):
    """A FullChainInputs of numpy arrays (or tensors) -> tensors on
    ``device``."""
    d = {f"base.{k}": v for k, v in fc.base._asdict().items()}
    d.update((k, v) for k, v in fc._asdict().items() if k != "base")
    return full_chain_inputs_from_numpy(d, device)
