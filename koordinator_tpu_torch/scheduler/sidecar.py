"""Batched scheduling sidecar: the round's entry point for packed arrays.

The host scheduler (the reference's Go event loop, or a Python cycle driver)
packs its caches into arrays and calls ``schedule_batch``; the server runs
one full-chain round on its device and returns the bindings. Steps are
cached by (shapes, gangs, flags) as in the JAX package's sidecar, and also
by the score weights, which fix the axes a step scores over. The
protobuf/gRPC transport comes with a later slice of the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

from koordinator_tpu_torch.models.convert import check_device, to_device
from koordinator_tpu_torch.models.full_chain import (
    FullChainInputs,
    build_best_full_chain_step,
)
from koordinator_tpu_torch.ops.kernel_common import SyncClock
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs


class SidecarServer:
    """Request handler. ``device`` is where rounds run: "cuda" (the default,
    the CUDA kernel) or "cpu" (the plain round); asking for CUDA where there
    is none raises."""

    def __init__(self, device="cuda") -> None:
        self.device = check_device(device)
        self._steps: Dict[Tuple, object] = {}
        self.last_backend = None

    def _get_sidecar_step(self, args: LoadAwareArgs, num_gangs: int,
                          num_groups: int, active):
        return build_best_full_chain_step(
            args, int(num_gangs), int(num_groups),
            active_axes=list(active) if active else None)

    def schedule_batch(self, fc: FullChainInputs, args: LoadAwareArgs,
                       num_gangs: int, num_groups: int, active_axes=None,
                       timings=None):
        """One round over ``fc`` (numpy arrays or tensors) ->
        (chosen[P] int32, requested[N, R] f32, quota_used[G, R] f32) as
        numpy arrays, gang Permit applied. With a ``timings`` dict the call
        synchronises between its layers and records their seconds: upload,
        round (wrapper and kernel), permit, readback."""
        active = tuple(int(a) for a in active_axes) if active_axes else None
        key = (
            tuple(fc.base.fit_requests.shape),
            tuple(fc.numa_free.shape),
            tuple(fc.quota_runtime.shape),
            int(num_gangs),
            int(num_groups),
            bool(args.score_according_prod_usage),
            active,
            tuple(sorted(args.resource_weights.items())),
        )
        if key not in self._steps:
            self._steps[key] = self._get_sidecar_step(args, num_gangs,
                                                      num_groups, active)
        step = self._steps[key]
        clock = SyncClock(timings, self.device)
        dev_fc = to_device(fc, self.device)
        clock.lap("upload")
        chosen, requested, quota_used = step(dev_fc, timings=timings)
        clock.restart()  # the step times its own layers
        out = (chosen.cpu().numpy(), requested.cpu().numpy(),
               quota_used.cpu().numpy())
        clock.lap("readback")
        self.last_backend = step.last_backend
        return out
