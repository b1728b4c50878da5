"""Wrapper of the LoadAware-only round's CUDA kernel (csrc/schedule_step.cu).

Replaces the TPU kernel of koordinator_tpu/ops/pallas_step.py. The wrapper
computes the LoadAware reject rows in plain torch (as the Pallas wrapper
computes them outside its kernel), hands the node arrays to the kernel
axis-major ([axis, N]: a warp then reads 32 neighbouring floats of one axis)
with the LoadAware terms and deltas cut to the weighted axes, checks every
tensor, and launches one thread block on the current stream. `requested`
comes back in the JAX layout, [N, R].

`launches` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch.models.scheduler_model import node_rejects
from koordinator_tpu_torch.ops.kernel_common import check_tensor, load_library

SOURCE = "schedule_step.cu"
MAX_AXES = 16
MAX_WEIGHTS = 16

launches = 0

_P = ctypes.c_void_p
_PTR_FIELDS = (
    "fit_req", "est", "is_prod", "is_ds", "pod_valid",
    "alloc", "term_np", "term_pr", "node_ok", "score_valid", "reject_np",
    "reject_pr", "weights",
    "requested", "delta_np", "delta_pr", "chosen",
)
_INT_FIELDS = ("P", "N", "R", "prod_mode", "n_widx")


class _Params(ctypes.Structure):
    """Mirror of ScheduleStepParams in csrc/schedule_step.cu, field for
    field."""

    _fields_ = ([(f, _P) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int) for f in _INT_FIELDS]
                + [("widx", ctypes.c_int * MAX_WEIGHTS)])


def _lib():
    lib = load_library(SOURCE)
    if not getattr(lib, "_koord_bound", False):
        lib.schedule_step_params_size.restype = ctypes.c_int
        lib.schedule_step_launch.restype = ctypes.c_int
        lib.schedule_step_launch.argtypes = [ctypes.POINTER(_Params),
                                             ctypes.c_void_p]
        size = lib.schedule_step_params_size()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"ScheduleStepParams layout mismatch: C {size} bytes, "
                f"ctypes {ctypes.sizeof(_Params)}")
        lib._koord_bound = True
    return lib


def schedule_round(inputs, weight_idx, prod_mode: bool):
    """One round in the kernel: ScheduleInputs (CUDA tensors) ->
    (chosen[P] int32, requested[N, R] f32). Raises for tensors anywhere but
    on the card."""
    global launches
    if not inputs.allocatable.is_cuda:
        raise ValueError("schedule_round launches the CUDA kernel and takes "
                         f"CUDA tensors, got {inputs.allocatable.device}")
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    W = len(weight_idx)
    if R > MAX_AXES or W > MAX_WEIGHTS:
        raise ValueError(f"at most {MAX_AXES} axes and {MAX_WEIGHTS} "
                         "weighted axes")

    reject_np, reject_pr = node_rejects(inputs)
    u8, f32, i32 = torch.uint8, torch.float32, torch.int32
    dev = inputs.allocatable.device
    widx = list(weight_idx)

    def b(t):
        return t.to(u8).contiguous()

    def axis_major(t):  # [N, k] -> [k, N]
        return t.to(f32).t().contiguous()

    # carried state: the round's own copies, updated in place by the kernel
    requested_t = axis_major(inputs.requested)
    delta_np = torch.zeros((W, N), dtype=f32, device=dev)
    delta_pr = torch.zeros((W, N), dtype=f32, device=dev)
    chosen = torch.empty(P, dtype=i32, device=dev)
    args = {
        "fit_req": (inputs.fit_requests, f32, (P, R)),
        "est": (inputs.estimated, f32, (P, R)),
        "is_prod": (b(inputs.is_prod), u8, (P,)),
        "is_ds": (b(inputs.is_daemonset), u8, (P,)),
        "pod_valid": (b(inputs.pod_valid), u8, (P,)),
        "alloc": (axis_major(inputs.allocatable), f32, (R, N)),
        "term_np": (axis_major(inputs.la_term_nonprod[:, widx]), f32, (W, N)),
        "term_pr": (axis_major(inputs.la_term_prod[:, widx]), f32, (W, N)),
        "node_ok": (b(inputs.node_ok), u8, (N,)),
        "score_valid": (b(inputs.la_score_valid), u8, (N,)),
        "reject_np": (b(reject_np), u8, (N,)),
        "reject_pr": (b(reject_pr), u8, (N,)),
        "weights": (inputs.weights, f32, (R,)),
        "requested": (requested_t, f32, (R, N)),
        "delta_np": (delta_np, f32, (W, N)),
        "delta_pr": (delta_pr, f32, (W, N)),
        "chosen": (chosen, i32, (P,)),
    }
    params = _Params()
    for name in _PTR_FIELDS:
        t, dtype, shape = args[name]
        setattr(params, name, check_tensor(name, t, dtype, shape))
    sizes = dict(P=P, N=N, R=R, prod_mode=int(bool(prod_mode)), n_widx=W)
    for name in _INT_FIELDS:
        setattr(params, name, sizes[name])
    for j, r in enumerate(widx):
        params.widx[j] = int(r)

    lib = _lib()
    # The temporaries above may be freed before the kernel ends: the caching
    # allocator hands their memory only to later work on this same stream.
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.schedule_step_launch(ctypes.byref(params),
                                   ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"schedule_step kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return chosen, requested_t.t().contiguous()
