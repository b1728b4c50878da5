"""Wrapper of the full-chain CUDA kernel (csrc/full_chain.cu).

Replaces the TPU kernel of koordinator_tpu/ops/pallas_full_chain.py. The
wrapper computes the pod-independent rows in plain torch (LoadAware node
rejects, per-pod gang validity), allocates the carried state and outputs with
torch.empty/clone, checks every tensor, and launches one thread block on the
current stream. The gang Permit barrier runs afterwards in plain torch, as
the JAX package runs it in XLA after the Pallas call.

`launches` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch.models.full_chain import (
    permit,
    pod_independent_rows,
    resolve_balance_idx,
    resolve_weight_idx,
)
from koordinator_tpu_torch.ops.kernel_common import check_tensor, load_library
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs

SOURCE = "full_chain.cu"
MAX_WEIGHTS = 16

launches = 0

_P = ctypes.c_void_p
_PTR_FIELDS = (
    "fit_req", "req", "est", "is_prod", "is_ds", "pod_valid", "gang_ok",
    "needs_numa", "needs_bind", "full_pcpus", "cores", "taint_mask",
    "quota_id", "aff_req", "anti_req", "aff_match", "skew", "pref_id",
    "ppref_id", "img_id", "port_wants", "vol_needed",
    "alloc", "term_np", "term_pr", "node_ok", "score_valid", "reject_np",
    "reject_pr", "has_topo", "cpc", "policy", "taint_group", "vol_group",
    "aff_dom", "pref_scores", "img_scores", "ppref_w", "weights", "anc",
    "runtime", "aff_exists0",
    "requested", "delta_np", "delta_pr", "numa", "bind_free", "vol_free",
    "port_used", "aff_count", "anti_cover", "quota_used", "chosen",
)
_INT_FIELDS = (
    "P", "N", "R", "K", "G", "D", "T", "S", "S2", "ppref_stride", "PT", "SI",
    "VG", "prod_mode", "bal_c", "bal_m", "n_widx",
)


class _Params(ctypes.Structure):
    """Mirror of FullChainParams in csrc/full_chain.cu, field for field."""

    _fields_ = ([(f, _P) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int) for f in _INT_FIELDS]
                + [("widx", ctypes.c_int * MAX_WEIGHTS)])


def _lib():
    lib = load_library(SOURCE)
    if not getattr(lib, "_koord_bound", False):
        lib.full_chain_params_size.restype = ctypes.c_int
        lib.full_chain_launch.restype = ctypes.c_int
        lib.full_chain_launch.argtypes = [ctypes.POINTER(_Params),
                                          ctypes.c_void_p]
        size = lib.full_chain_params_size()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"FullChainParams layout mismatch: C {size} bytes, "
                f"ctypes {ctypes.sizeof(_Params)}")
        lib._koord_bound = True
    return lib


def full_chain_round(fc, weight_idx, prod_mode: bool, bal_idx):
    """One round in the kernel: FullChainInputs (CUDA tensors) ->
    (chosen[P] int32 before Permit, requested[N, R], quota_used[G, R]).
    Raises for tensors anywhere but on the card."""
    global launches
    inputs = fc.base
    if not inputs.allocatable.is_cuda:
        raise ValueError("full_chain_round launches the CUDA kernel and takes "
                         f"CUDA tensors, got {inputs.allocatable.device}")
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    K = fc.numa_free.shape[1]
    G, D = fc.quota_ancestors.shape
    T = fc.aff_dom.shape[1]
    S = fc.pref_scores.shape[1]
    PT = fc.port_used.shape[1]
    SI = fc.img_scores.shape[1]
    VG = fc.vol_needed.shape[1]
    S2 = fc.ppref_w.shape[0] if T else 0
    if len(weight_idx) > MAX_WEIGHTS:
        raise ValueError(f"at most {MAX_WEIGHTS} weighted axes")

    reject_np, reject_pr, gang_ok = pod_independent_rows(fc)
    u8 = torch.uint8
    f32 = torch.float32
    i32 = torch.int32

    def b(t):
        return t.to(u8).contiguous()

    dev = inputs.allocatable.device
    # carried state: the round's own copies, updated in place by the kernel
    requested = inputs.requested.to(f32).clone()
    state = {
        "requested": requested,
        "delta_np": torch.zeros((N, R), dtype=f32, device=dev),
        "delta_pr": torch.zeros((N, R), dtype=f32, device=dev),
        "numa": fc.numa_free.to(f32).clone(),
        "bind_free": fc.bind_free.to(f32).clone(),
        "vol_free": fc.vol_free.to(f32).clone(),
        "port_used": fc.port_used.to(f32).clone(),
        "aff_count": fc.aff_count.to(f32).clone(),
        "anti_cover": fc.anti_cover.to(f32).clone(),
        "quota_used": fc.quota_used.to(f32).clone(),
        "chosen": torch.empty(P, dtype=i32, device=dev),
    }
    args = {
        "fit_req": (inputs.fit_requests, f32, (P, R)),
        "req": (fc.requests, f32, (P, R)),
        "est": (inputs.estimated, f32, (P, R)),
        "is_prod": (b(inputs.is_prod), u8, (P,)),
        "is_ds": (b(inputs.is_daemonset), u8, (P,)),
        "pod_valid": (b(inputs.pod_valid), u8, (P,)),
        "gang_ok": (b(gang_ok), u8, (P,)),
        "needs_numa": (b(fc.needs_numa), u8, (P,)),
        "needs_bind": (b(fc.needs_bind), u8, (P,)),
        "full_pcpus": (b(fc.full_pcpus), u8, (P,)),
        "cores": (fc.cores_needed, f32, (P,)),
        "taint_mask": (fc.pod_taint_mask, f32, (P,)),
        "quota_id": (fc.quota_id, i32, (P,)),
        "aff_req": (b(fc.pod_aff_req), u8, (P, T)),
        "anti_req": (b(fc.pod_anti_req), u8, (P, T)),
        "aff_match": (b(fc.pod_aff_match), u8, (P, T)),
        "skew": (fc.pod_spread_skew, f32, (P, T)),
        "pref_id": (fc.pod_pref_id, i32, (P,)),
        "ppref_id": (fc.pod_ppref_id, i32, (P,)),
        "img_id": (fc.pod_img_id, i32, (P,)),
        "port_wants": (b(fc.pod_port_wants), u8, (P, PT)),
        "vol_needed": (fc.vol_needed, f32, (P, VG)),
        "alloc": (inputs.allocatable, f32, (N, R)),
        "term_np": (inputs.la_term_nonprod, f32, (N, R)),
        "term_pr": (inputs.la_term_prod, f32, (N, R)),
        "node_ok": (b(inputs.node_ok), u8, (N,)),
        "score_valid": (b(inputs.la_score_valid), u8, (N,)),
        "reject_np": (b(reject_np), u8, (N,)),
        "reject_pr": (b(reject_pr), u8, (N,)),
        "has_topo": (b(fc.has_topology), u8, (N,)),
        "cpc": (fc.cpus_per_core, f32, (N,)),
        "policy": (fc.numa_policy, i32, (N,)),
        "taint_group": (fc.node_taint_group, i32, (N,)),
        "vol_group": (fc.node_vol_group, i32, (N,)),
        "aff_dom": (fc.aff_dom, f32, (N, T)),
        "pref_scores": (fc.pref_scores, f32, (N, S)),
        "img_scores": (fc.img_scores, f32, (N, SI)),
        "ppref_w": (fc.ppref_w, f32, tuple(fc.ppref_w.shape)),
        "weights": (inputs.weights, f32, (R,)),
        "anc": (fc.quota_ancestors, i32, (G, D)),
        "runtime": (fc.quota_runtime, f32, (G, R)),
        "aff_exists0": (b(fc.aff_exists), u8, (T,)),
        "requested": (requested, f32, (N, R)),
        "delta_np": (state["delta_np"], f32, (N, R)),
        "delta_pr": (state["delta_pr"], f32, (N, R)),
        "numa": (state["numa"], f32, (N, K, R)),
        "bind_free": (state["bind_free"], f32, (N,)),
        "vol_free": (state["vol_free"], f32, (N,)),
        "port_used": (state["port_used"], f32, (N, PT)),
        "aff_count": (state["aff_count"], f32, (N, T)),
        "anti_cover": (state["anti_cover"], f32, (N, T)),
        "quota_used": (state["quota_used"], f32, (G, R)),
        "chosen": (state["chosen"], i32, (P,)),
    }
    params = _Params()
    for name in _PTR_FIELDS:
        t, dtype, shape = args[name]
        setattr(params, name, check_tensor(name, t, dtype, shape))
    sizes = dict(P=P, N=N, R=R, K=K, G=G, D=D, T=T, S=S, S2=S2,
                 ppref_stride=fc.ppref_w.shape[1], PT=PT, SI=SI, VG=VG,
                 prod_mode=int(bool(prod_mode)), bal_c=int(bal_idx[0]),
                 bal_m=int(bal_idx[1]), n_widx=len(weight_idx))
    for name in _INT_FIELDS:
        setattr(params, name, sizes[name])
    for j, r in enumerate(weight_idx):
        params.widx[j] = int(r)

    lib = _lib()
    # The temporaries above may be freed before the kernel ends: the caching
    # allocator hands their memory only to later work on this same stream.
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.full_chain_launch(ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"full_chain kernel launch failed: cudaError {err}")
    launches += 1
    return state["chosen"], requested, state["quota_used"]


def build_cuda_full_chain_step(args: LoadAwareArgs, num_gangs: int,
                               num_groups: int, active_axes=None):
    """FullChainInputs (CUDA tensors) -> (chosen[P], requested[N, R],
    quota_used[G, R]): the kernel's round, then the gang Permit barrier.
    Same contract as models.full_chain.build_full_chain_step."""
    weight_idx = resolve_weight_idx(args, active_axes)
    bal_idx = resolve_balance_idx(active_axes)
    prod_mode = args.score_according_prod_usage

    def step(fc):
        chosen, requested, quota_used = full_chain_round(
            fc, weight_idx, prod_mode, bal_idx)
        return permit(fc, chosen, num_gangs, num_groups), requested, quota_used

    step.last_backend = "cuda"
    return step
