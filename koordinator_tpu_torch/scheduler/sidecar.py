"""Batched scheduling sidecar: the round's entry point for packed arrays,
in process and over gRPC.

The host scheduler (the reference's Go event loop, the C++ client in
native/sidecar_client.cpp, or a Python cycle driver on another machine)
packs its caches into arrays and calls ScheduleBatch (sidecar.proto); the
server lands them on its device, runs one full-chain round there and
returns the bindings. ``SidecarServer.schedule_batch`` is the same round
in process. Steps are cached by (shapes, gangs, flags) as in the JAX
package's sidecar, and also by the score weights, which fix the axes a
step scores over.

The wire is the JAX package's: sidecar.proto and sidecar_pb2.py are
byte-for-byte copies (two modules may register one proto file in a process
only when its serialized descriptor is identical), so either package's
client talks to either package's server. ``grpc`` and ``google.protobuf``
are imported inside the functions that use them: the in-process round needs
neither.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.models.convert import check_device, to_device
from koordinator_tpu_torch.models.full_chain import (
    FullChainInputs,
    build_best_full_chain_step,
)
from koordinator_tpu_torch.ops.kernel_common import SyncClock
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs

SERVICE_NAME = "koordinator.scheduler.v1.BatchedScheduler"
# the largest message either side takes: config 4's request is ~40 MiB
MAX_MESSAGE_BYTES = 1 << 30

_DTYPES = {"float32": np.float32, "int32": np.int32, "bool": np.bool_}


def _pb2():
    from koordinator_tpu_torch.scheduler import sidecar_pb2

    return sidecar_pb2


def tensor_to_np(t) -> np.ndarray:
    arr = np.frombuffer(t.data, dtype=_DTYPES[t.dtype])
    return arr.reshape(tuple(t.shape)).copy()


def np_to_tensor(a):
    a = np.asarray(a)
    dtype = {"float32": "float32", "int32": "int32", "bool": "bool"}[str(a.dtype)]
    return _pb2().Tensor(shape=list(a.shape), dtype=dtype, data=a.tobytes())


def pack_request(fc: FullChainInputs, num_gangs: int, num_groups: int,
                 args: LoadAwareArgs, active_axes=None,
                 snapshot_version: int = 0):
    """FullChainInputs (numpy arrays) -> ScheduleBatchRequest,
    every field: ``base.<name>`` for the ScheduleInputs fields, ``<name>``
    for the rest, and the score weights with the set of axes they name."""
    pb2 = _pb2()
    req = pb2.ScheduleBatchRequest(
        num_gangs=num_gangs,
        num_groups=num_groups,
        score_according_prod_usage=args.score_according_prod_usage,
        snapshot_version=snapshot_version,
    )
    if active_axes is not None:
        req.active_axes.extend(int(a) for a in active_axes)
    # args.resource_weights feed the step's score weights: they must ride
    # the wire or the server would silently score with defaults. The dense
    # vector alone can't tell "axis unset" from "axis set to 0", and
    # consumers iterate resource_weights keys, so the set-axes mask rides
    # alongside and the server rebuilds the key set verbatim.
    from koordinator_tpu_torch.api.resources import (
        NUM_RESOURCES,
        RESOURCE_INDEX,
    )

    req.inputs["args.weights"].CopyFrom(
        np_to_tensor(np.asarray(args.weight_vector(), np.float32)))
    weights_set = np.zeros(NUM_RESOURCES, np.bool_)
    for name in args.resource_weights:
        weights_set[RESOURCE_INDEX[name]] = True
    req.inputs["args.weights_set"].CopyFrom(np_to_tensor(weights_set))
    for name, value in fc.base._asdict().items():
        req.inputs[f"base.{name}"].CopyFrom(np_to_tensor(value))
    for name, value in fc._asdict().items():
        if name == "base":
            continue
        req.inputs[name].CopyFrom(np_to_tensor(value))
    return req


def unpack_request(req, device="cuda") -> Tuple[FullChainInputs,
                                               LoadAwareArgs]:
    """ScheduleBatchRequest -> (FullChainInputs on ``device``, args). Each
    array lands on the device in one upload (models/convert.to_device)."""
    arrays: Dict[str, np.ndarray] = {}
    weights_vec = None
    weights_set = None
    for name, tensor in req.inputs.items():
        if name == "args.weights":
            weights_vec = tensor_to_np(tensor)
        elif name == "args.weights_set":
            weights_set = tensor_to_np(tensor)
        else:
            arrays[name] = tensor_to_np(tensor)
    # wire compat: clients predating the volume-group encoding send a 1-D
    # vol_needed and no node_vol_group; normalize to the VG == 1 form
    # (identical semantics)
    vn = arrays.get("vol_needed")
    if vn is not None and vn.ndim == 1:
        arrays["vol_needed"] = vn[:, None]
    if "node_vol_group" not in arrays and "vol_free" in arrays:
        arrays["node_vol_group"] = np.zeros(arrays["vol_free"].shape[0],
                                            np.int32)
    base = {name[5:]: value for name, value in arrays.items()
            if name.startswith("base.")}
    rest = {name: value for name, value in arrays.items()
            if not name.startswith("base.")}
    from koordinator_tpu_torch.models.scheduler_model import ScheduleInputs

    fc = to_device(FullChainInputs(base=ScheduleInputs(**base), **rest),
                   device)
    args = LoadAwareArgs(
        score_according_prod_usage=req.score_according_prod_usage)
    if weights_vec is not None:
        from koordinator_tpu_torch.api.resources import RESOURCE_AXES

        # rebuild exactly the key set the client configured: the set-axes
        # mask keeps explicitly-zero weights (an older client without the
        # mask falls back to nonzero-only, the previous behavior)
        if weights_set is not None:
            args.resource_weights = {
                RESOURCE_AXES[i]: float(weights_vec[i])
                for i in range(len(weights_vec)) if weights_set[i]
            }
        else:
            args.resource_weights = {
                RESOURCE_AXES[i]: float(v)
                for i, v in enumerate(weights_vec) if v
            }
    return fc, args


class SidecarServer:
    """Request handler; transport added by serve_sidecar. ``device`` is
    where rounds run: "cuda" (the default, the CUDA kernel) or "cpu" (the
    plain round); asking for CUDA where there is none raises."""

    def __init__(self, device="cuda") -> None:
        self.device = check_device(device)
        self._steps: Dict[Tuple, object] = {}
        self.last_backend = None
        # the seconds of the last ScheduleBatch's layers: unpack (the
        # arrays to tensors on the device), upload (none left: they are
        # there), round, permit (on the card), readback, respond (the
        # response message); grpc parses the request before them
        self.last_timings: Dict[str, float] = {}

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

    def ScheduleBatch(self, request, context=None):
        """The RPC: the request's arrays land on the server's device, the
        same keyed step as schedule_batch runs, and ``kernel_seconds`` is
        the round's synchronised seconds (round, Permit and readback)."""
        timings: Dict[str, float] = {}
        clock = SyncClock(timings, self.device)
        fc, args = unpack_request(request, self.device)
        clock.lap("unpack")
        t0 = time.perf_counter()
        chosen, requested, quota_used = self.schedule_batch(
            fc, args, request.num_gangs, request.num_groups,
            tuple(request.active_axes) or None, timings=timings)
        kernel_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        response = _pb2().ScheduleBatchResponse(
            chosen=np_to_tensor(chosen),
            requested=np_to_tensor(requested),
            quota_used=np_to_tensor(quota_used),
            snapshot_version=request.snapshot_version,
            kernel_seconds=kernel_seconds,
        )
        timings["respond"] = time.perf_counter() - t0
        self.last_timings = timings
        return response


def serve_sidecar(address: str, server_impl: Optional[SidecarServer] = None,
                  device="cuda"):
    """Start the gRPC server; address like 'unix:///tmp/x.sock' or
    '[::]:50051'. Without ``server_impl`` it serves a SidecarServer on
    ``device``. Returns the grpc server (``stop(grace)`` ends it)."""
    import grpc
    from concurrent import futures

    pb2 = _pb2()
    impl = server_impl or SidecarServer(device=device)
    handler = grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            "ScheduleBatch": grpc.unary_unary_rpc_method_handler(
                impl.ScheduleBatch,
                request_deserializer=pb2.ScheduleBatchRequest.FromString,
                response_serializer=(
                    pb2.ScheduleBatchResponse.SerializeToString),
            )
        },
    )
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=2),
        options=[("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                 ("grpc.max_send_message_length", MAX_MESSAGE_BYTES)],
    )
    server.add_generic_rpc_handlers((handler,))
    server.add_insecure_port(address)
    server.start()
    return server


def schedule_batch_or_fallback(client, fc, num_gangs: int, num_groups: int,
                               args: LoadAwareArgs, active_axes=None,
                               local_step=None, device="cuda"):
    """Call the sidecar; on a transport failure (dead socket, timeout,
    server crash) run the round locally instead of wedging the scheduling
    cycle, the stance the reference takes for a missing NodeMetric
    dependency (load_aware.go:144-147: degrade, don't block).

    Returns (chosen, requested, quota_used, used_fallback) as numpy arrays.
    The local round is ``local_step`` (the Scheduler passes its own keyed
    step) or a step built here, on ``fc`` landed on ``device``: on the card
    that is kernel 1, never the plain round on the CPU."""
    import grpc

    # pack OUTSIDE the try: a client-side encoding bug is a programming
    # error that must surface, not silently degrade every cycle
    req = pack_request(fc, num_gangs, num_groups, args,
                       active_axes=active_axes)

    def _local_fallback():
        # transport-failure fallback: the Scheduler passes local_step from
        # ITS keyed cache; the bare build only runs for standalone client
        # use, where no step cache exists to route through
        # koordlint: disable=compile-in-steady-state
        step = local_step or build_best_full_chain_step(
            args, num_gangs, num_groups,
            active_axes=list(active_axes) if active_axes else None)
        chosen, requested, quota_used = step(to_device(fc, device))
        return (chosen.cpu().numpy(), requested.cpu().numpy(),
                quota_used.cpu().numpy(), True)

    try:
        resp = client.schedule_batch(req)
        return (tensor_to_np(resp.chosen), tensor_to_np(resp.requested),
                tensor_to_np(resp.quota_used), False)
    except grpc.RpcError as e:
        # TRANSPORT failures degrade; server-side application errors
        # (INVALID_ARGUMENT/INTERNAL: a schema or kernel bug) must surface,
        # not silently burn an RPC round-trip every cycle forever
        transport_codes = (
            grpc.StatusCode.UNAVAILABLE,
            grpc.StatusCode.DEADLINE_EXCEEDED,
            grpc.StatusCode.CANCELLED,
        )
        if e.code() not in transport_codes:
            raise
        return _local_fallback()
    except (ConnectionError, OSError):  # channel-level transport failure
        return _local_fallback()


class SidecarClient:
    """A gRPC channel to a ScheduleBatch server (either package's)."""

    def __init__(self, address: str, timeout_seconds: float = 120.0):
        import grpc

        pb2 = _pb2()
        self._channel = grpc.insecure_channel(
            address,
            options=[("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                     ("grpc.max_send_message_length", MAX_MESSAGE_BYTES)],
        )
        self._timeout = timeout_seconds
        self._call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/ScheduleBatch",
            request_serializer=pb2.ScheduleBatchRequest.SerializeToString,
            response_deserializer=pb2.ScheduleBatchResponse.FromString,
        )

    def schedule_batch(self, request):
        return self._call(request, timeout=self._timeout)

    def close(self) -> None:
        self._channel.close()
