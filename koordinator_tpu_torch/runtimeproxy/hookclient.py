"""Hook service transport: gRPC/UDS client + server glue.

The reference talks gRPC over unix sockets between runtime-proxy and koordlet
(dispatcher -> RuntimeHookService). grpc_tools isn't available for stub
codegen, so the service is wired with grpc's generic handler API over the
protoc-generated message classes — same wire protocol, no generated stubs.
An in-process client short-circuits the transport for tests and for NRI-style
embedding (hooks in the same process)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

from koordinator_tpu_torch.runtimeproxy import api_pb2

SERVICE_NAME = "koordinator.runtimeproxy.v1.RuntimeHookService"

POD_METHODS = ("PreRunPodSandboxHook", "PostStopPodSandboxHook")
CONTAINER_METHODS = (
    "PreCreateContainerHook",
    "PreStartContainerHook",
    "PostStartContainerHook",
    "PreUpdateContainerResourcesHook",
    "PostStopContainerHook",
)


def _req_res_types(method: str):
    if method in POD_METHODS:
        return api_pb2.PodSandboxHookRequest, api_pb2.PodSandboxHookResponse
    return (
        api_pb2.ContainerResourceHookRequest,
        api_pb2.ContainerResourceHookResponse,
    )


class HookClient:
    """gRPC client over a unix socket."""

    def __init__(self, socket_path: str, timeout_seconds: float = 5.0):
        import grpc

        self._channel = grpc.insecure_channel(f"unix://{socket_path}")
        self._timeout = timeout_seconds
        self._stubs: Dict[str, Callable] = {}
        for method in POD_METHODS + CONTAINER_METHODS:
            req_t, res_t = _req_res_types(method)
            self._stubs[method] = self._channel.unary_unary(
                f"/{SERVICE_NAME}/{method}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=res_t.FromString,
            )

    def call(self, method: str, request):
        return self._stubs[method](request, timeout=self._timeout)

    def close(self) -> None:
        self._channel.close()


class InProcessHookClient:
    """Short-circuit transport: calls the handler object directly."""

    def __init__(self, handler):
        self._handler = handler

    def call(self, method: str, request):
        return getattr(self._handler, method)(request)


def serve_hook_service(handler, socket_path: str):
    """Start a gRPC server for RuntimeHookService on a unix socket; returns the
    started server (caller stops it). `handler` has one method per RPC taking
    the request message and returning the response message."""
    import grpc
    from concurrent import futures

    def make_behavior(method: str):
        def behavior(request, context):
            return getattr(handler, method)(request)

        return behavior

    handlers = {}
    for method in POD_METHODS + CONTAINER_METHODS:
        req_t, res_t = _req_res_types(method)
        handlers[method] = grpc.unary_unary_rpc_method_handler(
            make_behavior(method),
            request_deserializer=req_t.FromString,
            response_serializer=res_t.SerializeToString,
        )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )
    server.add_insecure_port(f"unix://{socket_path}")
    server.start()
    return server
