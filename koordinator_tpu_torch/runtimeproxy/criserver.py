"""CRI proxy server: a real gRPC server on a unix socket between kubelet and
the backend runtime.

Analog of reference `pkg/runtimeproxy/server/cri/criserver.go`: kubelet dials
the proxy endpoint; intercepted RuntimeService methods run the hook chain
(PreRunPodSandbox / PreCreateContainer / ...) through the koordlet hook
server, merge the hook response into the CRI request, and forward the merged
request to the backend runtime's socket; every other method is transparently
passed through as raw bytes (criserver.go:92-95 TransparentHandler). On
start, ``failover()`` replays ListPodSandbox/ListContainers from the backend
to rebuild the pod/container store after a proxy restart (criserver.go:236+).

FailurePolicy (reference pkg/runtimeproxy/config) governs hook-server
outages: Ignore forwards the original request, Fail aborts the RPC so
kubelet retries.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from koordinator_tpu_torch.runtimeproxy import api_pb2, cri_pb2
from koordinator_tpu_torch.runtimeproxy.server import FailurePolicy

_SERVICE = "runtime.v1.RuntimeService"

# method -> (request type, response type); the typed (interceptable) surface
_METHODS = {
    "RunPodSandbox": (cri_pb2.RunPodSandboxRequest, cri_pb2.RunPodSandboxResponse),
    "StopPodSandbox": (cri_pb2.StopPodSandboxRequest, cri_pb2.StopPodSandboxResponse),
    "CreateContainer": (cri_pb2.CreateContainerRequest, cri_pb2.CreateContainerResponse),
    "StartContainer": (cri_pb2.StartContainerRequest, cri_pb2.StartContainerResponse),
    "StopContainer": (cri_pb2.StopContainerRequest, cri_pb2.StopContainerResponse),
    "UpdateContainerResources": (
        cri_pb2.UpdateContainerResourcesRequest,
        cri_pb2.UpdateContainerResourcesResponse,
    ),
    "ListPodSandbox": (cri_pb2.ListPodSandboxRequest, cri_pb2.ListPodSandboxResponse),
    "ListContainers": (cri_pb2.ListContainersRequest, cri_pb2.ListContainersResponse),
}


def _hook_resources_from_cri(
    res: cri_pb2.LinuxContainerResources,
) -> api_pb2.LinuxContainerResources:
    return api_pb2.LinuxContainerResources(
        cpu_period=res.cpu_period,
        cpu_quota=res.cpu_quota,
        cpu_shares=res.cpu_shares,
        memory_limit_bytes=res.memory_limit_in_bytes,
        cpuset_cpus=res.cpuset_cpus,
        cpuset_mems=res.cpuset_mems,
    )


def _merge_hook_into_cri(
    res: cri_pb2.LinuxContainerResources,
    patch: Optional[api_pb2.LinuxContainerResources],
) -> None:
    """Overlay non-zero hook fields onto the CRI request in place
    (resexecutor/cri/container.go UpdateResource semantics)."""
    if patch is None:
        return
    for src, dst in (
        ("cpu_period", "cpu_period"),
        ("cpu_quota", "cpu_quota"),
        ("cpu_shares", "cpu_shares"),
        ("memory_limit_bytes", "memory_limit_in_bytes"),
    ):
        v = getattr(patch, src)
        if v:
            setattr(res, dst, v)
    if patch.cpuset_cpus:
        res.cpuset_cpus = patch.cpuset_cpus
    if patch.cpuset_mems:
        res.cpuset_mems = patch.cpuset_mems
    if patch.cpu_bvt_warp_ns:
        # no first-class CRI field: lower to the unified cgroup map
        res.unified["cpu.bvt_warp_ns"] = str(patch.cpu_bvt_warp_ns)


class CRIClient:
    """Typed client for the trimmed RuntimeService (used by the proxy toward
    the backend, and by tests as the 'kubelet')."""

    def __init__(self, socket_path: str, timeout_seconds: float = 5.0):
        import grpc

        self._channel = grpc.insecure_channel(f"unix://{socket_path}")
        self._timeout = timeout_seconds
        self._stubs = {
            method: self._channel.unary_unary(
                f"/{_SERVICE}/{method}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=res_t.FromString,
            )
            for method, (req_t, res_t) in _METHODS.items()
        }
        # raw-bytes lane for methods outside the trimmed surface
        self._raw = {}

    def call(self, method: str, request):
        return self._stubs[method](request, timeout=self._timeout)

    def call_raw(self, method: str, payload: bytes) -> bytes:
        if method not in self._raw:
            self._raw[method] = self._channel.unary_unary(
                f"/{_SERVICE}/{method}",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
        return self._raw[method](payload, timeout=self._timeout)

    def close(self) -> None:
        self._channel.close()


class CRIProxyServer:
    """The koord-runtime-proxy binary's core: UDS in, UDS out."""

    def __init__(self, proxy_endpoint: str, backend_endpoint: str,
                 hook_client=None,
                 failure_policy: FailurePolicy = FailurePolicy.IGNORE):
        self.proxy_endpoint = proxy_endpoint
        self.backend = CRIClient(backend_endpoint)
        self.hook_client = hook_client
        self.failure_policy = failure_policy
        # store/ analog: sandbox id -> hook pod meta; container id -> (sandbox
        # id, hook container meta)
        self.pod_store: Dict[str, api_pb2.PodSandboxMeta] = {}
        self.container_store: Dict[str, Tuple[str, api_pb2.ContainerMeta]] = {}
        self._lock = threading.Lock()
        self._server = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        import grpc
        from concurrent import futures

        self.failover()

        outer = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, call_details):
                service, _, method = call_details.method.lstrip("/").partition("/")
                if service != _SERVICE:
                    return None
                if method in _METHODS:
                    req_t, _res_t = _METHODS[method]
                    return grpc.unary_unary_rpc_method_handler(
                        lambda request, context, m=method: outer._intercept(
                            m, request, context
                        ),
                        request_deserializer=req_t.FromString,
                        response_serializer=lambda msg: msg.SerializeToString(),
                    )
                # transparent passthrough: raw bytes to the backend
                return grpc.unary_unary_rpc_method_handler(
                    lambda payload, context, m=method: outer.backend.call_raw(
                        m, payload
                    ),
                    request_deserializer=lambda b: b,
                    response_serializer=lambda b: b,
                )

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((_Generic(),))
        self._server.add_insecure_port(f"unix://{self.proxy_endpoint}")
        self._server.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=None)
            self._server = None
        self.backend.close()

    def failover(self) -> None:
        """Rebuild the pod/container store from the backend after a restart
        (criserver.go failOver)."""
        try:
            sandboxes = self.backend.call(
                "ListPodSandbox", cri_pb2.ListPodSandboxRequest()
            )
            containers = self.backend.call(
                "ListContainers", cri_pb2.ListContainersRequest()
            )
        except Exception:
            return  # backend not up yet; stores fill as calls arrive
        with self._lock:
            for sandbox in sandboxes.items:
                self.pod_store[sandbox.id] = api_pb2.PodSandboxMeta(
                    name=sandbox.metadata.name,
                    namespace=sandbox.metadata.namespace,
                    uid=sandbox.metadata.uid,
                    labels=dict(sandbox.labels),
                    annotations=dict(sandbox.annotations),
                )
            for container in containers.containers:
                self.container_store[container.id] = (
                    container.pod_sandbox_id,
                    api_pb2.ContainerMeta(
                        name=container.metadata.name,
                        id=container.id,
                        labels=dict(container.labels),
                        annotations=dict(container.annotations),
                    ),
                )

    # -- hook dispatch -------------------------------------------------------
    def _call_hook(self, method: str, request, context):
        if self.hook_client is None:
            return None
        try:
            return self.hook_client.call(method, request)
        except Exception as exc:
            if self.failure_policy is FailurePolicy.FAIL:
                import grpc

                context.abort(
                    grpc.StatusCode.INTERNAL,
                    f"runtime hook {method} failed: {exc}",
                )
            return None

    def _intercept(self, method: str, request, context):
        handler = getattr(self, f"_do_{_snake(method)}", None)
        if handler is not None:
            return handler(request, context)
        return self.backend.call(method, request)

    # -- intercepted methods (criserver.go:106-131) --------------------------
    def _do_run_pod_sandbox(self, request, context):
        config = request.config
        pod_meta = api_pb2.PodSandboxMeta(
            name=config.metadata.name,
            namespace=config.metadata.namespace,
            uid=config.metadata.uid,
            labels=dict(config.labels),
            annotations=dict(config.annotations),
            cgroup_parent=config.linux.cgroup_parent,
        )
        res = self._call_hook(
            "PreRunPodSandboxHook",
            api_pb2.PodSandboxHookRequest(pod_meta=pod_meta),
            context,
        )
        if res is not None:
            for k, v in res.annotations.items():
                config.annotations[k] = v
                pod_meta.annotations[k] = v
            if res.cgroup_parent:
                config.linux.cgroup_parent = res.cgroup_parent
                pod_meta.cgroup_parent = res.cgroup_parent
        response = self.backend.call("RunPodSandbox", request)
        with self._lock:
            self.pod_store[response.pod_sandbox_id] = pod_meta
        return response

    def _do_stop_pod_sandbox(self, request, context):
        response = self.backend.call("StopPodSandbox", request)
        with self._lock:
            pod_meta = self.pod_store.pop(
                request.pod_sandbox_id, api_pb2.PodSandboxMeta()
            )
        self._call_hook(
            "PostStopPodSandboxHook",
            api_pb2.PodSandboxHookRequest(pod_meta=pod_meta),
            context,
        )
        return response

    def _do_create_container(self, request, context):
        with self._lock:
            pod_meta = self.pod_store.get(request.pod_sandbox_id)
        if pod_meta is None:
            pod_meta = api_pb2.PodSandboxMeta(
                name=request.sandbox_config.metadata.name,
                namespace=request.sandbox_config.metadata.namespace,
                uid=request.sandbox_config.metadata.uid,
                labels=dict(request.sandbox_config.labels),
                annotations=dict(request.sandbox_config.annotations),
            )
        container_meta = api_pb2.ContainerMeta(
            name=request.config.metadata.name,
            labels=dict(request.config.labels),
            annotations=dict(request.config.annotations),
        )
        hook_req = api_pb2.ContainerResourceHookRequest(
            pod_meta=pod_meta,
            container_meta=container_meta,
            resources=_hook_resources_from_cri(request.config.linux.resources),
        )
        for kv in request.config.envs:
            hook_req.env[kv.key] = kv.value
        res = self._call_hook("PreCreateContainerHook", hook_req, context)
        if res is not None:
            _merge_hook_into_cri(request.config.linux.resources, res.resources)
            # hook env wins on key collision (same semantics as the
            # in-process RuntimeProxy merge in server.py)
            by_key = {kv.key: kv for kv in request.config.envs}
            for k, v in res.env.items():
                if k in by_key:
                    by_key[k].value = v
                else:
                    request.config.envs.add(key=k, value=v)
        response = self.backend.call("CreateContainer", request)
        container_meta.id = response.container_id
        with self._lock:
            self.container_store[response.container_id] = (
                request.pod_sandbox_id, container_meta
            )
        return response

    def _container_hook_request(self, container_id: str):
        with self._lock:
            sandbox_id, container_meta = self.container_store.get(
                container_id, ("", api_pb2.ContainerMeta(id=container_id))
            )
            pod_meta = self.pod_store.get(sandbox_id, api_pb2.PodSandboxMeta())
        return api_pb2.ContainerResourceHookRequest(
            pod_meta=pod_meta, container_meta=container_meta
        )

    def _do_start_container(self, request, context):
        self._call_hook(
            "PreStartContainerHook",
            self._container_hook_request(request.container_id),
            context,
        )
        return self.backend.call("StartContainer", request)

    def _do_stop_container(self, request, context):
        response = self.backend.call("StopContainer", request)
        hook_req = self._container_hook_request(request.container_id)
        with self._lock:
            self.container_store.pop(request.container_id, None)
        self._call_hook("PostStopContainerHook", hook_req, context)
        return response

    def _do_update_container_resources(self, request, context):
        hook_req = self._container_hook_request(request.container_id)
        hook_req.resources.CopyFrom(_hook_resources_from_cri(request.linux))
        res = self._call_hook("PreUpdateContainerResourcesHook", hook_req, context)
        if res is not None:
            _merge_hook_into_cri(request.linux, res.resources)
        return self.backend.call("UpdateContainerResources", request)


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper() and out:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


class FakeContainerdServer:
    """A backend runtime implemented as a real gRPC server on a second unix
    socket (the e2e stand-in for containerd). Records every request it
    receives; unknown methods (the passthrough lane) land in ``raw_calls``."""

    def __init__(self, socket_path: str):
        import itertools

        self.socket_path = socket_path
        self.requests = []  # (method, request message)
        self.raw_calls = []  # (method, payload bytes)
        self._counter = itertools.count(1)
        self._sandboxes: Dict[str, cri_pb2.PodSandbox] = {}
        self._containers: Dict[str, cri_pb2.Container] = {}
        # gRPC handler threads run concurrently; every request-log and
        # sandbox/container map access goes through this lock
        self._lock = threading.Lock()
        self._server = None

    def _next_id(self, prefix: str) -> str:
        return f"{prefix}-{next(self._counter)}"

    def handle(self, method: str, request):
        with self._lock:
            self.requests.append((method, request))
            if method == "RunPodSandbox":
                sandbox_id = self._next_id("sandbox")
                self._sandboxes[sandbox_id] = cri_pb2.PodSandbox(
                    id=sandbox_id, metadata=request.config.metadata,
                    labels=request.config.labels,
                    annotations=request.config.annotations,
                )
                return cri_pb2.RunPodSandboxResponse(pod_sandbox_id=sandbox_id)
            if method == "StopPodSandbox":
                self._sandboxes.pop(request.pod_sandbox_id, None)
                return cri_pb2.StopPodSandboxResponse()
            if method == "CreateContainer":
                container_id = self._next_id("container")
                self._containers[container_id] = cri_pb2.Container(
                    id=container_id, pod_sandbox_id=request.pod_sandbox_id,
                    metadata=request.config.metadata,
                    labels=request.config.labels,
                    annotations=request.config.annotations,
                )
                return cri_pb2.CreateContainerResponse(
                    container_id=container_id)
            if method == "StartContainer":
                return cri_pb2.StartContainerResponse()
            if method == "StopContainer":
                self._containers.pop(request.container_id, None)
                return cri_pb2.StopContainerResponse()
            if method == "UpdateContainerResources":
                return cri_pb2.UpdateContainerResourcesResponse()
            if method == "ListPodSandbox":
                return cri_pb2.ListPodSandboxResponse(
                    items=list(self._sandboxes.values())
                )
            if method == "ListContainers":
                return cri_pb2.ListContainersResponse(
                    containers=list(self._containers.values())
                )
        raise KeyError(method)

    def start(self) -> None:
        import grpc
        from concurrent import futures

        outer = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, call_details):
                service, _, method = call_details.method.lstrip("/").partition("/")
                if service != _SERVICE:
                    return None
                if method in _METHODS:
                    req_t, _ = _METHODS[method]
                    return grpc.unary_unary_rpc_method_handler(
                        lambda request, context, m=method: outer.handle(m, request),
                        request_deserializer=req_t.FromString,
                        response_serializer=lambda msg: msg.SerializeToString(),
                    )

                def raw(payload, context, m=method):
                    with outer._lock:
                        outer.raw_calls.append((m, payload))
                    if m == "Version":
                        return cri_pb2.VersionResponse(
                            version="0.1.0", runtime_name="fake-containerd",
                            runtime_version="1.7", runtime_api_version="v1",
                        ).SerializeToString()
                    return b""

                return grpc.unary_unary_rpc_method_handler(
                    raw,
                    request_deserializer=lambda b: b,
                    response_serializer=lambda b: b,
                )

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((_Generic(),))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=None)
            self._server = None
