"""koordlet hook server: RuntimeHookService backed by the runtime hooks.

Analog of reference `pkg/koordlet/runtimehooks/proxyserver/`: translates the
proto context into a ContainerContext, runs the hook chain, and maps the writes
back to LinuxContainerResources / env in the response. Served over gRPC/UDS by
`runtimeproxy.hookclient.serve_hook_service`, or embedded in-process (NRI
mode)."""

from __future__ import annotations

from typing import Optional

from koordinator_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
from koordinator_tpu_torch.koordlet.runtimehooks import ContainerContext, RuntimeHooks
from koordinator_tpu_torch.koordlet.util import system as sysutil
from koordinator_tpu_torch.runtimeproxy import api_pb2


def _pod_from_meta(meta: api_pb2.PodSandboxMeta) -> Pod:
    return Pod(
        meta=ObjectMeta(
            name=meta.name,
            namespace=meta.namespace or "default",
            uid=meta.uid,
            labels=dict(meta.labels),
            annotations=dict(meta.annotations),
        ),
        spec=PodSpec(),
    )


class HookHandler:
    """One method per RPC (see runtimeproxy/api.proto)."""

    def __init__(self, runtime_hooks: RuntimeHooks):
        self.hooks = runtime_hooks

    # -- translation -----------------------------------------------------
    def _run(self, pod_meta: api_pb2.PodSandboxMeta) -> ContainerContext:
        # prefer the informer's full pod object (it has requests/limits);
        # O(1) uid lookup — this is the per-CRI-call critical path
        pod = None
        if pod_meta.uid:
            pod = self.hooks.informer.get_pod_by_uid(pod_meta.uid)
        if pod is None:
            pod = _pod_from_meta(pod_meta)
        ctx = ContainerContext(pod=pod, cgroup_parent=pod_meta.cgroup_parent)
        self.hooks.run_hooks(ctx)
        return ctx

    @staticmethod
    def _resources_from_ctx(ctx: ContainerContext) -> api_pb2.LinuxContainerResources:
        out = api_pb2.LinuxContainerResources()
        for w in ctx.cgroup_writes:
            if w.resource == sysutil.CPU_BVT_WARP_NS:
                out.cpu_bvt_warp_ns = int(w.value)
            elif w.resource == sysutil.CPU_CFS_QUOTA:
                out.cpu_quota = int(w.value)
            elif w.resource == sysutil.CPUSET_CPUS:
                out.cpuset_cpus = w.value
            elif w.resource == sysutil.MEMORY_LIMIT:
                out.memory_limit_bytes = int(w.value)
            elif w.resource == sysutil.CPU_SHARES:
                out.cpu_shares = int(w.value)
        return out

    # -- pod sandbox RPCs ------------------------------------------------
    def PreRunPodSandboxHook(self, request: api_pb2.PodSandboxHookRequest):
        ctx = self._run(request.pod_meta)
        return api_pb2.PodSandboxHookResponse(
            resources=self._resources_from_ctx(ctx),
            cgroup_parent=request.pod_meta.cgroup_parent,
        )

    def PostStopPodSandboxHook(self, request: api_pb2.PodSandboxHookRequest):
        return api_pb2.PodSandboxHookResponse()

    # -- container RPCs ---------------------------------------------------
    def _container_rpc(self, request: api_pb2.ContainerResourceHookRequest):
        ctx = self._run(request.pod_meta)
        res = api_pb2.ContainerResourceHookResponse(
            resources=self._resources_from_ctx(ctx)
        )
        for k, v in ctx.env.items():
            res.env[k] = v
        return res

    def PreCreateContainerHook(self, request):
        return self._container_rpc(request)

    def PreStartContainerHook(self, request):
        return self._container_rpc(request)

    def PostStartContainerHook(self, request):
        return self._container_rpc(request)

    def PreUpdateContainerResourcesHook(self, request):
        return self._container_rpc(request)

    def PostStopContainerHook(self, request):
        return api_pb2.ContainerResourceHookResponse()
