"""Runtime proxy: fake CRI server logic between kubelet and the real runtime.

Analog of reference `pkg/runtimeproxy/server/cri/` + `dispatcher/` + `store/`:
intercepts the container-lifecycle calls kubelet makes, invokes the registered
hook service before/after selected calls, merges the hook response into the
request, and forwards to the backend runtime (containerd/docker; a
FakeRuntimeBackend here records the merged calls for tests). FailurePolicy
(Fail|Ignore, reference config/) governs hook-server outages. A store of
pod/container info keeps context for calls that lack it (StopContainer)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from koordinator_tpu_torch.runtimeproxy import api_pb2


class FailurePolicy(enum.Enum):
    FAIL = "Fail"
    IGNORE = "Ignore"


@dataclass
class RuntimeCall:
    method: str
    pod_name: str
    container_name: str = ""
    resources: Optional[api_pb2.LinuxContainerResources] = None
    env: Dict[str, str] = field(default_factory=dict)
    cgroup_parent: str = ""


class FakeRuntimeBackend:
    """Stands in for containerd/docker: records forwarded calls."""

    def __init__(self) -> None:
        self.calls: List[RuntimeCall] = []

    def forward(self, call: RuntimeCall) -> None:
        self.calls.append(call)


class RuntimeProxy:
    def __init__(self, hook_client, backend: Optional[FakeRuntimeBackend] = None,
                 failure_policy: FailurePolicy = FailurePolicy.IGNORE):
        self.hook_client = hook_client
        self.backend = backend or FakeRuntimeBackend()
        self.failure_policy = failure_policy
        # store/ analog: pod uid -> sandbox meta; container id -> (pod, meta)
        self.pod_store: Dict[str, api_pb2.PodSandboxMeta] = {}
        self.container_store: Dict[str, api_pb2.ContainerMeta] = {}
        self.container_pod: Dict[str, str] = {}

    # ------------------------------------------------------------------
    def _call_hook(self, method: str, request):
        try:
            return self.hook_client.call(method, request)
        except Exception:
            if self.failure_policy is FailurePolicy.FAIL:
                raise
            return None

    @staticmethod
    def _merge_resources(base: api_pb2.LinuxContainerResources,
                         patch: Optional[api_pb2.LinuxContainerResources]):
        if patch is None:
            return base
        out = api_pb2.LinuxContainerResources()
        out.CopyFrom(base)
        for fld in ("cpu_period", "cpu_quota", "cpu_shares",
                    "memory_limit_bytes", "cpu_bvt_warp_ns"):
            v = getattr(patch, fld)
            if v:
                setattr(out, fld, v)
        if patch.cpuset_cpus:
            out.cpuset_cpus = patch.cpuset_cpus
        if patch.cpuset_mems:
            out.cpuset_mems = patch.cpuset_mems
        return out

    # -- CRI surface ----------------------------------------------------
    def run_pod_sandbox(self, pod_meta: api_pb2.PodSandboxMeta,
                        resources: Optional[api_pb2.LinuxContainerResources] = None):
        req = api_pb2.PodSandboxHookRequest(
            pod_meta=pod_meta,
            resources=resources or api_pb2.LinuxContainerResources(),
        )
        res = self._call_hook("PreRunPodSandboxHook", req)
        merged = self._merge_resources(req.resources, res.resources if res else None)
        cgroup_parent = (
            res.cgroup_parent if res and res.cgroup_parent else pod_meta.cgroup_parent
        )
        if res:
            for k, v in res.annotations.items():
                pod_meta.annotations[k] = v
        self.pod_store[pod_meta.uid] = pod_meta
        self.backend.forward(
            RuntimeCall("RunPodSandbox", pod_meta.name, resources=merged,
                        cgroup_parent=cgroup_parent)
        )
        return merged

    def create_container(self, pod_uid: str, container: api_pb2.ContainerMeta,
                         resources: Optional[api_pb2.LinuxContainerResources] = None,
                         env: Optional[Dict[str, str]] = None):
        pod_meta = self.pod_store.get(pod_uid, api_pb2.PodSandboxMeta(uid=pod_uid))
        req = api_pb2.ContainerResourceHookRequest(
            pod_meta=pod_meta,
            container_meta=container,
            resources=resources or api_pb2.LinuxContainerResources(),
        )
        for k, v in (env or {}).items():
            req.env[k] = v
        res = self._call_hook("PreCreateContainerHook", req)
        merged = self._merge_resources(req.resources, res.resources if res else None)
        out_env = dict(env or {})
        if res:
            out_env.update(dict(res.env))
        self.container_store[container.id] = container
        self.container_pod[container.id] = pod_uid
        self.backend.forward(
            RuntimeCall("CreateContainer", pod_meta.name, container.name,
                        resources=merged, env=out_env)
        )
        return merged, out_env

    def update_container_resources(self, container_id: str,
                                   resources: api_pb2.LinuxContainerResources):
        pod_uid = self.container_pod.get(container_id, "")
        pod_meta = self.pod_store.get(pod_uid, api_pb2.PodSandboxMeta(uid=pod_uid))
        container = self.container_store.get(
            container_id, api_pb2.ContainerMeta(id=container_id)
        )
        req = api_pb2.ContainerResourceHookRequest(
            pod_meta=pod_meta, container_meta=container, resources=resources
        )
        res = self._call_hook("PreUpdateContainerResourcesHook", req)
        merged = self._merge_resources(resources, res.resources if res else None)
        self.backend.forward(
            RuntimeCall("UpdateContainerResources", pod_meta.name, container.name,
                        resources=merged)
        )
        return merged

    def stop_container(self, container_id: str):
        pod_uid = self.container_pod.get(container_id, "")
        pod_meta = self.pod_store.get(pod_uid, api_pb2.PodSandboxMeta(uid=pod_uid))
        container = self.container_store.pop(
            container_id, api_pb2.ContainerMeta(id=container_id)
        )
        self.container_pod.pop(container_id, None)
        req = api_pb2.ContainerResourceHookRequest(
            pod_meta=pod_meta, container_meta=container
        )
        self._call_hook("PostStopContainerHook", req)
        self.backend.forward(
            RuntimeCall("StopContainer", pod_meta.name, container.name)
        )
