"""The runtime proxy binary between a fake containerd and the koordlet's
hook server, over unix sockets.

``binary_roundtrip`` starts ``cmd/koord_runtime_proxy.py --mode cri`` as a
child process, serves a fake containerd and a koordlet hook server (a
Daemon on a FakeFS holding one BE pod) in this process, and sends one
RunPodSandbox and one CreateContainer through the proxy socket, as a
kubelet would. It needs no card.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GIB = 1024 ** 3


def binary_roundtrip(timeout_s: float = 60.0) -> dict:
    """cmd/koord_runtime_proxy.py (--mode cri) as a child process between
    a fake containerd and the koordlet's hook server over unix sockets, a
    BE pod's Daemon on a FakeFS in this process: one RunPodSandbox and one
    CreateContainer through the proxy socket. The container request that
    reaches containerd must carry every cgroup write of the hook's own
    answer for that pod. Stops the child. Returns the forwarded and the
    hook's resources."""
    from koordinator_tpu_torch.api.objects import (
        LABEL_POD_QOS,
        Node,
        ObjectMeta,
        Pod,
        PodSpec,
    )
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import (
        KIND_NODE,
        KIND_POD,
        ObjectStore,
    )
    from koordinator_tpu_torch.koordlet.daemon import Daemon
    from koordinator_tpu_torch.koordlet.hookserver import HookHandler
    from koordinator_tpu_torch.koordlet.util.system import FakeFS
    from koordinator_tpu_torch.runtimeproxy import api_pb2, cri_pb2
    from koordinator_tpu_torch.runtimeproxy.criserver import (
        CRIClient,
        FakeContainerdServer,
    )
    from koordinator_tpu_torch.runtimeproxy.hookclient import (
        serve_hook_service,
    )

    fs = FakeFS(use_cgroup_v2=True)
    store = ObjectStore()
    store.add(KIND_NODE, Node(
        meta=ObjectMeta(name="node-0", namespace=""),
        allocatable=ResourceList.of(cpu=16_000, memory=64 * GIB, pods=110)))
    be = ResourceList.of(batch_cpu=2000, batch_memory=4 * GIB)
    store.add(KIND_POD, Pod(
        meta=ObjectMeta(name="spark-0", uid="spark-0",
                        labels={LABEL_POD_QOS: "BE"}),
        spec=PodSpec(node_name="node-0", requests=be, limits=be),
        phase="Running"))
    handler = HookHandler(Daemon(store, "node-0", fs.config,
                                 report_interval_seconds=0).runtime_hooks)
    tmp = tempfile.mkdtemp(prefix="koord-cri-")
    proxy_sock, backend_sock, hook_sock = (
        os.path.join(tmp, n) for n in ("proxy.sock", "containerd.sock",
                                       "hooks.sock"))
    hook_server = serve_hook_service(handler, hook_sock)
    backend = FakeContainerdServer(backend_sock)
    backend.start()
    child = subprocess.Popen(
        [sys.executable, "-m", "koordinator_tpu_torch.cmd.koord_runtime_proxy",
         "--mode", "cri", "--proxy-endpoint", proxy_sock,
         "--backend-endpoint", backend_sock,
         "--hook-server-endpoint", hook_sock],
        cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    kubelet = None
    try:
        deadline = time.monotonic() + timeout_s
        while not os.path.exists(proxy_sock):
            if child.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"koord_runtime_proxy did not serve: "
                                     f"{child.poll()}")
            time.sleep(0.05)
        kubelet = CRIClient(proxy_sock)
        run = cri_pb2.RunPodSandboxRequest()
        meta = run.config.metadata
        meta.name, meta.namespace, meta.uid = "spark-0", "default", "spark-0"
        run.config.labels[LABEL_POD_QOS] = "BE"
        run.config.linux.cgroup_parent = "kubepods/besteffort/podspark-0"
        sandbox = kubelet.call("RunPodSandbox", run)
        create = cri_pb2.CreateContainerRequest(
            pod_sandbox_id=sandbox.pod_sandbox_id)
        create.config.metadata.name = "main"
        create.config.linux.resources.cpu_shares = 2
        kubelet.call("CreateContainer", create)
        method, forwarded = backend.requests[-1]
        got = forwarded.config.linux.resources
        want = handler.PreCreateContainerHook(
            api_pb2.ContainerResourceHookRequest(
                pod_meta=api_pb2.PodSandboxMeta(
                    name="spark-0", namespace="default", uid="spark-0",
                    labels={LABEL_POD_QOS: "BE"},
                    cgroup_parent=run.config.linux.cgroup_parent))).resources
        expect = {
            "cpu_quota": want.cpu_quota, "cpu_shares": want.cpu_shares,
            "memory_limit_in_bytes": want.memory_limit_bytes,
            "cpuset_cpus": want.cpuset_cpus,
            "cpu.bvt_warp_ns": str(want.cpu_bvt_warp_ns)}
        seen = {"cpu_quota": got.cpu_quota, "cpu_shares": got.cpu_shares,
                "memory_limit_in_bytes": got.memory_limit_in_bytes,
                "cpuset_cpus": got.cpuset_cpus,
                "cpu.bvt_warp_ns": got.unified.get("cpu.bvt_warp_ns", "0")}
        if (method != "CreateContainer" or want.cpu_bvt_warp_ns != -1
                or any(v and seen[k] != v for k, v in expect.items())):
            raise AssertionError(f"cri: forwarded {seen}, hook {expect}")
        return {"method": method, "forwarded": seen, "hook": expect}
    finally:
        if kubelet is not None:
            kubelet.close()
        child.send_signal(signal.SIGINT)
        try:
            child.wait(timeout=10)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
        backend.stop()
        hook_server.stop(grace=None)
        fs.cleanup()
        shutil.rmtree(tmp, ignore_errors=True)
