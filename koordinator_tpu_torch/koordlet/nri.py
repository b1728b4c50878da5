"""NRI-mode runtime hooks: a containerd NRI plugin adapter.

Analog of reference `pkg/koordlet/runtimehooks/nri/server.go` (the third
runtimehooks mode next to the CRI proxy and the standalone reconciler).
Topology matches NRI's defining shape: the PLUGIN dials the runtime's
socket (`/var/run/nri/nri.sock` analog; start fails fast when the socket
does not exist — Options.Validate, server.go:50-58), registers itself
(plugin name `koordlet_nri`, index `00` — server.go:68-70), answers the
runtime's Configure with its subscribed-event mask, then serves
RunPodSandbox / CreateContainer / UpdateContainer requests arriving on the
SAME dialed connection (reverse RPC, as ttrpc does for NRI).

Wire format: length-prefixed protobuf frames (koordlet/nri.proto mirrors
the NRI v0.3.0 API surface; the upstream ttrpc schema is not vendored in
the reference checkout). Frame header: `!IHI` = payload length, method id
(response bit 0x8000, error bit 0x4000), request id.

Hook dispatch mirrors server.go:
  * RunPodSandbox  -> PreRunPodSandbox hooks; pod-level cgroup writes are
    applied locally through the executor (podCtx.NriDone), nothing returns
    to the runtime (server.go:151-166);
  * CreateContainer -> PreCreateContainer hooks; env + the NRI-expressible
    cgroup writes (cpuset, cfs quota, memory limit) return as a
    ContainerAdjustment; inexpressible writes (bvt, core-sched cookies)
    apply locally via the executor (containerCtx.NriDone split);
  * UpdateContainer -> PreUpdateContainerResources hooks; returns a
    ContainerUpdate (server.go:190-213).
FailurePolicy: FAIL returns the hook error to the runtime; IGNORE logs
and answers success (server.go:154-160).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
from koordinator_tpu_torch.koordlet import nri_pb2
from koordinator_tpu_torch.koordlet.runtimehooks import ContainerContext, RuntimeHooks
from koordinator_tpu_torch.koordlet.util import system as sysutil
from koordinator_tpu_torch.runtimeproxy.server import FailurePolicy

PLUGIN_NAME = "koordlet_nri"
PLUGIN_IDX = "00"
DEFAULT_EVENTS = ("RunPodSandbox", "CreateContainer", "UpdateContainer")

# method ids on the wire
M_REGISTER = 1
M_CONFIGURE = 2
M_SYNCHRONIZE = 3
M_RUN_POD_SANDBOX = 4
M_CREATE_CONTAINER = 5
M_UPDATE_CONTAINER = 6
M_SHUTDOWN = 7
RESPONSE_BIT = 0x8000
ERROR_BIT = 0x4000

_EVENT_BITS = {
    "RunPodSandbox": 1 << 0,
    "StopPodSandbox": 1 << 1,
    "RemovePodSandbox": 1 << 2,
    "CreateContainer": 1 << 3,
    "StartContainer": 1 << 4,
    "UpdateContainer": 1 << 5,
    "StopContainer": 1 << 6,
    "RemoveContainer": 1 << 7,
}

_HDR = struct.Struct("!IHI")


def event_mask(names) -> int:
    mask = 0
    for n in names:
        bit = _EVENT_BITS.get(str(n).strip())
        if bit is None:
            raise ValueError(f"unknown NRI event {n!r}")
        mask |= bit
    return mask


def send_frame(sock: socket.socket, method: int, req_id: int,
               payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload), method, req_id) + payload)


def recv_frame(sock: socket.socket) -> Optional[Tuple[int, int, bytes]]:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    length, method, req_id = _HDR.unpack(hdr)
    payload = _recv_exact(sock, length) if length else b""
    if length and payload is None:
        return None
    return method, req_id, payload or b""


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def pod_from_sandbox(sb: nri_pb2.PodSandbox) -> Pod:
    """protocol.PodContext.FromNri: rebuild the pod view the hooks consume."""
    return Pod(
        meta=ObjectMeta(
            name=sb.name,
            namespace=sb.namespace,
            uid=sb.uid,
            labels=dict(sb.labels),
            annotations=dict(sb.annotations),
        ),
        spec=PodSpec(),
    )


class NriPlugin:
    """The koordlet-side NRI plugin (NriServer analog)."""

    def __init__(self, socket_path: str, hooks: RuntimeHooks,
                 failure_policy: FailurePolicy = FailurePolicy.IGNORE,
                 events=DEFAULT_EVENTS):
        self.socket_path = socket_path
        self.hooks = hooks
        self.failure_policy = failure_policy
        self.mask = event_mask(events)
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        # handled/errors are written by the serve thread and read by the
        # owner (tests, daemon status) — guard both behind one lock
        self._state_lock = threading.Lock()
        self.handled: Dict[str, int] = {}
        self.errors: List[str] = []

    def _count(self, method: str) -> None:
        with self._state_lock:
            self.handled[method] = self.handled.get(method, 0) + 1

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        """Validate + dial + register + serve (NewNriServer then Start).
        Raises FileNotFoundError when the NRI socket does not exist — the
        fast support check of Options.Validate."""
        if not os.path.exists(self.socket_path):
            raise FileNotFoundError(
                f"nri socket path {self.socket_path!r} does not exist")
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(self.socket_path)
        reg = nri_pb2.RegisterPlugin(
            plugin_name=PLUGIN_NAME, plugin_idx=PLUGIN_IDX)
        send_frame(self._sock, M_REGISTER, 0, reg.SerializeToString())
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
            self._sock = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # -- serving -------------------------------------------------------
    def _serve(self) -> None:
        while True:
            # capture locally: stop() nulls self._sock concurrently; a
            # vanished or closed socket is a clean shutdown, not a crash
            sock = self._sock
            if sock is None:
                return
            frame = recv_frame(sock)
            if frame is None:
                return
            method, req_id, payload = frame
            if method == M_SHUTDOWN:
                return
            try:
                resp = self._dispatch(method, payload)
                send_frame(sock, method | RESPONSE_BIT, req_id,
                           resp.SerializeToString())
            except OSError:
                return  # peer went away mid-response
            except Exception as exc:  # noqa: BLE001 — relayed to the runtime
                err = nri_pb2.Error(message=str(exc))
                try:
                    send_frame(sock, method | RESPONSE_BIT | ERROR_BIT,
                               req_id, err.SerializeToString())
                except OSError:
                    return

    def _dispatch(self, method: int, payload: bytes):
        if method == M_CONFIGURE:
            return self._configure(
                nri_pb2.ConfigureRequest.FromString(payload))
        if method == M_SYNCHRONIZE:
            nri_pb2.SynchronizeRequest.FromString(payload)
            # todo-parity: the reference's Synchronize is a no-op too
            # (server.go:146-149)
            return nri_pb2.SynchronizeResponse()
        if method == M_RUN_POD_SANDBOX:
            return self._run_pod_sandbox(
                nri_pb2.RunPodSandboxRequest.FromString(payload))
        if method == M_CREATE_CONTAINER:
            return self._create_container(
                nri_pb2.CreateContainerRequest.FromString(payload))
        if method == M_UPDATE_CONTAINER:
            return self._update_container(
                nri_pb2.UpdateContainerRequest.FromString(payload))
        raise ValueError(f"unknown NRI method {method}")

    def _configure(self, req: nri_pb2.ConfigureRequest):
        self._count("Configure")
        if req.config:
            cfg = json.loads(req.config)
            self.mask = event_mask(cfg.get("events") or [])
        return nri_pb2.ConfigureResponse(events=self.mask)

    def _run_hooks(self, ctx: ContainerContext, stage: str) -> None:
        try:
            self.hooks.run_hooks(ctx)
        except Exception as exc:  # noqa: BLE001
            with self._state_lock:
                self.errors.append(f"{stage}: {exc}")
            if self.failure_policy is FailurePolicy.FAIL:
                raise
            # IGNORE: the runtime proceeds unmodified

    def _run_pod_sandbox(self, req: nri_pb2.RunPodSandboxRequest):
        self._count("RunPodSandbox")
        pod = pod_from_sandbox(req.pod)
        ctx = ContainerContext(
            pod=pod, cgroup_parent=req.pod.cgroup_parent)
        self._run_hooks(ctx, "RunPodSandbox")
        # podCtx.NriDone: pod-level writes go straight through the executor
        if ctx.cgroup_writes:
            self.hooks.executor.leveled_update_batch(
                list(ctx.cgroup_writes), increase=True)
        return nri_pb2.Empty()

    def _adjustment(self, ctx: ContainerContext) -> nri_pb2.ContainerAdjustment:
        """containerCtx.NriDone split: NRI-expressible writes become
        adjustment resources, the rest applies locally via the executor."""
        adjust = nri_pb2.ContainerAdjustment()
        for k, v in ctx.env.items():
            adjust.env.add(key=k, value=v)
        local = []
        for w in ctx.cgroup_writes:
            if w.resource == sysutil.CPUSET_CPUS:
                adjust.resources.cpuset_cpus = w.value
            elif w.resource == sysutil.CPU_CFS_QUOTA:
                adjust.resources.cpu_quota = int(w.value)
            elif w.resource == sysutil.MEMORY_LIMIT:
                adjust.resources.memory_limit_in_bytes = int(w.value)
            else:
                local.append(w)
        if local:
            self.hooks.executor.leveled_update_batch(local, increase=True)
        return adjust

    def _create_container(self, req: nri_pb2.CreateContainerRequest):
        self._count("CreateContainer")
        pod = pod_from_sandbox(req.pod)
        ctx = ContainerContext(
            pod=pod,
            cgroup_parent=req.container.cgroup_parent
            or req.pod.cgroup_parent,
            env={},
        )
        self._run_hooks(ctx, "CreateContainer")
        return nri_pb2.CreateContainerResponse(adjust=self._adjustment(ctx))

    def _update_container(self, req: nri_pb2.UpdateContainerRequest):
        self._count("UpdateContainer")
        pod = pod_from_sandbox(req.pod)
        ctx = ContainerContext(
            pod=pod,
            cgroup_parent=req.container.cgroup_parent
            or req.pod.cgroup_parent,
            env={},
        )
        self._run_hooks(ctx, "UpdateContainer")
        adjust = self._adjustment(ctx)
        update = nri_pb2.ContainerUpdate(
            container_id=req.container.id, resources=adjust.resources)
        return nri_pb2.UpdateContainerResponse(updates=[update])


class FakeContainerdNri:
    """Test-side runtime: binds the NRI socket, accepts one plugin, drives
    the Configure handshake and lifecycle events (the fake-backend
    discipline of tests/test_criserver.py and tests/test_dockerproxy.py)."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(socket_path)
        self._listener.listen(1)
        self._conn: Optional[socket.socket] = None
        self._req_id = 0
        self.registered: Optional[nri_pb2.RegisterPlugin] = None

    def accept_plugin(self, timeout: float = 5.0) -> nri_pb2.RegisterPlugin:
        self._listener.settimeout(timeout)
        self._conn, _ = self._listener.accept()
        self._conn.settimeout(timeout)
        frame = recv_frame(self._conn)
        assert frame is not None and frame[0] == M_REGISTER
        self.registered = nri_pb2.RegisterPlugin.FromString(frame[2])
        return self.registered

    def call(self, method: int, request) -> Tuple[bool, bytes]:
        """(ok, payload): send one request, wait for its response frame."""
        assert self._conn is not None
        self._req_id += 1
        send_frame(self._conn, method, self._req_id,
                   request.SerializeToString())
        frame = recv_frame(self._conn)
        assert frame is not None, "plugin hung up"
        rmethod, rid, payload = frame
        assert rid == self._req_id, "response id mismatch"
        assert rmethod & RESPONSE_BIT, "expected a response frame"
        assert (rmethod & ~(RESPONSE_BIT | ERROR_BIT)) == method
        return not (rmethod & ERROR_BIT), payload

    def configure(self, config: str = "", runtime: str = "fake-containerd",
                  version: str = "v2.0") -> nri_pb2.ConfigureResponse:
        ok, payload = self.call(M_CONFIGURE, nri_pb2.ConfigureRequest(
            config=config, runtime_name=runtime, runtime_version=version))
        assert ok, nri_pb2.Error.FromString(payload).message
        return nri_pb2.ConfigureResponse.FromString(payload)

    def close(self) -> None:
        if self._conn is not None:
            try:
                send_frame(self._conn, M_SHUTDOWN, 0, b"")
                self._conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._conn.close()
        self._listener.close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
