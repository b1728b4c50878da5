"""Docker (dockershim-style) backend for koord-runtime-proxy.

Analog of reference `pkg/runtimeproxy/server/docker/`: where the CRI path
(criserver.py) is a gRPC interceptor, the docker path is an HTTP reverse
proxy on a unix socket speaking the Docker Engine API. kubelet's dockershim
dials the proxy socket; the proxy intercepts the container-lifecycle calls

    POST /<ver>/containers/create          (hook: PreCreateContainer)
    POST /<ver>/containers/<id>/start      (hook: PreStartContainer)
    POST /<ver>/containers/<id>/stop       (hook: PostStopContainer, fired
                                            AFTER the daemon confirms the
                                            stop — same order as the CRI
                                            path — then the meta entry is
                                            dropped)
    POST /<ver>/containers/<id>/update     (hook: PreUpdateContainerResources)

runs the koordlet hook chain, overlays the hook's resource response onto the
request's HostConfig JSON (CpuPeriod/CpuQuota/CpuShares/Memory/CpusetCpus/
CpusetMems — the docker-API spellings of resexecutor's update semantics),
and forwards the mutated request to the real docker daemon's socket. Every
other path/method passes through untouched (the docker analog of the CRI
TransparentHandler), including Connection-Upgrade hijacks (exec/attach):
after relaying the request raw, the proxy pumps bytes both ways until
either side closes, so `kubectl exec` / `attach` / `logs -f` work through
the docker path exactly as through the reference's server
(pkg/runtimeproxy/server/docker/server.go proxies all endpoints).
FailurePolicy matches the CRI path: Ignore forwards the original request
when the hook server is down, Fail returns 502 so kubelet retries.

The pod/sandbox linkage rides docker labels the way dockershim writes them
(`io.kubernetes.pod.*`, `io.kubernetes.container.name`): create requests
carry them, so hook requests can be populated without a separate sandbox
store.
"""

from __future__ import annotations

import json
import os
import re
import socket
import socketserver
import stat
import threading
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional, Tuple

from koordinator_tpu_torch.runtimeproxy import api_pb2
from koordinator_tpu_torch.runtimeproxy.server import FailurePolicy

_CREATE_RE = re.compile(r"^/v[\d.]+/containers/create$")
_LIFECYCLE_RE = re.compile(
    r"^/v[\d.]+/containers/(?P<id>[^/]+)/(?P<op>start|stop|update)$")

# dockershim's well-known labels
_LABEL_POD_NAME = "io.kubernetes.pod.name"
_LABEL_POD_NS = "io.kubernetes.pod.namespace"
_LABEL_POD_UID = "io.kubernetes.pod.uid"
_LABEL_CONTAINER = "io.kubernetes.container.name"


def _host_config_to_hook(hc: dict) -> api_pb2.LinuxContainerResources:
    return api_pb2.LinuxContainerResources(
        cpu_period=int(hc.get("CpuPeriod") or 0),
        cpu_quota=int(hc.get("CpuQuota") or 0),
        cpu_shares=int(hc.get("CpuShares") or 0),
        memory_limit_bytes=int(hc.get("Memory") or 0),
        cpuset_cpus=hc.get("CpusetCpus") or "",
        cpuset_mems=hc.get("CpusetMems") or "",
    )


def _merge_hook_into_host_config(
    hc: dict, patch: Optional[api_pb2.LinuxContainerResources]
) -> None:
    """Overlay non-zero hook fields (same merge stance as the CRI path's
    _merge_hook_into_cri)."""
    if patch is None:
        return
    for src, dst in (
        ("cpu_period", "CpuPeriod"),
        ("cpu_quota", "CpuQuota"),
        ("cpu_shares", "CpuShares"),
        ("memory_limit_bytes", "Memory"),
    ):
        v = getattr(patch, src)
        if v:
            hc[dst] = int(v)
    if patch.cpuset_cpus:
        hc["CpusetCpus"] = patch.cpuset_cpus
    if patch.cpuset_mems:
        hc["CpusetMems"] = patch.cpuset_mems


class _UnixHTTPConnection(HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 10.0):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


class _UnixHTTPServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True

    def handle_error(self, request, client_address):
        # keep-alive peers closing mid-read are routine, not reportable
        pass


def _unlink_stale_socket(path: str) -> None:
    """allow_reuse_address is a no-op for AF_UNIX: a socket file left by an
    unclean shutdown raises 'Address already in use' on rebind, so remove
    it first — but only if it IS a socket (never a regular file) and
    nobody answers on it (a live server's endpoint must not be destroyed
    by a double start; its bind error surfaces instead)."""
    try:
        if not stat.S_ISSOCK(os.stat(path).st_mode):
            return
    except OSError:
        return  # nothing there
    probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        probe.settimeout(0.2)
        probe.connect(path)
        return  # something is serving: leave it alone
    except ConnectionRefusedError:
        pass  # definitively stale: bound-then-abandoned file
    except OSError:
        # timeout / EAGAIN (full backlog) / anything ambiguous: the server
        # may be alive but busy — never destroy its endpoint; our own bind
        # error will surface instead
        return
    finally:
        probe.close()
    try:
        os.unlink(path)
    except OSError:
        pass


class DockerProxyServer:
    """HTTP/UDS reverse proxy between kubelet(dockershim) and dockerd."""

    def __init__(self, proxy_socket: str, backend_socket: str,
                 hook_client=None,
                 failure_policy: FailurePolicy = FailurePolicy.IGNORE):
        self.proxy_socket = proxy_socket
        self.backend_socket = backend_socket
        self.hook_client = hook_client
        self.failure_policy = failure_policy
        # container id -> (pod meta, container meta) from create labels
        self.container_store: Dict[
            str, Tuple[api_pb2.PodSandboxMeta, api_pb2.ContainerMeta]] = {}
        # create-name -> meta awaiting the daemon-assigned id (keyed by the
        # ?name= query param so concurrent creates cannot cross-bind)
        self._pending_meta: Dict[str, Tuple] = {}
        self._lock = threading.Lock()
        self._server: Optional[_UnixHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- hook dispatch -------------------------------------------------------
    def _call_hook(self, method: str, request):
        """(response | None, abort) under the failure policy."""
        if self.hook_client is None:
            return None, False
        try:
            return self.hook_client.call(method, request), False
        except Exception:
            if self.failure_policy == FailurePolicy.FAIL:
                return None, True
            return None, False

    # -- request interception ------------------------------------------------
    @staticmethod
    def _query_name(path: str) -> str:
        from urllib.parse import parse_qs, urlsplit

        qs = parse_qs(urlsplit(path).query)
        return (qs.get("name") or [""])[0]

    def _intercept(self, method: str, path: str, body: bytes,
                   ) -> Tuple[bytes, Optional[int], Optional[str]]:
        """Returns (possibly mutated body, error status or None, pending-
        meta key for creates). Stop is NOT handled here: its hook is
        post-forward (see _after_response)."""
        if method != "POST":
            return body, None, None
        if _CREATE_RE.match(path.split("?")[0]):
            try:
                payload = json.loads(body or b"{}")
            except ValueError:
                return body, None, None
            labels = payload.get("Labels") or {}
            pod_meta = api_pb2.PodSandboxMeta(
                name=labels.get(_LABEL_POD_NAME, ""),
                namespace=labels.get(_LABEL_POD_NS, ""),
                uid=labels.get(_LABEL_POD_UID, ""),
                labels=labels,
            )
            container_meta = api_pb2.ContainerMeta(
                name=labels.get(_LABEL_CONTAINER, ""), labels=labels)
            hc = payload.setdefault("HostConfig", {})
            req = api_pb2.ContainerResourceHookRequest(
                pod_meta=pod_meta,
                container_meta=container_meta,
                resources=_host_config_to_hook(hc),
            )
            resp, abort = self._call_hook("PreCreateContainerHook", req)
            if abort:
                return body, 502, None
            if resp is not None and resp.HasField("resources"):
                _merge_hook_into_host_config(hc, resp.resources)
            # dockershim always names containers (?name=...); unnamed
            # creates get a unique token so concurrent ones cannot share
            # the "" key and cross-bind pod metadata
            import uuid

            pending_key = self._query_name(path) or f"unnamed-{uuid.uuid4()}"
            with self._lock:
                self._pending_meta[pending_key] = (pod_meta, container_meta)
            return json.dumps(payload).encode(), None, pending_key
        m = _LIFECYCLE_RE.match(path.split("?")[0])
        if m:
            cid, op = m.group("id"), m.group("op")
            if op == "stop":  # post-forward hook: nothing to do pre-flight
                return body, None, None
            with self._lock:
                pod_meta, container_meta = self.container_store.get(
                    cid, (api_pb2.PodSandboxMeta(), api_pb2.ContainerMeta()))
            hook_method = {
                "start": "PreStartContainerHook",
                "update": "PreUpdateContainerResourcesHook",
            }[op]
            meta = api_pb2.ContainerMeta()
            meta.CopyFrom(container_meta)
            meta.id = cid
            req = api_pb2.ContainerResourceHookRequest(
                pod_meta=pod_meta, container_meta=meta)
            if op == "update":
                try:
                    payload = json.loads(body or b"{}")
                except ValueError:
                    payload = None
                if payload is not None:
                    req.resources.CopyFrom(_host_config_to_hook(payload))
                resp, abort = self._call_hook(hook_method, req)
                if abort:
                    return body, 502, None
                if (payload is not None and resp is not None
                        and resp.HasField("resources")):
                    _merge_hook_into_host_config(payload, resp.resources)
                    return json.dumps(payload).encode(), None, None
                return body, None, None
            _resp, abort = self._call_hook(hook_method, req)
            if abort:
                return body, 502, None
        return body, None, None

    def _after_response(self, method: str, path: str, status: int,
                        resp_body: bytes,
                        pending_key: Optional[str] = None) -> None:
        """Post-forward bookkeeping: bind create ids, fire the post-stop
        hook only once the daemon CONFIRMED the stop (CRI-path order), and
        drop meta on stop/delete so the store cannot leak."""
        clean = path.split("?")[0]
        if method == "POST" and _CREATE_RE.match(clean):
            # pop the pending entry on EVERY create outcome — a rejected
            # create (409/500) must not leak it
            with self._lock:
                meta = (self._pending_meta.pop(pending_key, None)
                        if pending_key else None)
            if status != 201 or meta is None:
                return
            try:
                cid = json.loads(resp_body).get("Id", "")
            except ValueError:
                return
            if cid:
                with self._lock:
                    self.container_store[cid] = meta
            return
        m = _LIFECYCLE_RE.match(clean)
        if method == "POST" and m and m.group("op") == "stop":
            # 404 == the daemon no longer knows the container (AutoRemove,
            # out-of-band rm, daemon restart): treat it as a confirmed
            # teardown — fire the post-stop hook so koordlet releases its
            # per-container state, then drop the meta (no DELETE may ever
            # come). Other non-2xx are transient: keep the entry for the
            # kubelet retry.
            if status >= 300 and status != 404:
                return
            cid = m.group("id")
            with self._lock:
                entry = self.container_store.pop(cid, None)
            if entry is None:
                # never tracked (non-k8s container) or already handled (a
                # stop retry after an earlier 404): no blank-meta hook and
                # no duplicate teardown event for koordlet
                return
            pod_meta, container_meta = entry
            meta = api_pb2.ContainerMeta()
            meta.CopyFrom(container_meta)
            meta.id = cid
            self._call_hook(
                "PostStopContainerHook",
                api_pb2.ContainerResourceHookRequest(
                    pod_meta=pod_meta, container_meta=meta))
            return
        dm = re.match(r"^/v[\d.]+/containers/(?P<id>[^/]+)$", clean)
        if method == "DELETE" and dm and status < 300:
            with self._lock:
                self.container_store.pop(dm.group("id"), None)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _relay(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                # hijacked/upgraded connections (exec/attach/logs over the
                # hijack protocol) cannot ride an http.client relay: tunnel
                # the raw bytes instead — request verbatim to the daemon,
                # then a bidirectional pump until either side closes (the
                # reference's docker server proxies these transparently).
                # Decided BEFORE _intercept: upgrade endpoints are not
                # lifecycle hooks, and the tunnel forwards the ORIGINAL
                # headers, so a hook-mutated body (new length) or a pending
                # create entry must never reach this path
                if "upgrade" in (self.headers.get("Connection") or "").lower():
                    self._tunnel(body)
                    return
                body, err, pending_key = proxy._intercept(
                    self.command, self.path, body)
                if err is not None:
                    self.send_response(err)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                conn = _UnixHTTPConnection(proxy.backend_socket)
                streamed = False
                try:
                    headers = {
                        k: v for k, v in self.headers.items()
                        if k.lower() not in ("host", "content-length")
                    }
                    headers["Content-Length"] = str(len(body))
                    conn.request(self.command, self.path, body=body,
                                 headers=headers)
                    resp = conn.getresponse()
                    # 204/304 are BODYLESS — Go's net/http (real dockerd)
                    # omits Content-Length on them, and stop/delete return
                    # 204; they must take the buffered path or
                    # _after_response (post-stop hook, store cleanup)
                    # would never run
                    if (resp.getheader("Content-Length") is None
                            and resp.status not in (204, 304)):
                        # unbounded/streaming response (logs?follow, events,
                        # stats?stream): forward chunks as they arrive —
                        # buffering with read() would block forever
                        streamed = True
                        if conn.sock is not None:
                            conn.sock.settimeout(None)  # sporadic stream
                        self.send_response(resp.status)
                        ctype = resp.getheader("Content-Type")
                        if ctype:
                            self.send_header("Content-Type", ctype)
                        self.send_header("Connection", "close")
                        self.end_headers()
                        self.close_connection = True
                        while True:
                            chunk = resp.read(16384)
                            if not chunk:
                                break
                            self.wfile.write(chunk)
                            self.wfile.flush()
                        return
                    resp_body = resp.read()
                except OSError:
                    if pending_key:  # failed create must not leak its meta
                        with proxy._lock:
                            proxy._pending_meta.pop(pending_key, None)
                    if streamed:
                        return  # headers already sent; peer/daemon gone
                    self.send_response(502)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                finally:
                    conn.close()
                proxy._after_response(self.command, self.path, resp.status,
                                      resp_body, pending_key)
                self.send_response(resp.status)
                self.send_header("Content-Length", str(len(resp_body)))
                ctype = resp.getheader("Content-Type")
                if ctype:
                    self.send_header("Content-Type", ctype)
                self.end_headers()
                self.wfile.write(resp_body)

            def _tunnel(self, body: bytes) -> None:
                """Byte-for-byte Connection-Upgrade relay. The daemon's
                response (101 UPGRADED + raw stream) flows back verbatim;
                after it, the connection is a plain duplex pipe."""
                back = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    back.settimeout(10.0)
                    back.connect(proxy.backend_socket)
                except OSError:
                    back.close()
                    self.send_response(502)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.close_connection = True
                lines = [f"{self.command} {self.path} HTTP/1.1"]
                lines.extend(
                    f"{k}: {v}" for k, v in self.headers.items()
                    if k.lower() != "host")
                lines.append("Host: docker")
                raw = ("\r\n".join(lines) + "\r\n\r\n").encode(
                    "latin-1") + body
                try:
                    back.sendall(raw)
                    back.settimeout(None)  # interactive stream: no deadline
                    client = self.connection
                    client.settimeout(None)

                    def client_to_back():
                        try:
                            while True:
                                # read1 drains rfile's buffer before hitting
                                # the socket — bytes the client pipelined
                                # behind the request must not be lost
                                data = self.rfile.read1(65536)
                                if not data:
                                    break
                                back.sendall(data)
                            back.shutdown(socket.SHUT_WR)  # half-close
                        except OSError:
                            pass

                    t = threading.Thread(target=client_to_back, daemon=True)
                    t.start()
                    while True:
                        data = back.recv(65536)
                        if not data:
                            break
                        client.sendall(data)
                except OSError:
                    pass
                finally:
                    try:
                        back.close()
                    except OSError:
                        pass
                    try:
                        # unblocks the pump thread's rfile read
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

            do_GET = do_POST = do_DELETE = do_PUT = do_HEAD = _relay

        _unlink_stale_socket(self.proxy_socket)
        self._server = _UnixHTTPServer(self.proxy_socket, Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class FakeDockerDaemon:
    """Engine-API stub for tests (the docker analog of criserver.py's
    FakeContainerdServer): /containers/create assigns ids and records
    HostConfig, lifecycle posts record state transitions, /containers/
    <id>/json exposes what the daemon believes, /_ping answers OK (the
    passthrough probe)."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self.containers: Dict[str, dict] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self._server: Optional[_UnixHTTPServer] = None

    def start(self) -> None:
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _reply(self, status: int, payload=None):
                body = (json.dumps(payload).encode()
                        if payload is not None else b"")
                self.send_response(status)
                if status == 204:
                    # Go's net/http omits Content-Length on 204 — mirror
                    # it so the proxy's streaming detection is tested
                    # against real-daemon behavior
                    self.end_headers()
                    return
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path.endswith("/_ping"):
                    return self._reply(200, "OK")
                m = re.match(r"^/v[\d.]+/containers/([^/]+)/json$", path)
                if m:
                    with daemon._lock:
                        ctr = daemon.containers.get(m.group(1))
                    if ctr is None:
                        return self._reply(404, {"message": "no such container"})
                    return self._reply(200, ctr)
                return self._reply(404, {"message": "unknown path"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                path = self.path.split("?")[0]
                # attach/exec hijack: answer 101 and become an echo pipe
                # (each chunk comes back prefixed "echo:"), like dockerd's
                # raw-stream hijack — exercises the proxy's upgrade tunnel
                am = re.match(r"^/v[\d.]+/containers/([^/]+)/attach$", path)
                if am and "upgrade" in (
                        self.headers.get("Connection") or "").lower():
                    self.close_connection = True
                    self.wfile.write(
                        b"HTTP/1.1 101 UPGRADED\r\n"
                        b"Content-Type: application/vnd.docker.raw-stream\r\n"
                        b"Connection: Upgrade\r\nUpgrade: tcp\r\n\r\n")
                    self.wfile.flush()
                    while True:
                        try:
                            data = self.rfile.read1(65536)
                        except OSError:
                            break
                        if not data:
                            break
                        self.wfile.write(b"echo:" + data)
                        self.wfile.flush()
                    return
                payload = json.loads(body) if body else {}
                if _CREATE_RE.match(path):
                    with daemon._lock:
                        daemon._seq += 1
                        cid = f"ctr-{daemon._seq}"
                        daemon.containers[cid] = {
                            "Id": cid, "State": {"Status": "created"},
                            "Config": {"Labels": payload.get("Labels") or {}},
                            "HostConfig": payload.get("HostConfig") or {},
                        }
                    return self._reply(201, {"Id": cid})
                m = _LIFECYCLE_RE.match(path)
                if m:
                    cid, op = m.group("id"), m.group("op")
                    with daemon._lock:
                        ctr = daemon.containers.get(cid)
                        if ctr is None:
                            return self._reply(
                                404, {"message": "no such container"})
                        if op == "start":
                            ctr["State"]["Status"] = "running"
                        elif op == "stop":
                            ctr["State"]["Status"] = "exited"
                        elif op == "update":
                            ctr["HostConfig"].update(payload)
                    return self._reply(
                        200 if op == "update" else 204,
                        {"Warnings": []} if op == "update" else None)
                return self._reply(404, {"message": "unknown path"})

        _unlink_stale_socket(self.socket_path)
        self._server = _UnixHTTPServer(self.socket_path, Handler)
        threading.Thread(
            target=self._server.serve_forever, daemon=True).start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
