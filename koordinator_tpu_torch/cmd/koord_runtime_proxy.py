"""koord-runtime-proxy binary: CRI or docker interception.

Analog of reference cmd/koord-runtime-proxy main.go:57-67 (the mode
switch): --mode cri serves a gRPC CRI proxy between kubelet and the
containerd socket; --mode docker serves the Engine-API reverse proxy.
Hooks dial the koordlet hook server over its unix socket; FailurePolicy
governs hook-server outages."""

from __future__ import annotations

import argparse
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="koord-runtime-proxy")
    ap.add_argument("--mode", choices=["cri", "docker"], default="cri")
    ap.add_argument("--proxy-endpoint",
                    default="/var/run/koord-runtimeproxy.sock")
    ap.add_argument("--backend-endpoint", default=None,
                    help="runtime socket (default: containerd's for "
                    "--mode cri, docker's for --mode docker)")
    ap.add_argument("--hook-server-endpoint",
                    help="koordlet hook server unix socket")
    ap.add_argument("--failure-policy", choices=["Ignore", "Fail"],
                    default="Ignore")
    args = ap.parse_args(argv)
    if args.backend_endpoint is None:
        args.backend_endpoint = (
            "/var/run/docker.sock" if args.mode == "docker"
            else "/var/run/containerd/containerd.sock")

    from koordinator_tpu_torch.runtimeproxy.hookclient import HookClient
    from koordinator_tpu_torch.runtimeproxy.server import FailurePolicy

    policy = (FailurePolicy.FAIL if args.failure_policy == "Fail"
              else FailurePolicy.IGNORE)
    hook = (HookClient(args.hook_server_endpoint)
            if args.hook_server_endpoint else None)
    if args.mode == "cri":
        from koordinator_tpu_torch.runtimeproxy.criserver import CRIProxyServer

        server = CRIProxyServer(args.proxy_endpoint, args.backend_endpoint,
                                hook_client=hook, failure_policy=policy)
        server.start()  # start() replays failover() itself
    else:
        from koordinator_tpu_torch.runtimeproxy.dockerserver import (
            DockerProxyServer,
        )

        server = DockerProxyServer(args.proxy_endpoint,
                                   args.backend_endpoint,
                                   hook_client=hook, failure_policy=policy)
        server.start()
    print(f"koord-runtime-proxy: mode={args.mode} "
          f"proxy={args.proxy_endpoint} backend={args.backend_endpoint}",
          file=sys.stderr)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
