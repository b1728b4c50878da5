"""Scheduling sidecar binary: serve ScheduleBatch next to the card.

The rebuild-specific sixth binary (SURVEY.md 5.8): a gRPC server around
the full-chain round (kernel 1 on the card; --device cpu runs the plain
round, as the tests do), consumed by the cycle driver
(koord_scheduler --sidecar-address), by the reference's Go event loop, or
by the C++ client (native/sidecar_client.cpp). Steps cache per shape.
A copy of the JAX package's binary, with --device.

    python -m koordinator_tpu_torch.cmd.koord_sidecar \\
        --listen unix:///tmp/koord-sidecar.sock --device cuda"""

from __future__ import annotations

import argparse
import sys
import threading

from koordinator_tpu_torch.cmd import add_device_flag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="koord-sidecar")
    ap.add_argument("--listen", default="unix:///tmp/koord-sidecar.sock",
                    help="gRPC bind address (unix:///path or host:port)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from koordinator_tpu_torch.scheduler.sidecar import serve_sidecar

    server = serve_sidecar(args.listen, device=args.device)
    print(f"koord-sidecar: serving ScheduleBatch on {args.listen} "
          f"({args.device})", file=sys.stderr)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    server.stop(0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
