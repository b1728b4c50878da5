"""koord-manager binary: slo-controllers + quota profiles + webhooks.

Analog of reference cmd/koord-manager: all controllers behind ONE leader
election; the admission webhook serves on every replica (store-level
interceptor here, the apiserver-webhook analog). A copy of the JAX
package's binary: the colo pass runs on the card (--device cpu runs its
plain version, as the tests do).

    python -m koordinator_tpu_torch.cmd.koord_manager \
        --synth 5000x10000 --max-ticks 3 --interval 5"""

from __future__ import annotations

import argparse
import sys

from koordinator_tpu_torch.cmd import (
    add_cluster_flags,
    add_device_flag,
    add_loop_flags,
    build_store,
    parse_feature_gates,
    run_ticks,
    serve_obs,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="koord-manager")
    add_cluster_flags(ap)
    add_loop_flags(ap, default_interval=15.0)
    add_device_flag(ap)
    ap.add_argument("--identity", default="koord-manager-0")
    ap.add_argument("--feature-gates", help="Gate=bool[,Gate=bool...]")
    ap.add_argument("--obs-port", type=int, default=0,
                    help="serve /metrics + /traces + /healthz (0 = off)")
    args = ap.parse_args(argv)

    from koordinator_tpu_torch import manager_metrics
    from koordinator_tpu_torch.manager import Manager
    from koordinator_tpu_torch.utils.features import MANAGER_GATES

    parse_feature_gates(MANAGER_GATES, args.feature_gates)
    store = build_store(args)
    mgr = Manager(store, identity=args.identity, device=args.device)
    # /healthz carries the colo ladder snapshot under "degraded" and
    # /debug/flightrecorder serves the colo flight ring (dumps on colo
    # parity mismatch / dispatch-deadline overrun)
    obs_server = serve_obs(
        args.obs_port, manager_metrics.REGISTRY, "koord-manager",
        tracer=mgr.tracer,
        health_provider=mgr.health_snapshot,
        flight=(mgr.colo.flight if mgr.colo is not None else None),
        # koordwatch: the colo pass's device-window ring
        timeline=(mgr.colo.timeline if mgr.colo is not None else None))

    def tick():
        leading = mgr.tick()
        if leading:
            print(
                f"koord-manager: round={mgr.reconcile_rounds} "
                f"changes={mgr.last_changes}", file=sys.stderr)

    run_ticks(tick, args.interval, args.max_ticks, "koord-manager")
    if obs_server is not None:
        obs_server.shutdown()
    mgr.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
