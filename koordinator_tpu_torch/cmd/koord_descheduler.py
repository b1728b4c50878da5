"""koord-descheduler binary: profile runner loop.

Analog of reference cmd/koord-descheduler: periodic Deschedule/Balance
profile execution with leader-election gating and the migration
controller's arbitration. A copy of the JAX package's binary: the
LowNodeLoad rebalance pass runs on the card (--device cpu runs its plain
version, as the tests do).

    python -m koordinator_tpu_torch.cmd.koord_descheduler \
        --synth 5000x10000 --max-ticks 3 --interval 5"""

from __future__ import annotations

import argparse
import sys

from koordinator_tpu_torch.cmd import (
    add_cluster_flags,
    add_device_flag,
    add_loop_flags,
    build_store,
    run_ticks,
    serve_obs,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="koord-descheduler")
    add_cluster_flags(ap)
    add_loop_flags(ap, default_interval=60.0)
    add_device_flag(ap)
    ap.add_argument("--leader-elect", action="store_true")
    ap.add_argument("--identity", default="koord-descheduler-0")
    ap.add_argument("--obs-port", type=int, default=0,
                    help="serve /metrics (0 = off)")
    args = ap.parse_args(argv)

    from koordinator_tpu_torch.client.leaderelection import LeaderElector
    from koordinator_tpu_torch.descheduler import Descheduler

    store = build_store(args)
    elector = (
        LeaderElector(store, "koord-descheduler", args.identity)
        if args.leader_elect else None
    )
    desched = Descheduler(store, elector=elector, device=args.device)
    from koordinator_tpu_torch.descheduler import metrics as descheduler_metrics

    obs_server = serve_obs(
        args.obs_port, descheduler_metrics.REGISTRY, "koord-descheduler",
        # koordwatch: the rebalance pass's device-window ring (private
        # when the descheduler runs without a co-located scheduler)
        timeline=(desched.rebalancer.timeline
                  if desched.rebalancer is not None else None))

    def tick():
        summary = desched.run_once()
        print(f"koord-descheduler: {summary}", file=sys.stderr)

    run_ticks(tick, args.interval, args.max_ticks, "koord-descheduler")
    if obs_server is not None:
        obs_server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
