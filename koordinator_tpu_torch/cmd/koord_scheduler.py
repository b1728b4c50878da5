"""koord-scheduler binary: the batched scheduling cycle as a daemon.

Analog of reference cmd/koord-scheduler (main.go registers the plugin set
into the upstream scheduler app; here the cycle driver IS the scheduleOne
loop). Serves the frameworkext debug/services endpoints and the scheduler
metrics registry over HTTP (with /explain, /healthz, the flight recorder
and the device timeline), and gates cycles on leader election when
--leader-elect is set, and can offload the kernel pass to a scheduling
sidecar (--sidecar-address, a koord_sidecar's address) with in-process
degradation. A copy of the JAX package's binary: the cycle runs on the
card (--device cpu runs the plain versions, as the tests do), and so does
the local step a sidecar fallback runs. KOORD_TPU_EXPLAIN, like every
KOORD_TPU_* knob, is read by the Scheduler.

    KOORD_TPU_EXPLAIN=counts python -m koordinator_tpu_torch.cmd.koord_scheduler \
        --synth 5000x10000 --obs-port 9090 --max-ticks 3"""

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
    ap = argparse.ArgumentParser(prog="koord-scheduler")
    add_cluster_flags(ap)
    add_loop_flags(ap, default_interval=1.0)
    add_device_flag(ap)
    ap.add_argument("--leader-elect", action="store_true")
    ap.add_argument("--identity", default="koord-scheduler-0")
    ap.add_argument("--sidecar-address",
                    help="gRPC address of the scheduling sidecar")
    ap.add_argument("--services-port", type=int, default=0,
                    help="serve /apis/v1/... debug endpoints (0 = off)")
    ap.add_argument("--obs-port", type=int, default=0,
                    help="serve /metrics + /traces (0 = off)")
    ap.add_argument("--feature-gates", help="Gate=bool[,Gate=bool...]")
    args = ap.parse_args(argv)

    from koordinator_tpu_torch.client.leaderelection import LeaderElector
    from koordinator_tpu_torch.scheduler.cycle import Scheduler
    from koordinator_tpu_torch.utils.features import SCHEDULER_GATES

    parse_feature_gates(SCHEDULER_GATES, args.feature_gates)
    store = build_store(args)
    elector = (
        LeaderElector(store, "koord-scheduler", args.identity)
        if args.leader_elect else None
    )
    sched = Scheduler(store, elector=elector,
                      sidecar_address=args.sidecar_address,
                      device=args.device)
    server = None
    if args.services_port:
        server, _thread = sched.extender.services.serve(args.services_port)
        print(f"koord-scheduler: services on "
              f"127.0.0.1:{server.server_address[1]}", file=sys.stderr)
    from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics

    obs_server = serve_obs(args.obs_port, scheduler_metrics.REGISTRY,
                           "koord-scheduler", tracer=sched.tracer,
                           health_provider=sched.health_snapshot,
                           explain_provider=sched.explain_record,
                           flight=sched.flight,
                           timeline=sched.timeline)

    def tick():
        result = sched.run_cycle()
        if result.skipped_not_leader:
            return
        print(
            f"koord-scheduler: bound={len(result.bound)} "
            f"failed={len(result.failed)} rejected={len(result.rejected)} "
            f"kernel={result.kernel_seconds * 1000:.1f}ms"
            + (f" sidecar_fallbacks={sched.sidecar_fallbacks}"
               if args.sidecar_address else ""),
            file=sys.stderr,
        )

    run_ticks(tick, args.interval, args.max_ticks, "koord-scheduler")
    if server is not None:
        server.shutdown()
    if obs_server is not None:
        obs_server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
