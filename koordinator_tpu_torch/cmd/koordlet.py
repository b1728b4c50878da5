"""koordlet binary: the node agent daemon.

Analog of reference cmd/koordlet: metrics collection, QoS enforcement,
runtime hooks, audit — all module loops behind Daemon.run. On a real node
(root, cgroupfs) run with --node NAME; for a demo/CI machine --fake-node
builds the hermetic /sys + /proc + cgroup tree (the FileTestUtil analog)
and seeds a minimal busy node so every collector has something to read."""

from __future__ import annotations

import argparse
import sys

from koordinator_tpu_torch.cmd import (
    add_cluster_flags,
    add_loop_flags,
    build_store,
    parse_feature_gates,
)


def _seed_fake_node(fs, store, node_name: str, cores: int = 16) -> None:
    from koordinator_tpu_torch.api.objects import Node, ObjectMeta
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import KIND_NODE
    from koordinator_tpu_torch.koordlet.util import system as sysutil

    GIB = 1024**3
    if store.get(KIND_NODE, f"/{node_name}") is None:
        store.add(KIND_NODE, Node(
            meta=ObjectMeta(name=node_name, namespace=""),
            allocatable=ResourceList.of(cpu=cores * 1000, memory=64 * GIB,
                                        pods=110)))
    fs.set_proc("stat", "cpu  1000 0 1000 8000 0 0 0 0 0 0\n")
    fs.set_proc(
        "meminfo",
        "MemTotal: %d kB\nMemFree: %d kB\nMemAvailable: %d kB\n"
        % (64 * GIB // 1024, 32 * GIB // 1024, 48 * GIB // 1024))
    fs.set_cgroup("", sysutil.CPU_PRESSURE,
                  "some avg10=0.10 avg60=0.10 avg300=0.10 total=100\n"
                  "full avg10=0.00 avg60=0.00 avg300=0.00 total=0\n")
    fs.set_cgroup("", sysutil.MEMORY_PRESSURE,
                  "some avg10=0.00 avg60=0.00 avg300=0.00 total=0\n"
                  "full avg10=0.00 avg60=0.00 avg300=0.00 total=0\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="koordlet")
    add_cluster_flags(ap)
    add_loop_flags(ap, default_interval=10.0)
    ap.add_argument("--node", default="node-0", help="this node's name")
    ap.add_argument("--fake-node", action="store_true",
                    help="hermetic fake /sys+/proc+cgroup tree (demo/CI)")
    ap.add_argument("--checkpoint-dir",
                    help="prediction/metriccache checkpoint directory")
    ap.add_argument("--feature-gates", help="Gate=bool[,Gate=bool...]")
    args = ap.parse_args(argv)

    from koordinator_tpu_torch.koordlet.daemon import Daemon
    from koordinator_tpu_torch.utils.features import KOORDLET_GATES

    parse_feature_gates(KOORDLET_GATES, args.feature_gates)
    store = build_store(args)
    fs = None
    config = None
    if args.fake_node:
        from koordinator_tpu_torch.koordlet.util.system import FakeFS

        fs = FakeFS(use_cgroup_v2=True)
        _seed_fake_node(fs, store, args.node)
        config = fs.config
    daemon = Daemon(store, args.node, config,
                    checkpoint_dir=args.checkpoint_dir,
                    autodetect_cgroups=not args.fake_node)
    print(f"koordlet: node={args.node} fake={bool(fs)}", file=sys.stderr)
    try:
        daemon.run(interval_seconds=args.interval,
                   max_ticks=args.max_ticks or None)
    except KeyboardInterrupt:
        pass
    finally:
        if fs is not None:
            fs.cleanup()
    from koordinator_tpu_torch.client.store import KIND_DEVICE

    cr = store.get(KIND_DEVICE, f"/{args.node}")
    if cr is not None:
        # the devices this node published (its statesinformer's probe)
        print("koordlet: Device CR " + " ".join(
            f"{d.type}/{d.minor}/{d.uuid}" for d in cr.devices),
            file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
