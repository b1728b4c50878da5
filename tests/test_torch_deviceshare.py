"""DeviceShare on the port (scheduler/plugins/deviceshare.py) against the
JAX package's.

The cases of test_deviceshare.py run on the port under their reference
names (tests/test_torch_cases.py).
"""

from __future__ import annotations

import json

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module("test_deviceshare"), globals())


# ---------------------------------------------------------------------------
# a GPU pool through both packages: koordlet -> Device CR -> manager ->
# DeviceShare on the round's GPU axes
# ---------------------------------------------------------------------------

NODES, PODS, POOL, GPU_PODS, SEED = 200, 400, 8, 24, 7
H100_BYTES = 85_899_345_920  # torch.cuda total_memory of an H100 80GB HBM3


def _world(side, synth, objects_store, device_info, resource_list, manager,
           scheduler):
    """One package's run: its synth world, POOL koordlet Daemons publishing
    an injected H100, a manager tick (GPUDeviceResource), GPU_PODS
    GPU-share pods, one scheduling cycle. Returns the GPU dump, the
    world's cycle dump, and the active axes of the round."""
    from koordinator_tpu_torch.testing import gpu_pool
    from koordinator_tpu_torch.testing.churn import (
        cycle_dump,
        store_from_state,
    )

    _cluster, state = synth(NODES, PODS, seed=SEED,
                            num_quotas=max(8, PODS // 100),
                            num_gangs=max(4, PODS // 50))
    store = store_from_state(state, objects_store())
    names = gpu_pool.pool_nodes(store, POOL, side)

    def collector():
        return [device_info(
            type="gpu", uuid="GPU-5c1e0d2a-0000-4000-8000-000000000000",
            minor=0, health=True, numa_node=0,
            resources=resource_list.of(gpu_core=100, gpu_memory=H100_BYTES,
                                       gpu_memory_ratio=100))]

    agents = gpu_pool.start_pool_agents(store, names, state.now,
                                        device_collector=collector,
                                        side=side)
    try:
        mgr = manager(store)
        mgr.tick(now=state.now + 11)
        # the admission webhook refuses the synth world's LSR/koord-batch
        # pods at bind time, in both packages: stop the replica
        mgr.stop(now=state.now + 11)
        gpu_pool.add_gpu_share_pods(store, gpu_pool.gpu_share_specs(GPU_PODS),
                                    state.now + 12, side=side)
        sched = scheduler(store)
        result = sched.run_cycle(now=state.now + 15)
        return (gpu_pool.gpu_dump(store, side), cycle_dump(sched),
                [b.pod_key for b in result.bound], names)
    finally:
        gpu_pool.cleanup(agents)


def test_gpu_pool_world_matches_reference():
    """The same world through the JAX Scheduler + Manager + Daemon and the
    port's: bindings, allocation annotations, node GPU totals, Device CRs
    and PodScheduled messages identical."""
    from koordinator_tpu.api import objects as ref_objects
    from koordinator_tpu.api import resources as ref_resources
    from koordinator_tpu.client import store as ref_store
    from koordinator_tpu.cmd import koordlet as ref_koordlet_cmd
    from koordinator_tpu.koordlet import daemon as ref_daemon
    from koordinator_tpu.koordlet.util import system as ref_system
    from koordinator_tpu.manager import Manager as RefManager
    from koordinator_tpu.scheduler.cycle import Scheduler as RefScheduler
    from koordinator_tpu.testing import synth_full_cluster as ref_synth

    from koordinator_tpu_torch.api.objects import DeviceInfo
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import ObjectStore
    from koordinator_tpu_torch.manager import Manager
    from koordinator_tpu_torch.scheduler.cycle import Scheduler
    from koordinator_tpu_torch.testing import gpu_pool, synth_full_cluster

    ref = _world(
        gpu_pool.NodeSide(ref_objects, ref_resources, ref_store, ref_daemon,
                          ref_system, ref_koordlet_cmd),
        ref_synth, ref_store.ObjectStore, ref_objects.DeviceInfo,
        ref_resources.ResourceList, RefManager,
        lambda s: RefScheduler(s, waves=1, explain="off", mesh="off",
                               warmup="off"))
    port = _world(
        gpu_pool.port_node_side(), synth_full_cluster, ObjectStore,
        DeviceInfo, ResourceList, lambda s: Manager(s, device="cpu"),
        lambda s: Scheduler(s, waves=1, device="cpu"))
    gpu, world, bound, pool = port
    assert gpu == ref[0]
    assert world == ref[1]
    assert bound == ref[2]
    # the world exercises the pool: its Device CRs and totals, some GPU
    # pods bound (each on a pool node, within a card), some refused
    assert sorted(gpu["devices"]) == sorted(pool)
    assert sorted(gpu["nodes"]) == sorted(pool)
    placed = {k: v for k, v in gpu["pods"].items() if v[0]}
    assert 0 < len(placed) < GPU_PODS
    per_node = {}
    for node, raw, _cond in placed.values():
        assert node in pool
        (alloc,) = json.loads(raw)["gpu"]
        assert alloc["minor"] == 0
        per_node[node] = per_node.get(node, 0) + alloc["core"]
    assert max(per_node.values()) <= 100
