"""Worker process of the multi-process mesh tests (2 and 4 processes).

The port's counterpart of the JAX package's tests/multihost_worker.py.
Each process holds ``local_devices`` virtual CPU shard devices
(KOORD_TORCH_VIRTUAL_DEVICES); torch.distributed's gloo backend federates
them into one mesh (parallel/mesh.py), the process boundary standing in
for the host boundary. Every process builds the identical synthetic
cluster, runs the sharded full-chain step over the GLOBAL mesh (the
per-pod reductions and winner merges are gloo all-reduces across the
processes) and diffs the bindings and the quota rollup against a local
single-device run. A second pass runs a padded 500 x 250 batch (512 x 256
after the bucket pad) through the active-axis reduction; a third the
one-shot [P, N] score matrix over both mesh axes, its shards gathered and
held against the local single-device matrix. Prints ``MULTIHOST_OK
<digest> mesh=<shape>`` so the parent test can assert that every process
agrees.

Usage: python -m koordinator_tpu_torch.testing.multihost_worker
       <process_id> <num_processes> <port> [local_devices=4]
"""

from __future__ import annotations

import hashlib
import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    proc_id, num_procs, port = int(argv[0]), int(argv[1]), argv[2]
    local_devices = int(argv[3]) if len(argv) > 3 else 4
    os.environ["KOORD_TORCH_VIRTUAL_DEVICES"] = str(local_devices)

    import numpy as np
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=num_procs, rank=proc_id)
    try:
        from koordinator_tpu_torch.models.convert import to_device
        from koordinator_tpu_torch.models.full_chain import (
            build_full_chain_step,
        )
        from koordinator_tpu_torch.models.scheduler_model import (
            build_score_matrix,
        )
        from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
        from koordinator_tpu_torch.parallel import (
            build_sharded_full_chain_step,
            build_sharded_score_matrix,
            make_mesh,
            shard_full_chain_inputs,
            shard_inputs_2d,
            visible_devices,
        )
        from koordinator_tpu_torch.scheduler.snapshot import (
            build_full_chain_inputs,
            reduce_to_active_axes,
        )
        from koordinator_tpu_torch.testing import synth_full_cluster

        devices = visible_devices("cpu")
        assert len(devices) == local_devices * num_procs, devices
        mesh = make_mesh(devices)
        assert mesh.spans_processes or num_procs == 1
        args = LoadAwareArgs()

        # pass 1: the mixed fixture on the global mesh
        _, state = synth_full_cluster(30, 60, seed=0)
        fc, pods, _n, _t, _g, ng, ngroups = build_full_chain_inputs(
            state, args)
        chosen_1, _r1, quota_1 = build_full_chain_step(args, ng, ngroups)(
            to_device(fc, "cpu"))
        step = build_sharded_full_chain_step(args, ng, ngroups, mesh)
        chosen_g, _rg, quota_g = step(shard_full_chain_inputs(fc, mesh))
        chosen_g = np.asarray(chosen_g)  # replicated: this process's copy
        np.testing.assert_array_equal(chosen_1.numpy(), chosen_g)
        np.testing.assert_array_equal(quota_1.numpy(), np.asarray(quota_g))
        assert (chosen_g[: len(pods.keys)] >= 0).sum() > 0, "vacuous"

        # pass 2: a bucket-padded batch whose pad rows cross shard (and
        # process) boundaries, through the active-axis reduction
        _, big_state = synth_full_cluster(250, 500, seed=1)
        big_fc, big_pods, _n, _t, _g, bng, bngroups = (
            build_full_chain_inputs(big_state, args))
        big_fc, big_axes = reduce_to_active_axes(big_fc)
        assert big_fc.base.fit_requests.shape[0] > len(big_pods.keys)
        big_ref, _r, big_quota_ref = build_full_chain_step(
            args, bng, bngroups, active_axes=big_axes)(
                to_device(big_fc, "cpu"))
        big_step = build_sharded_full_chain_step(
            args, bng, bngroups, mesh, active_axes=big_axes)
        big_g, _r, big_quota_g = big_step(
            shard_full_chain_inputs(big_fc, mesh))
        big_g = np.asarray(big_g)
        np.testing.assert_array_equal(big_ref.numpy(), big_g)
        np.testing.assert_array_equal(big_quota_ref.numpy(),
                                      np.asarray(big_quota_g))
        assert (big_g[: len(big_pods.keys)] >= 0).sum() > 100

        # pass 3: the score matrix over both mesh axes; every process
        # gathers every shard's block and assembles the whole matrix
        feas_g, score_g = build_sharded_score_matrix(args, mesh)(
            shard_inputs_2d(big_fc.base, mesh))
        blocks = [(feas_g.index(k), feas_g.shards[k].numpy(),
                   score_g.shards[k].numpy())
                  for k in range(mesh.size) if feas_g.shards[k] is not None]
        gathered = [None] * num_procs
        dist.all_gather_object(gathered, blocks)
        feas = np.zeros(tuple(feas_g.shape), bool)
        score = np.zeros(tuple(score_g.shape), np.float32)
        for part in gathered:
            for idx, f, s in part:
                feas[idx] = f
                score[idx] = s
        feas_1, score_1 = build_score_matrix(args)(
            to_device(big_fc, "cpu").base)
        n_p, n_n = feas_1.shape
        np.testing.assert_array_equal(feas_1.numpy(), feas[:n_p, :n_n])
        np.testing.assert_array_equal(score_1.numpy(), score[:n_p, :n_n])

        digest = hashlib.sha256(
            chosen_g.tobytes() + big_g.tobytes() + feas.tobytes()
            + score.tobytes()).hexdigest()[:16]
        print(f"MULTIHOST_OK {digest} mesh={mesh.shape}", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
