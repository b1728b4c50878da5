"""Multi-device scaling: the node axis sharded over a mesh.

The port's counterpart of the JAX package's parallel/ (a jax.sharding Mesh
and XLA collectives there). Node-state tensors shard over the mesh's
"nodes" axis (the analog of the reference's per-node goroutine fan-out,
SURVEY.md section 5.7), pod batches shard over "pods" for the one-shot
score matrix, and the cross-shard merges are explicit: per pod, the
winners of the shards merge by (score, lowest global index). A mesh is D
virtual shards of one device (the card or the CPU;
KOORD_TORCH_VIRTUAL_DEVICES, parallel/mesh.py) or shards across OS
processes over torch.distributed's gloo backend. On the card, where every
shard shares the one card, the sharded steps gather the node axis and
launch the single-device kernels (kernels 1 and 2 and the stage-count
pass); a mesh whose shards sit on two or more cards, held by one process
or by several, launches the kernels' exchange instances on each card
instead (parallel/mesh.py, parallel/full_chain_mesh.py).
"""

from koordinator_tpu_torch.parallel.mesh import (  # noqa: F401
    build_sharded_schedule_step,
    build_sharded_score_matrix,
    make_mesh,
    merge_readback,
    mesh_from_env,
    mesh_row_layout,
    pad_for_sharding,
    put_on_mesh,
    shard_inputs_2d,
    shard_inputs_nodewise,
    surviving_submesh,
    visible_devices,
)
from koordinator_tpu_torch.parallel.full_chain_mesh import (  # noqa: F401
    build_sharded_chained_wave_step,
    build_sharded_fused_wave_step,
    build_sharded_full_chain_step,
    initial_sharded_wave_carry,
    shard_full_chain_inputs,
    wave_carry_shardings,
    wave_side_shardings,
)
from koordinator_tpu_torch.parallel.rebalance_mesh import (  # noqa: F401
    build_sharded_rebalance_step,
)
from koordinator_tpu_torch.parallel.colo_mesh import (  # noqa: F401
    build_sharded_colo_step,
)
