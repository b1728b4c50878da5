"""koordbalance in the port: the descheduler's rebalance pass on the card.

The descheduler's LowNodeLoad pass as a batched node x pod tensor pass
sharing the scheduler's device mirror — one upload, two consumers:

  * :mod:`koordinator_tpu_torch.balance.pack` — ``RebalancePack``, the
    event-maintained packed arrays (the JAX package's, copied whole).
    When a scheduler shares the process its ``SnapshotCache`` forwards
    its store events into the pack, so the cluster is encoded once for
    both consumers.
  * :mod:`koordinator_tpu_torch.balance.step` — ``build_rebalance_step``,
    the tensor pass: node classification, per-node overload margins and
    the victim selection, with compacted (node_idx, pod_idx, score)
    outputs; bit for bit the JAX package's step.
  * :mod:`koordinator_tpu_torch.balance.rebalancer` — ``DeviceRebalancer``,
    the rebalancer: pad-bucketed upload through the (shared)
    ``DeviceSnapshot``, the ``rebalance`` span tree, rebalance metrics,
    and the degradation ladder (device pass -> host ``LowNodeLoad``
    oracle on device faults).

``KOORD_TPU_REBALANCE=on|off|host`` selects the engine (see
``rebalance_from_env``); decision parity against the host oracle is
gated by ``pipeline_parity.run_rebalance_parity``.
"""

from koordinator_tpu_torch.balance.pack import (  # noqa: F401
    RebalancePack,
    has_pdb_like_guard,
)
from koordinator_tpu_torch.balance.rebalancer import (  # noqa: F401
    DeviceRebalancer,
    rebalance_from_env,
)
from koordinator_tpu_torch.balance.step import (  # noqa: F401
    RebalanceOut,
    build_rebalance_step,
)

__all__ = [
    "RebalancePack",
    "DeviceRebalancer",
    "RebalanceOut",
    "build_rebalance_step",
    "has_pdb_like_guard",
    "rebalance_from_env",
]
