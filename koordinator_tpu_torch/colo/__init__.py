"""koordcolo: the control plane's resource model on the card.

The third consumer of the scheduler's DeviceSnapshot (after the dispatch
kernels and the descheduler's rebalance pass): the slo-controller's
batch/mid overcommit pipeline and the quota-controller's elastic-quota
runtime fairness run as one tensor pass over packed state the
SnapshotCache's existing store subscriptions maintain, host-oracle
parity-gated by ``pipeline_parity.run_colo_parity``.
"""

from koordinator_tpu_torch.colo.pack import ColoPack  # noqa: F401
from koordinator_tpu_torch.colo.reconciler import (  # noqa: F401
    COLO_NODE_FIELDS,
    DeviceColoReconciler,
    colo_from_env,
)
from koordinator_tpu_torch.colo.step import ColoOut, build_colo_step  # noqa: F401
