"""SLO controllers (analog of reference `pkg/slo-controller/`, SURVEY.md 2.4):
nodemetric (CR lifecycle + collect policy), noderesource (THE colocation
resource pipeline — batch/mid allocatable, vectorized over all nodes in one JAX
pass), nodeslo (per-node strategy rendering from the cluster config)."""

from koordinator_tpu_torch.slocontroller.nodemetric import NodeMetricController  # noqa: F401
from koordinator_tpu_torch.slocontroller.noderesource import NodeResourceController  # noqa: F401
from koordinator_tpu_torch.slocontroller.nodeslo import NodeSLOController  # noqa: F401
