"""Data-model layer: the analog of the reference's `apis/` tree.

Everything the control plane communicates through — QoS classes, priority bands,
extended resources, well-known labels/annotations, and the CRD object model — lives
here, so that the rest of the framework (kernels included) depends only on this spec.
"""

from koordinator_tpu_torch.api.qos import QoSClass, qos_class_by_name  # noqa: F401
from koordinator_tpu_torch.api.priority import (  # noqa: F401
    PriorityClass,
    priority_class_by_value,
    priority_class_by_name,
    DEFAULT_PRIORITY_BY_CLASS,
)
from koordinator_tpu_torch.api.resources import (  # noqa: F401
    ResourceName,
    RESOURCE_AXES,
    RESOURCE_INDEX,
    NUM_RESOURCES,
    ResourceList,
    translate_resource_by_priority_class,
)
from koordinator_tpu_torch.api.objects import (  # noqa: F401
    ObjectMeta,
    PodSpec,
    Pod,
    Node,
    NodeMetric,
    NodeMetricInfo,
    PodMetricInfo,
    Reservation,
    PodGroup,
    ElasticQuota,
    Device,
    DeviceInfo,
    NodeSLO,
    NodeResourceTopology,
    PodMigrationJob,
    ClusterColocationProfile,
)
