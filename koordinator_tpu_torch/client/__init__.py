"""In-process object store + informer layer (a copy of the JAX package's
``client/``): typed collections with resourceVersion bumping and
subscriber callbacks, the cluster the scheduler cycle reads and patches,
and the leader election of the control-plane binaries."""

from koordinator_tpu_torch.client.store import ObjectStore, EventType, Informer  # noqa: F401
from koordinator_tpu_torch.client.leaderelection import (  # noqa: F401
    ElectedRunner,
    LeaderElector,
    Lease,
)
