"""In-process object store + informer layer (a copy of the JAX package's
``client/store.py``): typed collections with resourceVersion bumping and
subscriber callbacks, the cluster the scheduler cycle reads and patches.
Leader election comes with a later slice."""

from koordinator_tpu_torch.client.store import ObjectStore, EventType, Informer  # noqa: F401
