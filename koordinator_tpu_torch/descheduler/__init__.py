"""koord-descheduler (analog of reference `pkg/descheduler/`). The port
holds only the eviction layer (``evictions.py``) that the scheduler's
preemption and quota revoke reach; the descheduler itself comes with a
later slice."""
