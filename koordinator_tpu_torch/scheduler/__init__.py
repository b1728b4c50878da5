"""Scheduler host side: the cycle driver (cycle.py), the incremental pack
and its device mirror (snapshot.py, snapshot_cache.py), the plugins, the
framework extender, diagnosis, preemption, metrics and the sidecar entry
point."""
