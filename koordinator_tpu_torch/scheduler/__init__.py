"""Scheduler host side: snapshot pack, metrics, sidecar entry point."""
