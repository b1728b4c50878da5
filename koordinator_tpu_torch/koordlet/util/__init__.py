"""koordlet kernel-interface utilities (reference `pkg/koordlet/util/`)."""
