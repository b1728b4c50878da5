"""test_quota_gang.py's cases on the port.

The arrays the cases build with jax.numpy reach the port's ops as the
port's tensors on the CPU (test_torch_cases.PortNumpy).
"""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module(
    "test_quota_gang", [torch_cases.JNP], on_cpu=('Scheduler',)), globals())
