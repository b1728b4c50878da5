"""test_flight_triggers.py's cases on the port.

Mesh cases run on the host split into 8 virtual shard devices
(test_torch_cases.cpu_devices); the dispatch faults the cases inject
reach the ladder as InjectedFault (test_torch_cases.injected).
"""

from __future__ import annotations

import test_torch_cases as torch_cases

cpu_devices = torch_cases.cpu_devices

torch_cases.export(torch_cases.port_module("test_flight_triggers", [
    *torch_cases.injected('f"device dead', '"transient mesh fault"'),
    torch_cases.after_import("pytest", torch_cases.INJECTED_FAULT),
], on_cpu=("Scheduler",)), globals())
