"""test_koordguard.py's cases on the port; mesh cases run on the host
split into 8 virtual shard devices (test_torch_cases.cpu_devices). The
device loss the partial-mesh case injects reaches the ladder as
InjectedFault (test_torch_cases.injected), with its failed_device_ids
attached as the case attaches them."""

from __future__ import annotations

import test_torch_cases as torch_cases

cpu_devices = torch_cases.cpu_devices

torch_cases.export(torch_cases.port_module("test_koordguard", [
    *torch_cases.injected('f"ICI link down'),
    torch_cases.after_import("time", torch_cases.INJECTED_FAULT),
], on_cpu=("Scheduler",)), globals())
