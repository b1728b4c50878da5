"""test_replay_overlap.py's cases on the port.

The dispatch fault the ladder case injects reaches the ladder as
InjectedFault (test_torch_cases.injected).
"""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module("test_replay_overlap", [
    *torch_cases.injected('f"transient device fault'),
    torch_cases.after_import("numpy as np", torch_cases.INJECTED_FAULT),
], on_cpu=("Scheduler", "run_replay_overlap_parity")), globals())
