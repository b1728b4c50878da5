"""test_election_wiring.py's cases on the port, with device="cpu" at each
call of Scheduler, Manager and Descheduler."""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module(
    "test_election_wiring",
    on_cpu=("Scheduler", "Manager", "Descheduler")), globals())
