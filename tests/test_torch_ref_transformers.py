"""test_transformers.py's cases on the port, with device="cpu" at each call of
Scheduler."""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module(
    "test_transformers",
    on_cpu=("Scheduler",)), globals())
