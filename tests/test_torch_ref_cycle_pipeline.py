"""test_cycle_pipeline.py's cases on the port, with device="cpu" at each
call of Scheduler and run_pipeline_parity."""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module(
    "test_cycle_pipeline",
    on_cpu=("Scheduler", "run_pipeline_parity")), globals())
