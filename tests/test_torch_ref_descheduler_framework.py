"""test_descheduler_framework.py's cases on the port."""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module("test_descheduler_framework"),
                   globals())
