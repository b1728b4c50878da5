"""test_noderesource_plugins.py's cases on the port, with device="cpu" at each
call of Manager."""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module(
    "test_noderesource_plugins",
    on_cpu=("Manager",)), globals())
