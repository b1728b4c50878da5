"""test_loadaware_parity.py's cases on the port.

Each step takes the batch as the port's tensors (models/convert.py
schedule_inputs_from_numpy, on the CPU); the serial oracle keeps the
numpy batch.
"""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module("test_loadaware_parity", [
    ("step(inputs)", "step(_on_cpu(inputs))"),
    (")(inputs)", ")(_on_cpu(inputs))"),
    torch_cases.after_import(
        "numpy as np",
        "from koordinator_tpu.models.convert import "
        "schedule_inputs_from_numpy\n\n\n"
        "def _on_cpu(inputs):\n"
        "    return schedule_inputs_from_numpy(inputs._asdict(), 'cpu')\n"),
]), globals())
