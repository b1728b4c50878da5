"""test_full_chain_parity.py's cases on the port.

Each round takes the batch as the port's tensors (models/convert.py
to_device, on the CPU); the oracle and the native floor keep the numpy
batch.
"""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module("test_full_chain_parity", [
    *torch_cases.NATIVE_FLOOR,
    ("step(fc)", "step(to_device(fc, 'cpu'))"),
    (")(fc)[0]", ")(to_device(fc, 'cpu'))[0]"),
    (")(fc_red)[0]", ")(to_device(fc_red, 'cpu'))[0]"),
    torch_cases.after_import("numpy as np", torch_cases.TO_DEVICE),
]), globals())
