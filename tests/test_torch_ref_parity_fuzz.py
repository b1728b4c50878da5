"""test_parity_fuzz.py's cases on the port.

Each round takes the batch as the port's tensors (models/convert.py
to_device, on the CPU); the oracle and the native floor keep the numpy
batch. build_pallas_full_chain_step maps to the port's device-aware
selector (test_torch_cases.PALLAS_FULL_CHAIN).

Left out:
  * test_fuzz_pallas_interpret_agrees: an XLA-vs-Pallas pair; the port's
    plain round against the Pallas kernel in interpret mode on the same
    fixture (seed 707) is tests/test_torch_full_chain.py::
    test_port_matches_pallas_interpret[mixed707].
"""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module("test_parity_fuzz", [
    *torch_cases.PALLAS_FULL_CHAIN, *torch_cases.NATIVE_FLOOR,
    (")(fc)[0]", ")(to_device(fc, 'cpu'))[0]"),
    torch_cases.after_import("numpy as np", torch_cases.TO_DEVICE),
]), globals(), leave_out=("test_fuzz_pallas_interpret_agrees",))
