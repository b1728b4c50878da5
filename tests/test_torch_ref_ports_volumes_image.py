"""test_ports_volumes_image.py's cases on the port.

Each round takes the batch as the port's tensors (models/convert.py
to_device, on the CPU); the oracle and the native floor keep the numpy
batch. build_pallas_full_chain_step maps to the port's device-aware
selector (test_torch_cases.PALLAS_FULL_CHAIN).

Left out:
  * test_pallas_volume_less_variant_parity: the Pallas kernel's
    compiled-out volume variant (enable_volumes=False) has no
    counterpart; the CUDA kernel has one build for every batch, held
    against the plain round on volume-less batches by chip_smoke.py's
    kernel check and tests/test_torch_full_chain.py::
    test_port_matches_pallas_interpret.
"""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module("test_ports_volumes_image", [
    *torch_cases.PALLAS_FULL_CHAIN, *torch_cases.NATIVE_FLOOR,
    (")(fc)[0]", ")(to_device(fc, 'cpu'))[0]"),
    torch_cases.after_import("numpy as np", torch_cases.TO_DEVICE),
], on_cpu=("Scheduler",)), globals(),
    leave_out=("test_pallas_volume_less_variant_parity",))
