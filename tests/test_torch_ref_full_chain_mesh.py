"""test_full_chain_mesh.py's cases on the port, on the host split into 8
virtual shard devices (test_torch_cases.cpu_devices).

The single-device round takes the batch as the port's tensors
(models/convert.py to_device, on the CPU); the sharded step takes the
numpy batch through the port's shard_full_chain_inputs, as the
reference's takes its own.
"""

from __future__ import annotations

import test_torch_cases as torch_cases

cpu_devices = torch_cases.cpu_devices

torch_cases.export(torch_cases.port_module("test_full_chain_mesh", [
    (")(fc)", ")(to_device(fc, 'cpu'))"),
    torch_cases.after_import("numpy as np", torch_cases.TO_DEVICE),
]), globals())
