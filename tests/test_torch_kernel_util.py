"""The port's koordlet kernel interface layer (koordlet/util/: resctrl,
core-sched, kidled, machine-info discovery, cgroup drivers) against the
JAX package's.

The cases of test_kernel_util.py run on the port under their reference
names (tests/test_torch_cases.py), unedited. They live in a module of
their own because their `fs` fixture is a cgroup-v1 FakeFS, where the
other koordlet modules' (test_torch_koordlet.py) is cgroup v2.
"""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module("test_kernel_util"), globals())
