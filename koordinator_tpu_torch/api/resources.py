"""Resource model.

The reference represents resources as `corev1.ResourceList` (map[name]Quantity) and
defines koordinator extended resources in `apis/extension/resource.go:26-29`
(kubernetes.io/batch-cpu|batch-memory|mid-cpu|mid-memory) and GPU/device resources in
`apis/extension/device_share.go:38-46` (koordinator.sh/gpu-core, gpu-memory,
gpu-memory-ratio, gpu.shared, rdma, fpga).

TPU-first design: every resource list is packed into a fixed-length float32 vector
over the canonical RESOURCE_AXES below, so pod requests become a [P, R] matrix and
node allocatable a [N, R] matrix, and the whole Filter chain is elementwise compares
with reductions over R. Units are normalized so float32 is exact enough for parity:

  * cpu-like axes  -> milli-cores  (int-valued, < 2^24 for any real node)
  * memory-like    -> MiB          (int-valued for practical quantities)
  * counts/percent -> raw

The host-side object model (`api/objects.py`) keeps exact integers; `ResourceList`
converts at the packing boundary, and BOTH the serial parity emulator and the batched
kernel consume the packed encoding, so binding parity is by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, Mapping, Optional

import numpy as np

from koordinator_tpu_torch.api.priority import PriorityClass

# Canonical string names (values mirror the reference's wire names).
class ResourceName:
    CPU = "cpu"                                  # milli-cores
    MEMORY = "memory"                            # bytes on the wire, MiB packed
    EPHEMERAL_STORAGE = "ephemeral-storage"
    PODS = "pods"
    BATCH_CPU = "kubernetes.io/batch-cpu"        # resource.go:26
    BATCH_MEMORY = "kubernetes.io/batch-memory"  # resource.go:27
    MID_CPU = "kubernetes.io/mid-cpu"            # resource.go:28
    MID_MEMORY = "kubernetes.io/mid-memory"      # resource.go:29
    GPU = "nvidia.com/gpu"
    GPU_CORE = "koordinator.sh/gpu-core"             # device_share.go
    GPU_MEMORY = "koordinator.sh/gpu-memory"
    GPU_MEMORY_RATIO = "koordinator.sh/gpu-memory-ratio"
    GPU_SHARED = "koordinator.sh/gpu.shared"
    RDMA = "koordinator.sh/rdma"
    FPGA = "koordinator.sh/fpga"


# Axis order of the packed [R] vector. Order groups the hot axes (cpu/memory and the
# colocation batch/mid tiers) first so narrow kernels can slice a prefix.
RESOURCE_AXES = (
    ResourceName.CPU,
    ResourceName.MEMORY,
    ResourceName.BATCH_CPU,
    ResourceName.BATCH_MEMORY,
    ResourceName.MID_CPU,
    ResourceName.MID_MEMORY,
    ResourceName.EPHEMERAL_STORAGE,
    ResourceName.PODS,
    ResourceName.GPU,
    ResourceName.GPU_CORE,
    ResourceName.GPU_MEMORY,
    ResourceName.GPU_MEMORY_RATIO,
    ResourceName.RDMA,
    ResourceName.FPGA,
)
RESOURCE_INDEX: Dict[str, int] = {name: i for i, name in enumerate(RESOURCE_AXES)}
NUM_RESOURCES = len(RESOURCE_AXES)
# axes koord-manager computes AFTER applying node reservation — the node
# transformer must not trim them again (pkg/util/node.go)
BATCH_AXES = (RESOURCE_INDEX[ResourceName.BATCH_CPU],
              RESOURCE_INDEX[ResourceName.BATCH_MEMORY])

# Axes whose wire unit is bytes; packed as MiB to stay exact in float32.
_MEMORY_LIKE = frozenset(
    {
        ResourceName.MEMORY,
        ResourceName.BATCH_MEMORY,
        ResourceName.MID_MEMORY,
        ResourceName.EPHEMERAL_STORAGE,
        ResourceName.GPU_MEMORY,
    }
)
MIB = 1024 * 1024

# Packing scale per axis (wire value / scale = packed value).
PACK_SCALE = np.array(
    [MIB if name in _MEMORY_LIKE else 1 for name in RESOURCE_AXES], dtype=np.float64
)


@dataclass
class ResourceList:
    """Exact host-side resource map (wire units: milli-cpu, bytes, counts)."""

    quantities: Dict[str, int] = field(default_factory=dict)

    @staticmethod
    def of(**kwargs: int) -> "ResourceList":
        """Build from python-friendly names: cpu (milli), memory (bytes), etc."""
        alias = {
            "cpu": ResourceName.CPU,
            "memory": ResourceName.MEMORY,
            "batch_cpu": ResourceName.BATCH_CPU,
            "batch_memory": ResourceName.BATCH_MEMORY,
            "mid_cpu": ResourceName.MID_CPU,
            "mid_memory": ResourceName.MID_MEMORY,
            "ephemeral_storage": ResourceName.EPHEMERAL_STORAGE,
            "pods": ResourceName.PODS,
            "gpu": ResourceName.GPU,
            "gpu_core": ResourceName.GPU_CORE,
            "gpu_memory": ResourceName.GPU_MEMORY,
            "gpu_memory_ratio": ResourceName.GPU_MEMORY_RATIO,
            "rdma": ResourceName.RDMA,
            "fpga": ResourceName.FPGA,
        }
        return ResourceList({alias[k]: int(v) for k, v in kwargs.items() if v})

    def get(self, name: str, default: int = 0) -> int:
        return self.quantities.get(name, default)

    def __getitem__(self, name: str) -> int:
        return self.quantities.get(name, 0)

    def __iter__(self) -> Iterator[str]:
        return iter(self.quantities)

    def __bool__(self) -> bool:
        return any(self.quantities.values())

    def add(self, other: "ResourceList") -> "ResourceList":
        out = dict(self.quantities)
        for k, v in other.quantities.items():
            out[k] = out.get(k, 0) + v
        return ResourceList(out)

    def sub(self, other: "ResourceList") -> "ResourceList":
        out = dict(self.quantities)
        for k, v in other.quantities.items():
            out[k] = out.get(k, 0) - v
        return ResourceList(out)

    def max(self, other: "ResourceList") -> "ResourceList":
        out = dict(self.quantities)
        for k, v in other.quantities.items():
            out[k] = max(out.get(k, 0), v)
        return ResourceList(out)

    def copy(self) -> "ResourceList":
        return ResourceList(dict(self.quantities))

    def fill_wire_row(self, out_row: np.ndarray) -> None:
        """Write wire-unit quantities into a preallocated [R] row — the
        allocation-free half of to_vector, shared with the batch packer
        (callers scale by PACK_SCALE once over the whole matrix)."""
        for name, q in self.quantities.items():
            idx = RESOURCE_INDEX.get(name)
            if idx is not None:
                out_row[idx] = q

    def to_vector(self) -> np.ndarray:
        """Pack into the canonical [R] float32 vector (normalized units)."""
        vec = np.zeros(NUM_RESOURCES, dtype=np.float64)
        self.fill_wire_row(vec)
        return (vec / PACK_SCALE).astype(np.float32)

    @staticmethod
    def pack_wire_matrix(resource_lists) -> np.ndarray:
        """Pack many ResourceLists into one [K, R] float32 matrix: a single
        fill + scale instead of K to_vector allocations. Rows are
        bit-identical to to_vector() (same float64 fill, divide, cast)."""
        rls = list(resource_lists)
        mat = np.zeros((len(rls), NUM_RESOURCES), np.float64)
        for j, rl in enumerate(rls):
            rl.fill_wire_row(mat[j])
        return (mat / PACK_SCALE).astype(np.float32)

    @staticmethod
    def from_vector(vec: np.ndarray) -> "ResourceList":
        """Inverse of to_vector (rounds back to wire units)."""
        wire = np.asarray(vec, dtype=np.float64) * PACK_SCALE
        return ResourceList(
            {
                name: int(round(wire[i]))
                for i, name in enumerate(RESOURCE_AXES)
                if wire[i] != 0
            }
        )


_QUANTITY_SUFFIX = {
    "": 1,
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}


def parse_quantity(value, cpu: bool = False) -> int:
    """Parse a k8s resource.Quantity string ("10Gi", "500m", "2k", "1.5") into an
    integer in wire units: milli for cpu=True, raw value otherwise (bytes/counts).
    Accepts ints/floats as-is (already wire units)."""
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip()
    if not s:
        raise ValueError("empty quantity")
    if s.endswith("m"):
        num = float(s[:-1])
        milli = num
        return int(round(milli)) if cpu else int(round(milli / 1000.0))
    suffix = ""
    for suf in sorted(_QUANTITY_SUFFIX, key=len, reverse=True):
        if suf and s.endswith(suf):
            suffix = suf
            break
    num = float(s[: len(s) - len(suffix)] if suffix else s)
    raw = num * _QUANTITY_SUFFIX[suffix]
    return int(round(raw * 1000)) if cpu else int(round(raw))


def translate_resource_by_priority_class(
    priority_class: PriorityClass, resource: str
) -> Optional[str]:
    """cpu/memory -> batch-* or mid-* for BATCH/MID priority pods; PROD/NONE keep
    native names (reference resource.go:40-59)."""
    if priority_class in (PriorityClass.PROD, PriorityClass.NONE):
        return resource
    table: Mapping[PriorityClass, Mapping[str, str]] = {
        PriorityClass.BATCH: {
            ResourceName.CPU: ResourceName.BATCH_CPU,
            ResourceName.MEMORY: ResourceName.BATCH_MEMORY,
        },
        PriorityClass.MID: {
            ResourceName.CPU: ResourceName.MID_CPU,
            ResourceName.MEMORY: ResourceName.MID_MEMORY,
        },
    }
    return table.get(priority_class, {}).get(resource)
