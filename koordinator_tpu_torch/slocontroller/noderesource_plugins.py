"""NodeResource controller plugins beyond batch/mid: cpu normalization,
GPU device resources, resource amplification.

Analog of `pkg/slo-controller/noderesource/plugins/{cpunormalization,
gpudeviceresource, resourceamplification}` (plugin.go in each): each plugin
Calculates resource items / metadata for a node and Prepares them onto the
node object; the controller applies the chain per node after the vectorized
batch/mid pass. Plugin order matters: ResourceAmplification derives its
ratio from the annotation CPUNormalization prepared in the same round
(resourceamplification/plugin.go:82-111).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.objects import Device, Node, NodeResourceTopology
from koordinator_tpu_torch.api.resources import ResourceList, ResourceName
from koordinator_tpu_torch.client.store import (
    KIND_DEVICE,
    KIND_NODE_TOPOLOGY,
    ObjectStore,
)

ANNOTATION_CPU_NORMALIZATION_RATIO = "node.koordinator.sh/cpu-normalization-ratio"
ANNOTATION_CPU_BASIC_INFO = "node.koordinator.sh/cpu-basic-info"
ANNOTATION_AMPLIFICATION_RATIO = "node.koordinator.sh/resource-amplification-ratio"
LABEL_CPU_NORMALIZATION_ENABLED = "node.koordinator.sh/cpu-normalization-enabled"
LABEL_GPU_MODEL = "node.koordinator.sh/gpu-model"
LABEL_GPU_DRIVER_VERSION = "node.koordinator.sh/gpu-driver-version"

CPU_NORMALIZATION_CONFIG_KEY = "cpu-normalization-config"
DEFAULT_RATIO_STR = "1.00"
MIN_RATIO, MAX_RATIO = 1.0, 5.0

GPU_RESOURCE_NAMES = (
    ResourceName.GPU,
    ResourceName.GPU_CORE,
    ResourceName.GPU_MEMORY,
    ResourceName.GPU_MEMORY_RATIO,
)


@dataclass
class NodeResource:
    """Accumulator the plugin chain fills for one node (framework's
    NodeResource: Resources/Resets/Labels/Annotations)."""

    resources: Dict[str, int] = field(default_factory=dict)
    resets: Dict[str, bool] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    # annotations to remove when a plugin calculates "unset"
    annotation_removals: List[str] = field(default_factory=list)


class NodeResourcePlugin:
    """Calculate fills the NodeResource; Prepare writes it onto the node and
    reports whether the node changed."""

    name = "plugin"

    def calculate(self, node: Node, nr: NodeResource, store: ObjectStore,
                  config) -> None:
        raise NotImplementedError

    def prepare(self, node: Node, nr: NodeResource) -> bool:
        raise NotImplementedError


class CPUNormalizationPlugin(NodeResourcePlugin):
    """Ratio from the CPU model info (cpunormalization/plugin.go:130-215):
    the sloconfig's ratio model keyed by CPU model picks base / HT / turbo /
    HT+turbo ratios from the NodeResourceTopology's cpu-basic-info
    annotation; the node label can force-enable/disable. Result lands in the
    cpu-normalization-ratio annotation, validated to [1.0, 5.0]."""

    name = "CPUNormalization"

    def calculate(self, node: Node, nr: NodeResource, store: ObjectStore,
                  config) -> None:
        strategy = (config or {})
        enabled = strategy.get("enable", False)
        node_label = node.meta.labels.get(LABEL_CPU_NORMALIZATION_ENABLED)
        if node_label is not None:
            enabled = node_label == "true"
        if not enabled:
            nr.annotations[ANNOTATION_CPU_NORMALIZATION_RATIO] = DEFAULT_RATIO_STR
            return
        nrt: Optional[NodeResourceTopology] = store.get(
            KIND_NODE_TOPOLOGY, f"/{node.meta.name}")
        if nrt is None:
            return  # abort: missing NRT skips the annotation update
        raw = nrt.meta.annotations.get(ANNOTATION_CPU_BASIC_INFO, "")
        try:
            info = json.loads(raw) if raw else None
        except ValueError:
            info = None
        if not isinstance(info, dict):
            return
        model = info.get("cpuModel", "")
        ratio_model = strategy.get("ratioModel", {})
        cfg = ratio_model.get(model)
        if cfg is None:
            return
        ht = bool(info.get("hyperThreadEnabled"))
        turbo = bool(info.get("turboEnabled"))
        if ht and turbo:
            ratio = cfg.get("hyperThreadTurboEnabledRatio")
        elif ht:
            ratio = cfg.get("hyperThreadEnabledRatio")
        elif turbo:
            ratio = cfg.get("turboEnabledRatio")
        else:
            ratio = cfg.get("baseRatio")
        if ratio is None or not (MIN_RATIO <= float(ratio) <= MAX_RATIO):
            return
        nr.annotations[ANNOTATION_CPU_NORMALIZATION_RATIO] = f"{float(ratio):.2f}"

    def prepare(self, node: Node, nr: NodeResource) -> bool:
        ratio = nr.annotations.get(ANNOTATION_CPU_NORMALIZATION_RATIO)
        if ratio is None:
            return False
        if node.meta.annotations.get(ANNOTATION_CPU_NORMALIZATION_RATIO) == ratio:
            return False
        node.meta.annotations[ANNOTATION_CPU_NORMALIZATION_RATIO] = ratio
        return True


class GPUDeviceResourcePlugin(NodeResourcePlugin):
    """Device-CR -> node-status sync (gpudeviceresource/plugin.go:133-213):
    sum healthy GPU devices' resources into node allocatable/capacity (the
    koordinator.sh/gpu total is the summed gpu-core quantity), copy the
    device's model/driver labels, and reset all GPU resources when the
    Device CR is gone."""

    name = "GPUDeviceResource"

    def calculate(self, node: Node, nr: NodeResource, store: ObjectStore,
                  config) -> None:
        device: Optional[Device] = store.get(KIND_DEVICE, f"/{node.meta.name}")
        if device is None:
            for rn in GPU_RESOURCE_NAMES:
                nr.resets[rn] = True
            return
        totals: Dict[str, int] = {}
        total_gpu = 0
        for d in device.devices:
            if d.type != "gpu" or not d.health:
                continue
            for name, qty in d.resources.quantities.items():
                totals[name] = totals.get(name, 0) + qty
            total_gpu += d.resources.get(ResourceName.GPU_CORE)
        totals[ResourceName.GPU] = total_gpu
        nr.resources.update(totals)
        for label in (LABEL_GPU_MODEL, LABEL_GPU_DRIVER_VERSION):
            if label in device.meta.labels:
                nr.labels[label] = device.meta.labels[label]

    def prepare(self, node: Node, nr: NodeResource) -> bool:
        changed = False
        alloc = dict(node.allocatable.quantities)
        cap = dict(node.capacity.quantities)
        for rn in GPU_RESOURCE_NAMES:
            if nr.resets.get(rn):
                if rn in alloc or rn in cap:
                    alloc.pop(rn, None)
                    cap.pop(rn, None)
                    changed = True
        for rn, qty in nr.resources.items():
            if alloc.get(rn) != qty:
                alloc[rn] = qty
                cap[rn] = qty
                changed = True
        if changed:
            node.allocatable = ResourceList(alloc)
            node.capacity = ResourceList(cap)
        for label, val in nr.labels.items():
            if node.meta.labels.get(label) != val:
                node.meta.labels[label] = val
                changed = True
        return changed


class ResourceAmplificationPlugin(NodeResourcePlugin):
    """Amplification ratio from the normalization ratio
    (resourceamplification/plugin.go:82-111): ratio > 1 produces the
    resource-amplification-ratio annotation ({"cpu": ratio}) that the node
    mutating webhook consumes to amplify allocatable; ratio <= 1 removes it."""

    name = "ResourceAmplification"

    def calculate(self, node: Node, nr: NodeResource, store: ObjectStore,
                  config) -> None:
        # read the ratio CPUNormalization prepared this round (falling back
        # to what is already on the node)
        raw = nr.annotations.get(
            ANNOTATION_CPU_NORMALIZATION_RATIO,
            node.meta.annotations.get(ANNOTATION_CPU_NORMALIZATION_RATIO, ""))
        try:
            ratio = float(raw) if raw else -1.0
        except ValueError:
            return
        if ratio <= 1.0:
            nr.annotation_removals.append(ANNOTATION_AMPLIFICATION_RATIO)
            return
        nr.annotations[ANNOTATION_AMPLIFICATION_RATIO] = json.dumps(
            {"cpu": ratio})

    def prepare(self, node: Node, nr: NodeResource) -> bool:
        changed = False
        if ANNOTATION_AMPLIFICATION_RATIO in nr.annotation_removals:
            if node.meta.annotations.pop(ANNOTATION_AMPLIFICATION_RATIO, None) is not None:
                changed = True
            return changed
        val = nr.annotations.get(ANNOTATION_AMPLIFICATION_RATIO)
        if val is not None and node.meta.annotations.get(
                ANNOTATION_AMPLIFICATION_RATIO) != val:
            node.meta.annotations[ANNOTATION_AMPLIFICATION_RATIO] = val
            changed = True
        return changed


DEFAULT_PLUGINS = (
    CPUNormalizationPlugin(),
    GPUDeviceResourcePlugin(),
    ResourceAmplificationPlugin(),
)


def run_plugin_chain(node: Node, store: ObjectStore,
                     cpu_normalization_config: Optional[dict] = None,
                     plugins=DEFAULT_PLUGINS) -> bool:
    """Calculate + Prepare the chain for one node; True if the node changed."""
    nr = NodeResource()
    for plugin in plugins:
        cfg = (cpu_normalization_config
               if plugin.name == "CPUNormalization" else None)
        plugin.calculate(node, nr, store, cfg)
    changed = False
    for plugin in plugins:
        changed |= plugin.prepare(node, nr)
    return changed
