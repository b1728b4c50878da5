"""Kubelet stub: HTTP client for the kubelet's read-only endpoints.

Analog of reference `pkg/koordlet/statesinformer/impl/kubelet_stub.go:40-130`:
`GetAllPods` pulls `GET /pods/` (a k8s-style `PodList` JSON document) and
`GetKubeletConfiguration` pulls `GET /configz`. The pods informer uses this as
its pod source so the agent tracks what the *kubelet* is actually running, not
just what the apiserver mirror says. Tests stand up a plain `http.server`
fixture serving the same JSON shapes.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from koordinator_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
from koordinator_tpu_torch.api.resources import ResourceList, ResourceName, parse_quantity


class KubeletError(RuntimeError):
    pass


def _parse_resource_map(raw: Optional[Dict[str, Any]]) -> ResourceList:
    if not raw:
        return ResourceList()
    return ResourceList(
        {
            name: parse_quantity(value, cpu=(name == ResourceName.CPU))
            for name, value in raw.items()
        }
    )


def pod_from_k8s_json(doc: Dict[str, Any]) -> Pod:
    """Decode one k8s-wire pod object (the subset the agent consumes).

    Container requests/limits aggregate across containers the way the
    kubelet's resource accounting does (sum requests, sum limits)."""
    meta = doc.get("metadata") or {}
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}

    requests = ResourceList()
    limits = ResourceList()
    for container in spec.get("containers") or []:
        res = container.get("resources") or {}
        requests = requests.add(_parse_resource_map(res.get("requests")))
        limits = limits.add(_parse_resource_map(res.get("limits")))

    priority = spec.get("priority")
    return Pod(
        meta=ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            uid=meta.get("uid", ""),
            labels=dict(meta.get("labels") or {}),
            annotations=dict(meta.get("annotations") or {}),
        ),
        spec=PodSpec(
            node_name=spec.get("nodeName", ""),
            scheduler_name=spec.get("schedulerName", "koord-scheduler"),
            priority=int(priority) if priority is not None else None,
            priority_class_name=spec.get("priorityClassName", ""),
            requests=requests,
            limits=limits,
            node_selector=dict(spec.get("nodeSelector") or {}),
        ),
        phase=status.get("phase", "Pending"),
    )


class KubeletStub:
    """Minimal HTTP client for the kubelet read-only API."""

    def __init__(self, host: str = "127.0.0.1", port: int = 10255,
                 scheme: str = "http", timeout_seconds: float = 2.0):
        self.host = host
        self.port = port
        self.scheme = scheme
        self.timeout = timeout_seconds

    def _get_json(self, path: str) -> Any:
        url = f"{self.scheme}://{self.host}:{self.port}{path}"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as rsp:
                if rsp.status != 200:
                    raise KubeletError(f"request {url} failed, code {rsp.status}")
                body = rsp.read()
        except (urllib.error.URLError, OSError) as exc:
            raise KubeletError(f"request {url} failed: {exc}") from exc
        try:
            return json.loads(body)
        except ValueError as exc:
            raise KubeletError(f"parse {path} response failed: {exc}") from exc

    def get_all_pods(self) -> List[Pod]:
        """GET /pods/ -> decoded pod list (kubelet_stub.go:72-103)."""
        doc = self._get_json("/pods/")
        items = doc.get("items") if isinstance(doc, dict) else None
        return [pod_from_k8s_json(item) for item in items or []]

    def get_kubelet_configuration(self) -> Dict[str, Any]:
        """GET /configz -> the `kubeletconfig` payload (kubelet_stub.go:105-130)."""
        doc = self._get_json("/configz")
        if isinstance(doc, dict) and "kubeletconfig" in doc:
            return doc["kubeletconfig"]
        raise KubeletError("configz response missing 'kubeletconfig'")
