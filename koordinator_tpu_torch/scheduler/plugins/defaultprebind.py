"""DefaultPreBind: apply accumulated object patches once.

Reference `plugins/defaultprebind/plugin.go` implementing PreBindExtensions
(frameworkext/interface.go:194-197): every plugin contributes annotations during
PreBind; this plugin merges them into ONE store update per pod (one apiserver
patch in the reference) together with the binding itself."""

from __future__ import annotations


from typing import Dict

from koordinator_tpu_torch.api.objects import Pod
from koordinator_tpu_torch.client.store import KIND_POD, ObjectStore
from koordinator_tpu_torch.scheduler.frameworkext import CycleContext, Plugin


class DefaultPreBindPlugin(Plugin):
    name = "DefaultPreBind"

    def __init__(self) -> None:
        self._store: ObjectStore = None  # type: ignore[assignment]

    def register(self, store: ObjectStore) -> None:
        self._store = store

    def apply_patch(self, pod: Pod, node_name: str,
                    annotations: Dict[str, str], now: float = 0.0,
                    txn=None) -> None:
        # patch a COPY of the STORED object: watch subscribers diff old vs new,
        # and `pod` may be a cycle-local transformer view (BeforePreFilter
        # semantics) whose rewrites must not persist — the reference patches
        # nodeName/annotations via the apiserver against the server's copy
        stored = self._store.get(KIND_POD, pod.meta.key)
        patched = (stored if stored is not None else pod).patch_copy()
        patched.meta.annotations.update(annotations)
        patched.spec.node_name = node_name
        # PodScheduled=True rides the same single patch (upstream sets the
        # condition through the bind API call)
        patched.set_condition("PodScheduled", "True", "", "", now)
        if txn is not None:
            # overlapped wave replay: the cycle driver lands the whole
            # wave's patches as ONE store.update_many transaction. The
            # live-object mutation is deferred with it — `pod` may BE the
            # stored object, and mutating it before the batched event
            # fires would make the MODIFIED old-side already assigned,
            # hiding the bind transition from the gang/quota event
            # handlers the plugin counters hang off.
            txn.append((patched, pod, annotations, node_name))
            return
        self._store.update(KIND_POD, patched)
        # keep the caller's object coherent for later hooks in this cycle
        pod.meta.annotations.update(annotations)
        pod.spec.node_name = node_name
