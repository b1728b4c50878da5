"""Descheduler plugin framework: profiles + the four plugin interfaces.

Analog of reference `pkg/descheduler/framework/types.go:32-110` (Plugin,
DeschedulePlugin, BalancePlugin, EvictPlugin, FilterPlugin, Evictor, Handle)
and `pkg/descheduler/profile/`: each profile owns its plugin set and evictor;
the runner executes every profile's Deschedule plugins, then its Balance
plugins, each interval (descheduler.go deschedulerLoop).

The vendored-kubernetes adaptor layer (`framework/plugins/kubernetes/`)
collapses here: plugins are implemented natively against the ObjectStore and
the shared eviction machinery (descheduler/evictions.py) instead of adapting
sigs.k8s.io/descheduler types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from koordinator_tpu_torch.api.objects import Pod
from koordinator_tpu_torch.client.store import KIND_NODE, ObjectStore


@dataclass
class Status:
    """framework.Status."""

    err: Optional[str] = None


class Plugin:
    """Parent type for all descheduling plugins (types.go:76-78)."""

    name = "plugin"


class DeschedulePlugin(Plugin):
    """Per-pod violation plugins (types.go:80-83)."""

    def deschedule(self, nodes, now: float) -> Status:
        raise NotImplementedError


class BalancePlugin(Plugin):
    """Whole-cluster rebalance plugins (types.go:85-88)."""

    def balance(self, nodes, now: float) -> Status:
        raise NotImplementedError


class FilterPlugin(Plugin):
    """Evictability gates (types.go:96-102)."""

    def filter(self, pod: Pod) -> bool:
        raise NotImplementedError

    def pre_eviction_filter(self, pod: Pod) -> bool:
        raise NotImplementedError


class EvictPlugin(Plugin):
    """Eviction executors (types.go:90-94)."""

    def evict(self, pod: Pod, plugin_name: str, reason: str) -> bool:
        raise NotImplementedError


class DefaultEvictor(FilterPlugin, EvictPlugin):
    """The defaultevictor adaptor
    (framework/plugins/kubernetes/defaultevictor/evictor.go): evictability
    filter chain + PDB guard via the shared eviction machinery."""

    name = "DefaultEvictor"

    def __init__(self, store: ObjectStore) -> None:
        self.store = store

    def filter(self, pod: Pod) -> bool:
        from koordinator_tpu_torch.descheduler.evictions import is_evictable

        ok, _ = is_evictable(pod)
        return ok

    def pre_eviction_filter(self, pod: Pod) -> bool:
        from koordinator_tpu_torch.descheduler.evictions import check_pdbs

        return check_pdbs(self.store, pod) is None

    def evict(self, pod: Pod, plugin_name: str, reason: str) -> bool:
        # "Evict evicts a pod (no pre-check performed)" (types.go:90-94): the
        # Handle already ran Filter + PreEvictionFilter, so re-running the
        # guard chain here would double the O(|PDBs| x |pods|) scan per
        # eviction — terminate directly
        from koordinator_tpu_torch.descheduler.evictions import terminate_pod

        terminate_pod(self.store, pod, "koordinator.sh/evicted",
                      f"{plugin_name}: {reason}")
        return True


class Handle:
    """framework.Handle subset: the per-profile evictor façade plugins use
    (Evictor() in types.go:32-47). Filter -> PreEvictionFilter -> Evict."""

    def __init__(self, store: ObjectStore, filters: List[FilterPlugin],
                 evictor: EvictPlugin) -> None:
        self.store = store
        self.filters = filters
        self.evictor = evictor
        self.evicted_count = 0  # lifetime counter (callers diff it per cycle)

    def filter(self, pod: Pod) -> bool:
        return all(f.filter(pod) for f in self.filters)

    def pre_eviction_filter(self, pod: Pod) -> bool:
        return all(f.pre_eviction_filter(pod) for f in self.filters)

    def evict(self, pod: Pod, plugin_name: str, reason: str) -> bool:
        if not self.filter(pod) or not self.pre_eviction_filter(pod):
            return False
        if self.evictor.evict(pod, plugin_name, reason):
            self.evicted_count += 1
            return True
        return False


# plugin factories: name -> (store, args) -> Plugin
PluginFactory = Callable[[ObjectStore, Optional[dict]], Plugin]
_REGISTRY: Dict[str, PluginFactory] = {}


def register_plugin(name: str, factory: PluginFactory) -> None:
    _REGISTRY[name] = factory


def registered_plugins() -> List[str]:
    return sorted(_REGISTRY)


@dataclass
class ProfileConfig:
    """One descheduler profile (profile/profile.go): which plugins run at
    which extension point, with per-plugin args."""

    name: str = "default"
    deschedule: List[str] = field(default_factory=list)
    balance: List[str] = field(default_factory=list)
    filters: List[str] = field(default_factory=lambda: ["DefaultEvictor"])
    evictor: str = "DefaultEvictor"
    plugin_args: Dict[str, dict] = field(default_factory=dict)


class Profile:
    """Instantiated profile: resolved plugin objects + its Handle."""

    def __init__(self, config: ProfileConfig, store: ObjectStore) -> None:
        self.config = config
        self.store = store

        def build(name: str) -> Plugin:
            if name not in _REGISTRY:
                raise ValueError(
                    f"descheduler plugin {name!r} not registered "
                    f"(have: {registered_plugins()})"
                )
            return _REGISTRY[name](store, config.plugin_args.get(name))

        self.filter_plugins = [build(n) for n in config.filters]
        evictor = build(config.evictor)
        if not isinstance(evictor, EvictPlugin):
            raise ValueError(f"{config.evictor} is not an EvictPlugin")
        self.handle = Handle(store, self.filter_plugins, evictor)
        self.deschedule_plugins: List[DeschedulePlugin] = []
        self.balance_plugins: List[BalancePlugin] = []
        for n in config.deschedule:
            p = build(n)
            p.handle = self.handle
            self.deschedule_plugins.append(p)
        for n in config.balance:
            p = build(n)
            p.handle = self.handle
            self.balance_plugins.append(p)

    def run(self, now: float) -> Dict[str, Status]:
        """RunDeschedulePlugins then RunBalancePlugins (descheduler.go)."""
        nodes = self.store.list(KIND_NODE)
        out: Dict[str, Status] = {}
        for p in self.deschedule_plugins:
            out[p.name] = p.deschedule(nodes, now)
        for p in self.balance_plugins:
            out[p.name] = p.balance(nodes, now)
        return out
