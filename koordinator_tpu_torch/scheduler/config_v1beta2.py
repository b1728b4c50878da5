"""Versioned componentconfig: the v1beta2 external schema round-trip.

Analog of reference `pkg/scheduler/apis/config/v1beta2/` (register.go
addKnownTypes, defaults.go, zz_generated.conversion.go): plugin args are
carried on the wire as camelCase objects with an apiVersion/kind header in
the kube-scheduler config group, embedded in a KubeSchedulerConfiguration's
``profiles[].pluginConfig[].args``. Decoding applies POINTER defaulting —
an absent (or null) field takes the v1beta2 default, while an explicitly
present value is kept even when falsy (the same nil-pointer vs zero-value
distinction the Go defaulter makes) — then converts to the internal form
(scheduler/config.py dataclasses). Encoding emits the fully-defaulted
external form, so decode(encode(cfg)) == cfg (the conversion round-trip
the reference's scheme fuzz-tests).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.config import (
    ConfigValidationError,
    CoschedulingArgs,
    DeviceShareArgs,
    ElasticQuotaArgs,
    NodeNUMAResourceArgs,
    ReservationArgs,
    SchedulerConfiguration,
)

# the koordinator plugin args register into the upstream kube-scheduler
# config group (reference v1beta2/register.go:26 uses
# schedschemev1beta2.GroupName)
API_VERSION = "kubescheduler.config.k8s.io/v1beta2"
CONFIG_KIND = "KubeSchedulerConfiguration"


def _camel(snake: str) -> str:
    head, *rest = snake.split("_")
    out = head + "".join(w.capitalize() for w in rest)
    # acronym spellings the reference uses in JSON tags
    return out.replace("Cpu", "CPU").replace("Numa", "NUMA")


# kind -> (internal dataclass, SchedulerConfiguration attr, plugin name).
# Derived from config.py's section registry so a plugin added there cannot
# silently miss the wire format; every koordinator kind is <plugin>Args
# (reference v1beta2/register.go addKnownTypes).
from koordinator_tpu_torch.scheduler.config import _SECTION_TYPES  # noqa: E402

KINDS: Dict[str, Tuple[type, str, str]] = {
    f"{plugin}Args": (cls, attr, plugin)
    for plugin, (attr, cls) in _SECTION_TYPES.items()
}

# LoadAware's aggregated percentile knobs nest under "aggregated" in the
# external form (reference v1beta2/types.go LoadAwareSchedulingAggregatedArgs)
_AGG_FIELDS = {
    "agg_usage_thresholds": "usageThresholds",
    "agg_usage_aggregation_type": "usageAggregationType",
    "agg_usage_duration_seconds": "usageAggregatedDurationSeconds",
    "agg_score_aggregation_type": "scoreAggregationType",
    "agg_score_duration_seconds": "scoreAggregatedDurationSeconds",
}
_AGG_REV = {ext: snake for snake, ext in _AGG_FIELDS.items()}


def _external_field_map(cls: type) -> Dict[str, str]:
    """snake field -> external camelCase name (aggregated fields excluded:
    they nest)."""
    return {
        f.name: _camel(f.name)
        for f in dataclasses.fields(cls)
        if not (cls is LoadAwareArgs and f.name in _AGG_FIELDS)
    }


def _default_of(f: dataclasses.Field) -> Any:
    if f.default is not dataclasses.MISSING:
        return f.default
    return f.default_factory()  # type: ignore[misc]


def _type_error(kind: str, ext_name: str, value: Any,
                default: Any) -> Optional[str]:
    """Wire-type check against the field's default: bad YAML must become a
    ConfigValidationError here, not a raw TypeError out of validate()."""
    if default is None:
        return None
    if isinstance(default, bool):
        ok = isinstance(value, bool)
    elif isinstance(default, (int, float)):
        ok = isinstance(value, (int, float)) and not isinstance(value, bool)
    elif isinstance(default, str):
        ok = isinstance(value, str)
    elif isinstance(default, dict):
        ok = isinstance(value, dict)
    elif isinstance(default, list):
        ok = isinstance(value, list)
    else:
        return None
    if ok:
        return None
    return (f"{kind}.{ext_name}: expected "
            f"{type(default).__name__}, got {type(value).__name__}")


def decode_args(obj: Dict[str, Any]) -> Tuple[str, Any]:
    """One versioned args object -> (plugin name, internal args), with
    pointer defaulting and strict unknown-field rejection."""
    errs: List[str] = []
    api = obj.get("apiVersion")
    kind = obj.get("kind")
    if api != API_VERSION:
        raise ConfigValidationError([f"unknown apiVersion {api!r}"])
    if kind not in KINDS:
        raise ConfigValidationError([f"unknown kind {kind!r}"])
    cls, _attr, plugin = KINDS[kind]
    fmap = _external_field_map(cls)
    rev = {ext: snake for snake, ext in fmap.items()}
    defaults = {f.name: _default_of(f) for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}

    def take(snake: str, ext_name: str, value: Any) -> None:
        terr = _type_error(kind, ext_name, value, defaults.get(snake))
        if terr is not None:
            errs.append(terr)
        else:
            kwargs[snake] = value

    for key, value in obj.items():
        if key in ("apiVersion", "kind"):
            continue
        if cls is LoadAwareArgs and key == "aggregated":
            if value is None:
                continue
            if not isinstance(value, dict):
                errs.append(f"{kind}.aggregated: expected object, got "
                            f"{type(value).__name__}")
                continue
            for akey, avalue in value.items():
                if akey not in _AGG_REV:
                    errs.append(f"{kind}.aggregated: unknown field {akey!r}")
                    continue
                if avalue is not None:  # null == unset == default
                    take(_AGG_REV[akey], f"aggregated.{akey}", avalue)
            continue
        if key not in rev:
            errs.append(f"{kind}: unknown field {key!r}")
            continue
        if value is not None:  # pointer semantics: null -> default
            take(rev[key], key, value)
    if errs:
        raise ConfigValidationError(errs)
    return plugin, cls(**kwargs)


def encode_args(args: Any) -> Dict[str, Any]:
    """Internal args -> the fully-defaulted external form (every field
    explicit, so a round-trip is lossless)."""
    for kind, (cls, _attr, _plugin) in KINDS.items():
        if isinstance(args, cls):
            break
    else:
        raise TypeError(f"not a registered args type: {type(args)!r}")
    out: Dict[str, Any] = {"apiVersion": API_VERSION, "kind": kind}
    for snake, ext in _external_field_map(cls).items():
        out[ext] = getattr(args, snake)
    if cls is LoadAwareArgs:
        out["aggregated"] = {
            ext: getattr(args, snake) for snake, ext in _AGG_FIELDS.items()
        }
    return out


def decode_component_config(
    raw: Dict[str, Any], scheduler_name: str = "koord-scheduler"
) -> SchedulerConfiguration:
    """KubeSchedulerConfiguration (v1beta2 external form) -> internal
    SchedulerConfiguration. Only the matching profile's pluginConfig is
    consumed; absent sections keep their defaults; duplicate args for one
    plugin are an error (the scheme rejects them)."""
    if raw.get("apiVersion") != API_VERSION:
        raise ConfigValidationError(
            [f"unknown apiVersion {raw.get('apiVersion')!r}"])
    if raw.get("kind") != CONFIG_KIND:
        raise ConfigValidationError([f"unknown kind {raw.get('kind')!r}"])
    cfg = SchedulerConfiguration()
    seen: set = set()
    errs: List[str] = []
    # every nested wire layer is isinstance-guarded before container/dict
    # access: malformed YAML (profiles: 17, a string profile, pluginConfig:
    # "oops", args: "foo") must surface as ConfigValidationError, never
    # TypeError/AttributeError — and a string container must be rejected
    # whole, not iterated per character
    profiles = raw.get("profiles") or []
    if not isinstance(profiles, list):
        raise ConfigValidationError(
            [f"profiles: expected list, got {type(profiles).__name__}"])
    for pi, profile in enumerate(profiles):
        if not isinstance(profile, dict):
            errs.append(f"profiles[{pi}]: expected object, got "
                        f"{type(profile).__name__}")
            continue
        if profile.get("schedulerName", scheduler_name) != scheduler_name:
            continue
        plugin_config = profile.get("pluginConfig") or []
        if not isinstance(plugin_config, list):
            errs.append(
                f"profiles[{pi}].pluginConfig: expected list, got "
                f"{type(plugin_config).__name__}")
            continue
        for ei, entry in enumerate(plugin_config):
            if not isinstance(entry, dict):
                errs.append(
                    f"profiles[{pi}].pluginConfig[{ei}]: expected object, "
                    f"got {type(entry).__name__}")
                continue
            name = entry.get("name", "")
            args_obj = entry.get("args")
            if not args_obj:
                continue  # args-less entry == use defaults (legal upstream)
            if not isinstance(args_obj, dict):
                errs.append(
                    f"profiles[{pi}].pluginConfig[{ei}]"
                    f"{f' ({name})' if name else ''}: args must be an "
                    f"object, got {type(args_obj).__name__}")
                continue
            if args_obj.get("kind") not in KINDS:
                # not a koordinator kind: upstream kube-scheduler plugin
                # args (NodeResourcesFitArgs, ...) ride the same profile —
                # they belong to the vendored defaults, pass them through
                continue
            try:
                plugin, args = decode_args(args_obj)
            except ConfigValidationError as e:
                errs.extend(e.errors)
                continue
            if name and name != plugin:
                errs.append(
                    f"pluginConfig name {name!r} does not match args kind "
                    f"for {plugin!r}")
                continue
            if plugin in seen:
                errs.append(f"duplicate pluginConfig for {plugin!r}")
                continue
            seen.add(plugin)
            _cls, attr, _plugin = KINDS[args_obj["kind"]]
            setattr(cfg, attr, args)
    if errs:
        raise ConfigValidationError(errs)
    try:
        cfg.validate()
    except ConfigValidationError:
        raise
    except (TypeError, ValueError) as e:
        # a wire value of the right container type but wrong element type
        # (resourceWeights: {"cpu": "high"}) trips validate()'s comparisons;
        # callers contract on ConfigValidationError
        raise ConfigValidationError([f"invalid config value: {e}"])
    return cfg


def encode_component_config(
    cfg: SchedulerConfiguration, scheduler_name: str = "koord-scheduler"
) -> Dict[str, Any]:
    """Internal -> fully-defaulted external KubeSchedulerConfiguration."""
    plugin_config = []
    for kind, (cls, attr, plugin) in KINDS.items():
        plugin_config.append(
            {"name": plugin, "args": encode_args(getattr(cfg, attr))})
    return {
        "apiVersion": API_VERSION,
        "kind": CONFIG_KIND,
        "profiles": [
            {"schedulerName": scheduler_name, "pluginConfig": plugin_config}
        ],
    }
