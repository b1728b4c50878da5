"""koordwatch SLO engine: named objectives with burn-rate computation.

SLO accounting used to be ad-hoc fields scattered through
``sim/harness.py`` — ttb percentiles here, restart recovery there, colo
staleness and hotspot dissipation in their own blocks — each with its own
copy of the percentile/target/met arithmetic and nothing exported live.
The :class:`SloRegistry` makes an objective first-class: a name, a unit,
a target, the gating percentile (99 for tail objectives, 100 for
max-gated ones), the observed samples, and the derived numbers every
consumer needs — observed value at the percentile, overrun count, the
burn rate (observed/target: 1.0 is exactly on budget, 2.0 is burning the
error budget twice as fast as allowed) and the default met verdict
(vacuously true with no samples; ``observed <= target`` otherwise —
objectives with scenario-specific met rules compose them from these
stats, see ``sim/harness.SimReport.to_dict``).

Exported surfaces:

  * ``koord_slo_burn_rate{slo}`` / ``koord_slo_met{slo}`` gauges —
    injected by the owner (the flight-recorder ``dump_counter`` pattern:
    this module never imports a registry), refreshed on every observe;
  * ``/debug/slo`` on the ObsServer serves the registry as a JSONL
    bundle (header line + one line per objective);
  * ``load_bundle`` validates a bundle; the schema is the JAX package's
    (its ``tests/fixtures/slo_golden.jsonl``), field for field.

Thread discipline (koordlint's concurrency rules gate this package):
sample lists are lock-guarded — owners observe from their work threads
while the ObsServer thread exports.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

SLO_SCHEMA_VERSION = 1
SLO_SCHEMA_NAME = "koordwatch-slo"


class SloObjective:
    """One named objective. ``target <= 0`` means report-only (burn rate
    0, always met) — the sim scenarios' convention."""

    def __init__(self, name: str, target: float, percentile: float = 99.0,
                 unit: str = "seconds") -> None:
        self.name = name
        self.target = float(target)
        self.percentile = float(percentile)
        self.unit = unit
        self.samples: List[float] = []
        self.overruns = 0
        self._max: Optional[float] = None  # running max: O(1) observed()
        #                                    for max-gated objectives

    def add(self, value: float) -> None:
        """One observation (running max + overrun accounting in one
        place; the registry calls this under its lock)."""
        value = float(value)
        self.samples.append(value)
        if self._max is None or value > self._max:
            self._max = value
        if self.target > 0 and value > self.target:
            self.overruns += 1

    # -- stats (all pure reads over the sample list) --------------------
    def count(self) -> int:
        return len(self.samples)

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))

    def observed(self) -> float:
        """The value at the gating percentile (100 = max)."""
        if not self.samples:
            return 0.0
        if self.percentile >= 100.0:
            return self.maximum()
        return self.quantile(self.percentile)

    def maximum(self) -> float:
        return self._max if self._max is not None else 0.0

    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    def burn_rate(self) -> float:
        if self.target <= 0 or not self.samples:
            return 0.0
        return self.observed() / self.target

    def met(self) -> bool:
        """Default verdict: vacuously true with no samples, else
        ``observed <= target``. Report-only objectives (target <= 0)
        are always met."""
        if self.target <= 0 or not self.samples:
            return True
        return self.observed() <= self.target

    def to_record(self) -> dict:
        """One export record. The observed value is computed ONCE and
        burn/met derived from it, so a record can never contradict
        itself (e.g. met=true with burn>1) even if read while samples
        land — the registry additionally builds records under its lock
        for a consistent multi-objective export."""
        observed = self.observed()
        has_samples = bool(self.samples)
        return {
            "v": SLO_SCHEMA_VERSION,
            "kind": "slo",
            "slo": self.name,
            "unit": self.unit,
            "target": self.target,
            "percentile": self.percentile,
            "count": len(self.samples),
            "observed": observed,
            "burn_rate": (observed / self.target
                          if self.target > 0 and has_samples else 0.0),
            "met": (self.target <= 0 or not has_samples
                    or observed <= self.target),
            "overruns": self.overruns,
        }


class SloRegistry:
    """Named objectives + live gauge export + the ``/debug/slo`` dump."""

    def __init__(self, burn_gauge=None, met_gauge=None) -> None:
        self._lock = threading.Lock()
        self._objectives: Dict[str, SloObjective] = {}
        self.burn_gauge = burn_gauge
        self.met_gauge = met_gauge

    def register(self, name: str, target: float, percentile: float = 99.0,
                 unit: str = "seconds") -> SloObjective:
        with self._lock:
            if name in self._objectives:
                raise ValueError(f"SLO {name!r} already registered")
            obj = SloObjective(name, target, percentile=percentile,
                               unit=unit)
            self._objectives[name] = obj
        self._refresh(obj)
        return obj

    # percentile-gated gauges refresh at most every Nth sample (plus on
    # every overrun, when the met verdict can actually flip, and on
    # export): a full np.percentile per observation would make the
    # owner's hot path — once per bound pod in the sim — quadratic
    _REFRESH_EVERY = 16

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            obj = self._objectives[name]
            overruns0 = obj.overruns
            obj.add(value)
            force = obj.overruns != overruns0
        self._refresh(obj, force=force)

    def observe_many(self, name: str, values: Iterable[float]) -> None:
        values = list(values)
        with self._lock:
            obj = self._objectives[name]
            for v in values:
                obj.add(v)
        self._refresh(obj, force=True)

    def _refresh(self, obj: SloObjective, force: bool = False) -> None:
        """Move the injected gauges for one objective (outside the
        registry lock: gauges carry their own). The observed value is
        computed ONCE and reused for both gauges; max-gated objectives
        are O(1) via the running max, and percentile-gated ones
        throttle to every ``_REFRESH_EVERY``th sample unless forced
        (an overrun / a bulk observe / a registration)."""
        if self.burn_gauge is None and self.met_gauge is None:
            return
        if (not force and obj.percentile < 100.0
                and len(obj.samples) % self._REFRESH_EVERY):
            return
        observed = obj.observed()
        has_samples = bool(obj.samples)
        if self.burn_gauge is not None:
            burn = (observed / obj.target
                    if obj.target > 0 and has_samples else 0.0)
            self.burn_gauge.set(burn, slo=obj.name)
        if self.met_gauge is not None:
            met = (obj.target <= 0 or not has_samples
                   or observed <= obj.target)
            self.met_gauge.set(1.0 if met else 0.0, slo=obj.name)

    # -- read side -------------------------------------------------------
    def objective(self, name: str) -> Optional[SloObjective]:
        with self._lock:
            return self._objectives.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._objectives)

    def snapshot(self) -> Dict[str, dict]:
        # records built UNDER the lock: an owner observing mid-export
        # must not tear count/observed/met across objectives
        with self._lock:
            return {o.name: o.to_record()
                    for o in self._objectives.values()}

    def export_jsonl(self) -> str:
        """The ``/debug/slo`` body: header line + one line per
        objective, registration order (records built under the lock —
        see snapshot)."""
        with self._lock:
            records = [o.to_record() for o in self._objectives.values()]
        header = {
            "v": SLO_SCHEMA_VERSION,
            "kind": "header",
            "schema": SLO_SCHEMA_NAME,
            "dumped_at": time.time(),
            "slos": len(records),
        }
        lines = [json.dumps(header, sort_keys=True)]
        lines.extend(json.dumps(r, sort_keys=True) for r in records)
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# bundle schema (the JAX package's golden-fixture contract)
# ---------------------------------------------------------------------------


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_header(obj) -> List[str]:
    if not isinstance(obj, dict):
        return ["header is not a JSON object"]
    errs: List[str] = []
    if obj.get("v") != SLO_SCHEMA_VERSION:
        errs.append(f"v must be {SLO_SCHEMA_VERSION}, got {obj.get('v')!r}")
    if obj.get("kind") != "header":
        errs.append(f"kind must be 'header', got {obj.get('kind')!r}")
    if obj.get("schema") != SLO_SCHEMA_NAME:
        errs.append(f"schema must be {SLO_SCHEMA_NAME!r}, "
                    f"got {obj.get('schema')!r}")
    if not _is_num(obj.get("dumped_at")) or obj.get("dumped_at") < 0:
        errs.append(f"dumped_at must be a non-negative number, "
                    f"got {obj.get('dumped_at')!r}")
    if not isinstance(obj.get("slos"), int) or isinstance(
            obj.get("slos"), bool) or obj.get("slos") < 0:
        errs.append(f"slos must be a non-negative int, "
                    f"got {obj.get('slos')!r}")
    return errs


def validate_slo_record(obj) -> List[str]:
    if not isinstance(obj, dict):
        return ["record is not a JSON object"]
    errs: List[str] = []
    if obj.get("v") != SLO_SCHEMA_VERSION:
        errs.append(f"v must be {SLO_SCHEMA_VERSION}, got {obj.get('v')!r}")
    if obj.get("kind") != "slo":
        errs.append(f"kind must be 'slo', got {obj.get('kind')!r}")
    for key in ("slo", "unit"):
        if not isinstance(obj.get(key), str) or not obj.get(key):
            errs.append(f"{key} must be a non-empty string, "
                        f"got {obj.get(key)!r}")
    # target may legitimately be <= 0 (report-only objectives)
    if not _is_num(obj.get("target")):
        errs.append(f"target must be a number, got {obj.get('target')!r}")
    pct = obj.get("percentile")
    if not _is_num(pct) or not (0 < pct <= 100):
        errs.append(f"percentile must be in (0, 100], got {pct!r}")
    for key in ("observed", "burn_rate"):
        if not _is_num(obj.get(key)) or obj.get(key) < 0:
            errs.append(f"{key} must be a non-negative number, "
                        f"got {obj.get(key)!r}")
    for key in ("count", "overruns"):
        if not isinstance(obj.get(key), int) or isinstance(
                obj.get(key), bool) or obj.get(key) < 0:
            errs.append(f"{key} must be a non-negative int, "
                        f"got {obj.get(key)!r}")
    if not isinstance(obj.get("met"), bool):
        errs.append(f"met must be a bool, got {obj.get('met')!r}")
    return errs


def load_bundle(lines) -> Tuple[Optional[dict], List[dict], List[str]]:
    """Parse + validate an SLO bundle; returns (header, records,
    errors)."""
    from koordinator_tpu_torch.obs import load_jsonl_bundle

    return load_jsonl_bundle(lines, validate_header=validate_header,
                             validate_record=validate_slo_record,
                             count_key="slos")
