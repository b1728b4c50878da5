"""The repo-root gates of hack/ on the port.

``hack/check_demotion_budget.py`` caps the demoted-cycle fraction of a
soak-derived scenario run through the JAX package's Scheduler, and
``hack/check_metrics_catalog.py`` holds the README's metric catalog to
the metrics that the JAX package registers. Here both hold the port:
the same scenario, cycle count and budget through the port's sim harness
and ``Scheduler`` on the CPU, and the same AST scan over
``koordinator_tpu_torch/`` (the port keeps the metric names) against the
same catalog, both ways. The gates' own defaults and catalog parser are
read from hack/, so the port is held to exactly what the gates hold the
JAX package to.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
HACK = REPO / "hack"


def _gate_defaults() -> dict:
    """--budget and --cycles of hack/check_demotion_budget.py, as its
    argument parser declares them."""
    tree = ast.parse((HACK / "check_demotion_budget.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant)):
            for kw in node.keywords:
                if kw.arg == "default":
                    out[node.args[0].value.lstrip("-")] = kw.value.value
    return out


def _catalog_gate():
    spec = importlib.util.spec_from_file_location(
        "check_metrics_catalog", HACK / "check_metrics_catalog.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demotion_budget_holds_on_the_port():
    """SCENARIOS["soak"] at the gate's cycle count through the port's
    harness (``Scheduler(device="cpu")``, co-located descheduler and
    manager): the demoted-cycle fraction within the gate's budget, every
    demoted cycle attributed to a reason."""
    from koordinator_tpu_torch.sim.harness import run_scenario
    from koordinator_tpu_torch.sim.scenarios import SCENARIOS

    gate = _gate_defaults()
    assert gate == {"budget": 0.15, "cycles": 150}
    sc = dataclasses.replace(SCENARIOS["soak"], cycles=gate["cycles"])
    report = run_scenario(sc, device="cpu").to_dict()
    demo = report["demotions"]
    assert report["cycles"] == gate["cycles"]
    assert sum(demo["by_reason"].values()) == demo["cycles_demoted"]
    assert demo["fraction_of_cycles"] <= gate["budget"], (
        f"{demo['cycles_demoted']}/{report['cycles']} cycles demoted "
        f"against the budget {gate['budget']}; profile "
        f"{json.dumps(demo['by_reason'])}")


class _PortRoot:
    """The repository root as the catalog gate joins it, with its
    ``koordinator_tpu/`` taken to be the port's package."""

    def __truediv__(self, name):
        return REPO / ("koordinator_tpu_torch" if name == "koordinator_tpu"
                       else name)


def _port_registered(gate) -> set:
    """The gate's AST scan (``registered_names``) over the port."""
    saved = gate.REPO
    gate.REPO = _PortRoot()
    try:
        return gate.registered_names()
    finally:
        gate.REPO = saved


def test_metric_catalog_matches_the_ports_registrations():
    """Every metric the port registers is in the README's catalog, and
    every exact catalog row is registered by the port; the port registers
    the names the JAX package registers."""
    gate = _catalog_gate()
    port = _port_registered(gate)
    catalog = gate.catalog_names()
    wildcards = {c[:-1] for c in catalog if c.endswith("*")}
    exact = {c for c in catalog if not c.endswith("*")}
    missing = sorted(n for n in port if n not in exact
                     and not any(n.startswith(w) for w in wildcards))
    stale = sorted(n for n in exact if n not in port)
    assert not missing, f"registered by the port, not in the catalog: " \
        f"{missing}"
    assert not stale, f"catalog rows the port does not register: {stale}"
    assert len(port) > 50
    assert port == gate.registered_names()
