"""The port's versioned componentconfig (scheduler/config_v1beta2.py)
against the JAX package's.

Every case of tests/test_config_v1beta2.py runs on the port: the module's
source with its imports renamed to the port's package (and the one
Scheduler it builds put on the CPU), each test function called as it is.
Then both packages encode the same configurations to equal documents, and
decode each other's documents to equal configurations.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import types

import pytest

import test_config_v1beta2 as ref_cases
from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs
from koordinator_tpu.scheduler import config as ref_config
from koordinator_tpu.scheduler import config_v1beta2 as ref_v1beta2

from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler import config as port_config
from koordinator_tpu_torch.scheduler import config_v1beta2 as port_v1beta2


def _port_cases() -> types.ModuleType:
    path = os.path.join(os.path.dirname(__file__), "test_config_v1beta2.py")
    with open(path) as f:
        src = f.read()
    src = src.replace("koordinator_tpu.", "koordinator_tpu_torch.")
    src = src.replace("Scheduler(ObjectStore(), config=cfg)",
                      "Scheduler(ObjectStore(), config=cfg, device=\"cpu\")")
    mod = types.ModuleType("port_config_v1beta2_cases")
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


PORT_CASES = _port_cases()
CASE_NAMES = sorted(name for name, fn in inspect.getmembers(ref_cases)
                    if name.startswith("test_") and inspect.isfunction(fn))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_reference_case_on_the_port(name):
    getattr(PORT_CASES, name)()


def _configs(config_mod, args_cls):
    default = config_mod.SchedulerConfiguration()
    tuned = config_mod.SchedulerConfiguration()
    tuned.load_aware = args_cls(
        node_metric_expiration_seconds=60.0,
        resource_weights={"cpu": 2, "memory": 1},
        score_according_prod_usage=True,
        agg_usage_thresholds={"cpu": 70},
        agg_usage_aggregation_type="p95")
    tuned.coscheduling.default_timeout_seconds = 120.0
    tuned.device_share.scoring_strategy = "LeastAllocated"
    tuned.reservation.gc_duration_seconds = 3600.0
    return [default, tuned]


def test_both_packages_encode_and_decode_alike():
    for port_cfg, ref_cfg in zip(_configs(port_config, LoadAwareArgs),
                                 _configs(ref_config, RefArgs)):
        port_doc = port_v1beta2.encode_component_config(port_cfg)
        ref_doc = ref_v1beta2.encode_component_config(ref_cfg)
        assert port_doc == ref_doc
        assert (dataclasses.asdict(
            port_v1beta2.decode_component_config(ref_doc))
            == dataclasses.asdict(
                ref_v1beta2.decode_component_config(port_doc)))
    assert port_v1beta2.API_VERSION == ref_v1beta2.API_VERSION


def test_both_packages_reject_alike():
    bad = {"apiVersion": ref_v1beta2.API_VERSION,
           "kind": "KubeSchedulerConfiguration",
           "profiles": [17, {"schedulerName": "koord-scheduler",
                             "pluginConfig": [{"args": [1, 2]},
                                              "bad-entry"]}]}
    errors = []
    for mod, err_cls in ((port_v1beta2, port_config.ConfigValidationError),
                         (ref_v1beta2, ref_config.ConfigValidationError)):
        with pytest.raises(err_cls) as ei:
            mod.decode_component_config(bad)
        errors.append(ei.value.errors)
    assert errors[0] == errors[1] and len(errors[0]) == 3
