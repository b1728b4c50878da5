"""The port's compiled serial floor against the JAX package's, on the CPU.

native/serial_floor.cpp is the port's copy of the JAX package's C++
transcription of the serial full chain (and of the LowNodeLoad pass),
built at first use into build/native/ with -ffp-contract=off
-fno-fast-math. tests/test_native_floor.py's cases run on the port: on one
seeded cluster, the port's floor on the port's pack = the JAX package's
numpy oracle (scheduler/parity.serial_schedule_full) on its own pack = the
port's plain round, bit for bit; prod mode, no quota and no gang, every
node with a topology; the inputs are never mutated. The LowNodeLoad floor
on pack_floor_inputs from the port equals the JAX package's floor on its
own pack, and the plugin's victims. A failed build, a missing compiler and
a library of another ABI raise: no caller falls back to the numpy oracle.

Tolerance: bit-identical bindings and victim flags.
"""

from __future__ import annotations

import ctypes
import random

import numpy as np
import pytest

from koordinator_tpu.api import objects as ref_objects
from koordinator_tpu.api.resources import ResourceList as RefResourceList
from koordinator_tpu.client import store as ref_store
from koordinator_tpu.descheduler.lownodeload import (
    LowNodeLoad as RefLowNodeLoad,
    pack_floor_inputs as ref_pack_floor_inputs,
)
from koordinator_tpu.native import floor as ref_floor
from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs
from koordinator_tpu.scheduler.parity import (
    serial_schedule_full as ref_serial_schedule_full,
)
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_pack,
    reduce_to_active_axes as ref_reduce,
)
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.api import objects
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.client import store as port_store
from koordinator_tpu_torch.descheduler.lownodeload import (
    LowNodeLoad,
    pack_floor_inputs,
)
from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import build_full_chain_step
from koordinator_tpu_torch.native import build as native_build
from koordinator_tpu_torch.native import floor as native_floor
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing import synth_full_cluster

NOW = 1_000_000.0


def _diff(seed, prod=False, reduce=False, **kw):
    """Port floor (port pack) == JAX oracle (JAX pack) == port plain
    round, on one seeded cluster."""
    args = LoadAwareArgs(score_according_prod_usage=prod)
    _, state = synth_full_cluster(28, 56, seed=seed, **kw)
    fc, _, _, _, _, ng, ngroups = build_full_chain_inputs(state, args)
    active = None
    if reduce:
        fc, active = reduce_to_active_axes(fc)
    nat = native_floor.serial_schedule_full_native(
        fc, args, num_groups=ngroups, active_axes=active)
    plain = build_full_chain_step(args, ng, ngroups, active_axes=active)
    chosen_plain = plain(to_device(fc, "cpu"))[0].numpy()
    rargs = RefArgs(score_according_prod_usage=prod)
    _, rstate = ref_synth(28, 56, seed=seed, **kw)
    rfc = ref_pack(rstate, rargs)[0]
    ractive = None
    if reduce:
        rfc, ractive = ref_reduce(rfc)
    ref = ref_serial_schedule_full(rfc, rargs, active_axes=ractive)
    np.testing.assert_array_equal(nat, ref)
    np.testing.assert_array_equal(nat, chosen_plain)
    return nat


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_matches_numpy_oracle(seed):
    chosen = _diff(seed)
    assert (chosen >= 0).sum() > 0


def test_native_prod_mode():
    _diff(11, prod=True)


def test_native_no_quota_no_gang():
    _diff(12, num_quotas=0, num_gangs=0)


def test_native_all_topology():
    _diff(13, topology_fraction=1.0, lsr_fraction=0.4)


def test_native_active_axes():
    """The sliced batch the sidecar sends: the balanced-allocation axes
    resolve through active_axes."""
    _diff(14, reduce=True)


def test_native_inputs_not_mutated():
    args = LoadAwareArgs()
    _, state = synth_full_cluster(16, 24, seed=5)
    fc, _, _, _, _, _, ngroups = build_full_chain_inputs(state, args)
    before = {name: np.asarray(v).copy() for name, v in fc._asdict().items()
              if name != "base"}
    base_before = {name: np.asarray(v).copy()
                   for name, v in fc.base._asdict().items()}
    native_floor.serial_schedule_full_native(fc, args, num_groups=ngroups)
    for name, value in before.items():
        np.testing.assert_array_equal(np.asarray(getattr(fc, name)), value,
                                      err_msg=name)
    for name, value in base_before.items():
        np.testing.assert_array_equal(np.asarray(getattr(fc.base, name)),
                                      value, err_msg=f"base.{name}")


# ---------------------------------------------------------------------------
# the LowNodeLoad floor
# ---------------------------------------------------------------------------


def _rebalance_world(obj, res_list, store_mod, seed):
    """tests/test_descheduler.py's non-dyadic world (40 nodes of 32 cores,
    every other one hot, 600 running BE pods with non-power-of-two
    requests) in either package."""
    gib = 1024 ** 3
    rng = random.Random(seed)
    store = store_mod.ObjectStore()
    for i in range(40):
        name, frac = f"n{i}", 0.85 if i % 2 == 0 else 0.2
        store.add(store_mod.KIND_NODE, obj.Node(
            meta=obj.ObjectMeta(name=name, namespace=""),
            allocatable=res_list.of(cpu=32000, memory=64 * gib, pods=110)))
        store.add(store_mod.KIND_NODE_METRIC, obj.NodeMetric(
            meta=obj.ObjectMeta(name=name, namespace=""),
            update_time=NOW - 10,
            node_metric=obj.NodeMetricInfo(node_usage=res_list.of(
                cpu=int(32000 * frac), memory=int(64 * gib * 0.3)))))
    for p in range(600):
        store.add(store_mod.KIND_POD, obj.Pod(
            meta=obj.ObjectMeta(name=f"p{p}",
                                labels={obj.LABEL_POD_QOS: "BE"},
                                owner_kind="ReplicaSet", owner_name="rs1",
                                creation_timestamp=NOW),
            spec=obj.PodSpec(
                node_name=f"n{p % 40}",
                priority=rng.choice([100, 5500, 9000]),
                requests=res_list.of(
                    cpu=rng.choice([100, 300, 700, 1100, 1300]),
                    memory=4 * gib)),
            phase="Running"))
    return store


@pytest.fixture
def ref_native_floor(tmp_path, monkeypatch):
    """The JAX package's floor binding over its own serial_floor.cpp,
    built into tmp_path (nothing is built into the JAX package)."""
    from pathlib import Path

    source = Path(ref_floor.__file__).resolve().parent / "serial_floor.cpp"
    lib = native_build.build_floor(source, tmp_path)
    monkeypatch.setattr(ref_floor, "_LIB_PATH", str(lib))
    monkeypatch.setattr(ref_floor, "_lib", None)
    assert ref_floor.available()
    return ref_floor


@pytest.mark.parametrize("seed", [5, 6])
def test_lownodeload_floor_matches_reference(seed, ref_native_floor):
    store = _rebalance_world(objects, ResourceList, port_store, seed)
    plugin = LowNodeLoad(store)
    pods, arrays = pack_floor_inputs(store, plugin, NOW)
    victim = native_floor.lownodeload_floor_native(**arrays)
    assert victim.sum() > 0
    rstore = _rebalance_world(ref_objects, RefResourceList, ref_store, seed)
    rplugin = RefLowNodeLoad(rstore)
    rpods, rarrays = ref_pack_floor_inputs(rstore, rplugin, NOW)
    for name, value in rarrays.items():
        np.testing.assert_array_equal(np.asarray(arrays[name]),
                                      np.asarray(value), err_msg=name)
    np.testing.assert_array_equal(
        victim, ref_native_floor.lownodeload_floor_native(**rarrays))
    # the plugin's victims: the same set (the pass's jobs)
    jobs = plugin.balance(now=NOW)
    assert ({f"{pods[i].meta.namespace}/{pods[i].meta.name}"
             for i in np.nonzero(victim)[0]}
            == {f"{j.pod_namespace}/{j.pod_name}" for j in jobs})


# ---------------------------------------------------------------------------
# no silent fallback
# ---------------------------------------------------------------------------


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    broken = tmp_path / "serial_floor.cpp"
    broken.write_text("extern \"C\" int koord_floor_abi_version() "
                      "{ return 11 }\n")
    with pytest.raises(native_build.NativeBuildError, match="error"):
        native_build.build_floor(broken, tmp_path / "out")


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    with pytest.raises(native_build.NativeBuildError, match="g\\+\\+ not "
                       "found"):
        native_build.build_floor(build_dir=tmp_path)


def test_another_abi_raises(tmp_path):
    stale = tmp_path / "stale.cpp"
    stale.write_text("extern \"C\" int koord_floor_abi_version() "
                     "{ return 10; }\n")
    lib = ctypes.CDLL(str(native_build.build_floor(stale, tmp_path)))
    with pytest.raises(native_build.NativeBuildError, match="ABI 10"):
        native_floor._bind(lib)


def test_build_is_keyed_by_the_source(tmp_path):
    a = tmp_path / "a.cpp"
    a.write_text("extern \"C\" int koord_floor_abi_version() "
                 "{ return 11; }\n")
    first = native_build.build_floor(a, tmp_path)
    assert native_build.build_floor(a, tmp_path) == first
    a.write_text("extern \"C\" int koord_floor_abi_version() "
                 "{ return 12; }\n")
    assert native_build.build_floor(a, tmp_path) != first
