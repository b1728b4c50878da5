"""The port's host pack against the JAX package's, array for array.

Both packages build FullChainInputs from the same seeded cluster (the port's
copy of the synthetic generators and of the JAX-free host modules); every
array must be equal, before and after the active-axis reduction, and so must
the active axes and the gang/group counts. Also: importing the port leaves
JAX and the JAX package unloaded.
"""

import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
    reduce_to_active_axes as ref_reduce,
)
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing import mixed_cluster, synth_full_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "seed0": (0, {}),
    "seed1": (1, {}),
    "taints": (21, dict(taint_fraction=0.4)),
    "all_topology": (5, dict(topology_fraction=1.0, lsr_fraction=0.4)),
    "no_quota_no_gang": (9, dict(num_quotas=0, num_gangs=0)),
}


def _fields(fc):
    out = {f"base.{k}": v for k, v in fc.base._asdict().items()}
    out.update((k, v) for k, v in fc._asdict().items() if k != "base")
    return out


def mixed_fixture_state(seed):
    """The cluster state of the JAX package's own cross-feature fixture
    (tests/test_parity_fuzz.py), caught where the fixture packs it, so that
    it can be packed with any LoadAwareArgs."""
    import test_parity_fuzz

    seen = []

    def catch(state, args):
        seen.append(state)
        return ref_build(state, args)

    with mock.patch.object(test_parity_fuzz, "build_full_chain_inputs",
                           catch):
        test_parity_fuzz._mixed_fixture(seed)
    return seen[0]


def _assert_packs_equal(ref_state, state, prod=False):
    ref_args = RefArgs(score_according_prod_usage=prod)
    args = LoadAwareArgs(score_according_prod_usage=prod)
    ref_fc, ref_pods, _n, _t, ref_gi, ref_ng, ref_ngroups = ref_build(
        ref_state, ref_args)
    fc, pods, _n, _t, gi, ng, ngroups = build_full_chain_inputs(state, args)
    assert (ng, ngroups) == (ref_ng, ref_ngroups)
    assert gi == ref_gi
    assert list(pods.keys) == list(ref_pods.keys)
    for stage in ("packed", "reduced"):
        ref_f, f = _fields(ref_fc), _fields(fc)
        assert sorted(ref_f) == sorted(f)
        for name, ref_arr in ref_f.items():
            ref_arr, arr = np.asarray(ref_arr), np.asarray(f[name])
            assert arr.dtype == ref_arr.dtype, (stage, name)
            np.testing.assert_array_equal(arr, ref_arr,
                                          err_msg=f"{stage} {name}")
        if stage == "packed":
            ref_fc, ref_active = ref_reduce(ref_fc)
            fc, active = reduce_to_active_axes(fc)
            assert active == ref_active
    return fc


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_matches_reference(name):
    seed, kw = CASES[name]
    _, ref_state = ref_synth(24, 48, seed=seed, **kw)
    _, state = synth_full_cluster(24, 48, seed=seed, **kw)
    _assert_packs_equal(ref_state, state)


# the seeds tests/test_torch_full_chain.py runs through the mixed cluster
@pytest.mark.parametrize("seed,prod", [(101, False), (202, True),
                                       (303, True), (707, False)])
def test_mixed_pack_matches_reference(seed, prod):
    """mixed_cluster against the JAX package's own cross-feature fixture
    (tests/test_parity_fuzz.py), whose decoration it copies; every switch of
    the kernel is live."""
    _, state = mixed_cluster(seed, 30, 60)
    fc = _assert_packs_equal(mixed_fixture_state(seed), state, prod=prod)
    T = fc.aff_dom.shape[1]
    assert T > 0 and fc.pref_scores.shape[1] > 0
    assert fc.ppref_w.shape[0] > 0 and fc.port_used.shape[1] > 0
    assert fc.img_scores.shape[1] > 0 and fc.vol_needed.shape[1] > 1
    assert (fc.pod_spread_skew > 0).any()
    assert len(np.unique(fc.node_taint_group)) > 1


def test_storage_objects_raise_not_implemented():
    _, state = synth_full_cluster(8, 8, seed=0)
    state.pvcs = {"default/claim": object()}
    with pytest.raises(NotImplementedError, match="later slice"):
        build_full_chain_inputs(state, LoadAwareArgs())


def test_import_leaves_jax_out():
    code = ("import sys, koordinator_tpu_torch.scheduler.sidecar, "
            "koordinator_tpu_torch.testing, "
            "koordinator_tpu_torch.ops.full_chain_kernel, "
            "koordinator_tpu_torch.ops.schedule_kernel, "
            "koordinator_tpu_torch.scheduler.parity\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'koordinator_tpu' "
            "or m.startswith('koordinator_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
