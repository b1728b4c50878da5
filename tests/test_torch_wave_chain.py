"""The port's wave-parallel round (models/wave_chain.py) against the JAX
package's build_wave_full_chain_step and the port's plain round.

The cases of tests/test_wave_chain.py: four seeds, wave widths 1 (the serial
walk), 7, 64 and 512, full topology, no quota or gang, a tiny cluster under
heavy contention, tight quotas that force in-wave flips, and taints; plus
prod-usage scoring and the mixed cluster (affinity, spread, ports, images,
CSI volume groups), whose conflicts the JAX cases do not reach. Each side
packs its own package's synth_full_cluster (equal by
tests/test_torch_pack.py). Bindings are exact; ``requested`` and
``quota_used`` equal bit for bit, both to the JAX wave step and to the
port's plain round. The JAX runs are cached per case.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from koordinator_tpu.models.wave_chain import (
    build_wave_full_chain_step as ref_build_wave,
)
from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
)
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import (
    build_best_full_chain_step,
    build_full_chain_step,
)
from koordinator_tpu_torch.models.wave_chain import (
    DEFAULT_WAVE,
    build_wave_full_chain_step,
)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.snapshot import build_full_chain_inputs
from koordinator_tpu_torch.testing import mixed_cluster, synth_full_cluster

# (seed, nodes, pods, wave, quota scale, synth options) of each case
CASES = {
    "seed0": (0, 30, 60, 64, None, ()),
    "seed1": (1, 30, 60, 64, None, ()),
    "seed2": (2, 30, 60, 64, None, ()),
    "seed3": (3, 30, 60, 64, None, ()),
    "width1": (2, 30, 60, 1, None, ()),
    "width7": (2, 30, 60, 7, None, ()),
    "width512": (2, 30, 60, 512, None, ()),
    "topology": (5, 30, 60, 32, None,
                 (("topology_fraction", 1.0), ("lsr_fraction", 0.4))),
    "no-quota-no-gang": (9, 30, 60, 32, None,
                         (("num_quotas", 0), ("num_gangs", 0))),
    "tiny-contention": (13, 4, 40, 16, None, ()),
    "tight-quota": (7, 20, 80, 64, 0.15, ()),
    "taints": (21, 24, 60, 32, None, (("taint_fraction", 0.4),)),
}


def _tighten(fc, scale):
    if scale is None:
        return fc
    return fc._replace(quota_runtime=(
        np.asarray(fc.quota_runtime) * scale).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference(case: str, prod: bool = False):
    """The JAX wave step's outputs on the case's cluster, once per case."""
    seed, n, p, wave, scale, kw = CASES[case]
    args = RefArgs(score_according_prod_usage=prod)
    _c, state = ref_synth(n, p, seed=seed, **dict(kw))
    fc, pods, _n, _t, _g, ng, ngroups = ref_build(state, args)
    fc = _tighten(fc, scale)
    out = ref_build_wave(args, ng, ngroups, wave=wave)(fc)
    return tuple(np.asarray(x) for x in out), len(pods.keys)


def _port(case: str, prod: bool = False):
    seed, n, p, wave, scale, kw = CASES[case]
    args = LoadAwareArgs(score_according_prod_usage=prod)
    _c, state = synth_full_cluster(n, p, seed=seed, **dict(kw))
    fc, pods, _n, _t, _g, ng, ngroups = build_full_chain_inputs(state, args)
    fc = to_device(_tighten(fc, scale), "cpu")
    return args, fc, ng, ngroups, wave, len(pods.keys)


def _assert_equal(out, ref):
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(CASES))
def test_wave_step_matches_reference_and_plain_round(case):
    args, fc, ng, ngroups, wave, n_pods = _port(case)
    step = build_wave_full_chain_step(args, ng, ngroups, wave=wave)
    out = step(fc)
    ref, ref_pods = _reference(case)
    assert n_pods == ref_pods
    _assert_equal(out, ref)
    _assert_equal(out, tuple(
        x.numpy() for x in build_full_chain_step(args, ng, ngroups)(fc)))
    # the host reads the cut once a wave, never once a pod
    assert step.last_pos_reads == step.last_waves >= 1
    if wave == 1:
        assert step.last_waves == fc.base.fit_requests.shape[0]
    assert (out[0][:n_pods] >= 0).sum() > 0
    if case == "tight-quota":
        # the squeeze must actually reject some quota pods
        quota_pods = fc.quota_id[:n_pods] >= 0
        assert (out[0][:n_pods][quota_pods] < 0).any()


def test_wave_step_prod_usage_matches_reference():
    args, fc, ng, ngroups, wave, _n = _port("seed1", prod=True)
    out = build_wave_full_chain_step(args, ng, ngroups, wave=wave)(fc)
    _assert_equal(out, _reference("seed1", prod=True)[0])


@pytest.mark.parametrize("seed", [101, 707])
def test_wave_step_mixed_cluster_matches_plain_round(seed):
    """Affinity, anti-affinity, spread, preferred pod affinity, ports,
    images and CSI volume groups: every conflict rule of the window is
    live, and the wave step still gives the plain round's outputs."""
    args = LoadAwareArgs()
    _c, state = mixed_cluster(seed, 30, 60)
    fc, _p, _n, _t, _g, ng, ngroups = build_full_chain_inputs(state, args)
    fc = to_device(fc, "cpu")
    assert fc.aff_dom.shape[1] > 0 and fc.port_used.shape[1] > 0
    plain = build_full_chain_step(args, ng, ngroups)(fc)
    for wave in (8, DEFAULT_WAVE):
        out = build_wave_full_chain_step(args, ng, ngroups, wave=wave)(fc)
        for got, want in zip(out, plain):
            assert torch.equal(got, want)


def test_selector_takes_the_wave_round():
    args, fc, ng, ngroups, _w, _n = _port("seed0")
    step = build_best_full_chain_step(args, ng, ngroups, kernel="wave")
    assert step.last_backend == "wave"
    out = step(fc)
    _assert_equal(out, tuple(
        x.numpy() for x in build_full_chain_step(args, ng, ngroups)(fc)))
    with pytest.raises(ValueError, match="wave"):
        build_wave_full_chain_step(args, ng, ngroups, wave=0)
