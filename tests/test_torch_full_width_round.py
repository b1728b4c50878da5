"""Config 4's round and the LoadAware headline at full width: the JAX
package's decisions regenerated on the CPU.

``chip_smoke.py``'s ``main`` phase packs BASELINE config 4
(``synth_full_cluster(5000, 10000, seed=42, num_quotas=100,
num_gangs=200)``, reduced to its active axes) and runs it through the port's
sidecar entry point on the card (kernel 1) and through the plain round. Both
``chosen`` vectors must have the digest ``CONFIG4_ROUND_JAX_CHOSEN_SHA256``
(``testing/churn.round_sha``), and ``requested`` and ``quota_used`` must
equal the JAX package's within atol=1e-3 (tests/test_torch_full_chain.py's
tolerance against the JAX package), as kept in ``ROUND_FIXTURE``.

Its ``loadaware`` phase runs kernel 2 and the plain round on
``synth_cluster(5000, 10000, seed=42)`` padded to 10240 x 5120 x 14: both
``chosen`` vectors must have the digest ``LOADAWARE_JAX_CHOSEN_SHA256``.

Here the JAX package's XLA steps (``build_full_chain_step``,
``build_schedule_step``) on its own packs regenerate each pin and the
fixture, and the port's packs of the same clusters must equal the JAX
package's field for field. Write the fixture anew (after a change to the
JAX package's round) with

    JAX_PLATFORMS=cpu python -m tests.test_torch_full_width_round --write
"""

from __future__ import annotations

import functools
import sys
from pathlib import Path

import numpy as np

import chip_smoke
from koordinator_tpu.models.full_chain import build_full_chain_step
from koordinator_tpu.models.scheduler_model import (
    build_schedule_step as ref_schedule_step,
    make_inputs as ref_make_inputs,
)
from koordinator_tpu.ops.loadaware import (
    LoadAwareArgs as RefArgs,
    build_loadaware_node_state as ref_node_state,
)
from koordinator_tpu.ops.packing import (
    pack_nodes as ref_pack_nodes,
    pack_pods as ref_pack_pods,
)
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
    reduce_to_active_axes as ref_reduce,
)
from koordinator_tpu.testing import synth_cluster as ref_synth_cluster
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing import (
    loadaware_inputs,
    synth_cluster,
    synth_full_cluster,
)
from koordinator_tpu_torch.testing.churn import round_sha

NODES, PODS, SEED = 5000, 10000, 42
ROUND_FIXTURE = (Path(__file__).resolve().parent / "fixtures"
                 / chip_smoke.CONFIG4_ROUND_JAX_FIXTURE)


def _flatten(fc):
    d = {f"base.{k}": np.asarray(v) for k, v in fc.base._asdict().items()}
    d.update((k, np.asarray(v)) for k, v in fc._asdict().items()
             if k != "base")
    return d


@functools.lru_cache(maxsize=None)
def jax_round():
    """The JAX package's pack of config 4, reduced to its active axes, and
    its XLA full-chain step on it -> (flattened inputs, ng, ngroups,
    active, chosen, requested, quota_used)."""
    _cluster, state = ref_synth(NODES, PODS, seed=SEED,
                                num_quotas=PODS // 100, num_gangs=PODS // 50)
    args = RefArgs()
    fc, _pods, _nodes, _tree, _gi, ng, ngroups = ref_build(state, args)
    fc, active = ref_reduce(fc)
    out = build_full_chain_step(args, ng, ngroups, active_axes=active)(fc)
    chosen, requested, quota_used = (np.asarray(x) for x in out)
    return _flatten(fc), ng, ngroups, active, chosen, requested, quota_used


@functools.lru_cache(maxsize=None)
def jax_loadaware():
    """bench.py's default LoadAware chain in the JAX package at config
    size -> (inputs, chosen)."""
    cluster = ref_synth_cluster(num_nodes=NODES, num_pods=PODS, seed=SEED)
    args = RefArgs()
    pods = ref_pack_pods(cluster.pods, args.resource_weights,
                         args.estimated_scaling_factors)
    nodes = ref_pack_nodes(cluster.nodes)
    nodes.extras = ref_node_state(
        cluster.nodes, cluster.node_metrics, cluster.pods_by_key,
        cluster.assigned, args, cluster.now, pad_to=nodes.padded_size)
    inputs = ref_make_inputs(pods, nodes, args)
    chosen, _requested = ref_schedule_step(args)(inputs)
    return inputs, np.asarray(chosen)


def write_fixture() -> None:
    _fc, _ng, _ngroups, _active, _chosen, requested, quota_used = jax_round()
    np.savez_compressed(ROUND_FIXTURE, requested=requested,
                        quota_used=quota_used)


def test_round_pin_is_the_jax_package():
    _fc, _ng, _ngroups, active, chosen, requested, quota_used = jax_round()
    assert chosen.shape == (10240,) and requested.shape == (5120, len(active))
    assert round_sha(chosen) == chip_smoke.CONFIG4_ROUND_JAX_CHOSEN_SHA256
    with np.load(ROUND_FIXTURE) as kept:
        assert sorted(kept.files) == ["quota_used", "requested"]
        for name, got in (("requested", requested),
                          ("quota_used", quota_used)):
            assert kept[name].dtype == got.dtype == np.float32, name
            np.testing.assert_array_equal(kept[name], got, err_msg=name)


def test_port_pack_is_the_jax_pack():
    """The port's pack of config 4, as chip_smoke.py's main phase makes it,
    is the JAX package's field for field."""
    ref_fc, ng, ngroups, active, *_out = jax_round()
    _cluster, state = synth_full_cluster(NODES, PODS, seed=SEED,
                                         num_quotas=PODS // 100,
                                         num_gangs=PODS // 50)
    fc, _p, _n, _t, _gi, got_ng, got_ngroups = build_full_chain_inputs(
        state, LoadAwareArgs())
    fc, got_active = reduce_to_active_axes(fc)
    assert (got_ng, got_ngroups, list(got_active)) == (ng, ngroups,
                                                       list(active))
    got = _flatten(fc)
    assert sorted(got) == sorted(ref_fc)
    for name, want in ref_fc.items():
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_loadaware_pin_is_the_jax_package():
    inputs, chosen = jax_loadaware()
    assert inputs.fit_requests.shape == (10240, 14)
    assert inputs.allocatable.shape == (5120, 14)
    assert round_sha(chosen) == chip_smoke.LOADAWARE_JAX_CHOSEN_SHA256


def test_port_loadaware_pack_is_the_jax_pack():
    """The port's LoadAware inputs, as chip_smoke.py's loadaware phase
    packs them, are the JAX package's field for field."""
    ref_inputs, _chosen = jax_loadaware()
    inputs = loadaware_inputs(
        synth_cluster(num_nodes=NODES, num_pods=PODS, seed=SEED),
        LoadAwareArgs())
    for name, want in ref_inputs._asdict().items():
        got, want = np.asarray(getattr(inputs, name)), np.asarray(want)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: JAX_PLATFORMS=cpu python -m "
                 "tests.test_torch_full_width_round --write")
    write_fixture()
    print(ROUND_FIXTURE)
