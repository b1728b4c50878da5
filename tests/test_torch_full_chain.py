"""The port's full-chain round (koordinator_tpu_torch) against the JAX
package's, on the CPU.

Each configuration is packed by the JAX package and by the port from the
same seeded cluster; the port's plain round runs twice — once on its own
pack through SidecarServer.schedule_batch, once on the JAX pack carried
across by full_chain_inputs_from_numpy through build_best_full_chain_step —
and both are held against the JAX package's XLA step. Two configurations
are also held against the Pallas kernel in interpret mode.

Tolerances: `chosen` must be bit-identical. `requested` and `quota_used`
are compared with atol=1e-3, the tolerance tests/test_pallas_full_chain.py
uses between the XLA step and the Pallas kernel: the Pallas kernel carries
Fit state as alloc - requested and re-derives requested at the end, which is
exact for packed integers but may move a non-integer f32 value by an ulp.
"""

import functools

import numpy as np
import pytest

from koordinator_tpu.models.full_chain import build_full_chain_step
from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
    reduce_to_active_axes as ref_reduce,
)
from koordinator_tpu.testing import synth_full_cluster as ref_synth
from test_torch_pack import mixed_fixture_state

from koordinator_tpu_torch.models.convert import full_chain_inputs_from_numpy
from koordinator_tpu_torch.models.full_chain import build_best_full_chain_step
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.sidecar import SidecarServer
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing import mixed_cluster, synth_full_cluster

# name -> (cluster kind, seed, cluster kwargs, reduce to active axes, prod)
CONFIGS = {
    "seed0": ("synth", 0, {}, False, False),
    "seed1": ("synth", 1, {}, False, False),
    "seed2": ("synth", 2, {}, False, False),
    "no_quota_no_gang": ("synth", 9, dict(num_quotas=0, num_gangs=0), False,
                         False),
    "crosses_pod_block": ("synth", 6, dict(num_nodes=40, num_pods=160), False,
                          False),
    "all_topology": ("synth", 5, dict(topology_fraction=1.0,
                                      lsr_fraction=0.4), False, False),
    "active_axes": ("synth", 4, dict(num_nodes=20, num_pods=40), True, False),
    "taints": ("synth", 21, dict(taint_fraction=0.4), False, False),
    "mixed101": ("mixed", 101, {}, False, False),
    "mixed202": ("mixed", 202, {}, True, False),
    "mixed707": ("mixed", 707, {}, False, False),
    "prod_synth": ("synth", 3, {}, True, True),
    "prod_mixed": ("mixed", 303, {}, True, True),
}


def _clusters(name):
    """(reference state, port state) built from the same seed. A mixed
    configuration's reference is the JAX package's own cross-feature fixture
    (tests/test_parity_fuzz.py, 30 nodes x 60 pods), which the port's
    mixed_cluster copies."""
    kind, seed, kw, _reduce, _prod = CONFIGS[name]
    if kind == "mixed":
        return mixed_fixture_state(seed), mixed_cluster(seed, 30, 60)[1]
    kw = dict(kw)
    n, p = kw.pop("num_nodes", 24), kw.pop("num_pods", 48)
    _, ref_state = ref_synth(n, p, seed=seed, **kw)
    _, state = synth_full_cluster(n, p, seed=seed, **kw)
    return ref_state, state


def _flatten(fc):
    d = {f"base.{k}": np.asarray(v) for k, v in fc.base._asdict().items()}
    d.update((k, np.asarray(v)) for k, v in fc._asdict().items()
             if k != "base")
    return d


@functools.lru_cache(maxsize=None)
def _reference(name):
    """JAX pack + XLA step for one configuration."""
    _kind, _seed, _kw, reduce, prod = CONFIGS[name]
    ref_state, state = _clusters(name)
    args = RefArgs(score_according_prod_usage=prod)
    fc, _pods, _nodes, _tree, _gi, ng, ngroups = ref_build(ref_state, args)
    active = None
    if reduce:
        fc, active = ref_reduce(fc)
    out = build_full_chain_step(args, ng, ngroups, active_axes=active)(fc)
    return dict(fc=fc, args=args, ng=ng, ngroups=ngroups, active=active,
                state=state, out=tuple(np.asarray(x) for x in out))


def _port_args(ref_args):
    return LoadAwareArgs(
        resource_weights=dict(ref_args.resource_weights),
        score_according_prod_usage=ref_args.score_according_prod_usage)


def _assert_same(ref_out, out):
    chosen_r, req_r, q_r = ref_out
    chosen, req, q = (np.asarray(x) for x in out)
    np.testing.assert_array_equal(chosen_r, chosen)
    np.testing.assert_allclose(req_r, req, atol=1e-3)
    np.testing.assert_allclose(q_r, q, atol=1e-3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_pack_sidecar_matches_xla(name):
    """Port pack -> SidecarServer.schedule_batch (plain round on the CPU)."""
    ref = _reference(name)
    args = _port_args(ref["args"])
    fc, _pods, _nodes, _tree, _gi, ng, ngroups = build_full_chain_inputs(
        ref["state"], args)
    active = None
    if ref["active"] is not None:
        fc, active = reduce_to_active_axes(fc)
        assert active == ref["active"]
    assert (ng, ngroups) == (ref["ng"], ref["ngroups"])
    server = SidecarServer(device="cpu")
    out = server.schedule_batch(fc, args, ng, ngroups, active)
    assert server.last_backend == "serial"
    _assert_same(ref["out"], out)
    assert (ref["out"][0] >= 0).sum() > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_pack_carried_across_matches_xla(name):
    """JAX pack -> full_chain_inputs_from_numpy -> build_best_full_chain_step
    on CPU tensors."""
    ref = _reference(name)
    fc = full_chain_inputs_from_numpy(_flatten(ref["fc"]), device="cpu")
    step = build_best_full_chain_step(_port_args(ref["args"]), ref["ng"],
                                      ref["ngroups"],
                                      active_axes=ref["active"])
    out = step(fc)
    assert step.last_backend == "serial"
    _assert_same(ref["out"], out)


@pytest.mark.parametrize("name", ["seed0", "mixed707"])
def test_port_matches_pallas_interpret(name):
    """The port's plain round against the Pallas kernel in interpret mode,
    as the JAX package's own tests run it."""
    from koordinator_tpu.ops.pallas_full_chain import (
        build_pallas_full_chain_step,
    )

    ref = _reference(name)
    pallas = build_pallas_full_chain_step(
        ref["args"], ref["ng"], ref["ngroups"], interpret=True,
        active_axes=ref["active"])(ref["fc"])
    fc = full_chain_inputs_from_numpy(_flatten(ref["fc"]), device="cpu")
    out = build_best_full_chain_step(
        _port_args(ref["args"]), ref["ng"], ref["ngroups"],
        active_axes=ref["active"])(fc)
    _assert_same(tuple(np.asarray(x) for x in pallas), out)


def test_sidecar_step_cache_keys_on_weights():
    """Two batches of the same shapes with different score weights: the
    cached step of the first must not score the second."""
    from koordinator_tpu_torch.api.resources import ResourceName

    _, state = synth_full_cluster(24, 48, seed=0)
    server = SidecarServer(device="cpu")
    outs = {}
    # memory alone first: a step cached for it skips the cpu axis
    for weights in ({ResourceName.MEMORY: 1},
                    {ResourceName.CPU: 1, ResourceName.MEMORY: 1}):
        args = LoadAwareArgs(resource_weights=weights)
        fc, _p, _n, _t, _gi, ng, ngroups = build_full_chain_inputs(state,
                                                                   args)
        fc, active = reduce_to_active_axes(fc)
        outs[len(weights)] = server.schedule_batch(fc, args, ng, ngroups,
                                                   active)
        fresh = SidecarServer(device="cpu").schedule_batch(fc, args, ng,
                                                           ngroups, active)
        for got, want in zip(outs[len(weights)], fresh):
            np.testing.assert_array_equal(got, want)
    assert not np.array_equal(outs[1][0], outs[2][0])
