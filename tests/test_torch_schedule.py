"""The port's LoadAware-only round (koordinator_tpu_torch) against the JAX
package's, on the CPU.

Each configuration is packed by the JAX package and by the port from the
same seeded cluster. The port's round runs on the CPU, so it takes its plain
version; it is held against three references: the JAX XLA step, the JAX
Pallas kernel in interpret mode, and the numpy oracle (`serial_schedule`),
whose port copy must in turn equal the JAX one. Each configuration is fed
twice: through the port's own pack (which must equal the JAX pack array for
array) and through `schedule_inputs_from_numpy` of the JAX pack.

Tolerances: `chosen` must be bit-identical. `requested` is compared with
atol=1e-4, the tolerance tests/test_pallas_step.py uses between the XLA step
and the Pallas kernel. Every packed value is an integer below 2^24, so every
implementation's `requested` is exact; the tolerance only absorbs dtype
round trips (the Pallas kernel carries alloc - requested and re-derives
requested at the end).
"""

import functools

import numpy as np
import pytest
import torch

from koordinator_tpu.models.scheduler_model import (
    build_schedule_step as ref_build_step,
    build_score_matrix as ref_score_matrix,
    make_inputs as ref_make_inputs,
)
from koordinator_tpu.ops import loadaware as ref_la
from koordinator_tpu.ops.fit import fit_ok_matrix as ref_fit_matrix
from koordinator_tpu.ops.loadaware import (
    LoadAwareArgs as RefArgs,
    build_loadaware_node_state as ref_node_state,
)
from koordinator_tpu.ops.packing import (
    pack_nodes as ref_pack_nodes,
    pack_pods as ref_pack_pods,
)
from koordinator_tpu.ops.pallas_step import build_pallas_schedule_step
from koordinator_tpu.scheduler import parity as ref_parity
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
)
from koordinator_tpu.testing import synth_cluster as ref_synth
from koordinator_tpu.testing import synth_full_cluster as ref_synth_full

from koordinator_tpu_torch.api.resources import ResourceName
from koordinator_tpu_torch.models.convert import (
    as_tensor,
    check_device,
    schedule_inputs_from_numpy,
)
from koordinator_tpu_torch.models.scheduler_model import (
    build_best_schedule_step,
    build_schedule_step,
    build_score_matrix,
    make_inputs,
)
from koordinator_tpu_torch.ops import loadaware
from koordinator_tpu_torch.ops.fit import fit_ok_matrix
from koordinator_tpu_torch.ops.loadaware import (
    LoadAwareArgs,
    build_loadaware_node_state,
)
from koordinator_tpu_torch.ops.packing import pack_nodes, pack_pods
from koordinator_tpu_torch.scheduler import parity
from koordinator_tpu_torch.scheduler.snapshot import build_full_chain_inputs
from koordinator_tpu_torch.testing import synth_cluster, synth_full_cluster

CPU, MEM = ResourceName.CPU, ResourceName.MEMORY

# name -> (seed, nodes, pods, cluster kwargs, LoadAwareArgs kwargs,
#          every node unschedulable); the configurations of
# tests/test_pallas_step.py and tests/test_loadaware_parity.py
CONFIGS = {
    "seed0": (0, 40, 80, {}, {}, False),
    "seed1": (1, 40, 80, {}, {}, False),
    "seed2": (2, 40, 80, {}, {}, False),
    "seed7": (7, 24, 40, {}, {}, False),
    "prod_seed0": (0, 24, 40, {}, dict(score_according_prod_usage=True),
                   False),
    "prod_seed7": (7, 30, 60, {}, dict(prod_usage_thresholds={CPU: 60},
                                       score_according_prod_usage=True),
                   False),
    "aggregated": (11, 30, 60, dict(aggregated_fraction=0.9),
                   dict(agg_usage_thresholds={CPU: 70, MEM: 95},
                        agg_usage_aggregation_type="p95",
                        agg_score_aggregation_type="p95",
                        agg_score_duration_seconds=1800), False),
    "crosses_pod_block": (2, 32, 160, {}, {}, False),
    "unschedulable": (3, 4, 6, {}, {}, True),
}


def _pack(synth, pack_pods_fn, pack_nodes_fn, node_state_fn, make_fn,
          args, name):
    seed, n, p, cluster_kw, _args_kw, unschedulable = CONFIGS[name]
    cluster = synth(num_nodes=n, num_pods=p, seed=seed, **cluster_kw)
    pods = pack_pods_fn(cluster.pods, args.resource_weights,
                        args.estimated_scaling_factors)
    nodes = pack_nodes_fn(cluster.nodes)
    nodes.extras = node_state_fn(
        cluster.nodes, cluster.node_metrics, cluster.pods_by_key,
        cluster.assigned, args, cluster.now, pad_to=nodes.padded_size)
    inputs = make_fn(pods, nodes, args)
    if unschedulable:
        inputs = inputs._replace(node_ok=np.zeros_like(inputs.node_ok))
    return inputs


@functools.lru_cache(maxsize=None)
def _reference(name):
    """JAX pack, XLA step, Pallas interpret and the JAX oracle for one
    configuration."""
    args = RefArgs(**CONFIGS[name][4])
    inputs = _pack(ref_synth, ref_pack_pods, ref_pack_nodes, ref_node_state,
                   ref_make_inputs, args, name)
    chosen_x, req_x = ref_build_step(args)(inputs)
    chosen_p, req_p = build_pallas_schedule_step(args, interpret=True)(
        inputs)
    out = dict(args=args, inputs=inputs,
               xla=(np.asarray(chosen_x), np.asarray(req_x)),
               pallas=(np.asarray(chosen_p), np.asarray(req_p)),
               oracle=ref_parity.serial_schedule(inputs, args))
    # the references agree among themselves
    np.testing.assert_array_equal(out["xla"][0], out["pallas"][0])
    np.testing.assert_array_equal(out["xla"][0], out["oracle"])
    return out


def _port_args(name):
    return LoadAwareArgs(**CONFIGS[name][4])


def _assert_matches_references(ref, out):
    chosen, requested = (np.asarray(x) for x in out)
    for key in ("xla", "pallas"):
        np.testing.assert_array_equal(chosen, ref[key][0], err_msg=key)
        np.testing.assert_allclose(requested, ref[key][1], rtol=0, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_array_equal(chosen, ref["oracle"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_pack_round_matches_references(name):
    """Port pack (== JAX pack array for array) -> build_best_schedule_step
    on the CPU; the port's oracle on its own pack == the JAX oracle."""
    ref = _reference(name)
    args = _port_args(name)
    inputs = _pack(synth_cluster, pack_pods, pack_nodes,
                   build_loadaware_node_state, make_inputs, args, name)
    for field, ref_arr in ref["inputs"]._asdict().items():
        arr, ref_arr = np.asarray(getattr(inputs, field)), np.asarray(ref_arr)
        assert arr.dtype == ref_arr.dtype, field
        np.testing.assert_array_equal(arr, ref_arr, err_msg=field)
    step = build_best_schedule_step(args, device="cpu")
    out = step(inputs)
    assert step.last_backend == "serial"
    _assert_matches_references(ref, out)
    np.testing.assert_array_equal(parity.serial_schedule(inputs, args),
                                  ref["oracle"])
    if CONFIGS[name][5]:
        assert (np.asarray(out[0]) == -1).all()
    else:
        assert (np.asarray(out[0]) >= 0).sum() > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_pack_carried_across_matches_references(name):
    """JAX pack -> schedule_inputs_from_numpy -> the plain round, directly
    and through the entry point with kernel="serial"."""
    ref = _reference(name)
    args = _port_args(name)
    inputs = schedule_inputs_from_numpy(
        {k: np.asarray(v) for k, v in ref["inputs"]._asdict().items()}, "cpu")
    _assert_matches_references(ref, build_schedule_step(args)(inputs))
    step = build_best_schedule_step(args, device="cpu", kernel="serial")
    _assert_matches_references(ref, step(inputs))
    assert step.last_backend == "serial"


# ---- the ops the one-shot score matrix is built from

P, N, R = 12, 20, 5


def _ints(rng, lo, hi, shape, zero_frac=0.2):
    a = rng.randint(lo, hi, size=shape).astype(np.float32)
    a[rng.random_sample(shape) < zero_frac] = 0.0
    return a


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def case_fit_ok_matrix(rng):
    args = (_ints(rng, 0, 30, (P, R)), _ints(rng, 0, 200, (N, R)),
            _ints(rng, 0, 190, (N, R)))
    return ref_fit_matrix(*args), fit_ok_matrix(*map(_t, args))


def case_loadaware_filter(rng):
    args = tuple(rng.random_sample(k) < 0.4 for k in (P, P, N, N))
    return ref_la.loadaware_filter(*args), loadaware.loadaware_filter(
        *map(_t, args))


def _score_terms(rng, prod_mode):
    weights = rng.randint(0, 3, size=R).astype(np.float32)
    widx = tuple(int(i) for i in np.nonzero(weights)[0])
    arrays = (_ints(rng, 0, 40, (P, R)), rng.random_sample(P) < 0.5,
              _ints(rng, 0, 150, (N, R)), _ints(rng, 0, 150, (N, R)),
              _ints(rng, 0, 200, (N, R), 0.1), rng.random_sample(N) < 0.8,
              weights)
    ref = ref_la.loadaware_score_terms(*arrays, prod_mode, widx)
    out = loadaware.loadaware_score_terms(*map(_t, arrays), prod_mode, widx)
    return ref, out


def case_loadaware_score_terms(rng):
    return _score_terms(rng, False)


def case_loadaware_score_terms_prod(rng):
    return _score_terms(rng, True)


OP_CASES = {f.__name__[5:]: f for f in (
    case_fit_ok_matrix, case_loadaware_filter, case_loadaware_score_terms,
    case_loadaware_score_terms_prod)}


@pytest.mark.parametrize("op", sorted(OP_CASES))
def test_op_matches_reference(op):
    """Seeded packed integers below 2^24, the same f32 operations in the
    same order on both sides: exact (atol=0)."""
    ref, out = OP_CASES[op](np.random.RandomState(3))
    ref, out = np.asarray(ref), out.numpy()
    assert ref.shape == out.shape
    if ref.dtype == np.bool_:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["seed0", "prod_seed7"])
def test_score_matrix_matches_jax(name):
    """The one-shot [P, N] feasibility and score equal the JAX ones; the
    first pod's best node is the oracle's first pick (no pod has committed
    anything before it)."""
    ref = _reference(name)
    inputs = schedule_inputs_from_numpy(
        {k: np.asarray(v) for k, v in ref["inputs"]._asdict().items()}, "cpu")
    feasible, score = (x.numpy() for x in
                       build_score_matrix(_port_args(name))(inputs))
    ref_feasible, ref_score = (np.asarray(x) for x in
                               ref_score_matrix(ref["args"])(ref["inputs"]))
    np.testing.assert_array_equal(feasible, ref_feasible)
    np.testing.assert_allclose(score, ref_score, rtol=0, atol=0)
    assert feasible[0].any()
    best = int(np.argmax(np.where(feasible[0], score[0], -1.0)))
    assert ref["oracle"][0] == best


@pytest.mark.parametrize("seed", [0, 5])
def test_full_chain_oracle_matches_jax(seed):
    """The port's copy of serial_schedule_full on its own full-chain pack
    equals the JAX oracle on the JAX pack."""
    _, ref_state = ref_synth_full(24, 48, seed=seed)
    _, state = synth_full_cluster(24, 48, seed=seed)
    ref_fc = ref_build(ref_state, RefArgs())[0]
    fc = build_full_chain_inputs(state, LoadAwareArgs())[0]
    ref_chosen = ref_parity.serial_schedule_full(ref_fc, RefArgs())
    chosen = parity.serial_schedule_full(fc, LoadAwareArgs())
    np.testing.assert_array_equal(chosen, ref_chosen)
    assert (chosen >= 0).sum() > 0
    keys = [f"pod{i}" for i in range(len(chosen))]
    assert parity.diff_bindings(chosen, ref_chosen, keys) == []


def test_entry_point_forms():
    """On the CPU the entry point takes the plain round; an unknown kernel
    and CUDA where there is none raise."""
    ref = _reference("seed7")
    step = build_best_schedule_step(_port_args("seed7"), device="cpu")
    assert step.last_backend is None
    chosen, requested = step(ref["inputs"])
    assert step.last_backend == "serial"
    assert chosen.dtype == torch.int32 and requested.dtype == torch.float32
    assert chosen.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown kernel"):
        build_best_schedule_step(LoadAwareArgs(), device="cpu",
                                 kernel="pallas")
    if torch.cuda.is_available():
        assert check_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_best_schedule_step(LoadAwareArgs())


@pytest.mark.parametrize("value", [np.int32(3), np.float64(2.5), True,
                                   np.zeros((0, 3)), np.ones((2, 1, 4))])
def test_as_tensor_keeps_the_shape(value):
    """The converter keeps every shape, 0-d included (jnp.asarray does),
    with the round's dtypes."""
    arr = np.asarray(value)
    out = as_tensor(value, "cpu")
    assert tuple(out.shape) == arr.shape
    assert out.dtype == {"b": torch.bool, "i": torch.int32,
                         "f": torch.float32}[arr.dtype.kind]
    np.testing.assert_array_equal(out.numpy(), arr.astype(out.numpy().dtype))
