"""The port's device ops against their JAX counterparts, on the CPU.

Inputs are drawn with numpy from a seed and handed to both. Every value is a
packed integer below 2^24 and both sides run the same f32 operations in the
same order, so booleans and ints must be equal and the f32 rows equal with
atol=0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import gang as ref_gang
from koordinator_tpu.ops import loadaware as ref_la
from koordinator_tpu.ops import numa as ref_numa
from koordinator_tpu.ops import quota as ref_quota
from koordinator_tpu.ops.common import least_requested_score as ref_lrs
from koordinator_tpu.ops.fit import fit_ok_row as ref_fit
from koordinator_tpu.ops.pallas_common import safe_reciprocal as ref_recip

from koordinator_tpu_torch.ops import gang, loadaware, numa, quota
from koordinator_tpu_torch.ops.common import least_requested_score
from koordinator_tpu_torch.ops.fit import fit_ok_row
from koordinator_tpu_torch.ops.kernel_common import safe_reciprocal

N, R, K = 32, 4, 3


def _ints(rng, lo, hi, shape, zero_frac=0.2):
    a = rng.randint(lo, hi, size=shape).astype(np.float32)
    a[rng.random_sample(shape) < zero_frac] = 0.0
    return a


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quota_tree(rng, G=6, D=4):
    parent = np.full(G, -1, np.int32)
    for g in range(1, G):
        parent[g] = rng.randint(0, g)
    anc = np.full((G, D), -1, np.int32)
    for g in range(G):
        x, d = g, 0
        while x >= 0 and d < D:
            anc[g, d] = x
            x, d = parent[x], d + 1
    used = _ints(rng, 0, 50, (G, R))
    runtime = used + _ints(rng, 0, 40, (G, R), zero_frac=0.1)
    return anc, used, runtime


def case_loadaware_node_reject(rng):
    alloc = _ints(rng, 1, 200, (N, R))
    args = (alloc, _ints(rng, 0, 220, (N, R)), rng.random_sample(N) < 0.8,
            _ints(rng, 0, 100, (N, R), 0.4), _ints(rng, 0, 100, (N, R), 0.7),
            _ints(rng, 0, 220, (N, R)), rng.random_sample(N) < 0.2)
    ref = ref_la.loadaware_node_reject(*args)
    out = loadaware.loadaware_node_reject(*map(_t, args))
    return ref, out


def case_numa_admit_row(rng):
    req = _ints(rng, 0, 30, (R,))
    free = _ints(rng, 0, 40, (N, K, R))
    policy = rng.randint(0, 4, size=N).astype(np.int32)
    needs = bool(rng.random_sample() < 0.8)
    ref = ref_numa.numa_admit_row(req, jnp.bool_(needs), free, policy)
    out = numa.numa_admit_row(_t(req), torch.tensor(needs), _t(free),
                              _t(policy))
    return ref, out


def case_cpuset_filter_row(rng):
    needs, full = bool(rng.random_sample() < 0.8), bool(rng.randint(2))
    cores = np.float32(rng.randint(1, 9))
    topo = rng.random_sample(N) < 0.7
    bind_free = _ints(rng, 0, 12, (N,))
    cpc = rng.randint(0, 3, size=N).astype(np.float32)
    ref = ref_numa.cpuset_filter_row(jnp.bool_(needs), cores, jnp.bool_(full),
                                     topo, bind_free, cpc)
    out = numa.cpuset_filter_row(torch.tensor(needs), torch.tensor(cores),
                                 torch.tensor(full), _t(topo), _t(bind_free),
                                 _t(cpc))
    return ref, out


def case_numa_spread_fill(rng):
    free = _ints(rng, 0, 40, (K, R))
    req = _ints(rng, 0, 60, (R,))
    zone = rng.randint(-1, K)
    ref = ref_numa.numa_spread_fill(free, req, jnp.int32(zone))
    out = numa.numa_spread_fill(_t(free), _t(req),
                                torch.tensor(zone, dtype=torch.int32))
    return ref, out


def case_numa_score_row(rng):
    req = _ints(rng, 0, 30, (R,))
    requested = _ints(rng, 0, 150, (N, R))
    alloc = _ints(rng, 0, 200, (N, R), 0.1)
    weights = rng.randint(0, 4, size=R).astype(np.float32)
    widx = tuple(int(i) for i in np.nonzero(weights)[0])
    ref = ref_numa.numa_score_row(req, requested, alloc, weights, widx)
    out = numa.numa_score_row(_t(req), _t(requested), _t(alloc), _t(weights),
                              widx)
    return ref, out


def case_quota_admit_row(rng):
    anc, used, runtime = _quota_tree(rng)
    req = _ints(rng, 0, 30, (R,))
    qid = rng.randint(-1, anc.shape[0])
    ref = ref_quota.quota_admit_row(req, jnp.int32(qid), anc, used, runtime)
    out = quota.quota_admit_row(_t(req), torch.tensor(qid, dtype=torch.int32),
                                _t(anc), _t(used), _t(runtime))
    return ref, out


def case_quota_used_add_row(rng):
    anc, used, _runtime = _quota_tree(rng)
    req = _ints(rng, 0, 30, (R,))
    qid = rng.randint(-1, anc.shape[0])
    apply = bool(rng.random_sample() < 0.8)
    ref = ref_quota.quota_used_add_row(used, req, jnp.int32(qid), anc,
                                       jnp.bool_(apply))
    out = quota.quota_used_add_row(_t(used), _t(req),
                                   torch.tensor(qid, dtype=torch.int32),
                                   _t(anc), torch.tensor(apply))
    return ref, out


def case_gang_permit_mask(rng):
    P, NG, NGROUP = 40, 6, 4
    chosen = rng.randint(-1, N, size=P).astype(np.int32)
    gang_id = rng.randint(-1, NG, size=P).astype(np.int32)
    min_member = rng.randint(1, 6, size=NG).astype(np.float32)
    assumed = rng.randint(0, 3, size=NG).astype(np.float32)
    group = rng.randint(0, NGROUP, size=NG).astype(np.int32)
    args = (chosen, gang_id, min_member, assumed, group)
    ref = ref_gang.gang_permit_mask(*args, NG, NGROUP)
    out = gang.gang_permit_mask(*map(_t, args), NG, NGROUP)
    return ref, out


def case_fit_ok_row(rng):
    req = _ints(rng, 0, 30, (R,))
    alloc, requested = _ints(rng, 0, 200, (N, R)), _ints(rng, 0, 190, (N, R))
    return (ref_fit(req, alloc, requested),
            fit_ok_row(_t(req), _t(alloc), _t(requested)))


def case_least_requested_and_reciprocal(rng):
    used, cap = _ints(rng, 0, 250, (N,)), _ints(rng, 0, 200, (N,), 0.2)
    return ((ref_lrs(used, cap), ref_recip(cap)),
            (least_requested_score(_t(used), _t(cap)), safe_reciprocal(_t(cap))))


CASES = {f.__name__[5:]: f for f in (
    case_loadaware_node_reject, case_numa_admit_row, case_cpuset_filter_row,
    case_numa_spread_fill, case_numa_score_row, case_quota_admit_row,
    case_quota_used_add_row, case_gang_permit_mask, case_fit_ok_row,
    case_least_requested_and_reciprocal)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", sorted(CASES))
def test_op_matches_reference(op, seed):
    ref, out = CASES[op](np.random.RandomState(seed))
    if not isinstance(ref, tuple):
        ref, out = (ref,), (out,)
    for r, o in zip(ref, out):
        r, o = np.asarray(r), o.numpy()
        assert r.shape == o.shape, (op, r.shape, o.shape)
        if r.dtype == np.bool_ or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(o.astype(r.dtype), r)
        else:
            np.testing.assert_allclose(o, r, rtol=0, atol=0)
