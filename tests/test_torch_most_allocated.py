"""NodeNUMAResource's mostAllocated scoring on the port against the JAX
package, on the CPU: ops/common.most_requested_score and
ops/numa.numa_score_row(most_allocated=True), on seeded numpy inputs with
zero capacities and requests past capacity. Packed integers below 2^24:
both sides run the same f32 operations in the same order, so the rows are
equal with atol=0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import common as ref_common
from koordinator_tpu.ops import numa as ref_numa

from koordinator_tpu_torch.ops import common, numa

N, R = 64, 5


def _world(seed):
    rng = np.random.RandomState(seed)
    cap = rng.randint(0, 400, size=(N, R)).astype(np.float32)
    cap[rng.random_sample((N, R)) < 0.2] = 0.0      # capacity 0
    used = rng.randint(0, 500, size=(N, R)).astype(np.float32)
    used[:8] = cap[:8] + 1.0                         # requested > capacity
    used[8:12] = cap[8:12]                           # requested == capacity
    request = rng.randint(0, 60, size=R).astype(np.float32)
    weights = rng.randint(0, 4, size=R).astype(np.float32)
    return cap, used, request, weights


@pytest.mark.parametrize("seed", range(4))
def test_most_requested_score_matches_jax(seed):
    cap, used, _, _ = _world(seed)
    ref = np.asarray(ref_common.most_requested_score(jnp.asarray(used),
                                                     jnp.asarray(cap)))
    out = common.most_requested_score(torch.from_numpy(used),
                                      torch.from_numpy(cap)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[(cap == 0) | (used > cap)] == 0).all()
    assert (out[8:12][cap[8:12] > 0] == 100).all()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("most_allocated", [False, True])
def test_numa_score_row_strategies_match_jax(seed, most_allocated):
    cap, used, request, weights = _world(seed)
    widx = tuple(int(r) for r in np.nonzero(weights)[0])
    ref = np.asarray(ref_numa.numa_score_row(
        jnp.asarray(request), jnp.asarray(used), jnp.asarray(cap),
        jnp.asarray(weights), widx, most_allocated=most_allocated))
    out = numa.numa_score_row(
        torch.from_numpy(request), torch.from_numpy(used),
        torch.from_numpy(cap), torch.from_numpy(weights), widx,
        most_allocated=most_allocated).numpy()
    np.testing.assert_array_equal(out, ref)


def test_most_allocated_prefers_the_fuller_node():
    cap = torch.tensor([[100.0], [100.0]])
    used = torch.tensor([[20.0], [70.0]])
    w = torch.ones(1)
    req = torch.tensor([10.0])
    least = numa.numa_score_row(req, used, cap, w, (0,))
    most = numa.numa_score_row(req, used, cap, w, (0,), most_allocated=True)
    assert least.tolist() == [70.0, 20.0]
    assert most.tolist() == [30.0, 80.0]
