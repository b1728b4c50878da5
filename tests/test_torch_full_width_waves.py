"""The Scheduler's default path at BASELINE config 4's full width, held to
the JAX package's own decisions.

``chip_smoke.py``'s ``scheduler_waves`` phase runs the port's default path
(auto waves, chained dispatch) on the card over config 4's churn store
(``churn_store(5000, 10000, seed=42)``): cycle 0, then
``WAVE_CHURN_WARMUP + WAVE_CHURN_MEASURED`` churn cycles of 1000 arrivals.
It fails unless the outcome's digest (``testing/churn.outcome_sha``: every
cycle's bindings in order, its failed and rejected lists, and every pod's
PodScheduled condition) equals ``CONFIG4_WAVES_JAX_SHA256``, and each
cycle's ``CycleResult.waves`` equals ``CONFIG4_WAVES_JAX_WAVES``.

Here, on the CPU: the JAX package's ``Scheduler(explain="off", mesh="off",
warmup="off")`` over the twin store regenerates both pins, and the port's
``Scheduler(device="cpu")`` (the plain wave step) over the same cycles must
give the pinned digest. At 16 nodes x 300 pods the digest is shown to be
package-neutral: the same functions over a JAX run's store and the port's
give one value.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import chip_smoke
from koordinator_tpu.api import objects as ref_objects
from koordinator_tpu.api.resources import ResourceList as RefResourceList
from koordinator_tpu.client.store import ObjectStore as RefObjectStore
from koordinator_tpu.scheduler.cycle import Scheduler as RefScheduler
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.scheduler.cycle import Scheduler
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    churn_store,
    conditions,
    drive_churn,
    outcome_sha,
    round_sha,
    store_from_state,
)

NODES, PODS, SEED = 5000, 10000, 42
CHURN = chip_smoke.WAVE_CHURN_WARMUP + chip_smoke.WAVE_CHURN_MEASURED


def ref_add(store, specs, created):
    """add_arrivals for the JAX package's store."""
    add_arrivals(store, specs, created, objects=ref_objects,
                 resource_list=RefResourceList)


def ref_churn_store(nodes, pods, seed):
    """The JAX package's twin of testing/churn.churn_store."""
    _cluster, state = ref_synth(nodes, pods, seed=seed,
                                num_quotas=max(8, pods // 100),
                                num_gangs=max(4, pods // 50))
    return store_from_state(state, RefObjectStore()), state


def ref_drive(nodes, pods, seed, churn_cycles, arrivals, **kw):
    """The JAX package's Scheduler over its churn store -> (keys, waves,
    store)."""
    store, state = ref_churn_store(nodes, pods, seed)
    sched = RefScheduler(store, explain="off", mesh="off", warmup="off", **kw)
    keys, waves = drive_churn(sched, store, state.now, churn_cycles,
                              arrivals, add=ref_add)
    return keys, waves, store


@functools.lru_cache(maxsize=None)
def jax_default_path():
    """(outcome digest, waves per cycle) of the JAX package's default path
    over scheduler_waves' cycles at config 4."""
    keys, waves, store = ref_drive(NODES, PODS, SEED, CHURN, PODS // 10)
    return outcome_sha(keys, store), tuple(waves)


def test_default_path_pin_is_the_jax_package():
    sha, waves = jax_default_path()
    assert sha == chip_smoke.CONFIG4_WAVES_JAX_SHA256
    assert waves == chip_smoke.CONFIG4_WAVES_JAX_WAVES


def test_port_cpu_default_path_gives_the_pin():
    """The port's default path on the CPU (the plain wave step) at config
    4's full width decides as the JAX package does."""
    store, state = churn_store(NODES, PODS, seed=SEED)
    sched = Scheduler(store, device="cpu")
    keys, waves = drive_churn(sched, store, state.now, CHURN, PODS // 10)
    assert sched.last_backend == "serial"
    assert tuple(waves) == chip_smoke.CONFIG4_WAVES_JAX_WAVES
    assert outcome_sha(keys, store) == chip_smoke.CONFIG4_WAVES_JAX_SHA256


@pytest.mark.parametrize("waves", [1, "auto"])
def test_outcome_digest_is_package_neutral(waves):
    """At 16 x 300 the digest reads either package's run alike: one value
    for the JAX run and the port's, over every condition written."""
    nodes, pods, seed, arrivals = 16, 300, 1, 150
    ref_keys, ref_waves, ref_store = ref_drive(nodes, pods, seed, 2,
                                               arrivals, waves=waves)
    store, state = churn_store(nodes, pods, seed=seed)
    sched = Scheduler(store, waves=waves, device="cpu")
    keys, got_waves = drive_churn(sched, store, state.now, 2, arrivals)
    assert (keys, got_waves) == (ref_keys, ref_waves)
    assert conditions(store) == conditions(ref_store)
    assert len(conditions(store)) > 0
    assert outcome_sha(keys, store) == outcome_sha(ref_keys, ref_store)
    # a changed condition moves the digest
    pod = next(p for p in store.list("Pod")
               if p.get_condition("PodScheduled") is not None)
    pod.get_condition("PodScheduled").message += "."
    assert outcome_sha(keys, store) != outcome_sha(ref_keys, ref_store)


def test_round_digest_is_package_neutral():
    """round_sha reads a numpy array, a JAX array and a torch tensor of
    one chosen vector alike, as little-endian int32."""
    import jax.numpy as jnp
    import torch

    chosen = np.array([3, -1, 0, 2 ** 31 - 1], dtype=np.int32)
    want = round_sha(chosen)
    assert round_sha(jnp.asarray(chosen)) == want
    assert round_sha(torch.from_numpy(chosen)) == want
    assert round_sha(chosen.astype(np.int64)) == want
    assert round_sha(chosen[::-1]) != want
