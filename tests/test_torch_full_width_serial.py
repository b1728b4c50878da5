"""The Scheduler's serial dispatch (``waves=1``) at BASELINE config 4's full
width: the JAX package's decisions regenerated on the CPU.

``chip_smoke.py``'s ``scheduler`` phase runs ``Scheduler(store, waves=1,
device="cuda")`` over config 4's churn store (``churn_store(5000, 10000,
seed=42)``): cycle 0, then ``CHURN_WARMUP + CHURN_MEASURED`` churn cycles of
1000 arrivals. It fails unless the incremental world's outcome digest
(``testing/churn.outcome_sha``) equals ``CONFIG4_SERIAL_JAX_SHA256``.

Here the JAX package's ``Scheduler(waves=1, explain="off", mesh="off",
warmup="off")`` over the twin store, on the same cycles, regenerates that pin.
The port's own serial run at this width stays on the card: on the CPU its
round is the plain round's per-pod loop.
"""

from __future__ import annotations

import chip_smoke
from test_torch_full_width_waves import NODES, PODS, SEED, ref_drive

from koordinator_tpu_torch.testing.churn import outcome_sha

CHURN = chip_smoke.CHURN_WARMUP + chip_smoke.CHURN_MEASURED


def test_serial_path_pin_is_the_jax_package():
    keys, waves, store = ref_drive(NODES, PODS, SEED, CHURN, PODS // 10,
                                   waves=1)
    assert waves == [1] * (1 + CHURN)
    assert all(k[0] for k in keys)
    assert outcome_sha(keys, store) == chip_smoke.CONFIG4_SERIAL_JAX_SHA256


def test_pack_overlap_parity_on_the_churn_world():
    """chip_smoke.py's pack_overlap phase at config 4, cut to 16 x 300 on
    the CPU: the churn store and its arrivals at the Scheduler's default
    waves, every upload compared by its digest, rows pre-packed."""
    from koordinator_tpu_torch.scheduler import pipeline_parity
    from koordinator_tpu_torch.testing.churn import churn_store

    def world():
        store, state = churn_store(16, 300, seed=1)
        return state, store

    report = pipeline_parity.run_pack_overlap_parity(
        waves=None, rounds=2, device="cpu", world=world, churn_arrivals=150)
    assert report["ok"], report["mismatches"]
    assert report["encodes_compared"] > 3
    assert report["prepacked_rows"] > 0 and report["prepack_failures"] == 0
