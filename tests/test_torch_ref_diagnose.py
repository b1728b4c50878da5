"""test_diagnose.py's cases on the port.

The attribution pass takes the batch as the port's tensors (models/
convert.py to_device, on the CPU) and its state as the port's
cycle_start_state: the port's explain_stage_counts builds the round's
predicates itself and takes no evaluator.
"""

from __future__ import annotations

import test_torch_cases as torch_cases

torch_cases.export(torch_cases.port_module("test_diagnose", [
    ("""    fc = jax.tree_util.tree_map(jnp.asarray, fc)
    evaluate = make_pod_evaluator(
        fc, resolve_weight_idx(LoadAwareArgs(), list(range(R))), False)
    state = (fc.base.requested, fc.numa_free, fc.bind_free, fc.quota_used,
             fc.aff_count, fc.anti_cover, jnp.asarray(fc.aff_exists, bool),
             fc.port_used, fc.vol_free)
    return np.asarray(explain_stage_counts(fc, evaluate, state,
                                           np.int32(N)))""",
     """    fc = to_device(fc, "cpu")
    return np.asarray(explain_stage_counts(fc, cycle_start_state(fc), N))"""),
    torch_cases.after_import(
        "numpy as np",
        torch_cases.TO_DEVICE
        + "from koordinator_tpu.models.full_chain import cycle_start_state\n"),
]), globals())
