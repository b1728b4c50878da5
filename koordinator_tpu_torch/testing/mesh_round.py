"""The sharded steps against the single-device kernels, on the card.

For each mesh depth D, the batch goes onto a mesh of D virtual shards of
the card (parallel/mesh.py; node fields padded to a multiple of D, then
split) and through the sharded steps, which on the card gather the node
fields and launch the single-device kernels: the full-chain step with
explain "full" (kernel 1, its terms instance and the stage-count pass) and
the LoadAware step (kernel 2). Each output is held against the
single-device kernels' on the same padded tensors, mismatch by mismatch
(0 is the gate), and both are timed with CUDA events
(testing/kernel_ab.time_ms: median of 10 after a warm-up), so the gather
and split are what the times differ by. ``chip_smoke.py``'s ``mesh_round``
phase runs it at config 4 and at the LoadAware headline.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import (
    cycle_start_state,
    permit,
    resolve_balance_idx,
)
from koordinator_tpu_torch.models.scheduler_model import (
    ScheduleInputs,
    resolve_weight_idx,
)
from koordinator_tpu_torch.parallel.full_chain_mesh import (
    build_sharded_full_chain_step,
    shard_full_chain_inputs,
)
from koordinator_tpu_torch.parallel.mesh import (
    MeshDevice,
    NamedSharding,
    _node_axis_spec,
    build_sharded_schedule_step,
    make_mesh,
    pad_for_sharding,
    shard_inputs_nodewise,
)
from koordinator_tpu_torch.testing.kernel_ab import time_ms

DEPTHS = (1, 2, 3, 4, 8)


def virtual_mesh(depth: int, device="cuda"):
    """A mesh of ``depth`` shard devices on one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return make_mesh([MeshDevice(k, dev) for k in range(depth)])


def _mismatches(a, b) -> int:
    """Elements whose bits differ (every element when the shapes or dtypes
    differ)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.size, b.size)
    if a.dtype == np.bool_:
        return int((a != b).sum())
    bits = np.dtype(f"u{a.itemsize}")
    return int((a.view(bits) != b.view(bits)).sum())


def _padded_fc(fc_host, mesh):
    """The host batch with its node fields padded as put_on_mesh pads them
    (the single-device kernel's inputs for this depth)."""
    from koordinator_tpu_torch.parallel.full_chain_mesh import _FC_NODE_FIELDS
    from koordinator_tpu_torch.parallel.mesh import _SCHEDULE_POD_FIELDS

    node = NamedSharding(mesh, _node_axis_spec(mesh, flat=True))
    base = type(fc_host.base)(**{
        k: (v if k in _SCHEDULE_POD_FIELDS else pad_for_sharding(v, node))
        for k, v in fc_host.base._asdict().items()})
    rest = {k: (pad_for_sharding(v, node) if k in _FC_NODE_FIELDS else v)
            for k, v in fc_host._asdict().items() if k != "base"}
    return type(fc_host)(base=base, **rest)


def check_full_chain(fc_host, args, ng: int, ngroups: int, active,
                     n_real: int, depths: Sequence[int] = DEPTHS,
                     device="cuda") -> List[dict]:
    """The sharded full-chain step (explain "full") against kernel 1, its
    terms instance, Permit and the stage-count pass on one device, at each
    depth. ``fc_host``: the packed batch (numpy FullChainInputs),
    ``active`` its active axes."""
    from koordinator_tpu_torch.ops import explain_kernel as ek
    from koordinator_tpu_torch.ops import full_chain_kernel as fk

    widx = resolve_weight_idx(args, active)
    bal = resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    out = []
    for depth in depths:
        mesh = virtual_mesh(depth, device)
        fc = to_device(_padded_fc(fc_host, mesh), device)
        sfc = shard_full_chain_inputs(fc_host, mesh)
        step = build_sharded_full_chain_step(args, ng, ngroups, mesh,
                                             active_axes=active,
                                             explain="full")
        N = fc.base.allocatable.shape[0]
        row = {"depth": depth, "n_padded": N, "per": N // depth}

        c1, r1, q1, t1 = fk.full_chain_round(fc, widx, prod, bal,
                                             terms=True)
        c1 = permit(fc, c1, ng, ngroups)
        e1 = ek.explain_counts(fc, cycle_start_state(fc), n_real)
        cs, rs, qs, ex = step(sfc, n_real)
        row["round_mismatches"] = (
            _mismatches(c1.cpu(), cs.numpy()) + _mismatches(r1.cpu(), rs)
            + _mismatches(q1.cpu(), qs.numpy()))
        row["terms_mismatches"] = _mismatches(t1.cpu(), ex.terms.numpy())
        row["counts_mismatches"] = _mismatches(e1.cpu(),
                                               ex.stage_counts.numpy())
        row["bound"] = int((c1 >= 0).sum())

        def single():
            fk.full_chain_round(fc, widx, prod, bal, terms=True)
            ek.explain_counts(fc, cycle_start_state(fc), n_real)

        row["single_ms"] = time_ms(single)
        row["sharded_ms"] = time_ms(lambda: step(sfc, n_real))
        out.append(row)
    return out


def check_schedule(inputs_host: ScheduleInputs, args,
                   depths: Sequence[int] = DEPTHS,
                   device="cuda") -> List[dict]:
    """The sharded LoadAware step against kernel 2 on one device, at each
    depth."""
    from koordinator_tpu_torch.models.convert import (
        schedule_inputs_from_numpy,
    )
    from koordinator_tpu_torch.ops import schedule_kernel as sk
    from koordinator_tpu_torch.parallel.mesh import _SCHEDULE_POD_FIELDS

    widx = resolve_weight_idx(args)
    prod = args.score_according_prod_usage
    out = []
    for depth in depths:
        mesh = virtual_mesh(depth, device)
        node = NamedSharding(mesh, _node_axis_spec(mesh, flat=True))
        padded = {k: (v if k in _SCHEDULE_POD_FIELDS
                      else pad_for_sharding(v, node))
                  for k, v in inputs_host._asdict().items()}
        inputs = schedule_inputs_from_numpy(padded, device)
        sin = shard_inputs_nodewise(inputs_host, mesh)
        step = build_sharded_schedule_step(args, mesh)
        c1, r1 = sk.schedule_round(inputs, widx, prod)
        cs, rs = step(sin)
        row = {"depth": depth, "n_padded": inputs.allocatable.shape[0],
               "bound": int((c1 >= 0).sum()),
               "mismatches": (_mismatches(c1.cpu(), cs.numpy())
                              + _mismatches(r1.cpu(), rs.numpy()))}
        row["single_ms"] = time_ms(
            lambda: sk.schedule_round(inputs, widx, prod))
        row["sharded_ms"] = time_ms(lambda: step(sin))
        out.append(row)
    return out
