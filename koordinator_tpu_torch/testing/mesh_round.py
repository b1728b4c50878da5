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

``check_exchange`` holds the instances over a mesh of cards (parallel/
full_chain_mesh.py's exchange route) against the single-device kernels at
D = 2, 4 and 8 virtual cards of this one card, all D shards as clusters of
one launch, which exchange through the card's own memory by the protocol
that crosses NVLink between cards: kernel 1's round and terms instances
(chosen before Permit, requested, quota_used, the terms rows), the per-card
replay against the replay instance, the per-card stage counts against the
stage-count pass and kernel 2's exchange instance against kernel 2, bit for
bit. ``check_timeout`` launches shard 0 of a D = 2 exchange alone: it must
end within the time limit with ExchangeTimeout naming shard 1, and the
card must take the next launch.
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
# the virtual cards of the exchange checks: one launch holds every shard
EXCHANGE_DEPTHS = (2, 4, 8)


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


def _cards_of(nt, mesh, per: int, rows):
    """[(device, shards, view)] of every card of ``mesh``: ``nt``'s rows
    of the card's shards (``rows(nt, lo, hi)`` cuts them; a card's shards
    are consecutive), on the card."""
    from koordinator_tpu_torch.parallel.mesh import card_view

    out = []
    for dev, ks in mesh.card_shards():
        if ks != list(range(ks[0], ks[-1] + 1)):
            raise ValueError(f"the shards {ks} of {dev} are not consecutive")
        part = rows(nt, ks[0] * per, (ks[-1] + 1) * per)
        out.append((dev, ks, card_view(part, ks, dev)))
    return out


def _schedule_rows(inputs, lo: int, hi: int):
    from koordinator_tpu_torch.parallel.mesh import _SCHEDULE_POD_FIELDS

    return inputs._replace(**{k: v[lo:hi] for k, v in inputs._asdict().items()
                              if k not in _SCHEDULE_POD_FIELDS})


def exchanging_mesh(depth: int, device="cuda"):
    """``depth`` virtual cards of one card, exchanging: every shard a
    cluster of one launch, through the card's own memory."""
    mesh = virtual_mesh(depth, device)
    mesh.exchange = True
    return mesh


def check_exchange(fc_host, args, ng: int, ngroups: int, active,
                   n_real: int, inputs_host: ScheduleInputs,
                   depths: Sequence[int] = EXCHANGE_DEPTHS,
                   device="cuda", meshes=None) -> List[dict]:
    """The instances over a mesh of cards against the single-device
    kernels (on the first card) on the same padded tensors: kernel 1's
    round and terms round, its per-card replay (the kept pods of the terms
    round after Permit, from the cycle-start state), the per-card stage
    counts and kernel 2's exchange instance. ``meshes``: the meshes to
    check (default: ``depths`` virtual cards of this card). Every
    mismatch count must be 0; on the first mesh each pair is timed (CUDA
    events, median of 10)."""
    from koordinator_tpu_torch.models.convert import (
        schedule_inputs_from_numpy,
    )
    from koordinator_tpu_torch.ops import explain_kernel as ek
    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.ops import schedule_kernel as sk
    from koordinator_tpu_torch.parallel.full_chain_mesh import (
        _STATE_NODE_SLOTS,
        gather_dom_rows,
        node_rows,
        replay_state0,
    )
    from koordinator_tpu_torch.parallel.mesh import (
        _SCHEDULE_POD_FIELDS,
        card_view,
    )

    widx = resolve_weight_idx(args, active)
    bal = resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    la_widx = resolve_weight_idx(args)
    if meshes is None:
        meshes = [exchanging_mesh(d, device) for d in depths]
    out = []
    for mesh in meshes:
        depth = mesh.size
        dev0 = mesh.flat[0].device
        fc = to_device(_padded_fc(fc_host, mesh), dev0)
        N = fc.base.allocatable.shape[0]
        per = N // depth
        box = mesh.mailboxes()
        cards = _cards_of(fc, mesh, per, node_rows)
        jobs = [(v, ks) for _d, ks, v in cards]
        row = {"depth": depth, "cards": len(cards), "n_padded": N,
               "per": per}

        def merged(parts):
            """A node-axis output's cards, in shard order, on card 0."""
            return torch.cat([t.to(dev0) for t in parts])

        c1, r1, q1, t1 = fk.full_chain_round(fc, widx, prod, bal, terms=True)
        outs = fk.full_chain_round_cards(jobs, widx, prod, bal, box,
                                         terms=True)
        last = dict(fk.last_launch)
        row["terms_mismatches"] = sum(
            _mismatches(c1.cpu(), o[0].cpu()) + _mismatches(q1.cpu(),
                                                             o[2].cpu())
            + _mismatches(t1.cpu(), o[3].cpu()) for o in outs) + _mismatches(
                r1.cpu(), merged([o[1] for o in outs]).cpu())
        c0, r0, q0 = fk.full_chain_round(fc, widx, prod, bal)
        outs = fk.full_chain_round_cards(jobs, widx, prod, bal, box)
        row["round_mismatches"] = sum(
            _mismatches(c0.cpu(), o[0].cpu()) + _mismatches(q0.cpu(),
                                                             o[2].cpu())
            for o in outs) + _mismatches(
                r0.cpu(), merged([o[1] for o in outs]).cpu())
        row["bound"] = int((c0 >= 0).sum())
        row["launch"] = {k: last[k] for k in ("cluster_size", "block_threads",
                                               "state", "shards")}

        kept = permit(fc, c1, ng, ngroups) >= 0
        state0 = replay_state0(fc, prod)
        s1, z1 = fk.full_chain_replay(fc, c1, kept, state0, prod)
        doms = gather_dom_rows([(v, ks) for _d, ks, v in cards], c1, kept,
                               per)
        rjobs = [(v, ks, c1.to(d), kept.to(d),
                  tuple(card_view(t, ks, d) for t in _state_rows(
                      state0, ks[0] * per, (ks[-1] + 1) * per)), dom)
                 for (d, ks, v), dom in zip(cards, doms)]
        routs = fk.full_chain_replay_cards(rjobs, prod, depth)
        zones = routs[0][1]
        for _st, z in routs[1:]:
            zones = torch.maximum(zones, z.to(zones.device))
        bad = _mismatches(z1.cpu(), zones.cpu())
        for i, a in enumerate(s1):
            parts = [o[0][i] for o in routs]
            b = merged(parts) if i in _STATE_NODE_SLOTS else parts[0]
            bad += _mismatches(a.cpu(), b.cpu())
        row["replay_mismatches"] = bad

        e1 = ek.explain_counts(fc, cycle_start_state(fc), n_real)
        views = [card_view(node_rows(fc, k * per, (k + 1) * per), [k],
                           mesh.flat[k].device) for k in range(depth)]
        shards = [(v, cycle_start_state(v), k * per)
                  for k, v in enumerate(views)]
        e2 = ek.explain_counts_shards(shards, n_real)
        row["counts_mismatches"] = _mismatches(e1.cpu(), e2.cpu())

        node = NamedSharding(mesh, _node_axis_spec(mesh, flat=True))
        padded = {k: (v if k in _SCHEDULE_POD_FIELDS
                      else pad_for_sharding(v, node))
                  for k, v in inputs_host._asdict().items()}
        inputs = schedule_inputs_from_numpy(padded, dev0)
        la_jobs = [(v, ks) for _d, ks, v in _cards_of(inputs, mesh, per,
                                                       _schedule_rows)]
        lc, lr = sk.schedule_round(inputs, la_widx, prod)
        louts = sk.schedule_round_cards(la_jobs, la_widx, prod, box)
        row["loadaware_mismatches"] = sum(
            _mismatches(lc.cpu(), o[0].cpu()) for o in louts) + _mismatches(
                lr.cpu(), merged([o[1] for o in louts]).cpu())

        if mesh is not meshes[0]:
            out.append(row)
            continue
        row["terms_single_ms"] = time_ms(
            lambda: fk.full_chain_round(fc, widx, prod, bal, terms=True))
        row["terms_xchg_ms"] = time_ms(lambda: fk.full_chain_round_cards(
            jobs, widx, prod, bal, box, terms=True))
        row["round_single_ms"] = time_ms(
            lambda: fk.full_chain_round(fc, widx, prod, bal))
        row["round_xchg_ms"] = time_ms(
            lambda: fk.full_chain_round_cards(jobs, widx, prod, bal, box))
        row["replay_single_ms"] = time_ms(
            lambda: fk.full_chain_replay(fc, c1, kept, state0, prod))
        row["replay_cards_ms"] = time_ms(
            lambda: fk.full_chain_replay_cards(rjobs, prod, depth))
        row["counts_single_ms"] = time_ms(
            lambda: ek.explain_counts(fc, cycle_start_state(fc), n_real))
        row["counts_shards_ms"] = time_ms(
            lambda: ek.explain_counts_shards(shards, n_real))
        row["loadaware_single_ms"] = time_ms(
            lambda: sk.schedule_round(inputs, la_widx, prod))
        row["loadaware_xchg_ms"] = time_ms(
            lambda: sk.schedule_round_cards(la_jobs, la_widx, prod, box))
        out.append(row)
    return out


def _state_rows(state, lo: int, hi: int):
    """A replay 11-tuple with its node-axis slots cut to rows [lo, hi)."""
    from koordinator_tpu_torch.parallel.full_chain_mesh import (
        _STATE_NODE_SLOTS,
    )

    return tuple(t[lo:hi] if i in _STATE_NODE_SLOTS and t is not None
                 else t for i, t in enumerate(state))


def check_timeout(fc_host, args, active, device="cuda", mesh=None) -> dict:
    """The first card's launch of an exchange alone (default: shard 0 of
    2 virtual cards of this card): the round must end (no trap) with
    ExchangeTimeout naming every other shard once the exchange's time
    limit (ops/kernel_common.EXCHANGE_TIMEOUT_S) has passed, and the card
    must run the next launch (the single-device round) to the same
    bindings as before."""
    import time

    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.ops.kernel_common import (
        EXCHANGE_TIMEOUT_S,
        ExchangeTimeout,
    )
    from koordinator_tpu_torch.parallel.full_chain_mesh import node_rows
    from koordinator_tpu_torch.parallel.mesh import card_view

    widx = resolve_weight_idx(args, active)
    bal = resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    if mesh is None:
        mesh = exchanging_mesh(2, device)
    dev0 = mesh.flat[0].device
    fc = to_device(_padded_fc(fc_host, mesh), dev0)
    per = fc.base.allocatable.shape[0] // mesh.size
    before = fk.full_chain_round(fc, widx, prod, bal)[0].cpu()
    _dev, ks = mesh.card_shards()[0]
    if len(mesh.card_shards()) == 1:
        ks = [0]
    alone = card_view(node_rows(fc, ks[0] * per, (ks[-1] + 1) * per), ks,
                      dev0)
    t0 = time.perf_counter()
    try:
        fk.full_chain_round_cards([(alone, ks)], widx, prod, bal,
                                  mesh.mailboxes())
    except ExchangeTimeout as exc:
        err = exc
    else:
        raise AssertionError("a lone card's round did not time out")
    seconds = time.perf_counter() - t0
    missing = [k for k in range(mesh.size) if k not in ks]
    if list(err.failed_shards) != missing:
        raise AssertionError(f"the timeout named {err.failed_shards}, not "
                             f"{missing}")
    after = fk.full_chain_round(fc, widx, prod, bal)[0].cpu()
    return {"timeout_s": EXCHANGE_TIMEOUT_S, "seconds": seconds,
            "failed_shards": list(err.failed_shards),
            "failed_device_ids": list(err.failed_device_ids),
            "next_launch_mismatches": _mismatches(before, after)}


# pods the exchange instances are held to their plain versions on (the
# plain sharded round takes ~10 ms a pod on the card at config 4)
PLAIN_PODS = 256


def _first_pods(fc, n: int):
    """``fc`` with only its first ``n`` valid pods valid."""
    valid = fc.base.pod_valid.to(torch.bool)
    keep = valid & (torch.cumsum(valid.to(torch.int64), 0) <= n)
    return fc._replace(base=fc.base._replace(pod_valid=keep))


def check_sharded_exchange(fc_host, args, ng: int, ngroups: int, active,
                           n_real: int, inputs_host: ScheduleInputs,
                           depth: int = 2, device="cuda",
                           plain_pods: int = PLAIN_PODS) -> dict:
    """The exchange route through its entry points on ``depth`` exchanging
    virtual cards: the sharded full-chain step (explain "full") and the
    sharded LoadAware step, with every launch count set to 0 just before
    and read just after (``launches``: the route's launches), against
    the single-device kernels; then each exchange instance against its
    plain version on the card (parallel/full_chain_mesh.py
    sharded_plain_round with its terms rows, sharded_replay_kept and
    sharded_stage_counts, parallel/mesh.py _plain_sharded_schedule), on
    the first ``plain_pods`` valid pods (the stage counts on every pod),
    each plain version timed once. Every mismatch count must be 0."""
    import time

    from koordinator_tpu_torch.models.convert import (
        schedule_inputs_from_numpy,
    )
    from koordinator_tpu_torch.ops import explain_kernel as ek
    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.ops import schedule_kernel as sk
    from koordinator_tpu_torch.parallel.full_chain_mesh import (
        _STATE_NODE_SLOTS,
        gather_dom_rows,
        node_rows,
        replay_state0,
        sharded_plain_round,
        sharded_replay_kept,
        sharded_stage_counts,
    )
    from koordinator_tpu_torch.parallel.mesh import (
        _SCHEDULE_POD_FIELDS,
        _plain_sharded_schedule,
        card_view,
        replicate,
        split_nodes,
    )

    widx = resolve_weight_idx(args, active)
    bal = resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    la_widx = resolve_weight_idx(args)
    mesh = exchanging_mesh(depth, device)
    dev = mesh.flat[0].device
    fc = to_device(_padded_fc(fc_host, mesh), dev)
    per = fc.base.allocatable.shape[0] // depth
    sfc = shard_full_chain_inputs(fc_host, mesh)
    sin = shard_inputs_nodewise(inputs_host, mesh)
    step = build_sharded_full_chain_step(args, ng, ngroups, mesh,
                                         active_axes=active, explain="full")
    lstep = build_sharded_schedule_step(args, mesh)
    counters = ((fk, "launches"), (fk, "terms_launches"),
                (fk, "replay_launches"), (fk, "xchg_launches"),
                (fk, "xchg_terms_launches"), (fk, "xchg_replay_launches"),
                (ek, "launches"), (ek, "shard_launches"),
                (sk, "launches"), (sk, "xchg_launches"))
    for mod, name in counters:
        setattr(mod, name, 0)
    cs, rs, qs, ex = step(sfc, n_real)
    lc, lr = lstep(sin)
    torch.cuda.synchronize()
    launches = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod,
                                                                   name)
                for mod, name in counters}
    row = {"depth": depth, "launches": launches,
           "backends": [step.last_backend, lstep.last_backend]}
    if row["backends"] != ["cuda-exchange", "cuda-exchange"] or any(
            launches[k] for k in ("full_chain_kernel.launches",
                                  "explain_kernel.launches",
                                  "schedule_kernel.launches")):
        raise AssertionError(f"the exchange route did not run: {row}")

    c1, r1, q1, t1 = fk.full_chain_round(fc, widx, prod, bal, terms=True)
    e1 = ek.explain_counts(fc, cycle_start_state(fc), n_real)
    node = NamedSharding(mesh, _node_axis_spec(mesh, flat=True))
    padded = {k: (v if k in _SCHEDULE_POD_FIELDS
                  else pad_for_sharding(v, node))
              for k, v in inputs_host._asdict().items()}
    inputs = schedule_inputs_from_numpy(padded, dev)
    l1, lr1 = sk.schedule_round(inputs, la_widx, prod)
    row["step_mismatches"] = (
        _mismatches(permit(fc, c1, ng, ngroups).cpu(), cs.numpy())
        + _mismatches(r1.cpu(), rs) + _mismatches(q1.cpu(), qs.numpy())
        + _mismatches(t1.cpu(), ex.terms.numpy())
        + _mismatches(e1.cpu(), ex.stage_counts.numpy())
        + _mismatches(l1.cpu(), lc.numpy()) + _mismatches(lr1.cpu(), lr))

    # ---- each instance against its plain version on the card
    cut = _first_pods(fc, plain_pods)
    box = mesh.mailboxes()
    jobs = [(cut, list(range(depth)))]
    views = {k: card_view(node_rows(cut, k * per, (k + 1) * per), [k], dev)
             for k in range(depth)}
    (kc, kr, kq, kt), = fk.full_chain_round_cards(jobs, widx, prod, bal, box,
                                                  terms=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pc, states, pt = sharded_plain_round(views, mesh, per, widx, prod, bal,
                                         terms=True)
    torch.cuda.synchronize()
    row["round_plain_ms"] = (time.perf_counter() - t0) * 1e3
    pr = torch.cat([states[k][0] for k in range(depth)])
    row["round_plain_mismatches"] = (
        _mismatches(kc.cpu(), pc.cpu()) + _mismatches(kr.cpu(), pr.cpu())
        + _mismatches(kq.cpu(), states[0][5].cpu()))
    row["terms_plain_mismatches"] = _mismatches(kt.cpu(), pt.cpu())
    row["round_err"] = float(max(
        (kr - pr).abs().max(), (kq - states[0][5]).abs().max(),
        (kt - pt).abs().max()))

    kept = permit(cut, kc, ng, ngroups) >= 0
    state0 = replay_state0(cut, prod)
    state0 = state0[:2] + (torch.zeros_like(state0[0]),) + state0[3:]
    dom = gather_dom_rows([(cut, list(range(depth)))], kc, kept, per)[0]
    (ks, kz), = fk.full_chain_replay_cards(
        [(cut, list(range(depth)), kc, kept, state0, dom)], prod, depth)
    sstates = {k: _state_rows(state0, k * per, (k + 1) * per)
               for k in range(depth)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pstates, pz = sharded_replay_kept(views, mesh, per, prod, sstates, kc,
                                      kept)
    torch.cuda.synchronize()
    row["replay_plain_ms"] = (time.perf_counter() - t0) * 1e3
    row["replay_pods"] = int(kept.sum())
    bad = _mismatches(kz.cpu(), pz.cpu())
    err = 0.0
    for i, a in enumerate(ks):
        b = (torch.cat([pstates[k][i] for k in range(depth)])
             if i in _STATE_NODE_SLOTS else pstates[0][i])
        bad += _mismatches(a.cpu(), b.cpu())
        if a.dtype == torch.float32 and a.numel():
            err = max(err, float((a - b).abs().max()))
    row["replay_plain_mismatches"] = bad
    row["replay_err"] = err

    full_views = {k: card_view(node_rows(fc, k * per, (k + 1) * per), [k],
                               dev) for k in range(depth)}
    counts = ek.explain_counts_shards(
        [(full_views[k], cycle_start_state(full_views[k]), k * per)
         for k in range(depth)], n_real)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcounts = sharded_stage_counts(
        full_views, {k: cycle_start_state(v) for k, v in full_views.items()},
        mesh, per, n_real)
    torch.cuda.synchronize()
    row["counts_plain_ms"] = (time.perf_counter() - t0) * 1e3
    row["counts_plain_mismatches"] = _mismatches(counts.cpu(), pcounts.cpu())

    # the plain sharded LoadAware round walks every pod row: cut the rows
    lcut = inputs._replace(**{k: v[:plain_pods] for k, v in
                              inputs._asdict().items()
                              if k in _SCHEDULE_POD_FIELDS and k != "weights"})
    (xc, xr), = sk.schedule_round_cards([(lcut, list(range(depth)))],
                                        la_widx, prod, box)
    sin_cut = ScheduleInputs(**{
        k: (replicate(v, mesh) if k in _SCHEDULE_POD_FIELDS
            else split_nodes(v, mesh))
        for k, v in lcut._asdict().items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pc2, pr2 = _plain_sharded_schedule(sin_cut, mesh, la_widx, prod)
    torch.cuda.synchronize()
    row["loadaware_plain_ms"] = (time.perf_counter() - t0) * 1e3
    pr2 = np.asarray(pr2)
    row["loadaware_plain_mismatches"] = (
        _mismatches(xc.cpu(), pc2.local().cpu())
        + _mismatches(xr.cpu(), torch.from_numpy(pr2)))
    row["loadaware_err"] = float((xr.cpu() - torch.from_numpy(pr2)).abs()
                                 .max())
    row["plain_pods"] = plain_pods
    return row

