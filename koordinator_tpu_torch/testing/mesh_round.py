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

The instances over a mesh of cards (parallel/full_chain_mesh.py's
exchange route) have one harness, for a mesh held by one process or by
several: ``run_checks`` runs them over this process's part of a mesh
(kernel 1's round and terms instances, the per-card replay, the per-card
stage counts, kernel 2's exchange instance, the score matrix, the wave
steps over the card route, the timeout), ``reference`` runs the
single-device kernels and steps on the same padded batch, and ``compare``
holds every process's outputs against it, bit for bit
(testing/xproc_cards.py starts the processes). ``check_exchange`` runs
them at D = 2, 4 and 8 virtual cards of this one card, all D shards as
clusters of one launch, which exchange through the card's own memory by
the protocol that crosses NVLink between cards. ``check_timeout`` launches
the first card (of one card: shard 0) of an exchange alone: it must end
within the time limit with ExchangeTimeout naming every other shard, and
every card must take the next launch. ``check_deadline`` launches shard 1
late, behind a spin near the (shortened) time limit, so that shard 0's
blocks, each timing its own wait, may disagree about an entry that
arrives at the deadline: every launch group must end with ExchangeTimeout
or with the single-device bindings, never a trap. ``check_claim_view``
holds kernel 1's exchange round over a hot-claim world's per-card volume
view (the wave body's, parallel/full_chain_mesh.CardBackend.claim_view)
against the single-device round over the [P, N] view.
"""

from __future__ import annotations

import hashlib
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
    ShardedTensor,
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
    """[(device, shards, view)] of every card of ``mesh`` that this
    process holds: ``nt``'s rows of the card's shards (``rows(nt, lo,
    hi)`` cuts them; a card's shards are consecutive), on the card."""
    from koordinator_tpu_torch.parallel.mesh import card_view

    out = []
    for dev, ks in mesh.local_card_shards():
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


def check_counts_cards(fc_host, mesh) -> dict:
    """The per-card stage counts (ops/explain_kernel.explain_counts_shards:
    each card's rows, the spread minima and the counts added into buffers
    on the first card) on ``mesh`` against the one-card pass and the plain
    sharded_stage_counts, both on the first card, over every row and a cut
    below it; then the per-card pass timed (CUDA events, median of 10)."""
    from koordinator_tpu_torch.ops import explain_kernel as ek
    from koordinator_tpu_torch.parallel.full_chain_mesh import (
        node_rows,
        sharded_stage_counts,
    )
    from koordinator_tpu_torch.parallel.mesh import card_view

    depth = mesh.size
    dev0 = mesh.flat[0].device
    fc = to_device(_padded_fc(fc_host, mesh), dev0)
    N = fc.base.allocatable.shape[0]
    per = N // depth
    rows = {k: node_rows(fc, k * per, (k + 1) * per) for k in range(depth)}
    views = {k: card_view(v, [k], mesh.flat[k].device)
             for k, v in rows.items()}
    shards = [(views[k], cycle_start_state(views[k]), k * per)
              for k in range(depth)]
    out = {"depth": depth, "cards": len(mesh.cards), "n_padded": N,
           "T": int(fc.aff_dom.shape[1]),
           "spread_pods": int((fc.pod_spread_skew > 0).any(1).sum()),
           "mismatches": 0}
    for n_real in (N, N - 7):
        one = ek.explain_counts(fc, cycle_start_state(fc), n_real)
        got = ek.explain_counts_shards(shards, n_real)
        plain = sharded_stage_counts(
            rows, {k: cycle_start_state(v) for k, v in rows.items()}, mesh,
            per, n_real)
        out["mismatches"] += _mismatches(got.cpu(), one.cpu()) + _mismatches(
            got.cpu(), plain.cpu())
    out["counts_shards_ms"] = time_ms(
        lambda: ek.explain_counts_shards(shards, N))
    out["counts_single_ms"] = time_ms(
        lambda: ek.explain_counts(fc, cycle_start_state(fc), N))
    return out


def _state_rows(state, lo: int, hi: int):
    """A replay 11-tuple with its node-axis slots cut to rows [lo, hi)."""
    from koordinator_tpu_torch.parallel.full_chain_mesh import (
        _STATE_NODE_SLOTS,
    )

    return tuple(t[lo:hi] if i in _STATE_NODE_SLOTS and t is not None
                 else t for i, t in enumerate(state))


def check_deadline(fc_host, args, active, device="cuda", trials=48,
                   timeout_s=20e-3, band_s=20e-6) -> dict:
    """Kernel 1's round over D = 2 virtual cards of this card, each shard
    a launch of its own on a stream of its own, shard 1's behind a spin
    (torch.cuda._sleep, queued before either launch) of about the
    exchange's time limit, shortened to ``timeout_s`` (which still covers
    the host's time to queue both launches). A coarse pass and a bisection find the spin at which
    shard 0's first wait starts to time out; then ``trials`` spins spread
    over +-``band_s`` around it plant shard 1's first entries at the
    deadline, where the blocks of shard 0's cluster, each timing its own
    wait, may disagree. Every launch group must end with ExchangeTimeout
    or with both shards' chosen equal to the single-device round's (no
    trap), and the card must then run the single-device round to the same
    bindings as before. Reports the counts of each outcome."""
    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.ops.kernel_common import ExchangeTimeout
    from koordinator_tpu_torch.parallel.full_chain_mesh import node_rows
    from koordinator_tpu_torch.parallel.mesh import card_view

    widx = resolve_weight_idx(args, active)
    bal = resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    mesh = exchanging_mesh(2, device)
    dev = mesh.flat[0].device
    fc = to_device(_padded_fc(fc_host, mesh), dev)
    per = fc.base.allocatable.shape[0] // 2
    P = fc.base.fit_requests.shape[0]
    before = fk.full_chain_round(fc, widx, prod, bal)[0].cpu()
    views = [card_view(node_rows(fc, k * per, (k + 1) * per), [k], dev)
             for k in range(2)]
    box = mesh.mailboxes()
    box.ensure(fk.payload_words(fc.aff_dom.shape[1]))
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    # the spin's cycles per second, from one timed spin
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10**7)
        stop.record()
        stop.synchronize()
    hz = 10**7 / (start.elapsed_time(stop) * 1e-3)

    def launch(delay_s) -> bool:
        """One group; True when it timed out."""
        bufs = [fk._round_buffers(v, widx, False) for v in views]
        flag0 = box.begin(2 * P)
        main = torch.cuda.current_stream(dev)
        for s in streams:
            s.wait_stream(main)
        with torch.cuda.stream(streams[1]):
            torch.cuda._sleep(max(int(delay_s * hz), 1))
        for k, (view, s) in enumerate(zip(views, streams)):
            with torch.cuda.stream(s):
                records, n_valid, flags, state, chosen, _rows = bufs[k]
                x = box.xchg(dev, [k], per, flag0)
                x.timeout_ns = int(timeout_s * 1e9)
                fk._launch(view, widx, prod, bal, records, n_valid, flags,
                           state, chosen, fk.CLUSTER_SIZE, None, xchg=x)
        for s in streams:
            main.wait_stream(s)
        try:
            box.check("full_chain round, shard 1 late")
        except ExchangeTimeout:
            return True
        for k in range(2):
            bad = _mismatches(before, bufs[k][4].cpu())
            if bad:
                raise AssertionError(f"shard {k} of a late group that did "
                                     f"not time out: {bad} mismatches")
        return False

    coarse = [timeout_s * f for f in np.linspace(0.25, 2.0, 8)]
    outcomes = [launch(d) for d in coarse]
    if not outcomes[-1] or outcomes[0]:
        raise AssertionError(f"no deadline in the coarse spins: {outcomes}")
    hi = coarse[outcomes.index(True)]
    lo = coarse[outcomes.index(True) - 1]
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        if launch(mid):
            hi = mid
        else:
            lo = mid
    edge = 0.5 * (lo + hi)
    band = [launch(edge + d)
            for d in np.linspace(-band_s, band_s, trials)]
    after = fk.full_chain_round(fc, widx, prod, bal)[0].cpu()
    return {"timeout_s": timeout_s, "edge_spin_s": edge,
            "band_s": band_s, "trials": trials,
            "timed_out": int(sum(band)),
            "bound": int(len(band) - sum(band)),
            "next_launch_mismatches": _mismatches(before, after)}


def check_claim_view(fc, weight_idx, prod_mode: bool, bal_idx,
                     depth: int = 2, device="cuda", mesh=None) -> dict:
    """Kernel 1's exchange round over a hot-claim world's volume view as
    the wave body builds it on a mesh of cards (CardBackend.claim_view:
    each shard's [P, per] columns of the view, no claim attached yet, so
    zeros; each card's launch over its [P, rows] columns with its own
    group index) against the single-device round over the [P, N] view
    (zeros, one group per node), on ``fc`` (one card's tensors, the node
    axis a multiple of the mesh size): chosen, requested and quota_used
    bit for bit. ``mesh``: default ``depth`` exchanging virtual cards of
    this card. Reports each launch's state, shared memory and record, and
    both rounds' CUDA-event medians."""
    from koordinator_tpu_torch.models.fused_waves import ClaimSides
    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.parallel.full_chain_mesh import (
        CardBackend,
        hybrid,
    )
    from koordinator_tpu_torch.parallel.mesh import put_on_mesh

    if mesh is None:
        mesh = exchanging_mesh(depth, device)
    P_, N = fc.base.fit_requests.shape[0], fc.base.allocatable.shape[0]
    if N % mesh.size:
        raise ValueError(f"{N} rows do not split into {mesh.size} shards")
    dev = fc.base.allocatable.device
    f32, i32 = torch.float32, torch.int32
    keys = ("state", "smem_bytes_per_block", "cluster_size", "shards")

    def record(f):
        d = fk._dims(f)
        return {"VG": d["VG"], "rec_stride": fk.record_layout(
            d["R"], d["T"], d["PT"], d["VG"])["rec_stride"]}

    one = fc._replace(vol_needed=torch.zeros((P_, N), dtype=f32, device=dev),
                      node_vol_group=torch.arange(N, dtype=i32, device=dev))
    c1, r1, q1 = fk.full_chain_round(one, weight_idx, prod_mode, bal_idx)
    row = {"depth": mesh.size, "P": P_, "N": N,
           "single": {**{k: fk.last_launch[k] for k in keys},
                      **record(one)}}
    hfc = hybrid(shard_full_chain_inputs(fc._replace(
        vol_needed=torch.zeros((P_, 1), dtype=f32, device=dev),
        node_vol_group=torch.zeros(N, dtype=i32, device=dev)), mesh))
    backend = CardBackend(mesh)
    none = put_on_mesh(np.zeros((N, 1), np.float32),
                       NamedSharding(mesh, _node_axis_spec(mesh, flat=True)))
    claims = ClaimSides(pod_claim=torch.zeros((P_, 1), dtype=f32, device=dev),
                        pod_nonhot=torch.zeros(P_, dtype=f32, device=dev),
                        covered0=none)
    vol, groups = backend.claim_view(hfc, claims, none)
    fc_w = hfc._replace(vol_needed=vol, node_vol_group=groups)
    launches = []
    real = fk._launch

    def spy(f, *a, **k):
        out = real(f, *a, **k)
        launches.append({**{k: fk.last_launch[k] for k in keys}, **record(f)})
        return out

    fk._launch = spy
    try:
        cs, rs, qs = backend.round(fc_w, weight_idx, prod_mode, bal_idx,
                                   False)
    finally:
        fk._launch = real
    row["exchange"] = launches
    row["mismatches"] = (_mismatches(c1.cpu(), cs.cpu())
                         + _mismatches(r1.cpu(), np.asarray(rs))
                         + _mismatches(q1.cpu(), qs.cpu()))
    row["bound"] = int((c1 >= 0).sum())
    row["single_ms"] = time_ms(
        lambda: fk.full_chain_round(one, weight_idx, prod_mode, bal_idx))
    row["xchg_ms"] = time_ms(
        lambda: backend.round(fc_w, weight_idx, prod_mode, bal_idx, False))
    return row


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


# ---------------------------------------------------------------------------
# the exchange instances over a mesh of cards, held by one process or
# several: run_checks (each process's part), reference (one device),
# compare
# ---------------------------------------------------------------------------

# run_checks' checks, in the order they run
CHECKS = ("rtt", "round", "replay", "counts", "loadaware", "matrix",
          "waves", "worlds", "timeout")
WAVES = 2              # the fused step's waves in ``waves``
WORLD_WAVES = 4        # and in ``worlds``
CHAIN_WAVES = 3        # chained waves over each world
# two processes on one card time-slice it: a round trip there took 4.475
# ms (NVIDIA H100 80GB HBM3, 700.00 W), so 50 trips a run
RTT_ROUNDS, RTT_REPEATS = 50, 5
FIELDS = ("bind_pods", "bind_nodes", "bind_zones", "bind_res",
          "wave_counts")
CHAIN_FIELDS = ("bind_pods", "bind_nodes", "bind_zones", "bind_res",
                "count")


def exchange_batch(fc_host, args, ng: int, ngroups: int, active,
                   n_real: int, la_host: ScheduleInputs = None, sides=None,
                   worlds=None) -> dict:
    """The checks' batch, all numpy (it is pickled for other processes):
    the packed FullChainInputs ``fc_host`` with its ``active`` axes, gangs
    and groups, the LoadAware ScheduleInputs ``la_host``, the wave sides
    ``sides`` (models/fused_waves.WaveSideInputs) and the carried
    ``worlds`` ({name: (fc, sides, build kwargs)})."""
    return {"fc": fc_host, "args": args, "ng": ng, "ngroups": ngroups,
            "active": None if active is None else tuple(active),
            "n_real": int(n_real), "la": la_host, "sides": sides,
            "worlds": dict(worlds or {})}


def _host(t) -> np.ndarray:
    if isinstance(t, ShardedTensor):  # this process's replica
        t = t.local()
    return t.detach().cpu().numpy()


def _by_shard(cards, outs, i: int) -> dict:
    """{shard: its rows} of output ``i`` of each card's ``outs``, from
    ``cards`` [(device, shards, view)]."""
    from koordinator_tpu_torch.parallel.mesh import split_card_rows

    got = {}
    for (_d, ks, _v), o in zip(cards, outs):
        for k, part in zip(ks, split_card_rows(o[i], len(ks))):
            got[k] = part.cpu().numpy()
    return got


def _pod_outputs(prefix: str, outs, which: Sequence[int], names, rep):
    """The first card's pod-level outputs ``which`` of ``outs`` into
    ``rep``, and how many elements every other card's differ by."""
    for i, name in zip(which, names):
        rep[f"{prefix}.{name}"] = _host(outs[0][i])
    rep[f"{prefix}.cards_differ"] = np.array([sum(
        _mismatches(_host(outs[0][i]), _host(o[i]))
        for o in outs[1:] for i in which)], dtype=np.int64)


def _counters():
    from koordinator_tpu_torch.ops import explain_kernel as ek
    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.ops import schedule_kernel as sk

    return ((fk, "xchg_launches"), (fk, "xchg_terms_launches"),
            (fk, "xchg_replay_launches"), (ek, "shard_launches"),
            (sk, "xchg_launches"), (fk, "launches"), (fk, "terms_launches"),
            (fk, "replay_launches"), (ek, "launches"), (sk, "launches"))


def launches() -> dict:
    """The kernels' launch counts, by ``module.counter``."""
    return {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod, name)
            for mod, name in _counters()}


def zero_launches() -> None:
    for mod, name in _counters():
        setattr(mod, name, 0)


def _la_padded(la_host, mesh, device):
    from koordinator_tpu_torch.models.convert import (
        schedule_inputs_from_numpy,
    )
    from koordinator_tpu_torch.parallel.mesh import _SCHEDULE_POD_FIELDS

    node = NamedSharding(mesh, _node_axis_spec(mesh, flat=True))
    padded = {k: (v if k in _SCHEDULE_POD_FIELDS
                  else pad_for_sharding(v, node))
              for k, v in la_host._asdict().items()}
    return schedule_inputs_from_numpy(padded, device)


def shard_sides(sides, mesh, place=None):
    """numpy WaveSideInputs on ``mesh`` (wave_side_shardings' layout):
    each array through ``place(array, sharding)`` (default put_on_mesh)."""
    from koordinator_tpu_torch.parallel.full_chain_mesh import (
        wave_side_shardings,
    )
    from koordinator_tpu_torch.parallel.mesh import put_on_mesh

    place = place or put_on_mesh
    sh = wave_side_shardings(mesh, prod=sides.prod is not None,
                             claims=sides.claims is not None,
                             res=sides.res is not None)

    def put(x, s):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(put(a, b) for a, b in zip(x, s)))
        return place(x, s)

    return put(sides, sh)


def _sides_on(sides, mesh, device):
    """numpy WaveSideInputs padded as ``shard_sides`` pads them, on
    ``device``."""
    from koordinator_tpu_torch.models.fused_waves import WaveSideInputs

    padded = shard_sides(sides, mesh, lambda x, s: pad_for_sharding(
        np.asarray(x), s))

    def t(x):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x)).to(device)

    def conv(group):
        return None if group is None else type(group)(*(t(v) for v in group))

    return WaveSideInputs(t(padded.la_est), t(padded.la_adj),
                          conv(padded.prod), conv(padded.claims),
                          conv(padded.res))


def run_checks(mesh, data: dict, checks: Sequence[str],
               reps: int = 0) -> dict:
    """The checks over ``mesh`` (this process's part of it; every process
    of the mesh runs the same checks) on ``data`` (``exchange_batch``'s),
    through the instances over a mesh of cards and the mesh's entry
    points:

      rtt        the mailbox round trip between ranks 0 and 1, each box
                 mapped into the other process through CUDA IPC
                 (testing/mailbox_rtt.ipc_round_trip; across processes);
      round      kernel 1's exchange round, then its terms instance
                 (ops/full_chain_kernel.full_chain_round_cards);
      replay     the per-card replay of the terms round's kept pods (after
                 Permit) from the cycle-start state (full_chain_replay_cards;
                 after ``round``);
      counts     the per-card stage counts (ops/explain_kernel.
                 explain_counts_shards);
      loadaware  kernel 2's exchange instance (ops/schedule_kernel.
                 schedule_round_cards);
      matrix     the one-shot [P, N] score matrix over both mesh axes
                 (parallel/mesh.build_sharded_score_matrix: each process's
                 blocks against its own whole matrix, the mismatches summed
                 over the processes);
      waves      the fused wave step at K = WAVES with explain "counts"
                 (parallel/full_chain_mesh.build_sharded_fused_wave_step:
                 the exchange round, Permit, the per-card replay and stage
                 counts), then one chained wave, whose carry is the replay
                 state;
      worlds     the fused K = WORLD_WAVES step with explain "full", then
                 CHAIN_WAVES chained waves with explain "counts", over each
                 carried world of the batch;
      timeout    the mesh's first card (of one card: shard 0) launches a
                 group of kernel 1 alone, every other card skips it (begins
                 the group and reads the error words, launching nothing):
                 every process must raise ExchangeTimeout naming every
                 other shard; then every card takes the next group.

    Returns {"rep": the outputs alike in every process, "node": this
    process's node rows by shard, "times", "launches", "extra"}; ``reps``
    > 0 times each instance (CUDA events, median of ``reps`` after a
    warm-up; across processes each call ends with every process's
    error-word check, a gloo collective, so the processes stay in step).
    The launch counts are zeroed first and read last."""
    import time

    from koordinator_tpu_torch.ops import explain_kernel as ek
    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.ops import schedule_kernel as sk
    from koordinator_tpu_torch.parallel import full_chain_mesh as fcm
    from koordinator_tpu_torch.parallel.mesh import card_view

    args = data["args"]
    prod = args.score_according_prod_usage
    active = data["active"]
    widx = resolve_weight_idx(args, active)
    bal = resolve_balance_idx(active)
    rep, node, times, extra = {}, {}, {}, {}
    dev = mesh.cards[0]
    timed = reps > 0 and dev.type == "cuda"
    zero_launches()

    if {"round", "replay", "counts", "timeout"} & set(checks):
        fc = to_device(_padded_fc(data["fc"], mesh), dev)
        per = fc.base.allocatable.shape[0] // mesh.size
        cards = _cards_of(fc, mesh, per, fcm.node_rows)
        jobs = [(v, ks) for _d, ks, v in cards]

    if "rtt" in checks:
        from koordinator_tpu_torch.testing.mailbox_rtt import ipc_round_trip

        extra["rtt"] = ipc_round_trip(data.get("rtt_rounds", RTT_ROUNDS),
                                      RTT_REPEATS)

    if "round" in checks:
        box = mesh.mailboxes()

        def round_(terms=False):
            return fk.full_chain_round_cards(jobs, widx, prod, bal, box,
                                             terms=terms)

        t0 = time.perf_counter()
        outs = round_()
        extra["round_first_s"] = time.perf_counter() - t0
        extra["launch"] = {k: fk.last_launch[k] for k in (
            "cluster_size", "block_threads", "state", "shards")}
        _pod_outputs("round", outs, (0, 2), ("chosen", "quota_used"), rep)
        node["round.requested"] = _by_shard(cards, outs, 1)
        outs = round_(terms=True)
        _pod_outputs("terms", outs, (0, 2, 3),
                     ("chosen", "quota_used", "terms"), rep)
        node["terms.requested"] = _by_shard(cards, outs, 1)
        chosen = outs[0][0]
        if timed:
            times["round_ms"] = time_ms(round_, reps)
            times["terms_ms"] = time_ms(lambda: round_(terms=True), reps)

    if "replay" in checks:
        kept = permit(fc, chosen.to(dev), data["ng"], data["ngroups"]) >= 0
        state0 = fcm.replay_state0(fc, prod)
        doms = fcm.gather_dom_rows(jobs, chosen, kept, per, mesh)
        rjobs = [(v, ks, chosen.to(d), kept.to(d),
                  tuple(card_view(t, ks, d) for t in _state_rows(
                      state0, ks[0] * per, (ks[-1] + 1) * per)), dom)
                 for (d, ks, v), dom in zip(cards, doms)]

        def replay():
            routs = fk.full_chain_replay_cards(rjobs, prod, mesh.size)
            zones = routs[0][1]
            for _st, z in routs[1:]:
                zones = torch.maximum(zones, z.to(zones.device))
            return routs, mesh.all_reduce(zones, "max")

        routs, zones = replay()
        rep["replay.zones"] = _host(zones)
        states = [o[0] for o in routs]
        slots = [i for i, t in enumerate(states[0]) if t is not None]
        for i in slots:
            if i in fcm._STATE_NODE_SLOTS:
                node[f"replay.state{i}"] = _by_shard(cards, states, i)
        pod = [i for i in slots if i not in fcm._STATE_NODE_SLOTS]
        _pod_outputs("replay", states, pod, [f"state{i}" for i in pod], rep)
        if timed:
            times["replay_ms"] = time_ms(replay, reps)

    if "counts" in checks:
        views = {k: card_view(fcm.node_rows(fc, k * per, (k + 1) * per), [k],
                              mesh.flat[k].device)
                 for k in range(mesh.size) if mesh.local(k)}
        shards = [(v, cycle_start_state(v), k * per)
                  for k, v in sorted(views.items())]

        def counts():
            return ek.explain_counts_shards(shards, data["n_real"],
                                            mesh=mesh)

        rep["counts.stage_counts"] = _host(counts())
        if timed:
            times["counts_ms"] = time_ms(counts, reps)

    if "loadaware" in checks:
        la = _la_padded(data["la"], mesh, dev)
        per_la = la.allocatable.shape[0] // mesh.size
        la_cards = _cards_of(la, mesh, per_la, _schedule_rows)
        la_jobs = [(v, ks) for _d, ks, v in la_cards]
        la_widx = resolve_weight_idx(args)
        box = mesh.mailboxes()

        def la_round():
            return sk.schedule_round_cards(la_jobs, la_widx, prod, box)

        outs = la_round()
        _pod_outputs("loadaware", outs, (0,), ("chosen",), rep)
        node["loadaware.requested"] = _by_shard(la_cards, outs, 1)
        if timed:
            times["loadaware_ms"] = time_ms(la_round, reps)

    if "matrix" in checks:
        rep["matrix.mismatches"], rep["matrix.blocks"] = _matrix_mismatches(
            mesh, data["la"], args, dev)

    if "waves" in checks:
        sfc = fcm.shard_full_chain_inputs(data["fc"], mesh)
        ssides = shard_sides(data["sides"], mesh)
        n_real = data["n_real"]
        step = fcm.build_sharded_fused_wave_step(
            args, data["ng"], data["ngroups"], WAVES, mesh,
            active_axes=active, explain="counts")
        out, ex = step(sfc, ssides, n_real)
        for k in FIELDS:
            rep[f"waves.{k}"] = _host(getattr(out, k))
        rep["waves.stage_counts"] = _host(ex.stage_counts)
        cstep = fcm.build_sharded_chained_wave_step(
            args, data["ng"], data["ngroups"], mesh, active_axes=active,
            explain="counts")
        _chain(cstep, fcm.initial_sharded_wave_carry(
            sfc, ssides, mesh, explain="counts"), sfc, ssides, n_real, 1,
            "chain", rep, node)
        if timed:
            times["waves_ms"] = time_ms(
                lambda: step(sfc, ssides, n_real), reps)

    if "worlds" in checks:
        for name, (wfc, wsides, b) in sorted(data["worlds"].items()):
            n_real = int(np.asarray(wfc.base.node_ok).sum())
            kw = dict(active_axes=b["active_axes"], prod=b["prod"],
                      claims=b["claims"], res=b["res"])
            sfc = fcm.shard_full_chain_inputs(wfc, mesh)
            ssides = shard_sides(wsides, mesh)
            out, ex = fcm.build_sharded_fused_wave_step(
                args, b["num_gangs"], b["num_groups"], WORLD_WAVES, mesh,
                explain="full", **kw)(sfc, ssides, n_real)
            for k in FIELDS:
                rep[f"world.{name}.{k}"] = _host(getattr(out, k))
            rep[f"world.{name}.stage_counts"] = _host(ex.stage_counts)
            rep[f"world.{name}.terms"] = _host(ex.terms)
            cstep = fcm.build_sharded_chained_wave_step(
                args, b["num_gangs"], b["num_groups"], mesh,
                explain="counts", **kw)
            sfc = fcm.shard_full_chain_inputs(wfc, mesh)
            ssides = shard_sides(wsides, mesh)
            _chain(cstep, fcm.initial_sharded_wave_carry(sfc, ssides, mesh),
                   sfc, ssides, n_real, CHAIN_WAVES, f"world.{name}.chain",
                   rep, node)

    if "timeout" in checks:
        extra["timeout"] = _timeout(mesh, fc, cards, widx, prod, bal)
        outs = fk.full_chain_round_cards(jobs, widx, prod, bal,
                                         mesh.mailboxes())
        _pod_outputs("timeout", outs, (0,), ("next_chosen",), rep)

    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"rep": rep, "node": node, "times": times,
            "launches": launches(), "extra": extra}


def _matrix_mismatches(mesh, la_host, args, dev):
    """The score matrix's blocks of this process's shards (both mesh axes)
    against the whole matrix on its own device, element by element:
    (mismatches, blocks compared), each summed over the processes (the
    same in each)."""
    from koordinator_tpu_torch.models.convert import (
        schedule_inputs_from_numpy,
    )
    from koordinator_tpu_torch.models.scheduler_model import (
        build_score_matrix,
    )
    from koordinator_tpu_torch.parallel.mesh import (
        build_sharded_score_matrix,
        shard_inputs_2d,
    )

    feas, score = build_sharded_score_matrix(args, mesh)(
        shard_inputs_2d(la_host, mesh))
    whole = build_score_matrix(args)(schedule_inputs_from_numpy(
        {k: np.asarray(v) for k, v in la_host._asdict().items()}, dev))
    bad, blocks = 0, 0
    for got, want in zip((feas, score), whole):
        padded = torch.zeros(tuple(got.shape), dtype=want.dtype,
                             device=dev)
        padded[:want.shape[0], :want.shape[1]] = want
        for _d, block, idx in got.addressable_shards:
            rows, cols = idx
            lo_r = min(rows.stop, want.shape[0])
            lo_c = min(cols.stop, want.shape[1])
            part = block.to(dev)[:lo_r - rows.start, :lo_c - cols.start]
            bad += int((part != padded[rows.start:lo_r,
                                       cols.start:lo_c]).sum())
            blocks += 1
    total = mesh.all_reduce(torch.tensor([bad, blocks], dtype=torch.int64),
                            "sum").numpy()
    return total[:1], total[1:]


def _chain(step, carry, fc, sides, n_real: int, waves: int, prefix: str,
           rep, node) -> None:
    """``waves`` chained waves from ``carry``: each wave's rows and counts
    into ``rep``, the last carry's slots into ``rep`` (pod-level) and
    ``node`` (node-axis; by shard where sharded)."""
    from koordinator_tpu_torch.models.fused_waves import WAVE_STATE_FIELDS
    from koordinator_tpu_torch.parallel.full_chain_mesh import (
        WAVE_STATE_NODE_SLOTS,
    )

    for w in range(waves):
        carry, rows, counts = step(fc, carry, sides, n_real)
        for k, t in zip(CHAIN_FIELDS, rows):
            rep[f"{prefix}.{w}.{k}"] = _host(t)
        rep[f"{prefix}.{w}.stage_counts"] = _host(counts)
    for i, t in enumerate(carry):
        if t is None:
            continue
        name = f"{prefix}.carry.{WAVE_STATE_FIELDS[i]}"
        if i not in WAVE_STATE_NODE_SLOTS:
            rep[name] = _host(t)
        elif isinstance(t, ShardedTensor):
            node[name] = {k: s.cpu().numpy() for k, s in enumerate(t.shards)
                          if s is not None}
        else:
            node[name] = _host(t)


def _timeout(mesh, fc, cards, widx, prod: bool, bal) -> dict:
    """The mesh's first card (of a one-card mesh: shard 0 alone, a cluster
    of one launch) launches a group of kernel 1 alone; every other card of
    this process skips it, and every other process begins the group and
    reads the error words, launching nothing. Every process must raise
    ExchangeTimeout naming every other shard; returns what it named and
    when."""
    import time

    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.ops.kernel_common import (
        EXCHANGE_TIMEOUT_S,
        ExchangeTimeout,
    )
    from koordinator_tpu_torch.parallel.full_chain_mesh import node_rows
    from koordinator_tpu_torch.parallel.mesh import card_view

    box = mesh.mailboxes()
    groups = mesh.card_shards()
    first = groups[0][1] if len(groups) > 1 else [0]
    missing = [k for k in range(mesh.size) if k not in first]
    per = fc.base.allocatable.shape[0] // mesh.size
    t0 = time.perf_counter()
    try:
        if mesh.local(first[0]):
            alone = card_view(node_rows(fc, first[0] * per,
                                        (first[-1] + 1) * per), first,
                              groups[0][0])
            fk.full_chain_round_cards([(alone, first)], widx, prod, bal,
                                      box)
        else:
            box.ensure(fk.payload_words(fc.aff_dom.shape[1]))
            box.begin(2 * fc.base.fit_requests.shape[0])
            # full_chain_round_cards' own words: every process names the
            # timeout alike
            box.check("full_chain round over a mesh of cards")
    except ExchangeTimeout as exc:
        err = exc
    else:
        raise AssertionError("a launch group with only the first card "
                             "did not time out")
    seconds = time.perf_counter() - t0
    if list(err.failed_shards) != missing:
        raise AssertionError(f"the timeout named {err.failed_shards}, not "
                             f"{missing}")
    return {"timeout_s": EXCHANGE_TIMEOUT_S, "seconds": seconds,
            "failed_shards": list(err.failed_shards),
            "failed_device_ids": list(err.failed_device_ids),
            "message": str(err)}


def reference(data: dict, checks: Sequence[str], depth: int,
              device="cuda", reps: int = 0) -> dict:
    """run_checks' outputs on one device with the single-device kernels
    and steps (kernel 1, its terms instance, the replay, the stage-count
    pass, kernel 2, the wave steps) on the batch padded for a mesh of
    ``depth`` shards: {"rep", "node" (whole), "times" (``reps`` > 0: CUDA
    events, median of ``reps``)}. ``rtt`` has no reference."""
    from koordinator_tpu_torch.models import fused_waves as fw
    from koordinator_tpu_torch.ops import explain_kernel as ek
    from koordinator_tpu_torch.ops import full_chain_kernel as fk
    from koordinator_tpu_torch.ops import schedule_kernel as sk
    from koordinator_tpu_torch.parallel.full_chain_mesh import (
        _STATE_NODE_SLOTS,
        replay_state0,
    )

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = virtual_mesh(depth, dev)
    args = data["args"]
    prod, active = args.score_according_prod_usage, data["active"]
    widx = resolve_weight_idx(args, active)
    bal = resolve_balance_idx(active)
    timed = reps > 0 and dev.type == "cuda"
    rep, node, times = {}, {}, {}
    none = np.zeros(1, dtype=np.int64)  # no card differs from the first
    checks = set(checks)
    if {"round", "replay", "counts", "timeout"} & checks:
        fc = to_device(_padded_fc(data["fc"], mesh), dev)
    if {"round", "timeout"} & checks:
        c, r, q = fk.full_chain_round(fc, widx, prod, bal)
    if {"round", "replay"} & checks:
        c1, r1, q1, t1 = fk.full_chain_round(fc, widx, prod, bal, terms=True)
    if "round" in checks:
        rep["round.chosen"], rep["round.quota_used"] = _host(c), _host(q)
        rep["round.cards_differ"] = none
        node["round.requested"] = _host(r)
        rep["terms.chosen"], rep["terms.quota_used"] = _host(c1), _host(q1)
        rep["terms.terms"], rep["terms.cards_differ"] = _host(t1), none
        node["terms.requested"] = _host(r1)
        if timed:
            times["round_ms"] = time_ms(
                lambda: fk.full_chain_round(fc, widx, prod, bal), reps)
            times["terms_ms"] = time_ms(lambda: fk.full_chain_round(
                fc, widx, prod, bal, terms=True), reps)
    if "replay" in checks:
        kept = permit(fc, c1, data["ng"], data["ngroups"]) >= 0
        state0 = replay_state0(fc, prod)
        s1, z1 = fk.full_chain_replay(fc, c1, kept, state0, prod)
        rep["replay.zones"] = _host(z1)
        for i, t in enumerate(s1):
            if t is not None:
                (node if i in _STATE_NODE_SLOTS else rep)[
                    f"replay.state{i}"] = _host(t)
        rep["replay.cards_differ"] = none
        if timed:
            times["replay_ms"] = time_ms(lambda: fk.full_chain_replay(
                fc, c1, kept, state0, prod), reps)
    if "counts" in checks:
        rep["counts.stage_counts"] = _host(ek.explain_counts(
            fc, cycle_start_state(fc), data["n_real"]))
        if timed:
            times["counts_ms"] = time_ms(lambda: ek.explain_counts(
                fc, cycle_start_state(fc), data["n_real"]), reps)
    if "loadaware" in checks:
        la = _la_padded(data["la"], mesh, dev)
        la_widx = resolve_weight_idx(args)
        lc, lr = sk.schedule_round(la, la_widx, prod)
        rep["loadaware.chosen"], rep["loadaware.cards_differ"] = (_host(lc),
                                                                  none)
        node["loadaware.requested"] = _host(lr)
        if timed:
            times["loadaware_ms"] = time_ms(
                lambda: sk.schedule_round(la, la_widx, prod), reps)
    if "matrix" in checks:
        rep["matrix.mismatches"] = np.zeros(1, dtype=np.int64)
        # the feasibility and the score blocks of every shard
        rep["matrix.blocks"] = np.array([2 * depth], dtype=np.int64)
    if "waves" in checks:
        pfc = to_device(_padded_fc(data["fc"], mesh), dev)
        sides = _sides_on(data["sides"], mesh, dev)
        n_real = data["n_real"]
        out, ex = fw.build_fused_wave_step(
            args, data["ng"], data["ngroups"], WAVES, active_axes=active,
            explain="counts")(pfc, sides, n_real)
        for k in FIELDS:
            rep[f"waves.{k}"] = _host(getattr(out, k))
        rep["waves.stage_counts"] = _host(ex.stage_counts)
        _chain(fw.build_chained_wave_step(
            args, data["ng"], data["ngroups"], active_axes=active,
            explain="counts"), fw.initial_wave_carry(pfc, sides,
                                                     explain="counts"),
            pfc, sides, n_real, 1, "chain", rep, node)
    if "worlds" in checks:
        for name, (wfc, wsides, b) in sorted(data["worlds"].items()):
            n_real = int(np.asarray(wfc.base.node_ok).sum())
            kw = dict(active_axes=b["active_axes"], prod=b["prod"],
                      claims=b["claims"], res=b["res"])
            pfc = to_device(_padded_fc(wfc, mesh), dev)
            psides = _sides_on(wsides, mesh, dev)
            out, ex = fw.build_fused_wave_step(
                args, b["num_gangs"], b["num_groups"], WORLD_WAVES,
                explain="full", **kw)(pfc, psides, n_real)
            for k in FIELDS:
                rep[f"world.{name}.{k}"] = _host(getattr(out, k))
            rep[f"world.{name}.stage_counts"] = _host(ex.stage_counts)
            rep[f"world.{name}.terms"] = _host(ex.terms)
            _chain(fw.build_chained_wave_step(
                args, b["num_gangs"], b["num_groups"], explain="counts",
                **kw), fw.initial_wave_carry(pfc, psides), pfc, psides,
                n_real, CHAIN_WAVES, f"world.{name}.chain", rep, node)
    if "timeout" in checks:
        rep["timeout.next_chosen"] = _host(c)
        rep["timeout.cards_differ"] = none
    return {"rep": rep, "node": node, "times": times}


def digest(rep: dict) -> str:
    """SHA-256 of the outputs alike in every process, by name."""
    h = hashlib.sha256()
    for name in sorted(rep):
        a = np.ascontiguousarray(rep[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def compare(ref: dict, outs: List[dict], depth: int) -> dict:
    """Every process's outputs against ``ref``, bit for bit: each output
    alike in every process, and each node output's rows of every shard
    (every shard held by exactly one process). Returns {"mismatches":
    {name: count} (all must be 0), "total", "digests" (each process's),
    "reference_digest"}; raises on an output without a reference."""
    bad = {}
    for name, want in ref["rep"].items():
        bad[name] = sum(_mismatches(want, o["rep"].get(name, np.empty(0)))
                        for o in outs)
    for name, want in ref["node"].items():
        per = want.shape[0] // depth
        seen = {}
        for o in outs:
            for k, rows in o["node"].get(name, {}).items():
                seen[k] = seen.get(k, 0) + 1
                bad[name] = bad.get(name, 0) + _mismatches(
                    want[k * per:(k + 1) * per], rows)
        if sorted(seen) != list(range(depth)) or set(seen.values()) != {1}:
            bad[name] = bad.get(name, 0) + want.size
    extra = (set().union(*(o["rep"] for o in outs))
             | set().union(*(o["node"] for o in outs))) - (
                 set(ref["rep"]) | set(ref["node"]))
    if extra:
        raise AssertionError(f"outputs without a reference: {sorted(extra)}")
    return {"mismatches": bad, "total": sum(bad.values()),
            "digests": sorted({digest(o["rep"]) for o in outs}),
            "reference_digest": digest(ref["rep"])}


def _mismatches_of(res: dict, prefix: str) -> int:
    return sum(v for k, v in res["mismatches"].items()
               if k.startswith(prefix + "."))


def check_exchange(fc_host, args, ng: int, ngroups: int, active,
                   n_real: int, inputs_host: ScheduleInputs,
                   depths: Sequence[int] = EXCHANGE_DEPTHS,
                   device="cuda", meshes=None) -> List[dict]:
    """The instances over a mesh of cards against the single-device
    kernels (on the first card) on the same padded tensors, through
    run_checks, reference and compare: kernel 1's round and terms round,
    its per-card replay (the kept pods of the terms round after Permit,
    from the cycle-start state), the per-card stage counts and kernel 2's
    exchange instance. ``meshes``: the meshes to check (default:
    ``depths`` virtual cards of this card). Every mismatch count must be 0
    (``cards_differ``: every card's pod-level outputs are the first's); on
    the first mesh each pair is timed (CUDA events, median of 10)."""
    from koordinator_tpu_torch.testing.kernel_ab import REPS

    if meshes is None:
        meshes = [exchanging_mesh(d, device) for d in depths]
    data = exchange_batch(fc_host, args, ng, ngroups, active, n_real,
                          inputs_host)
    checks = ("round", "replay", "counts", "loadaware")
    out = []
    for i, mesh in enumerate(meshes):
        reps = REPS if i == 0 else 0
        got = run_checks(mesh, data, checks, reps)
        ref = reference(data, checks, mesh.size, mesh.flat[0].device, reps)
        res = compare(ref, [got], mesh.size)
        N = ref["node"]["round.requested"].shape[0]
        row = {"depth": mesh.size, "cards": len(mesh.card_shards()),
               "n_padded": N, "per": N // mesh.size,
               "bound": int((ref["rep"]["round.chosen"] >= 0).sum()),
               "launch": got["extra"]["launch"]}
        for name in ("round", "terms", "replay", "counts", "loadaware"):
            row[f"{name}_mismatches"] = _mismatches_of(res, name)
        for name, xchg in (("round", "xchg"), ("terms", "xchg"),
                           ("replay", "cards"), ("counts", "shards"),
                           ("loadaware", "xchg")):
            if reps:
                row[f"{name}_single_ms"] = ref["times"][f"{name}_ms"]
                row[f"{name}_{xchg}_ms"] = got["times"][f"{name}_ms"]
        out.append(row)
    return out


def check_timeout(fc_host, args, active, device="cuda", mesh=None) -> dict:
    """run_checks' ``timeout`` on ``mesh`` (default: 2 virtual cards of
    this card, shard 0 launching alone): the first card's group must end
    (no trap) with ExchangeTimeout naming every other shard once the
    exchange's time limit (ops/kernel_common.EXCHANGE_TIMEOUT_S) has
    passed, and the next group, over every card, must give the
    single-device round's bindings (``next_launch_mismatches``)."""
    if mesh is None:
        mesh = exchanging_mesh(2, device)
    data = exchange_batch(fc_host, args, 0, 0, active, 0)
    got = run_checks(mesh, data, ["timeout"])
    res = compare(reference(data, ["timeout"], mesh.size,
                            mesh.flat[0].device), [got], mesh.size)
    return {**got["extra"]["timeout"], "next_launch_mismatches": res["total"]}
