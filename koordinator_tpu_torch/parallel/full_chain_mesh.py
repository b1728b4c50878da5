"""Sharded FULL plugin-chain step: the full-chain round over a mesh.

The port's counterpart of the JAX package's parallel/full_chain_mesh.py,
composing the same pieces the single-device steps compose
(models/full_chain.py, models/fused_waves.py) on node-sharded state:

  * node-axis state sharded over ALL mesh devices (``_FC_NODE_FIELDS`` and
    the ScheduleInputs node fields): allocatable/requested/usage [N, R],
    NUMA free/capacity [N, K, R], cpuset bind state [N], the affinity,
    port, volume and preferred-score rows;
  * pod arrays, the quota tree and the gangs replicated; the quota
    admission and used-rollup run identically on every shard, so the
    carried quota state never needs a collective;
  * gang Permit over the replicated ``chosen`` vector, after the round.

Per pod, each shard evaluates its own rows (make_pod_evaluator over the
shard's view, ``shard_rows``); the round's only node reductions, the
spread minima and the preferred pod-affinity max/min, are each shard's
``node_stats`` reduced over the mesh (a min and a max: exact); the winners
merge by (score, lowest global index) (parallel/mesh.WinnerMerge) and the
shard owning the winner commits its row, while every shard applies the
quota and the affinity domain over its own nodes. Bindings therefore equal
the single-device round bit for bit at any mesh size. Across processes the
reductions and the winner merge are gloo all-reduces. That is the plain
sharded round, run for shards on the CPU.

Shards that share one card (or the CPU) are gathered for the wave steps
and, on the card, for the round: the sharded steps gather the node fields
(parallel/mesh.gather, a torch.cat of the shards), run the single-device
step on them (kernel 1 and its terms instance, the replay kernel, the
stage-count pass) and split the node outputs back into their shards, as
the JAX package's sharded steps are its single-device steps jitted with
out_shardings.

A mesh of cards (``mesh.exchange``) takes the exchange route instead:
every node-axis array stays on its shard's card, and the one wave body of
models/fused_waves.py runs with ``CardBackend``'s passes, each over every
card at once: kernel 1's exchange instance (ops/full_chain_kernel.py
``full_chain_round_cards``; the cards swap each pod's stats and winner
through the mesh's mailboxes), the per-card replay (each card replays the
kept pods onto its own rows, the chosen nodes' aff_dom rows gathered once
before it, ``gather_dom_rows``) and the per-card stage counts
(ops/explain_kernel.py ``explain_counts_shards``). The pieces of the body
that index node rows by a global node index run per card too: the
reservation pre-passes commit onto the shard owning the node, the hot
claims' [P, N] volume view is built as each card's [P, rows] columns (a
ShardedTensor split along its second dimension) and advanced by each
card over the pods it holds, and the device score transformers rewrite
each card's view. The pod-level work (Permit, the compacted rows, the
gang counters, the nomination choice) runs once, on the first shard's
card, and its outputs are replicated. On the CPU the same route runs the
plain sharded pieces (``sharded_plain_round``, ``sharded_replay_kept``,
``sharded_stage_counts``), so the CPU tests drive the card route's wave
body.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from koordinator_tpu_torch.models.full_chain import (
    EXPLAIN_STAGE_GANG,
    EXPLAIN_TERMS,
    ExplainOut,
    FullChainInputs,
    _check_explain,
    _commit_affinity,
    commit_pod_state,
    cycle_start_state,
    explain_spread_minima,
    explain_stage_counts,
    make_pod_evaluator,
    permit,
    resolve_balance_idx,
)
from koordinator_tpu_torch.models.scheduler_model import resolve_weight_idx
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.ops.quota import quota_used_add_row
from koordinator_tpu_torch.ops.numa import numa_zone_for_node
from koordinator_tpu_torch.ops.volumes import (
    advance_claim_state,
    effective_vol_needed,
)
from koordinator_tpu_torch.parallel.mesh import (
    _SCHEDULE_POD_FIELDS,
    Mesh,
    NamedSharding,
    P,
    ShardedTensor,
    WinnerMerge,
    _node_axis_spec,
    card_view,
    from_shards,
    gather,
    gather_tree,
    put_on_mesh,
    replicate,
    shard_inputs_nodewise,
    split_card_rows,
    split_nodes,
)

# FullChainInputs fields indexed [N, ...] (sharded); everything else (pods,
# quota tree, gangs) is replicated.
_FC_NODE_FIELDS = frozenset(
    {
        "numa_free",
        "numa_capacity",
        "numa_policy",
        "has_topology",
        "bind_free",
        "cpus_per_core",
        "node_taint_group",
        "aff_dom",
        "aff_count",
        "anti_cover",
        "pref_scores",
        "port_used",
        "vol_free",
        "node_vol_group",
        "img_scores",
    }
)

_INF = float("inf")


def shard_full_chain_inputs(fc: FullChainInputs, mesh: Mesh) -> FullChainInputs:
    """Place FullChainInputs on the mesh: node state sharded over all
    devices, pod/quota/gang state replicated."""
    node_spec = _node_axis_spec(mesh, flat=True)
    base = shard_inputs_nodewise(fc.base, mesh)

    def put(name, arr):
        spec = node_spec if name in _FC_NODE_FIELDS else P()
        return put_on_mesh(arr, NamedSharding(mesh, spec))

    rest = {k: put(k, v) for k, v in fc._asdict().items() if k != "base"}
    return FullChainInputs(base=base, **rest)


# ---------------------------------------------------------------------------
# the plain sharded pieces (shards on the CPU)
# ---------------------------------------------------------------------------

def _from_owner(mesh: Mesh, vals: Optional[torch.Tensor], size: int):
    """The owning shard's f32 [size] values on every process: a min
    all-reduce where the other processes give +inf."""
    if not mesh.spans_processes:
        return vals
    t = (vals.to(torch.float32).reshape(size).clone() if vals is not None
         else torch.full((size,), _INF, dtype=torch.float32))
    return mesh.all_reduce(t, "min")


def _round_init(fc: FullChainInputs):
    """A shard's own copy of the round state, as plain_round starts it."""
    inputs = fc.base
    N, R = inputs.allocatable.shape[0], inputs.fit_requests.shape[1]
    dev = inputs.allocatable.device
    return (inputs.requested.clone(),
            torch.zeros((N, R), dtype=torch.float32, device=dev),
            torch.zeros((N, R), dtype=torch.float32, device=dev),
            fc.numa_free.clone(), fc.bind_free.clone(),
            fc.quota_used.clone(), fc.aff_count.clone(),
            fc.anti_cover.clone(), fc.aff_exists.to(torch.bool).clone(),
            fc.port_used.clone(), fc.vol_free.clone())


def _commit(fcs, states, mesh: Mesh, per: int, prod_mode: bool, i, found,
            g: int, zone, dom):
    """Pod ``i``'s commit onto global node ``g`` on every local shard: the
    owner its rows, the others the quota and the affinity domain ``dom``
    (the chosen node's aff_dom row)."""
    owner, b = divmod(g, per)
    quota = None
    for k, f in fcs.items():
        dev = f.aff_dom.device
        if k == owner:
            bt = torch.tensor(b, device=dev)
            states[k] = commit_pod_state(f, prod_mode, states[k], i,
                                         found.to(dev), bt, zone.to(dev))
            quota = states[k][5]
        else:
            _commit_affinity(f, i, found.to(dev), dom.to(dev), states[k][6],
                             states[k][7], states[k][8])
    # the quota state is replicated: one update, shared by every shard
    if quota is None:
        f = next(iter(fcs.values()))
        quota = quota_used_add_row(next(iter(states.values()))[5],
                                   f.requests[i], f.quota_id[i],
                                   f.quota_ancestors, found)
    for k, st in states.items():
        if st[5] is not quota:
            states[k] = st[:5] + (quota,) + st[6:]


def sharded_plain_round(fcs: Dict[int, FullChainInputs], mesh: Mesh,
                        per: int, weight_idx, prod_mode: bool, bal_idx,
                        states=None, terms: bool = False):
    """The serial round over the local shards ``fcs`` (k -> the shard's
    view), each shard's state in ``states`` (k -> commit_pod_state's
    11-tuple, updated in place; default: the views' own state). Returns
    (chosen[P] int32 before Permit, states, terms rows [P, 5] or None)."""
    if states is None:
        states = {k: _round_init(f) for k, f in fcs.items()}
    evs = {k: make_pod_evaluator(f, weight_idx, prod_mode, bal_idx,
                                 shard_rows=True) for k, f in fcs.items()}
    f0 = next(iter(fcs.values()))
    P_ = f0.base.fit_requests.shape[0]
    T = f0.aff_dom.shape[1]
    dev = f0.base.allocatable.device
    merge = WinnerMerge(mesh, per)
    chosen = torch.full((P_,), -1, dtype=torch.int32, device=dev)
    rows = (torch.zeros((P_, len(EXPLAIN_TERMS)), dtype=torch.float32,
                        device=dev) if terms else None)
    for i in torch.nonzero(f0.base.pod_valid).flatten().tolist():
        st = torch.stack([evs[k].node_stats(i, states[k][6]) for k in evs])
        # spread minima and the ppref min: min; the ppref max: max
        red = torch.cat([st[:, :T].min(dim=0)[0], st[:, T:T + 1].max(dim=0)[0],
                         st[:, T + 1:].min(dim=0)[0]])
        if mesh.spans_processes:
            red[T] = -red[T]
            mesh.all_reduce(red, "min")
            red[T] = -red[T]
        k0 = next(iter(evs))
        admit = evs[k0].pod_admit(i, states[k0][5])
        outs = {k: evs[k](i, *states[k], stats=red, admit=admit)
                for k in evs}
        bests = []
        for k, out in outs.items():
            b = torch.argmax(out[1])
            bests.append((k, out[1][b], b))
        best_v, g = merge.merge(bests)
        found = (best_v >= 0.0) & f0.base.pod_valid[i]
        owner, b = divmod(g, per)
        mine = outs.get(owner)
        picked = (torch.cat([fcs[owner].aff_dom[b],
                             mine[2][b].to(torch.float32).reshape(1),
                             torch.stack([mine[3][b], mine[4][b],
                                          mine[5][b]])])
                  if mine is not None else None)
        picked = _from_owner(mesh, picked, T + 4)
        dom, zone = picked[:T], picked[T].to(torch.int32)
        if terms:
            runs = []
            for k, out in outs.items():
                sc = out[1]
                if k == owner:
                    sc = torch.where(
                        torch.arange(sc.shape[0], device=sc.device) == b,
                        -_INF, sc)
                runs.append(sc.max())
            runner = torch.stack(runs).max().reshape(1)
            runner = mesh.all_reduce(runner, "max")[0]
            rows[i] = torch.stack([picked[T + 1], picked[T + 2],
                                   picked[T + 3], best_v,
                                   torch.clamp_min(runner, -1.0)])
        _commit(fcs, states, mesh, per, prod_mode, i, found, g, zone, dom)
        chosen[i] = torch.where(
            found, torch.tensor(g, dtype=torch.int32, device=dev), -1)
    return chosen, states, rows


def sharded_replay_kept(fcs: Dict[int, FullChainInputs], mesh: Mesh,
                        per: int, prod_mode: bool, states, chosen, kept):
    """The kept-only replay over the local shards ``fcs`` (k -> the shard's
    view of the carry-form inputs): each kept pod, in queue order, commits
    onto its chosen node's shard (the zone re-picked there under the replay
    state) while every shard applies the quota and the chosen node's
    affinity domain over its own rows (``_commit``). ``states`` (k -> the
    11-tuple) is not modified. Returns (k -> state', zones[P] int32, -1
    outside the kept pods): models/fused_waves.replay_kept, sharded."""
    from koordinator_tpu_torch.models.fused_waves import _round_state

    states = {k: _round_state(*st) for k, st in states.items()}
    f0 = next(iter(fcs.values()))
    T = f0.aff_dom.shape[1]
    dev = chosen.device
    zones = torch.full((chosen.shape[0],), -1, dtype=torch.int32, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    for i in torch.nonzero(kept).flatten().tolist():
        g = int(chosen[i])
        owner, b = divmod(g, per)
        picked = None
        if owner in fcs:
            f = fcs[owner]
            zone = numa_zone_for_node(f.requests[i], f.needs_numa[i],
                                      states[owner][3][b], f.numa_policy[b])
            picked = torch.cat([f.aff_dom[b].to(torch.float32),
                                zone.to(torch.float32).reshape(1)])
        picked = _from_owner(mesh, picked, T + 1)
        dom, zone = picked[:T], picked[T].to(torch.int32)
        _commit(fcs, states, mesh, per, prod_mode, i, yes, g, zone, dom)
        zones[i] = zone
    return states, zones


def sharded_stage_counts(fcs: Dict[int, FullChainInputs], filter_states,
                         mesh: Mesh, per: int, n_real) -> torch.Tensor:
    """[P, NUM_EXPLAIN_STAGES] uint32: each shard counts its own rows
    (explain_stage_counts over its view, n_real cut to its rows) against
    the mesh's spread minima; the per-stage counts are integers, so the
    shard sums are exact. The two pod-level verdict slots are the same on
    every shard and taken from one."""
    mins = torch.stack([explain_spread_minima(f, filter_states[k][4])
                        for k, f in fcs.items()]).min(dim=0)[0]
    mesh.all_reduce(mins, "min")
    total = None
    for k, f in fcs.items():
        n_loc = max(0, min(per, int(n_real) - k * per))
        c = explain_stage_counts(f, filter_states[k], n_loc,
                                 spread_min=mins).to(torch.int64)
        if total is None:
            total = c
        else:
            total[:, :EXPLAIN_STAGE_GANG] += c[:, :EXPLAIN_STAGE_GANG]
    if mesh.spans_processes:
        node = total[:, :EXPLAIN_STAGE_GANG].contiguous()
        mesh.all_reduce(node, "sum")
        total[:, :EXPLAIN_STAGE_GANG] = node
    return total.to(torch.uint32)


def _first(d: Dict[int, object]):
    return d[min(d)]


def _node_out(mesh: Mesh, per_shard: Dict[int, torch.Tensor]) -> ShardedTensor:
    return from_shards([per_shard.get(k) for k in range(mesh.size)], mesh,
                       _node_axis_spec(mesh, flat=True))


# ---------------------------------------------------------------------------
# the exchange route: node-axis arrays on their shards' cards
# ---------------------------------------------------------------------------

def node_rows(fc: FullChainInputs, lo: int, hi: int) -> FullChainInputs:
    """``fc`` with its node-axis fields cut to rows [lo, hi)."""
    base = fc.base._replace(**{
        k: v[lo:hi] for k, v in fc.base._asdict().items()
        if k not in _SCHEDULE_POD_FIELDS})
    return fc._replace(base=base, **{
        k: getattr(fc, k)[lo:hi] for k in _FC_NODE_FIELDS})


def hybrid(nt):
    """``nt`` (a NamedTuple of ShardedTensors, nested NamedTuples, tensors
    or None) with each replicated ShardedTensor replaced by its first local
    copy: the form the exchange route's wave body takes, node-axis arrays
    on their shards and the pod-level ones on the first shard's card."""
    if isinstance(nt, ShardedTensor):
        return nt.local() if nt.replicated else nt
    if isinstance(nt, tuple) and hasattr(nt, "_fields"):
        return type(nt)(*(hybrid(v) for v in nt))
    return nt


def replay_state0(fc: FullChainInputs, prod: bool):
    """A replay's wave-start 11-tuple at ``fc``'s own state: requested,
    the LoadAware terms as the estimate sums (the prod one only in
    ``prod`` mode), then the round state fields."""
    return (fc.base.requested, fc.base.la_term_nonprod,
            fc.base.la_term_prod if prod else None, fc.numa_free,
            fc.bind_free, fc.quota_used, fc.aff_count, fc.anti_cover,
            fc.aff_exists.to(torch.bool), fc.port_used, fc.vol_free)


def gather_dom_rows(cards, chosen, kept, per: int):
    """The aff_dom row of each kept pod's chosen node, [P, T] f32 on each
    card (zeros outside the kept pods): ``cards`` [(fc, shards)] per card,
    each card reading the rows it holds, combined on the first card and
    copied to every card, once before a replay. ``chosen`` and ``kept``
    on the first card."""
    dev0 = chosen.device
    P, T = chosen.shape[0], cards[0][0].aff_dom.shape[1]
    dom = torch.zeros((P, T), dtype=torch.float32, device=dev0)
    g = torch.clamp_min(chosen.to(torch.int64), 0)
    shard = g // per
    for fc, shards in cards:
        pos = torch.full((int(shard.max()) + 2 if P else 1,), -1,
                         dtype=torch.int64, device=dev0)
        for j, k in enumerate(shards):
            if k < pos.shape[0]:
                pos[k] = j
        at = pos[torch.clamp_max(shard, pos.shape[0] - 1)]
        mine = kept & (at >= 0)
        local = torch.where(mine, at * per + g - shard * per, 0)
        dev = fc.aff_dom.device
        part = fc.aff_dom.to(torch.float32)[local.to(dev)].to(dev0)
        dom = torch.where(mine[:, None], part, dom)
    return [dom.to(fc.aff_dom.device) for fc, _shards in cards]


def _view(nt, shards, device):
    """card_view of ``nt`` for ``shards``; a FullChainInputs whose volume
    view is split by node columns (CardBackend.claim_view) takes its own
    columns' group index, ``arange`` of them, as the single-device view
    has one group per node."""
    view = card_view(nt, shards, device)
    vol = getattr(nt, "vol_needed", None)
    if isinstance(vol, ShardedTensor) and not vol.replicated:
        view = view._replace(node_vol_group=torch.arange(
            view.vol_needed.shape[1], dtype=torch.int32, device=device))
    return view


def _merge_views(mesh: Mesh, x, parts, check: bool):
    """A hybrid-form field ``x`` rebuilt from views that rewrote it:
    ``parts`` [(shards, view in, view out)]. A field no view changed stays
    ``x``; a node-axis one goes back to its shards (along its node
    dimension); a pod-level one is the first view's, and with ``check``
    every view's must be equal."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(
            _merge_views(mesh, v, [(ks, a[j], b[j]) for ks, a, b in parts],
                         check)
            for j, v in enumerate(x)))
    if all(b is a for _ks, a, b in parts):
        return x
    if isinstance(x, ShardedTensor):
        shards = [None] * mesh.size
        for ks, _a, b in parts:
            for k, t in zip(ks, split_card_rows(b, len(ks), x.node_dim)):
                shards[k] = t
        return ShardedTensor(shards, x.shape, x.sharding)
    first = parts[0][2]
    if check and not all(torch.equal(b, first) for _ks, _a, b in parts):
        raise ValueError("a device score pass gave the cards different "
                         "pod-level fields")
    return first


class CardBackend:
    """The wave body's passes (models/fused_waves.WaveBackend) over a mesh
    whose node-axis arrays stay on their shards: inputs in ``hybrid``
    form, each pass run over every card at once, its node-axis outputs
    back on their shards and its pod-level outputs on the first shard's
    card. On the card: the exchange instances; on the CPU: the plain
    sharded pieces."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh

    def _per(self, fc) -> int:
        return fc.base.allocatable.shape[0] // self.mesh.size

    def _cuda(self, fc) -> bool:
        return fc.base.allocatable.local().is_cuda

    def _local(self):
        return [k for k in range(self.mesh.size) if self.mesh.local(k)]

    def _shard_fcs(self, fc) -> Dict[int, FullChainInputs]:
        """k -> shard k's view (pod-level fields on its device)."""
        mesh = self.mesh
        return {k: _view(fc, [k], mesh.flat[k].device) for k in self._local()}

    def _cards(self, nt):
        return [(dev, ks, _view(nt, ks, dev))
                for dev, ks in self.mesh.card_shards()]

    def _node_out(self, per_card) -> ShardedTensor:
        shards = [None] * self.mesh.size
        for (_dev, ks), t in per_card:
            for k, part in zip(ks, split_card_rows(t, len(ks))):
                shards[k] = part
        return _node_out(self.mesh, dict(enumerate(shards)))

    def round(self, fc, weight_idx, prod_mode, bal_idx, terms: bool):
        """(chosen[P] before Permit, requested node-sharded, quota_used
        [, terms rows])."""
        mesh = self.mesh
        if not self._cuda(fc):
            chosen, states, rows = sharded_plain_round(
                self._shard_fcs(fc), mesh, self._per(fc), weight_idx,
                prod_mode, bal_idx, terms=terms)
            out = (chosen, _node_out(mesh, {k: st[0]
                                            for k, st in states.items()}),
                   _first(states)[5])
            return out + ((rows,) if terms else ())
        from koordinator_tpu_torch.ops.full_chain_kernel import (
            full_chain_round_cards,
        )

        cards = self._cards(fc)
        outs = full_chain_round_cards([(v, ks) for _d, ks, v in cards],
                                      weight_idx, prod_mode, bal_idx,
                                      mesh.mailboxes(), terms=terms)
        requested = self._node_out([((d, ks), o[1])
                                    for (d, ks, _v), o in zip(cards, outs)])
        return (outs[0][0], requested, outs[0][2]) + (
            (outs[0][3],) if terms else ())

    def replay(self, fc_carry, chosen, kept, state0, prod_mode):
        """(state' with its node-axis slots on their shards, zones[P])."""
        mesh = self.mesh
        per = self._per(fc_carry)
        if not self._cuda(fc_carry):
            fcs = self._shard_fcs(fc_carry)
            states = {k: tuple(card_view(x, [k], mesh.flat[k].device)
                               for x in state0) for k in fcs}
            states, zones = sharded_replay_kept(fcs, mesh, per, prod_mode,
                                                states, chosen, kept)
            out = tuple(
                _node_out(mesh, {k: st[i] for k, st in states.items()})
                if i in _STATE_NODE_SLOTS else _first(states)[i]
                for i in range(len(state0)))
            return out, zones
        from koordinator_tpu_torch.ops.full_chain_kernel import (
            full_chain_replay_cards,
        )

        cards = self._cards(fc_carry)
        doms = gather_dom_rows([(v, ks) for _d, ks, v in cards], chosen,
                               kept, per)
        jobs = [(v, ks, chosen.to(d), kept.to(d),
                 tuple(card_view(x, ks, d) for x in state0), dom)
                for (d, ks, v), dom in zip(cards, doms)]
        outs = full_chain_replay_cards(jobs, prod_mode, mesh.size)
        state = tuple(
            self._node_out([((d, ks), o[0][i])
                            for (d, ks, _v), o in zip(cards, outs)])
            if i in _STATE_NODE_SLOTS else outs[0][0][i]
            for i in range(len(state0)))
        zones = outs[0][1]
        for _st, z in outs[1:]:
            zones = torch.maximum(zones, z.to(zones.device))
        return state, zones

    def counts(self, fc, state, n_real):
        """[P, 11] stage counts at ``state`` (cycle_start_state's
        9-tuple), on the first shard's card."""
        mesh = self.mesh
        per = self._per(fc)
        views = self._shard_fcs(fc)
        states = {k: tuple(card_view(x, [k], mesh.flat[k].device)
                           for x in state) for k in views}
        if not self._cuda(fc):
            return sharded_stage_counts(views, states, mesh, per, n_real)
        from koordinator_tpu_torch.ops.explain_kernel import (
            explain_counts_shards,
        )

        return explain_counts_shards(
            [(views[k], states[k], k * per) for k in sorted(views)], n_real)

    def round_counts(self, fc, weight_idx, prod_mode, bal_idx, terms: bool,
                     n_real):
        """(the round's outputs, the stage counts at ``fc``'s own state):
        the per-card counts, then the round over the mesh."""
        counts = self.counts(fc, cycle_start_state(fc), n_real)
        return self.round(fc, weight_idx, prod_mode, bal_idx, terms), counts

    def zeros(self, like: ShardedTensor) -> ShardedTensor:
        return ShardedTensor(
            [None if t is None else torch.zeros_like(t, dtype=torch.float32)
             for t in like.shards], like.shape, like.sharding)

    def succeeded_fold(self, requested, res_succ, res_node, fit_requests,
                       alloc):
        """Pass 0a per card: each Succeeded row's delta goes to the
        requested row of the shard owning its node, at the local index."""
        per = requested.shape[0] // self.mesh.size
        requested = requested.clone()
        for r in torch.nonzero(res_succ >= 0).flatten().tolist():
            p = int(res_succ[r])
            owner, b = divmod(max(int(res_node[r]), 0), per)
            rows = requested.shards[owner]
            if rows is None:
                continue  # another process's shard
            delta = (fit_requests[p] - alloc[r]).to(rows.device)
            rows[b] = rows[b] + 1.0 * delta
        return requested

    def nominate(self, fc, fc_nom, prod_mode, chain, i, noden):
        """Pass 0b's commit per card: the shard owning the node picks the
        NUMA zone under its own state and commits ``fc_nom`` onto its row,
        every other shard takes the quota and the node's aff_dom row
        (``_commit``, as sharded_replay_kept does). ``chain``'s node-axis
        slots are updated in place on their shards."""
        mesh = self.mesh
        per = self._per(fc)
        g = int(noden)
        owner, b = divmod(g, per)
        views = self._shard_fcs(fc)
        states = {k: tuple(card_view(x, [k], mesh.flat[k].device)
                           for x in chain) for k in views}
        T = fc.aff_dom.shape[1]
        picked = None
        if owner in views:
            f = views[owner]
            zone = numa_zone_for_node(f.requests[i], f.needs_numa[i],
                                      states[owner][3][b], f.numa_policy[b])
            picked = torch.cat([f.aff_dom[b].to(torch.float32),
                                zone.to(torch.float32).reshape(1)])
        picked = _from_owner(mesh, picked, T + 1)
        dom, zone = picked[:T], picked[T].to(torch.int32)
        yes = torch.ones((), dtype=torch.bool, device=zone.device)
        _commit(self._shard_fcs(fc_nom), states, mesh, per, prod_mode, i,
                yes, g, zone, dom)
        quota = _first(states)[5].to(chain[5].device)
        return chain[:5] + (quota,) + chain[6:], zone

    def claim_view(self, fc, claims, claim_new):
        """The volume view per card: each shard's [P, per] columns, the
        frozen needs gathered by its own nodes' groups less the claims its
        nodes newly attached (ops/volumes.effective_vol_needed), split
        along the second dimension; the group index is the global
        ``arange`` (each view takes its own, ``_view``)."""
        mesh = self.mesh
        per = self._per(fc)
        vol = [None] * mesh.size
        groups = [None] * mesh.size
        for k in self._local():
            grp = fc.node_vol_group.shards[k]
            dev = grp.device
            vol[k] = effective_vol_needed(
                fc.vol_needed.to(dev), grp, claims.pod_claim.to(dev),
                claim_new.shards[k])
            groups[k] = torch.arange(k * per, (k + 1) * per,
                                     dtype=torch.int32, device=dev)
        spec = _node_axis_spec(mesh, flat=True)
        return (from_shards(vol, mesh, P(None, *spec), dim=1),
                from_shards(groups, mesh, spec))

    def advance_claims(self, chosen, kept, claims, claim_new, vol_new,
                       vol_free0):
        """The claim state's wave boundary per card: each shard advances
        its own rows over the kept pods whose node it holds, at local
        indices (ops/volumes.advance_claim_state; its sums are of 0/1 and
        small integers, so the split is exact)."""
        mesh = self.mesh
        per = claim_new.shape[0] // mesh.size
        outs = {}
        for k in self._local():
            rows = claim_new.shards[k]
            dev = rows.device
            node = chosen.to(dev).to(torch.int64) - k * per
            mine = kept.to(dev) & (node >= 0) & (node < per)
            outs[k] = advance_claim_state(
                torch.where(mine, node, 0), mine, claims.pod_claim.to(dev),
                claims.pod_nonhot.to(dev), claims.covered0.shards[k], rows,
                vol_new.shards[k], vol_free0.shards[k])
        return tuple(_node_out(mesh, {k: o[j] for k, o in outs.items()})
                     for j in range(3))

    def score_passes(self, fc_w, passes):
        """The device score transformers over each card's view (each
        shard's on the CPU, where the shards stand for cards): node-axis
        fields go back to their shards, pod-level fields (``weights``, …)
        come from the first card. Exact by the DeviceScoreTransformer
        contract (scheduler/frameworkext.py): a pass rewrites score-side
        fields only, with elementwise and gather ops, so a card's rows come
        out as the single device's same rows and the pod-level fields alike
        on every card; on the CPU that is checked."""
        cuda = self._cuda(fc_w)
        groups = (self.mesh.card_shards() if cuda else
                  [(self.mesh.flat[k].device, [k]) for k in self._local()])
        parts = []
        for dev, ks in groups:
            view = _view(fc_w, ks, dev)
            out = view
            for tf in passes:
                out = tf(out)
            parts.append((ks, view, out))
        return _merge_views(self.mesh, fc_w, parts, check=not cuda)


# the replay state's node-axis slots (models/full_chain.commit_pod_state's
# 11-tuple): all but quota_used and aff_exists
_STATE_NODE_SLOTS = frozenset({0, 1, 2, 3, 4, 6, 7, 9, 10})


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------

def build_sharded_full_chain_step(
    args: LoadAwareArgs,
    num_gangs: int,
    num_groups: int,
    mesh: Mesh,
    active_axes=None,
    explain=None,
):
    """The full-chain step over ``mesh``: FullChainInputs with node-sharded
    fields (shard_full_chain_inputs, or the mesh-backed DeviceSnapshot) ->
    (chosen[P] replicated, requested[N, R] node-sharded, quota_used[G, R]
    replicated), plus the ExplainOut 4th output (and the extra ``n_real``
    operand) when ``explain`` is "counts"/"full", its arrays replicated.
    Shards of one card gather the node axis (parallel/mesh.gather) and run
    the single-device CUDA step: kernel 1, its terms instance at "full"
    and the stage-count pass. A mesh of cards (``mesh.exchange``) runs
    CardBackend's passes: kernel 1's exchange instance and the per-card
    stage counts, each card over its own rows. Shards on the CPU run the
    plain sharded round (the same passes' CPU side)."""
    from koordinator_tpu_torch.ops.full_chain_kernel import (
        build_cuda_full_chain_step,
    )

    _check_explain(explain)
    weight_idx = resolve_weight_idx(args, active_axes)
    bal_idx = resolve_balance_idx(active_axes)
    prod_mode = args.score_according_prod_usage
    full = explain == "full"
    cuda_step = build_cuda_full_chain_step(
        args, num_gangs, num_groups, active_axes=active_axes,
        explain=explain)

    def run_cuda(fc: FullChainInputs, n_real):
        extra = () if explain is None else (n_real,)
        out = cuda_step(gather_tree(fc), *extra)
        wrapped = (replicate(out[0], mesh), split_nodes(out[1], mesh),
                   replicate(out[2], mesh))
        if explain is None:
            return wrapped
        ex = out[3]
        return wrapped + (ExplainOut(
            replicate(ex.stage_counts, mesh),
            replicate(ex.terms, mesh) if full else None),)

    backend = CardBackend(mesh)

    def run(fc: FullChainInputs, n_real):
        cuda = fc.base.allocatable.local().is_cuda
        if cuda and not mesh.exchange:
            step.last_backend = "cuda"
            return run_cuda(fc, n_real)
        step.last_backend = "cuda-exchange" if cuda else "serial"
        hfc = hybrid(fc)
        out = backend.round(hfc, weight_idx, prod_mode, bal_idx, full)
        chosen = permit(hfc, out[0], num_gangs, num_groups)
        wrapped = (replicate(chosen, mesh), out[1], replicate(out[2], mesh))
        if explain is None:
            return wrapped
        counts = backend.counts(hfc, cycle_start_state(hfc), n_real)
        return wrapped + (ExplainOut(
            replicate(counts, mesh),
            replicate(out[3], mesh) if full else None),)

    if explain is None:
        def step(fc: FullChainInputs):
            return run(fc, None)
    else:
        def step(fc: FullChainInputs, n_real):
            return run(fc, n_real)

    step.last_backend = None
    return step


# the carry slots (models/fused_waves.WAVE_STATE_FIELDS) on the node axis
WAVE_STATE_NODE_SLOTS = frozenset({1, 2, 3, 4, 6, 7, 9, 10, 12, 13, 14})


def wave_carry_shardings(mesh: Mesh, explain=None, prod: bool = False,
                         claims: bool = False, res: bool = False):
    """Shardings for the chained wave step's carry tuple: node-axis slots
    sharded flat over the mesh, pod/quota/gang/reservation/term slots
    replicated, feature-absent slots None."""
    from koordinator_tpu_torch.models.fused_waves import (
        NUM_WAVE_STATE,
        WAVE_STATE_FIELDS,
    )

    node = NamedSharding(mesh, _node_axis_spec(mesh, flat=True))
    rep = NamedSharding(mesh, P())
    present = {
        "est_sum_prod": prod,
        "claim_new": claims,
        "vol_new": claims,
        "res_avail": res,
        "res_remain": res,
        "res_node": res,
        "res_succ": res,
    }
    carry = tuple(
        (None if not present.get(WAVE_STATE_FIELDS[i], True)
         else node if i in WAVE_STATE_NODE_SLOTS else rep)
        for i in range(NUM_WAVE_STATE))
    if explain == "full":
        carry = carry + (rep,)  # per-pod score-term rows
    return carry


def wave_side_shardings(mesh: Mesh, prod: bool = False,
                        claims: bool = False, res: bool = False):
    """Sharding tree for WaveSideInputs: [N, ...] operands follow the flat
    node sharding, pod-axis/reservation operands replicate."""
    from koordinator_tpu_torch.models.fused_waves import (
        ClaimSides,
        ProdSides,
        ResSides,
        WaveSideInputs,
    )

    node = NamedSharding(mesh, _node_axis_spec(mesh, flat=True))
    rep = NamedSharding(mesh, P())
    return WaveSideInputs(
        la_est=node,
        la_adj=node,
        prod=ProdSides(est=node, adj=node) if prod else None,
        claims=(ClaimSides(pod_claim=rep, pod_nonhot=rep, covered0=node)
                if claims else None),
        res=(ResSides(owner_match=rep, rank=rep, alloc=rep, once=rep,
                      row_of=rep, pod_slot=rep, nominate_ok=rep)
             if res else None),
    )


def _shard_carry(mesh: Mesh, carry) -> tuple:
    """A wave carry on the mesh (wave_carry_shardings' layout): the
    node-axis slots split into their shards (kept where they are already
    sharded), the other slots replicated."""
    return tuple(
        t if t is None or isinstance(t, ShardedTensor)
        else split_nodes(t, mesh) if i in WAVE_STATE_NODE_SLOTS
        else replicate(t, mesh)
        for i, t in enumerate(carry))


def initial_sharded_wave_carry(fc: FullChainInputs, sides, mesh: Mesh,
                               explain=None):
    """models/fused_waves.initial_wave_carry over the mesh, node-axis
    slots on their shards, the other slots replicated
    (wave_carry_shardings' layout). On a mesh of cards the slots it makes
    new (the hot claims' claim_new and vol_new) are made on their shards'
    cards (CardBackend.zeros)."""
    from koordinator_tpu_torch.models.fused_waves import initial_wave_carry

    if mesh.exchange:
        return _shard_carry(mesh, initial_wave_carry(
            hybrid(fc), hybrid(sides), explain=explain,
            backend=CardBackend(mesh)))
    return _shard_carry(mesh, initial_wave_carry(
        gather_tree(fc), gather_tree(sides), explain=explain))


def build_sharded_fused_wave_step(
    args: LoadAwareArgs,
    num_gangs: int,
    num_groups: int,
    waves: int,
    mesh: Mesh,
    active_axes=None,
    explain=None,
    prod: bool = False,
    claims: bool = False,
    res: bool = False,
    score_passes=(),
):
    """The fused multi-wave step (models/fused_waves.build_fused_wave_step)
    over the mesh: (FullChainInputs, WaveSideInputs), node fields sharded
    -> FusedWaveOut (+ ExplainOut), every output replicated. The node
    fields are gathered (parallel/mesh.gather) and the single-device wave
    body runs on them: kernel 1, its replay and the stage-count pass on
    the card, the plain passes on the CPU. A mesh of cards
    (``mesh.exchange``) runs the same wave body over its shards with
    CardBackend's passes, gathering nothing."""
    from koordinator_tpu_torch.models.fused_waves import (
        FusedWaveOut,
        build_fused_wave_step,
    )

    kw = dict(active_axes=active_axes, explain=explain, prod=prod,
              claims=claims, res=res, score_passes=score_passes)
    inner = build_fused_wave_step(args, num_gangs, num_groups, waves, **kw)
    xinner = (build_fused_wave_step(args, num_gangs, num_groups, waves,
                                    backend=CardBackend(mesh), **kw)
              if mesh.exchange else None)

    def run(fc: FullChainInputs, sides, extra):
        if mesh.exchange:
            out = xinner(hybrid(fc), hybrid(sides), *extra)
        else:
            out = inner(gather_tree(fc), gather_tree(sides), *extra)
        fw = out if explain is None else out[0]
        fw = FusedWaveOut(*(replicate(t, mesh) for t in fw[:5]),
                          waves_run=fw.waves_run)
        if explain is None:
            return fw
        ex = out[1]
        return fw, ExplainOut(
            replicate(ex.stage_counts, mesh),
            replicate(ex.terms, mesh) if ex.terms is not None else None)

    if explain is None:
        def step(fc: FullChainInputs, sides):
            return run(fc, sides, ())
    else:
        def step(fc: FullChainInputs, sides, n_real):
            return run(fc, sides, (n_real,))

    return step


def build_sharded_chained_wave_step(
    args: LoadAwareArgs,
    num_gangs: int,
    num_groups: int,
    mesh: Mesh,
    active_axes=None,
    explain=None,
    prod: bool = False,
    claims: bool = False,
    res: bool = False,
    score_passes=(),
):
    """One chained wave (models/fused_waves.build_chained_wave_step) over
    the mesh: (FullChainInputs, carry, WaveSideInputs) -> (carry',
    WaveChainOut[, counts_row]). The carry's node-axis slots come back on
    their shards (wave_carry_shardings); the per-wave rows come back
    replicated for the host merge (parallel/mesh.merge_readback).
    ``initial_sharded_wave_carry`` builds the wave-0 carry. Each call
    gathers the node fields and runs the single-device wave body, as
    build_sharded_fused_wave_step does; a mesh of cards runs it over its
    shards with CardBackend's passes, the carry's node-axis slots staying
    on their shards."""
    from koordinator_tpu_torch.models.fused_waves import (
        WaveChainOut,
        build_chained_wave_step,
    )

    kw = dict(active_axes=active_axes, explain=explain, prod=prod,
              claims=claims, res=res, score_passes=score_passes)
    inner = build_chained_wave_step(args, num_gangs, num_groups, **kw)
    xinner = (build_chained_wave_step(args, num_gangs, num_groups,
                                      backend=CardBackend(mesh), **kw)
              if mesh.exchange else None)

    def run(fc: FullChainInputs, carry, sides, extra):
        if mesh.exchange:
            out = xinner(hybrid(fc), tuple(hybrid(t) for t in carry),
                         hybrid(sides), *extra)
        else:
            out = inner(gather_tree(fc), tuple(gather(t) for t in carry),
                        gather_tree(sides), *extra)
        wrapped = (_shard_carry(mesh, out[0]),
                   WaveChainOut(*(replicate(t, mesh) for t in out[1])))
        if explain is None:
            return wrapped
        return wrapped + (replicate(out[2], mesh),)

    if explain is None:
        def step(fc: FullChainInputs, carry, sides):
            return run(fc, carry, sides, ())
    else:
        def step(fc: FullChainInputs, carry, sides, n_real):
            return run(fc, carry, sides, (n_real,))

    return step
