"""The mesh of cards (parallel/, the exchange route) on the CPU.

A mesh whose shards sit on two or more cards of one process exchanges
(``Mesh.exchange``): its scheduling steps run the kernels' exchange
instances on each card over that card's rows. On the CPU the same route
runs the plain sharded pieces (parallel/full_chain_mesh.py CardBackend),
so these tests set ``exchange`` on a mesh of virtual CPU shards and hold
the route's wave body, its per-shard replay and stage counts against the
JAX package's sharded steps (the ``cpu_devices`` fixture's virtual CPU
devices) and the port's single-device steps, tolerance 0. They also check
what needs no card: building a mesh of cards, the refusals (cards across
processes, a pair without peer access), the mailbox layout the wrappers
mirror, the launch device the wrappers select, and the exchange timeout
as a device fault that takes the ladder to the partial-mesh rung with the
JAX package's bindings.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from koordinator_tpu.parallel import (
    build_sharded_fused_wave_step as ref_sharded_fused,
    make_mesh as ref_make_mesh,
    shard_full_chain_inputs as ref_shard_fc,
)

from koordinator_tpu_torch.models import fused_waves as fw
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import kernel_common as kc
from koordinator_tpu_torch.ops import schedule_kernel as sk
from koordinator_tpu_torch.parallel import full_chain_mesh as fcm
from koordinator_tpu_torch.parallel import mesh as pm
from koordinator_tpu_torch.parallel.mesh import MeshDevice, make_mesh
from koordinator_tpu_torch.scheduler import degrade
from koordinator_tpu_torch.testing.mesh_round import virtual_mesh

CSRC = Path(fck.__file__).resolve().parent.parent / "csrc"


def _cards_mesh(n_cards=2, per_card=2):
    return make_mesh([MeshDevice(k, torch.device("cuda", k // per_card))
                      for k in range(n_cards * per_card)])


def _host(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# building a mesh of cards
# ---------------------------------------------------------------------------

def test_mesh_of_two_cards_builds_without_touching_a_card(monkeypatch):
    def no_card(*_a, **_k):
        raise AssertionError("building a mesh touched CUDA")

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    mesh = _cards_mesh()
    assert mesh.exchange and mesh.size == 4
    assert mesh.cards == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.card_shards()[1] == (torch.device("cuda", 1), [2, 3])
    # the partial-mesh rung keeps the route, on the surviving card too
    sub = pm.surviving_submesh(mesh, {2, 3})
    assert sub.exchange and sub.cards == [torch.device("cuda", 0)]


def test_card_mesh_across_processes_raises_the_narrowed_message():
    with pytest.raises(NotImplementedError) as err:
        make_mesh([MeshDevice(0, torch.device("cuda", 0), 0),
                   MeshDevice(1, torch.device("cuda", 1), 1)])
    assert str(err.value) == pm.CROSS_PROCESS_CARDS
    # a CPU mesh across processes (gloo) is still a mesh
    arr = np.empty(2, dtype=object)  # element-wise: a device is a tuple
    arr[0] = MeshDevice(0, torch.device("cpu"), 0)
    arr[1] = MeshDevice(1, torch.device("cpu"), 1)
    cpu = pm.Mesh(arr.reshape(1, 2))
    assert cpu.spans_processes and not cpu.exchange


def test_peer_access_refusal_names_the_pair_and_builds_nothing(monkeypatch):
    asked = []

    def refuse(a, b):
        asked.append((a, b))
        return False

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", refuse)
    mesh = _cards_mesh()
    with pytest.raises(RuntimeError, match=r"cuda:0 cannot reach cuda:1"):
        mesh.check_peer_access()
    with pytest.raises(RuntimeError, match="peer access"):
        mesh.mailboxes()
    assert mesh._mailboxes is None and asked


# ---------------------------------------------------------------------------
# the mailbox layout and the launch device
# ---------------------------------------------------------------------------

def _constant(text: str, name: str) -> int:
    return int(re.search(rf"{name}\s*=\s*(\d+)", text).group(1))


def test_mailbox_layout_mirrors_the_kernels():
    common = (CSRC / "kernel_common.cuh").read_text()
    full = (CSRC / "full_chain.cu").read_text()
    step = (CSRC / "schedule_step.cu").read_text()
    assert _constant(common, "kMaxLocalShards") == kc.MAX_LOCAL_SHARDS
    assert _constant(common, "kMaxShards") == kc.MAX_SHARDS
    assert _constant(full, "kWinHead") == fck.WIN_HEAD
    assert _constant(full, "kResHead") == fck.RES_HEAD
    assert _constant(step, "kPayloadWords") == sk.PAYLOAD_WORDS
    assert _constant(step, "kResultWords") == sk.RESULT_WORDS
    # koord::Xchg, field for field: two pointers, the timeout, the first
    # flag, four ints, the shards (80 bytes with the tail's padding)
    body = re.search(r"struct Xchg \{(.*?)\n\};", common, re.S).group(1)
    names = re.findall(r"\b(\w+)(?:\[\w+\])?;", body)
    assert names == [f for f, _ in kc._Xchg._fields_]
    assert ctypes.sizeof(kc._Xchg) == (8 * 3 + 4 * 5
                                       + 4 * kc.MAX_LOCAL_SHARDS + 4)
    # FullChainParams and ScheduleStepParams end with it
    assert fck._Params.x.offset + ctypes.sizeof(kc._Xchg) == ctypes.sizeof(
        fck._Params)
    assert sk._Params.x.offset + ctypes.sizeof(kc._Xchg) == ctypes.sizeof(
        sk._Params)
    # a pair per payload word, an even count (kernel_common.cuh xpairs)
    assert "return (words + 1) & ~1;" in common
    for T in (0, 1, 5, 32):
        # an entry holds the winner's payload and the stats' T + 2 words
        words = fck.payload_words(T)
        assert words >= T + 2
        assert kc.mailbox_shape(4, words) == (2, 4, words + words % 2)
        assert kc.exchange_pairs(T + 2) <= kc.exchange_pairs(words)
        assert fck.result_words(T) % 2 == 0
        assert fck.result_words(T) >= fck.RES_HEAD + T
        # the exchange's regions, 16-aligned, in every layout: mbarriers,
        # results, the polling warp's staging area
        base = fck.estimate_smem_bytes(640, 3, 2, 2, 10, 3, T, 4, 1)
        xw = fck.result_words(T)
        extra = sum((n + 15) & ~15 for n in (
            16, 2 * xw * 4, kc.MAX_SHARDS * kc.exchange_pairs(words) * 4))
        assert fck.estimate_smem_bytes(640, 3, 2, 2, 10, 3, T, 4, 1,
                                       exchange=True) == base + extra
    extra = sum((n + 15) & ~15 for n in (
        16, 2 * sk.RESULT_WORDS * 4,
        kc.MAX_SHARDS * kc.exchange_pairs(sk.PAYLOAD_WORDS) * 4))
    assert sk.estimate_smem_bytes(640, 14, 2, exchange=True) == (
        sk.estimate_smem_bytes(640, 14, 2) + extra)


def test_mailboxes_group_shards_by_card_and_raise_the_sequence():
    box = kc.Mailboxes([torch.device("cuda", 0)] * 2
                       + [torch.device("cuda", 1)] * 2, [10, 11, 12, 13])
    assert box.cards() == {torch.device("cuda", 0): [0, 1],
                           torch.device("cuda", 1): [2, 3]}
    first = box.begin(100)
    assert box.begin(10) == first + 101 and first >= 1
    x = kc.Mailboxes.local(4, [2, 3], 640)
    assert (x.D, x.L, x.per, list(x.shard)[:2]) == (4, 2, 640, [2, 3])
    with pytest.raises(ValueError):
        kc.Mailboxes.local(9, list(range(9)), 10)


def _flags(flag0, exchanges):
    return range(flag0, flag0 + exchanges)


def test_mailboxes_never_issue_flag_zero_and_restart_before_the_wrap():
    box = kc.Mailboxes([torch.device("cpu")] * 2, [0, 1])
    box.ensure(fck.payload_words(3))
    assert box.entry_pairs == kc.exchange_pairs(fck.payload_words(3))
    # a flag near the top, left in the mailboxes by earlier launch groups
    pair = ((kc.MAX_FLAG - 1) << 32 | 7) - (1 << 64)  # as an int64
    for b in box.boxes:
        b.fill_(pair)
    box.next_seq = kc.MAX_FLAG - 20
    flag0 = box.begin(20)  # its flags reach MAX_FLAG - 1: no restart
    assert list(_flags(flag0, 20))[-1] == kc.MAX_FLAG - 1
    assert all(int(b.abs().sum()) > 0 for b in box.boxes)
    assert box.begin(1) == 1  # MAX_FLAG + 1 would come next: restart first
    assert all(int(b.abs().sum()) == 0 for b in box.boxes)
    # every group's flags are 32-bit, nonzero and new since the restart
    rng = np.random.default_rng(3)
    box.next_seq = kc.MAX_FLAG - 5000
    seen, restarts = set(), 0
    for _ in range(400):
        n = int(rng.integers(0, 40))
        flag0 = box.begin(n)
        if flag0 == 1:  # a restart: the mailboxes hold no flag any more
            seen, restarts = set(), restarts + 1
        flags = set(_flags(flag0, n))
        assert all(1 <= f <= kc.MAX_FLAG for f in flags)
        assert not flags & seen
        seen |= flags
    assert restarts >= 1
    with pytest.raises(ValueError, match="32-bit"):
        box.begin(kc.MAX_FLAG)


def test_mailboxes_carry_the_time_limit_into_each_launch():
    box = kc.Mailboxes([torch.device("cpu")] * 2, [0, 1])
    box.ensure(fck.payload_words(2))
    flag0 = box.begin(4)
    x = box.xchg(torch.device("cpu"), [1], 8, flag0)
    assert x.timeout_ns == int(kc.EXCHANGE_TIMEOUT_S * 1e9)
    assert (x.flag0, x.D, x.L, x.per, x.shard[0]) == (flag0, 2, 1, 8, 1)
    assert x.entry_pairs == box.entry_pairs


@pytest.mark.parametrize("source", ["full_chain.cu", "schedule_step.cu"])
def test_a_timed_out_block_runs_every_pod_and_waits_no_more(source):
    """Each block times its own wait, so blocks of one cluster may disagree
    about an entry that arrives at the deadline: none may leave the pod
    loop on a missed exchange (its cluster's merges would wait for it), and
    a block that missed one waits on no later exchange."""
    src = (CSRC / source).read_text()
    loop = src[src.index("for (int v = 0; v < nv; ++v)"):]
    loop = loop[:loop.index("cluster.sync();\n  if constexpr (kStateInSmem)")]
    waits = re.findall(r"=\s*(missed \? missed : )?koord::xwait\(", loop)
    assert waits and all(guard for guard in waits)
    assert loop.count("missed = res[0];") == len(waits)
    # the only way out of a pod is to the next pod
    assert "break;" not in loop
    assert "stopped" not in src
    # err takes the missed shards once per block
    assert src.count("if (missing && !missed) atomicOr(p.x.err, missing);") \
        == len(waits)


def test_round_trip_params_mirror_the_kernel():
    from koordinator_tpu_torch.testing import mailbox_rtt

    src = (CSRC / mailbox_rtt.SOURCE).read_text()
    body = re.search(r"struct RttParams \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if decl.strip():
            first, *rest = decl.split(",")
            names += [first.split()[-1].lstrip("*")] + [r.strip() for r in rest]
    assert names == [f for f, _ in mailbox_rtt._RttParams._fields_]
    assert ctypes.sizeof(mailbox_rtt._RttParams) == 8 * 4 + 4 * 4
    # the round trip goes through the exchange's own store and load
    assert "koord::st_pair(" in src and "koord::ld_pairs(" in src


class _Fake:
    """A tensor's device, as the launch-device selection reads it."""

    def __init__(self, device):
        self.device = torch.device(device)


def test_wrappers_launch_on_their_tensors_card(monkeypatch):
    assert kc.launch_device(_Fake("cuda:1"), None,
                            _Fake("cuda:1")) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="one device"):
        kc.launch_device(_Fake("cuda:0"), _Fake("cuda:1"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kc.launch_device(_Fake("cpu"))
    entered = []

    class _Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", _Device)
    with kc.on_device(torch.device("cuda", 1)):
        pass
    assert entered == [torch.device("cuda", 1)]


# ---------------------------------------------------------------------------
# the exchange timeout: a device fault naming the lost card's shards
# ---------------------------------------------------------------------------

def test_exchange_timeout_is_an_attributable_device_fault():
    exc = kc.ExchangeTimeout("full_chain round", [2, 3], [12, 13])
    assert degrade.is_device_fault(exc)
    assert degrade.attributable_device_ids(exc) == frozenset({12, 13})
    assert "shard(s) [2, 3]" in str(exc)
    box = kc.Mailboxes([torch.device("cpu")] * 2, [5, 6])

    class _Err:
        def __init__(self, v):
            self.v = v

        def item(self):
            return self.v

        def zero_(self):
            self.v = 0

    box.errs = {torch.device("cpu"): _Err(0b10)}
    with pytest.raises(kc.ExchangeTimeout) as err:
        box.check("round")
    assert err.value.failed_shards == (1,)
    assert err.value.failed_device_ids == (6,)


def test_exchange_timeout_takes_the_ladder_to_partial_mesh():
    """The "mesh" fault sequence of tests/test_torch_degrade.py with the
    device loss raised as the exchange's timeout (naming shard 3) on an
    exchanging mesh of 4 virtual CPU shards: the same transitions, retries
    and bindings every cycle as the JAX package's device-loss run."""
    import test_torch_degrade as td

    pods, kwargs, faults, walk = td.CONFIGS["mesh"]
    _c, state = td.synth_full_cluster(td.NODES, pods, seed=5, num_quotas=8,
                                      num_gangs=4)
    store = td.store_from_state(state)
    mesh = virtual_mesh(kwargs["mesh"], "cpu")
    mesh.exchange = True
    sched = td.Scheduler(store, device="cpu", dispatch_deadline_ms=300,
                         ladder=degrade.DegradationLadder(promote_after=2),
                         **dict(kwargs, mesh=mesh))
    plan = td._plan(td.port_faults, faults)

    class _AsTimeout:
        """The plan's hooks, its device loss raised as the exchange's
        timeout."""

        def __init__(self, plan):
            self.plan = plan
            self.injected = plan.injected

        def dispatch_hook(self, stage):
            try:
                self.plan.dispatch_hook(stage)
            except td.port_faults.DeviceLossFault as exc:
                ids = sorted(exc.failed_device_ids)
                raise kc.ExchangeTimeout(stage, ids, ids) from exc

        def __getattr__(self, name):
            return getattr(self.plan, name)

    got = td._drive(sched, store, state, _AsTimeout(plan), td.port_metrics,
                    td.add_arrivals)
    want = td._reference("mesh")
    for c, (a, b) in enumerate(zip(got[0], want[0])):
        assert a == b, f"cycle {c}"
    # the transitions' reasons name each package's own exception
    def strip(ts):
        return [{k: v for k, v in t.items() if k != "reason"} for t in ts]

    assert strip(got[1]) == strip(want[1]) and got[2] == want[2]
    assert "ExchangeTimeout" in got[1][0]["reason"]
    assert [(t["from"], t["to"]) for t in got[1]] == walk
    assert sched.mesh.exchange


# ---------------------------------------------------------------------------
# the route itself, on virtual CPU shards
# ---------------------------------------------------------------------------

def _exchanging(depth):
    mesh = virtual_mesh(depth, "cpu")
    mesh.exchange = True
    return mesh


@pytest.mark.parametrize("depth", [2, 4])
def test_card_route_wave_steps_match_the_jax_sharded_steps(cpu_devices,
                                                           depth,
                                                           monkeypatch):
    """The fused K = 4 step (explain "full") and the chained step on the
    exchange route: no node field is gathered, every wave row and count
    equals the single-device step's and the fused rows the JAX sharded
    fused step's; the carry's node-axis slots stay on their shards."""
    from test_torch_fused_waves import _args, _fc, _ref_args, _ref_fc, _sides
    from test_torch_parallel import _ref_shard_sides, _shard_sides

    def no_gather(*_a, **_k):
        raise AssertionError("the exchange route gathered node rows")

    monkeypatch.setattr(fcm, "gather", no_gather)
    monkeypatch.setattr(fcm, "gather_tree", no_gather)
    fc, sides, b = fw_world("synth")
    kw = dict(active_axes=b["active_axes"], prod=b["prod"],
              claims=b["claims"], res=b["res"])
    n_real = int(np.asarray(fc.base.node_ok).sum())
    single = fw.build_fused_wave_step(
        _args(False), b["num_gangs"], b["num_groups"], waves=4,
        explain="full", **kw)(_fc(fc), _sides(sides), n_real)
    mesh = _exchanging(depth)
    sfc = fcm.shard_full_chain_inputs(fc, mesh)
    ssides = _shard_sides(sides, mesh)
    out, ex = fcm.build_sharded_fused_wave_step(
        _args(False), b["num_gangs"], b["num_groups"], 4, mesh,
        explain="full", **kw)(sfc, ssides, n_real)
    fields = ("bind_pods", "bind_nodes", "bind_zones", "bind_res",
              "wave_counts")
    for k in fields:
        np.testing.assert_array_equal(getattr(single[0], k).numpy(),
                                      _host(getattr(out, k)), err_msg=k)
    np.testing.assert_array_equal(single[1].stage_counts.numpy(),
                                  _host(ex.stage_counts))
    np.testing.assert_array_equal(single[1].terms.numpy(), _host(ex.terms))
    rm = ref_make_mesh(cpu_devices[:depth])
    ref = ref_sharded_fused(
        _ref_args(False), b["num_gangs"], b["num_groups"], 4, rm, **kw)(
            ref_shard_fc(_ref_fc(fc), rm), _ref_shard_sides(sides, rm, b))
    for k in fields:
        np.testing.assert_array_equal(_host(getattr(ref, k)),
                                      _host(getattr(out, k)), err_msg=k)
    cstep = fw.build_chained_wave_step(_args(False), b["num_gangs"],
                                       b["num_groups"], explain="counts",
                                       **kw)
    sstep = fcm.build_sharded_chained_wave_step(
        _args(False), b["num_gangs"], b["num_groups"], mesh,
        explain="counts", **kw)
    pfc, psides = _fc(fc), _sides(sides)
    carry = fw.initial_wave_carry(pfc, psides)
    scarry = fcm.initial_sharded_wave_carry(sfc, ssides, mesh)
    for _w in range(3):
        carry, rows, counts = cstep(pfc, carry, psides, n_real)
        scarry, srows, scounts = sstep(sfc, scarry, ssides, n_real)
        for a, s in zip(rows, srows):
            np.testing.assert_array_equal(a.numpy(), _host(s))
        np.testing.assert_array_equal(counts.numpy(), _host(scounts))
    assert len(scarry[1].shards) == depth and not scarry[1].replicated
    np.testing.assert_array_equal(
        carry[1].numpy(), _host(scarry[1])[:fc.base.allocatable.shape[0]])


def fw_world(name):
    from test_torch_fused_waves import _world_inputs

    return _world_inputs(name)


@pytest.mark.parametrize("depth", [2, 4])
def test_per_shard_replay_and_counts_match_the_single_device(depth):
    """The per-card replay's and stage count's plain versions (each shard
    over its own rows, the chosen nodes' domains from their owners) equal
    the single-device replay_kept and explain_stage_counts bit for bit, on
    a world with spread and affinity terms."""
    from test_torch_fused_waves import _fc
    from koordinator_tpu_torch.models.full_chain import (
        cycle_start_state,
        explain_stage_counts,
        permit,
        plain_round,
        resolve_balance_idx,
        resolve_weight_idx,
    )

    fc, _sides, b = fw_world("spread")
    pfc = _fc(fc)
    from test_torch_fused_waves import _args

    args = _args(False)
    wi = resolve_weight_idx(args, b["active_axes"])
    bi = resolve_balance_idx(b["active_axes"])
    chosen = plain_round(pfc, wi, False, bi)[0]
    kept = permit(pfc, chosen, b["num_gangs"], b["num_groups"]) >= 0
    assert bool(kept.any())
    mesh = _exchanging(depth)
    sfc = fcm.hybrid(fcm.shard_full_chain_inputs(fc, mesh))
    per = sfc.base.allocatable.shape[0] // depth
    backend = fcm.CardBackend(mesh)
    N = pfc.base.allocatable.shape[0]
    pad = sfc.base.allocatable.shape[0] - N
    state0 = fcm.replay_state0(pfc, False)
    state0 = tuple(torch.zeros_like(pfc.base.requested) if t is None else t
                   for t in state0)
    want_state, want_zones = fw.replay_kept(pfc, False, state0, chosen, kept)
    sstate0 = fcm.replay_state0(sfc, False)
    sstate0 = sstate0[:2] + (backend.zeros(sfc.base.requested),) + sstate0[3:]
    got_state, got_zones = backend.replay(sfc, chosen, kept, sstate0, False)
    np.testing.assert_array_equal(want_zones.numpy(), got_zones.numpy())
    for i, (a, s) in enumerate(zip(want_state, got_state)):
        s = _host(s)
        if i in fcm._STATE_NODE_SLOTS:
            s = s[:N]
            assert pad >= 0
        np.testing.assert_array_equal(_host(a), s, err_msg=str(i))
    n_real = int(np.asarray(fc.base.node_ok).sum())
    want = explain_stage_counts(pfc, cycle_start_state(pfc), n_real)
    got = backend.counts(sfc, cycle_start_state(sfc), n_real)
    np.testing.assert_array_equal(want.numpy(), got.numpy())
    assert per * depth == sfc.base.allocatable.shape[0]


def test_card_route_refuses_what_it_does_not_take():
    """The exchange instances' wrappers take CUDA tensors only: a
    wrapper handed CPU tensors raises. (The wave worlds the route once
    refused, tests/test_torch_cross_card_worlds.py runs.)"""
    with pytest.raises(ValueError, match="CUDA"):
        sk.schedule_round_cards(
            [(_CpuInputs(), [0])], (0, 1), False,
            kc.Mailboxes([torch.device("cpu")], [0]))


class _CpuInputs:
    allocatable = torch.zeros((4, 3))
    fit_requests = torch.zeros((2, 3))
