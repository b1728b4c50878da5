"""The port's gRPC scheduling sidecar against the JAX package's, on the CPU.

tests/test_sidecar.py's cases run on the port: every FullChainInputs field
survives the wire, the handler equals the direct step, custom and
explicitly-zero weights ride along, a real gRPC socket serves. Then the
two packages meet: the port's sidecar_pb2 carries the JAX package's
serialized descriptor byte for byte (both import in one process), the two
packs of one seeded cluster parse to equal requests, and each package's
client gets the other package's server's bindings. The fallback runs the
local step on transport failures only (UNAVAILABLE, DEADLINE_EXCEEDED,
CANCELLED, ConnectionError, OSError), counts it, and lands the batch on the
device the caller names: a CUDA request where there is none raises, it
never runs on the CPU instead. Last, ``Scheduler(sidecar_address=)`` over a
port server against the JAX Scheduler over a JAX server, cycle 0 and two
churn cycles: bindings, the canonical dump (PodScheduled messages), the
demotion reasons and the fallback count.

Tolerance: bindings (``chosen``) are bit-identical everywhere; the port's
``requested`` and ``quota_used`` over the wire equal its in-process round's
exactly (the same plain round on the same arrays).
"""

from __future__ import annotations

import contextlib

import grpc
import numpy as np
import pytest

from koordinator_tpu.api import objects as ref_objects
from koordinator_tpu.api.resources import ResourceList as RefResourceList
from koordinator_tpu.client.store import ObjectStore as RefObjectStore
from koordinator_tpu.models.full_chain import (
    build_full_chain_step as ref_build_step,
)
from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs
from koordinator_tpu.scheduler import sidecar as ref_sidecar
from koordinator_tpu.scheduler import sidecar_pb2 as ref_pb2
from koordinator_tpu.scheduler.cycle import Scheduler as RefScheduler
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_pack,
)
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.api.objects import Node, ObjectMeta, Pod, PodSpec
from koordinator_tpu_torch.api.resources import ResourceList, ResourceName
from koordinator_tpu_torch.client.store import KIND_NODE, KIND_POD, ObjectStore
from koordinator_tpu_torch.models.convert import to_device
from koordinator_tpu_torch.models.full_chain import build_best_full_chain_step
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
from koordinator_tpu_torch.scheduler import sidecar_pb2
from koordinator_tpu_torch.scheduler.cycle import Scheduler
from koordinator_tpu_torch.scheduler.sidecar import (
    SidecarClient,
    SidecarServer,
    pack_request,
    schedule_batch_or_fallback,
    serve_sidecar,
    tensor_to_np,
    unpack_request,
)
from koordinator_tpu_torch.scheduler.snapshot import build_full_chain_inputs
from koordinator_tpu_torch.sim.faults import DeadSidecarClient
from koordinator_tpu_torch.testing import synth_full_cluster
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    churn_store,
    cycle_dump,
    store_from_state,
)

GIB = 1024 ** 3


def _fixture(seed=3, nodes=16, pods=24, args=None):
    args = args or LoadAwareArgs()
    _cluster, state = synth_full_cluster(nodes, pods, seed=seed)
    fc, _pods, _nb, _tree, _gi, ng, ngroups = build_full_chain_inputs(
        state, args)
    return args, fc, ng, ngroups


def _ref_fixture(seed=3, nodes=16, pods=24):
    args = RefArgs()
    _cluster, state = ref_synth(nodes, pods, seed=seed)
    fc, _pods, _nb, _tree, _gi, ng, ngroups = ref_pack(state, args)
    return args, fc, ng, ngroups


def _direct(args, fc, ng, ngroups):
    """The port's round on the CPU: the plain round."""
    step = build_best_full_chain_step(args, ng, ngroups)
    return tuple(x.numpy() for x in step(to_device(fc, "cpu")))


@contextlib.contextmanager
def _served(address, server):
    try:
        yield server
    finally:
        server.stop(0)


# ---------------------------------------------------------------------------
# tests/test_sidecar.py's cases on the port
# ---------------------------------------------------------------------------


def test_pack_unpack_roundtrip_preserves_every_field():
    args, fc, ng, ngroups = _fixture()
    fc2, _args2 = unpack_request(pack_request(fc, ng, ngroups, args),
                                 device="cpu")
    for name, value in fc._asdict().items():
        pairs = (fc.base._asdict().items() if name == "base"
                 else [(name, value)])
        for field, want in pairs:
            src = fc2.base if name == "base" else fc2
            got = getattr(src, field).numpy()
            np.testing.assert_array_equal(np.asarray(want), got,
                                          err_msg=field)
            assert np.asarray(want).dtype == got.dtype, field
            assert getattr(src, field).device.type == "cpu"


def test_in_process_handler_matches_direct_step():
    args, fc, ng, ngroups = _fixture()
    direct = _direct(args, fc, ng, ngroups)
    server = SidecarServer(device="cpu")
    resp = server.ScheduleBatch(pack_request(fc, ng, ngroups, args))
    np.testing.assert_array_equal(tensor_to_np(resp.chosen), direct[0])
    np.testing.assert_array_equal(tensor_to_np(resp.requested), direct[1])
    np.testing.assert_array_equal(tensor_to_np(resp.quota_used), direct[2])
    assert resp.kernel_seconds > 0
    assert server.last_backend == "serial"
    assert set(server.last_timings) == {"unpack", "upload", "round",
                                        "readback", "respond"}
    # second call with the same shapes reuses the cached step
    server.ScheduleBatch(pack_request(fc, ng, ngroups, args))
    assert len(server._steps) == 1
    # a different shape builds a second entry
    args3, fc3, ng3, ngroups3 = _fixture(seed=9, nodes=10, pods=12)
    server.ScheduleBatch(pack_request(fc3, ng3, ngroups3, args3))
    assert len(server._steps) == 2


def test_handler_equals_the_in_process_call():
    """ScheduleBatch and schedule_batch run the same keyed step: one
    cache entry, equal outputs."""
    args, fc, ng, ngroups = _fixture(seed=4)
    server = SidecarServer(device="cpu")
    local = server.schedule_batch(fc, args, ng, ngroups)
    resp = server.ScheduleBatch(pack_request(fc, ng, ngroups, args))
    for got, want in zip((resp.chosen, resp.requested, resp.quota_used),
                         local):
        np.testing.assert_array_equal(tensor_to_np(got), want)
    assert len(server._steps) == 1


def test_custom_resource_weights_survive_the_wire():
    """args.resource_weights feed the step's scores: the sidecar must
    transport them, not rebuild defaults server-side."""
    args = LoadAwareArgs(resource_weights={ResourceName.CPU: 3,
                                           ResourceName.MEMORY: 1})
    args, fc, ng, ngroups = _fixture(seed=21, args=args)
    direct = _direct(args, fc, ng, ngroups)
    resp = SidecarServer(device="cpu").ScheduleBatch(
        pack_request(fc, ng, ngroups, args))
    np.testing.assert_array_equal(tensor_to_np(resp.chosen), direct[0])
    _fc2, args2 = unpack_request(pack_request(fc, ng, ngroups, args),
                                 device="cpu")
    assert args2.resource_weights == {ResourceName.CPU: 3,
                                      ResourceName.MEMORY: 1}


def test_explicit_zero_weight_survives_the_wire():
    args = LoadAwareArgs(resource_weights={ResourceName.CPU: 2,
                                           ResourceName.MEMORY: 0})
    args, fc, ng, ngroups = _fixture(seed=13, nodes=8, pods=8, args=args)
    _fc2, args2 = unpack_request(pack_request(fc, ng, ngroups, args),
                                 device="cpu")
    assert args2.resource_weights == {ResourceName.CPU: 2.0,
                                      ResourceName.MEMORY: 0.0}


def test_old_client_wire_forms_are_normalized():
    """A 1-D vol_needed and a missing node_vol_group (clients predating the
    volume groups) unpack to the VG == 1 form and bind the same."""
    args, fc, ng, ngroups = _fixture(seed=6)
    assert fc.vol_needed.shape[1] == 1
    req = pack_request(fc, ng, ngroups, args)
    req.inputs["vol_needed"].CopyFrom(
        sidecar_pb2.Tensor(shape=[fc.vol_needed.shape[0]], dtype="float32",
                           data=np.asarray(fc.vol_needed[:, 0]).tobytes()))
    del req.inputs["node_vol_group"]
    fc2, _ = unpack_request(req, device="cpu")
    assert tuple(fc2.vol_needed.shape) == tuple(fc.vol_needed.shape)
    assert not fc2.node_vol_group.any()
    resp = SidecarServer(device="cpu").ScheduleBatch(req)
    np.testing.assert_array_equal(tensor_to_np(resp.chosen),
                                  _direct(args, fc, ng, ngroups)[0])


def test_unpack_lands_on_the_named_device(monkeypatch):
    """The server's device is where the arrays land: asking for CUDA where
    there is none raises instead of landing them on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, fc, ng, ngroups = _fixture()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        unpack_request(pack_request(fc, ng, ngroups, args))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SidecarServer()


def test_over_real_grpc_socket(tmp_path):
    args, fc, ng, ngroups = _fixture(seed=5)
    direct = _direct(args, fc, ng, ngroups)
    address = f"unix://{tmp_path}/sidecar.sock"
    with _served(address, serve_sidecar(address, device="cpu")):
        client = SidecarClient(address)
        try:
            resp = client.schedule_batch(
                pack_request(fc, ng, ngroups, args, snapshot_version=7))
        finally:
            client.close()
    for got, want in zip((resp.chosen, resp.requested, resp.quota_used),
                         direct):
        np.testing.assert_array_equal(tensor_to_np(got), want)
    assert resp.snapshot_version == 7
    assert resp.kernel_seconds > 0


# ---------------------------------------------------------------------------
# the two packages on one wire
# ---------------------------------------------------------------------------


def test_descriptor_is_the_reference_descriptor():
    """Both modules are loaded in this process; they register one proto
    file, which only works because the serialized descriptors are the
    same bytes (file name and package included)."""
    assert (sidecar_pb2.DESCRIPTOR.serialized_pb
            == ref_pb2.DESCRIPTOR.serialized_pb)
    assert sidecar_pb2.DESCRIPTOR.package == "koordinator.scheduler.v1"
    assert (sidecar_pb2.DESCRIPTOR.services_by_name["BatchedScheduler"]
            .full_name == ref_sidecar.SERVICE_NAME)


@pytest.mark.parametrize("seed", [3, 11])
def test_reference_and_port_requests_parse_equal(seed):
    """One seeded cluster packed by each package: the two requests parse to
    equal messages, every field and the weights included."""
    args, fc, ng, ngroups = _fixture(seed=seed)
    rargs, rfc, rng_, rngroups = _ref_fixture(seed=seed)
    port_req = sidecar_pb2.ScheduleBatchRequest.FromString(
        pack_request(fc, ng, ngroups, args,
                     snapshot_version=3).SerializeToString())
    ref_req = sidecar_pb2.ScheduleBatchRequest.FromString(
        ref_sidecar.pack_request(rfc, rng_, rngroups, rargs,
                                 snapshot_version=3).SerializeToString())
    assert set(port_req.inputs) == set(ref_req.inputs)
    assert port_req == ref_req


def test_reference_client_against_port_server(tmp_path):
    rargs, rfc, rng_, rngroups = _ref_fixture(seed=5)
    want = np.asarray(ref_build_step(rargs, rng_, rngroups)(rfc)[0])
    address = f"unix://{tmp_path}/port.sock"
    with _served(address, serve_sidecar(address, device="cpu")):
        client = ref_sidecar.SidecarClient(address)
        try:
            resp = client.schedule_batch(ref_sidecar.pack_request(
                rfc, rng_, rngroups, rargs, snapshot_version=5))
        finally:
            client.close()
    np.testing.assert_array_equal(ref_sidecar.tensor_to_np(resp.chosen),
                                  want)
    assert resp.snapshot_version == 5


def test_port_client_against_reference_server(tmp_path):
    args, fc, ng, ngroups = _fixture(seed=5)
    want = _direct(args, fc, ng, ngroups)[0]
    address = f"unix://{tmp_path}/ref.sock"
    with _served(address, ref_sidecar.serve_sidecar(address)):
        client = SidecarClient(address)
        try:
            chosen, _req, _quota, fell_back = schedule_batch_or_fallback(
                client, fc, ng, ngroups, args, device="cpu")
        finally:
            client.close()
    assert not fell_back
    np.testing.assert_array_equal(chosen, want)


# ---------------------------------------------------------------------------
# the fallback
# ---------------------------------------------------------------------------


class _Status(grpc.RpcError):
    def __init__(self, code):
        super().__init__(code.name)
        self._code = code

    def code(self):
        return self._code


class _Failing:
    """A client whose every call raises ``exc``."""

    def __init__(self, exc):
        self.exc = exc
        self.calls = 0

    def schedule_batch(self, request):
        self.calls += 1
        raise self.exc

    def close(self):
        pass


TRANSPORT = [_Status(grpc.StatusCode.UNAVAILABLE),
             _Status(grpc.StatusCode.DEADLINE_EXCEEDED),
             _Status(grpc.StatusCode.CANCELLED),
             ConnectionError("reset"), OSError("broken pipe")]


@pytest.mark.parametrize("exc", TRANSPORT,
                         ids=["unavailable", "deadline", "cancelled",
                              "connection", "oserror"])
def test_transport_failures_fall_back(exc):
    args, fc, ng, ngroups = _fixture(seed=7)
    client = _Failing(exc)
    chosen, requested, quota_used, fell_back = schedule_batch_or_fallback(
        client, fc, ng, ngroups, args, device="cpu")
    assert fell_back and client.calls == 1
    for got, want in zip((chosen, requested, quota_used),
                         _direct(args, fc, ng, ngroups)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code", [grpc.StatusCode.INVALID_ARGUMENT,
                                  grpc.StatusCode.INTERNAL])
def test_application_errors_raise(code):
    args, fc, ng, ngroups = _fixture(seed=7)
    with pytest.raises(grpc.RpcError):
        schedule_batch_or_fallback(_Failing(_Status(code)), fc, ng, ngroups,
                                   args, device="cpu")


def test_fallback_lands_on_the_callers_device(monkeypatch):
    """The bare fallback builds its step on the device the caller names:
    CUDA where there is none raises, never the CPU instead."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, fc, ng, ngroups = _fixture(seed=7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        schedule_batch_or_fallback(DeadSidecarClient(), fc, ng, ngroups,
                                   args)


def test_unreachable_sidecar_degrades_to_in_process(tmp_path):
    args, fc, ng, ngroups = _fixture(seed=7, nodes=12, pods=16)
    client = SidecarClient(f"unix://{tmp_path}/never-started.sock",
                           timeout_seconds=2.0)
    try:
        chosen, _, _, fell_back = schedule_batch_or_fallback(
            client, fc, ng, ngroups, args, device="cpu")
    finally:
        client.close()
    assert fell_back
    np.testing.assert_array_equal(chosen, _direct(args, fc, ng, ngroups)[0])


def test_killed_sidecar_degrades_to_in_process(tmp_path):
    """The sidecar answering once then dying degrades too; the same client
    object keeps working through the fallback."""
    args, fc, ng, ngroups = _fixture(seed=9, nodes=12, pods=16)
    want = _direct(args, fc, ng, ngroups)[0]
    address = f"unix://{tmp_path}/sidecar.sock"
    server = serve_sidecar(address, device="cpu")
    client = SidecarClient(address, timeout_seconds=30.0)
    try:
        chosen, _, _, fell_back = schedule_batch_or_fallback(
            client, fc, ng, ngroups, args, device="cpu")
        assert not fell_back
        np.testing.assert_array_equal(chosen, want)
        server.stop(0)  # the sidecar dies
        client._timeout = 2.0
        chosen2, _, _, fell_back2 = schedule_batch_or_fallback(
            client, fc, ng, ngroups, args, device="cpu")
        assert fell_back2
        np.testing.assert_array_equal(chosen2, want)
    finally:
        client.close()
        server.stop(0)


# ---------------------------------------------------------------------------
# the Scheduler's sidecar dispatch
# ---------------------------------------------------------------------------


def _small_store():
    store = ObjectStore()
    for i in range(4):
        store.add(KIND_NODE, Node(
            meta=ObjectMeta(name=f"n{i}", namespace=""),
            allocatable=ResourceList.of(cpu=8000, memory=32 * GIB, pods=20)))
    for i in range(6):
        store.add(KIND_POD, Pod(
            meta=ObjectMeta(name=f"p{i}", uid=f"p{i}",
                            creation_timestamp=float(i)),
            spec=PodSpec(requests=ResourceList.of(cpu=1000, memory=GIB))))
    return store


def _bound(res):
    return [(b.pod_key, b.node_name) for b in res.bound]


def test_cycle_driver_runs_through_the_sidecar(tmp_path):
    address = f"unix://{tmp_path}/sidecar.sock"
    server = SidecarServer(device="cpu")
    with _served(address, serve_sidecar(address, server)):
        remote = Scheduler(_small_store(), sidecar_address=address,
                           device="cpu")
        r_remote = remote.run_cycle(now=1_000_000.0)
    r_local = Scheduler(_small_store(), device="cpu").run_cycle(
        now=1_000_000.0)
    assert remote.sidecar_fallbacks == 0
    assert remote.last_backend == "sidecar"
    assert server.last_backend == "serial"
    assert _bound(r_remote) == _bound(r_local)
    assert len(r_remote.bound) == 6


def test_cycle_driver_degrades_when_sidecar_dead(tmp_path):
    before = scheduler_metrics.SIDECAR_FALLBACKS.get() or 0.0
    sched = Scheduler(
        _small_store(), device="cpu",
        sidecar_address=f"unix://{tmp_path}/never-started.sock")
    sched._sidecar_client._timeout = 2.0
    result = sched.run_cycle(now=1_000_000.0)
    assert sched.sidecar_fallbacks == 1
    assert scheduler_metrics.SIDECAR_FALLBACKS.get() - before == 1
    assert len(result.bound) == 6  # the cycle completed via the local step
    # the local step is the Scheduler's own keyed step, on its device
    assert sched.last_backend == "serial"
    assert len(sched._step_cache) == 1


@pytest.mark.parametrize("exc", TRANSPORT[:3],
                         ids=["unavailable", "deadline", "cancelled"])
def test_scheduler_counts_each_transport_fallback(exc):
    sched = Scheduler(_small_store(), device="cpu",
                      sidecar_address="unix:///nonexistent/sidecar.sock")
    sched._sidecar_client = _Failing(exc)
    assert len(sched.run_cycle(now=1_000_000.0).bound) == 6
    assert sched.sidecar_fallbacks == 1


def test_scheduler_surfaces_application_errors():
    sched = Scheduler(_small_store(), device="cpu",
                      sidecar_address="unix:///nonexistent/sidecar.sock")
    sched._sidecar_client = _Failing(
        _Status(grpc.StatusCode.INVALID_ARGUMENT))
    with pytest.raises(grpc.RpcError):
        sched.run_cycle(now=1_000_000.0)
    assert sched.sidecar_fallbacks == 0


def test_sidecar_turns_waves_explain_and_the_mesh_off():
    """The sidecar's ladder skips the waves and explain rungs, and a mesh
    request is ignored with a warning (the RPC is single-device)."""
    sched = Scheduler(ObjectStore(), device="cpu", explain="counts",
                      mesh=4, sidecar_address="unix:///nonexistent/s.sock")
    assert sched._ladder_features() == {"mesh": False, "waves": False,
                                        "explain": False}


NODES, PODS, ARRIVALS = 16, 300, 150


def _arrivals():
    return [arrival_specs(c, ARRIVALS) + [dict(
        name=f"hog-{c}", uid=f"hog-{c}", prio=9000, cpu=10 ** 7,
        mem=GIB)] for c in (1, 2)]


def _drive(sched, store, now, add):
    keys, dumps = [], []
    for c, specs in enumerate([None] + _arrivals()):
        if specs is not None:
            add(store, specs, now + c)
        res = sched.run_cycle(now=now + 2 * c)
        keys.append((_bound(res), list(res.failed), list(res.rejected),
                     list(res.demotions), res.waves))
        dumps.append(cycle_dump(sched))
    return keys, dumps, sched.sidecar_fallbacks


def _reference_sidecar_run(address):
    _cluster, state = ref_synth(NODES, PODS, seed=4,
                                num_quotas=max(8, PODS // 100),
                                num_gangs=max(4, PODS // 50))
    store = store_from_state(state, RefObjectStore())
    server = ref_sidecar.serve_sidecar(address)
    try:
        sched = RefScheduler(store, sidecar_address=address,
                             explain="counts", mesh="off", warmup="off")
        return _drive(sched, store, state.now, lambda s, specs, t:
                      add_arrivals(s, specs, t, objects=ref_objects,
                                   resource_list=RefResourceList))
    finally:
        server.stop(0)


def test_scheduler_over_sidecar_matches_reference(tmp_path):
    """Default waves ("auto") and explain "counts" on both sides: every
    cycle demotes with reasons sidecar and explain-sidecar, and the
    bindings, failure lists, PodScheduled messages and fallback count
    equal the JAX Scheduler's over its own sidecar."""
    ref = _reference_sidecar_run(f"unix://{tmp_path}/ref.sock")
    store, state = churn_store(NODES, PODS, seed=4)
    address = f"unix://{tmp_path}/port.sock"
    with _served(address, serve_sidecar(address, device="cpu")):
        sched = Scheduler(store, sidecar_address=address, explain="counts",
                          device="cpu")
        port = _drive(sched, store, state.now, add_arrivals)
    assert port == ref
    keys, _dumps, fallbacks = port
    assert fallbacks == 0
    assert all("explain-sidecar" in k[3] for k in keys)
    assert "sidecar" in keys[0][3]


def test_in_process_round_needs_no_grpc():
    """grpc and google.protobuf hidden: the sidecar module, the cycle and
    the in-process round still import and run; only the transport needs
    them."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "class Hide:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'grpc' or name.startswith("
        "'google.protobuf'):\n"
        "            raise ImportError('hidden: ' + name)\n"
        "sys.meta_path.insert(0, Hide())\n"
        "from koordinator_tpu_torch.scheduler.sidecar import SidecarServer\n"
        "import koordinator_tpu_torch.scheduler.cycle\n"
        "from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs\n"
        "from koordinator_tpu_torch.scheduler.snapshot import "
        "build_full_chain_inputs\n"
        "from koordinator_tpu_torch.testing import synth_full_cluster\n"
        "_, st = synth_full_cluster(4, 6, seed=1)\n"
        "fc, _p, _n, _t, _g, ng, ngroups = build_full_chain_inputs("
        "st, LoadAwareArgs())\n"
        "out = SidecarServer(device='cpu').schedule_batch("
        "fc, LoadAwareArgs(), ng, ngroups)\n"
        "bad = [m for m in sys.modules if m.startswith(('grpc', "
        "'google.protobuf'))]\n"
        "print(bad, (out[0] >= 0).sum())\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
