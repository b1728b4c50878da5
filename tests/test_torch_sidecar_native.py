"""The port's C++ sidecar client against the port's gRPC server, on the CPU.

native/sidecar_client.cpp is the port's copy of the JAX package's
hand-rolled h2c gRPC client (no grpc++): a non-Python host packing a
batch, calling ScheduleBatch over a real unix socket and reading the
bindings back. native/build.py generates sidecar.pb.cc from the port's
sidecar.proto with protoc and compiles the client into build/native/; the
tests skip only where protoc, g++ or libprotobuf is missing, as the JAX
package's tests/test_sidecar_native.py does. Bindings are bit-identical to
the in-process round, and to the JAX package's XLA step on its own pack of
the same seeded cluster.
"""

from __future__ import annotations

import subprocess

import numpy as np
import pytest

from koordinator_tpu.models.full_chain import (
    build_full_chain_step as ref_build_step,
)
from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_pack,
)
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.native.build import (
    NativeBuildError,
    build_sidecar_client,
)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler import sidecar_pb2
from koordinator_tpu_torch.scheduler.sidecar import (
    SidecarServer,
    pack_request,
    serve_sidecar,
    tensor_to_np,
)
from koordinator_tpu_torch.scheduler.snapshot import build_full_chain_inputs
from koordinator_tpu_torch.testing import synth_full_cluster


@pytest.fixture(scope="module")
def client_bin():
    try:
        return str(build_sidecar_client())
    except NativeBuildError as exc:
        if "not found" in str(exc) or "protobuf" in str(exc):
            pytest.skip(f"C++ toolchain/protobuf unavailable: {exc}")
        raise


def _call(client_bin, sock, request, tmp_path, timeout=300):
    req_file, resp_file = tmp_path / "request.pb", tmp_path / "response.pb"
    req_file.write_bytes(request.SerializeToString())
    proc = subprocess.run(
        [client_bin, str(sock), str(req_file), str(resp_file), str(timeout)],
        capture_output=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr.decode()
    resp = sidecar_pb2.ScheduleBatchResponse()
    resp.ParseFromString(resp_file.read_bytes())
    return resp


@pytest.mark.parametrize("seed", [5, 8])
def test_cpp_client_end_to_end(client_bin, tmp_path, seed):
    """C++ binary -> UDS -> the port's gRPC server -> the round -> C++
    binary: bindings, fit state and quota identical to the in-process
    call, and the JAX package's step on its own pack."""
    args = LoadAwareArgs()
    _c, state = synth_full_cluster(12, 16, seed=seed)
    fc, _p, _n, _t, _g, ng, ngroups = build_full_chain_inputs(state, args)
    server = SidecarServer(device="cpu")
    local = server.schedule_batch(fc, args, ng, ngroups)
    rargs = RefArgs()
    _c, rstate = ref_synth(12, 16, seed=seed)
    rfc, _p, _n, _t, _g, rng_, rngroups = ref_pack(rstate, rargs)
    want = np.asarray(ref_build_step(rargs, rng_, rngroups)(rfc)[0])

    sock = tmp_path / "sidecar.sock"
    grpc_server = serve_sidecar(f"unix://{sock}", server)
    try:
        resp = _call(client_bin, sock, pack_request(
            fc, ng, ngroups, args, snapshot_version=11), tmp_path)
    finally:
        grpc_server.stop(0)
    for got, exp in zip((resp.chosen, resp.requested, resp.quota_used),
                        local):
        np.testing.assert_array_equal(tensor_to_np(got), exp)
    np.testing.assert_array_equal(tensor_to_np(resp.chosen), want)
    assert resp.snapshot_version == 11
    assert resp.kernel_seconds > 0


def test_cpp_client_rejects_garbage_request(client_bin, tmp_path):
    req_file = tmp_path / "bad.pb"
    req_file.write_bytes(b"\xff" * 64)
    proc = subprocess.run(
        [client_bin, "/nonexistent.sock", str(req_file),
         str(tmp_path / "out.pb"), "5"],
        capture_output=True, timeout=60)
    assert proc.returncode != 0


def test_cpp_client_fails_without_a_server(client_bin, tmp_path):
    args = LoadAwareArgs()
    _c, state = synth_full_cluster(4, 4, seed=1)
    fc, _p, _n, _t, _g, ng, ngroups = build_full_chain_inputs(state, args)
    req_file = tmp_path / "request.pb"
    req_file.write_bytes(pack_request(fc, ng, ngroups,
                                      args).SerializeToString())
    proc = subprocess.run(
        [client_bin, str(tmp_path / "never-started.sock"), str(req_file),
         str(tmp_path / "out.pb"), "5"], capture_output=True, timeout=60)
    assert proc.returncode != 0
    assert not (tmp_path / "out.pb").exists()
