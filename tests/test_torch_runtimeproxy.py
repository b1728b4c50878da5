"""The port's runtime hook surface (koordinator_tpu_torch/runtimeproxy/,
koordlet/hookserver.py, koordlet/nri.py) against the JAX package's.

The cases of test_runtimeproxy.py, test_criserver.py, test_dockerproxy.py,
test_nri.py and the CRI part of test_concurrency_stress.py run on the port
under their reference names (tests/test_torch_cases.py). The generated
protobuf modules and their .proto sources are byte copies of the JAX
package's, so both packages' messages share one descriptor in protobuf's
default pool, and one package's proxy talks to the other's hook server.
"""

from __future__ import annotations

import pytest

import test_torch_cases as torch_cases

# the sidecar case's local round: the port's step takes tensors
_SIDECAR_LOCAL_ROUND = [
    ("local = np.asarray(build_full_chain_step(args, ng, ngroups)(fc)[0])",
     "from koordinator_tpu.models.convert import to_device\n"
     "        local = build_full_chain_step(args, ng, ngroups)("
     "to_device(fc, 'cpu'))[0].numpy()"),
]

for _name, _edits, _on_cpu, _leave_out in (
        ("test_runtimeproxy", _SIDECAR_LOCAL_ROUND, ("serve_sidecar",), ()),
        ("test_criserver", (), (), ()),
        ("test_dockerproxy", (), (), ()),
        ("test_nri", (), (), ()),
        ("test_concurrency_stress", (), (),
         ("test_metriccache_concurrent_add_flush_restore",
          "test_koordlet_server_under_parallel_queries",
          "test_resource_executor_concurrent_batches", "fakefs"))):
    torch_cases.export(
        torch_cases.port_module(_name, _edits, on_cpu=_on_cpu), globals(),
        leave_out=_leave_out)


@pytest.mark.parametrize("module", ["runtimeproxy.api", "runtimeproxy.cri",
                                    "koordlet.nri"])
def test_descriptor_and_sources_are_the_reference_ones(module):
    """protobuf's default pool takes one file name twice only when the
    serialized descriptors are identical: the generated module and its
    .proto are byte copies of the JAX package's."""
    import importlib
    import os

    ref = importlib.import_module(f"koordinator_tpu.{module}_pb2")
    port = importlib.import_module(f"koordinator_tpu_torch.{module}_pb2")
    assert port.DESCRIPTOR.serialized_pb == ref.DESCRIPTOR.serialized_pb
    for suffix in ("_pb2.py", ".proto"):
        paths = [os.path.join(os.path.dirname(m.__file__),
                              module.split(".")[1] + suffix)
                 for m in (ref, port)]
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read(), paths


def _hook_world(package):
    """One node's Daemon and HookHandler in ``package``, with the LSR pod of
    test_runtimeproxy.py's fixture."""
    import importlib
    import json

    def mod(name):
        return importlib.import_module(f"{package}.{name}")

    o = mod("api.objects")
    rl = mod("api.resources").ResourceList
    k = mod("client.store")
    fs = mod("koordlet.util.system").FakeFS()
    store = k.ObjectStore()
    store.add(k.KIND_NODE, o.Node(
        meta=o.ObjectMeta(name="node-0", namespace=""),
        allocatable=rl.of(cpu=16000, memory=64 * 1024**3)))
    store.add(k.KIND_POD, o.Pod(
        meta=o.ObjectMeta(
            name="lsr-pod", uid="uid-1", labels={o.LABEL_POD_QOS: "LSR"},
            annotations={o.ANNOTATION_RESOURCE_STATUS:
                         json.dumps({"cpuset": "0-3"})}),
        spec=o.PodSpec(node_name="node-0",
                       requests=rl.of(cpu=4000, memory=8 * 1024**3),
                       limits=rl.of(cpu=4000, memory=8 * 1024**3)),
        phase="Running"))
    daemon = mod("koordlet.daemon").Daemon(store, "node-0", fs.config,
                                           report_interval_seconds=0,
                                           device_collector=lambda: [])
    return fs, mod("koordlet.hookserver").HookHandler(daemon.runtime_hooks)


@pytest.mark.parametrize("server,client", [
    ("koordinator_tpu", "koordinator_tpu_torch"),
    ("koordinator_tpu_torch", "koordinator_tpu")])
def test_the_two_packages_on_one_hook_socket(tmp_path, server, client):
    """One package's runtime proxy against the other's koordlet hook
    server over a unix socket: the merged sandbox and container calls
    equal those of a proxy and server of one package."""
    import importlib

    def run(server_pkg, client_pkg, sock):
        rp = importlib.import_module(f"{client_pkg}.runtimeproxy")
        hc = importlib.import_module(f"{client_pkg}.runtimeproxy.hookclient")
        pb = importlib.import_module(f"{client_pkg}.runtimeproxy.api_pb2")
        serve = importlib.import_module(
            f"{server_pkg}.runtimeproxy.hookclient").serve_hook_service
        fs, handler = _hook_world(server_pkg)
        srv = serve(handler, sock)
        try:
            hook = hc.HookClient(sock)
            backend = rp.FakeRuntimeBackend()
            proxy = rp.RuntimeProxy(hook, backend)
            proxy.run_pod_sandbox(pb.PodSandboxMeta(
                name="lsr-pod", namespace="default", uid="uid-1",
                labels={"koordinator.sh/qosClass": "LSR"},
                cgroup_parent="kubepods/poduid-1"))
            merged, env = proxy.create_container(
                "uid-1", pb.ContainerMeta(name="main", id="c1"),
                resources=pb.LinuxContainerResources(cpu_shares=1024))
            hook.close()
            return (merged.SerializeToString(deterministic=True),
                    sorted(env.items()) if env else env,
                    [c.method for c in backend.calls])
        finally:
            srv.stop(0)
            fs.cleanup()

    crossed = run(server, client, str(tmp_path / "cross.sock"))
    alone = run(server, server, str(tmp_path / "alone.sock"))
    assert crossed == alone
    assert crossed[2] == ["RunPodSandbox", "CreateContainer"]
