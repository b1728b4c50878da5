"""The port's node-side binaries and the colocation loop against the JAX
package's.

The cases of test_cmd_binaries.py (the koordlet, demo, runtime proxy and
cmd-helper cases; the descheduler/manager case is in test_torch_cmd.py)
and test_colocation_e2e.py run on the port under their reference names
(tests/test_torch_cases.py), with the port's device passes put on the CPU
and the koordlet's tick interval at 0. Then the demo's colocation loop in
both packages: the same log lines, bindings and BE cgroup values; and the
runtime proxy binary between a fake containerd and the hook server.
"""

from __future__ import annotations

import test_torch_cases as torch_cases

# the koordlet binary's tick interval at 0
_KOORDLET_INTERVAL = [
    ('"--interval", "0.01"]) == 0\n\n\ndef test_demo',
     '"--interval", "0"]) == 0\n\n\ndef test_demo'),
]

torch_cases.export(
    torch_cases.port_module(
        "test_cmd_binaries", _KOORDLET_INTERVAL,
        on_cpu=("test_scheduler_main_binds_pods:main",
                "test_demo_runs_colocation_loop:main")), globals(),
    leave_out=("test_descheduler_and_manager_mains",))
torch_cases.export(
    torch_cases.port_module("test_colocation_e2e",
                            on_cpu=("Manager", "Scheduler")),
    globals())


def test_demo_loop_matches_reference(capsys):
    """The demo's colocation loop in both packages, with its defaults (the
    port's on the CPU): the same log, line for line, but for the kernel's
    milliseconds."""
    import re

    from koordinator_tpu.cmd import demo as ref_demo

    from koordinator_tpu_torch.cmd import demo

    def log(main, argv):
        assert main(argv) == 0
        return re.sub(r"\(\d+(\.\d+)?ms kernel\)", "(kernel)",
                      capsys.readouterr().err).splitlines()

    ref = log(ref_demo.main, [])
    port = log(demo.main, ["--device", "cpu"])
    assert port == ref
    bound = [ln for ln in port if ln.startswith("[koord-scheduler] bound")]
    assert bound == ["[koord-scheduler] bound 2 BE pods (kernel): "
                     "['default/spark-0', 'default/spark-1']"]
    assert "[koordlet] BE cgroups enforced: cfs_quota=200000 bvt=-1" in port
    assert port[-1].startswith("demo complete")


def test_koordlet_binary_logs_its_device_cr(capsys, monkeypatch):
    """The port's koordlet binary logs the Device CR its node published:
    the devices its statesinformer's probe (stubbed here) reported."""
    from koordinator_tpu_torch.api.objects import DeviceInfo
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.cmd import koordlet
    from koordinator_tpu_torch.koordlet import statesinformer

    card = DeviceInfo(type="gpu", uuid="GPU-5c1e0d2a", minor=0, health=True,
                      numa_node=0, resources=ResourceList.of(
                          gpu_core=100, gpu_memory=80 * 1024**3,
                          gpu_memory_ratio=100))
    monkeypatch.setattr(statesinformer, "collect_gpu_devices",
                        lambda: [card])
    assert koordlet.main(["--fake-node", "--max-ticks", "2",
                          "--interval", "0"]) == 0
    err = capsys.readouterr().err.splitlines()
    assert err[-1] == "koordlet: Device CR gpu/0/GPU-5c1e0d2a"


def test_runtime_proxy_binary_lands_the_hook_writes():
    """cmd/koord_runtime_proxy.py as a child process between a fake
    containerd and the koordlet's hook server (chip_smoke.py's
    node_binaries round trip, which needs no card): a BE pod's
    CreateContainer reaches containerd with the hook's cgroup writes."""
    from koordinator_tpu_torch.testing.cri import binary_roundtrip

    out = binary_roundtrip()
    assert out["method"] == "CreateContainer"
    assert out["forwarded"]["cpu.bvt_warp_ns"] == "-1"
    assert out["forwarded"]["cpu_quota"] == out["hook"]["cpu_quota"] > 0
    assert (out["forwarded"]["memory_limit_in_bytes"]
            == out["hook"]["memory_limit_in_bytes"] == 4 * 1024**3)
