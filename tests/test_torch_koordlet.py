"""The port's koordlet (koordinator_tpu_torch/koordlet/) against the JAX
package's.

The cases of the JAX package's koordlet tests run on the port, each under
its reference name (tests/test_torch_cases.py): test_koordlet.py,
test_koordlet_server.py, test_statesinformer_registry.py,
test_services_qos.py, test_runtimehooks_hooks.py, test_collectors.py
and the koordlet parts of test_concurrency_stress.py (test_kernel_util.py's
run in test_torch_kernel_util.py: its `fs` fixture is a cgroup-v1 FakeFS,
unlike the other modules').
The edits each needs are listed beside it: the port's Scheduler put on the
CPU, and the device probes, which read torch.cuda where the JAX ones read
jax.devices(). Then the twin check (one node through each package's
Daemon, byte for byte), a JAX koordlet's checkpoint restored in the port
without importing the JAX package, the two device probes against a
stubbed torch.cuda, and tests/test_native_perf.py's cases on the port's
perf reader, which builds into build/native/.
"""

from __future__ import annotations

import pytest

import test_torch_cases as torch_cases

_STATESINFORMER_PROBE = [
    ("    import jax\n\n", "    import torch\n\n"),
    ('monkeypatch.setattr(jax, "devices", boom)',
     'monkeypatch.setattr(torch.cuda, "is_available", boom)'),
    ("jax_devices", "cuda_devices"),
    ("collect_tpu_devices", "collect_gpu_devices"),
]


# ---------------------------------------------------------------------------
# the twin check: one node, driven by each package's Daemon
# ---------------------------------------------------------------------------

TWIN_TICKS = 5
GIB = 1024 ** 3
NOW = 1_000_000.0


def _twin_run(package: str, checkpoint_dir=None, outputs=None) -> dict:
    """Drive one node through ``package``'s koordlet Daemon for
    TWIN_TICKS ticks on a FakeFS, with an injected device collector.
    Returns every output a twin is compared by, as text, or, with
    ``checkpoint_dir``, flushes the Daemon's checkpoint there and returns
    ``_cache_state`` of it."""
    import dataclasses
    import importlib
    import os

    def mod(name):
        return importlib.import_module(f"{package}.{name}")

    o = mod("api.objects")
    rl = mod("api.resources").ResourceList
    k = mod("client.store")
    sysutil = mod("koordlet.util.system")
    store = k.ObjectStore()
    fs = sysutil.FakeFS(use_cgroup_v2=True)
    try:
        store.add(k.KIND_NODE, o.Node(
            meta=o.ObjectMeta(name="node-0", namespace=""),
            allocatable=rl.of(cpu=16_000, memory=64 * GIB, pods=110)))
        store.add(k.KIND_NODE_SLO, o.NodeSLO(
            meta=o.ObjectMeta(name="node-0", namespace=""),
            resource_used_threshold_with_be=o.ResourceThresholdStrategy(
                enable=True, cpu_suppress_threshold_percent=65)))
        mod("koordlet.util.machineinfo").write_fake_machine(fs)
        fs.set_proc(
            "meminfo",
            "MemTotal: %d kB\nMemFree: %d kB\nMemAvailable: %d kB\n"
            % (64 * GIB // 1024, 32 * GIB // 1024, 48 * GIB // 1024))
        fs.set_cgroup("", sysutil.CPU_PRESSURE,
                      "some avg10=1.50 avg60=1.00 avg300=0.50 total=12345\n"
                      "full avg10=0.50 avg60=0.30 avg300=0.10 total=2345\n")
        fs.set_cgroup("", sysutil.MEMORY_PRESSURE,
                      "some avg10=0.00 avg60=0.00 avg300=0.00 total=0\n"
                      "full avg10=0.00 avg60=0.00 avg300=0.00 total=0\n")
        pods = [("web", "LS", 4000, ""), ("cache", "LSR", 2000, ""),
                ("be-0", "BE", 2000, sysutil.QOS_BESTEFFORT),
                ("be-1", "BE", 1000, sysutil.QOS_BESTEFFORT)]
        for name, qos, cpu, qos_dir in pods:
            annotations = ({o.ANNOTATION_RESOURCE_STATUS: '{"cpuset": "0-3"}'}
                           if qos == "LSR" else {})
            requests = (rl.of(batch_cpu=cpu, batch_memory=GIB) if qos == "BE"
                        else rl.of(cpu=cpu, memory=2 * GIB))
            store.add(k.KIND_POD, o.Pod(
                meta=o.ObjectMeta(name=name, uid=name,
                                  labels={o.LABEL_POD_QOS: qos},
                                  annotations=annotations),
                spec=o.PodSpec(node_name="node-0", requests=requests,
                               limits=requests),
                phase="Running"))
        be_rel = fs.config.qos_relative_path(sysutil.QOS_BESTEFFORT)
        fs.set_cgroup(be_rel, sysutil.CPU_STAT, "usage_usec 0\n")
        device = o.DeviceInfo(
            type="gpu", uuid="GPU-00000000-0000-0000-0000-000000000000",
            minor=0, health=True, numa_node=0,
            resources=rl.of(gpu_core=100, gpu_memory=80 * GIB,
                            gpu_memory_ratio=100))
        daemon = mod("koordlet.daemon").Daemon(
            store, "node-0", fs.config, report_interval_seconds=0,
            checkpoint_dir=checkpoint_dir, device_collector=lambda: [device])
        status = []
        for tick in range(TWIN_TICKS):
            busy = 1000 + 1500 * tick
            fs.set_proc("stat", f"cpu  {busy} 0 {busy} {8000 + 900 * tick}"
                                " 0 0 0 0 0 0\n")
            for i, (name, _qos, _cpu, qos_dir) in enumerate(pods):
                rel = fs.config.pod_relative_path(qos_dir, name)
                fs.set_cgroup(rel, sysutil.CPU_STAT,
                              f"usage_usec {(i + 1) * 3_000_000 * tick}\n")
                fs.set_cgroup(rel, sysutil.MEMORY_USAGE,
                              str((i + 1) * GIB // 2))
            daemon.run_once(now=NOW + 10 * tick)
            nm = store.get(k.KIND_NODE_METRIC, "/node-0")
            status.append(repr(dataclasses.asdict(nm)))
        if checkpoint_dir is not None:
            daemon.metric_cache.flush(now=NOW + 10 * TWIN_TICKS)
            daemon.prediction.checkpoint()
            return _cache_state(daemon)
        files = {}
        for root, _dirs, names in os.walk(fs.root):
            for name in names:
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    files[os.path.relpath(path, fs.root)] = f.read().hex()
        server = daemon.api_server
        return {
            "files": files,
            "node_metric": status,
            "device": repr(dataclasses.asdict(
                store.get(k.KIND_DEVICE, "/node-0"))),
            "audit": server.handle("/apis/v1/audit", {"size": "10000"})[2],
            "metrics": server.handle("/metrics")[2],
        }
    finally:
        fs.cleanup()


def _plain(x):
    """A dataclass tree as plain values, each class by its name."""
    import dataclasses

    if dataclasses.is_dataclass(x):
        return {"class": type(x).__name__,
                **{f.name: _plain(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {repr(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _cache_state(daemon) -> dict:
    """What a koordlet restart carries: the metric cache's series and KV,
    and the peak predictor's histograms and predictions."""
    cache, pred = daemon.metric_cache, daemon.prediction
    return {
        "series": {repr((k.metric, k.labels)): [list(p) for p in v]
                   for k, v in sorted(cache._series.items(),
                                      key=lambda kv: repr(kv[0]))},
        "kv": _plain(cache._kv),
        "first_seen": pred.first_seen,
        "histograms": {uid: [pred.cpu[uid].to_checkpoint(),
                             pred.mem[uid].to_checkpoint()]
                       for uid in sorted(pred.cpu)},
        "peaks": {uid: pred.predict_peak(uid, now=NOW + 86_400)
                  for uid in sorted(pred.cpu)},
    }


def _restore_state(checkpoint_dir: str) -> dict:
    """The port's Daemon started over ``checkpoint_dir``: its restored
    ``_cache_state``, and whether the JAX package got imported."""
    import sys

    from koordinator_tpu_torch.client.store import ObjectStore
    from koordinator_tpu_torch.koordlet.daemon import Daemon
    from koordinator_tpu_torch.koordlet.util.system import FakeFS

    fs = FakeFS(use_cgroup_v2=True)
    try:
        daemon = Daemon(ObjectStore(), "node-0", fs.config,
                        checkpoint_dir=checkpoint_dir,
                        device_collector=lambda: [])
        state = _cache_state(daemon)
    finally:
        fs.cleanup()
    state["jax_modules"] = sorted(
        m for m in sys.modules if m in ("jax", "koordinator_tpu")
        or m.startswith(("jax.", "koordinator_tpu.")))
    return state


def _fixed_clocks():
    """Pin the wall clock, the perf counter and statvfs, which the two
    runs would otherwise read at different moments."""
    import os
    import time

    time.time = lambda: NOW
    time.perf_counter = lambda: 0.0
    fixed = os.statvfs(os.getcwd())
    os.statvfs = lambda path: fixed


if __name__ == "__main__":
    # a child process of the tests below: the twin (clocks pinned before
    # either package is imported), or a restore that must not import JAX
    import json
    import sys

    if sys.argv[1] == "twin":
        _fixed_clocks()
        print(json.dumps({pkg: _twin_run(pkg) for pkg in
                          ("koordinator_tpu", "koordinator_tpu_torch")}))
    else:
        print(json.dumps(_restore_state(sys.argv[2])))
else:
    for _name, _edits, _on_cpu, _leave_out in (
            ("test_koordlet", (), (), ()),
            ("test_koordlet_server", (), (), ()),
            ("test_statesinformer_registry", _STATESINFORMER_PROBE, (), ()),
            ("test_services_qos", (), ("Scheduler",), ()),
            ("test_runtimehooks_hooks", (), (), ()),
            ("test_collectors", [("sample_tpu_devices", "sample_gpu_devices")],
             (), ()),
            ("test_concurrency_stress", (), (),
             ("test_cri_proxy_under_parallel_kubelet_calls",))):
        torch_cases.export(
            torch_cases.port_module(_name, _edits, on_cpu=_on_cpu),
            globals(), leave_out=_leave_out)


def _child(*args) -> dict:
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(torch_cases.TESTS)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([repo, torch_cases.TESTS]))
    proc = subprocess.run([sys.executable, __file__, *args], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def test_twin_daemons_write_identical_outputs():
    """Five ticks of one node in each package: byte-identical cgroup files,
    NodeMetric status after every tick, Device CR, audit events and
    /metrics exposition."""
    twins = _child("twin")
    ref, port = twins["koordinator_tpu"], twins["koordinator_tpu_torch"]
    assert set(ref) == set(port)
    for key in ref:
        assert port[key] == ref[key], key
    assert len(ref["files"]) > 20 and len(ref["node_metric"]) == TWIN_TICKS
    assert "GPU-00000000" in ref["device"]
    assert "koordlet_be_suppress_cpu_cores" in ref["metrics"]


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint directory written by the JAX package's Daemon restores
    in the port's Daemon, in a process that never imports the JAX
    package: equal series, KV (the CPU topology pickled under the JAX
    module path) and predictions."""
    written = _twin_run("koordinator_tpu", checkpoint_dir=str(tmp_path))
    restored = _child("restore", str(tmp_path))
    assert restored.pop("jax_modules") == []
    assert restored == json_round_trip(written)
    assert restored["kv"]["'node_cpu_info'"]["class"] == "CPUTopology"
    assert restored["peaks"] and restored["series"]


def json_round_trip(value):
    import json

    return json.loads(json.dumps(value))


def test_restore_refuses_other_reference_globals(tmp_path):
    """A snapshot global of the JAX package outside the modules a metric
    cache holds is refused (the cache starts empty) and nothing of the JAX
    package is imported for it."""
    import fractions
    import pickle
    import sys

    from koordinator_tpu_torch.koordlet.metriccache import (
        MetricCache,
        _SnapshotUnpickler,
    )

    # protocol 0 names a global as "c<module>\n<name>\n"
    payload = pickle.dumps(
        {"series": {}, "kv": {"x": fractions.Fraction(1, 2)}}, protocol=0)
    assert b"cfractions\nFraction\n" in payload
    payload = payload.replace(b"cfractions\nFraction\n",
                              b"ckoordinator_tpu.scheduler.cycle\n"
                              b"Scheduler\n")
    path = tmp_path / "metriccache.pkl"
    path.write_bytes(payload)
    before = "koordinator_tpu.scheduler.cycle" in sys.modules
    with pytest.raises(pickle.UnpicklingError):
        _SnapshotUnpickler(open(path, "rb")).load()
    assert MetricCache(storage_path=str(path))._kv == {}
    assert ("koordinator_tpu.scheduler.cycle" in sys.modules) == before


# ---------------------------------------------------------------------------
# the device probes on the CPU
# ---------------------------------------------------------------------------


class _Props:
    def __init__(self, uuid, total_memory):
        self.uuid = uuid
        self.total_memory = total_memory


def _stub_cuda(monkeypatch, count=2, free=None, raising=None):
    import torch

    props = [_Props(f"0000000{i}-aaaa-bbbb-cccc-dddddddddddd",
                    80 * GIB + i) for i in range(count)]

    def get_props(i):
        if raising == "device_properties":
            raise RuntimeError("no properties")
        return props[i]

    def mem_get_info(i):
        if raising == "mem_get_info":
            raise RuntimeError("no context")
        return (free[i], props[i].total_memory)

    def is_available():
        if raising == "cuda_devices":
            raise RuntimeError("driver gone")
        return True

    monkeypatch.setattr(torch.cuda, "is_available", is_available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "get_device_properties", get_props)
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    return props


def _errors(stage):
    from koordinator_tpu_torch.koordlet import metrics as koordlet_metrics

    return koordlet_metrics.INFORMER_ERRORS_TOTAL.get(
        informer="deviceInformer", stage=stage) or 0.0


def test_probes_report_nothing_without_cuda():
    """A CPU build of torch sees no card: both probes return [] and count
    nothing, as the JAX probes do off-TPU."""
    import torch

    from koordinator_tpu_torch.koordlet.metricsadvisor import (
        sample_gpu_devices,
    )
    from koordinator_tpu_torch.koordlet.statesinformer import (
        collect_gpu_devices,
    )

    assert not torch.cuda.is_available()
    stages = ("cuda_devices", "device_properties", "mem_get_info")
    before = [_errors(s) for s in stages]
    assert collect_gpu_devices() == []
    assert sample_gpu_devices() == []
    assert [_errors(s) for s in stages] == before


def test_collector_maps_the_card_fields(monkeypatch):
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.koordlet.statesinformer import (
        collect_gpu_devices,
    )

    props = _stub_cuda(monkeypatch)
    devices = collect_gpu_devices()
    assert [(d.type, d.uuid, d.minor, d.health, d.numa_node)
            for d in devices] == [
        ("gpu", f"GPU-{p.uuid}", i, True, 0) for i, p in enumerate(props)]
    for d, p in zip(devices, props):
        want = ResourceList.of(gpu_core=100, gpu_memory=p.total_memory,
                               gpu_memory_ratio=100)
        assert all(d.resources[r] == want[r] for r in want)
        assert all(d.resources[r] == want[r] for r in d.resources)


def test_sampler_takes_device_wide_bytes_in_use(monkeypatch):
    from koordinator_tpu_torch.koordlet.metricsadvisor import (
        sample_gpu_devices,
    )

    props = _stub_cuda(monkeypatch, free=[60 * GIB, 80 * GIB + 1])
    samples = sample_gpu_devices()
    in_use = [props[0].total_memory - 60 * GIB, 0]
    assert samples == [
        {"minor": i, "uuid": f"GPU-{p.uuid}",
         "core_pct": 100.0 * in_use[i] / p.total_memory,
         "mem_bytes": in_use[i]} for i, p in enumerate(props)]


@pytest.mark.parametrize("stage", ["cuda_devices", "device_properties",
                                   "mem_get_info"])
def test_a_raising_probe_is_counted_and_logged_once(monkeypatch, caplog,
                                                    stage):
    """Every failure counts; the first of a stage logs; the probe reports
    no device rather than a made-up one."""
    import logging

    from koordinator_tpu_torch.koordlet import statesinformer
    from koordinator_tpu_torch.koordlet.metricsadvisor import (
        sample_gpu_devices,
    )

    _stub_cuda(monkeypatch, free=[0, 0], raising=stage)
    monkeypatch.setattr(statesinformer, "_DEVICE_PROBE_LOGGED", set())
    probe = (sample_gpu_devices if stage == "mem_get_info"
             else statesinformer.collect_gpu_devices)
    before = _errors(stage)
    with caplog.at_level(logging.WARNING,
                         logger="koordinator_tpu_torch.koordlet"
                                ".statesinformer"):
        assert probe() == []
        assert probe() == []
    assert _errors(stage) == before + 2.0
    assert len([r for r in caplog.records
                if f"device probe {stage} failed" in r.message]) == 1


def test_informer_and_advisor_default_to_the_cuda_probes():
    from koordinator_tpu_torch.client.store import ObjectStore
    from koordinator_tpu_torch.koordlet import metricsadvisor, statesinformer
    from koordinator_tpu_torch.koordlet.metriccache import MetricCache
    from koordinator_tpu_torch.koordlet.util.system import FakeFS

    fs = FakeFS(use_cgroup_v2=True)
    try:
        informer = statesinformer.StatesInformer(
            ObjectStore(), "node-0", MetricCache())
        advisor = metricsadvisor.MetricsAdvisor(
            informer, MetricCache(), fs.config)
    finally:
        fs.cleanup()
    device = informer.plugins["deviceInformer"]
    assert device.collector is statesinformer.collect_gpu_devices
    assert advisor.device_sampler is metricsadvisor.sample_gpu_devices


# ---------------------------------------------------------------------------
# the perf reader (tests/test_native_perf.py's cases on the port)
# ---------------------------------------------------------------------------


def test_perf_library_builds_into_build_native_and_loads():
    from koordinator_tpu_torch.native import build, perf

    path = perf.build()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libkoordperf-") and path.exists()
    assert perf._load() is not None


def test_perf_build_failure_raises(monkeypatch, tmp_path):
    from koordinator_tpu_torch.native import build

    broken = tmp_path / "perf_reader.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(build.NativeBuildError):
        build.build_perf(broken, build_dir=tmp_path)


def test_perf_degrades_only_where_perf_events_are_denied():
    """open_self either works or returns None; None means the kernel
    denied perf_event_open, and then available() is False."""
    from koordinator_tpu_torch.native import perf

    g = perf.PerfGroup.open_self()
    if g is None:
        assert perf.available() is False
        return
    sample = g.read()
    g.close()
    if sample is None:
        assert perf.available() is False


def test_perf_counts_where_permitted_and_stays_off_where_denied():
    """Where the kernel permits perf events the counters rise with the
    work done at a sane CPI; where it denies them the CPI collector's
    reader is None."""
    import math

    from koordinator_tpu_torch.native import perf

    if not perf.available():
        assert perf.build_cgroup_perf_reader(None) is None
        return
    g = perf.PerfGroup.open_self()
    assert g is not None
    _ = sum(math.sin(i) for i in range(100_000))
    a = g.read()
    _ = sum(math.sin(i) for i in range(100_000))
    b = g.read()
    g.close()
    assert b[0] > a[0] and b[1] > a[1]
    assert 0.05 < b[0] / b[1] < 20.0
