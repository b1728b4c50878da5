"""koordlet Daemon: module wiring + run loop.

Analog of reference `pkg/koordlet/koordlet.go:70-188`: NewDaemon builds
executor -> metriccache -> statesinformer -> metricsadvisor -> prediction ->
qosmanager -> runtimehooks; Run starts them in dependency order. `run_once(now)`
drives one tick of everything (tests and the driver call it directly; `run`
loops it on an interval)."""

from __future__ import annotations

import os
import time
from typing import Optional

from koordinator_tpu_torch.client.store import ObjectStore
from koordinator_tpu_torch.koordlet.audit import Auditor
from koordinator_tpu_torch.koordlet.metriccache import MetricCache
from koordinator_tpu_torch.koordlet.server import KoordletServer
from koordinator_tpu_torch.koordlet.metricsadvisor import MetricsAdvisor
from koordinator_tpu_torch.koordlet.pleg import Pleg
from koordinator_tpu_torch.koordlet.prediction import PeakPredictServer
from koordinator_tpu_torch.koordlet.qosmanager import QoSManager
from koordinator_tpu_torch.koordlet.resourceexecutor import ResourceUpdateExecutor
from koordinator_tpu_torch.koordlet.runtimehooks import RuntimeHooks
from koordinator_tpu_torch.koordlet.statesinformer import StatesInformer
from koordinator_tpu_torch.koordlet.util import system as sysutil
from koordinator_tpu_torch.koordlet import metriccache as mc


class Daemon:
    def __init__(self, store: ObjectStore, node_name: str,
                 config: Optional[sysutil.SystemConfig] = None,
                 checkpoint_dir: Optional[str] = None,
                 report_interval_seconds: int = 60,
                 autodetect_cgroups: bool = False,
                 kubelet_stub=None,
                 device_collector=None):
        self.config = config or sysutil.CONFIG
        if autodetect_cgroups:
            # probe the real node layout (koordlet.go does this at startup
            # via system.InitSupportConfigs); explicit configs (tests/FakeFS)
            # skip it
            self.config.use_cgroup_v2 = sysutil.detect_cgroup_version(self.config)
            self.config.cgroup_driver = sysutil.detect_cgroup_driver(self.config)
        self.auditor = Auditor()
        self.executor = ResourceUpdateExecutor(self.config, self.auditor)
        # metriccache persists next to the prediction checkpoints so the
        # NodeMetric aggregation window survives agent restarts
        # (tsdb_storage.go:32-46)
        metric_storage = (
            os.path.join(checkpoint_dir, "metriccache.pkl")
            if checkpoint_dir else None
        )
        from koordinator_tpu_torch.koordlet.metrics import REGISTRY

        self.metric_cache = MetricCache(storage_path=metric_storage)
        self.api_server = KoordletServer(self.auditor,
                                         metrics_registry=REGISTRY)
        # PLEG feeds the pods informer (cgroup pod-added -> early kubelet
        # resync), so it is built first (koordlet.go wiring order)
        self.pleg = Pleg(self.config)
        self.states_informer = StatesInformer(
            store, node_name, self.metric_cache,
            report_interval_seconds=report_interval_seconds,
            kubelet_stub=kubelet_stub,
            pleg=self.pleg,
            device_collector=device_collector,
        )
        self.metrics_advisor = MetricsAdvisor(
            self.states_informer, self.metric_cache, self.config
        )
        from koordinator_tpu_torch.utils.features import KOORDLET_GATES

        if KOORDLET_GATES.enabled("CPICollector"):
            from koordinator_tpu_torch.native.perf import build_cgroup_perf_reader

            self.metrics_advisor.perf_reader = build_cgroup_perf_reader(self.config)
        self.prediction = PeakPredictServer(checkpoint_dir)
        self.qos_manager = QoSManager(
            store, self.states_informer, self.metric_cache, self.executor
        )
        self.runtime_hooks = RuntimeHooks(self.states_informer, self.executor)

    def run_once(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self.pleg.tick()
        self.metrics_advisor.collect_once(now)
        for pod in self.states_informer.get_all_pods():
            cpu = self.metric_cache.query(
                mc.POD_CPU_USAGE, "latest", now=now, pod=pod.meta.key
            )
            mem = self.metric_cache.query(
                mc.POD_MEMORY_USAGE, "latest", now=now, pod=pod.meta.key
            )
            if cpu is not None or mem is not None:
                self.prediction.update(
                    pod.meta.uid or pod.meta.key, cpu or 0.0, mem or 0.0, now
                )
        self.states_informer.sync(now)
        self.qos_manager.run_once(now)
        self.runtime_hooks.reconcile()
        self.metric_cache.maybe_flush(now)

    def run(self, interval_seconds: float = 10.0, max_ticks: Optional[int] = None) -> None:
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            self.run_once()
            self.prediction.checkpoint()
            ticks += 1
            time.sleep(interval_seconds)
