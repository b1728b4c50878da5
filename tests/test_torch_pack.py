"""The port's host pack against the JAX package's, array for array.

Both packages build FullChainInputs from the same seeded cluster (the port's
copy of the synthetic generators and of the JAX-free host modules); every
array must be equal, before and after the active-axis reduction, and so must
the active axes and the gang/group counts. Also: importing the port leaves
JAX and the JAX package unloaded.
"""

import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from koordinator_tpu.ops.loadaware import LoadAwareArgs as RefArgs
from koordinator_tpu.scheduler.snapshot import (
    build_full_chain_inputs as ref_build,
    reduce_to_active_axes as ref_reduce,
)
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.testing import mixed_cluster, synth_full_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "seed0": (0, {}),
    "seed1": (1, {}),
    "taints": (21, dict(taint_fraction=0.4)),
    "all_topology": (5, dict(topology_fraction=1.0, lsr_fraction=0.4)),
    "no_quota_no_gang": (9, dict(num_quotas=0, num_gangs=0)),
}


def _fields(fc):
    out = {f"base.{k}": v for k, v in fc.base._asdict().items()}
    out.update((k, v) for k, v in fc._asdict().items() if k != "base")
    return out


def mixed_fixture_state(seed):
    """The cluster state of the JAX package's own cross-feature fixture
    (tests/test_parity_fuzz.py), caught where the fixture packs it, so that
    it can be packed with any LoadAwareArgs."""
    import test_parity_fuzz

    seen = []

    def catch(state, args):
        seen.append(state)
        return ref_build(state, args)

    with mock.patch.object(test_parity_fuzz, "build_full_chain_inputs",
                           catch):
        test_parity_fuzz._mixed_fixture(seed)
    return seen[0]


def _assert_packs_equal(ref_state, state, prod=False):
    ref_args = RefArgs(score_according_prod_usage=prod)
    args = LoadAwareArgs(score_according_prod_usage=prod)
    ref_fc, ref_pods, _n, _t, ref_gi, ref_ng, ref_ngroups = ref_build(
        ref_state, ref_args)
    fc, pods, _n, _t, gi, ng, ngroups = build_full_chain_inputs(state, args)
    assert (ng, ngroups) == (ref_ng, ref_ngroups)
    assert gi == ref_gi
    assert list(pods.keys) == list(ref_pods.keys)
    for stage in ("packed", "reduced"):
        ref_f, f = _fields(ref_fc), _fields(fc)
        assert sorted(ref_f) == sorted(f)
        for name, ref_arr in ref_f.items():
            ref_arr, arr = np.asarray(ref_arr), np.asarray(f[name])
            assert arr.dtype == ref_arr.dtype, (stage, name)
            np.testing.assert_array_equal(arr, ref_arr,
                                          err_msg=f"{stage} {name}")
        if stage == "packed":
            ref_fc, ref_active = ref_reduce(ref_fc)
            fc, active = reduce_to_active_axes(fc)
            assert active == ref_active
    return fc


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_matches_reference(name):
    seed, kw = CASES[name]
    _, ref_state = ref_synth(24, 48, seed=seed, **kw)
    _, state = synth_full_cluster(24, 48, seed=seed, **kw)
    _assert_packs_equal(ref_state, state)


# the seeds tests/test_torch_full_chain.py runs through the mixed cluster
@pytest.mark.parametrize("seed,prod", [(101, False), (202, True),
                                       (303, True), (707, False)])
def test_mixed_pack_matches_reference(seed, prod):
    """mixed_cluster against the JAX package's own cross-feature fixture
    (tests/test_parity_fuzz.py), whose decoration it copies; every switch of
    the kernel is live."""
    _, state = mixed_cluster(seed, 30, 60)
    fc = _assert_packs_equal(mixed_fixture_state(seed), state, prod=prod)
    T = fc.aff_dom.shape[1]
    assert T > 0 and fc.pref_scores.shape[1] > 0
    assert fc.ppref_w.shape[0] > 0 and fc.port_used.shape[1] > 0
    assert fc.img_scores.shape[1] > 0 and fc.vol_needed.shape[1] > 1
    assert (fc.pod_spread_skew > 0).any()
    assert len(np.unique(fc.node_taint_group)) > 1


def test_storage_objects_raise_not_implemented():
    """Storage objects used to raise here; the classification is ported:
    a StorageClass turns it on, so a pod naming a claim that does not
    exist is PreFilter-rejected with the JAX package's reason, where the
    same pod without storage objects keeps an opaque CSI token."""
    from koordinator_tpu_torch.api.objects import ObjectMeta, StorageClass

    _, state = synth_full_cluster(8, 8, seed=0)
    pod = state.pending_pods[0]
    pod.spec.pvc_names = ["claim"]
    fc, pods, *_ = build_full_chain_inputs(state, LoadAwareArgs())
    assert fc.vol_needed[0].sum() == 1 and not pods.unschedulable_reasons
    state.storage_classes = {"local": StorageClass(
        meta=ObjectMeta(name="local", namespace=""))}
    fc, pods, *_ = build_full_chain_inputs(state, LoadAwareArgs())
    assert pods.unschedulable_reasons[0] == "persistentvolumeclaim not found"


def test_import_leaves_jax_out():
    code = ("import sys, koordinator_tpu_torch.scheduler.sidecar, "
            "koordinator_tpu_torch.testing, "
            "koordinator_tpu_torch.ops.full_chain_kernel, "
            "koordinator_tpu_torch.ops.schedule_kernel, "
            "koordinator_tpu_torch.scheduler.parity, "
            "koordinator_tpu_torch.scheduler.cycle, "
            "koordinator_tpu_torch.scheduler.snapshot_cache, "
            "koordinator_tpu_torch.scheduler.warmup, "
            "koordinator_tpu_torch.scheduler.config_v1beta2, "
            "koordinator_tpu_torch.models.wave_chain, "
            "koordinator_tpu_torch.testing.storage, "
            "koordinator_tpu_torch.testing.cold_start, "
            "koordinator_tpu_torch.cmd.koord_descheduler, "
            "koordinator_tpu_torch.cmd.koord_manager, "
            "koordinator_tpu_torch.models.fused_waves, "
            "koordinator_tpu_torch.scheduler.pipeline_parity, "
            "koordinator_tpu_torch.testing.churn, "
            "koordinator_tpu_torch.scheduler.degrade, "
            "koordinator_tpu_torch.sim, koordinator_tpu_torch.sim.harness, "
            "koordinator_tpu_torch.sim.__main__, "
            "koordinator_tpu_torch.obs.slo, "
            "koordinator_tpu_torch.obs.lockorder, "
            "koordinator_tpu_torch.balance.pack, "
            "koordinator_tpu_torch.balance, "
            "koordinator_tpu_torch.balance.step, "
            "koordinator_tpu_torch.balance.rebalancer, "
            "koordinator_tpu_torch.descheduler, "
            "koordinator_tpu_torch.descheduler.descheduler, "
            "koordinator_tpu_torch.descheduler.framework, "
            "koordinator_tpu_torch.descheduler.lownodeload, "
            "koordinator_tpu_torch.descheduler.metrics, "
            "koordinator_tpu_torch.descheduler.migration, "
            "koordinator_tpu_torch.descheduler.plugins_k8s, "
            "koordinator_tpu_torch.client, "
            "koordinator_tpu_torch.client.leaderelection, "
            "koordinator_tpu_torch.testing.rebalance_fixture, "
            "koordinator_tpu_torch.utils.sloconfig, "
            "koordinator_tpu_torch.slocontroller, "
            "koordinator_tpu_torch.slocontroller.nodemetric, "
            "koordinator_tpu_torch.slocontroller.nodeslo, "
            "koordinator_tpu_torch.slocontroller.noderesource, "
            "koordinator_tpu_torch.slocontroller.noderesource_plugins, "
            "koordinator_tpu_torch.quotacontroller, "
            "koordinator_tpu_torch.quotacontroller.profile, "
            "koordinator_tpu_torch.webhook, "
            "koordinator_tpu_torch.webhook.server, "
            "koordinator_tpu_torch.colo, "
            "koordinator_tpu_torch.colo.pack, "
            "koordinator_tpu_torch.colo.step, "
            "koordinator_tpu_torch.colo.reconciler, "
            "koordinator_tpu_torch.manager, "
            "koordinator_tpu_torch.manager_metrics, "
            "koordinator_tpu_torch.ops.explain_kernel, "
            "koordinator_tpu_torch.obs.server, "
            "koordinator_tpu_torch.obs.__main__, "
            "koordinator_tpu_torch.cmd, "
            "koordinator_tpu_torch.cmd.koord_scheduler, "
            "koordinator_tpu_torch.cmd.koord_sidecar, "
            "koordinator_tpu_torch.scheduler.sidecar_pb2, "
            "koordinator_tpu_torch.native, "
            "koordinator_tpu_torch.native.build, "
            "koordinator_tpu_torch.native.floor, "
            "koordinator_tpu_torch.utils.histogram, "
            "koordinator_tpu_torch.utils.parallelize, "
            "koordinator_tpu_torch.parallel, "
            "koordinator_tpu_torch.parallel.mesh, "
            "koordinator_tpu_torch.parallel.full_chain_mesh, "
            "koordinator_tpu_torch.parallel.rebalance_mesh, "
            "koordinator_tpu_torch.parallel.colo_mesh, "
            "koordinator_tpu_torch.testing.mesh_round, "
            "koordinator_tpu_torch.testing.cross_card, "
            "koordinator_tpu_torch.testing.multihost_worker, "
            "koordinator_tpu_torch.testing.mailbox_rtt, "
            "koordinator_tpu_torch.testing.xproc_cards, "
            "koordinator_tpu_torch.testing.explain_ab, "
            "koordinator_tpu_torch.testing.scrape_convoy, "
            "koordinator_tpu_torch.testing.round_pack_probe, "
            "koordinator_tpu_torch.models.replay_by_node, "
            "koordinator_tpu_torch.models.round_pack, "
            "koordinator_tpu_torch.koordlet, "
            "koordinator_tpu_torch.koordlet.util, "
            "koordinator_tpu_torch.koordlet.util.system, "
            "koordinator_tpu_torch.koordlet.util.machineinfo, "
            "koordinator_tpu_torch.koordlet.util.kidled, "
            "koordinator_tpu_torch.koordlet.util.resctrl, "
            "koordinator_tpu_torch.koordlet.util.coresched, "
            "koordinator_tpu_torch.koordlet.metrics, "
            "koordinator_tpu_torch.koordlet.audit, "
            "koordinator_tpu_torch.koordlet.resourceexecutor, "
            "koordinator_tpu_torch.koordlet.metriccache, "
            "koordinator_tpu_torch.koordlet.pleg, "
            "koordinator_tpu_torch.koordlet.kubeletstub, "
            "koordinator_tpu_torch.koordlet.prediction, "
            "koordinator_tpu_torch.koordlet.statesinformer, "
            "koordinator_tpu_torch.koordlet.metricsadvisor, "
            "koordinator_tpu_torch.koordlet.qosmanager, "
            "koordinator_tpu_torch.koordlet.runtimehooks, "
            "koordinator_tpu_torch.koordlet.hookserver, "
            "koordinator_tpu_torch.koordlet.nri, "
            "koordinator_tpu_torch.koordlet.nri_pb2, "
            "koordinator_tpu_torch.koordlet.server, "
            "koordinator_tpu_torch.koordlet.daemon, "
            "koordinator_tpu_torch.runtimeproxy, "
            "koordinator_tpu_torch.runtimeproxy.api_pb2, "
            "koordinator_tpu_torch.runtimeproxy.cri_pb2, "
            "koordinator_tpu_torch.runtimeproxy.server, "
            "koordinator_tpu_torch.runtimeproxy.hookclient, "
            "koordinator_tpu_torch.runtimeproxy.criserver, "
            "koordinator_tpu_torch.runtimeproxy.dockerserver, "
            "koordinator_tpu_torch.native.perf, "
            "koordinator_tpu_torch.cmd.koordlet, "
            "koordinator_tpu_torch.cmd.demo, "
            "koordinator_tpu_torch.cmd.koord_runtime_proxy, "
            "koordinator_tpu_torch.testing.gpu_pool, "
            "koordinator_tpu_torch.testing.cri, "
            "koordinator_tpu_torch.sim.faults, "
            "koordinator_tpu_torch.sim.racecheck, "
            "koordinator_tpu_torch.analysis, "
            "koordinator_tpu_torch.analysis.__main__, "
            "koordinator_tpu_torch.analysis.core, "
            "koordinator_tpu_torch.analysis.guards, "
            "koordinator_tpu_torch.analysis.rules, "
            "koordinator_tpu_torch.analysis.rules.balance, "
            "koordinator_tpu_torch.analysis.rules.colo, "
            "koordinator_tpu_torch.analysis.rules.compilecache, "
            "koordinator_tpu_torch.analysis.rules.concurrency, "
            "koordinator_tpu_torch.analysis.rules.demotion, "
            "koordinator_tpu_torch.analysis.rules.jaxtrace, "
            "koordinator_tpu_torch.analysis.rules.loops, "
            "koordinator_tpu_torch.analysis.rules.pipeline, "
            "koordinator_tpu_torch.analysis.rules.race, "
            "koordinator_tpu_torch.analysis.rules.wire\n"
            "from koordinator_tpu_torch.analysis import all_rules\n"
            "assert len(all_rules()) == 23, sorted(all_rules())\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'koordinator_tpu' "
            "or m.startswith('koordinator_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
