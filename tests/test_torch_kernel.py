"""The CUDA kernels' surroundings, on the CPU (no nvcc runs here): each
source is in the package, the ctypes mirror of its parameter struct names
the same fields in the same order, and each kernel path refuses tensors that
are not on the card."""

import re

import pytest
import torch

from koordinator_tpu_torch.models.convert import check_device, to_device
from koordinator_tpu_torch.models.full_chain import build_best_full_chain_step
from koordinator_tpu_torch.models.convert import schedule_inputs_from_numpy
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import schedule_kernel as sk
from koordinator_tpu_torch.ops.kernel_common import CSRC_DIR
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler.snapshot import build_full_chain_inputs
from koordinator_tpu_torch.testing import (
    loadaware_inputs,
    synth_cluster,
    synth_full_cluster,
)


def _small_fc():
    args = LoadAwareArgs()
    _, state = synth_full_cluster(8, 16, seed=0)
    fc, _p, _n, _t, _g, ng, ngroups = build_full_chain_inputs(state, args)
    return args, to_device(fc, "cpu"), ng, ngroups


def test_kernel_sources_present():
    src = (CSRC_DIR / fck.SOURCE).read_text()
    assert (CSRC_DIR / "kernel_common.cuh").exists()
    assert "__global__" in src and 'extern "C"' in src
    assert "pallas_full_chain.py" in src  # names the TPU kernel it replaces


def _struct_fields(source, struct):
    """Field names of ``struct`` in csrc/<source>, in declaration order."""
    src = (CSRC_DIR / source).read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        if "*" in decl:
            names.append(decl.split("*")[-1].strip())
        else:
            names.extend(n.strip().split("[")[0]
                         for n in decl.split(None, 1)[1].split(","))
    return names


def test_params_struct_mirrors_source():
    assert _struct_fields(fck.SOURCE, "FullChainParams") == [
        f for f, _ in fck._Params._fields_]


def test_kernel_path_refuses_cpu_tensors():
    args, fc, ng, ngroups = _small_fc()
    with pytest.raises(ValueError, match="CUDA"):
        fck.build_cuda_full_chain_step(args, ng, ngroups)(fc)
    with pytest.raises(ValueError, match="CUDA"):
        fck.full_chain_round(fc, (0, 1), False, (0, 1))


def test_selector_forms():
    args, fc, ng, ngroups = _small_fc()
    step = build_best_full_chain_step(args, ng, ngroups)
    chosen, _req, _q = step(fc)
    assert step.last_backend == "serial" and chosen.shape == (16,)
    # the wave-parallel round is ported: plain PyTorch on the inputs'
    # device, the plain round's bindings
    wave = build_best_full_chain_step(args, ng, ngroups, kernel="wave")
    assert wave.last_backend == "wave"
    assert torch.equal(wave(fc)[0], chosen)
    with pytest.raises(ValueError, match="kernel"):
        build_best_full_chain_step(args, ng, ngroups, kernel="pallas")
    # explain is ported: on CPU tensors the plain step with its 4th output
    ex = build_best_full_chain_step(args, ng, ngroups, explain="counts")
    out = ex(fc, 16)
    assert ex.last_backend == "serial" and len(out) == 4
    assert out[3].terms is None and tuple(out[3].stage_counts.shape) == (
        16, 11)
    assert torch.equal(out[0], chosen)
    with pytest.raises(ValueError, match="explain"):
        build_best_full_chain_step(args, ng, ngroups, explain="verbose")


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        assert check_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_device("cuda")
    from koordinator_tpu_torch.scheduler.sidecar import SidecarServer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SidecarServer()


def test_schedule_kernel_source_present():
    src = (CSRC_DIR / sk.SOURCE).read_text()
    assert "__global__" in src and 'extern "C"' in src
    assert "pallas_step.py" in src  # names the TPU kernel it replaces
    assert _struct_fields(sk.SOURCE, "ScheduleStepParams") == [
        f for f, _ in sk._Params._fields_]


def test_schedule_kernel_refuses_cpu_tensors():
    args = LoadAwareArgs()
    cluster = synth_cluster(num_nodes=8, num_pods=16, seed=0)
    inputs = schedule_inputs_from_numpy(
        loadaware_inputs(cluster, args)._asdict(), "cpu")
    before = sk.launches
    with pytest.raises(ValueError, match="CUDA"):
        sk.schedule_round(inputs, (0, 1), False)
    assert sk.launches == before
