"""The port's koord-descheduler and koord-manager binaries
(cmd/koord_descheduler.py, cmd/koord_manager.py) with ``--device cpu``.

The JAX package's binary test (tests/test_cmd_binaries.py
test_descheduler_and_manager_mains) on the port, then each binary on a
larger synthetic world for a few ticks: it exits 0, prints a line a tick,
and its pass ran through the device engine (the descheduler's rebalance
windows and the manager's colo passes by engine, read off each binary's
metrics registry as deltas). ``--device`` defaults to cuda and refuses
anything but cuda and cpu.
"""

from __future__ import annotations

import re

import pytest

from koordinator_tpu_torch import manager_metrics
from koordinator_tpu_torch.cmd import koord_descheduler, koord_manager
from koordinator_tpu_torch.descheduler import metrics as descheduler_metrics


def _sample(registry, series: str) -> float:
    """The value of one exposed series (0 when it is not exposed yet)."""
    for line in registry.expose().splitlines():
        name, _, value = line.rpartition(" ")
        if name == series:
            return float(value)
    return 0.0


REBALANCE_WINDOWS = ('koord_device_window_seconds_count'
                     '{consumer="rebalance",path="serial"}')
COLO_DEVICE_PASSES = 'koord_manager_colo_passes_total{engine="device"}'


def test_descheduler_and_manager_mains(capsys):
    """tests/test_cmd_binaries.py's case, on the CPU."""
    assert koord_descheduler.main(["--synth", "6x6", "--max-ticks", "1",
                                   "--interval", "0.01",
                                   "--device", "cpu"]) == 0
    assert koord_manager.main(["--synth", "6x6", "--max-ticks", "1",
                               "--interval", "0.01", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "koord-descheduler:" in err
    assert "round=1" in err


def test_koord_descheduler_runs_the_rebalance_pass(capsys):
    before = _sample(descheduler_metrics.REGISTRY, REBALANCE_WINDOWS)
    assert koord_descheduler.main(["--synth", "60x300", "--max-ticks", "3",
                                   "--interval", "0",
                                   "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert len(re.findall(r"koord-descheduler: \{", err)) == 3
    assert _sample(descheduler_metrics.REGISTRY,
                   REBALANCE_WINDOWS) - before == 3


def test_koord_manager_runs_the_colo_pass(capsys):
    before = _sample(manager_metrics.REGISTRY, COLO_DEVICE_PASSES)
    assert koord_manager.main(["--synth", "60x300", "--max-ticks", "3",
                               "--interval", "0", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert re.findall(r"koord-manager: round=(\d+)", err) == ["1", "2", "3"]
    assert _sample(manager_metrics.REGISTRY,
                   COLO_DEVICE_PASSES) - before == 3


@pytest.mark.parametrize("main", [koord_descheduler.main,
                                  koord_manager.main],
                         ids=["koord-descheduler", "koord-manager"])
def test_device_flag(main, capsys):
    with pytest.raises(SystemExit):
        main(["--synth", "6x6", "--max-ticks", "1", "--device", "tpu"])
    assert "invalid choice" in capsys.readouterr().err


def test_koord_sidecar_device_flag(monkeypatch, capsys, tmp_path):
    """koord-sidecar's --device: cuda by default, raising where there is
    none (before it listens), and nothing but cuda or cpu."""
    import torch

    from koordinator_tpu_torch.cmd import koord_sidecar

    with pytest.raises(SystemExit):
        koord_sidecar.main(["--device", "tpu"])
    assert "invalid choice" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        koord_sidecar.main(["--listen", f"unix://{tmp_path}/s.sock"])
    assert not (tmp_path / "s.sock").exists()
