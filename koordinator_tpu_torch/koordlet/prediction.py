"""Peak-usage prediction: decayed histograms with checkpoints.

Analog of reference `pkg/koordlet/prediction/peak_predictor.go:34-141` +
`checkpoint.go:36-95`: per-UID decaying histograms of cpu/memory usage, a
safety-margin peak estimate (p95 * (1 + margin)), cold-start handling, and
periodic JSON checkpoints restored on start. Feeds the Mid-tier resource
calculation in the noderesource controller."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

from koordinator_tpu_torch.utils.histogram import DecayingHistogram, HistogramOptions

DEFAULT_SAFETY_MARGIN_PERCENT = 10
COLD_START_SECONDS = 15 * 60


class PeakPredictServer:
    def __init__(self, checkpoint_dir: Optional[str] = None,
                 half_life_seconds: float = 12 * 3600,
                 safety_margin_percent: int = DEFAULT_SAFETY_MARGIN_PERCENT):
        self.checkpoint_dir = checkpoint_dir
        self.safety_margin = safety_margin_percent
        self.half_life = half_life_seconds
        self._cpu_opts = HistogramOptions.exponential(1024.0, 0.025, 1.05)
        self._mem_opts = HistogramOptions.exponential(1 << 44, 1 << 24, 1.05)
        self.cpu: Dict[str, DecayingHistogram] = {}
        self.mem: Dict[str, DecayingHistogram] = {}
        self.first_seen: Dict[str, float] = {}
        if checkpoint_dir:
            self.restore()

    def _hist(self, cache: Dict[str, DecayingHistogram], opts, uid: str) -> DecayingHistogram:
        if uid not in cache:
            cache[uid] = DecayingHistogram(opts, self.half_life)
        return cache[uid]

    def update(self, uid: str, cpu_cores: float, memory_bytes: float,
               timestamp: Optional[float] = None) -> None:
        ts = time.time() if timestamp is None else timestamp
        self.first_seen.setdefault(uid, ts)
        self._hist(self.cpu, self._cpu_opts, uid).add_sample(cpu_cores, 1.0, ts)
        self._hist(self.mem, self._mem_opts, uid).add_sample(memory_bytes, 1.0, ts)

    def predict_peak(self, uid: str, now: Optional[float] = None
                     ) -> Optional[Tuple[float, float]]:
        """(cpu_cores, memory_bytes) p95 peak with safety margin; None during
        cold start or for unknown UIDs."""
        now = time.time() if now is None else now
        if uid not in self.cpu:
            return None
        if now - self.first_seen.get(uid, now) < COLD_START_SECONDS:
            return None
        factor = 1.0 + self.safety_margin / 100.0
        return (
            self.cpu[uid].percentile(0.95) * factor,
            self.mem[uid].percentile(0.95) * factor,
        )

    # -- checkpoints ---------------------------------------------------------
    def checkpoint(self) -> None:
        if not self.checkpoint_dir:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        data = {
            "first_seen": self.first_seen,
            "cpu": {uid: h.to_checkpoint() for uid, h in self.cpu.items()},
            "mem": {uid: h.to_checkpoint() for uid, h in self.mem.items()},
        }
        path = os.path.join(self.checkpoint_dir, "prediction.json")
        with open(path + ".tmp", "w") as f:
            json.dump(data, f)
        os.replace(path + ".tmp", path)

    def restore(self) -> bool:
        path = os.path.join(self.checkpoint_dir or "", "prediction.json")
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return False
        self.first_seen = {k: float(v) for k, v in data.get("first_seen", {}).items()}
        for uid, ckpt in data.get("cpu", {}).items():
            try:
                self.cpu[uid] = DecayingHistogram.from_checkpoint(self._cpu_opts, ckpt)
            except ValueError:
                continue
        for uid, ckpt in data.get("mem", {}).items():
            try:
                self.mem[uid] = DecayingHistogram.from_checkpoint(self._mem_opts, ckpt)
            except ValueError:
                continue
        return True
