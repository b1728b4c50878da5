"""resctrl (Intel RDT / AMD QoS) filesystem interface.

Analog of reference `pkg/koordlet/util/system/resctrl*.go`:
  * schemata parsing/formatting — `L3:<dom>=<hexmask>` cache-allocation lines
    and `MB:<dom>=<percent>` memory-bandwidth lines
  * control-group management (LS/LSR/BE group dirs, tasks file)
  * percent-range -> contiguous way bitmask calculation
    (resctrl.go CalculateCatL3MaskValue semantics: masks must be contiguous;
    a QoS class gets the ways covering [start%, end%] of the cache)

All paths resolve through a `SystemConfig` so the whole module runs against a
`FakeFS` tree in tests.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from koordinator_tpu_torch.koordlet.util import system as sysutil

# well-known resctrl group names (resctrl.go LSRResctrlGroup etc.)
ROOT_GROUP = ""
LSR_GROUP = "LSR"
LS_GROUP = "LS"
BE_GROUP = "BE"
STANDARD_GROUPS = (LSR_GROUP, LS_GROUP, BE_GROUP)

SCHEMATA_FILE = "schemata"
TASKS_FILE = "tasks"
CPUS_FILE = "cpus"

_L3_LINE = re.compile(r"^\s*L3:(.*)$")
_MB_LINE = re.compile(r"^\s*MB:(.*)$")


@dataclass
class Schemata:
    """Parsed schemata: per-domain L3 way masks and MB percents."""

    l3_masks: Dict[int, int] = field(default_factory=dict)
    mb_percents: Dict[int, int] = field(default_factory=dict)
    l3_num_ways: int = 0  # inferred from root-group mask width when parsed

    def format(self) -> str:
        lines: List[str] = []
        if self.l3_masks:
            doms = ";".join(
                f"{d}={m:x}" for d, m in sorted(self.l3_masks.items()))
            lines.append(f"L3:{doms}")
        if self.mb_percents:
            doms = ";".join(
                f"{d}={p}" for d, p in sorted(self.mb_percents.items()))
            lines.append(f"MB:{doms}")
        return "\n".join(lines) + "\n"


def parse_schemata(content: str) -> Schemata:
    out = Schemata()
    for line in content.splitlines():
        m = _L3_LINE.match(line)
        if m:
            for part in m.group(1).split(";"):
                if "=" not in part:
                    continue
                dom, mask = part.split("=", 1)
                out.l3_masks[int(dom)] = int(mask.strip(), 16)
            continue
        m = _MB_LINE.match(line)
        if m:
            for part in m.group(1).split(";"):
                if "=" not in part:
                    continue
                dom, pct = part.split("=", 1)
                out.mb_percents[int(dom)] = int(pct.strip())
    if out.l3_masks:
        out.l3_num_ways = max(m.bit_length() for m in out.l3_masks.values())
    return out


def calculate_l3_mask(num_ways: int, start_percent: int, end_percent: int) -> int:
    """Contiguous way mask covering [start%, end%] of an L3 with num_ways ways.

    Matches the reference's semantics (resctrl.go CalculateCatL3MaskValue):
    the mask must be contiguous and non-empty; the BE class typically gets
    [0, llcPercent], LS/LSR get [0, 100].
    """
    if num_ways <= 0:
        raise ValueError("num_ways must be positive")
    if not (0 <= start_percent < end_percent <= 100):
        raise ValueError(f"invalid percent range [{start_percent},{end_percent}]")
    lo = num_ways * start_percent // 100
    hi = max(lo + 1, (num_ways * end_percent + 99) // 100)  # ceil, >=1 way
    hi = min(hi, num_ways)
    width = hi - lo
    return ((1 << width) - 1) << lo


class ResctrlInterface:
    """Group + schemata management against the resctrl fs root."""

    def __init__(self, config: Optional[sysutil.SystemConfig] = None):
        self.config = config or sysutil.CONFIG

    def group_dir(self, group: str) -> str:
        root = self.config.resctrl_root()
        return root if group == ROOT_GROUP else os.path.join(root, group)

    def available(self) -> bool:
        """resctrl mounted (root schemata readable)?"""
        return sysutil.read_file(
            os.path.join(self.config.resctrl_root(), SCHEMATA_FILE)) is not None

    def read_schemata(self, group: str = ROOT_GROUP) -> Optional[Schemata]:
        raw = sysutil.read_file(os.path.join(self.group_dir(group), SCHEMATA_FILE))
        return parse_schemata(raw) if raw is not None else None

    def num_l3_ways(self) -> int:
        root = self.read_schemata(ROOT_GROUP)
        return root.l3_num_ways if root else 0

    def ensure_group(self, group: str) -> bool:
        try:
            os.makedirs(self.group_dir(group), exist_ok=True)
            return True
        except OSError:
            return False

    def write_schemata(self, group: str, schemata: Schemata) -> bool:
        self.ensure_group(group)
        return sysutil.write_file(
            os.path.join(self.group_dir(group), SCHEMATA_FILE), schemata.format())

    def add_tasks(self, group: str, pids: List[int]) -> bool:
        """Move tasks into a control group. One pid per write(2): the kernel
        rejects multi-pid writes, and rewriting existing members would fail
        with ESRCH if any has exited. Failures for individual pids (task died)
        don't abort the rest."""
        path = os.path.join(self.group_dir(group), TASKS_FILE)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        except OSError:
            return False
        ok = True
        for pid in pids:
            try:
                with open(path, "a") as f:
                    f.write(f"{pid}\n")
            except OSError:
                ok = False
        return ok

    def read_tasks(self, group: str) -> List[int]:
        raw = sysutil.read_file(os.path.join(self.group_dir(group), TASKS_FILE))
        if not raw:
            return []
        return [int(x) for x in raw.split() if x.isdigit()]
