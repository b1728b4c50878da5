"""Where chip_smoke.py spends its time: a sampling profile by phase.

    python3 chip_smoke_profile.py [--out build/chip_smoke_profile.json]

Runs chip_smoke.main() in this process (so it needs the card, as the
script does) with a thread that reads the main thread's stack every
INTERVAL_S seconds. Each sample goes to the phase that is running: the
next phase line chip_smoke.py prints. Per phase the JSON gives the
sampled seconds and, by sampled seconds, the innermost chip_smoke.py
line, the innermost line of the port, the innermost frame, and each
port function anywhere on the stack; Python's garbage collections
(count and seconds by generation, from gc.callbacks); and the process's
resident set and the host's available memory at the phase's end. If the
host's available memory drops under MIN_AVAILABLE_MIB the profile is
written and the run stops with exit code 3, before the host runs out.
The profile is written every minute and at the end.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import sys
import threading
import time

import chip_smoke

PORT = "koordinator_tpu_torch/"
INTERVAL_S = 0.2
MIN_AVAILABLE_MIB = 10 * 1024


class Profile:
    def __init__(self, out: str):
        self.out = out
        self.lock = threading.Lock()
        self.phases = []        # phase names in the order they were printed
        self.samples = []       # (index of the running phase, stack)
        self.memory = []        # (phase name, rss MiB, available MiB)
        self.gc = collections.defaultdict(lambda: [0, 0.0])
        self._gc_start = 0.0
        self.stopped = False
        self.main_id = threading.main_thread().ident

    def running(self) -> int:
        return len(self.phases)

    def on_gc(self, stage, info):
        if stage == "start":
            self._gc_start = time.perf_counter()
            return
        with self.lock:
            entry = self.gc[(self.running(), info["generation"])]
        entry[0] += 1
        entry[1] += time.perf_counter() - self._gc_start

    def on_phase(self, name: str):
        rss, available = memory_mib()
        with self.lock:
            self.phases.append(name)
            self.memory.append((name, rss, available))

    def sample(self):
        last_write = time.monotonic()
        while not self.stopped:
            time.sleep(INTERVAL_S)
            frame = sys._current_frames().get(self.main_id)
            stack = []
            while frame is not None:
                stack.append((frame.f_code.co_filename, frame.f_lineno,
                              frame.f_code.co_name))
                frame = frame.f_back
            with self.lock:
                self.samples.append((self.running(), stack))
            if memory_mib()[1] < MIN_AVAILABLE_MIB:
                sys.stderr.write("chip_smoke_profile: host memory under "
                                 f"{MIN_AVAILABLE_MIB} MiB; stopping\n")
                self.write()
                os._exit(3)
            if time.monotonic() - last_write > 60:
                last_write = time.monotonic()
                self.write()

    def name(self, index: int, phases) -> str:
        return phases[index] if index < len(phases) else "(after the last)"

    def write(self):
        with self.lock:
            phases = list(self.phases)
            samples = list(self.samples)
            memory = list(self.memory)
            collections_ = {k: list(v) for k, v in self.gc.items()}
        per = {}
        for index, stack in samples:
            p = per.setdefault(self.name(index, phases), {
                "n": 0, "smoke": collections.Counter(),
                "port": collections.Counter(), "leaf": collections.Counter(),
                "port_anywhere": collections.Counter()})
            p["n"] += 1
            smoke = next((f for f in stack
                          if f[0].endswith("chip_smoke.py")), None)
            if smoke:
                p["smoke"][f"chip_smoke.py:{smoke[1]} {smoke[2]}"] += 1
            port = next((f for f in stack if PORT in f[0]), None)
            if port:
                p["port"][f"{port[0].split(PORT)[-1]}:{port[1]} "
                          f"{port[2]}"] += 1
            if stack:
                leaf = stack[0]
                p["leaf"][f"{os.path.basename(leaf[0])}:{leaf[1]} "
                          f"{leaf[2]}"] += 1
            for key in {f"{f[0].split(PORT)[-1]} {f[2]}"
                        for f in stack if PORT in f[0]}:
                p["port_anywhere"][key] += 1
        report = {}
        for name, p in per.items():
            report[name] = {
                "sampled_seconds": p["n"] * INTERVAL_S,
                **{k: [(where, n * INTERVAL_S)
                       for where, n in p[k].most_common(25)]
                   for k in ("smoke", "port", "leaf", "port_anywhere")}}
        gc_by_phase = {}
        for (index, generation), (n, seconds) in collections_.items():
            entry = gc_by_phase.setdefault(self.name(index, phases), {})
            entry[f"gen{generation}"] = {"collections": n,
                                         "seconds": seconds}
        out = {"interval_s": INTERVAL_S, "phases": report,
               "gc": gc_by_phase,
               "gc_seconds": sum(s for _n, s in collections_.values()),
               "memory_mib": [{"phase": name, "rss": rss,
                               "available": available}
                              for name, rss, available in memory]}
        os.makedirs(os.path.dirname(os.path.abspath(self.out)), exist_ok=True)
        with open(self.out, "w") as f:
            json.dump(out, f, indent=1)


def memory_mib():
    """(this process's resident set, the host's available memory), MiB."""
    rss = available = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) // 1024
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                available = int(line.split()[1]) // 1024
    return rss, available


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke_profile")
    ap.add_argument("--out", default="build/chip_smoke_profile.json")
    args = ap.parse_args(argv)
    prof = Profile(args.out)
    emit = chip_smoke.emit

    def emit_and_mark(obj):
        emit(obj)
        if "phase" in obj:
            prof.on_phase(obj["phase"])

    chip_smoke.emit = emit_and_mark
    gc.callbacks.append(prof.on_gc)
    threading.Thread(target=prof.sample, daemon=True).start()
    try:
        return chip_smoke.main()
    finally:
        prof.stopped = True
        prof.write()


if __name__ == "__main__":
    sys.exit(main())
