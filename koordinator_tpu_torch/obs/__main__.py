"""Trace replay + koordexplain + koordwatch CLI.

    python -m koordinator_tpu_torch.obs trace.jsonl            # span waterfall
    curl -s localhost:9090/traces | python -m koordinator_tpu_torch.obs -
    python -m koordinator_tpu_torch.obs flight bundle.jsonl    # validate bundle
    python -m koordinator_tpu_torch.obs explain bundle.jsonl ns/pod
    python -m koordinator_tpu_torch.obs timeline timeline.jsonl  # device waterfall
    python -m koordinator_tpu_torch.obs slo slo.jsonl            # SLO table

Each trace renders as an indented latency waterfall — bar offset is the
span's monotonic start relative to its root, bar length its share of the
root's duration — so "where did the cycle spend its time" is answerable
from a terminal with no tooling.

``flight`` validates a flight-recorder bundle (obs/flight.py) against its
schema and prints a per-cycle summary; ``explain`` renders the stage-by-
stage verdict table for one pod from the newest cycle record that carries
it — the offline twin of the live ``/explain?pod=`` endpoint.

``timeline`` validates a koordwatch device-timeline bundle
(obs/timeline.py, the ``/debug/timeline`` body) and renders the
cross-consumer device waterfall — one bar per window, offset by its
idle gap, so "who had the device and when" is answerable from a
terminal. ``slo`` validates an SLO bundle (obs/slo.py, the
``/debug/slo`` body) and renders the objective table with burn rates.

A copy of the JAX package's obs/__main__.py: the bundles of both packages
share one schema, so each CLI reads the other's.

Exit codes (the `hack/lint.sh` golden-fixture contract, all subcommands):
  0  every record parsed and validated (explain: pod found)
  1  schema drift: bad JSON, missing/mistyped fields, dangling parent ids
     (explain: pod absent from the bundle)
  2  usage error (unreadable input)
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.obs import validate_record


def load_records(lines) -> Tuple[List[dict], List[str]]:
    records: List[dict] = []
    errors: List[str] = []
    for lineno, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as exc:
            errors.append(f"line {lineno}: invalid JSON ({exc})")
            continue
        errs = validate_record(obj)
        if errs:
            errors.extend(f"line {lineno}: {e}" for e in errs)
            continue
        records.append(obj)
    return records, errors


def build_traces(records: List[dict]
                 ) -> Tuple[List[Tuple[dict, Dict[int, List[dict]]]], List[str]]:
    """Group records into (root, children_by_parent) per trace id."""
    errors: List[str] = []
    by_trace: Dict[int, List[dict]] = {}
    for rec in records:
        by_trace.setdefault(rec["trace"], []).append(rec)
    traces = []
    for trace_id, spans in sorted(by_trace.items()):
        ids = {s["span"] for s in spans}
        roots = [s for s in spans if s["parent"] is None]
        for s in spans:
            if s["parent"] is not None and s["parent"] not in ids:
                errors.append(
                    f"trace {trace_id}: span {s['span']} ({s['name']!r}) "
                    f"has dangling parent {s['parent']}")
        if len(roots) != 1:
            errors.append(
                f"trace {trace_id}: expected exactly 1 root span, "
                f"got {len(roots)}")
            continue
        children: Dict[int, List[dict]] = {}
        for s in spans:
            if s["parent"] is not None:
                children.setdefault(s["parent"], []).append(s)
        for sibs in children.values():
            sibs.sort(key=lambda s: s["start_mono"])
        traces.append((roots[0], children))
    return traces, errors


def _bar(offset_ms: float, dur_ms: float, total_ms: float, width: int) -> str:
    if total_ms <= 0:
        return " " * width
    scale = width / total_ms
    lead = min(width - 1, int(round(offset_ms * scale)))
    length = max(1, int(round(dur_ms * scale)))
    length = min(length, width - lead)
    return " " * lead + "█" * length + " " * (width - lead - length)


def render_trace(root: dict, children: Dict[int, List[dict]],
                 width: int = 40, out=sys.stdout) -> None:
    total_ms = root["duration_ms"]
    n_spans = 1 + sum(len(v) for v in children.values())
    out.write(f"trace {root['trace']} · {root['name']} · "
              f"{total_ms:.2f}ms · {n_spans} spans\n")
    name_width = max(
        (len(s["name"]) + 2 * depth
         for s, depth in _walk(root, children)), default=0)

    for span, depth in _walk(root, children):
        offset_ms = (span["start_mono"] - root["start_mono"]) * 1000.0
        label = "  " * depth + span["name"]
        attrs = "".join(
            f" {k}={v}" for k, v in sorted(span["attrs"].items()))
        out.write(
            f"  {label:<{name_width}} "
            f"|{_bar(offset_ms, span['duration_ms'], total_ms, width)}| "
            f"{span['duration_ms']:8.2f}ms{attrs}\n")


def _walk(root: dict, children: Dict[int, List[dict]], depth: int = 0):
    yield root, depth
    for child in children.get(root["span"], []):
        yield from _walk(child, children, depth + 1)


def _read_lines(path: str) -> Optional[List[str]]:
    if path == "-":
        return sys.stdin.readlines()
    try:
        with open(path) as f:
            return f.readlines()
    except OSError as exc:
        print(f"cannot read {path!r}: {exc}", file=sys.stderr)
        return None


def flight_main(argv: List[str]) -> int:
    """`flight <bundle>`: schema-validate + summarize a flight bundle."""
    from koordinator_tpu_torch.obs.flight import load_bundle

    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.obs flight",
        description="validate and summarize a flight-recorder JSONL bundle")
    ap.add_argument("bundle", help="flight bundle file, or '-' for stdin")
    args = ap.parse_args(argv)
    lines = _read_lines(args.bundle)
    if lines is None:
        return 2
    header, records, errors = load_bundle(lines)
    if errors:
        for err in errors:
            print(f"schema error: {err}", file=sys.stderr)
        return 1
    print(f"flight bundle · reason={header['reason']} · "
          f"{header['cycles']} cycles")
    for rec in records:
        err = f" error={rec['error']!r}" if rec.get("error") else ""
        print(f"  cycle {rec['seq']}: {rec['duration_ms']:.2f}ms "
              f"waves={rec['waves']} bound={len(rec['bound'])} "
              f"failed={len(rec['failed'])} "
              f"rejected={len(rec['rejected'])}{err}")
    return 0


def explain_main(argv: List[str]) -> int:
    """`explain <bundle> <pod>`: the pod's stage-by-stage verdict table
    from the newest flight-bundle cycle that carries it."""
    from koordinator_tpu_torch.obs.flight import load_bundle

    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.obs explain",
        description="render one pod's decision attribution from a "
                    "flight-recorder bundle")
    ap.add_argument("bundle", help="flight bundle file, or '-' for stdin")
    ap.add_argument("pod", help="pod key (namespace/name)")
    args = ap.parse_args(argv)
    lines = _read_lines(args.bundle)
    if lines is None:
        return 2
    _header, records, errors = load_bundle(lines)
    if errors:
        for err in errors:
            print(f"schema error: {err}", file=sys.stderr)
        return 1
    hit = None
    for rec in records:  # newest record (bundle is oldest-first) wins
        for field in ("bound", "failed", "rejected"):
            for entry in rec[field]:
                if entry["pod"] == args.pod:
                    hit = (rec, field, entry)
    if hit is None:
        print(f"pod {args.pod!r} not found in any bundle cycle",
              file=sys.stderr)
        return 1
    rec, field, entry = hit
    verdict = "bound" if field == "bound" else f"unbound ({field})"
    print(f"pod {args.pod} · cycle {rec['seq']} · verdict: {verdict}")
    if field == "bound":
        print(f"  node: {entry['node']}")
        terms = entry.get("terms")
        if terms:
            width = max(len(k) for k in terms)
            for name, value in terms.items():
                print(f"  {name:<{width}}  {value:g}")
            if "best_score" in terms and "runner_up" in terms:
                print(f"  {'margin':<{width}}  "
                      f"{terms['best_score'] - terms['runner_up']:g}")
    else:
        if entry.get("reason"):
            print(f"  reason: {entry['reason']}")
        stages = entry.get("stages")
        if stages:
            width = max(len(k) for k in stages)
            print("  stage" + " " * (max(width - 5, 0) + 2)
                  + "rejected nodes")
            for name, count in sorted(stages.items(),
                                      key=lambda kv: -kv[1]):
                print(f"  {name:<{width}}  {count}")
        if entry.get("message"):
            print(f"  message: {entry['message']}")
    return 0


def timeline_main(argv: List[str]) -> int:
    """`timeline <bundle>`: schema-validate + render the device-window
    waterfall of a koordwatch timeline bundle."""
    from koordinator_tpu_torch.obs.timeline import load_bundle

    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.obs timeline",
        description="validate and render a koordwatch device-timeline "
                    "JSONL bundle as a cross-consumer waterfall")
    ap.add_argument("bundle", help="timeline bundle file, or '-' for stdin")
    ap.add_argument("--width", type=int, default=40,
                    help="waterfall bar width in characters")
    args = ap.parse_args(argv)
    lines = _read_lines(args.bundle)
    if lines is None:
        return 2
    header, records, errors = load_bundle(lines)
    if errors:
        for err in errors:
            print(f"schema error: {err}", file=sys.stderr)
        return 1
    print(f"device timeline · {header['windows']} windows · "
          f"idle fraction {header['idle_fraction']:.3f}")
    if not records:
        return 0
    width = max(10, args.width)
    # the waterfall axis: gap-prefixed windows laid end to end
    offsets, cursor = [], 0.0
    for rec in records:
        cursor += rec["gap_ms"]
        offsets.append(cursor)
        cursor += rec["duration_ms"]
    total = cursor or 1.0
    label_w = max(len(f"{r['consumer']}/{r['path']}") for r in records)
    id_w = max(len(r["decision_id"]) for r in records)
    for rec, off in zip(records, offsets):
        label = f"{rec['consumer']}/{rec['path']}"
        print(f"  {rec['decision_id']:<{id_w}} {label:<{label_w}} "
              f"|{_bar(off, rec['duration_ms'], total, width)}| "
              f"{rec['duration_ms']:8.2f}ms gap {rec['gap_ms']:8.2f}ms "
              f"{rec['outcome']}")
    return 0


def slo_main(argv: List[str]) -> int:
    """`slo <bundle>`: schema-validate + render a koordwatch SLO bundle
    as the objective table."""
    from koordinator_tpu_torch.obs.slo import load_bundle

    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.obs slo",
        description="validate and render a koordwatch SLO JSONL bundle")
    ap.add_argument("bundle", help="SLO bundle file, or '-' for stdin")
    args = ap.parse_args(argv)
    lines = _read_lines(args.bundle)
    if lines is None:
        return 2
    header, records, errors = load_bundle(lines)
    if errors:
        for err in errors:
            print(f"schema error: {err}", file=sys.stderr)
        return 1
    print(f"slo registry · {header['slos']} objectives")
    if not records:
        return 0
    name_w = max(len(r["slo"]) for r in records)
    for rec in records:
        pct = ("max" if rec["percentile"] >= 100
               else f"p{rec['percentile']:g}")
        verdict = "MET" if rec["met"] else "BLOWN"
        print(f"  {rec['slo']:<{name_w}}  {pct:>4} "
              f"{rec['observed']:10.3f} / {rec['target']:g} {rec['unit']} "
              f"· burn {rec['burn_rate']:.2f} · {rec['count']} samples "
              f"({rec['overruns']} overruns) · {verdict}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # subcommand dispatch keeps the historical `obs <trace.jsonl>` call
    # shape working (hack/lint.sh pins it against the golden fixture)
    if argv and argv[0] == "flight":
        return flight_main(argv[1:])
    if argv and argv[0] == "explain":
        return explain_main(argv[1:])
    if argv and argv[0] == "timeline":
        return timeline_main(argv[1:])
    if argv and argv[0] == "slo":
        return slo_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.obs",
        description="replay a koordtrace JSONL dump as a latency waterfall")
    ap.add_argument("trace", help="JSONL trace file, or '-' for stdin")
    ap.add_argument("--width", type=int, default=40,
                    help="waterfall bar width in characters")
    args = ap.parse_args(argv)

    lines = _read_lines(args.trace)
    if lines is None:
        return 2

    records, errors = load_records(lines)
    traces, tree_errors = build_traces(records)
    errors.extend(tree_errors)
    if errors:
        for err in errors:
            print(f"schema error: {err}", file=sys.stderr)
        return 1
    if not records:
        print("no spans in input", file=sys.stderr)
        return 0
    try:
        for i, (root, children) in enumerate(traces):
            if i:
                print()
            render_trace(root, children, width=max(10, args.width))
    except BrokenPipeError:
        # downstream pager/head closed the pipe mid-waterfall: normal CLI
        # usage, not an error; hand stdout a sink so interpreter shutdown
        # doesn't print a second traceback flushing the dead pipe
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
