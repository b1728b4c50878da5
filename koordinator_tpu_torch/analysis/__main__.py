"""koordlint CLI.

    python -m koordinator_tpu_torch.analysis [paths...]
        [--baseline FILE] [--write-baseline] [--json] [--sarif]
        [--list-rules] [--guards] [--check-locks] [--jobs N]

Exit codes (the CI contract tests/test_static_analysis.py pins):
    0  no non-baselined, non-suppressed findings
    1  findings reported (or orphan locks under --check-locks)
    2  usage error / unreadable baseline

Default paths: ``koordinator_tpu_torch`` (the port's tree). Default
baseline: ``koordlint_baseline.json`` next to the first scanned tree's
repo root (CWD), used only when it exists; pass ``--baseline ''`` to
force a no-baseline run.

``--guards`` dumps the inferred guard map (which attribute is protected
by which lock — see analysis/guards.py) as JSON so drift is reviewable
in diffs; ``--check-locks`` additionally fails when any
``threading.Lock()``/``RLock()`` attribute in the scanned modules guards
nothing (an orphan lock is either dead weight or a guard the map failed
to learn — both deserve a look). ``--sarif`` emits SARIF 2.1.0 for
external CI consumers; ``--jobs`` sizes the per-file worker pool
(KOORDLINT_JOBS env works too; finding order is identical either way).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from koordinator_tpu_torch.analysis.core import (
    all_rules,
    analyze_paths,
    load_baseline,
    write_baseline,
)

DEFAULT_BASELINE = "koordlint_baseline.json"

SARIF_VERSION = "2.1.0"


def to_sarif(findings, rules) -> dict:
    """Findings as a SARIF 2.1.0 log (one run, one driver)."""
    return {
        "version": SARIF_VERSION,
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "runs": [{
            "tool": {"driver": {
                "name": "koordlint",
                "informationUri": ("https://github.com/koordinator-sh/"
                                   "koordinator"),
                "rules": [
                    {"id": name,
                     "shortDescription": {"text": rules[name].description}}
                    for name in sorted(rules)
                ],
            }},
            "results": [
                {"ruleId": f.rule,
                 "level": "error" if f.severity == "error" else "warning",
                 "message": {"text": f.message},
                 "locations": [{"physicalLocation": {
                     "artifactLocation": {"uri": f.path},
                     "region": {"startLine": f.line},
                 }}]}
                for f in findings
            ],
        }],
    }


def _guard_map_for(paths):
    from koordinator_tpu_torch.analysis.guards import (
        build_guard_map,
        collect_facts_for_paths,
    )

    return build_guard_map(collect_facts_for_paths(paths))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.analysis",
        description="koordlint: static analysis for JAX-tracing, "
                    "wire-decode and concurrency invariants")
    ap.add_argument("paths", nargs="*",
                    default=["koordinator_tpu_torch"],
                    help="files/directories to scan "
                         "(default: koordinator_tpu_torch)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: ./{DEFAULT_BASELINE} "
                         f"if present; '' disables)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current findings to the baseline "
                         "file and exit 0")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON array")
    ap.add_argument("--sarif", action="store_true",
                    help="emit findings as SARIF 2.1.0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--guards", action="store_true",
                    help="emit the inferred guard map as JSON and exit")
    ap.add_argument("--check-locks", action="store_true",
                    help="with --guards semantics: exit 1 when any "
                         "Lock/RLock attribute guards nothing (orphan)")
    ap.add_argument("--jobs", type=int, default=None,
                    help="per-file worker processes (default: auto; "
                         "KOORDLINT_JOBS env overrides)")
    args = ap.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for name in sorted(rules):
            r = rules[name]
            print(f"{name} [{r.severity}]\n    {r.description}")
        return 0

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        print(f"koordlint: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    # a path that exists but matches no .py files (a typo'd extensionless
    # file, an empty dir) must not produce a false-clean exit 0
    from koordinator_tpu_torch.analysis.core import iter_python_files

    empty = [p for p in args.paths
             if not any(True for _ in iter_python_files([p]))]
    if empty:
        print(f"koordlint: no Python files under: {', '.join(empty)}",
              file=sys.stderr)
        return 2

    if args.guards or args.check_locks:
        gm = _guard_map_for(args.paths)
        print(json.dumps(gm.to_dict(), indent=2, sort_keys=True))
        if args.check_locks:
            orphans = gm.orphan_locks()
            if orphans:
                for path, d in orphans:
                    print(f"koordlint: orphan lock: {path}:{d.line} "
                          f"{d.owner}.{d.attr} ({d.kind}) guards no field",
                          file=sys.stderr)
                return 1
        return 0

    baseline_path = args.baseline
    if baseline_path is None:
        baseline_path = (DEFAULT_BASELINE
                         if Path(DEFAULT_BASELINE).exists() else "")
    baseline = set()
    if baseline_path and not args.write_baseline:
        try:
            baseline = load_baseline(baseline_path)
        except (ValueError, OSError, KeyError, json.JSONDecodeError) as e:
            print(f"koordlint: bad baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2

    findings = analyze_paths(args.paths, baseline=baseline,
                             jobs=args.jobs)

    if args.write_baseline:
        target = baseline_path or DEFAULT_BASELINE
        write_baseline(target, findings)
        print(f"koordlint: wrote {len(findings)} finding(s) to {target}")
        return 0

    if args.sarif:
        print(json.dumps(to_sarif(findings, rules), indent=2))
    elif args.as_json:
        print(json.dumps([
            {"rule": f.rule, "severity": f.severity, "path": f.path,
             "line": f.line, "message": f.message}
            for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        n_err = sum(1 for f in findings if f.severity == "error")
        n_warn = len(findings) - n_err
        print(f"koordlint: {len(findings)} finding(s) "
              f"({n_err} error, {n_warn} warning) across "
              f"{len(rules)} rules"
              + (f", {len(baseline)} baselined" if baseline else ""))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
