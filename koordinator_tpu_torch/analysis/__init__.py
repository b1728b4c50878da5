"""koordlint: AST-based static analysis for this repo's hazard classes.

Run as ``python -m koordinator_tpu_torch.analysis <paths...>``; see README
"Static analysis". Public API:

  * all_rules() — the registry (name -> Rule)
  * analyze_source(src, path) — lint one source text (tests/fixtures)
  * analyze_paths(paths, baseline) — lint files/trees minus the baseline
  * load_baseline / write_baseline — the grandfathered-finding file
"""

from koordinator_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    ModuleContext,
    Rule,
    all_rules,
    analyze_paths,
    analyze_source,
    load_baseline,
    register,
    suppressed_lines,
    write_baseline,
)

__all__ = [
    "Finding", "ModuleContext", "Rule", "all_rules", "analyze_paths",
    "analyze_source", "load_baseline", "register", "suppressed_lines",
    "write_baseline",
]
