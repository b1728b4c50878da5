"""koordlet: the node agent (analog of reference `pkg/koordlet/`, SURVEY.md 2.3).

Module wiring follows `koordlet.go:70-188`: the Daemon builds resourceexecutor,
metriccache, statesinformer, metricsadvisor, prediction, qosmanager and
runtimehooks, then runs them in dependency order. All kernel interfaces go
through `util/system` with redirectable roots so everything runs hermetically
against a fake /sys + /proc + cgroupfs tree (the reference's FileTestUtil
pattern, util_test_tool.go:56-69).
"""

from koordinator_tpu_torch.koordlet.daemon import Daemon  # noqa: F401
