"""Test fixtures: synthetic clusters and trace replay.

Analog of the reference's load-bearing fixtures (SURVEY.md section 4): fake
clientset (client.ObjectStore is already in-process), scheduler-framework harness,
and workload generators standing in for the `examples/spark-jobs` colocation traces.
"""

from koordinator_tpu_torch.testing.synth import (  # noqa: F401
    SynthCluster,
    decorate_mixed,
    loadaware_inputs,
    mixed_cluster,
    synth_cluster,
    synth_full_cluster,
)
