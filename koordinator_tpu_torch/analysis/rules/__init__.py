"""Rule modules; importing this package registers every rule."""

from koordinator_tpu_torch.analysis.rules import (  # noqa: F401
    balance,
    colo,
    compilecache,
    concurrency,
    demotion,
    jaxtrace,
    loops,
    pipeline,
    race,
    wire,
)
