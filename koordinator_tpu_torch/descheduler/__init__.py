"""koord-descheduler (analog of reference `pkg/descheduler/`, SURVEY.md 2.5):
profile-driven Deschedule/Balance plugin runner, the LowNodeLoad utilization
balancer (its victim selection as a tensor pass on the card, balance/), and
the arbitration-gated MigrationController."""

from koordinator_tpu_torch.descheduler.lownodeload import LowNodeLoad  # noqa: F401
from koordinator_tpu_torch.descheduler.migration import (  # noqa: F401
    Arbitrator,
    MigrationController,
)
from koordinator_tpu_torch.descheduler.descheduler import Descheduler  # noqa: F401
