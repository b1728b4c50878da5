"""koordsim: a fault-injecting churn simulator for the real scheduler.

The cluster simulator ROADMAP calls the scenario-diversity engine and
the regression harness: seeded arrival/departure processes (Poisson
arrivals, gang storms, burst queues), cluster events (node drain/delete,
spot reclamation, metric-expiry flips, quota rebalances) and an
injectable :class:`FaultPlan` drive the REAL :class:`Scheduler` (on the
card, or on the CPU) for thousands of cycles, checking the
store-level invariants (:mod:`koordinator_tpu_torch.sim.invariants`) after
every cycle and tracking time-to-bind p50/p99 SLOs with pending-queue
backpressure.

Run named scenarios with ``python -m koordinator_tpu_torch.sim <scenario>
[--device cuda|cpu]``; the catalog lives in
:mod:`koordinator_tpu_torch.sim.scenarios`, copied whole from the JAX
package. Every scenario runs: a scenario's mesh is that many virtual shards
of the sim's device (sim/harness.py), and the 1000-cycle ``soak`` runs
with its dead-sidecar cycles.
"""

from koordinator_tpu_torch.sim.faults import (  # noqa: F401
    Fault,
    FaultPlan,
    FaultyStore,
    InjectedFault,
)
from koordinator_tpu_torch.sim.harness import ChurnSimulator, SimReport  # noqa: F401
from koordinator_tpu_torch.sim.invariants import check_invariants  # noqa: F401
from koordinator_tpu_torch.sim.scenarios import SCENARIOS, Scenario  # noqa: F401
