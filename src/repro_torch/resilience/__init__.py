"""repro_torch.resilience — fault tolerance for the serving path.

    monitor : HeartbeatMonitor / StragglerMonitor / RestartPolicy /
              Supervisor — the launcher-facing liveness + restart layer
              (clock-injectable, deterministic under test)
    faults  : seeded deterministic FaultPlan injection, armed into the
              fault-plan slot of ``repro_torch.core.health``

The dispatch-level circuit breaker itself lives in ``repro_torch.core.health``
(core must not depend on this package).
"""
from .faults import SITES, FaultPlan, FaultSpec
from .monitor import (
    HeartbeatMonitor,
    RestartPolicy,
    StragglerMonitor,
    Supervisor,
    serve_under_supervision,
)

__all__ = [
    "SITES", "FaultPlan", "FaultSpec",
    "HeartbeatMonitor", "RestartPolicy", "StragglerMonitor", "Supervisor",
    "serve_under_supervision",
]
