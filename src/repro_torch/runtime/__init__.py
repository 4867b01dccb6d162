"""Runtime: fault injection and the training supervisor (counterpart of
``repro.runtime``)."""
from .fault import (FailureInjector, FaultInjected, FaultPlan, FaultSpec,
                    Supervisor, SupervisorConfig, SupervisorStats, backoff)

__all__ = ["FailureInjector", "FaultInjected", "FaultPlan", "FaultSpec",
           "Supervisor", "SupervisorConfig", "SupervisorStats", "backoff"]
