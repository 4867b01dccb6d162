"""Runtime: the training supervisor (counterpart of ``repro.runtime``)."""
from .fault import (FailureInjector, Supervisor, SupervisorConfig,
                    SupervisorStats, backoff)

__all__ = ["FailureInjector", "Supervisor", "SupervisorConfig",
           "SupervisorStats", "backoff"]
