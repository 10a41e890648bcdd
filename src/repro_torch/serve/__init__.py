"""Continuous-batching serving engine of the port.

The scheduler, page pool and speculative helpers are host-only Python
(copies of the JAX package's); :mod:`.engine` drives the device step in
``repro_torch.runtime.serve_step``.
"""

from .kv_manager import PagedKVPool, PoolStats
from .scheduler import SchedulerConfig, Segment, StepPlan, TickScheduler
from .speculative import SpecStats, propose_draft, verify_greedy

__all__ = ["PagedKVPool", "PoolStats", "SchedulerConfig", "Segment",
           "SpecStats", "StepPlan", "TickScheduler", "propose_draft",
           "verify_greedy"]
