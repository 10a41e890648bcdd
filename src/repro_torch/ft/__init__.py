"""Straggler monitoring, cost-model re-planning and deterministic straggler
injection (a copy of the JAX package's ``ft/``)."""

from .failures import StragglerInjector, StragglerMonitor, replan_costmodel

__all__ = ["StragglerInjector", "StragglerMonitor", "replan_costmodel"]
