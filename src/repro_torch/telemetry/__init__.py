"""Telemetry, calibration and online re-planning (the trainer's control
plane), copied from the JAX package's ``telemetry/``: pure Python and
NumPy on the port's ``core``, no torch.

* :mod:`.timeline` — ``StepTimeline``: ring-buffered event recorder with
  JSONL spill and always-on per-bucket EMA counters.
* :mod:`.calibrate` — ``CostCalibration``: robust fit of measured step
  times back onto ``core/costs.py`` terms, plus the CUSUM / length-mix
  drift detectors.
* :mod:`.replan` — ``ReplanController``: drift → fit → re-solve →
  hysteresis-gated swap at a step boundary (plan-lint rejection, per-mesh
  calibration persistence).
"""

from .calibrate import (CostCalibration, Cusum, MixTracker, StepSample,
                        fit_calibration, fit_stage_slowdowns,
                        plan_components, predicted_work)
from .replan import ReplanConfig, ReplanController, ReplanDecision
from .stats_io import atomic_write_json, read_json, read_jsonl
from .timeline import StepEvent, StepTimeline

__all__ = [
    "CostCalibration", "Cusum", "MixTracker", "StepSample",
    "fit_calibration", "fit_stage_slowdowns", "plan_components",
    "predicted_work",
    "ReplanConfig", "ReplanController", "ReplanDecision",
    "atomic_write_json", "read_json", "read_jsonl",
    "StepEvent", "StepTimeline",
]
