"""Straggler-aware re-planning (a copy of the JAX package's
``ft/failures.py``).

* **Restart**: ``launch/train.py --resume`` finds the latest committed
  checkpoint (partial saves are invisible: ``ckpt/checkpoint.py`` commits
  through its manifest) and resumes; plans are NOT checkpointed — they are
  deterministic functions of (data seed, step, mesh, calibration), so a
  restart on a *different* pipeline depth simply re-plans.
* **Straggler mitigation**: :class:`StragglerMonitor` keeps an EWMA of
  per-stage step times; when a stage exceeds the median by ``threshold``,
  :func:`replan_costmodel` gives the planner per-stage slowdown multipliers
  (``CostModel.with_slowdowns``). As in the JAX trainer, the training loop
  never calls ``StragglerMonitor.observe`` (the controller's probe fit,
  ``telemetry/calibrate.fit_stage_slowdowns``, is what sees stragglers),
  so ``replan_costmodel`` returns its model unchanged there and the port's
  plans stay the reference's.
* **Injection**: :class:`StragglerInjector` scales the *reported* times
  only, never the computation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import CostModel

__all__ = ["StragglerInjector", "StragglerMonitor", "replan_costmodel"]


@dataclass
class StragglerMonitor:
    d_p: int
    ewma: float = 0.3
    threshold: float = 1.25            # x median => flagged
    _t: Optional[np.ndarray] = None

    def observe(self, per_stage_seconds: Sequence[float]) -> None:
        x = np.asarray(per_stage_seconds, dtype=np.float64)
        if self._t is None:
            self._t = x
        else:
            self._t = (1 - self.ewma) * self._t + self.ewma * x

    def slowdowns(self) -> Optional[List[float]]:
        """Per-stage multipliers (>=1) if any straggler is flagged."""
        if self._t is None:
            return None
        med = float(np.median(self._t))
        if med <= 0:
            return None
        mult = np.maximum(self._t / med, 1.0)
        if (mult < self.threshold).all():
            return None
        return [float(m) for m in mult]


def replan_costmodel(cm: CostModel,
                     monitor: StragglerMonitor) -> CostModel:
    """Cost model for the next planning round, straggler-aware."""
    slow = monitor.slowdowns()
    if slow is None:
        return cm
    return cm.with_slowdowns(slow)


@dataclass
class StragglerInjector:
    """Deterministic straggler injection for tests/CI: from ``start_step``
    on, the *reported* telemetry (per-stage seconds and the wall clock the
    timeline records) is scaled as if the configured stages ran slow.

    It perturbs measurements, NOT computation — losses are bitwise
    unaffected — which is exactly what the re-planning tests need: prove
    the telemetry → calibration → re-solve loop detects the skew and
    shifts work off the slow stage, without depending on real host noise.
    ``jitter`` adds seeded relative noise so hysteresis sees realistic
    measurements; determinism is per ``(seed, step)``.

    Spec string (``--inject-straggler``): ``STAGE:FACTOR[,STAGE:FACTOR...]
    [@START]`` with 1-based stages, e.g. ``"2:2.5@3"`` = stage 2 runs 2.5x
    slow starting at step 3.
    """

    d_p: int
    factors: Dict[int, float] = field(default_factory=dict)  # 1-based stage
    start_step: int = 0
    jitter: float = 0.0
    seed: int = 0

    @staticmethod
    def parse(spec: str, d_p: int, *, jitter: float = 0.0,
              seed: int = 0) -> "StragglerInjector":
        spec = spec.strip()
        start = 0
        if "@" in spec:
            spec, s = spec.rsplit("@", 1)
            start = int(s)
        factors: Dict[int, float] = {}
        for part in spec.split(","):
            if not part.strip():
                continue
            stage, factor = part.split(":")
            p = int(stage)
            if not 1 <= p <= d_p:
                raise ValueError(f"injector stage {p} outside 1..{d_p}")
            factors[p] = float(factor)
        return StragglerInjector(d_p=d_p, factors=factors,
                                 start_step=start, jitter=jitter, seed=seed)

    def active(self, step: int) -> bool:
        return bool(self.factors) and step >= self.start_step

    def _noise(self, step: int, n: int) -> np.ndarray:
        if self.jitter <= 0:
            return np.ones(n)
        rng = np.random.default_rng((self.seed, step))
        return 1.0 + self.jitter * rng.standard_normal(n)

    def per_stage(self, per_stage_seconds: Sequence[float],
                  step: int) -> List[float]:
        """The per-stage vector a probe would have measured."""
        x = np.asarray(per_stage_seconds, dtype=np.float64)
        out = x * self._noise(step, len(x))
        if self.active(step):
            for p, f in self.factors.items():
                out[p - 1] *= f
        return [float(v) for v in out]

    def wall(self, wall_seconds: float, step: int) -> float:
        """The step wall clock under injection: a pipeline runs at the
        slowest stage's pace, so the worst factor gates the step."""
        w = float(wall_seconds) * float(self._noise(step, 1)[0])
        if self.active(step):
            w *= max(self.factors.values())
        return w
