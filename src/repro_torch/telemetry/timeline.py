"""StepTimeline: the low-overhead collection half of online re-planning
(a copy of the JAX package's ``telemetry/timeline.py``).

One recorder per training run. Events go into a bounded ring buffer
(``collections.deque``) and, when ``--telemetry-dir`` is set, are mirrored
line-by-line into an append-only JSONL spill. Always-on accounting is cheap
(a dict update + an EMA multiply per step). The port's step already ends in
``torch.cuda.synchronize``, so every step's wall time is a device time; the
caller's ``probe_every`` decides which steps also carry a per-stage vector.

Event kinds:

* ``step``         — one training step: bucket, wall seconds, tokens, loss,
                     optional per-stage seconds (probe steps only).
* ``probe``        — the per-stage breakdown of a probe step.
* ``lint``         — plan-lint findings attributed to a bucket.
* ``calibration``  — a new CostCalibration version was adopted.
* ``replan``       — re-plan trigger / decision / swap (replan.py).

A spill write that fails is counted (``dropped_spill_writes``) and never
raises: telemetry must not take the training loop down.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["StepEvent", "StepTimeline"]

EMA_DECAY = 0.3  # weight of the newest sample in the per-bucket step EMA


class StepEvent(dict):
    """A timeline event is a plain dict (JSON-ready); attribute sugar only."""

    @property
    def kind(self) -> str:
        return self.get("kind", "?")


class StepTimeline:
    """Ring buffer + JSONL spill + always-on per-bucket EMA counters."""

    def __init__(self, capacity: int = 1024,
                 spill_dir: Optional[str] = None,
                 name: str = "train", clock=time.time) -> None:
        self.name = name
        self._clock = clock
        self._events: deque = deque(maxlen=max(4, capacity))
        self._by_kind: Dict[str, int] = defaultdict(int)
        # per-bucket always-on counters: EMA step seconds, count, last value
        self._buckets: Dict[str, Dict[str, float]] = {}
        self._spill_path: Optional[Path] = None
        self._spill = None
        self.dropped_spill_writes = 0
        if spill_dir:
            d = Path(spill_dir)
            d.mkdir(parents=True, exist_ok=True)
            self._spill_path = d / f"timeline-{name}.jsonl"
            self._spill = open(self._spill_path, "a", buffering=1)

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, step: int = -1, **data: Any) -> StepEvent:
        ev = StepEvent(kind=kind, step=step, t=round(self._clock(), 6),
                       **data)
        self._events.append(ev)
        self._by_kind[kind] += 1
        if self._spill is not None:
            try:
                self._spill.write(json.dumps(ev, default=str) + "\n")
            except (OSError, ValueError):
                # telemetry must never take the training loop down
                self.dropped_spill_writes += 1
        return ev

    def record_step(self, step: int, bucket: Any, wall_s: float, *,
                    tokens: float = 0.0, loss: Optional[float] = None,
                    per_stage_s: Optional[List[float]] = None,
                    probed: bool = False, **extra: Any) -> StepEvent:
        """The always-on per-step sample. ``bucket`` is any hashable bucket
        identity (a ``BucketKey`` or its string form); ``per_stage_s`` is
        only present on probed steps."""
        b = str(bucket)
        st = self._buckets.setdefault(
            b, {"ema_s": 0.0, "n": 0, "last_s": 0.0})
        st["n"] += 1
        st["last_s"] = wall_s
        st["ema_s"] = (wall_s if st["n"] == 1 else
                       EMA_DECAY * wall_s + (1 - EMA_DECAY) * st["ema_s"])
        data: Dict[str, Any] = {"bucket": b, "wall_s": round(wall_s, 6),
                                "tokens": tokens, "probed": probed}
        if loss is not None:
            data["loss"] = loss
        if per_stage_s is not None:
            data["per_stage_s"] = [round(float(x), 6) for x in per_stage_s]
        data.update(extra)
        if probed and per_stage_s is not None:
            self.record("probe", step, bucket=b,
                        per_stage_s=data["per_stage_s"])
        return self.record("step", step, **data)

    # -- reading -----------------------------------------------------------

    def ema(self, bucket: Any) -> float:
        """Smoothed step seconds for a bucket (0.0 if never seen)."""
        st = self._buckets.get(str(bucket))
        return float(st["ema_s"]) if st else 0.0

    def events(self, kind: Optional[str] = None) -> List[StepEvent]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e.kind == kind]

    def snapshot(self) -> Dict[str, Any]:
        """The ``--stats-json``-ready summary (never the full ring)."""
        return {
            "name": self.name,
            "events": sum(self._by_kind.values()),
            "by_kind": dict(self._by_kind),
            "per_bucket": {
                b: {"ema_s": round(st["ema_s"], 6), "n": int(st["n"]),
                    "last_s": round(st["last_s"], 6)}
                for b, st in self._buckets.items()},
            "spill": str(self._spill_path) if self._spill_path else None,
            "dropped_spill_writes": self.dropped_spill_writes,
        }

    def close(self) -> None:
        if self._spill is not None:
            try:
                self._spill.close()
            finally:
                self._spill = None

    def __enter__(self) -> "StepTimeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
