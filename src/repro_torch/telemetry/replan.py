"""Online re-planning controller: drift → calibrate → re-solve → hot-swap
(a copy of the JAX package's ``telemetry/replan.py``; the same decisions on
the same inputs, which ``tests/test_torch_replan.py`` holds equal).

The controller closes the loop from live telemetry back to the solver. It
owns the drift detectors (CUSUM on relative prediction residuals,
fast/slow-EMA length-mix tracker), the sample window the calibration fits
from, and the swap policy:

* Per-step solves in the training loop always use the **active**
  calibration (frozen between adoptions, so plan buckets stay stable).
* On a trigger (drift, mix shift, elastic mesh change, forced, or the
  bootstrap fit once ``min_samples`` have arrived) a re-plan job runs —
  inline, or on a background thread (``ReplanConfig.background``) so the
  training loop never blocks on the ILP: fit a candidate
  :class:`CostCalibration`, re-solve the latest batch with it, and re-cost
  the incumbent plan under the *same* candidate model (like against like).
* If the candidate keeps the incumbent's bucket the calibration is adopted
  silently (no swap). If it changes bucket it must beat the incumbent by
  ``min_win`` (hysteresis, default >5%) AND pass the plan lint; then, in
  ``auto`` mode, ``precompile(candidate)`` runs before adoption. The port
  compiles nothing per bucket, so its training loop passes no
  ``precompile`` (the callback stays for a driver that has per-bucket work
  to prepare, such as CUDA graphs) and ``precompiled`` stays False.
* ``observe`` mode runs the whole machinery (fits, residuals, would-swap
  decisions in the stats) but ``cost_model()`` keeps returning the base
  model, so plans — and therefore numerics — are untouched.

Adoption happens only in :meth:`ReplanController.poll`, which the driver
calls at a step boundary.

Calibrations persist to ``<telemetry-dir>/calibration.json`` keyed by mesh
fingerprint (``"{d_p}x{d_s}:{spec.name}"``): an elastic restart onto the
same mesh warm-starts its calibration; a restart onto a *different* mesh
(shrink/grow) finds only foreign fingerprints and forces an immediate
re-solve instead of replaying the bootstrap plan.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.costs import CostModel
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.planner import estimate_plan_time

from .calibrate import (CostCalibration, Cusum, MixTracker, StepSample,
                        fit_calibration, plan_components)
from .stats_io import atomic_write_json, read_json
from .timeline import StepTimeline

__all__ = ["ReplanConfig", "ReplanController", "ReplanDecision"]


@dataclass
class ReplanConfig:
    mode: str = "off"              # "off" | "observe" | "auto"
    min_win: float = 0.05          # hysteresis: swap needs >5% predicted win
    cooldown_steps: int = 8        # min steps between re-plan jobs
    min_samples: int = 4           # samples before the first fit
    window: int = 32               # sample window the fit sees
    probe_window: int = 8          # per-stage probe vectors kept for slowdowns
    cusum_k: float = 0.05
    cusum_h: float = 0.5
    mix_rel: float = 0.3
    background: bool = False       # re-plan jobs on a worker thread

    @property
    def enabled(self) -> bool:
        return self.mode in ("observe", "auto")


@dataclass
class ReplanDecision:
    """Outcome of one re-plan job (returned from :meth:`poll` on adoption)."""
    step: int
    reason: str
    decision: str = ""             # swap | recalibrate | hysteresis | lint-reject
    calibration: Optional[CostCalibration] = None
    plan: Optional[ExecutionPlan] = None
    old_bucket: str = ""
    new_bucket: str = ""
    t_candidate: float = 0.0
    t_incumbent: float = 0.0
    lint_errors: List[str] = field(default_factory=list)
    precompiled: bool = False

    @property
    def win(self) -> float:
        if self.t_incumbent <= 0:
            return 0.0
        return 1.0 - self.t_candidate / self.t_incumbent

    @property
    def is_swap(self) -> bool:
        return self.decision == "swap"


class ReplanController:
    """One controller per training run. The driver supplies the closures
    that tie it to its stack: ``solve(cm, lengths) -> ExecutionPlan``,
    ``bucket_of(plan) -> str`` (the compile-cache identity), optional
    ``lint(plan) -> [error, ...]`` and ``precompile(plan)``."""

    def __init__(self, base_cm: CostModel, cfg: ReplanConfig,
                 solve: Callable[[CostModel, Sequence[int]], ExecutionPlan],
                 bucket_of: Callable[[ExecutionPlan], str], *,
                 evaluate: Callable[[CostModel, ExecutionPlan], float]
                 = estimate_plan_time,
                 lint: Optional[Callable[[ExecutionPlan], List[str]]] = None,
                 precompile: Optional[Callable[[ExecutionPlan], Any]] = None,
                 resolve_incumbent: Optional[
                     Callable[[CostModel, Sequence[int], ExecutionPlan],
                              ExecutionPlan]] = None,
                 timeline: Optional[StepTimeline] = None,
                 telemetry_dir: Optional[str] = None,
                 fingerprint: str = "", log=None) -> None:
        self.base_cm = base_cm
        self.cfg = cfg
        self.solve = solve
        self.bucket_of = bucket_of
        self.evaluate = evaluate
        self.lint = lint
        self.precompile = precompile
        # "what would the NEXT steps cost if we kept the incumbent's
        # bucket" — the driver supplies a bucket-constrained re-solve so
        # hysteresis compares both plans on the SAME batch; the default
        # costs the incumbent plan as-is (fine when mixes are stationary)
        self.resolve_incumbent = resolve_incumbent or (
            lambda cm, lengths, inc: inc)
        self.timeline = timeline
        self.fingerprint = fingerprint or (
            f"{base_cm.cluster.d_p}x{base_cm.cluster.d_s}:"
            f"{base_cm.model.name}")
        self.log = log or (lambda *_: None)
        self._cal_path = (Path(telemetry_dir) / "calibration.json"
                          if telemetry_dir else None)

        self.active: Optional[CostCalibration] = None
        self.version = 0
        self.cusum = Cusum(k=cfg.cusum_k, h=cfg.cusum_h)
        self.mix = MixTracker(rel=cfg.mix_rel)
        self._samples: deque = deque(maxlen=cfg.window)
        self._probes: deque = deque(maxlen=cfg.probe_window)
        self._last_plan: Optional[ExecutionPlan] = None
        # the incumbent REFERENCE: the last plan this controller adopted
        # (seeded by the first executed plan). Per-step solves may ride the
        # length mix freely — a "swap" is the control-plane event where the
        # adopted reference moves to a different bucket (and the fresh
        # bucket gets precompiled before the step boundary needs it).
        self._adopted_plan: Optional[ExecutionPlan] = None
        self._last_lengths: List[int] = []
        self._last_trigger_step = -10 ** 9
        self._force: Optional[str] = None
        self._lock = threading.Lock()
        self._pending: Optional[ReplanDecision] = None
        self._worker: Optional[threading.Thread] = None
        self._active_cm_cache: Optional[CostModel] = None
        self.counters: Dict[str, int] = {
            "fits": 0, "swaps": 0, "would_swaps": 0, "recalibrations": 0,
            "hysteresis_rejects": 0, "lint_rejects": 0, "forced": 0}
        self.trigger_reasons: Dict[str, int] = {}
        self.swap_steps: List[int] = []
        self._load_persisted()

    # -- the model the per-step solver uses --------------------------------

    def cost_model(self) -> CostModel:
        """Active calibrated model in ``auto`` mode; the base model
        otherwise (``observe`` never perturbs the plans)."""
        if self.cfg.mode != "auto" or self.active is None:
            return self.base_cm
        if self._active_cm_cache is None:
            self._active_cm_cache = self.active.apply(self.base_cm)
        return self._active_cm_cache

    def _residual_cm(self) -> CostModel:
        """The model residuals are measured against: the active calibration
        in BOTH observe and auto mode (observe still tracks drift — it just
        never feeds plans)."""
        if self.active is None:
            return self.base_cm
        if self.cfg.mode == "auto":
            return self.cost_model()
        return self.active.apply(self.base_cm)

    # -- collection --------------------------------------------------------

    def observe_step(self, step: int, plan: ExecutionPlan,
                     measured_s: float, lengths: Sequence[int], *,
                     per_stage_s: Optional[Sequence[float]] = None,
                     comm_s: Optional[float] = None,
                     bucket: Optional[str] = None) -> Optional[str]:
        """Feed one executed step. ``per_stage_s`` / ``comm_s`` are probe
        measurements (per-stage walls, collective seconds) when the driver
        ran this step in probe mode. Returns the trigger reason when a
        re-plan job was launched this step, else None."""
        if not self.cfg.enabled:
            return None
        sp_pol = plan.sp.policy if plan.sp is not None else "none"
        self._samples.append(StepSample(
            step=step, measured_s=float(measured_s),
            components=plan_components(self.base_cm, plan),
            sp_policy=sp_pol,
            bucket=bucket if bucket is not None else self.bucket_of(plan),
            tokens=float(sum(lengths)),
            comm_s=float(comm_s) if comm_s else 0.0,
            predicted_s=self.evaluate(self.base_cm, plan)))
        if per_stage_s is not None:
            self._probes.append([float(x) for x in per_stage_s])
        self._last_plan = plan
        if self._adopted_plan is None:
            self._adopted_plan = plan  # bootstrap incumbent
        self._last_lengths = list(lengths)

        predicted = self.evaluate(self._residual_cm(), plan)
        r = ((measured_s - predicted) / predicted) if predicted > 0 else 0.0
        drifted = self.cusum.update(r)
        shifted = self.mix.update(lengths)

        reason = None
        if self._force:
            reason, self._force = self._force, None
            self.counters["forced"] += 1
        elif self.active is None and len(self._samples) >= self.cfg.min_samples:
            reason = "bootstrap"   # first fit absorbs the sim-vs-wall scale
        elif drifted:
            reason = "drift"
        elif shifted:
            reason = "mix-shift"
        if reason is None:
            return None
        if reason not in ("elastic", "forced"):
            if len(self._samples) < self.cfg.min_samples:
                return None
            if step - self._last_trigger_step < self.cfg.cooldown_steps:
                return None
        if self._worker is not None and self._worker.is_alive():
            return None  # a job is already in flight
        self._last_trigger_step = step
        self.trigger_reasons[reason] = self.trigger_reasons.get(reason, 0) + 1
        if self.timeline is not None:
            self.timeline.record("replan", step, phase="trigger",
                                 reason=reason, cusum=self.cusum.state(),
                                 mix=self.mix.state())
        job_args = (step, reason, list(self._samples), list(self._probes),
                    self._adopted_plan or self._last_plan,
                    list(self._last_lengths))
        if self.cfg.background:
            self._worker = threading.Thread(
                target=self._replan_job, args=job_args,
                name="replan-worker", daemon=True)
            self._worker.start()
        else:
            self._replan_job(*job_args)
        return reason

    def force_replan(self, reason: str = "forced") -> None:
        """Queue an unconditional re-plan at the next observed step —
        elastic shrink/grow events route through here."""
        self._force = reason

    # -- the re-plan job (worker thread or inline) -------------------------

    def _replan_job(self, step: int, reason: str,
                    samples: List[StepSample], probes: List[List[float]],
                    incumbent: Optional[ExecutionPlan],
                    lengths: List[int]) -> None:
        try:
            cal: Optional[CostCalibration] = None
            if samples:
                cal = fit_calibration(
                    samples, probes=probes, d_p=self.base_cm.cluster.d_p,
                    fingerprint=self.fingerprint, version=self.version + 1,
                    prior=self.active, created_step=step)
                self.counters["fits"] += 1
            cand_cm = (cal.apply(self.base_cm) if cal is not None
                       else self._residual_cm())
            candidate = self.solve(cand_cm, lengths)
            dec = ReplanDecision(step=step, reason=reason, calibration=cal,
                                 plan=candidate,
                                 new_bucket=self.bucket_of(candidate))
            if incumbent is not None:
                dec.old_bucket = self.bucket_of(incumbent)
                dec.t_candidate = self.evaluate(cand_cm, candidate)
                # like against like: the incumbent's BUCKET re-planned on
                # the trigger step's batch (resolve_incumbent), both costed
                # under the candidate calibration
                held = self.resolve_incumbent(cand_cm, lengths, incumbent)
                dec.t_incumbent = self.evaluate(cand_cm, held)
            if incumbent is None or dec.new_bucket == dec.old_bucket:
                dec.decision = "recalibrate"
            elif reason == "bootstrap":
                # the bootstrap fit exists to absorb the units conversion —
                # a bucket move proposed by a model that just changed
                # wholesale is not evidence; adopt the calibration only and
                # let a real drift trigger argue for the move
                dec.decision, dec.plan = "recalibrate", None
            elif dec.t_candidate >= (1.0 - self.cfg.min_win) * dec.t_incumbent:
                dec.decision = "hysteresis"
            else:
                errs = list(self.lint(candidate)) if self.lint else []
                if errs:
                    dec.decision, dec.lint_errors = "lint-reject", errs
                elif self.cfg.mode == "auto":
                    if self.precompile is not None:
                        self.precompile(candidate)
                        dec.precompiled = True
                    dec.decision = "swap"
                else:
                    dec.decision = "swap"  # observe: counted as would-swap
            with self._lock:
                self._pending = dec
        except Exception as e:  # noqa: BLE001 — telemetry never kills training
            self.log(f"[replan] job failed ({reason} @ step {step}): {e!r}")
            if self.timeline is not None:
                self.timeline.record("replan", step, phase="error",
                                     reason=reason, error=repr(e))

    # -- adoption at the step boundary -------------------------------------

    def poll(self) -> Optional[ReplanDecision]:
        """Collect a finished re-plan job and adopt its outcome. Call once
        per step, at the boundary. Returns the decision when a SWAP (auto)
        or would-swap (observe) was adopted this poll, else None."""
        with self._lock:
            dec, self._pending = self._pending, None
        if dec is None:
            return None
        adopt = dec.decision in ("swap", "recalibrate")
        # hysteresis rejects the BUCKET MOVE, not the fit: the calibration
        # still explains the measurements better, and dropping it would
        # leave residuals high and re-fire the same trigger every window
        adopt_cal = adopt or dec.decision == "hysteresis"
        if dec.decision == "hysteresis":
            self.counters["hysteresis_rejects"] += 1
        elif dec.decision == "lint-reject":
            self.counters["lint_rejects"] += 1
            self.log(f"[replan] candidate bucket {dec.new_bucket} REJECTED "
                     f"by plan lint: {dec.lint_errors[:3]}")
        if adopt and dec.plan is not None:
            self._adopted_plan = dec.plan
        if adopt_cal and dec.calibration is not None:
            self.active = dec.calibration
            self.version = dec.calibration.version
            self._active_cm_cache = None
            if dec.reason in ("drift", "elastic"):
                # a detected regime change means the window's older rows
                # describe a reality that no longer exists; refitting on a
                # window that straddles the change makes the regimes fight
                # and rotates the split every trigger. Restart collection
                # from the change point.
                self._samples.clear()
                self._probes.clear()
            self._persist()
            if self.timeline is not None:
                self.timeline.record("calibration", dec.step,
                                     version=self.version,
                                     deltas=dec.calibration.deltas(),
                                     rms=dec.calibration.residual_rel_rms)
        if dec.decision == "recalibrate":
            self.counters["recalibrations"] += 1
        swap = None
        if dec.is_swap:
            key = "swaps" if self.cfg.mode == "auto" else "would_swaps"
            self.counters[key] += 1
            if self.cfg.mode == "auto":
                self.swap_steps.append(dec.step)
            swap = dec
            self.log(f"[replan] {'swap' if self.cfg.mode == 'auto' else 'would swap'} "
                     f"@ step {dec.step} ({dec.reason}): "
                     f"{dec.old_bucket} -> {dec.new_bucket} "
                     f"predicted win {dec.win:.1%}"
                     + (" (precompiled)" if dec.precompiled else ""))
        if self.timeline is not None:
            self.timeline.record(
                "replan", dec.step, phase="decision",
                decision=dec.decision, reason=dec.reason,
                win=round(dec.win, 4), old=dec.old_bucket,
                new=dec.new_bucket, precompiled=dec.precompiled,
                mode=self.cfg.mode)
        # one trigger -> one decision: reset the detectors so the same
        # residual history cannot re-fire next step
        self.cusum.reset()
        self.mix.settle()
        return swap

    def drain(self, timeout: float = 30.0) -> None:
        """Wait for an in-flight background job (end of run)."""
        w = self._worker
        if w is not None and w.is_alive():
            w.join(timeout)

    # -- persistence -------------------------------------------------------

    def _load_persisted(self) -> None:
        if self._cal_path is None:
            return
        data = read_json(str(self._cal_path))
        if not isinstance(data, dict) or not data:
            return
        mine = data.get(self.fingerprint)
        if mine:
            self.active = CostCalibration.from_dict(mine)
            self.version = self.active.version
            self._active_cm_cache = None
            self.log(f"[replan] warm calibration v{self.version} for "
                     f"{self.fingerprint} from {self._cal_path}")
        else:
            # calibrations exist but none for THIS mesh: an elastic
            # shrink/grow changed the topology under the run — re-solve
            # immediately instead of replaying the bootstrap plan
            self.force_replan("elastic")
            self.log(f"[replan] mesh {self.fingerprint} has no calibration "
                     f"(store has {sorted(data)}); forcing elastic re-solve")

    def _persist(self) -> None:
        if self._cal_path is None or self.active is None:
            return
        data = read_json(str(self._cal_path), default={}) or {}
        data[self.fingerprint] = self.active.to_dict()
        atomic_write_json(str(self._cal_path), data)

    # -- reporting ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {
            "mode": self.cfg.mode,
            "fingerprint": self.fingerprint,
            "calibration_version": self.version,
            "calibration": (self.active.to_dict()
                            if self.active is not None else None),
            "calibration_deltas": (self.active.deltas()
                                   if self.active is not None else {}),
            "counters": dict(self.counters),
            "triggers": dict(self.trigger_reasons),
            "swap_steps": list(self.swap_steps),
            "cusum": self.cusum.state(),
            "mix": self.mix.state(),
            "samples": len(self._samples),
        }
