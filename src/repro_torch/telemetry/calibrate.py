"""Fit measured step times back onto ``core/costs.py`` terms (a copy of the
JAX package's ``telemetry/calibrate.py`` on the port's ``core``).

The fit is deliberately *structured*: rather than free-fitting Eq. 1's
coefficients from scratch (ill-posed from a handful of step samples), each
step's predicted time is decomposed under the **base** analytic model into
five work components — quadratic attention, linear compute, per-stage
dispatch overhead, checkpoint recompute, SP collectives — and a robust
(Huber-IRLS, ridge-regularized toward 1.0) regression fits one
multiplicative scale per component:

    measured ≈ s_quad·P_quad + s_lin·P_lin + s_over·P_over
               + s_rec·P_rec + s_comm(policy)·P_comm

The scales then re-enter the model exactly where they came from:
``alpha1' = s_quad·alpha1``, ``alpha2' = s_lin·alpha2``, ``beta1' =
s_over·beta1``, ``recompute_factor = s_rec``, and the collective bandwidth
per SP policy divides by ``s_comm`` — so a :class:`CostCalibration` is just
a versioned, serializable recipe for constructing a calibrated
:class:`~repro_torch.core.costs.CostModel`. Components that carry no signal in
the sample window (all-zero or non-varying columns) keep their base scale
of 1.0 instead of absorbing noise.

Drift detection is a two-sided CUSUM on relative prediction residuals
(:class:`Cusum`) plus a fast/slow-EMA length-mix tracker
(:class:`MixTracker`); both are consumed by ``telemetry/replan.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.costs import BWD_MULT, CostModel
from repro_torch.core.plan import ExecutionPlan

__all__ = ["CostCalibration", "StepSample", "Cusum", "MixTracker",
           "plan_components", "predicted_work", "fit_calibration",
           "fit_stage_slowdowns"]

COMPONENTS = ("quad", "lin", "over", "rec", "comm")
# a stage is a straggler when its mean relative tick time exceeds this
SLOWDOWN_THRESHOLD = 1.1


# ---------------------------------------------------------------------------
# Work decomposition under the base model.
# ---------------------------------------------------------------------------

def plan_components(cm: CostModel, plan: ExecutionPlan) -> Dict[str, float]:
    """Decompose one plan's predicted *work* (fwd+bwd+recompute, summed over
    chunks; no bubble) into the five calibratable components, evaluated at
    the plan's own SP point."""
    out = {k: 0.0 for k in COMPONENTS}
    pcm = cm
    if plan.sp is not None:
        pcm = cm.with_sp(plan.sp.policy, plan.sp.d_s_eff)
    cl, co = pcm.cluster, pcm.coeffs
    both = 1.0 + BWD_MULT
    for pp in plan.pipelines:
        for k, ck in enumerate(pp.chunks):
            C, s0 = float(ck.context), float(ck.s0)
            quad = (C + s0) ** 2 - C ** 2 if s0 else 0.0
            lin = s0
            for s in ck.short_slices:
                quad += float(s.length) ** 2
                lin += float(s.length)
            geom = pcm.sp_replication / cl.n_devices / pcm.utilization(ck)
            p_quad = both * co.alpha1 * 0.5 * quad * geom
            p_lin = both * co.alpha2 * lin * geom
            out["quad"] += p_quad
            out["lin"] += p_lin
            out["over"] += both * co.beta1 / cl.d_p
            out["comm"] += both * pcm.t_sp_comm(ck)
            # ckpt[p][k]: each stage re-runs its own checkpointed depth;
            # the total equals the mean depth's whole-model fraction
            if pp.ckpt:
                l_mean = sum(row[k] for row in pp.ckpt) / len(pp.ckpt)
                if l_mean > 0:
                    frac = min(1.0, l_mean * cl.d_p / pcm.model.n_layers)
                    out["rec"] += frac * ((p_quad + p_lin) / both
                                          + pcm.t_sp_comm(ck))
    return out


def predicted_work(cm: CostModel, plan: ExecutionPlan) -> float:
    return sum(plan_components(cm, plan).values())


@dataclass
class StepSample:
    """One measured step, with its work decomposition frozen at record time
    (under the base model — the design matrix must not move as calibrations
    are adopted)."""
    step: int
    measured_s: float
    components: Dict[str, float]
    sp_policy: str = "none"
    bucket: str = ""
    tokens: float = 0.0
    # measured collective seconds this step (profiler/NCCL-style timing),
    # 0 = not probed. A direct comm probe pins the bandwidth scale exactly;
    # without it comm is identifiable only when the comm SHARE varies
    # across the sample window (it often doesn't — a uniform bandwidth
    # collapse inflates every row alike and the regression misattributes
    # it to whichever compute column varies most)
    comm_s: float = 0.0
    # the BASE model's simulated makespan for this plan, 0 = unknown. When
    # present, the fit renormalizes the row so its components sum to this
    # value: the work-sum surrogate cannot represent per-mix bubble
    # differences, and without the renormalization that structural mismatch
    # is real in-sample signal the regression "explains" by rotating
    # coefficients — distorting the planner's trade-offs even when
    # measured == base prediction exactly
    predicted_s: float = 0.0


# ---------------------------------------------------------------------------
# The calibration artifact.
# ---------------------------------------------------------------------------

@dataclass
class CostCalibration:
    """A versioned recipe for constructing a calibrated CostModel."""
    version: int = 0
    scales: Dict[str, float] = field(
        default_factory=lambda: {k: 1.0 for k in COMPONENTS})
    comm_scales: Dict[str, float] = field(default_factory=dict)
    stage_slowdowns: Optional[List[float]] = None
    fingerprint: str = ""           # mesh identity (d_p x d_s : arch)
    n_samples: int = 0
    residual_rel_rms: float = 0.0
    created_step: int = -1

    # -- derived views ------------------------------------------------------

    def deltas(self) -> Dict[str, float]:
        """Relative change per term vs the analytic base (0.0 = unchanged);
        the quantities BENCH_replan's ``meta`` records."""
        d = {k: round(v - 1.0, 4) for k, v in self.scales.items()}
        for pol, s in self.comm_scales.items():
            d[f"comm[{pol}]"] = round(s - 1.0, 4)
        if self.stage_slowdowns:
            d["max_stage_slowdown"] = round(max(self.stage_slowdowns) - 1.0, 4)
        return d

    def apply(self, base: CostModel) -> CostModel:
        """Construct the calibrated model. The SP policy/degree of ``base``
        is preserved; ``stage_slowdowns`` replace any on ``base``."""
        s = self.scales
        co = replace(base.coeffs,
                     alpha1=base.coeffs.alpha1 * s.get("quad", 1.0),
                     alpha2=base.coeffs.alpha2 * s.get("lin", 1.0),
                     beta1=base.coeffs.beta1 * s.get("over", 1.0))
        comm = self.comm_scales.get(base.sp_policy, s.get("comm", 1.0))
        if comm > 0 and comm != 1.0:
            co = replace(co, a2a_bw=co.a2a_bw / comm, ag_bw=co.ag_bw / comm)
        slow = self.stage_slowdowns
        if slow is not None and len(slow) != base.cluster.d_p:
            slow = None  # stale mesh shape — drop rather than crash
        return CostModel(base.model, base.cluster, co,
                         sp_policy=base.sp_policy, sp_degree=base.sp_degree,
                         stage_slowdowns=slow, sat_half=base.sat_half,
                         ce_mode=base.ce_mode,
                         recompute_factor=s.get("rec", 1.0))

    # recovered per-token times (whole model / cluster), for the round-trip
    # gate: t_b/t_w derive from t_f exactly as the schedule layer does
    def t_f_per_token(self, base: CostModel) -> float:
        return (base.coeffs.alpha2 * self.scales.get("lin", 1.0)
                / base.cluster.n_devices)

    def t_b_per_token(self, base: CostModel) -> float:
        return BWD_MULT * self.t_f_per_token(base)

    def t_w_per_token(self, base: CostModel) -> float:
        from repro_torch.core.schedule import WGRAD_FRACTION
        return WGRAD_FRACTION * self.t_b_per_token(base)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"version": self.version, "scales": dict(self.scales),
                "comm_scales": dict(self.comm_scales),
                "stage_slowdowns": (list(self.stage_slowdowns)
                                    if self.stage_slowdowns else None),
                "fingerprint": self.fingerprint,
                "n_samples": self.n_samples,
                "residual_rel_rms": round(self.residual_rel_rms, 6),
                "created_step": self.created_step}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CostCalibration":
        return cls(version=int(d.get("version", 0)),
                   scales={k: float(v)
                           for k, v in d.get("scales", {}).items()},
                   comm_scales={k: float(v)
                                for k, v in d.get("comm_scales", {}).items()},
                   stage_slowdowns=d.get("stage_slowdowns"),
                   fingerprint=d.get("fingerprint", ""),
                   n_samples=int(d.get("n_samples", 0)),
                   residual_rel_rms=float(d.get("residual_rel_rms", 0.0)),
                   created_step=int(d.get("created_step", -1)))


# ---------------------------------------------------------------------------
# Robust fit.
# ---------------------------------------------------------------------------

def fit_calibration(samples: Sequence[StepSample], *,
                    probes: Optional[Sequence[Sequence[float]]] = None,
                    d_p: int = 0,
                    huber_delta: float = 1.345, ridge: float = 1e-4,
                    iters: int = 8, fingerprint: str = "",
                    version: int = 1, prior: Optional[CostCalibration] = None,
                    created_step: int = -1) -> CostCalibration:
    """Huber-IRLS fit of per-component scales on relative (y-normalized)
    rows. Columns with no usable signal keep scale 1.0; fitted scales are
    ridge-pulled toward the best common multiplier (so an overall unit
    conversion is free) and clipped so one wild outlier window can never
    invert the model.
    ``probes`` (per-stage second vectors) additionally fit stage slowdowns.
    ``prior`` (the currently-active calibration): the refit is returned
    only if it explains this window meaningfully better than the prior —
    an under-determined window (all rows one length regime) must not churn
    a split that was identified from a richer one.
    """
    samples = [s for s in samples if s.measured_s > 0]
    if not samples:
        raise ValueError("fit_calibration needs at least one sample")
    slow = None
    if probes and d_p:
        slow = fit_stage_slowdowns(probes, d_p)
    elif prior is not None:
        # no probes this window: stage health is unobservable here, so the
        # prior's view is still the best knowledge (a recovered straggler
        # is re-measured as healthy the next time probes run)
        slow = prior.stage_slowdowns
    policies = sorted({s.sp_policy for s in samples
                       if s.components.get("comm", 0.0) > 0})
    cols = list(COMPONENTS[:4]) + [f"comm[{p}]" for p in policies]
    A = np.zeros((len(samples), len(cols)))
    for i, s in enumerate(samples):
        for j, c in enumerate(COMPONENTS[:4]):
            A[i, j] = s.components.get(c, 0.0)
        if s.components.get("comm", 0.0) > 0:
            A[i, cols.index(f"comm[{s.sp_policy}]")] = s.components["comm"]
    # anchor each row to the base simulator's makespan (see StepSample
    # .predicted_s): components become makespan SHARES, so scales == 1
    # reproduces the base prediction exactly and a calibration fitted from
    # a drift-free window is the identity — not a mix-dependent rotation
    for i, s in enumerate(samples):
        tot = float(A[i].sum())
        if s.predicted_s > 0 and tot > 0:
            A[i] *= s.predicted_s / tot
    if slow is not None:
        # the simulator already models stragglers explicitly: inflate the
        # COMPUTE columns by the fitted slowdown (a pipeline's steady state
        # runs at the slowest stage's rate) so the regression does not
        # re-absorb the straggler into the coefficient scales — apply()
        # would then double-count it
        A[:, :4] *= max(slow)
    y = np.array([s.measured_s for s in samples])
    # relative regression: scale every row by its measurement
    Ar = A / y[:, None]
    # a column is fittable when it carries a non-trivial share of the
    # prediction *relative to the largest component* — the absolute scale of
    # model units vs wall seconds is exactly what the fit has to absorb, so
    # the threshold must be scale-free; frozen columns stay at scale 1.0
    col_max = Ar.max(axis=0)
    active = col_max > 1e-3 * max(float(col_max.max()), 1e-30)
    theta = np.ones(len(cols))
    # direct comm probes (collective timings) pin the comm scale per
    # policy EXACTLY — those columns leave the regression, which then only
    # splits what probes cannot see. Ratios divide by the matrix column
    # (renormalized units), not the raw work component
    for p in policies:
        j = cols.index(f"comm[{p}]")
        ratios = [s.comm_s / A[i, j] for i, s in enumerate(samples)
                  if s.sp_policy == p and s.comm_s > 0 and A[i, j] > 0]
        if ratios:
            # median of the most RECENT probes: bandwidth is the term that
            # genuinely shifts regime (contention), so a full-window median
            # would let the stale regime outvote the current one
            # wide absolute bounds: the ratio carries the model-units →
            # wall-seconds conversion, which is legitimately huge on real
            # hardware; the RELATIVE split clip below is the safety rail
            theta[j] = float(np.clip(np.median(ratios[-5:]), 1e-9, 1e9))
            active[j] = False
    if active.any():
        Aa = Ar[:, active]
        resid_target = 1.0 - Ar[:, ~active] @ theta[~active]
        # the ridge pulls toward the best COMMON multiplier theta0, not
        # toward 1.0: an overall unit conversion (model units vs wall
        # seconds) must be absorbed freely — regularization should only
        # shape the SPLIT between components
        rowsum = Aa.sum(axis=1)
        denom = float(rowsum @ rowsum)
        theta0 = float(rowsum @ resid_target) / denom if denom > 0 else 1.0
        theta0 = float(np.clip(theta0, 1e-9, 1e9))
        w = np.ones(len(samples))
        k = int(active.sum())
        # identifiability: the SPLIT between components is fittable only
        # along directions where the window's compositions actually vary. A
        # window of near-identical mixes is nearly rank-1 — the data pins
        # the common level and NOTHING else, and an unrestricted solve
        # would rotate collinear columns against each other until the
        # planner's trade-offs invert, faking bucket wins out of noise. So
        # the fit is RESTRICTED to the identified subspace (singular value
        # >= 10% of the leading one); the orthogonal complement is frozen
        # at the common multiplier theta0.
        U, sv, Vt = np.linalg.svd(Aa, full_matrices=False)
        keep = sv >= 0.1 * sv[0] if sv.size else np.zeros(0, bool)
        th = np.full(k, theta0)
        if keep.any():
            V = Vt[keep].T                       # (k, r) identified basis
            B = Aa @ V                           # (n, r)
            t2 = resid_target - theta0 * rowsum  # fit the residual split
            lam = ridge * max(1.0, len(samples))
            z0 = np.zeros(V.shape[1])
            for _ in range(max(1, iters)):
                Bw = B * w[:, None]
                lhs = B.T @ Bw + lam * np.eye(B.shape[1])
                z0 = np.linalg.solve(lhs, B.T @ (w * t2))
                r = B @ z0 - t2
                mad = np.median(np.abs(r - np.median(r)))
                sc = max(1.4826 * mad, 1e-9)
                zz = np.abs(r) / sc
                w = np.where(zz <= huber_delta, 1.0,
                             huber_delta / np.maximum(zz, 1e-12))
            th = theta0 + V @ z0
        # the fit absorbs the model-units → wall-seconds conversion through
        # theta0, so the COMMON level can be orders of magnitude — but the
        # RELATIVE split between regression-fitted terms is physically
        # bounded (coefficient drift is 1.x–3x, not 100x; regime-sized
        # shifts like a bandwidth collapse enter via probes, which bypass
        # this clip). An unbounded split lets two collinear columns rotate
        # against each other and invert the planner's trade-offs.
        theta[active] = np.clip(th, theta0 / 3.0, theta0 * 3.0)
    resid = Ar @ theta - 1.0
    rms = float(np.sqrt(np.mean(resid ** 2))) if len(resid) else 0.0
    scales = {c: float(theta[j]) for j, c in enumerate(COMPONENTS[:4])}
    comm_scales = {p: float(theta[cols.index(f"comm[{p}]")])
                   for p in policies}
    scales["comm"] = (float(np.mean(list(comm_scales.values())))
                      if comm_scales else 1.0)
    cal = CostCalibration(version=version, scales=scales,
                          comm_scales=comm_scales, stage_slowdowns=slow,
                          fingerprint=fingerprint, n_samples=len(samples),
                          residual_rel_rms=rms, created_step=created_step)
    if prior is not None:
        # score the PRIOR's theta on this exact window; keep the prior's
        # compute/comm split (refreshing probed terms) unless the refit is
        # a clear improvement — a one-regime window cannot identify the
        # split and would otherwise churn it every trigger
        th_p = np.array([prior.scales.get(c, 1.0) for c in COMPONENTS[:4]]
                        + [prior.comm_scales.get(p, prior.scales.get("comm", 1.0))
                           for p in policies])
        for p in policies:           # probed comm is current-regime truth
            j = cols.index(f"comm[{p}]")
            if not active[j]:
                th_p[j] = theta[j]
        r_p = Ar @ th_p - 1.0
        rms_p = float(np.sqrt(np.mean(r_p ** 2)))
        if rms >= 0.9 * rms_p:
            cal = CostCalibration(
                version=version,
                scales={c: float(th_p[j])
                        for j, c in enumerate(COMPONENTS[:4])}
                | {"comm": (float(np.mean([th_p[cols.index(f"comm[{p}]")]
                                           for p in policies]))
                            if policies else prior.scales.get("comm", 1.0))},
                comm_scales={p: float(th_p[cols.index(f"comm[{p}]")])
                             for p in policies},
                stage_slowdowns=slow, fingerprint=fingerprint,
                n_samples=len(samples), residual_rel_rms=rms_p,
                created_step=created_step)
    if prior is not None and prior.comm_scales:
        # SP policies not exercised in THIS window (e.g. every post-swap
        # plan is sp=none, so no collective ran) are unobservable here —
        # carry the prior's pricing forward instead of silently resetting
        # it to 1.0, which would let the very next re-solve flip straight
        # back into the collapsed fabric
        missing = {pol: v for pol, v in prior.comm_scales.items()
                   if pol not in cal.comm_scales}
        if missing:
            cal.comm_scales = {**cal.comm_scales, **missing}
            cal.scales["comm"] = float(
                np.mean(list(cal.comm_scales.values())))
    return cal


def fit_stage_slowdowns(probes: Sequence[Sequence[float]], d_p: int,
                        threshold: float = SLOWDOWN_THRESHOLD
                        ) -> Optional[List[float]]:
    """Per-stage slowdown multipliers from probe vectors: each probe is
    normalized by its median stage time, averaged across probes, and stages
    under ``threshold`` snap to exactly 1.0 (no phantom stragglers from
    probe jitter). Returns None when no stage is slow."""
    rows = [list(map(float, p)) for p in probes if len(p) == d_p]
    if not rows:
        return None
    arr = np.asarray(rows)
    med = np.median(arr, axis=1, keepdims=True)
    med = np.where(med <= 0, 1.0, med)
    rel = (arr / med).mean(axis=0)
    slow = [float(r) if r >= threshold else 1.0 for r in rel]
    return slow if any(s > 1.0 for s in slow) else None


# ---------------------------------------------------------------------------
# Drift detection.
# ---------------------------------------------------------------------------

@dataclass
class Cusum:
    """Two-sided CUSUM on relative residuals r = (measured - predicted) /
    predicted. ``k`` is the slack (residual drift smaller than k never
    accumulates), ``h`` the decision threshold in the same units."""
    k: float = 0.05
    h: float = 0.5
    pos: float = 0.0
    neg: float = 0.0

    def update(self, r: float) -> bool:
        if not math.isfinite(r):
            return False
        self.pos = max(0.0, self.pos + r - self.k)
        self.neg = max(0.0, self.neg - r - self.k)
        return self.drifted

    @property
    def drifted(self) -> bool:
        return self.pos > self.h or self.neg > self.h

    def reset(self) -> None:
        self.pos = self.neg = 0.0

    def state(self) -> Dict[str, float]:
        return {"pos": round(self.pos, 4), "neg": round(self.neg, 4),
                "k": self.k, "h": self.h}


@dataclass
class MixTracker:
    """Length-mix shift detector: fast vs slow EMA of the batch's mean and
    p95 sequence length. A shift fires when the fast view departs from the
    slow view by ``rel`` on either statistic."""
    rel: float = 0.3
    fast: float = 0.5
    slow: float = 0.05
    warmup: int = 3
    _n: int = 0
    _fast_mean: float = 0.0
    _slow_mean: float = 0.0
    _fast_p95: float = 0.0
    _slow_p95: float = 0.0

    def update(self, lengths: Sequence[int]) -> bool:
        if not len(lengths):
            return False
        mean = float(np.mean(lengths))
        p95 = float(np.percentile(lengths, 95))
        self._n += 1
        if self._n == 1:
            self._fast_mean = self._slow_mean = mean
            self._fast_p95 = self._slow_p95 = p95
            return False
        self._fast_mean = self.fast * mean + (1 - self.fast) * self._fast_mean
        self._slow_mean = self.slow * mean + (1 - self.slow) * self._slow_mean
        self._fast_p95 = self.fast * p95 + (1 - self.fast) * self._fast_p95
        self._slow_p95 = self.slow * p95 + (1 - self.slow) * self._slow_p95
        if self._n <= self.warmup:
            return False
        return self.shifted

    @property
    def shifted(self) -> bool:
        def rel(f, s):
            return abs(f - s) / max(abs(s), 1e-9)
        return (rel(self._fast_mean, self._slow_mean) > self.rel
                or rel(self._fast_p95, self._slow_p95) > self.rel)

    def settle(self) -> None:
        """Adopt the fast view as the new normal (called after a re-solve
        so one shift triggers one re-plan, not one per step)."""
        self._slow_mean = self._fast_mean
        self._slow_p95 = self._fast_p95

    def state(self) -> Dict[str, float]:
        return {"fast_mean": round(self._fast_mean, 1),
                "slow_mean": round(self._slow_mean, 1),
                "fast_p95": round(self._fast_p95, 1),
                "slow_p95": round(self._slow_p95, 1)}
