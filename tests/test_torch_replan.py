"""Port parity of the online re-planning controller and the plan lint:
``repro_torch.telemetry.ReplanController`` and ``repro_torch.lint``
against the JAX package's, on the scenarios of ``tests/test_replan.py``
(each package's own planner and cost model on the same lengths and the
same measured times; inline jobs, ``background=False``).

Each scenario's decision sequence must be the JAX controller's: every
trigger, decision (step, reason, decision, old and new bucket, win,
precompiled) and adopted calibration (version, deltas, residual), the
counters and the final calibration (to 1e-12). The plan lint must give
the JAX passes' findings on the same plans, on plans planted with
hazards, and as the controller's lint gate.
"""

import copy
import dataclasses
from dataclasses import replace

import numpy as np
import pytest

import repro.core as jcore
import repro.core.planner as jplanner
import repro.lint as jlint
import repro.telemetry as jt
import repro_torch.core as tcore
import repro_torch.core.planner as tplanner
import repro_torch.lint as tlint
import repro_torch.telemetry as tt

from test_torch_telemetry import close, plan_json, port_cost_model
from test_torch_threads import torch_thread_share  # noqa: F401

D_S = 4
PKGS = {"jax": (jcore, jplanner, jt, jlint), "port": (tcore, tplanner, tt,
                                                       tlint)}


def _lengths(seed, batch=8, lo=256, hi=32768, mu=8.0):
    rng = np.random.default_rng(seed)
    return [int(x) for x in np.clip(rng.lognormal(mu, 1, size=batch), lo, hi)]


class Stack:
    """One package's planner, cost model and controller closures (the
    scenarios' ``_solve``, ``_bucket`` and ``_held`` of
    ``tests/test_replan.py``)."""

    def __init__(self, name, jcm):
        self.core, self.planner, self.tel, self.lint = PKGS[name]
        self.cm = jcm if name == "jax" else port_cost_model(jcm)
        self.plans = []

    def solve(self, cm, lengths):
        plan = self.core.plan_batch(cm, lengths, self.core.PlannerConfig())
        self.plans.append(plan)
        return plan

    def bucket(self, plan):
        return str(plan.bucket_key(D_S))

    def held(self, cm, lengths, inc):
        key = inc.bucket_key(D_S)
        return self.core.plan_batch(cm, lengths, self.core.PlannerConfig(
            token_capacity=key.cap, sp_policy=key.sp_policy,
            sp_degree=key.d_s_eff))

    def estimate(self, cm, plan):
        return self.planner.estimate_plan_time(cm, plan)

    def plan_lint(self, plan):
        rep = self.lint.run_plan_checks(plan, D_S, self.cm.cluster.d_p,
                                        model=self.cm.model)
        return [str(e) for e in rep.errors]

    def controller(self, mode="auto", tmp=None, fingerprint="", **kw):
        cfg = dict(mode=mode, min_samples=3, cooldown_steps=2,
                   background=False)
        cfg.update(kw.pop("cfg", {}))
        self.timeline = self.tel.StepTimeline(clock=lambda: 0.0)
        return self.tel.ReplanController(
            self.cm, self.tel.ReplanConfig(**cfg), self.solve, self.bucket,
            resolve_incumbent=self.held, timeline=self.timeline,
            telemetry_dir=tmp, fingerprint=fingerprint, **kw)


def _drifted(stack, step, drift_at=6):
    """The truth model at ``step``: from ``drift_at`` on, a 16x bandwidth
    collapse and stage 3 at 1.8x (the swap scenario)."""
    cm = stack.cm
    if step < drift_at:
        return cm
    co = replace(cm.coeffs, ag_bw=cm.coeffs.ag_bw / 16,
                 a2a_bw=cm.coeffs.a2a_bw / 16)
    slow = [1.8 if p == 2 else 1.0 for p in range(cm.cluster.d_p)]
    return stack.core.CostModel(cm.model, cm.cluster, co,
                                stage_slowdowns=slow, ce_mode=cm.ce_mode)


def _comm_probe(stack, tr, plan):
    co = replace(tr.coeffs, ag_bw=tr.coeffs.ag_bw * 1e9,
                 a2a_bw=tr.coeffs.a2a_bw * 1e9)
    nocomm = stack.core.CostModel(tr.model, tr.cluster, co,
                                  stage_slowdowns=tr.stage_slowdowns,
                                  ce_mode=tr.ce_mode)
    return max(0.0, stack.estimate(tr, plan) - stack.estimate(nocomm, plan))


def _drive(stack, c, steps, *, truth=None, comm=False, noise=0.01,
           inflate=1.0, forced=(), comm_scale=0.0, lengths_seed=None):
    """Feed ``steps`` steps (measured = the truth model's makespan); returns
    what each step's observe and poll gave."""
    rng = np.random.default_rng(0)
    out = []
    for step in range(steps):
        tr = truth(stack, step) if truth else stack.cm
        lengths = _lengths(lengths_seed if lengths_seed is not None
                           else 100 + step % 3)
        plan = stack.solve(c.cost_model(), lengths)
        wall = stack.estimate(tr, plan) * inflate
        wall *= 1 + noise * rng.standard_normal()
        slow = tr.stage_slowdowns or [1.0] * tr.cluster.d_p
        probes = [wall / len(slow) * s for s in slow]
        comm_s = _comm_probe(stack, tr, plan) if comm else None
        if comm_scale:
            comm_s = stack.tel.plan_components(stack.cm, plan)["comm"] \
                * comm_scale
        if step in forced:
            c.force_replan("test-noise")
        reason = c.observe_step(step, plan, wall, lengths,
                                per_stage_s=probes, comm_s=comm_s)
        dec = c.poll()
        out.append((reason, None if dec is None else
                    (dec.step, dec.reason, dec.decision, dec.old_bucket,
                     dec.new_bucket, dec.win, dec.precompiled,
                     dec.calibration.version if dec.calibration else None)))
    return out


def _record(stack, c, steps_out):
    snap = c.snapshot()
    return {"steps": steps_out, "counters": dict(c.counters),
            "triggers": dict(c.trigger_reasons), "swaps": list(c.swap_steps),
            "version": c.version, "snapshot": snap,
            "events": [dict(e) for e in stack.timeline.events()
                       if e.kind in ("replan", "calibration")],
            "cost_model_is_base": c.cost_model() is stack.cm,
            "plans": [plan_json(p) for p in stack.plans]}


def scenario(name, jcm, case, tmp_path):
    stack = Stack(name, jcm)
    tmp = str(tmp_path / name)
    if case == "swap":
        pre = []
        c = stack.controller(precompile=lambda p: pre.append(stack.bucket(p)))
        out = _record(stack, c, _drive(stack, c, 18, truth=_drifted,
                                       comm=True))
        out["precompiled"] = pre
    elif case == "swap_lint_gate":
        # the same drift with the real plan lint as the gate
        c = stack.controller(lint=stack.plan_lint)
        out = _record(stack, c, _drive(stack, c, 18, truth=_drifted,
                                       comm=True))
    elif case == "hysteresis":
        c = stack.controller(cfg={"min_win": 0.05})
        out = _record(stack, c, _drive(stack, c, 12, noise=0.03,
                                       forced=(6, 9), lengths_seed=100))
    elif case == "lint_reject":
        c = stack.controller(lint=lambda plan: ["E_TEST: synthetic hazard"])
        out = _record(stack, c, _drive(stack, c, 8, noise=0.0, inflate=3.0,
                                       comm_scale=40.0))
    elif case == "observe":
        c = stack.controller(mode="observe")
        out = _record(stack, c, _drive(stack, c, 8, noise=0.0, inflate=2.0))
    elif case in ("persist", "foreign"):
        c = stack.controller(tmp=tmp, fingerprint="4x4:tiny")
        out = _record(stack, c, _drive(stack, c, 6, noise=0.0, inflate=1.7))
        fp = "4x4:tiny" if case == "persist" else "2x4:tiny"
        c2 = stack.controller(tmp=tmp, fingerprint=fp)
        out["warm"] = (c2.version, c2._force, c2.active.to_dict()
                       if c2.active is not None else None)
        out["second"] = _record(stack, c2, _drive(stack, c2, 3, noise=0.0))
    else:
        raise ValueError(case)
    return out


CASES = ["swap", "swap_lint_gate", "hysteresis", "lint_reject", "observe",
         "persist", "foreign"]


@pytest.mark.parametrize("case", CASES)
def test_controller_decisions_equal_jax(cost_model, case, tmp_path):
    got = scenario("port", cost_model, case, tmp_path)
    want = scenario("jax", cost_model, case, tmp_path)
    close(got, want)
    # the scenarios' own outcomes (tests/test_replan.py), on the port
    c = got["counters"]
    if case == "swap":
        assert c["swaps"] >= 1 and got["precompiled"]
        swap = next(s[1] for s in got["steps"] if s[1] and s[1][2] == "swap")
        assert swap[0] >= 6 and swap[3] != swap[4] and swap[6]
    if case == "hysteresis":
        assert c["swaps"] == 0 and c["forced"] == 2
    if case == "lint_reject":
        assert c["swaps"] == 0
        assert c["lint_rejects"] + c["hysteresis_rejects"] >= 1
    if case == "observe":
        assert c["fits"] >= 1 and got["cost_model_is_base"]
    if case == "persist":
        assert got["warm"][0] == got["version"] >= 1
    if case == "foreign":
        assert got["warm"][:2] == (0, "elastic")
        assert got["second"]["steps"][0][0] == "elastic"


# ---------------------------------------------------------------------------
# Plan lint
# ---------------------------------------------------------------------------

def _hazards(plan, core):
    """Copies of ``plan`` planted with hazards the passes must flag."""
    negative = copy.deepcopy(plan)      # a negative remat depth
    negative.remat_mode = "stage_aware"
    negative.pipelines[0].ckpt[0][0] = -1
    fraction = copy.deepcopy(negative)  # a depth that is not an int
    fraction.pipelines[0].ckpt[0][0] = 1.5
    bad_sp = dataclasses.replace(plan, sp=core.SPConfig("ulysses", 3))
    return [negative, fraction, bad_sp]


def _lint_all(name, jcm, d_p_override=None):
    stack = Stack(name, jcm)
    out = []
    for seed in (100, 101, 102, 7):
        plan = stack.solve(stack.cm, _lengths(seed))
        for p in [plan] + _hazards(plan, stack.core):
            for kw in ({}, {"split_bwd": True, "dtype": "float32"}):
                rep = stack.lint.run_plan_checks(
                    p, D_S, d_p_override or stack.cm.cluster.d_p,
                    key_kwargs=kw, model=stack.cm.model)
                out.append({"subject": rep.subject,
                            "passes": list(rep.passes_run),
                            "findings": [f.as_dict() for f in rep.findings],
                            "summary": rep.summary()})
    return out


@pytest.mark.parametrize("d_p", [None, 2])
def test_plan_lint_findings_equal_jax(cost_model, d_p):
    got = _lint_all("port", cost_model, d_p)
    assert got == _lint_all("jax", cost_model, d_p)
    clean = [r for i, r in enumerate(got) if i % 8 < 2]
    planted = [r for i, r in enumerate(got) if i % 8 >= 2]
    if d_p is None:
        assert all(not r["findings"] for r in clean)
    assert all(r["findings"] for r in planted)


def test_lint_error_mode_raises_as_jax(cost_model):
    for name in ("port", "jax"):
        stack = Stack(name, cost_model)
        plan = stack.solve(stack.cm, _lengths(3))
        rep = stack.lint.run_plan_checks(_hazards(plan, stack.core)[0], D_S,
                                         4)
        with pytest.raises(stack.lint.LintError, match="plan-ckpt-table"):
            rep.raise_if_findings()


def test_ppermute_checks_equal_jax():
    perms = [[(0, 1), (1, 2), (2, 3), (3, 0)], [(0, 1), (0, 2)],
             [(0, 5)], [(0, 1), (1, 0)], []]
    for perm in perms:
        for d_p, full in ((4, True), (4, False), (2, True)):
            assert tlint.check_ppermute_perm(perm, d_p, require_full=full) \
                == jlint.check_ppermute_perm(perm, d_p, require_full=full)
