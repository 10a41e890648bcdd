"""Port parity of the trainer's telemetry: ``repro_torch.telemetry`` and
``repro_torch.ft`` against the JAX package's ``telemetry`` and ``ft`` on
the same seeded inputs (the scenarios of ``tests/test_telemetry.py`` and
the straggler test of ``tests/test_substrates.py``):

* the timeline's counters, per-bucket EMAs, events and spill (a spill that
  fails never raises);
* atomic stats writes, the torn-tail JSONL read, a writer killed mid-dump;
* the calibration fit: each scenario's ``to_dict``, ``deltas``, the
  recovered per-token times and the calibrated cost model, to 1e-12;
* the drift detectors' flags (``Cusum``, ``MixTracker``);
* the straggler injector's vectors and the monitor's slowdowns.

Plans come from each package's own planner on the same lengths (their JSON
is compared too: ``tests/test_torch_planner.py`` holds the planners equal).
"""

import dataclasses
import math
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from repro.core import PlannerConfig as JConfig
from repro.core import plan_batch as jplan
from repro.ft import StragglerInjector as JInjector
from repro.ft import StragglerMonitor as JMonitor
from repro import telemetry as jt
from repro_torch import telemetry as tt
from repro_torch.core import ClusterSpec, CostModel, ModelSpec, \
    PlannerConfig, plan_batch
from repro_torch.ft import StragglerInjector, StragglerMonitor

from test_torch_threads import torch_thread_share  # noqa: F401


def port_cost_model(jcm):
    """The port's CostModel for the JAX one (its specs copied field by
    field; the JAX cluster's ``ici_bw``/``dcn_bw`` are ``link_bw``/
    ``net_bw``)."""
    cl = dataclasses.asdict(jcm.cluster)
    cl["link_bw"], cl["net_bw"] = cl.pop("ici_bw"), cl.pop("dcn_bw")
    return CostModel(ModelSpec(**dataclasses.asdict(jcm.model)),
                     ClusterSpec(**cl))


def close(a, b, rel=1e-12, path="") -> None:
    """``a == b`` with floats to ``rel`` relative (nested dicts, lists)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            close(a[k], b[k], rel, f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, rel, f"{path}/{i}")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rel, abs_tol=1e-300), (path, a, b)
    else:
        assert a == b, (path, a, b)


def plan_json(plan):
    d = plan.to_json()
    d.pop("solve_time")
    return d


def sample_plans(jcm, cm, n, seed=0, batch=8):
    """``n`` (lengths, JAX plan, port plan) triples from the same draws."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = [int(x) for x in np.clip(rng.lognormal(8, 1, size=batch),
                                           256, 32768)]
        jp, tp = jplan(jcm, lengths, JConfig()), plan_batch(cm, lengths,
                                                            PlannerConfig())
        assert plan_json(tp) == plan_json(jp)
        out.append((lengths, jp, tp))
    return out


# ---------------------------------------------------------------------------
# StepTimeline and the stats I/O
# ---------------------------------------------------------------------------

def _ticks():
    t = iter(range(10 ** 6))
    return lambda: float(next(t))


def _timeline_run(mod, case, spill):
    tl = mod.StepTimeline(capacity=4 if case != "ema" else 16,
                          spill_dir=spill, clock=_ticks())
    if case == "ring":
        for i in range(10):
            tl.record("step", i, wall_s=0.1)
    elif case == "ema":
        tl.record_step(0, "bkA", 1.0, tokens=10, loss=2.0, probed=False)
        tl.record_step(1, "bkA", 2.0, tokens=10, loss=2.0,
                       per_stage_s=[0.5, 1.5], probed=True)
        tl.record_step(2, "bkB", 0.7, tokens=4, probed=False)
        tl.record_step(3, "bkA", 1.2, tokens=10, per_stage_s=[0.6, 0.6],
                       probed=True)
    elif case == "spill_failure":
        tl._spill.close()                 # sabotage the spill file
        tl.record("step", 0, wall_s=0.1)  # must not raise
        tl.record_step(1, "bk", 0.5)
    snap = tl.snapshot()
    snap.pop("spill")
    out = {"snapshot": snap, "ema": [tl.ema(b) for b in ("bkA", "bkB")],
           "events": [dict(e) for e in tl.events()],
           "probes": [dict(e) for e in tl.events("probe")]}
    tl.close()
    if spill:
        out["spilled"] = list(mod.read_jsonl(
            os.path.join(spill, "timeline-train.jsonl")))
    return out


@pytest.mark.parametrize("case", ["ring", "ema", "spill_failure"])
def test_timeline_equals_jax(case, tmp_path):
    spill = case != "ring"
    got = _timeline_run(tt, case, str(tmp_path / "port") if spill else None)
    want = _timeline_run(jt, case, str(tmp_path / "jax") if spill else None)
    close(got, want)
    if case == "ring":
        assert got["snapshot"]["by_kind"]["step"] == 10
        assert [e["step"] for e in got["events"]] == [6, 7, 8, 9]
    if case == "spill_failure":
        assert got["snapshot"]["dropped_spill_writes"] == 2


@pytest.mark.parametrize("case", ["atomic", "torn_tail"])
def test_stats_io_equals_jax(case, tmp_path):
    outs = []
    for mod in (tt, jt):
        d = tmp_path / mod.__name__
        d.mkdir()
        if case == "atomic":
            p = d / "stats.json"
            mod.atomic_write_json(p, {"a": 1})
            mod.atomic_write_json(p, {"a": 2, "b": [1.5]})
            outs.append((mod.read_json(p), mod.read_json(d / "none", 7),
                         sorted(os.listdir(d))))
        else:
            p = d / "log.jsonl"
            p.write_text('{"step": 0}\n\n{"step": 1}\nnot json\n'
                         '{"step": 2, "x": ')
            outs.append((list(mod.read_jsonl(p)),
                         list(mod.read_jsonl(d / "absent.jsonl"))))
    assert outs[0] == outs[1]


def test_atomic_write_survives_writer_kill(tmp_path):
    """The port's writer killed mid-dump: the reader sees a complete
    generation, never a torn file (the JAX test's scenario)."""
    target = tmp_path / "stats.json"
    tt.atomic_write_json(target, {"generation": 0, "payload": "x" * 64})
    prog = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.join(os.path.dirname(__file__), "..",
                                         "src")!r})
        from repro_torch.telemetry import atomic_write_json
        payload = "y" * (1 << 20)
        i = 1
        print("ready", flush=True)
        while True:
            atomic_write_json({str(target)!r},
                              {{"generation": i, "payload": payload}})
            i += 1
    """)
    proc = subprocess.Popen([sys.executable, "-c", prog],
                            stdout=subprocess.PIPE)
    try:
        proc.stdout.readline()
        time.sleep(0.2)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    data = tt.read_json(target)
    assert data is not None, "reader saw a torn stats file"
    assert len(data["payload"]) in (64, 1 << 20)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

TRUE_SCALES = {"round_trip": {"quad": 1.5, "lin": 0.8, "over": 1.0,
                              "rec": 1.0, "comm": 1.3},
               "outliers": {"quad": 1.2, "lin": 1.0, "over": 1.0, "rec": 1.0,
                            "comm": 1.0}}


def _samples(mod, cm, plans, case, pick):
    """The scenario's StepSamples under ``mod`` (``pick``: which plan of
    each triple)."""
    rng = np.random.default_rng({"round_trip": 1, "unit": 2, "outliers": 3,
                                 "apply": 4, "prior": 5}[case])
    out = []
    for i, triple in enumerate(plans):
        plan = triple[pick]
        comp = mod.plan_components(cm, plan)
        if case in TRUE_SCALES:
            t = sum(TRUE_SCALES[case][k] * v for k, v in comp.items())
            if case == "outliers" and i in (4, 11):
                t *= 5.0
        elif case == "unit":
            t = 7.3 * sum(comp.values())
        else:
            t = 1.4 * sum(comp.values())
        noise = 1 + 0.01 * rng.standard_normal()
        pol = plan.sp.policy if plan.sp is not None else "none"
        out.append(mod.StepSample(step=i, measured_s=t * noise,
                                  components=comp, sp_policy=pol,
                                  comm_s=0.3 * comp["comm"] if case == "prior"
                                  else 0.0,
                                  predicted_s=sum(comp.values())
                                  if case == "prior" else 0.0))
    return out


def _fit(mod, cm, plans, case, pick):
    samples = _samples(mod, cm, plans, case, pick)
    d_p = cm.cluster.d_p
    kw = dict(d_p=d_p)
    if case == "apply":
        kw.update(fingerprint="4x4:tiny", version=3)
    if case == "prior":
        first = mod.fit_calibration(samples[:8], d_p=d_p, version=1)
        probes = [[1.0, 1.0, 1.8, 1.0], [1.1, 0.9, 1.9, 1.0]]
        kw.update(prior=first, probes=probes, version=2, created_step=7)
    cal = mod.fit_calibration(samples, **kw)
    back = type(cal).from_dict(cal.to_dict())
    cm2 = back.apply(cm)
    return {"components": [s.components for s in samples],
            "cal": cal.to_dict(), "deltas": cal.deltas(),
            "per_token": [cal.t_f_per_token(cm), cal.t_b_per_token(cm),
                          cal.t_w_per_token(cm)],
            "applied": dict(dataclasses.asdict(cm2.coeffs),
                            recompute_factor=cm2.recompute_factor,
                            slow=cm2.stage_slowdowns),
            "work": [mod.predicted_work(cm, p[pick]) for p in plans[:3]]}


@pytest.mark.parametrize("case", ["round_trip", "unit", "outliers", "apply",
                                  "prior"])
def test_calibration_equals_jax(cost_model, case):
    cm = port_cost_model(cost_model)
    plans = sample_plans(cost_model, cm, 16 if case != "apply" else 8)
    got = _fit(tt, cm, plans, case, 2)
    want = _fit(jt, cost_model, plans, case, 1)
    close(got, want)
    if case == "round_trip":
        assert got["cal"]["residual_rel_rms"] < 0.05
    if case == "unit":
        assert got["cal"]["scales"]["lin"] > 2.0
    if case == "prior":
        assert got["cal"]["stage_slowdowns"][2] > 1.5


def test_stale_mesh_slowdowns_dropped_as_jax(cost_model):
    cm = port_cost_model(cost_model)
    out = []
    for mod, base in ((tt, cm), (jt, cost_model)):
        cal = mod.CostCalibration(version=1, stage_slowdowns=[1.0, 2.0],
                                  fingerprint="2x2:tiny")
        out.append(cal.apply(base).stage_slowdowns)
    assert out == [None, None]


@pytest.mark.parametrize("probes", [
    [[1.0, 1.0, 1.8, 1.0], [1.1, 0.9, 1.9, 1.0]],
    [[1.0, 1.0]],
    [[2.0, 1.0, 1.0, 1.05], [0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0]],
])
def test_stage_slowdowns_equal_jax(probes):
    d_p = len(probes[0])
    got = tt.fit_stage_slowdowns(probes, d_p)
    assert got == jt.fit_stage_slowdowns(probes, d_p)


# ---------------------------------------------------------------------------
# Drift detectors
# ---------------------------------------------------------------------------

def _cusum_flags(mod):
    c = mod.Cusum(k=0.05, h=0.5)
    rng = np.random.default_rng(0)
    flags = [c.update(float(0.02 * rng.standard_normal())) for _ in range(50)]
    flags += [c.update(0.3 + float(0.02 * rng.standard_normal()))
              for _ in range(10)]
    flags.append(c.update(float("nan")))
    state = c.state()
    c.reset()
    return flags, state, c.update(0.0)


def _mix_flags(mod):
    m = mod.MixTracker(rel=0.3)
    rng = np.random.default_rng(0)
    flags = [m.update([int(x) for x in rng.integers(100, 140, 8)])
             for _ in range(10)]
    flags += [m.update([int(x) for x in rng.integers(400, 520, 8)])
              for _ in range(6)]
    state = m.state()
    m.settle()
    return flags, state, m.update([int(x) for x in rng.integers(400, 520, 8)])


@pytest.mark.parametrize("detector", [_cusum_flags, _mix_flags],
                         ids=["cusum", "mix"])
def test_drift_detectors_equal_jax(detector):
    got, want = detector(tt), detector(jt)
    close(got, want)
    assert any(got[0]) and not got[2]


# ---------------------------------------------------------------------------
# Straggler injection and monitoring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,jitter", [("2:2.5@3", 0.05), ("1:1.5,3:2",
                                                             0.0)])
def test_injector_equals_jax(spec, jitter):
    out = []
    for cls in (StragglerInjector, JInjector):
        inj = cls.parse(spec, 4, jitter=jitter, seed=7)
        out.append((inj.factors, inj.start_step,
                    [inj.active(s) for s in range(6)],
                    [inj.per_stage([1.0, 0.5, 1.0, 2.0], s) for s in range(6)],
                    [inj.wall(1.3, s) for s in range(6)]))
    assert out[0] == out[1]


@pytest.mark.parametrize("spec", ["5:2.0", "0:1.5"])
def test_injector_rejects_bad_stage_as_jax(spec):
    for cls in (StragglerInjector, JInjector):
        with pytest.raises(ValueError, match="outside"):
            cls.parse(spec, 4)


def test_straggler_monitor_equals_jax(cost_model):
    cm = port_cost_model(cost_model)
    out = []
    for cls, base in ((StragglerMonitor, cm), (JMonitor, cost_model)):
        from repro.ft import replan_costmodel as jrc
        from repro_torch.ft import replan_costmodel as trc
        rc = trc if cls is StragglerMonitor else jrc
        mon = cls(d_p=4, ewma=0.5)
        seq = [mon.slowdowns()]
        for v in ([1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.9, 1.0],
                  [1.0, 1.0, 2.5, 1.0], [1.0, 1.0, 1.0, 1.0]):
            mon.observe(v)
            seq.append(mon.slowdowns())
        seq.append(rc(base, mon).stage_slowdowns)
        out.append(seq)
    close(out[0], out[1])
    assert out[0][3] is not None and out[0][3][2] > 1.25
