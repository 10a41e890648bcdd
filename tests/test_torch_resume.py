"""Resume, journal replay and elastic re-staging of the port's training
loop (``repro_torch.launch.{train,elastic}``) on the CPU, float32:

* 4 uninterrupted steps equal 2 steps, a checkpoint, a new trainer
  restored from it, and 2 more steps, bit for bit (losses and the final
  parameters, master, moments and step): reduced gemma3-1b at 1x1, 2x1 and
  2x1 interleaved, reduced seamless-m4t-v2 at 2x1 (``enc_layers``). A
  restore that keeps the new trainer's own master (from the parameters)
  and zero moments — the planted fault — misses;
* ``--replan observe`` trains as ``--replan off``, bit for bit, and a
  ``--plan-journal`` replay of an ``auto`` run with an injected straggler
  runs its plans and gives its losses, bit for bit;
* the elastic launcher's three phases (2x1 -> 1x1 -> 2x1): each restore,
  re-staged, equals the state saved, the loss continues, and the
  re-planning triggers are the reference's;
* against the JAX trainer: its checkpoint of step 1 (read with its
  ``CheckpointManager``, bridged through ``weights.from_jax``, saved with
  the port's) resumes the port to the JAX run's steps 2-3: losses ``rtol
  1e-5``, final parameters ``atol 1e-6``. The JAX loop's own resume runs
  step 0's batch again at its first step (``ROADMAP.md`` §3, reference
  caveats): the port is held to the JAX run's uninterrupted steps 2-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.core import ClusterSpec as JCluster
from repro.models import DecoderLM as JLM
from repro_torch.ckpt import CheckpointManager, named_leaves
from repro_torch.configs import get_arch
from repro_torch.core import ClusterSpec
from repro_torch.launch import elastic
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models.model import tree_leaves, unstack_layers
from repro_torch.optim import init_opt_state
from repro_torch.weights import OPT_KEYS, from_jax

from test_torch_threads import torch_thread_share  # noqa: F401

CPU = torch.device("cpu")
QUIET = dict(log=lambda *a: None)


def _host_state(trainer):
    return [(n, x.detach().clone() if isinstance(x, torch.Tensor) else x)
            for n, x in named_leaves(trainer.state_tree())]


def _same_state(a, b):
    assert [n for n, _ in a] == [n for n, _ in b]
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for (_, x), (_, y) in zip(a, b))


RESUME_CASES = {
    "gemma3-1b 1x1": ("gemma3-1b", dict(d_p=1)),
    "gemma3-1b 2x1": ("gemma3-1b", dict(d_p=2, schedule="zero-bubble-h1")),
    "gemma3-1b 2x1 interleaved": ("gemma3-1b", dict(
        d_p=2, schedule="interleaved-1f1b", v_stages=2)),
    "seamless-m4t-v2 2x1": ("seamless-m4t-v2", dict(d_p=2,
                                                    schedule="gpipe-1f1b")),
}


def _resume_runs(case, tmp_path, fault=False):
    arch, kw = RESUME_CASES[case]
    cfg = get_arch(arch).reduced(n_layers=2 if arch == "seamless-m4t-v2"
                                 else 4)
    loop = dict(global_batch=4, context=256, compute_dtype="float32",
                seed=0, **kw)
    full, hist = train(cfg, TrainConfig(steps=4, **loop), device=CPU,
                       **QUIET)
    want = _host_state(full)
    del full
    ck = dict(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2)
    first, h1 = train(cfg, TrainConfig(steps=2, **ck, **loop), device=CPU,
                      **QUIET)
    saved = _host_state(first)
    del first
    restored = []

    def on_resume(tr, step):
        restored.append((step, _host_state(tr)))
        if fault:
            # the new trainer's own AdamW state: master from the bf16 or
            # float32 live parameters, zero moments
            tr.opt = (init_opt_state(tr.params) if not isinstance(
                tr.opt, list) else [init_opt_state(sp) for sp in tr.params])
    second, h2 = train(cfg, TrainConfig(steps=4, resume=True, **ck, **loop),
                       device=CPU, on_resume=on_resume, **QUIET)
    return hist, want, h1, saved, restored, h2, _host_state(second)


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_is_bitwise(case, tmp_path):
    hist, want, h1, saved, restored, h2, got = _resume_runs(case, tmp_path)
    assert [r[0] for r in restored] == [2]
    assert _same_state(restored[0][1], saved)
    assert [h["step"] for h in h2] == [2, 3]
    assert [h["loss"] for h in h1 + h2] == [h["loss"] for h in hist]
    assert _same_state(got, want)
    assert h2[-1]["checkpoint"]["step"] == 3


def test_fresh_moments_fail_the_resume_gate(tmp_path):
    """The planted fault: restoring the parameters alone (the trainer
    re-derives master and zeroes the moments) passes a loss-continuity
    check but not the bitwise gate."""
    hist, want, h1, saved, restored, h2, got = _resume_runs(
        "gemma3-1b 1x1", tmp_path, fault=True)
    assert abs(h2[0]["loss"] - hist[2]["loss"]) / hist[2]["loss"] < 0.25
    assert not _same_state(got, want)


# ---------------------------------------------------------------------------
# the plan journal and the re-planning modes

def test_observe_is_off_and_a_replay_is_its_run(tmp_path):
    cfg = get_arch("gemma3-1b").reduced(n_layers=4)
    base = dict(steps=6, global_batch=4, context=256,
                compute_dtype="float32", d_p=2, schedule="zero-bubble-h1")
    runs = {}
    for name, kw in (
            ("off", {}),
            ("observe", dict(replan="observe", replan_min_samples=2,
                             replan_background=False)),
            ("auto", dict(replan="auto", replan_background=False,
                          probe_every=1, inject_straggler="2:2.5@3",
                          replan_min_samples=2, replan_cooldown=2,
                          telemetry_dir=str(tmp_path / "auto"))),
            ("replay", dict(plan_journal=str(tmp_path / "auto" /
                                             "plans.jsonl"),
                            telemetry_dir=str(tmp_path / "replay")))):
        plans = []
        _, hist = train(cfg, TrainConfig(**base, **kw), device=CPU,
                        on_step=lambda s, p, c, tr: plans.append(p.to_json()),
                        **QUIET)
        runs[name] = ([h["loss"] for h in hist], plans, hist[-1])
    assert runs["observe"][0] == runs["off"][0]
    # the same plans (solve_time is the solver's own clock)
    assert [dict(p, solve_time=0) for p in runs["observe"][1]] == \
        [dict(p, solve_time=0) for p in runs["off"][1]]
    assert runs["replay"][0] == runs["auto"][0]
    assert runs["replay"][1] == runs["auto"][1]
    rep = runs["auto"][2]["replan"]
    assert rep["calibration_version"] >= 1
    assert sum(rep["triggers"].values()) >= 1
    assert "replan" not in runs["replay"][2]
    # the injected straggler reached the telemetry: stage 2's probes read
    # 2.5x stage 1's from step 3 on
    from repro_torch.telemetry import read_jsonl
    probes = {e["step"]: e["per_stage_s"] for e in read_jsonl(
        tmp_path / "auto" / "timeline-train.jsonl") if e["kind"] == "probe"}
    assert sorted(probes) == list(range(base["steps"]))
    assert all(abs(b / a - (2.5 if s >= 3 else 1.0)) < 1e-4
               for s, (a, b) in probes.items())


def test_a_replay_runs_only_journaled_steps(tmp_path):
    """A resumed run's journal (steps 2-3) replays under the same resume;
    a replay that reaches a step the journal lacks, past its end or before
    its start, raises instead of running another step's plan."""
    import shutil
    cfg = get_arch("gemma3-1b").reduced(n_layers=2)
    loop = dict(global_batch=2, context=256, compute_dtype="float32",
                ckpt_every=2)
    ck = {n: str(tmp_path / n) for n in ("run", "replay", "past")}
    train(cfg, TrainConfig(steps=2, ckpt_dir=ck["run"], **loop), device=CPU,
          **QUIET)
    for n in ("replay", "past"):
        shutil.copytree(ck["run"], ck[n])
    _, run = train(cfg, TrainConfig(steps=4, resume=True, ckpt_dir=ck["run"],
                                    telemetry_dir=str(tmp_path / "t"),
                                    **loop), device=CPU, **QUIET)
    journal = str(tmp_path / "t" / "plans.jsonl")
    _, replay = train(cfg, TrainConfig(steps=4, resume=True,
                                       ckpt_dir=ck["replay"],
                                       plan_journal=journal, **loop),
                      device=CPU, **QUIET)
    assert [h["step"] for h in replay] == [2, 3]
    assert [h["loss"] for h in replay] == [h["loss"] for h in run]
    with pytest.raises(ValueError, match="no plan for step 4 .*steps 2-3"):
        train(cfg, TrainConfig(steps=5, resume=True, ckpt_dir=ck["past"],
                               plan_journal=journal, **loop), device=CPU,
              **QUIET)
    with pytest.raises(ValueError, match="no plan for step 0 "):
        train(cfg, TrainConfig(steps=4, plan_journal=journal, **loop),
              device=CPU, **QUIET)


# ---------------------------------------------------------------------------
# elastic shrink and grow

def test_elastic_phases_restage_bit_for_bit(tmp_path):
    cfg = get_arch("gemma3-1b").reduced(n_layers=4)
    done, checks = {}, []

    def on_done(phase, tr):
        done[phase] = _host_state(tr)

    def on_resume(phase, tr, step):
        prev = {"shrink": "phase 1", "grow": "shrink"}[phase]
        checks.append((phase, step, _same_state(_host_state(tr),
                                                done[prev])))
    hists = elastic.run(cfg, tmp_path, device=CPU, steps=2,
                        replan="observe", global_batch=4, context=256,
                        compute_dtype="float32", on_resume=on_resume,
                        on_done=on_done, **QUIET)
    assert checks == [("shrink", 2, True), ("grow", 4, True)]
    assert [[h["step"] for h in hists[p]] for p in hists] == [[0, 1], [2, 3],
                                                            [4, 5]]
    assert "elastic" in hists["shrink"][-1]["replan"]["triggers"]
    assert "elastic" not in hists["grow"][-1]["replan"]["triggers"]


def test_elastic_refuses_a_scrambled_restore():
    with pytest.raises(AssertionError, match="loss discontinuity"):
        elastic._assert_loss_continuity([{"step": 1, "loss": 2.0}],
                                        [{"step": 2, "loss": 6.0}], "shrink",
                                        **QUIET)
    with pytest.raises(AssertionError, match="never ran step 4"):
        elastic._assert_loss_continuity([{"step": 1, "loss": 2.0}],
                                        [{"step": 5, "loss": 2.0}], "grow",
                                        **QUIET)


# ---------------------------------------------------------------------------
# against the JAX trainer

def _jax_state(cfg, params, opt):
    """The JAX trainer's (params, opt) -> the port's checkpoint tree."""
    tree = {"params": params, **{k: opt[k] for k in OPT_KEYS}}
    out = {k: unstack_layers(from_jax(cfg, jax.tree.map(np.asarray, v),
                                      device=CPU))
           for k, v in tree.items()}
    out["step"] = int(opt["step"])
    return out


def test_resume_from_a_jax_checkpoint_matches_the_jax_trainer(tmp_path):
    from repro.ckpt import CheckpointManager as JManager
    from repro.launch.train import TrainLoopConfig
    from repro.launch.train import train as jtrain
    arch, seed = "gemma3-1b", 0
    jcfg, cfg = jget(arch).reduced(), get_arch(arch).reduced()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    loop = dict(global_batch=4, context=256, dataset="github", seed=seed)
    jdir = str(tmp_path / "jax")
    jkw = dict(compute_dtype="float32", lint="off", cache_dir="",
               ckpt_dir=jdir, ckpt_every=2)
    jparams, jopt, jhist = jtrain(jcfg, mesh, TrainLoopConfig(
        steps=4, **loop, **jkw), log=lambda *a: None)
    # the JAX checkpoint of step 1, read with the JAX manager
    (p1, o1), extra = JManager(jdir).restore((jparams, jopt), step=1)
    assert extra["step"] == 1 and int(o1["step"]) == 2
    state = _jax_state(cfg, p1, o1)
    pdir = tmp_path / "port"
    pmgr = CheckpointManager(pdir)
    pmgr.save(1, state, extra=extra)
    pmgr.wait()

    jcl = JCluster(d_p=1, d_s=1)
    cluster = ClusterSpec(d_p=1, d_s=1, flops_per_chip=jcl.flops_per_chip,
                          hbm_bytes=jcl.hbm_bytes, hbm_bw=jcl.hbm_bw,
                          link_bw=jcl.ici_bw, net_bw=jcl.dcn_bw)
    raw = jax.tree.map(np.asarray,
                       JLM(jcfg).init(jax.random.PRNGKey(seed), jnp.float32))
    restored = []
    trainer, hist = train(
        cfg, TrainConfig(steps=4, **loop, compute_dtype="float32",
                         ckpt_dir=str(pdir), ckpt_every=2, resume=True),
        device=CPU, params=from_jax(cfg, raw, device=CPU), cluster=cluster,
        on_resume=lambda tr, step: restored.append(step), **QUIET)
    assert restored == [2] and [h["step"] for h in hist] == [2, 3]
    assert [h["tokens"] for h in hist] == [h["tokens"] for h in jhist[2:]]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist[2:]], rtol=1e-5)
    want = unstack_layers(from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                   device=CPU))
    for a, b in zip(tree_leaves(trainer.params), tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-6,
                                   rtol=0)

    # the reference caveat: the JAX loop's resume from step 1 runs step 0's
    # batch at its first step (step 2), where its uninterrupted run ran
    # step 2's
    import shutil
    jres_dir = tmp_path / "jax_resume"
    shutil.copytree(tmp_path / "jax" / "step_00000001",
                    jres_dir / "step_00000001")
    _, _, jres = jtrain(jcfg, mesh, TrainLoopConfig(
        steps=3, resume=True, **loop, **dict(jkw, ckpt_dir=str(jres_dir),
                                             ckpt_every=100)),
        log=lambda *a: None)
    assert [h["step"] for h in jres] == [2]
    assert jres[0]["tokens"] == jhist[0]["tokens"] != jhist[2]["tokens"]


@pytest.fixture(autouse=True)
def one_thread():
    """The CPU embedding backward is not bitwise across thread counts or
    runs with several threads: the bitwise gates run on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
