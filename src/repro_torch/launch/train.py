"""Training driver of the port: the planner's chunked step, on one card
or pipelined over ``--mesh PxS`` stages of ``S`` sequence-parallel ranks.

Each step samples a global batch (``data/synth.sample_corpus_batch``),
plans it with the host planner (Alg. 1 chunking, the grouping DP, the
stage-aware checkpointing ILP) for one card (``ClusterSpec``: an H100 with
``d_p = d_s = 1``), and runs the plan through
:class:`repro_torch.runtime.train_step.ChunkedTrainer`: the KV carry
between a sequence's chunks, the dKV hand-off, remat from the plan's
table, attention and the loss in the CUDA kernels, then AdamW.

On the card (the default device), gemma3-1b or hymba-1.5b at full width
in bfloat16:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 3 --batch 8 --context 16384
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --steps 3 --batch 8 --context 16384

A model whose states alone exceed the card (falcon-mamba-7b: 126 GB of
parameters, master, moments and gradient sums on an 80 GB H100; olmoe-1b-7b
at its 16 layers: 125 GB) stops at the planner with its message, before
any parameter is allocated. ``--layers N`` cuts the depth and keeps every
width: olmoe-1b-7b at 4 layers (34 GB of states) trains on one H100:

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
      --layers 4 --steps 3 --batch 8 --context 16384

On the CPU, at a reduced size (float32):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma3-1b --reduced --steps 2 --batch 4 --context 256

``--mesh PxS`` other than ``1x1`` plans for ``P`` pipeline stages of
``S`` sequence-parallel ranks (each rank planned with the memory of its
card divided by the stages on that card and by ``S``) and runs
:class:`repro_torch.runtime.train_step.PipelineTrainer`: stage ``p`` and
its ``S`` ranks on card ``p mod --cards``, the schedule backend the
planner picks for step 0 (or ``--schedule``, ``--v-stages``) pinned for
the run, the zero-bubble split backward as ``--split-bwd`` says. Each
plan carries its SP point ``(policy, d_s_eff)``: the planner's choice, or
``--sp-policy`` / ``--sp-degree`` pinned (the step logs ``[sp]``). At
``S > 1`` each rank owns its ZeRO-3 shards of its stage's parameters,
gradient sums and AdamW state, gathered per layer and chunk (the
reference's default ``per_tick``; ``per_step`` and the pod axis are the
trainer's, as the reference reaches them through ``make_geometry`` and
``TrainStepBuilder``: its CLI has no flag for either). Still
refused: more cards than stages at ``S > 1`` (SP ranks across cards). On
the card,
gemma3-1b on two stages of one H100, and on two stages of two ranks:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --steps 2 --batch 8 --context 16384 --mesh 2x1
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --steps 2 --batch 8 --context 16384 --mesh 2x2

The encoder-decoder seamless-m4t-v2 trains only pipelined (``--mesh PxS``
with ``P >= 2``: ``core.checkpointing.encoder_stage_split`` gives the
leading stages the encoder and the rest the decoder; ``--mesh 1x1`` exits
with its message), planned as the reference's train step plans it (``K =
1``: the encoder is pack-only; one virtual stage; at ``S > 1``
allgather_kv over all ``S`` ranks, each rank a block of a chunk's frames
and tokens: ``runtime/encdec_pipeline.py``), each sequence with as many
frames as tokens from the audio-frame stub; pods through
``TrainConfig(n_pods=N)``. At full width and depth on two stages of one
H100, and on two stages of two ranks:

  PYTHONPATH=src python -m repro_torch.launch.train --arch seamless-m4t-v2 \
      --steps 3 --batch 8 --context 16384 --mesh 2x1 --schedule gpipe-1f1b
  PYTHONPATH=src python -m repro_torch.launch.train --arch seamless-m4t-v2 \
      --steps 2 --batch 8 --context 16384 --mesh 2x2 --schedule gpipe-1f1b

Each step prints one line: loss, valid tokens, wall time, tokens per
second, the card's peak allocated memory and the plan's own peak-memory
estimate; pipelined, also each stage's estimate (and the planner's memory
model on the order the stage ran, ``program.residual_peaks``), each
card's peak, the hand-offs and their bytes, and the schedule's bubble
share
(``core/schedule.ScheduleSpec.bubble_fraction`` on the plan's mean stage
times). ``--profile PATH`` runs the last step under ``torch.profiler``
and writes a JSON summary (device time by kernel group, launches, the
device's busy share of the step). ``--memory-snapshot PATH`` records the
last step's allocation history, writes the snapshot (a pickle that
PyTorch's memory viz reads) and prints what is live at the step's peak
(:func:`repro_torch.runtime.profile.memory_peak_summary`).

The control plane is the JAX trainer's. ``--ckpt-dir D`` saves the
parameters, the AdamW master, moments and step every ``--ckpt-every``
steps (``ckpt/checkpoint.py``: host copy before the next step, files
written in the background, the manifest last); ``--resume`` restores the
latest into the trainer, re-staged for this run's ``--mesh`` (the
checkpoint holds the model's layout: ``weights.state_from_stages``).
``--replan observe|auto`` feeds each step's time (and, every
``--probe-every`` steps, a per-stage vector) to the re-planning
controller (``telemetry/replan.py``), which fits the cost model to the
card; ``--telemetry-dir`` keeps the timeline, the plan journal
``plans.jsonl`` (``--plan-journal`` replays one) and ``calibration.json``;
``--inject-straggler 2:2.5@3`` scales the reported times of stage 2 from
step 3 on; ``--lint`` audits each new bucket's plan (``lint/``). Elastic
shrink and grow through a shared checkpoint: ``launch/elastic.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --steps 4 --batch 8 --context 16384 --ckpt-dir ckpts/g --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --steps 6 --batch 8 --context 16384 --ckpt-dir ckpts/g --resume \
      --mesh 2x1 --replan auto --probe-every 1 --telemetry-dir runs/g
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["TrainConfig", "train", "plan_step", "plan_lengths", "mix_for",
           "corpus_for",
           "main", "BUCKET_ROUNDING", "PlanError", "parse_mesh"]


class PlanError(RuntimeError):
    """The planner finds no plan: the model does not fit the cluster."""


@dataclass
class TrainConfig:
    """The JAX trainer's loop settings that apply on one card."""
    steps: int = 20
    global_batch: int = 16
    context: int = 2048
    dataset: str = "github"
    seed: int = 0
    compute_dtype: str = "bfloat16"
    # "stage-aware": the ILP's per-chunk remat depths; "uniform": the
    # largest depth on every chunk (both as in the JAX trainer)
    ckpt_policy: str = "stage-aware"
    # pipeline stages; the schedule backend and its virtual stages (None
    # and 0: the planner's pick for step 0, then pinned); the zero-bubble
    # split backward: "auto" (the backend's), "on" or "off"
    d_p: int = 1
    # sequence-parallel ranks a stage, and the planner's SP pins: "auto"
    # and 0 let it choose (policy, d_s_eff) per plan
    d_s: int = 1
    sp_policy: str = "auto"
    sp_degree: int = 0
    # ZeRO-3's gather cadence at d_s > 1 ("per_tick", the reference's
    # default, or "per_step"), and data-parallel pods of the pipeline (the
    # plan's pipelines split over them, each pod planned with its share of
    # the card, the gradients summed over them, through the int8 all-reduce
    # with compress_pod_grads): the trainer's API, as the reference reaches
    # them through make_geometry and TrainStepBuilder (no CLI flag)
    zero3_mode: str = "per_tick"
    n_pods: int = 1
    compress_pod_grads: bool = False
    schedule: Optional[str] = None
    v_stages: int = 0
    split_bwd: str = "auto"
    # checkpoints (ckpt/checkpoint.py): saved after every ckpt_every-th
    # step; resume continues from the latest one in ckpt_dir (at any
    # pipeline depth: the saved tree is the model's layout)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    resume: bool = False
    # plan lint (lint/): "warn" logs the findings of every new bucket's
    # plan and of each re-plan candidate, "error" raises on any, "off"
    lint: str = "warn"
    # online re-planning (telemetry/): "off" = the static cost model;
    # "observe" = telemetry, fits and would-be swaps, plans untouched;
    # "auto" = per-step solves under the adopted calibration, swaps at
    # step boundaries (hysteresis, cooldown, lint gate)
    replan: str = "off"
    telemetry_dir: Optional[str] = None  # timeline spill, plans.jsonl,
    #                                      calibration.json
    # every Nth step carries a per-stage vector (wall / d_p each, as the
    # JAX trainer's probes); 0 = none. Every step is timed: the port's
    # step ends in a synchronize
    probe_every: int = 0
    replan_min_win: float = 0.05
    replan_cooldown: int = 8
    replan_min_samples: int = 4
    # re-plan jobs on a background thread; False runs them inline (the
    # swap timing is then deterministic)
    replan_background: bool = True
    # telemetry-only straggler injection "STAGE:FACTOR[,...][@START]"
    # (ft.StragglerInjector): scales the reported times, never the math
    inject_straggler: str = ""
    # from step drift_at on (0 = never), batches come from dataset2 at
    # context2 (0 = context)
    dataset2: Optional[str] = None
    context2: int = 0
    drift_at: int = 0
    # replay the per-step plans of this plans.jsonl instead of solving
    plan_journal: Optional[str] = None


BUCKET_ROUNDING = 256     # chunk-capacity granularity, as the JAX trainer


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"PxS"`` -> ``(P, S)``: ``P`` pipeline stages of ``S``
    sequence-parallel ranks."""
    try:
        p, s = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes PxS, got {text!r}") from None
    if p < 1 or s < 1:
        raise ValueError(f"--mesh {text}: sizes must be >= 1")
    return p, s


def mix_for(loop: TrainConfig, step: int) -> Tuple[str, int]:
    """The length preset and context of step ``step``'s batch (the second
    phase's from ``loop.drift_at`` on)."""
    if loop.drift_at and step >= loop.drift_at and (loop.dataset2
                                                    or loop.context2):
        return loop.dataset2 or loop.dataset, loop.context2 or loop.context
    return loop.dataset, loop.context


def corpus_for(loop: TrainConfig, step: int, vocab: int) -> Dict:
    """Step ``step``'s global batch, as :func:`train` runs it."""
    from repro_torch.data import sample_corpus_batch
    ds, ctx = mix_for(loop, step)
    return sample_corpus_batch(ds, loop.global_batch, ctx, vocab,
                               seed=loop.seed + step)


def plan_lengths(cm, loop: TrainConfig, lengths: Sequence[int], *,
                 schedule: Optional[str] = None, v_stages: int = 0, **pins):
    """The plan of a batch of ``lengths`` under the cost model ``cm``: the
    one solve of the training loop, its re-planning controller and the
    controller's incumbent what-if (``pins``: ``token_capacity``,
    ``sp_policy``, ``sp_degree``); ``schedule`` and ``v_stages`` pin the
    planner's schedule backend."""
    from repro_torch.core import PlannerConfig, plan_batch
    remat_mode = ("stage_aware" if loop.ckpt_policy == "stage-aware"
                  else "uniform")
    pins = {"sp_policy": loop.sp_policy, "sp_degree": loop.sp_degree,
            **pins}
    if cm.model.is_encoder_decoder:
        # the reference's encoder-decoder cell: K = 1 (the encoder is
        # pack-only), one virtual stage, allgather_kv over the whole SP
        # axis (runtime/encdec_pipeline.encdec_sp_pin: another pin raises)
        from repro_torch.runtime.encdec_pipeline import encdec_sp_pin
        d_s = cm.cluster.d_s
        pol = encdec_sp_pin(pins["sp_policy"], pins["sp_degree"], d_s)
        pins = dict(pins, fixed_k=1, sp_degree=d_s,
                    **({"sp_policy": pol} if d_s > 1 else {}))
        v_stages = 1
    pconf = PlannerConfig(bucket_rounding=BUCKET_ROUNDING,
                          remat_mode=remat_mode, schedule=schedule,
                          v_stages=v_stages, **pins)
    return plan_batch(cm, list(lengths), pconf)


def plan_step(cm, loop: TrainConfig, step: int, *,
              schedule: Optional[str] = None, v_stages: int = 0):
    """Step ``step``'s batch and its plan under the cost model ``cm``, as
    :func:`train` runs them: ``(corpus, plan)``; ``schedule`` and
    ``v_stages`` pin the planner's schedule backend."""
    corpus = corpus_for(loop, step, cm.model.vocab)
    return corpus, plan_lengths(cm, loop, [len(v) for v in corpus.values()],
                                schedule=schedule, v_stages=v_stages)


def train(cfg, loop: TrainConfig, *, device, params: Optional[Dict] = None,
          cluster=None, log: Callable = print,
          on_step: Optional[Callable] = None,
          on_resume: Optional[Callable] = None,
          cards: Optional[Sequence] = None) -> Tuple[object, List[Dict]]:
    """Run ``loop.steps`` steps (from the checkpoint's next step under
    ``loop.resume``); returns ``(trainer, history)``.

    ``params``: starting parameters in the port's layout (default: random
    from ``loop.seed``). ``cluster``: the planner's hardware (default: one
    H100; with ``loop.d_p > 1`` its ``d_p`` is set and each stage gets its
    card's memory divided by the stages on that card). ``cards``: the
    pipeline's cards (default: ``device``). ``on_step(step, plan,
    corpus, trainer)`` is called before each step (the caller may reset
    counters or read the state there); ``on_resume(trainer, step)`` right after a checkpoint was
    restored into the trainer (``step``: the first step the run will
    take).

    As the JAX trainer's loop: step 0's plan is solved first and pins the
    schedule and ``v``; a resumed run restores after its trainer is built
    (overwriting parameters, master, moments and step) and refuses a
    checkpoint written at another ``v``; each step's plan is solved after
    the previous step ran and before its telemetry reaches the re-planning
    controller, and solved again when an ``auto`` swap is adopted; plans
    are journaled, never checkpointed. One difference: a resumed run's
    first step runs its own step's batch, where the JAX loop runs step 0's
    again (``ROADMAP.md`` §3, reference caveats)."""
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import ClusterSpec, CostModel, ExecutionPlan
    from repro_torch.device import dtype_of
    from repro_torch.ft import (StragglerInjector, StragglerMonitor,
                                replan_costmodel)
    from repro_torch.lint import run_plan_checks
    from repro_torch.models import DecoderLM, EncDecLM
    from repro_torch.runtime.train_step import ChunkedTrainer
    from repro_torch.telemetry import (ReplanConfig, ReplanController,
                                       StepTimeline, read_jsonl)

    device = torch.device(device)
    dtype = dtype_of(loop.compute_dtype)
    d_p, d_s = loop.d_p, loop.d_s
    cards = [torch.device(c) for c in (cards or [device])]
    cluster = cluster or ClusterSpec()
    piped = d_p > 1 or d_s > 1 or loop.n_pods > 1
    if piped:
        # each SP rank (of each pod) is planned with its share of its card
        per_card = -(-d_p // len(cards)) * loop.n_pods
        cluster = cluster.with_(d_p=d_p, d_s=d_s,
                                hbm_bytes=cluster.hbm_bytes / (per_card * d_s))
    cm = CostModel(cfg.spec, cluster)
    try:
        cm.token_capacity()
    except ValueError as e:
        raise PlanError(f"{cfg.name}: no plan for this cluster: {e}") from e
    encdec = cfg.spec.is_encoder_decoder
    # the JAX loop never feeds the monitor (replan_costmodel returns cm)
    monitor = StragglerMonitor(d_p=d_p)
    mgr = CheckpointManager(loop.ckpt_dir) if loop.ckpt_dir else None
    timeline = StepTimeline(spill_dir=loop.telemetry_dir, name="train")
    injector = (StragglerInjector.parse(loop.inject_straggler, d_p,
                                        seed=loop.seed)
                if loop.inject_straggler else None)
    journal_in = {}
    if loop.plan_journal:
        for rec in read_jsonl(loop.plan_journal):
            journal_in[int(rec["step"])] = ExecutionPlan.loads(rec["plan"])
        if not journal_in:
            raise ValueError(f"--plan-journal {loop.plan_journal} holds no "
                             f"replayable plans")
        log(f"[journal] replaying {len(journal_in)} plans from "
            f"{loop.plan_journal}")
    # the schedule and v place the layers: pinned after step 0's plan
    pinned = {"schedule": loop.schedule, "v_stages": loop.v_stages}
    key_kwargs = {"split_bwd": loop.split_bwd, "dtype": loop.compute_dtype}

    def solve(cm_, lengths):
        plan = plan_lengths(cm_, loop, lengths, **pinned)
        pinned["schedule"], pinned["v_stages"] = plan.schedule, plan.v_stages
        return plan

    def resolve_incumbent(cm_, lengths, inc):
        """This batch re-planned under the incumbent's bucket (capacity and
        SP point pinned): the hysteresis strawman, never run."""
        key = inc.bucket_key(d_s, **key_kwargs)
        return plan_lengths(cm_, loop, lengths, **pinned,
                            token_capacity=key.cap,
                            sp_policy=key.sp_policy, sp_degree=key.d_s_eff)

    def bucket_of(plan):
        return str(plan.bucket_key(d_s, **key_kwargs))

    def lint_report(plan):
        return run_plan_checks(plan, d_s, d_p, model=cfg.spec,
                               key_kwargs=key_kwargs)

    def plan_lint(plan):
        """A re-plan candidate's lint errors: a hazardous candidate is
        rejected before the swap."""
        if loop.lint == "off":
            return []
        return [str(e) for e in lint_report(plan).errors]

    controller = None
    if loop.replan in ("observe", "auto") and not journal_in:
        # no precompile: the port builds nothing per bucket
        controller = ReplanController(
            cm, ReplanConfig(mode=loop.replan, min_win=loop.replan_min_win,
                             cooldown_steps=loop.replan_cooldown,
                             min_samples=loop.replan_min_samples,
                             background=loop.replan_background),
            solve, bucket_of, lint=plan_lint,
            resolve_incumbent=resolve_incumbent, timeline=timeline,
            telemetry_dir=loop.telemetry_dir,
            fingerprint=f"{d_p}x{d_s}:{cfg.spec.name}", log=log)

    resuming = (mgr is not None and loop.resume
                and mgr.latest_step() is not None)

    def plan_for(step: int, *, layout_only: bool = False):
        """Step ``step``'s plan and batch; ``layout_only``: the plan only
        places the layers (a resumed run's bootstrap), so a replay of a
        resumed run's journal, which lacks step 0, takes its first plan."""
        corpus = corpus_for(loop, step, cfg.spec.vocab)
        if journal_in:
            plan = journal_in.get(step)
            if plan is None and not layout_only:
                raise ValueError(
                    f"--plan-journal {loop.plan_journal} holds no plan for "
                    f"step {step} (it holds steps {min(journal_in)}-"
                    f"{max(journal_in)})")
            plan = plan or journal_in[min(journal_in)]
            pinned["schedule"], pinned["v_stages"] = (plan.schedule,
                                                      plan.v_stages)
            return plan, corpus
        cm_ = controller.cost_model() if controller is not None else cm
        cm_ = replan_costmodel(cm_, monitor)
        return solve(cm_, [len(v) for v in corpus.values()]), corpus

    journal_out = None
    history: List[Dict] = []
    lint_stats = {"buckets": 0, "findings": 0, "errors": 0}
    linted = set()
    try:
        if loop.telemetry_dir:
            jp = Path(loop.telemetry_dir) / "plans.jsonl"
            jp.parent.mkdir(parents=True, exist_ok=True)
            journal_out = open(jp, "w", buffering=1)
        # bootstrap: step 0's plan pins the schedule and v
        plan, corpus = plan_for(0, layout_only=resuming)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(loop.seed)
            params = (EncDecLM if encdec else DecoderLM)(cfg).init(
                gen, device=device)
        if plan.sp is not None and d_s > 1:
            log(f"[sp] policy={plan.sp.policy} d_s_eff={plan.sp.d_s_eff}/"
                f"{d_s}" + (" (planner-chosen)" if loop.sp_policy == "auto"
                            and not loop.sp_degree and not encdec
                            else " (pinned)"))
        if not piped:
            trainer = ChunkedTrainer(cfg, params, device=device,
                                     compute_dtype=dtype)
        else:
            trainer = _pipeline_trainer(cfg, loop, plan, params, cards,
                                        dtype, cm)
            g = trainer.geom
            log(f"[pipeline] d_p={d_p} d_s={d_s} schedule={g.schedule} "
                f"v={g.v_stages} split_bwd={g.split_bwd} cards="
                f"{[str(c) for c in cards]} stage_devices="
                f"{[str(d) for d in trainer.devices]}")
        del params
        start_step, restore_s = 0, None
        if resuming:
            t0 = time.perf_counter()
            start_step = _resume(mgr, trainer, plan, log)
            restore_s = time.perf_counter() - t0
            if on_resume is not None:
                on_resume(trainer, start_step)
            if start_step < loop.steps:
                plan, corpus = plan_for(start_step)
        for step in range(start_step, loop.steps):
            if journal_out is not None:
                journal_out.write(json.dumps({"step": step,
                                              "plan": plan.dumps()}) + "\n")
            bucket = bucket_of(plan)
            if loop.lint != "off" and bucket not in linted:
                # a new bucket stands in for the JAX trainer's cold compile
                linted.add(bucket)
                rep = lint_report(plan)
                for f in rep.findings:
                    log(f"[lint] {f}")
                lint_stats["buckets"] += 1
                lint_stats["findings"] += len(rep.findings)
                lint_stats["errors"] += len(rep.errors)
                if rep.findings:
                    timeline.record("lint", step, bucket=bucket,
                                    findings=len(rep.findings),
                                    errors=len(rep.errors))
                if loop.lint == "error":
                    rep.raise_if_findings()
            if on_step is not None:
                on_step(step, plan, corpus, trainer)
            rec, res = _run_step(trainer, cfg, loop, plan, corpus, step,
                                 cards, device, dtype, encdec)
            if piped:
                rec.update(_pipeline_record(cm, plan, trainer, cards, res))
            del res
            lengths = [len(v) for v in corpus.values()]
            executed = plan
            if step + 1 < loop.steps:
                plan, corpus = plan_for(step + 1)
            wall = rec["wall_s"]
            probed = bool(loop.probe_every) and step % loop.probe_every == 0
            per_stage = None
            if probed:
                per_stage = [wall / d_p] * d_p
                if injector is not None:
                    per_stage = injector.per_stage(per_stage, step)
            wall_rep = (injector.wall(wall, step) if injector is not None
                        else wall)
            timeline.record_step(step, bucket, wall_rep,
                                 tokens=float(rec["tokens"]),
                                 loss=rec["loss"], per_stage_s=per_stage,
                                 probed=probed)
            history.append(rec)
            log(_step_line(rec))
            if controller is not None:
                controller.observe_step(step, executed, wall_rep, lengths,
                                        per_stage_s=per_stage, bucket=bucket)
                swap = controller.poll()
                if (swap is not None and loop.replan == "auto"
                        and step + 1 < loop.steps):
                    # the swap at the step boundary: the next step is solved
                    # again under the newly adopted calibration
                    plan, corpus = plan_for(step + 1)
            if mgr is not None and (step + 1) % loop.ckpt_every == 0:
                mgr.save(step, trainer.state_tree(),
                         extra={"step": step, "schedule": executed.schedule,
                                "v_stages": executed.v_stages})
                # the save's bytes and blocking seconds; its write's
                # seconds once on disk
                rec["save"] = mgr.stats
        if mgr is not None:
            mgr.wait()
        if controller is not None:
            controller.drain()
            controller.poll()       # a job that outlived the loop
            log(f"[replan] version={controller.version} "
                f"counters={controller.counters} "
                f"triggers={controller.trigger_reasons}")
        if history:
            history[-1]["telemetry"] = timeline.snapshot()
            history[-1]["lint"] = dict(lint_stats)
            if controller is not None:
                history[-1]["replan"] = controller.snapshot()
            if mgr is not None:
                history[-1]["checkpoint"] = dict(mgr.stats,
                                                 restore_s=restore_s)
    finally:
        if journal_out is not None:
            journal_out.close()
        timeline.close()
    return trainer, history


def _resume(mgr, trainer, plan, log) -> int:
    """Restore the latest checkpoint into ``trainer`` (built for ``plan``'s
    schedule and v); returns the first step to run."""
    state, extra = mgr.restore(trainer.state_tree())
    # the port could re-stage across v (its checkpoint is the model's
    # layout); the reference's guard stays, so a run keeps its v
    saved_v = int(extra.get("v_stages", 1))
    if saved_v != plan.v_stages:
        raise ValueError(
            f"checkpoint was written with v_stages={saved_v} but "
            f"this run pinned {plan.schedule} v={plan.v_stages}; "
            f"pass --schedule/--v-stages matching the checkpoint "
            f"(layer stacking is v-dependent and cannot be "
            f"restacked across v)")
    trainer.load_state(state)
    del state
    start = int(extra.get("step", mgr.latest_step())) + 1
    log(f"[resume] from step {start - 1}")
    return start


def _run_step(trainer, cfg, loop, plan, corpus, step, cards, device, dtype,
              encdec):
    """One step, bracketed by synchronizes: ``(record, result)``, its
    history record and the trainer's ``StepResult``."""
    import torch

    from repro_torch.data.batching import sequence_frames
    for c in cards:
        if c.type == "cuda":
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
    # the encoder-decoder's frames: each sequence's from the frontend stub
    # (set-up, outside the step's time)
    data = (sequence_frames(cfg, corpus, loop.seed + step, device=cards[0],
                            dtype=dtype),) if encdec else ()
    t0 = time.perf_counter()
    res = trainer.step(plan, corpus, *data, remat_policy=loop.ckpt_policy)
    for c in cards:
        if c.type == "cuda":
            torch.cuda.synchronize(c)
    wall = time.perf_counter() - t0
    rec = {"step": step, "loss": res.loss, "tokens": res.n_valid,
           "wall_s": wall, "tokens_per_s": res.n_valid / wall,
           "chunks": res.chunks, "pipelines": len(plan.pipelines),
           "remat_layers": res.remat_layers, "grad_norm": res.grad_norm,
           "solve_s": plan.solve_time,
           "frames": (sum(len(t) for t in corpus.values()) if encdec
                      else 0),
           "plan_peak_mem_gb": max((m for p in plan.pipelines
                                    for m in p.est_peak_mem),
                                   default=0.0) / 1e9,
           "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None)}
    return rec, res


def _step_line(rec: Dict) -> str:
    mem = (f"{rec['peak_mem_gb']:.2f} GB" if rec["peak_mem_gb"] is not None
           else "n/a (cpu)")
    extra = ""
    if "card_peak_mem_gb" in rec:
        extra = (f" stages_est {rec['stage_plan_mem_gb']} GB (in the"
                 f" order run {rec['stage_order_mem_gb']})"
                 f" card_peak {rec['card_peak_mem_gb']} GB (est "
                 f"{rec['card_plan_mem_gb']}) handoffs "
                 f"{rec['handoffs']} ({rec['handoff_bytes'] / 1e6:.1f} "
                 f"MB) bubble {rec['bubble_share']:.4f}")
    if "sp_policy" in rec:
        extra += (f" sp {rec['sp_policy']} d_s_eff {rec['d_s_eff']}/"
                  f"{rec['d_s']} collectives {rec['collectives']} "
                  f"({rec['collective_bytes'] / 1e6:.1f} MB) zero3 "
                  f"{rec['zero3_mode']} rank_state "
                  f"{[[round(b / 1e9, 3) for b in st] for st in rec['rank_state_bytes']]}"
                  f" GB (charge "
                  f"{[round(b / 1e9, 3) for b in rec['rank_charge_bytes']]})"
                  f" gathered_peak {rec['gathered_peak_bytes'] / 1e9:.3f} GB")
    if "frame_rows_per_rank" in rec:
        extra += (f" frames/rank {rec['frame_rows_per_rank']} memory_gathers "
                  f"{rec['memory_gathers']} "
                  f"({rec['memory_gather_bytes'] / 1e6:.1f} MB)")
    return (f"step {rec['step']:4d} loss {rec['loss']:.4f} tokens "
            f"{rec['tokens']} wall {rec['wall_s']:.2f}s tok/s "
            f"{rec['tokens_per_s']:.1f} peak_mem {mem} (plan estimate "
            f"{rec['plan_peak_mem_gb']:.2f} GB) chunks {rec['chunks']} "
            f"remat_layers {rec['remat_layers']}" + extra)


def _pipeline_trainer(cfg, loop: TrainConfig, plan, params, cards, dtype,
                      cm):
    """The run's :class:`PipelineTrainer` for step 0's ``plan``."""
    from repro_torch.core.schedule import get_schedule
    from repro_torch.runtime.pipeline import PipelineGeometry
    from repro_torch.runtime.train_step import PipelineTrainer
    split = {"auto": get_schedule(plan.schedule, plan.v_stages).split_bwd,
             "on": True, "off": False}[loop.split_bwd]
    if cfg.spec.is_encoder_decoder:
        from repro_torch.runtime.encdec_pipeline import EncDecGeometry
        from repro_torch.runtime.train_step import EncDecTrainer
        geom = EncDecGeometry(d_p=loop.d_p, schedule=plan.schedule,
                              v_stages=plan.v_stages, split_bwd=split,
                              d_s=loop.d_s, **(
                                  {"zero3_mode": loop.zero3_mode}
                                  if loop.d_s > 1 else {}))
        return EncDecTrainer(cfg, params, geometry=geom, cards=cards,
                             compute_dtype=dtype, cost_model=cm,
                             n_pods=loop.n_pods,
                             compress_pod_grads=loop.compress_pod_grads)
    geom = PipelineGeometry(d_p=loop.d_p, schedule=plan.schedule,
                            v_stages=plan.v_stages, split_bwd=split,
                            d_s=loop.d_s, **(
                                {"policy": plan.sp.policy,
                                 "d_s_eff": plan.sp.d_s_eff,
                                 "zero3_mode": loop.zero3_mode}
                                if plan.sp is not None and loop.d_s > 1
                                else {}))
    return PipelineTrainer(cfg, params, geometry=geom, cards=cards,
                           compute_dtype=dtype, cost_model=cm,
                           n_pods=loop.n_pods,
                           compress_pod_grads=loop.compress_pod_grads)


def _pipeline_record(cm, plan, trainer, cards, res) -> Dict:
    """A pipelined step's line: each stage's estimate (a rank's, with a
    sequence-parallel axis), each card's peak beside the sum of its
    stages' ranks' estimates, the hand-offs, the schedule's bubble share
    on the plan's mean stage times; with ``d_s > 1`` the step's SP point,
    the bytes its collectives moved and the rows a rank gives kernel A
    (queries, keys) and kernel B (tokens, vocabulary rows) on the
    step's largest chunk."""
    import torch

    from repro_torch.core.schedule import get_schedule
    g = trainer.geom
    est = [max(p.est_peak_mem[s] for p in plan.pipelines)
           for s in range(g.d_p)]
    card_est = [len(trainer.pods) * g.d_s * sum(est[c::len(cards)])
                for c in range(len(cards))]
    spec = get_schedule(g.schedule, g.v_stages)
    bub = work = 0.0
    for pipe in plan.pipelines:
        t_f, t_b = cm.avg_stage_times(pipe.chunks)
        bub += spec.bubble_time(pipe.n_chunks, g.d_p, t_f, t_b)
        work += pipe.n_chunks * (t_f + t_b)
    peaks = [torch.cuda.max_memory_allocated(c) / 1e9
             if c.type == "cuda" else None for c in cards]
    return {"schedule": g.schedule, "v_stages": g.v_stages,
            "split_bwd": g.split_bwd,
            "stage_plan_mem_gb": [round(e / 1e9, 3) for e in est],
            "stage_order_mem_gb": [round(e / 1e9, 3)
                                   for e in res.pipeline["order_peak_mem"]],
            "card_plan_mem_gb": [round(e / 1e9, 3) for e in card_est],
            "card_peak_mem_gb": [None if p is None else round(p, 3)
                                 for p in peaks],
            "plan_peak_mem_gb": max(card_est) / 1e9,
            "bubble_share": bub / (bub + work) if work else 0.0,
            **{k: res.pipeline[k] for k in ("handoffs", "handoff_bytes",
                                            "copied_bytes")},
            **{k: res.pipeline[k] for k in ("n_pods", "compress_pod_grads",
                                            "pod_chunks", "pod_n_valid")
               if k in res.pipeline},
            **(_sp_record(cm, plan, res.pipeline, trainer)
               if g.d_s > 1 else {})}


def _sp_record(cm, plan, pipe: Dict, trainer) -> Dict:
    """The SP fields of a step's line (see :func:`_pipeline_record`); an
    encoder-decoder's also each rank's frame rows (its queries of the
    encoder's attention; cross-attention's keys are every rank's) and the
    memory's gathers and bytes."""
    from repro_torch.runtime.sp import row_blocks
    from repro_torch.runtime.train_step import ROW_MULTIPLE
    d_s, d_eff, policy = pipe["d_s"], pipe["d_s_eff"], pipe["sp_policy"]
    quantum = ROW_MULTIPLE * d_eff
    big = max((c for p in plan.pipelines for c in p.chunks),
              key=lambda c: c.tokens)
    rows = -(-big.tokens // quantum) * quantum
    spec = cm.model
    if policy == "ulysses":
        attn = {"queries": rows, "keys": big.context + rows,
                "q_heads": spec.n_heads // d_eff,
                "kv_heads": spec.n_kv_heads // d_eff}
    else:
        attn = {"queries": rows // d_eff, "keys": big.context + rows,
                "q_heads": spec.n_heads, "kv_heads": spec.n_kv_heads}
    z = pipe["zero3"]
    return {"sp_policy": policy, "d_s_eff": d_eff, "d_s": d_s,
            "collective_bytes": pipe["collective_bytes"],
            "collectives": pipe["collectives"],
            "attn_rows_per_rank": attn,
            "ce_rows_per_rank": {"tokens": rows,
                                 "vocab_rows": row_blocks(spec.vocab,
                                                          d_s)[0][1]},
            # ZeRO-3: what each rank owns beside the planner's charge
            # (m_model_states: a rank's 1/d_s of its stage's states), the
            # leaves it keeps whole, its share of what the planner's count
            # leaves out; the gathers and reduce-scatters of the step and
            # the most gathered bytes alive at once
            "zero3_mode": z["mode"],
            "rank_state_bytes": z["rank_state_bytes"],
            "rank_charge_bytes": trainer.rank_charges(cm),
            "planner_charge_bytes": [cm.m_model_states(p + 1) for p in
                                     range(len(z["rank_state_bytes"]))],
            "whole_state_bytes": z["whole_state_bytes"],
            "uncounted_state_bytes": z["uncounted_state_bytes"],
            "gathers": z["gathers"], "regathers": z["regathers"],
            "gather_bytes": z["gather_bytes"],
            "scatter_bytes": z["scatter_bytes"],
            "gathered_peak_bytes": z["peak_live_bytes"],
            **({"frame_rows_per_rank": rows // d_eff,
                "memory_gathers": pipe["memory_gathers"],
                "memory_gather_bytes": pipe["memory_bytes"]}
               if spec.is_encoder_decoder else {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, every width "
                         "kept (0: the arch's own)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--context", type=int, default=2048)
    ap.add_argument("--dataset", default="github",
                    help="length preset (github/commoncrawl/uniform)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-policy", default="stage-aware",
                    choices=["stage-aware", "uniform"])
    ap.add_argument("--mesh", default="1x1",
                    help="PxS: P pipeline stages of S sequence-parallel "
                         "ranks")
    ap.add_argument("--sp-policy", default="auto",
                    choices=["auto", "none", "ulysses", "allgather_kv"],
                    help="sequence-parallel policy pin: 'auto' lets the "
                         "planner choose (policy, degree) jointly with "
                         "chunking; a name pins the policy")
    ap.add_argument("--sp-degree", type=int, default=0,
                    help="effective SP degree pin (must divide S); 0 = "
                         "planner-chosen")
    ap.add_argument("--cards", type=int, default=1,
                    help="cards the stages are placed on (stage p on "
                         "card p mod cards)")
    ap.add_argument("--schedule", default=None,
                    choices=["gpipe-1f1b", "interleaved-1f1b",
                             "zero-bubble-h1"],
                    help="pipeline schedule backend (default: the "
                         "planner's pick for step 0, pinned for the run)")
    ap.add_argument("--v-stages", type=int, default=0,
                    help="virtual stages per stage for interleaved-1f1b "
                         "(0: the planner's pick, pinned for the run)")
    ap.add_argument("--split-bwd", default="auto",
                    choices=["auto", "on", "off"],
                    help="zero-bubble B/W backward split: 'auto' follows "
                         "the schedule backend (split for zero-bubble-h1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="compute dtype (default: float32 with --reduced, "
                         "else bfloat16)")
    ap.add_argument("--profile", default="",
                    help="run the last step under torch.profiler and write "
                         "its summary (JSON) here")
    ap.add_argument("--memory-snapshot", default="",
                    help="record the last step's allocation history, write "
                         "the snapshot (pickle) here and print what is "
                         "live at its peak")
    ap.add_argument("--ckpt-dir", default="",
                    help="save a checkpoint here every --ckpt-every steps")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir "
                         "(at any --mesh: the checkpoint is re-staged)")
    ap.add_argument("--lint", default="warn", choices=["off", "warn", "error"],
                    help="plan lint on each new bucket and each re-plan "
                         "candidate: 'warn' logs findings, 'error' aborts")
    ap.add_argument("--replan", default="off",
                    choices=["off", "observe", "auto"],
                    help="online re-planning: 'observe' fits calibrations "
                         "and logs would-be swaps without touching plans; "
                         "'auto' plans under the adopted calibration and "
                         "swaps at step boundaries")
    ap.add_argument("--telemetry-dir", default="",
                    help="the timeline's JSONL spill, the plan journal "
                         "(plans.jsonl) and calibration.json")
    ap.add_argument("--probe-every", type=int, default=0,
                    help="every Nth step carries a per-stage time vector "
                         "(0: none)")
    ap.add_argument("--replan-min-win", type=float, default=0.05,
                    help="hysteresis: a bucket-changing swap needs this "
                         "predicted relative win")
    ap.add_argument("--replan-cooldown", type=int, default=8,
                    help="minimum steps between re-plan jobs")
    ap.add_argument("--replan-min-samples", type=int, default=4,
                    help="telemetry samples before the first fit")
    ap.add_argument("--replan-sync", action="store_true",
                    help="run re-plan jobs inline, not on a background "
                         "thread (deterministic swap timing)")
    ap.add_argument("--inject-straggler", default="",
                    help="telemetry-only straggler 'STAGE:FACTOR[,...]"
                         "[@START]' (e.g. '2:2.5@3'): scales the reported "
                         "times, never the math")
    ap.add_argument("--dataset2", default="",
                    help="the length preset from --drift-at on")
    ap.add_argument("--context2", type=int, default=0,
                    help="the context from --drift-at on (0: --context)")
    ap.add_argument("--drift-at", type=int, default=0,
                    help="step at which --dataset2/--context2 take over "
                         "(0: never)")
    ap.add_argument("--plan-journal", default="",
                    help="replay the per-step plans of this plans.jsonl "
                         "instead of solving")
    ap.add_argument("--stats-json", default="",
                    help="write the run's history, telemetry, re-planning "
                         "and lint counters to this JSON file")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import DeviceUnavailableError, resolve_device

    try:
        device = resolve_device(args.device)
    except DeviceUnavailableError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.memory_snapshot and device.type != "cuda":
        print("error: --memory-snapshot records the CUDA allocator's "
              "history: it needs --device cuda", file=sys.stderr)
        return 2
    d_p, d_s = parse_mesh(args.mesh)
    cfg = get_arch(args.arch)
    if cfg.spec.is_encoder_decoder and d_p < 2:
        print(f"error: {cfg.name} is an encoder-decoder: its pipeline needs "
              f"an encoder and a decoder stage, and encoder_stage_split("
              f"{cfg.spec.n_encoder_layers}, {cfg.spec.n_layers}, {d_p}) "
              f"leaves no encoder stage: use --mesh 2x1 or more",
              file=sys.stderr)
        return 2
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.with_layers(args.layers)
    loop = TrainConfig(steps=args.steps, global_batch=args.batch,
                       context=args.context, dataset=args.dataset,
                       seed=args.seed, ckpt_policy=args.ckpt_policy,
                       compute_dtype=args.dtype or (
                           "float32" if args.reduced else "bfloat16"),
                       d_p=d_p, d_s=d_s, sp_policy=args.sp_policy,
                       sp_degree=args.sp_degree, schedule=args.schedule,
                       v_stages=args.v_stages, split_bwd=args.split_bwd,
                       ckpt_dir=args.ckpt_dir or None,
                       ckpt_every=args.ckpt_every, resume=args.resume,
                       lint=args.lint, replan=args.replan,
                       telemetry_dir=args.telemetry_dir or None,
                       probe_every=args.probe_every,
                       replan_min_win=args.replan_min_win,
                       replan_cooldown=args.replan_cooldown,
                       replan_min_samples=args.replan_min_samples,
                       replan_background=not args.replan_sync,
                       inject_straggler=args.inject_straggler,
                       dataset2=args.dataset2 or None,
                       context2=args.context2, drift_at=args.drift_at,
                       plan_journal=args.plan_journal or None)
    cards = ([torch.device(device.type, i) for i in range(args.cards)]
             if device.type == "cuda" else [device] * args.cards)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[train] arch={cfg.name} device={name} dtype={loop.compute_dtype} "
          f"batch={loop.global_batch}x{loop.context} {loop.dataset}")
    prof = None
    mem_base = None

    def on_step(step, plan, corpus, trainer):
        nonlocal prof, mem_base
        if args.memory_snapshot and step == loop.steps - 1:
            torch.cuda.synchronize(device)
            mem_base = torch.cuda.memory_allocated(device)
            torch.cuda.memory._record_memory_history(
                max_entries=2_000_000, stacks="python")
        if args.profile and step == loop.steps - 1:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
    try:
        _, history = train(cfg, loop, device=device, on_step=on_step,
                           cards=cards)
    except PlanError as e:
        print(f"error: {e}", file=sys.stderr)
        return 5
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if mem_base is not None:
        import pickle

        from repro_torch.runtime.profile import memory_peak_summary
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        with open(args.memory_snapshot, "wb") as f:
            pickle.dump(snap, f)
        summary = memory_peak_summary(snap, mem_base)
        summary["step_peak_gb"] = history[-1]["peak_mem_gb"]
        summary["plan_peak_mem_gb"] = history[-1]["plan_peak_mem_gb"]
        print(f"[memory] {json.dumps(summary)}")
    if prof is not None:
        from repro_torch.runtime.profile import profile_summary
        summary = profile_summary(prof, history[-1]["wall_s"], 1)
        with open(args.profile, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"[profile] {json.dumps(summary)}")
    if args.stats_json:
        from repro_torch.telemetry import atomic_write_json
        last = history[-1] if history else {}
        atomic_write_json(args.stats_json, {
            "history": history, **{k: last.get(k, {}) for k in (
                "telemetry", "replan", "lint", "checkpoint")}})
    bad = [h["step"] for h in history if not math.isfinite(h["loss"])]
    if bad:
        print(f"error: non-finite loss at steps {bad}", file=sys.stderr)
        return 4
    print("train OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
