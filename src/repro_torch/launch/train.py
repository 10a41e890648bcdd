"""Training driver of the port: the planner's chunked step, on one card
or pipelined over ``--mesh Px1`` stages.

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

``--mesh PxS`` with ``P > 1`` plans for ``P`` pipeline stages (each
planned with the memory of its card divided by the stages on that card)
and runs :class:`repro_torch.runtime.train_step.PipelineTrainer`: stage
``p`` on card ``p mod --cards``, the schedule backend the planner picks for
step 0 (or ``--schedule``, ``--v-stages``) pinned for the run, the
zero-bubble split backward as ``--split-bwd`` says. ``S`` must be 1 (the
sequence-parallel axis is not ported). On the card, gemma3-1b on two
stages of one H100:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --steps 2 --batch 8 --context 16384 --mesh 2x1

The encoder-decoder seamless-m4t-v2 trains only pipelined (``--mesh Px1``
with ``P >= 2``: ``core.checkpointing.encoder_stage_split`` gives the
leading stages the encoder and the rest the decoder; ``--mesh 1x1`` exits
with its message), planned as the reference's train step plans it (``K =
1``: the encoder is pack-only; one virtual stage), each sequence with as
many frames as tokens from the audio-frame stub. At full width and depth
on two stages of one H100:

  PYTHONPATH=src python -m repro_torch.launch.train --arch seamless-m4t-v2 \
      --steps 3 --batch 8 --context 16384 --mesh 2x1 --schedule gpipe-1f1b

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
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["TrainConfig", "train", "plan_step", "main", "BUCKET_ROUNDING",
           "PlanError", "parse_mesh"]


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
    schedule: Optional[str] = None
    v_stages: int = 0
    split_bwd: str = "auto"


BUCKET_ROUNDING = 256     # chunk-capacity granularity, as the JAX trainer


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"PxS"`` -> ``(P, S)``; ``S`` must be 1."""
    try:
        p, s = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes PxS, got {text!r}") from None
    if p < 1 or s < 1:
        raise ValueError(f"--mesh {text}: sizes must be >= 1")
    if s != 1:
        raise NotImplementedError(
            f"--mesh {text}: the sequence-parallel axis (S > 1) is not "
            f"ported (ROADMAP.md queue 1, item 4; ZeRO-3 over it: item 3)")
    return p, s


def plan_step(cm, loop: TrainConfig, step: int, *,
              schedule: Optional[str] = None, v_stages: int = 0):
    """Step ``step``'s batch and its plan under the cost model ``cm``, as
    :func:`train` runs them: ``(corpus, plan)``; ``schedule`` and
    ``v_stages`` pin the planner's schedule backend."""
    from repro_torch.core import PlannerConfig, plan_batch
    from repro_torch.data import sample_corpus_batch
    corpus = sample_corpus_batch(loop.dataset, loop.global_batch,
                                 loop.context, cm.model.vocab,
                                 seed=loop.seed + step)
    remat_mode = ("stage_aware" if loop.ckpt_policy == "stage-aware"
                  else "uniform")
    pinned = {}
    if cm.model.is_encoder_decoder:
        # the reference's encoder-decoder cell: K = 1 (the encoder is
        # pack-only), one virtual stage, the whole (unported) SP axis
        pinned = dict(fixed_k=1, sp_degree=cm.cluster.d_s)
        v_stages = 1
    pconf = PlannerConfig(bucket_rounding=BUCKET_ROUNDING,
                          remat_mode=remat_mode, schedule=schedule,
                          v_stages=v_stages, **pinned)
    return corpus, plan_batch(cm, [len(v) for v in corpus.values()], pconf)


def train(cfg, loop: TrainConfig, *, device, params: Optional[Dict] = None,
          cluster=None, log: Callable = print,
          on_step: Optional[Callable] = None,
          cards: Optional[Sequence] = None) -> Tuple[object, List[Dict]]:
    """Run ``loop.steps`` steps; returns ``(trainer, history)``.

    ``params``: starting parameters in the port's layout (default: random
    from ``loop.seed``). ``cluster``: the planner's hardware (default: one
    H100; with ``loop.d_p > 1`` its ``d_p`` is set and each stage gets its
    card's memory divided by the stages on that card). ``cards``: the
    pipeline's cards (default: ``device``). ``on_step(step, plan,
    corpus)`` is called before each step (the caller may reset counters
    there)."""
    import torch

    from repro_torch.core import ClusterSpec, CostModel
    from repro_torch.device import dtype_of
    from repro_torch.data.batching import sequence_frames
    from repro_torch.models import DecoderLM, EncDecLM
    from repro_torch.runtime.train_step import ChunkedTrainer

    device = torch.device(device)
    dtype = dtype_of(loop.compute_dtype)
    d_p = loop.d_p
    cards = [torch.device(c) for c in (cards or [device])]
    cluster = cluster or ClusterSpec()
    if d_p > 1:
        per_card = -(-d_p // len(cards))
        cluster = cluster.with_(d_p=d_p,
                                hbm_bytes=cluster.hbm_bytes / per_card)
    cm = CostModel(cfg.spec, cluster)
    try:
        cm.token_capacity()
    except ValueError as e:
        raise PlanError(f"{cfg.name}: no plan for this cluster: {e}") from e
    encdec = cfg.spec.is_encoder_decoder
    if params is None:
        gen = torch.Generator(device=device).manual_seed(loop.seed)
        params = (EncDecLM if encdec else DecoderLM)(cfg).init(
            gen, device=device)
    trainer = None
    if d_p == 1:
        trainer = ChunkedTrainer(cfg, params, device=device,
                                 compute_dtype=dtype)
        del params
    pinned = (loop.schedule, loop.v_stages)
    history = []
    for step in range(loop.steps):
        corpus, plan = plan_step(cm, loop, step, schedule=pinned[0],
                                 v_stages=pinned[1])
        if trainer is None:
            # the schedule and v place the layers: pinned for the run
            pinned = (plan.schedule, plan.v_stages)
            trainer = _pipeline_trainer(cfg, loop, plan, params, cards,
                                        dtype, cm)
            del params
            g = trainer.geom
            log(f"[pipeline] d_p={d_p} schedule={g.schedule} "
                f"v={g.v_stages} split_bwd={g.split_bwd} cards="
                f"{[str(c) for c in cards]} stage_devices="
                f"{[str(d) for d in trainer.devices]}")
        if on_step is not None:
            on_step(step, plan, corpus)
        for c in cards:
            if c.type == "cuda":
                torch.cuda.synchronize(c)
                torch.cuda.reset_peak_memory_stats(c)
        # the encoder-decoder's frames: each sequence's from the frontend
        # stub (set-up, outside the step's time)
        data = (sequence_frames(cfg, corpus, loop.seed + step,
                                device=cards[0], dtype=dtype),) \
            if encdec else ()
        t0 = time.perf_counter()
        res = trainer.step(plan, corpus, *data,
                           remat_policy=loop.ckpt_policy)
        for c in cards:
            if c.type == "cuda":
                torch.cuda.synchronize(c)
        wall = time.perf_counter() - t0
        rec = {"step": step, "loss": res.loss, "tokens": res.n_valid,
               "wall_s": wall, "tokens_per_s": res.n_valid / wall,
               "chunks": res.chunks, "pipelines": len(plan.pipelines),
               "remat_layers": res.remat_layers,
               "grad_norm": res.grad_norm,
               "solve_s": plan.solve_time,
               "frames": (sum(len(t) for t in corpus.values()) if encdec
                          else 0),
               "plan_peak_mem_gb": max((m for p in plan.pipelines
                                        for m in p.est_peak_mem),
                                       default=0.0) / 1e9,
               "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                               if device.type == "cuda" else None)}
        extra = ""
        if d_p > 1:
            rec.update(_pipeline_record(cm, plan, trainer, cards, res))
            extra = (f" stages_est {rec['stage_plan_mem_gb']} GB (in the"
                     f" order run {rec['stage_order_mem_gb']})"
                     f" card_peak {rec['card_peak_mem_gb']} GB (est "
                     f"{rec['card_plan_mem_gb']}) handoffs "
                     f"{rec['handoffs']} ({rec['handoff_bytes'] / 1e6:.1f} "
                     f"MB) bubble {rec['bubble_share']:.4f}")
        history.append(rec)
        mem = (f"{rec['peak_mem_gb']:.2f} GB" if rec["peak_mem_gb"]
               is not None else "n/a (cpu)")
        log(f"step {step:4d} loss {res.loss:.4f} tokens {res.n_valid} "
            f"wall {wall:.2f}s tok/s {rec['tokens_per_s']:.1f} "
            f"peak_mem {mem} (plan estimate "
            f"{rec['plan_peak_mem_gb']:.2f} GB) chunks {res.chunks} "
            f"remat_layers {res.remat_layers}" + extra)
    return trainer, history


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
                              v_stages=plan.v_stages, split_bwd=split)
        return EncDecTrainer(cfg, params, geometry=geom, cards=cards,
                             compute_dtype=dtype, cost_model=cm)
    geom = PipelineGeometry(d_p=loop.d_p, schedule=plan.schedule,
                            v_stages=plan.v_stages, split_bwd=split)
    return PipelineTrainer(cfg, params, geometry=geom, cards=cards,
                           compute_dtype=dtype, cost_model=cm)


def _pipeline_record(cm, plan, trainer, cards, res) -> Dict:
    """A pipelined step's line: each stage's estimate, each card's peak
    beside the sum of its stages' estimates, the hand-offs, and the
    schedule's bubble share on the plan's mean stage times."""
    import torch

    from repro_torch.core.schedule import get_schedule
    g = trainer.geom
    est = [max(p.est_peak_mem[s] for p in plan.pipelines)
           for s in range(g.d_p)]
    card_est = [sum(est[c::len(cards)]) for c in range(len(cards))]
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
                                            "copied_bytes")}}


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
                    help="PxS: P pipeline stages (S must be 1)")
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
    d_p, _ = parse_mesh(args.mesh)
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
                       d_p=d_p, schedule=args.schedule,
                       v_stages=args.v_stages, split_bwd=args.split_bwd)
    cards = ([torch.device(device.type, i) for i in range(args.cards)]
             if device.type == "cuda" else [device] * args.cards)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[train] arch={cfg.name} device={name} dtype={loop.compute_dtype} "
          f"batch={loop.global_batch}x{loop.context} {loop.dataset}")
    prof = None
    mem_base = None

    def on_step(step, plan, corpus):
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
    bad = [h["step"] for h in history if not math.isfinite(h["loss"])]
    if bad:
        print(f"error: non-finite loss at steps {bad}", file=sys.stderr)
        return 4
    print("train OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
