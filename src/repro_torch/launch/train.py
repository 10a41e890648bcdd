"""Training driver of the port on one card: the planner's chunked step.

Each step samples a global batch (``data/synth.sample_corpus_batch``),
plans it with the host planner (Alg. 1 chunking, the grouping DP, the
stage-aware checkpointing ILP) for one card (``ClusterSpec``: an H100 with
``d_p = d_s = 1``), and runs the plan through
:class:`repro_torch.runtime.train_step.ChunkedTrainer`: the KV carry
between a sequence's chunks, the dKV hand-off, remat from the plan's
table, attention and the loss in the CUDA kernels, then AdamW.

On the card (the default device), gemma3-1b at full width in bfloat16:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 3 --batch 8 --context 16384

On the CPU, at a reduced size (float32):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma3-1b --reduced --steps 2 --batch 4 --context 256

Each step prints one line: loss, valid tokens, wall time, tokens per
second, the card's peak allocated memory and the plan's own peak-memory
estimate. ``--profile PATH`` runs the last step under ``torch.profiler``
and writes a JSON summary (device time by kernel group, launches, the
device's busy share of the step).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["TrainConfig", "train", "plan_step", "main", "BUCKET_ROUNDING"]


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


BUCKET_ROUNDING = 256     # chunk-capacity granularity, as the JAX trainer


def plan_step(cm, loop: TrainConfig, step: int):
    """Step ``step``'s batch and its plan under the cost model ``cm``, as
    :func:`train` runs them: ``(corpus, plan)``."""
    from repro_torch.core import PlannerConfig, plan_batch
    from repro_torch.data import sample_corpus_batch
    corpus = sample_corpus_batch(loop.dataset, loop.global_batch,
                                 loop.context, cm.model.vocab,
                                 seed=loop.seed + step)
    remat_mode = ("stage_aware" if loop.ckpt_policy == "stage-aware"
                  else "uniform")
    pconf = PlannerConfig(bucket_rounding=BUCKET_ROUNDING,
                          remat_mode=remat_mode)
    return corpus, plan_batch(cm, [len(v) for v in corpus.values()], pconf)


def train(cfg, loop: TrainConfig, *, device, params: Optional[Dict] = None,
          cluster=None, log: Callable = print,
          on_step: Optional[Callable] = None) -> Tuple[object, List[Dict]]:
    """Run ``loop.steps`` steps; returns ``(trainer, history)``.

    ``params``: starting parameters in the port's layout (default: random
    from ``loop.seed``). ``cluster``: the planner's hardware (default: one
    H100). ``on_step(step, plan, corpus)`` is called before each step (the
    caller may reset counters there)."""
    import torch

    from repro_torch.core import ClusterSpec, CostModel
    from repro_torch.device import dtype_of
    from repro_torch.models import DecoderLM
    from repro_torch.runtime.train_step import ChunkedTrainer

    device = torch.device(device)
    dtype = dtype_of(loop.compute_dtype)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(loop.seed)
        params = DecoderLM(cfg).init(gen, device=device)
    trainer = ChunkedTrainer(cfg, params, device=device, compute_dtype=dtype)
    del params
    cm = CostModel(cfg.spec, cluster or ClusterSpec())
    history = []
    for step in range(loop.steps):
        corpus, plan = plan_step(cm, loop, step)
        if on_step is not None:
            on_step(step, plan, corpus)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = trainer.step(plan, corpus, remat_policy=loop.ckpt_policy)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        rec = {"step": step, "loss": res.loss, "tokens": res.n_valid,
               "wall_s": wall, "tokens_per_s": res.n_valid / wall,
               "chunks": res.chunks, "pipelines": len(plan.pipelines),
               "remat_layers": res.remat_layers,
               "grad_norm": res.grad_norm,
               "solve_s": plan.solve_time,
               "plan_peak_mem_gb": max((m for p in plan.pipelines
                                        for m in p.est_peak_mem),
                                       default=0.0) / 1e9,
               "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                               if device.type == "cuda" else None)}
        history.append(rec)
        mem = (f"{rec['peak_mem_gb']:.2f} GB" if rec["peak_mem_gb"]
               is not None else "n/a (cpu)")
        log(f"step {step:4d} loss {res.loss:.4f} tokens {res.n_valid} "
            f"wall {wall:.2f}s tok/s {rec['tokens_per_s']:.1f} "
            f"peak_mem {mem} (plan estimate "
            f"{rec['plan_peak_mem_gb']:.2f} GB) chunks {res.chunks} "
            f"remat_layers {res.remat_layers}")
    return trainer, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--context", type=int, default=2048)
    ap.add_argument("--dataset", default="github",
                    help="length preset (github/commoncrawl/uniform)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-policy", default="stage-aware",
                    choices=["stage-aware", "uniform"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="compute dtype (default: float32 with --reduced, "
                         "else bfloat16)")
    ap.add_argument("--profile", default="",
                    help="run the last step under torch.profiler and write "
                         "its summary (JSON) here")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import DeviceUnavailableError, resolve_device

    try:
        device = resolve_device(args.device)
    except DeviceUnavailableError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    loop = TrainConfig(steps=args.steps, global_batch=args.batch,
                       context=args.context, dataset=args.dataset,
                       seed=args.seed, ckpt_policy=args.ckpt_policy,
                       compute_dtype=args.dtype or (
                           "float32" if args.reduced else "bfloat16"))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[train] arch={cfg.name} device={name} dtype={loop.compute_dtype} "
          f"batch={loop.global_batch}x{loop.context} {loop.dataset}")
    prof = None

    def on_step(step, plan, corpus):
        nonlocal prof
        if args.profile and step == loop.steps - 1:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
    try:
        _, history = train(cfg, loop, device=device, on_step=on_step)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
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
