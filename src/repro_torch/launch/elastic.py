"""Elastic shrink and grow on the port (the JAX package's
``launch/elastic.py``): plans are functions of the mesh and the batch, not
state, so a run moves between pipeline depths through its checkpoint.

Three phases share one checkpoint directory and one telemetry directory:

1. ``--mesh 2x1`` for ``steps`` steps (a checkpoint every 2 steps);
2. shrink to ``--mesh 1x1``: resume from phase 1's last checkpoint,
   re-staged onto one stage, and run to ``steps + 2``;
3. grow back to ``--mesh 2x1``: resume from phase 2's, run to
   ``steps + 4``.

Each restarted phase must continue its predecessor's loss
(:func:`_assert_loss_continuity`, the reference's check). Under
``--replan observe|auto`` the calibrations persist per mesh fingerprint:
phase 1 adopts one, the shrink phase finds only a foreign fingerprint and
forces an ``elastic`` re-solve, and the grow phase warm-starts phase 1's
calibration with no ``elastic`` trigger. The reference also asserts on
its compile-cache store across the phases (stale skips on the shrink,
warm loads on the grow); the port compiles nothing per bucket, so those
checks have no counterpart here.

Every phase runs on one card (``--cards 1``: both stages of a 2x1 mesh on
it), or on the CPU with ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu \\
      --arch gemma3-1b --reduced --steps 4
  PYTHONPATH=src python -m repro_torch.launch.elastic --arch gemma3-1b \\
      --steps 2 --batch 8 --context 16384 --schedule zero-bubble-h1

A checkpoint moves only between runs of one ``v`` (the reference's guard,
``launch/train.py``): where the planner would pick an interleaved schedule
at 2x1 (gemma3-1b picks ``v = 13``), ``--schedule`` pins a
one-virtual-stage backend for the phases.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

__all__ = ["PHASES", "run", "main"]

# (name, pipeline stages, steps past --steps)
PHASES = (("phase 1", 2, 0), ("shrink", 1, 2), ("grow", 2, 4))


def _assert_loss_continuity(prev_hist, next_hist, phase: str,
                            rel_tol: float = 0.25, log=print) -> None:
    """The restarted run must CONTINUE the previous one: it resumes right
    after a step the previous phase RAN (the last checkpointed one) and its
    first loss stays close to that step's (a scrambled restore shows up as
    a jump back toward the init loss)."""
    nxt = next_hist[0]
    by_step = {h["step"]: h for h in prev_hist}
    prev = by_step.get(nxt["step"] - 1)
    if prev is None:
        raise AssertionError(
            f"{phase}: resumed at step {nxt['step']}, but the previous phase "
            f"never ran step {nxt['step'] - 1} (ran "
            f"{prev_hist[0]['step']}..{prev_hist[-1]['step']})")
    rel = abs(nxt["loss"] - prev["loss"]) / max(prev["loss"], 1e-9)
    if not rel < rel_tol:
        raise AssertionError(
            f"{phase}: loss discontinuity across restart — "
            f"{prev['loss']:.4f} (step {prev['step']}) -> "
            f"{nxt['loss']:.4f} (step {nxt['step']}) ({rel:.1%})")
    log(f"[{phase}] loss continuity OK: {prev['loss']:.4f} -> "
        f"{nxt['loss']:.4f} ({rel:.2%})")


def run(cfg, work_dir, *, device, steps: int = 6, replan: str = "observe",
        cards=None, log: Callable = print,
        on_step: Optional[Callable] = None,
        on_resume: Optional[Callable] = None,
        on_done: Optional[Callable] = None,
        **loop_kw) -> Dict[str, List[Dict]]:
    """The three phases of :data:`PHASES` under ``work_dir`` (its
    ``ckpt/`` and ``telemetry/``); returns each phase's history and raises
    ``AssertionError`` when a check fails. ``loop_kw``: further
    :class:`~repro_torch.launch.train.TrainConfig` fields (batch, context,
    dtype, schedule). ``on_step(phase, step, plan, corpus, trainer)`` runs before
    each step, ``on_resume(phase, trainer, step)`` right after a phase's
    restore, ``on_done(phase, trainer)`` after its last step."""
    from repro_torch.launch.train import TrainConfig, train
    work_dir = Path(work_dir)
    common = dict(ckpt_dir=str(work_dir / "ckpt"), ckpt_every=2,
                  replan=replan,
                  # one telemetry dir across the phases: calibrations
                  # persist keyed by mesh fingerprint
                  telemetry_dir=(str(work_dir / "telemetry")
                                 if replan != "off" else None),
                  replan_min_samples=2, replan_background=False, **loop_kw)
    hists: Dict[str, List[Dict]] = {}
    prev = None
    for name, d_p, more in PHASES:
        log(f"== {name}: mesh {d_p}x1 ==")
        loop = TrainConfig(steps=steps + more, d_p=d_p,
                           resume=prev is not None, **common)
        hooks = {}
        if on_step is not None:
            hooks["on_step"] = lambda *a, n=name: on_step(n, *a)
        if on_resume is not None:
            hooks["on_resume"] = lambda *a, n=name: on_resume(n, *a)
        trainer, hist = train(cfg, loop, device=device, cards=cards, log=log,
                              **hooks)
        if on_done is not None:
            on_done(name, trainer)
        del trainer
        hists[name] = hist
        rep = hist[-1].get("replan", {})
        if prev is not None:
            _assert_loss_continuity(hists[prev], hist, name, log=log)
        if replan != "off" and name != "shrink" and \
                rep.get("calibration_version", 0) < 1:
            raise AssertionError(f"{name}: no calibration adopted or warm-"
                                 f"started: {rep}")
        if replan != "off" and name == "shrink" and \
                "elastic" not in rep.get("triggers", {}):
            # the 1x1 mesh has no calibration in the shared store: the
            # controller must force an elastic re-solve
            raise AssertionError(f"shrink phase should force an elastic "
                                 f"re-solve: {rep}")
        if replan != "off" and name == "grow" and \
                "elastic" in rep.get("triggers", {}):
            raise AssertionError(f"grow phase must not force an elastic "
                                 f"re-solve: {rep}")
        prev = name
    log("elastic restart OK")
    return hists


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the arch's)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--context", type=int, default=256)
    ap.add_argument("--schedule", default=None,
                    choices=["gpipe-1f1b", "interleaved-1f1b",
                             "zero-bubble-h1"],
                    help="the 2x1 phases' schedule (a checkpoint moves "
                         "only between runs of one v)")
    ap.add_argument("--replan", default="observe",
                    choices=["off", "observe", "auto"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    ap.add_argument("--work-dir", default="",
                    help="checkpoints and telemetry (default: a temporary "
                         "directory, removed at the end)")
    args = ap.parse_args(argv)

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
    if args.layers:
        cfg = cfg.with_layers(args.layers)
    kw = dict(steps=args.steps, replan=args.replan,
              global_batch=args.batch, context=args.context,
              schedule=args.schedule,
              compute_dtype="float32" if args.reduced else "bfloat16")
    if args.work_dir:
        run(cfg, args.work_dir, device=device, **kw)
    else:
        with tempfile.TemporaryDirectory() as d:
            run(cfg, d, device=device, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
