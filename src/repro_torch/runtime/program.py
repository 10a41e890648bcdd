"""The per-stage action lists of one pipeline: what each stage runs, in
order.

Counterpart of the JAX package's ``runtime/program.py``
(``StageProgram``, ``TickContext``). The reference compiles one lockstep
``lax.scan`` whose every tick maps each stage to an ``(item, virtual
stage)`` through the schedule backend's ``tick_coords``, and whose
backward is the scan's transpose. Here each stage gets an explicit,
ordered list of actions that :mod:`.executor` walks:

* ``F(k, j)``: the forward of chunk ``k`` through virtual stage ``j`` of
  the stage (global virtual stage ``s = j * d_p + p``);
* ``B(k, j)``: its backward: the stream's and the carry's gradients (and,
  unless the backward is split, the weights');
* ``W(k, j)``: under the zero-bubble split, the weight gradients ``B``
  left behind.

The lists, by schedule backend:

* ``v == 1`` (``gpipe-1f1b``, ``zero-bubble-h1``): the plan's own stage
  schedule ``PipelinePlan.schedule[p]`` (``core/schedule.build_schedule``),
  the memory order the checkpointing ILP solved against;
* ``v > 1`` (``interleaved-1f1b``): forwards in ``ScheduleSpec.tick_coords``
  order; backwards, at each virtual stage, in the plan's backward order
  ``f2b`` (a sequence's later chunk before its earlier one: the dKV
  order); a stage interleaves them as a unit-duration event simulation
  of the ring decides, 1F1B once ``(v - 1) d_p + 2 (d_p - p - 1) + 1``
  micro-steps are in flight (Megatron's interleaved warm-up). The order
  can need more residuals than the 1F1B window the ILP solved for: the
  forwards of a group of ``d_p`` chunks advance together, so a chunk
  rides along before the backward of a sequence's last chunk can start.
  A forward that would take the stage past the plan's estimate runs only
  when nothing else can, and then remats all of its layers
  (``Action.remat``), so its residuals are its layers' inputs;
* split: each ``W`` goes after its ``B``, into the slots where the
  stage's next ``F`` or ``B`` would wait for its inputs, as
  ``core/schedule.simulate_schedule`` places them (F 1, B 1, W 1 per
  ``1 / v`` of a stage); the rest drain at the end. A chunk's weight-
  gradient store holds about what its residuals held, so a chunk counts
  as in flight until its ``W`` (ZB-H1's memory rule): a stage starts a
  forward only while fewer are in flight than its fused order ever holds,
  and runs a ``W`` first otherwise.
"""

from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Optional, Sequence

from repro_torch.core.plan import PipelinePlan, TickOp
from repro_torch.core.schedule import (build_schedule, get_schedule,
                                       simulate_occupancy)

__all__ = ["Action", "stage_programs", "residual_peaks"]


class Action(NamedTuple):
    op: str             # "F", "B" or "W"
    chunk: int          # chunk index within the pipeline
    vstage: int = 0     # the stage's local virtual stage j
    remat: bool = False     # F: the step remats every layer of it

    def __repr__(self) -> str:
        return f"{self.op}({self.chunk},{self.vstage}{',*' * self.remat})"


def stage_programs(pipe: PipelinePlan, d_p: int, *, v: int = 1,
                   split: bool = False, cm=None,
                   depths: Optional[Sequence[Sequence[int]]] = None
                   ) -> List[List[Action]]:
    """Each stage's action list for ``pipe`` on ``d_p`` stages of ``v``
    virtual stages each, with ``W`` actions when ``split``. With the cost
    model ``cm`` and the remat table ``depths`` (``[d_p][n]``), an
    interleaved stage starts a forward only while its residuals
    (:func:`residual_peaks`) stay within the plan's estimate
    ``pipe.est_peak_mem``, unless no op of any stage could run otherwise."""
    n = pipe.n_chunks
    if v == 1:
        sched = pipe.schedule or build_schedule(n, d_p, pipe.n_split,
                                                pipe.f2b)
        if len(sched) != d_p:
            raise ValueError(f"the plan's schedule has {len(sched)} stages, "
                             f"the pipeline {d_p}")
        fixed = [[Action("F" if t.op is TickOp.FWD else "B", t.chunk)
                  for t in row] for row in sched]
        return _simulate(d_p, 1, n, pipe.f2b, fixed=fixed) if split \
            else fixed
    act = budget = None
    if cm is not None and pipe.est_peak_mem:
        act = _act(cm, pipe, depths, d_p, v)
        budget = [pipe.est_peak_mem[p] - cm.m_model_states(p + 1)
                  for p in range(d_p)]
    return _simulate(d_p, v, n, pipe.f2b, split=split, act=act,
                     budget=budget)


def _act(cm, pipe: PipelinePlan, depths, d_p: int, v: int):
    """``act[p][k] = (residual bytes of one of stage p's virtual stages on
    chunk k at its remat depth, the same with every layer remat'd)``,
    in the planner's model (``CostModel.m_act``)."""
    l_s = -(-cm.model.n_layers // d_p)
    return [[(cm.m_act(p + 1, c, depths[p][k]) / v,
              cm.m_act(p + 1, c, l_s) / v)
             for k, c in enumerate(pipe.chunks)] for p in range(d_p)]


def _simulate(d_p: int, v: int, n: int, f2b: Sequence[int], *,
              fixed: Optional[List[List[Action]]] = None,
              split: bool = True, act=None, budget=None
              ) -> List[List[Action]]:
    """Unit-duration event simulation of the ring (virtual stage ``s`` on
    stage ``s % d_p``): ``F(k, s)`` after ``F(k, s - 1)``; ``B(k, s)`` after
    ``F(k, s)`` and ``B(k, s + 1)``; ``W`` after its ``B``, only where the
    stage would otherwise wait. At each step the op that can start first
    runs (ties: the 1F1B preference, then the later virtual stage, then the
    lower stage). ``fixed`` gives each stage's F/B order (v == 1);
    otherwise forwards follow ``tick_coords`` and backwards ``f2b`` per
    virtual stage, and a forward that would take a stage's residuals
    (``act[p][k][0]`` bytes each) over ``budget[p]`` waits while any other
    op can run, and then remats every layer (``act[p][k][1]`` bytes); so
    does one that would put more forwards in flight before their ``W``
    than ``cap`` (without the remat). Returns the order each stage ran its
    ops in."""
    S = d_p * v
    dur = {"F": 1.0 / v, "B": (1.0 if split else 2.0) / v, "W": 1.0 / v}
    b2f = [0] * n
    for f, b in enumerate(f2b):
        b2f[b] = f
    f_end, b_end = {}, {}
    free = [0.0] * d_p
    out: List[List[Action]] = [[] for _ in range(d_p)]
    pend_w = [deque() for _ in range(d_p)]
    ptr = [0] * d_p
    if fixed is None:
        occ = simulate_occupancy(get_schedule("interleaved-1f1b", v), n, d_p)
        fwd = [[row[p] for row in occ.grid if row[p] is not None]
               for p in range(d_p)]
        bptr = [[0] * v for _ in range(d_p)]
        cap = [(v - 1) * d_p + 2 * (d_p - p - 1) + 1 for p in range(d_p)]
        inflight = [0] * d_p
        held = [0.0] * d_p
        held_by = {}        # (k, j, p) -> what that forward holds
    else:       # the most forwards the fused order holds before their B
        cap = [max(sum((a.op == "F") - (a.op == "B") for a in row[:i + 1])
                   for i in range(len(row))) for row in fixed]
    until_w = [0] * d_p     # forwards whose W has not run (split)

    def f_ready(p, k, j):
        s = j * d_p + p
        return 0.0 if s == 0 else f_end.get((s - 1, k))

    def b_ready(p, k, j):
        s = j * d_p + p
        own = f_end.get((s, k))
        if own is None or s == S - 1:
            return own
        dep = b_end.get((s + 1, k))
        return None if dep is None else max(own, dep)

    total = n * S * (3 if split else 2)
    for _ in range(total):
        cands = []              # (start, priority, order, stage, action)
        over = []               # forwards held back (budget, W first)
        for p in range(d_p):
            w_first = split and until_w[p] >= cap[p]
            if fixed is not None:
                if ptr[p] < len(fixed[p]):
                    a = fixed[p][ptr[p]]
                    r = (f_ready if a.op == "F" else b_ready)(p, a.chunk,
                                                              a.vstage)
                    if r is not None:
                        held_back = w_first and a.op == "F"
                        (over if held_back else cands).append(
                            (max(r, free[p]), 0, 0, p, a))
            else:
                want_bwd = inflight[p] >= cap[p] or ptr[p] == len(fwd[p])
                if ptr[p] < len(fwd[p]):
                    k, j = fwd[p][ptr[p]]
                    r = f_ready(p, k, j)
                    if r is not None:
                        c = (max(r, free[p]), int(want_bwd), 0, p,
                             Action("F", k, j))
                        within = act is None or \
                            held[p] + act[p][k][0] <= budget[p]
                        if not within:
                            c = c[:4] + (Action("F", k, j, True),)
                        (cands if within and not w_first else over).append(
                            c)
                for j in range(v):
                    if bptr[p][j] < n:
                        k = b2f[bptr[p][j]]
                        r = b_ready(p, k, j)
                        if r is not None:
                            cands.append((max(r, free[p]), int(not want_bwd),
                                          v - 1 - j, p, Action("B", k, j)))
            if pend_w[p]:
                cands.append((free[p], 2, 0, p, pend_w[p][0]))
        cands = cands or over
        if not cands:
            raise RuntimeError("pipeline schedule deadlock: "
                               f"{[lst[-1:] for lst in out]}")
        start, _, _, p, a = min(cands)
        end = start + dur[a.op]
        free[p] = end
        out[p].append(a)
        s = a.vstage * d_p + p
        if a.op == "W":
            pend_w[p].popleft()
            until_w[p] -= 1
            continue
        if fixed is not None:
            ptr[p] += 1
        if a.op == "F":
            until_w[p] += 1
            f_end[(s, a.chunk)] = end
            if fixed is None:
                ptr[p] += 1
                inflight[p] += 1
                m = act[p][a.chunk][a.remat] if act else 0.0
                held[p] += m
                held_by[(a.chunk, a.vstage, p)] = m
        else:
            b_end[(s, a.chunk)] = end
            if split:
                pend_w[p].append(Action("W", a.chunk, a.vstage))
            if fixed is None:
                bptr[p][a.vstage] += 1
                inflight[p] -= 1
                held[p] -= held_by.pop((a.chunk, a.vstage, p), 0.0)
    return out


def residual_peaks(cm, pipe: PipelinePlan, programs: List[List[Action]],
                   depths: Sequence[Sequence[int]], v: int = 1
                   ) -> List[float]:
    """Each stage's peak bytes under ``programs`` in the planner's memory
    model (``core/schedule.PipelineSimulator._peak_memory``): its model
    states plus the residuals of the micro-steps in flight, each ``F(k,
    j)`` holding ``1 / v`` of ``m_act(p, chunk k, depths[p][k])`` until its
    ``B``. At ``v == 1`` on the plan's own lists this is the plan's
    ``est_peak_mem``; at ``v > 1`` it says whether the interleaved order
    stays within it. Under the split a chunk holds them until its ``W``
    (its weight-gradient store in their place)."""
    act = _act(cm, pipe, depths, len(programs), v)
    peaks = []
    for p, prog in enumerate(programs):
        cur = pk = 0.0
        held = {}
        free_at = "W" if any(a.op == "W" for a in prog) else "B"
        for a in prog:
            if a.op == "F":
                held[(a.chunk, a.vstage)] = act[p][a.chunk][a.remat]
                cur += held[(a.chunk, a.vstage)]
            elif a.op == free_at:
                cur -= held.pop((a.chunk, a.vstage))
            pk = max(pk, cur)
        peaks.append(cm.m_model_states(p + 1) + pk)
    return peaks
