"""Sequence Grouping — §III-C2, Eq. 14.

A copy of the JAX package's ``core/grouping.py`` (pure Python and NumPy;
same outputs, which ``tests/test_torch_planner.py`` holds equal).

Sequences with similar chunk counts are grouped into the same 1F1B pipeline:
grouping a short sequence with a long one inflates N_split (Eq. 7), forcing
tighter checkpointing on everyone (Fig. 6a). Scheduling more pipelines
reduces recompute but pays one warmup-cooldown delta each (Eq. 13) —
gradient accumulation keeps optimization consistent across pipelines.

The DP runs over *chunk-count levels*: ``S[i]`` = chunks whose owning
sequence spans ``i`` chunks (batched chunks are level 1; a hybrid chunk takes
the level of the long sequence whose tail it carries). A pipeline serves a
contiguous level range (l, r]:

    dp[r] = min_l { dp[l] + delta(P(l+1..r)) + T_ckpt(P(l+1..r)) }
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .checkpointing import solve_checkpointing, stage_roles
from .chunking import ChunkingResult
from .costs import CostModel
from .plan import Chunk, PipelinePlan
from .schedule import PipelineSimulator, backward_order

__all__ = ["group_sequences", "GroupingResult"]


@dataclass
class GroupingResult:
    pipelines: List[PipelinePlan]
    est_cost: float                 # Eq. 13 objective value
    feasible: bool


def _chunk_level(chunk: Chunk, seq_nchunks: Dict[int, int]) -> int:
    sid = chunk.seq_id
    if sid is None:
        return 1
    return seq_nchunks[sid]


def _candidate(cm: CostModel, chunks: List[Chunk], n_split: int, *,
               gap: float, capacity: Optional[float]
               ) -> Tuple[float, Optional[PipelinePlan]]:
    """Cost of serving ``chunks`` in one 1F1B pipeline: delta + T_ckpt."""
    if not chunks:
        return 0.0, None
    f2b = backward_order(chunks)
    # stage-aware roles: enc-dec arches get encoder coefficients on their
    # leading stages, so the ILP can hand encoder and decoder stages
    # different checkpoint depths (all-decoder otherwise — a no-op)
    roles = stage_roles(cm.model, cm.cluster.d_p)
    sol = solve_checkpointing(cm, chunks, f2b, n_split, gap=gap,
                              capacity=capacity,
                              roles=roles if "encoder" in roles else None)
    if sol.status == "infeasible":
        return math.inf, None
    delta = cm.delta_warmup(chunks)
    plan = PipelinePlan(
        chunks=chunks,
        f2b=f2b,
        ckpt=sol.table,
        ckpt_diag=sol.diag,
        n_split=n_split,
        est_recompute=sol.recompute_time,
    )
    return delta + sol.recompute_time, plan


def group_sequences(cm: CostModel, chunking: ChunkingResult, *,
                    gap: float = 0.02,
                    capacity: Optional[float] = None,
                    simulate: bool = True) -> GroupingResult:
    """Eq. 14 DP. Returns pipelines ordered long-levels-first."""
    chunks = chunking.chunks
    if not chunks:
        return GroupingResult([], 0.0, True)
    seq_nchunks = {s.seq_id: s.n_chunks for s in chunking.sequences}
    levels_of = [_chunk_level(c, seq_nchunks) for c in chunks]
    levels = sorted(set(levels_of), reverse=True)  # descending: longest first
    # chunks per level, preserving the execution order within each level
    by_level: Dict[int, List[int]] = {lv: [] for lv in levels}
    for idx, lv in enumerate(levels_of):
        by_level[lv].append(idx)

    L = len(levels)
    INF = math.inf
    dp = [INF] * (L + 1)
    dp[0] = 0.0
    choice: List[Optional[Tuple[int, PipelinePlan]]] = [None] * (L + 1)
    memo: Dict[Tuple[int, int], Tuple[float, Optional[PipelinePlan]]] = {}

    for r in range(1, L + 1):
        for l in range(r):
            if dp[l] == INF:
                continue
            key = (l, r)
            if key not in memo:
                sel: List[Chunk] = []
                for lv in levels[l:r]:
                    sel.extend(chunks[i] for i in by_level[lv])
                n_split = levels[l]  # max level in the range (desc order)
                memo[key] = _candidate(cm, sel, n_split, gap=gap,
                                       capacity=capacity)
            cost, plan = memo[key]
            if cost == INF or plan is None:
                continue
            if dp[l] + cost < dp[r]:
                dp[r] = dp[l] + cost
                choice[r] = (l, plan)

    if dp[L] == INF:
        return GroupingResult([], INF, False)

    # backtrack
    pipelines: List[PipelinePlan] = []
    r = L
    while r > 0:
        l, plan = choice[r]  # type: ignore[misc]
        pipelines.append(plan)
        r = l
    pipelines.reverse()

    if simulate:
        for p in pipelines:
            sim = PipelineSimulator(cm, p.chunks, p.f2b, p.n_split, p.ckpt)
            res = sim.run()
            p.est_time = res.makespan
            p.est_peak_mem = res.per_stage_peak_mem
    return GroupingResult(pipelines, dp[L], True)
