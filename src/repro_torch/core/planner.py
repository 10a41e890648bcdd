"""Top-level InfiniPipe solver (the "solver" box of Fig. 4).

A copy of the JAX package's ``core/planner.py`` (pure Python and NumPy;
same outputs, which ``tests/test_torch_planner.py`` holds equal).

For one global (per-pod) batch of sequence lengths it:

1. sweeps the slice-count hyper-parameter ``K`` over ``[1, d_p + 4]``
   (§III-B: automatically tuned),
2. runs Alg. 1 chunking, the Eq. 14 grouping DP (which internally solves the
   Alg. 2 checkpointing ILP per candidate pipeline),
3. scores each K by the cycle-accurate simulator's makespan summed over the
   scheduled 1F1B pipelines (gradient accumulation between them),
4. emits an :class:`ExecutionPlan` with bucketed chunk geometry so the
   executor's compiled program is reused across iterations.

The planner is pure host-side Python; `launch/train.py` overlaps it with the
executor's previous step, reproducing the paper's disaggregated architecture.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .chunking import ChunkingResult, chunk_sequences
from .costs import CostModel
from .grouping import GroupingResult, group_sequences
from .plan import ExecutionPlan
from .schedule import build_schedule, choose_schedule
from .sp import SPConfig, sp_candidates, sp_legal

__all__ = ["plan_batch", "estimate_plan_time", "PlannerConfig"]


@dataclass
class PlannerConfig:
    k_min: int = 1
    k_max: Optional[int] = None       # default: d_p + 4 (paper's range)
    ilp_gap: float = 0.02             # SCIP-style optimality gap (§V-F)
    # remat policy the EXECUTOR applies (the ILP always solves the full
    # per-(stage, chunk) table): "uniform" collapses it to one max depth
    # (the pre-vector behavior); "stage_aware" threads the table itself
    # into the compiled step ("per_chunk" is the legacy alias)
    remat_mode: str = "uniform"       # "uniform" | "stage_aware"
    capacity_bytes: Optional[float] = None
    token_capacity: Optional[int] = None
    bucket_rounding: int = 512        # chunk-capacity bucket granularity
    fixed_k: Optional[int] = None     # pin K (Seq1F1B-style baselines)
    uniform_split: bool = False       # ablate: evenly split (w/o wbc)
    disable_ckpt: bool = False        # ablate: no checkpointing
    full_ckpt: bool = False          # ablate: checkpoint everything
    # schedule backend: None => pick per plan from the bubble model
    # (core/schedule.choose_schedule); a registry name pins it. v_stages=0
    # lets the picker choose the virtual-stage count (interleaved only),
    # a value pins it. Training runs MUST pin after the first plan — the
    # interleaved layer stacking bakes v into the parameter layout.
    schedule: Optional[str] = None
    v_stages: int = 0
    # sequence-parallel axis: "auto" sweeps every legal (policy, d_s_eff)
    # candidate (core/sp.sp_candidates) and solves the best-ranked one
    # jointly with K / chunking / checkpointing; a policy name and/or a
    # degree pins that coordinate. Like schedule pins, training runs keep
    # these fixed across steps so one compiled step per bucket suffices.
    sp_policy: str = "auto"           # "auto" | "none" | "ulysses" | ...
    sp_degree: int = 0                # 0 = auto; else must divide d_s


def _round_up(v: int, q: int) -> int:
    return ((max(v, 1) + q - 1) // q) * q


def _apply_ablations(cm: CostModel, cfg: PlannerConfig,
                     grouping: GroupingResult) -> GroupingResult:
    if cfg.disable_ckpt or cfg.full_ckpt:
        per_stage = max(1, cm.model.n_layers // cm.cluster.d_p)
        val = 0 if cfg.disable_ckpt else per_stage
        for p in grouping.pipelines:
            n = len(p.chunks)
            p.ckpt = [[val] * n for _ in range(cm.cluster.d_p)]
            p.ckpt_diag = [val] * (n + cm.cluster.d_p - 1)
            avg_fwd = sum(cm.t_tot(c) for c in p.chunks) / max(n, 1)
            p.est_recompute = (avg_fwd / cm.model.n_layers) * sum(p.ckpt_diag)
    return grouping


def _quick_estimate(cm: CostModel, chunking: ChunkingResult) -> float:
    """Cheap makespan proxy for K pre-selection: steady-state per-stage work
    plus the Eq. 13 warmup-cooldown delta (no grouping/ILP/simulation)."""
    chunks = chunking.chunks
    if not chunks:
        return 0.0
    per_stage = sum(cm.t_tot(c, per_stage=True)
                    + cm.t_tot(c, bwd=True, per_stage=True) for c in chunks)
    return per_stage + cm.delta_warmup(chunks)


def _sp_pins(cm: CostModel, cfg: PlannerConfig) -> List[SPConfig]:
    """The SP points the solver may place this plan on, best-guess first.

    With no pins this is every legal ``(policy, d_s_eff)`` pair for the
    model at the mesh's ``d_s`` (``core/sp.sp_candidates``); a
    ``cfg.sp_policy``/``cfg.sp_degree`` pin filters that set down (and a
    fully-pinned illegal combination is an error, not a fallback)."""
    d_s = cm.cluster.d_s
    if cfg.sp_degree and d_s % cfg.sp_degree:
        raise ValueError(f"sp_degree={cfg.sp_degree} does not divide the "
                         f"model-axis size d_s={d_s}")
    if cfg.sp_degree and cfg.sp_policy != "auto":
        if not sp_legal(cm.model, cfg.sp_policy, cfg.sp_degree):
            raise ValueError(
                f"pinned sp_policy={cfg.sp_policy!r} is illegal at "
                f"d_s_eff={cfg.sp_degree} for this model "
                f"(heads={cm.model.n_heads}/{cm.model.n_kv_heads}, "
                f"mla={cm.model.kv_lora_rank > 0}, "
                f"attn_free={cm.model.attn_free})")
        return [SPConfig(cfg.sp_policy, cfg.sp_degree)]
    cands = sp_candidates(cm.model, d_s)
    if cfg.sp_degree:
        cands = [c for c in cands if c.d_s_eff == cfg.sp_degree]
    if cfg.sp_policy != "auto":
        cands = [c for c in cands if c.policy == cfg.sp_policy]
    if not cands:
        raise ValueError(
            f"no legal SP candidate for pins (policy={cfg.sp_policy!r}, "
            f"degree={cfg.sp_degree}) at d_s={d_s}")
    return cands


def _rank_sp(cm: CostModel, lengths: Sequence[int], cfg: PlannerConfig,
             cands: List[SPConfig],
             sweep: Dict[str, float]) -> List[Tuple[SPConfig, CostModel]]:
    """Rank SP candidates by the cheap K-proxy at a single probe K.

    The estimate sees everything that distinguishes the candidates: the
    utilization gain of longer per-device shards, the ``sp_replication``
    compute tax of sub-degrees, the 4×a2a vs KV-all-gather comm terms,
    and — through ``token_capacity()`` — the memory pressure of KV
    replication (tighter capacity → more, shorter chunks). Ties keep the
    candidate order (higher degree first, default policy first)."""
    k_probe = cfg.fixed_k if cfg.fixed_k is not None else cm.cluster.d_p
    scored: List[Tuple[float, int, SPConfig, CostModel]] = []
    for i, sp in enumerate(cands):
        cm_c = cm.with_sp(sp.policy, sp.d_s_eff)
        try:
            est = _quick_estimate(
                cm_c, chunk_sequences(cm_c, lengths, k_probe,
                                      capacity=cfg.token_capacity))
        except (ValueError, RuntimeError):
            est = math.inf  # e.g. token_capacity() <= 0 under replication
        sweep[f"{sp.policy}@{sp.d_s_eff}"] = est
        scored.append((est, i, sp, cm_c))
    scored.sort(key=lambda t: (t[0], t[1]))
    return [(sp, cm_c) for _, _, sp, cm_c in scored]


def _solve_k_sweep(cm: CostModel, lengths: Sequence[int], cfg: PlannerConfig
                   ) -> Optional[Tuple[float, ChunkingResult, GroupingResult,
                                       Dict[int, float]]]:
    """The per-SP-point K sweep (Alg. 1 + grouping DP + ILP + simulation).
    Returns ``None`` when no K is memory-feasible at this SP point."""
    d_p = cm.cluster.d_p
    k_max = cfg.k_max if cfg.k_max is not None else d_p + 4
    ks = ([cfg.fixed_k] if cfg.fixed_k is not None
          else list(range(cfg.k_min, k_max + 1)))

    # Two-phase sweep: rank all K by a cheap analytic proxy, then run the
    # full grouping-DP + ILP + simulation only for the most promising ones
    # (falling back down the ranking if memory-infeasible).
    if len(ks) > 5:
        ranked = sorted(
            ks, key=lambda k: _quick_estimate(
                cm, chunk_sequences(cm, lengths, k,
                                    capacity=cfg.token_capacity)))
        ks = ranked

    best: Optional[Tuple[float, ChunkingResult, GroupingResult]] = None
    tried: Dict[int, float] = {}
    full_solves = 0
    for k in ks:
        if best is not None and full_solves >= 4:
            break
        full_solves += 1
        chunking = chunk_sequences(cm, lengths, k,
                                   capacity=cfg.token_capacity)
        if cfg.uniform_split and k > 1:
            chunking = _uniform_chunking(cm, lengths, k, cfg)
        grouping = group_sequences(cm, chunking, gap=cfg.ilp_gap,
                                   capacity=cfg.capacity_bytes)
        if not grouping.feasible:
            tried[k] = math.inf
            continue
        grouping = _apply_ablations(cm, cfg, grouping)
        total = sum(p.est_time for p in grouping.pipelines)
        if cfg.disable_ckpt or cfg.full_ckpt:
            # re-simulate with the forced ckpt tables
            from .schedule import PipelineSimulator
            total = 0.0
            for p in grouping.pipelines:
                res = PipelineSimulator(cm, p.chunks, p.f2b, p.n_split,
                                        p.ckpt).run()
                p.est_time = res.makespan
                p.est_peak_mem = res.per_stage_peak_mem
                total += res.makespan
        tried[k] = total
        if best is None or total < best[0]:
            best = (total, chunking, grouping)
    if best is None:
        return None
    return (*best, tried)


def estimate_plan_time(cm: CostModel, plan: ExecutionPlan) -> float:
    """Predicted step time of an EXISTING plan under ``cm``: the cycle-
    accurate simulator's makespan summed over the plan's pipelines
    (gradient accumulation runs them back to back), evaluated at the
    plan's own SP point. This is the re-planner's comparison primitive —
    it re-costs an incumbent plan under a *newly calibrated* model so the
    candidate-vs-incumbent hysteresis compares like against like."""
    from .schedule import PipelineSimulator

    cm_c = cm
    if plan.sp is not None:
        cm_c = cm.with_sp(plan.sp.policy, plan.sp.d_s_eff)
    total = 0.0
    for p in plan.pipelines:
        res = PipelineSimulator(cm_c, p.chunks, p.f2b, p.n_split,
                                p.ckpt or None).run()
        total += res.makespan
    return total


def plan_batch(cm: CostModel, lengths: Sequence[int],
               cfg: Optional[PlannerConfig] = None) -> ExecutionPlan:
    cfg = cfg or PlannerConfig()
    t0 = time.perf_counter()
    d_p = cm.cluster.d_p

    # SP is a plan axis: rank the legal (policy, d_s_eff) candidates by
    # the cheap proxy, then full-solve the best one — falling down the
    # ranking only when a point is memory-infeasible at every K. The
    # chosen CostModel (cm_c) is the one every downstream estimate,
    # schedule pick, and ILP solve sees.
    cands = _sp_pins(cm, cfg)
    sp_sweep: Dict[str, float] = {}
    if len(cands) == 1:
        order = [(cands[0], cm.with_sp(cands[0].policy, cands[0].d_s_eff))]
    else:
        order = _rank_sp(cm, lengths, cfg, cands, sp_sweep)
    solved = None
    sp = cm_c = None
    for sp, cm_c in order:
        solved = _solve_k_sweep(cm_c, lengths, cfg)
        if solved is not None:
            break
    if solved is None:
        raise RuntimeError(
            f"no feasible plan at any SP point in "
            f"{[(c.policy, c.d_s_eff) for c in cands]}; "
            f"lengths={list(lengths)[:8]}…")

    total, chunking, grouping, tried = solved
    cap = _round_up(max(chunking.max_chunk_tokens, 1), cfg.bucket_rounding)
    for p in grouping.pipelines:
        p.schedule = build_schedule(len(p.chunks), d_p, p.n_split, p.f2b)
    sched_name, v_stages = _pick_schedules(cm_c, grouping.pipelines, cfg)
    plan = ExecutionPlan(
        pipelines=grouping.pipelines,
        sequences=chunking.sequences,
        k_split=chunking.k_split,
        chunk_capacity=cap,
        mesh_slices=chunking.mesh,
        est_total_time=total,
        solve_time=time.perf_counter() - t0,
        remat_mode=cfg.remat_mode,
        schedule=sched_name,
        v_stages=v_stages,
        sp=sp,
        meta={"k_sweep": {str(k): v for k, v in tried.items()},
              "sp_policy": cm_c.sp_policy,
              "sp_sweep": sp_sweep},
    )
    return plan


def _pick_schedules(cm: CostModel, pipelines, cfg: PlannerConfig
                    ) -> Tuple[str, int]:
    """Schedule-backend selection from the bubble model.

    Each pipeline records its own preferred backend
    (``PipelinePlan.sched_backend``); the plan-level pick — the one the
    single compiled executable actually runs, and the one ``bucket_key()``
    carries — minimizes the summed *realized* executor bubble across
    pipelines. The realized model is backend-capability-aware: with the
    executor's B/W backward split compiled in (``schedule.
    SPLIT_BWD_REALIZED``, the default), zero-bubble-h1's realized bubble
    is ``(d_p-1)(t_f+t_b-t_w)`` — its W-grad cooldown fill exists in the
    HLO — so it competes on real footing; with the split disabled it
    falls back to the fused wasted-slot model and never shadows
    interleaving's gain. A pinned ``cfg.schedule`` restricts the
    candidates to that backend
    (with the ``v`` sweep still running for interleaved unless ``v_stages``
    pins it too); a pinned ``v_stages`` — including an explicit 1 — is
    honored, and one that cannot divide the stage's layer block is an
    error, not a silent fallback.
    """
    from .schedule import (candidate_schedules, rank_schedule,
                           schedule_tiebreak)

    d_p = cm.cluster.d_p
    l_s = max(1, -(-cm.model.n_layers // d_p))
    if cfg.v_stages > 1 and l_s % cfg.v_stages:
        raise ValueError(
            f"v_stages={cfg.v_stages} does not divide layers_per_stage="
            f"{l_s} (n_layers={cm.model.n_layers}, d_p={d_p})")
    candidates = candidate_schedules(l_s, schedule=cfg.schedule,
                                     v_stages=cfg.v_stages)

    times = [cm.avg_stage_times(p.chunks) for p in pipelines]
    p2ps = [sum(cm.t_p2p(c) for c in p.chunks) / max(len(p.chunks), 1)
            for p in pipelines]
    for p, tfb, t_p in zip(pipelines, times, p2ps):
        best = choose_schedule(cm, p.chunks, layers_per_stage=l_s,
                               candidates=candidates, avg_times=tfb,
                               avg_p2p=t_p)
        p.sched_backend, p.v_stages = best.name, best.v

    def total_cost(spec) -> Tuple[float, int, str]:
        tot = sum(rank_schedule(spec, len(p.chunks), d_p, t_f, t_b, t_p)[0]
                  for p, (t_f, t_b), t_p in zip(pipelines, times, p2ps))
        return (tot, *schedule_tiebreak(spec))

    best = min(candidates, key=total_cost)
    return best.name, best.v


def _uniform_chunking(cm: CostModel, lengths: Sequence[int], k: int,
                      cfg: PlannerConfig) -> ChunkingResult:
    """'w/o wbc' ablation + the Seq1F1B baseline: split every long sequence
    into K *equal-length* slices and pack shorts into fixed-size chunks."""
    from .plan import Chunk, ChunkKind, SequenceInfo, Slice

    max_len = max(lengths)
    slice_len = (max_len + k - 1) // k
    chunks: List = []
    seqinfos: List[SequenceInfo] = []
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    pack: List[Slice] = []
    pack_tokens = 0

    def flush_pack() -> None:
        nonlocal pack, pack_tokens
        if pack:
            chunks.append(Chunk(kind=ChunkKind.BATCHED, context=0,
                                slices=tuple(pack)))
            pack, pack_tokens = [], 0

    for sid in order:
        ln = lengths[sid]
        if ln > slice_len:
            ids = []
            off = 0
            while off < ln:
                cur = min(slice_len, ln - off)
                sl = Slice(seq_id=sid, start=off, length=cur,
                           is_tail=(off + cur == ln))
                chunks.append(Chunk(kind=ChunkKind.SPLIT, context=off,
                                    slices=(sl,)))
                ids.append(len(chunks) - 1)
                off += cur
            seqinfos.append(SequenceInfo(sid, ln, len(ids), ids))
        else:
            if pack_tokens + ln > slice_len:
                flush_pack()
            pack.append(Slice(seq_id=sid, start=0, length=ln, is_tail=True))
            pack_tokens += ln
            seqinfos.append(SequenceInfo(sid, ln, 1, []))
    flush_pack()
    # fix chunk ids for packed sequences
    for ci, c in enumerate(chunks):
        for sl in c.slices:
            for si in seqinfos:
                if si.seq_id == sl.seq_id and not si.chunk_ids:
                    si.chunk_ids = [ci]
    return ChunkingResult(chunks=chunks, sequences=seqinfos,
                          mesh=[slice_len] * k, t_t=0.0, t_m=slice_len,
                          k_split=k)
