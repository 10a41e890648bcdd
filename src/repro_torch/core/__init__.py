"""Host-side solver stack: specs, cost model, chunking, the checkpointing
ILP, grouping, schedules and the planner (pure Python and NumPy; no
torch). A copy of the JAX package's ``core``, with the cluster defaults of
one NVIDIA H100."""

from .plan import (BucketKey, Chunk, ChunkKind, ClusterSpec, Coefficients,
                   ExecutionPlan, ModelSpec, PipelinePlan, SequenceInfo,
                   Slice, Tick, TickOp)
from .sp import (SPConfig, SP_POLICIES, choose_sp_policy, legal_degrees,
                 sp_candidates, sp_legal)
from .costs import CostModel, analytic_coefficients, fit_coefficients
from .chunking import (ChunkingResult, chunk_sequences, prompt_slices,
                       seq_workload)
from .ilp import IlpResult, greedy_cover, simplex_lp, solve_cover_ilp
from .checkpointing import (CkptSolution, diag_index, encoder_stage_split,
                            solve_checkpointing, stage_roles)
from .grouping import GroupingResult, group_sequences
from .schedule import (Occupancy, PipelineSimulator, ScheduleSpec, SimResult,
                       available_schedules, backward_order, build_schedule,
                       choose_schedule, enumerate_windows, get_schedule,
                       register_schedule, simulate_occupancy,
                       simulate_schedule, window_limit)
from .planner import PlannerConfig, estimate_plan_time, plan_batch

__all__ = [
    "BucketKey", "Chunk", "ChunkKind", "ClusterSpec", "Coefficients",
    "ExecutionPlan",
    "ModelSpec", "PipelinePlan", "SequenceInfo", "Slice", "Tick", "TickOp",
    "SPConfig", "SP_POLICIES", "choose_sp_policy", "legal_degrees",
    "sp_candidates", "sp_legal",
    "CostModel", "analytic_coefficients", "fit_coefficients",
    "ChunkingResult", "chunk_sequences", "prompt_slices", "seq_workload",
    "IlpResult", "greedy_cover", "simplex_lp", "solve_cover_ilp",
    "CkptSolution", "diag_index", "encoder_stage_split",
    "solve_checkpointing", "stage_roles",
    "GroupingResult", "group_sequences",
    "Occupancy", "PipelineSimulator", "ScheduleSpec", "SimResult",
    "available_schedules", "backward_order", "build_schedule",
    "choose_schedule", "enumerate_windows", "get_schedule",
    "register_schedule", "simulate_occupancy", "simulate_schedule",
    "window_limit",
    "PlannerConfig", "estimate_plan_time", "plan_batch",
]
