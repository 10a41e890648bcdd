"""Plan-level lint passes: solver/schedule invariants checked before a plan
runs (a copy of the plan passes of the JAX package's ``lint/plan_checks.py``;
the same findings on the same plans, which ``tests/test_torch_replan.py``
holds equal).

Everything here is pure Python (like ``repro_torch.core``) so the passes can
run on every new bucket at effectively zero cost:

* tick coverage: every (item, virtual stage) slot mapped exactly once;
* the remat table's geometry and digest;
* the stage hand-off permutation (``core.schedule.stream_perm``);
* bucket-key completeness: each plan axis that changes the program must
  move ``ExecutionPlan.bucket_key()`` (perturb each axis, demand the key
  moves), so two plans that run differently never share a bucket;
* sequence-parallel legality.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.schedule import (get_schedule, simulate_occupancy,
                                      stream_perm)
from repro_torch.core.sp import SP_POLICIES, SPConfig, sp_legal

from .registry import register_pass
from .report import SEV_ERROR, LintReport

__all__ = ["PlanContext", "run_plan_checks", "check_ppermute_perm",
           "check_bucket_key_completeness", "BUCKET_KEY_AXES"]

_DIGEST_RE = re.compile(r"^(u\d+|v[0-9a-f]{12})$")

# the plan axes bucket_key() must separate; see
# check_bucket_key_completeness for how each one is perturbed
BUCKET_KEY_AXES = ("schedule", "v_stages", "ckpt", "split_bwd", "dtype",
                   "sp")


@dataclass
class PlanContext:
    """Inputs one plan audit runs against."""

    plan: Any                   # repro_torch.core.plan.ExecutionPlan
    d_s: int
    d_p: int
    n_items: int = 0            # 0 => the key's rounded chunk count
    # kwargs forwarded to bucket_key() at the call site (split_bwd/dtype)
    key_kwargs: Dict[str, Any] = field(default_factory=dict)
    # optional: the ModelSpec the plan was solved for — enables the
    # model-dependent tier of plan-sp-legality (head divisibility, MLA,
    # attn-free). Without it only mesh-shape legality is checked.
    model: Any = None

    def resolved_n_items(self) -> int:
        if self.n_items:
            return self.n_items
        return self.plan.bucket_key(self.d_s, **self.key_kwargs).n_chunks


def run_plan_checks(plan, d_s: int, d_p: int, *, n_items: int = 0,
                    key_kwargs: Optional[Dict[str, Any]] = None,
                    model: Any = None) -> LintReport:
    """Run every registered plan pass against one ExecutionPlan."""
    from .registry import available_passes
    ctx = PlanContext(plan=plan, d_s=d_s, d_p=d_p, n_items=n_items,
                      key_kwargs=dict(key_kwargs or {}), model=model)
    report = LintReport(subject=repr(plan.bucket_key(d_s, **ctx.key_kwargs)))
    for p in available_passes():
        report.ran(p.name)
        try:
            p.fn(ctx, report)
        except Exception as e:  # noqa: BLE001 - a crashed pass is a finding
            report.add(p.name, SEV_ERROR,
                       f"pass crashed: {type(e).__name__}: {e}")
    return report


# ---------------------------------------------------------------------------
# tick coverage
# ---------------------------------------------------------------------------


@register_pass("plan-tick-coverage",
               doc="every (item, v_idx) slot mapped exactly once; drain "
                   "tick count matches n*v for split-backward schedules")
def _tick_coverage(ctx: PlanContext, report: LintReport) -> None:
    plan = ctx.plan
    try:
        spec = get_schedule(plan.schedule, plan.v_stages)
    except ValueError as e:
        report.add("plan-tick-coverage", SEV_ERROR,
                   f"schedule resolution failed: {e}",
                   where=f"{plan.schedule} v={plan.v_stages}")
        return
    n = ctx.resolved_n_items()
    try:
        # simulate_occupancy is the schedule oracle: it raises on
        # out-of-range coords, per-device repeats, and incomplete
        # (item, v_idx) coverage
        simulate_occupancy(spec, n, ctx.d_p)
    except ValueError as e:
        report.add("plan-tick-coverage", SEV_ERROR, str(e),
                   where=f"{spec.name} n={n} d_p={ctx.d_p}")
    if spec.split_bwd:
        drain = spec.drain_ticks(n, ctx.d_p)
        if drain != n * spec.v:
            report.add("plan-tick-coverage", SEV_ERROR,
                       f"split-backward drain must cover every W-grad "
                       f"slot: expected n*v = {n * spec.v} drain ticks, "
                       f"schedule reports {drain}",
                       where=f"{spec.name} n={n}")


# ---------------------------------------------------------------------------
# checkpoint table shape
# ---------------------------------------------------------------------------


@register_pass("plan-ckpt-table",
               doc="canonical remat table matches the mesh/bucket "
                   "geometry; digest well-formed")
def _ckpt_table(ctx: PlanContext, report: LintReport) -> None:
    n = ctx.resolved_n_items()
    l_max, table, digest = ctx.plan.ckpt_policy(n)
    if not _DIGEST_RE.match(digest):
        report.add("plan-ckpt-table", SEV_ERROR,
                   f"malformed remat digest {digest!r} (expected 'uN' or "
                   f"'v<sha12>')")
    if table is None:
        if not digest.startswith("u"):
            report.add("plan-ckpt-table", SEV_ERROR,
                       f"uniform policy must carry a 'uN' digest, got "
                       f"{digest!r}")
        return
    if len(table) != ctx.d_p:
        report.add("plan-ckpt-table", SEV_ERROR,
                   f"remat table has {len(table)} stage rows but the mesh "
                   f"runs d_p={ctx.d_p} stages (solved for a different "
                   f"pipeline depth?)", where=digest)
    for p, row in enumerate(table):
        if len(row) != n:
            report.add("plan-ckpt-table", SEV_ERROR,
                       f"stage {p} row has {len(row)} chunk columns, "
                       f"bucket holds {n}", where=digest)
            break
    flat = [v for row in table for v in row]
    bad = [v for v in flat if not isinstance(v, int) or v < 0]
    if bad:
        report.add("plan-ckpt-table", SEV_ERROR,
                   f"remat depths must be non-negative ints, got "
                   f"{bad[:4]}", where=digest)
    elif flat and max(flat) != l_max:
        report.add("plan-ckpt-table", SEV_ERROR,
                   f"l_ckpt={l_max} does not equal the table max "
                   f"{max(flat)} — the key would lie about peak remat",
                   where=digest)


# ---------------------------------------------------------------------------
# ppermute ring validity
# ---------------------------------------------------------------------------


def check_ppermute_perm(perm: List[Tuple[int, int]], d_p: int, *,
                        require_full: bool = False) -> List[str]:
    """Validate a ppermute (src, dst) pair list against ``d_p`` devices.

    ``require_full`` demands a total permutation (every device appears
    exactly once as source and once as destination) — the closed-ring
    hand-off interleaved schedules rely on. Returns a list of problem
    strings (empty == valid)."""
    problems: List[str] = []
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    for s, d in perm:
        if not (0 <= s < d_p) or not (0 <= d < d_p):
            problems.append(f"pair ({s}, {d}) out of range for d_p={d_p}")
    dup_src = sorted({s for s in srcs if srcs.count(s) > 1})
    dup_dst = sorted({d for d in dsts if dsts.count(d) > 1})
    if dup_src:
        problems.append(f"duplicate source device(s) {dup_src}: a device "
                        f"cannot send two streams in one ppermute")
    if dup_dst:
        problems.append(f"duplicate destination device(s) {dup_dst}: "
                        f"colliding writes clobber a stream")
    if require_full and (len(perm) != d_p or set(srcs) != set(range(d_p))
                         or set(dsts) != set(range(d_p))):
        problems.append(
            f"ring hand-off must be a total permutation of {d_p} "
            f"devices, got sources {sorted(set(srcs))} -> destinations "
            f"{sorted(set(dsts))}")
    return problems


@register_pass("plan-ppermute-ring",
               doc="stage hand-off permutation is a valid ring/shift for "
                   "the pipeline depth")
def _ppermute_ring(ctx: PlanContext, report: LintReport) -> None:
    plan, d_p = ctx.plan, ctx.d_p
    ring = plan.v_stages > 1  # interleaved routes d_p-1 -> 0
    perm = stream_perm(d_p, ring=ring)
    for msg in check_ppermute_perm(perm, d_p,
                                   require_full=ring and d_p > 1):
        report.add("plan-ppermute-ring", SEV_ERROR, msg,
                   where=f"d_p={d_p} ring={ring}")
    # the schedule's virtual-stage routing additionally needs the closed
    # ring even when this plan's consensus pick is v=1-capable
    if ring and d_p > 1:
        expected = [(i, (i + 1) % d_p) for i in range(d_p)]
        if sorted(perm) != sorted(expected):
            report.add("plan-ppermute-ring", SEV_ERROR,
                       f"interleaved hand-off must close the ring "
                       f"{expected}, got {perm}",
                       where=f"d_p={d_p}")


# ---------------------------------------------------------------------------
# bucket-key completeness
# ---------------------------------------------------------------------------


def _ckpt_variant(plan, cells: List[Tuple[int, int]]):
    """Deep-copied plan whose remat vector is zero except ``cells`` (each
    set to 1), in stage-aware mode — a digest-only perturbation: l_max
    stays 1, the vector (and so the 'v<sha>' digest) moves."""
    v = copy.deepcopy(plan)
    v.remat_mode = "stage_aware"
    if not v.pipelines:
        return None
    pipe = v.pipelines[0]
    n = max(pipe.n_chunks, 2)
    rows = max(len(pipe.ckpt), 2)
    pipe.ckpt = [[0] * n for _ in range(rows)]
    for r, c in cells:
        pipe.ckpt[r % rows][c % n] = 1
    return v


def check_bucket_key_completeness(plan, d_s: int, *,
                                  key_kwargs: Optional[Dict] = None,
                                  ) -> List[Tuple[str, str]]:
    """Perturb each plan axis and demand ``bucket_key()`` separates it.

    Returns ``(axis, problem)`` pairs. For each axis two plan variants
    are synthesized that differ *only* in that axis; if their keys
    collide the axis is invisible to the bucket key and plans would
    alias each other's buckets (the message keeps the reference's
    wording)."""
    import dataclasses

    kw = dict(key_kwargs or {})
    kw.pop("split_bwd", None)
    kw.pop("dtype", None)

    def variants(axis: str):
        if axis == "schedule":
            a = dataclasses.replace(plan, schedule="gpipe-1f1b", v_stages=1)
            b = dataclasses.replace(plan, schedule="interleaved-1f1b",
                                    v_stages=1)
            return (a, dict(kw, split_bwd=False, dtype="bfloat16")), \
                   (b, dict(kw, split_bwd=False, dtype="bfloat16"))
        if axis == "v_stages":
            a = dataclasses.replace(plan, schedule="interleaved-1f1b",
                                    v_stages=2)
            b = dataclasses.replace(plan, schedule="interleaved-1f1b",
                                    v_stages=4)
            return (a, dict(kw, split_bwd=False, dtype="bfloat16")), \
                   (b, dict(kw, split_bwd=False, dtype="bfloat16"))
        if axis == "ckpt":
            a = _ckpt_variant(plan, [(0, 0)])
            b = _ckpt_variant(plan, [(0, 1)])
            if a is None or b is None:
                return None
            kk = dict(kw, split_bwd=False, dtype="bfloat16")
            return (a, kk), (b, kk)
        if axis == "split_bwd":
            return (plan, dict(kw, split_bwd=False, dtype="bfloat16")), \
                   (plan, dict(kw, split_bwd=True, dtype="bfloat16"))
        if axis == "dtype":
            return (plan, dict(kw, split_bwd=False, dtype="bfloat16")), \
                   (plan, dict(kw, split_bwd=False, dtype="float32"))
        if axis == "sp":
            # two SP points that always differ in BOTH fields; legality
            # is irrelevant here — only key separation is probed
            a = dataclasses.replace(plan, sp=SPConfig("none", 1))
            b = dataclasses.replace(
                plan, sp=SPConfig("allgather_kv", max(d_s, 2)))
            kk = dict(kw, split_bwd=False, dtype="bfloat16")
            return (a, kk), (b, kk)
        raise ValueError(f"unknown bucket-key axis {axis!r}")

    problems: List[Tuple[str, str]] = []
    for axis in BUCKET_KEY_AXES:
        pair = variants(axis)
        if pair is None:
            continue  # empty plan: nothing to perturb
        (pa, ka), (pb, kb) = pair
        try:
            key_a = pa.bucket_key(d_s, **ka)
            key_b = pb.bucket_key(d_s, **kb)
        except TypeError as e:
            problems.append((axis, f"bucket_key() rejected the "
                                   f"{axis} perturbation kwargs: {e}"))
            continue
        if key_a != key_b:
            continue
        problems.append(
            (axis, f"perturbing {axis} does not change bucket_key() "
                   f"(key={key_a!r}); the compile cache cannot separate "
                   f"plans along this axis"))
    return problems


@register_pass("plan-bucket-key",
               doc="every plan axis (schedule, v_stages, ckpt digest, "
                   "split_bwd, dtype, sp) is visible to bucket_key()")
def _bucket_key(ctx: PlanContext, report: LintReport) -> None:
    for axis, msg in check_bucket_key_completeness(
            ctx.plan, ctx.d_s, key_kwargs=ctx.key_kwargs):
        report.add("plan-bucket-key", SEV_ERROR, msg, where=axis)


# ---------------------------------------------------------------------------
# sequence-parallel legality
# ---------------------------------------------------------------------------


@register_pass("plan-sp-legality",
               doc="plan's SP policy is known, the effective degree "
                   "divides the model axis, and (when the ModelSpec is "
                   "supplied) the policy is legal for the model")
def _sp_legality(ctx: PlanContext, report: LintReport) -> None:
    spc = getattr(ctx.plan, "sp", None)
    if spc is None:
        # legacy sp-less plan: bucket_key() resolves it to ("auto", d_s)
        # and the runtime rederives the policy at full degree — nothing
        # to validate
        return
    where = f"sp=({spc.policy}, {spc.d_s_eff}) d_s={ctx.d_s}"
    if spc.policy not in SP_POLICIES:
        report.add("plan-sp-legality", SEV_ERROR,
                   f"unknown SP policy {spc.policy!r} (expected one of "
                   f"{SP_POLICIES})", where=where)
        return
    if spc.d_s_eff < 1 or ctx.d_s % spc.d_s_eff:
        report.add("plan-sp-legality", SEV_ERROR,
                   f"effective SP degree {spc.d_s_eff} must divide the "
                   f"mesh's model-axis size {ctx.d_s} (sub-groups cannot "
                   f"tile the axis otherwise)", where=where)
        return
    if ctx.model is not None and not sp_legal(ctx.model, spc.policy,
                                              spc.d_s_eff):
        m = ctx.model
        report.add("plan-sp-legality", SEV_ERROR,
                   f"policy {spc.policy!r} is illegal at d_s_eff="
                   f"{spc.d_s_eff} for this model (heads={m.n_heads}/"
                   f"{m.n_kv_heads}, mla={m.kv_lora_rank > 0}, "
                   f"attn_free={m.attn_free}): ulysses needs divisible "
                   f"non-MLA heads, 'none' with attention needs degree 1, "
                   f"attn-free models shard only via 'none'", where=where)
