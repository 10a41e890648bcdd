"""Schedule backends, 1F1B schedule construction, chunks-window
enumeration, and pipeline simulators.

A copy of the JAX package's ``core/schedule.py`` (pure Python and NumPy;
same outputs, which ``tests/test_torch_planner.py`` holds equal).

Four consumers:

1. :class:`ScheduleSpec` / :func:`get_schedule` name a pipeline schedule
   backend (``gpipe-1f1b``, ``interleaved-1f1b``, ``zero-bubble-h1``) and
   own its *executor geometry*: the forward ``lax.scan`` tick count, the
   per-tick ``(item, virtual-stage)`` mapping every device follows, and the
   bubble fraction both imply. :func:`simulate_occupancy` replays the
   mapping tick by tick (the parity oracle the executor is tested against)
   and :func:`simulate_schedule` is a unit-duration event simulator that
   also models zero-bubble B-grad/W-grad splitting.
2. :func:`enumerate_windows` feeds Alg. 2's ILP the distinct chunks windows
   ``W_p(t)`` (Eq. 7-8). Window *content* is duration-independent — it only
   depends on the per-stage op order, which the 1F1B policy fixes — so the
   ILP never needs timing.
3. :func:`build_schedule` emits the per-stage tick list the executor and the
   simulator share.
4. :class:`PipelineSimulator` is an event-driven simulator with true chunk
   durations (from the cost model) and token-level-PP dependencies. It
   produces makespan, per-stage bubble ratios, a time breakdown
   (compute / SP-comm / P2P / bubble / recompute) and per-stage peak memory —
   the measurement substrate for the paper-figure benchmarks (Figs. 7-12)
   and the straggler-mitigation loop.

Token-level PP dependency (§II-A): forward of slice i must follow forward of
slices < i of the same sequence; backward of slice i must follow backward of
slices > i. Both are encoded via the fwd order (slices emitted causally) and
the ``f2b`` map (slices reversed within each sequence).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Callable, Dict, FrozenSet, List, Optional, Sequence, Set,
                    Tuple)

from .costs import CostModel
from .plan import Chunk, Tick, TickOp

__all__ = [
    "ScheduleSpec",
    "Occupancy",
    "available_schedules",
    "get_schedule",
    "register_schedule",
    "stream_perm",
    "simulate_occupancy",
    "simulate_schedule",
    "candidate_schedules",
    "choose_schedule",
    "rank_schedule",
    "schedule_tiebreak",
    "backward_order",
    "enumerate_windows",
    "build_schedule",
    "PipelineSimulator",
    "SimResult",
]

# fraction of one backward pass that is weight-grad work (dgrad ~= wgrad for
# matmul-dominated transformer layers) — the zero-bubble split point
WGRAD_FRACTION = 0.5

# Executor capability: the compiled step realizes the B-grad/W-grad split for
# ``split_bwd`` backends (runtime/executor.py's split-backward stage wrapper +
# W-drain tick map). With this on, ``realized_bubble_time`` prices ZB-H1's
# W-grad fill instead of collapsing it to plain 1F1B — tests monkeypatch it
# to model executors without the split path.
SPLIT_BWD_REALIZED = True


# ---------------------------------------------------------------------------
# Schedule backends.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScheduleSpec:
    """One named pipeline schedule backend over the StageProgram executor.

    A spec owns the *geometry* a schedule imposes on the executor's lockstep
    forward scan:

    * :meth:`scan_ticks` — how many ticks the ``lax.scan`` runs;
    * :meth:`tick_coords` — which ``(item, virtual-stage)`` device ``p``
      works on at tick ``t`` (the mapping the executor mirrors in traced
      arithmetic — ``tests/test_schedule_backends.py`` keeps them equal);
    * :meth:`scan_bubble_fraction` — the fraction of ``(device, tick)``
      slots that are bubbles, i.e. the compiled-FLOPs inflation of the
      lockstep-SPMD program (``(n + d_p - 1)/n`` for plain 1F1B);
    * :meth:`bubble_time` — the per-stage idle seconds of one fwd+bwd
      iteration under schedule theory, the planner's selection objective.

    ``v`` is the number of virtual stages per device (``interleaved-1f1b``;
    1 otherwise). ``split_bwd`` marks zero-bubble schedules whose backward
    splits into a B-grad (activation-grad) tick on the critical path and a
    W-grad (weight-grad) tick that fills trailing bubbles.
    """

    name: str
    v: int = 1
    split_bwd: bool = False

    def __post_init__(self) -> None:
        if self.v < 1:
            raise ValueError(f"v must be >= 1, got {self.v}")

    # -- executor geometry --------------------------------------------------
    def n_groups(self, n_items: int, d_p: int) -> int:
        """Interleaved round-robin groups: microbatches advance through the
        ``v * d_p`` virtual-stage ring in groups of ``d_p``."""
        return -(-n_items // d_p) if n_items > 0 else 0

    def scan_ticks(self, n_items: int, d_p: int) -> int:
        """Tick count of the executor's forward ``lax.scan``.

        ``v == 1``: the classic ``n + d_p - 1``. ``v > 1``: every device
        runs each item once per virtual stage (``n * v`` useful ticks,
        rounded up to whole groups) plus the ``d_p - 1`` fill diagonal —
        each tick now being ``1/v`` of a stage, which is where interleaving
        wins: the fill is paid in short ticks.
        """
        if n_items <= 0:
            return 0
        if self.v == 1:
            return n_items + d_p - 1
        return self.n_groups(n_items, d_p) * self.v * d_p + d_p - 1

    def drain_ticks(self, n_items: int, d_p: int) -> int:
        """W-grad drain ticks appended to the tick map by ``split_bwd``
        backends: one per (item, virtual stage) a device runs. In the
        compiled program these are a primal no-op scan *preceding* the
        forward scan whose autodiff transpose runs *after* every B-grad
        tick — the backward cooldown — popping the per-item weight-grad
        stash (see runtime/executor.py). Zero for fused backends."""
        if not self.split_bwd or n_items <= 0:
            return 0
        return n_items * self.v

    def total_ticks(self, n_items: int, d_p: int) -> int:
        """Forward-scan ticks plus the split-backward drain ticks — the
        tick count of the whole stage program."""
        return self.scan_ticks(n_items, d_p) + self.drain_ticks(n_items, d_p)

    def tick_coords(self, t: int, p: int, n_items: int,
                    d_p: int) -> Tuple[int, int, bool]:
        """``(item, v_idx, valid)`` device ``p`` handles at forward tick
        ``t``. Pure-python mirror of the executor's traced mapping.

        ``v == 1``: the classic diagonal ``item = t - p``. ``v > 1``: with
        wave index ``u = t - p``, round ``r = u // d_p`` and in-round
        offset ``q = u % d_p``, the device runs local virtual stage
        ``j = r % v`` on item ``m = (r // v) * d_p + q`` — i.e. microbatches
        advance through the ``v * d_p`` virtual-stage ring (global virtual
        stage ``j * d_p + p``) in round-robin groups of ``d_p``.
        """
        u = t - p
        if self.v == 1:
            return u, 0, (0 <= u < n_items)
        lim = self.n_groups(n_items, d_p) * self.v * d_p
        if not 0 <= u < lim:
            return -1, 0, False
        r, q = divmod(u, d_p)
        j = r % self.v
        m = (r // self.v) * d_p + q
        return m, j, m < n_items

    # -- bubble models ------------------------------------------------------
    def scan_bubble_fraction(self, n_items: int, d_p: int) -> float:
        """Bubble share of the lockstep forward scan: wasted
        ``(device, tick)`` slots over total. Useful ticks per device are
        ``n * v`` (each item visits each of the device's virtual stages
        once); everything else computes masked garbage. Equal to what
        :func:`simulate_occupancy` measures — tested."""
        ticks = self.scan_ticks(n_items, d_p)
        if ticks <= 0:
            return 0.0
        return 1.0 - (n_items * self.v) / ticks

    def bubble_time(self, n_items: int, d_p: int, t_f: float, t_b: float,
                    t_w: Optional[float] = None) -> float:
        """Per-stage idle seconds of one fwd+bwd iteration — the planner's
        schedule-selection objective.

        * ``gpipe-1f1b``: the classic ``(d_p - 1) * (t_f + t_b)`` ramp.
        * ``interleaved-1f1b``: every wasted scan slot costs ``1/v`` of a
          stage's fwd+bwd, so ``wasted * (t_f + t_b) / v`` — the
          ``(d_p - 1)/v`` Megatron interleaving gain, plus the exact
          group-padding waste when ``d_p`` does not divide ``n``.
        * ``zero-bubble-h1``: B splits into B-grad (``t_b - t_w``, critical
          path) and W-grad (``t_w``, fills the cooldown), leaving
          ``(d_p - 1) * (t_f + t_b - 2 t_w)`` — one third of 1F1B's bubble
          at ``t_b = 2 t_f``, ``t_w = t_b / 2`` (ZB-H1).
        """
        if n_items <= 0 or d_p <= 1:
            return 0.0
        if self.split_bwd:
            if t_w is None:
                t_w = WGRAD_FRACTION * t_b
            return (d_p - 1) * max(t_f + t_b - 2.0 * t_w, 0.0)
        wasted = self.scan_ticks(n_items, d_p) - n_items * self.v
        return wasted * (t_f + t_b) / self.v

    def bubble_fraction(self, n_items: int, d_p: int, t_f: float = 1.0,
                        t_b: float = 2.0,
                        t_w: Optional[float] = None) -> float:
        """``bubble_time`` normalized by per-stage makespan (work + idle)."""
        work = n_items * (t_f + t_b)
        if work <= 0:
            return 0.0
        bub = self.bubble_time(n_items, d_p, t_f, t_b, t_w)
        return bub / (work + bub)

    def realized_bubble_time(self, n_items: int, d_p: int, t_f: float,
                             t_b: float, t_w: Optional[float] = None,
                             split_realized: Optional[bool] = None) -> float:
        """Per-stage idle seconds the lockstep-SPMD executor actually
        realizes: wasted scan slots at ``1/v`` of a stage's fwd+bwd each.

        For ``split_bwd`` backends this is backend-capability-aware
        (``split_realized``, default the module's
        :data:`SPLIT_BWD_REALIZED`). With the split compiled
        (runtime/executor.py): B-grad ticks genuinely drop the weight-grad
        work from the critical path and the W-drain ticks are bubble-free
        (stash slots hold real items only), but the lockstep scan cannot
        retask its own (d_p - 1) cooldown garbage B-ticks — every tick runs
        the same HLO — so the realized bubble is

            (d_p - 1) * (t_f + t_b - t_w)

        sitting between :meth:`bubble_time`'s ideal
        ``(d_p - 1) * (t_f + t_b - 2 t_w)`` (free-form W placement) and
        plain 1F1B's ``(d_p - 1) * (t_f + t_b)``; the two converge as the
        weight-grad share shrinks — exactly the long-context regime, where
        attention dgrad is O(T^2 d) but wgrad only O(T d^2). Without the
        capability, W stays fused in the autodiff transpose and the
        realized bubble equals plain 1F1B's. The planner's default pick
        ranks by THIS, so a modeled-but-unpaid advantage can never shadow
        interleaving's real one.
        """
        if n_items <= 0 or d_p <= 1:
            return 0.0
        if split_realized is None:
            split_realized = SPLIT_BWD_REALIZED
        if self.split_bwd and split_realized:
            if t_w is None:
                t_w = WGRAD_FRACTION * t_b
            return (d_p - 1) * max(t_f + t_b - t_w, 0.0)
        wasted = self.scan_ticks(n_items, d_p) - n_items * self.v
        return wasted * (t_f + t_b) / self.v

    def comm_overhead_time(self, n_items: int, d_p: int,
                           t_p2p: float) -> float:
        """Extra stream hand-off seconds vs the ``v = 1`` diagonal.

        Interleaving sends the same activations around the ring once per
        virtual stage (forward + the backward transpose), so every scan
        tick beyond the ``n + d_p - 1`` baseline pays one more chunk
        hand-off each way — the price that caps how far raising ``v``
        keeps paying off.
        """
        if n_items <= 0 or d_p <= 1:
            return 0.0
        extra = self.scan_ticks(n_items, d_p) - (n_items + d_p - 1)
        return 2.0 * extra * t_p2p


_SCHEDULE_REGISTRY: Dict[str, Callable[[int], ScheduleSpec]] = {}


def register_schedule(name: str,
                      factory: Callable[[int], ScheduleSpec]) -> None:
    """Register a schedule backend: ``factory(v) -> ScheduleSpec``."""
    _SCHEDULE_REGISTRY[name] = factory


def available_schedules() -> Tuple[str, ...]:
    return tuple(sorted(_SCHEDULE_REGISTRY))


def get_schedule(name: str, v: int = 1) -> ScheduleSpec:
    """Resolve a schedule name (+ virtual-stage count) to its spec."""
    try:
        factory = _SCHEDULE_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; known: {available_schedules()}")
    return factory(v)


def _mk_gpipe(v: int) -> ScheduleSpec:
    if v != 1:
        raise ValueError("gpipe-1f1b has no virtual stages (v must be 1)")
    return ScheduleSpec("gpipe-1f1b")


def _mk_interleaved(v: int) -> ScheduleSpec:
    return ScheduleSpec("interleaved-1f1b", v=v)


def _mk_zb_h1(v: int) -> ScheduleSpec:
    if v != 1:
        raise ValueError("zero-bubble-h1 has no virtual stages (v must be 1)")
    return ScheduleSpec("zero-bubble-h1", split_bwd=True)


register_schedule("gpipe-1f1b", _mk_gpipe)
register_schedule("interleaved-1f1b", _mk_interleaved)
register_schedule("zero-bubble-h1", _mk_zb_h1)


def stream_perm(d_p: int, *, ring: bool = False) -> List[Tuple[int, int]]:
    """(src, dst) pairs of the stage hand-off ppermute: every stream
    moves stage ``p -> p + 1``; ``ring=True`` closes the loop
    (``d_p - 1 -> 0``) for interleaved virtual-stage routing.

    This is the single definition both the executor
    (``runtime/executor.ppermute_streams``) and the plan lint pass
    (``lint/plan_checks``: ``plan-ppermute-ring``) consume, so the
    audited permutation is by construction the one that runs."""
    if d_p <= 1:
        return []
    if ring:
        return [(i, (i + 1) % d_p) for i in range(d_p)]
    return [(i, i + 1) for i in range(d_p - 1)]


@dataclass
class Occupancy:
    """Tick-by-tick forward-scan occupancy of one schedule backend."""

    spec: ScheduleSpec
    n_items: int
    d_p: int
    # grid[t][p] = (item, v_idx) or None for a bubble slot
    grid: List[List[Optional[Tuple[int, int]]]]

    @property
    def total_slots(self) -> int:
        return len(self.grid) * self.d_p

    @property
    def useful_slots(self) -> int:
        return sum(1 for row in self.grid for cell in row if cell is not None)

    @property
    def bubble_fraction(self) -> float:
        return (1.0 - self.useful_slots / self.total_slots
                if self.total_slots else 0.0)

    def render(self) -> str:
        """ASCII tick-occupancy diagram (stages as rows, ticks as columns):
        ``m`` for item m at v_idx 0, ``m'``/``m"`` for higher virtual
        stages, ``.`` for bubbles."""
        marks = ["", "'", '"', "`"]
        lines = []
        for p in range(self.d_p):
            cells = []
            for t in range(len(self.grid)):
                cell = self.grid[t][p]
                if cell is None:
                    cells.append(".")
                else:
                    m, j = cell
                    cells.append(f"{m}{marks[j % len(marks)]}")
            lines.append(f"p{p}: " + " ".join(f"{c:>3}" for c in cells))
        return "\n".join(lines)


def simulate_occupancy(spec: ScheduleSpec, n_items: int,
                       d_p: int) -> Occupancy:
    """Replay ``spec.tick_coords`` over the whole forward scan.

    Verifies the mapping is a schedule at all: every device handles every
    ``(item, v_idx)`` pair exactly once, virtual stages of one item run in
    causal ring order. Raises on violations — this is the oracle the traced
    executor mapping is tested against.
    """
    ticks = spec.scan_ticks(n_items, d_p)
    grid: List[List[Optional[Tuple[int, int]]]] = []
    seen: Dict[int, Set[Tuple[int, int]]] = {p: set() for p in range(d_p)}
    for t in range(ticks):
        row: List[Optional[Tuple[int, int]]] = []
        for p in range(d_p):
            m, j, valid = spec.tick_coords(t, p, n_items, d_p)
            if not valid:
                row.append(None)
                continue
            if not (0 <= m < n_items and 0 <= j < spec.v):
                raise ValueError(f"out-of-range coords {(m, j)} at {(t, p)}")
            if (m, j) in seen[p]:
                raise ValueError(f"device {p} repeats {(m, j)}")
            seen[p].add((m, j))
            row.append((m, j))
        grid.append(row)
    for p in range(d_p):
        if len(seen[p]) != n_items * spec.v:
            raise ValueError(
                f"device {p} covered {len(seen[p])} of "
                f"{n_items * spec.v} (item, v_idx) pairs")
    return Occupancy(spec, n_items, d_p, grid)


def simulate_schedule(spec: ScheduleSpec, n_items: int, d_p: int,
                      t_f: float = 1.0, t_b: float = 2.0,
                      t_w: Optional[float] = None) -> Dict[str, float]:
    """Event-driven fwd+bwd makespan of one schedule with uniform op
    durations — the validation substrate for :meth:`ScheduleSpec.bubble_time`.

    Dependencies: ``F(p, m)`` after ``F(p-1, m)``; ``B(p, m)`` (activation
    grad) after ``B(p+1, m)`` and the stage's own ``F``; ``W(p, m)`` (weight
    grad, ``split_bwd`` only) after ``B(p, m)``, schedulable whenever the
    stage would otherwise idle — ZB-H1's bubble filling. Virtual stages
    (``v > 1``) run on the global ``v * d_p`` ring with per-tick durations
    scaled by ``1/v``. Returns makespan, per-stage bubble time and fraction.
    """
    if n_items <= 0:
        return {"makespan": 0.0, "bubble_time": 0.0, "bubble_fraction": 0.0}
    v = spec.v
    if spec.split_bwd:
        if t_w is None:
            t_w = WGRAD_FRACTION * t_b
        dur = {"F": t_f, "B": t_b - t_w, "W": t_w}
    else:
        t_w = 0.0
        dur = {"F": t_f / v, "B": t_b / v}
    S = v * d_p  # virtual stages, stage s on device s % d_p
    f_done: Dict[Tuple[int, int], float] = {}
    b_done: Dict[Tuple[int, int], float] = {}
    w_left = {(s, m) for s in range(S) for m in range(n_items)} \
        if spec.split_bwd else set()
    nf = [0] * S           # next fwd item per virtual stage
    nb = [0] * S           # next bwd item per virtual stage
    free = [0.0] * d_p
    busy = [0.0] * d_p

    def f_ready(s: int, m: int) -> Optional[float]:
        if m >= n_items:
            return None
        return f_done.get((s - 1, m), 0.0) if s > 0 else 0.0

    def b_ready(s: int, m: int) -> Optional[float]:
        if m >= n_items or (s, m) not in f_done:
            return None
        return f_done[(s, m)] if s == S - 1 else b_done.get((s + 1, m))

    total_ops = n_items * S * (3 if spec.split_bwd else 2)
    done_ops = 0
    while done_ops < total_ops:
        # pick the globally earliest-startable op; per-device 1F1B priority:
        # once the Eq. 7 in-flight window fills (or fwds are exhausted) B
        # beats F at equal start times; W only fills otherwise-idle time.
        cands = []  # (start, priority, kind, s, m)
        for s in range(S):
            p = s % d_p
            cap = S - s  # Eq. 7 on the virtual-stage ring (N_split = 1)
            want_bwd = (nf[s] - nb[s]) >= cap or nf[s] >= n_items
            rb = b_ready(s, nb[s]) if nb[s] < n_items else None
            rf = f_ready(s, nf[s]) if nf[s] < n_items else None
            if rb is not None:
                cands.append((max(rb, free[p]), 0 if want_bwd else 1,
                              "B", s, nb[s]))
            if rf is not None:
                cands.append((max(rf, free[p]), 1 if want_bwd else 0,
                              "F", s, nf[s]))
        for (s, m) in w_left:
            rb = b_done.get((s, m))
            if rb is not None:
                cands.append((max(rb, free[s % d_p]), 2, "W", s, m))
        if not cands:
            raise RuntimeError("schedule simulator deadlock")
        start, _pri, kind, s, m = min(cands)
        p = s % d_p
        d = dur[kind]
        free[p] = start + d
        busy[p] += d
        done_ops += 1
        if kind == "F":
            f_done[(s, m)] = start + d
            nf[s] += 1
        elif kind == "B":
            b_done[(s, m)] = start + d
            nb[s] += 1
        else:
            w_left.discard((s, m))
    makespan = max(free)
    idle = sum(makespan - b for b in busy)
    return {
        "makespan": makespan,
        "bubble_time": idle / d_p,
        "bubble_fraction": idle / (d_p * makespan) if makespan else 0.0,
    }


def candidate_schedules(layers_per_stage: int, *,
                        schedule: Optional[str] = None,
                        v_stages: int = 0) -> List[ScheduleSpec]:
    """Candidate specs for schedule selection.

    Default (nothing pinned): every registered backend, interleaved swept
    over the divisors of ``layers_per_stage``. A pinned ``schedule``
    restricts to that backend (the ``v`` sweep stays on for interleaved
    unless ``v_stages`` pins it too). A pinned ``v_stages`` is honored
    strictly: ``1`` keeps only single-virtual-stage backends, ``> 1``
    implies interleaving at exactly that ``v`` (no other backend has
    virtual stages, so the pin cannot silently fall back to ``v = 1``).
    The one place both ``choose_schedule`` and the planner's consensus
    pick get their candidate set from.
    """
    l_s = max(1, layers_per_stage)
    divisors = [v for v in range(2, l_s + 1) if l_s % v == 0]
    if schedule == "interleaved-1f1b" or (schedule is None and v_stages > 1):
        vs = [v_stages] if v_stages > 0 else (divisors or [1])
        return [get_schedule("interleaved-1f1b", v) for v in vs]
    if schedule is not None:
        return [get_schedule(schedule, max(v_stages, 1))]  # validates
    vs = divisors if v_stages == 0 else []  # explicit v=1: no interleaving
    return ([get_schedule("gpipe-1f1b"), get_schedule("zero-bubble-h1")]
            + [get_schedule("interleaved-1f1b", v) for v in vs])


def schedule_tiebreak(spec: ScheduleSpec) -> Tuple[int, str]:
    """Equal-bubble tie-break: fewer virtual stages, then the plain backend
    (stable bucket keys). Since the executor compiles the B/W split
    (:data:`SPLIT_BWD_REALIZED`), zero-bubble-h1 normally wins or loses on
    its realized bubble and only reaches this tie-break at ``t_w == 0``."""
    return (spec.v, "" if spec.name == "gpipe-1f1b" else spec.name)


def rank_schedule(spec: ScheduleSpec, n_items: int, d_p: int, t_f: float,
                  t_b: float, t_p2p: float = 0.0, *,
                  realized: bool = True,
                  t_w: Optional[float] = None) -> Tuple[float, int, str]:
    """Schedule-selection sort key: lower (bubble + extra hand-off) cost
    first (the *realized* executor bubble by default — see
    ``realized_bubble_time``, which prices split-backward backends'
    W-grad fill whenever the executor compiles it; ``t_p2p`` charges
    interleaving's extra ring trips), then :func:`schedule_tiebreak`.
    ``t_w`` overrides the default ``WGRAD_FRACTION * t_b`` weight-grad
    share for split backends."""
    bub = (spec.realized_bubble_time(n_items, d_p, t_f, t_b, t_w) if realized
           else spec.bubble_time(n_items, d_p, t_f, t_b, t_w))
    bub += spec.comm_overhead_time(n_items, d_p, t_p2p)
    return (bub, *schedule_tiebreak(spec))


def choose_schedule(cm: CostModel, chunks: Sequence[Chunk], *,
                    layers_per_stage: Optional[int] = None,
                    candidates: Optional[Sequence[ScheduleSpec]] = None,
                    avg_times: Optional[Tuple[float, float]] = None,
                    avg_p2p: Optional[float] = None,
                    realized: bool = True) -> ScheduleSpec:
    """Pick the min-cost schedule backend for one pipeline.

    Average per-stage fwd/bwd chunk times and the per-chunk hand-off time
    come from the cost model (Eq. 1-4, :meth:`CostModel.t_p2p`) unless
    precomputed ``avg_times``/``avg_p2p`` are passed in; candidates default
    to every registered backend, with interleaved tried at every ``v`` that
    divides ``layers_per_stage`` (virtual stages must split a stage's layer
    block evenly). Ranking uses the *realized* executor bubble by default
    (``realized=False`` ranks by the modeled bubble instead, where ZB-H1's
    W-grad fill counts) plus interleaving's extra ring-trip communication;
    ties break toward ``gpipe-1f1b``.
    """
    n = len(chunks)
    d_p = cm.cluster.d_p
    if candidates is None:
        l_s = (layers_per_stage if layers_per_stage is not None
               else max(1, -(-cm.model.n_layers // d_p)))
        candidates = candidate_schedules(l_s)
    if n == 0 or d_p <= 1:
        return get_schedule("gpipe-1f1b")
    t_f, t_b = avg_times if avg_times is not None \
        else cm.avg_stage_times(chunks)
    t_p = avg_p2p if avg_p2p is not None \
        else sum(cm.t_p2p(c) for c in chunks) / n
    return min(candidates,
               key=lambda s: rank_schedule(s, n, d_p, t_f, t_b, t_p,
                                           realized=realized))


def backward_order(chunks: Sequence[Chunk]) -> List[int]:
    """f2b: fwd index -> bwd index. Slices of one sequence reverse; everything
    else keeps its fwd position (Fig. 2 semantics)."""
    n = len(chunks)
    f2b = [0] * n
    # group consecutive chunks belonging to the same long sequence
    i = 0
    pos = 0
    while i < n:
        sid = chunks[i].seq_id
        j = i
        if sid is not None:
            while j + 1 < n and chunks[j + 1].seq_id == sid:
                j += 1
        # fwd block [i..j] maps to bwd block [pos..pos+(j-i)] reversed
        blk = j - i + 1
        for t in range(blk):
            f2b[i + t] = pos + (blk - 1 - t)
        pos += blk
        i = j + 1
    return f2b


def window_limit(d_p: int, stage: int, n_split: int) -> int:
    """Eq. 7: |W_p| = d_p - p + N_split (stage is 1-based)."""
    return d_p - stage + n_split


def _stage_op_order(n: int, d_p: int, stage: int, n_split: int,
                    f2b: Sequence[int]) -> List[Tick]:
    """Per-stage op order under the 1F1B policy with in-flight cap Eq. 7.

    Forward ops run in fwd-index order; backward ops in bwd-index order; a
    backward with bwd index j requires its fwd done at this stage. The stage
    runs fwds until the in-flight cap, then strictly alternates B, F while
    both remain, then drains the remaining Bs (cooldown).
    """
    cap = max(1, window_limit(d_p, stage, n_split))
    b2f = [0] * n
    for f, b in enumerate(f2b):
        b2f[b] = f
    order: List[Tick] = []
    nf = nb = 0
    resident: Set[int] = set()
    while nb < n:
        want_bwd = (nf - nb) >= cap or nf == n
        if want_bwd and b2f[nb] in resident:
            resident.discard(b2f[nb])
            order.append(Tick(TickOp.BWD, b2f[nb]))
            nb += 1
        elif nf < n:
            resident.add(nf)
            order.append(Tick(TickOp.FWD, nf))
            nf += 1
        else:
            # forced wait: next bwd's fwd not yet at this stage (cannot happen
            # with in-order fwds since b2f[nb] < nf required; guard anyway)
            if b2f[nb] in resident or b2f[nb] < nf:
                resident.discard(b2f[nb])
                order.append(Tick(TickOp.BWD, b2f[nb]))
                nb += 1
            else:  # pragma: no cover - defensive
                raise RuntimeError("deadlocked schedule")
    return order


def build_schedule(n_chunks: int, d_p: int, n_split: int,
                   f2b: Sequence[int]) -> List[List[Tick]]:
    """Per-stage (1-based stages stored at index p-1) op order."""
    return [
        _stage_op_order(n_chunks, d_p, p, n_split, f2b)
        for p in range(1, d_p + 1)
    ]


def enumerate_windows(n_chunks: int, d_p: int, n_split: int,
                      f2b: Sequence[int]) -> List[List[FrozenSet[int]]]:
    """Distinct chunks windows per stage: the resident set right after each
    forward (the per-stage activation peaks Eq. 8 constrains)."""
    out: List[List[FrozenSet[int]]] = []
    for p in range(1, d_p + 1):
        order = _stage_op_order(n_chunks, d_p, p, n_split, f2b)
        resident: Set[int] = set()
        seen: Set[FrozenSet[int]] = set()
        windows: List[FrozenSet[int]] = []
        for t in order:
            if t.op is TickOp.FWD:
                resident.add(t.chunk)
                fs = frozenset(resident)
                if fs not in seen:
                    seen.add(fs)
                    windows.append(fs)
            else:
                resident.discard(t.chunk)
        out.append(windows)
    return out


# ---------------------------------------------------------------------------
# Event-driven simulator.
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    makespan: float
    bubble_ratio: float                 # aggregate idle / (d_p * makespan)
    per_stage_busy: List[float]
    per_stage_peak_mem: List[float]     # bytes (activations + model states)
    breakdown: Dict[str, float]         # compute / sp_comm / p2p / recompute / bubble
    op_times: Dict[Tuple[int, str, int], Tuple[float, float]]  # (stage,op,chunk)->(t0,t1)

    @property
    def total_device_time(self) -> float:
        return self.makespan * len(self.per_stage_busy)


class PipelineSimulator:
    """Cycle-accurate 1F1B simulation of one pipeline on ``d_p`` stages.

    Durations come from the cost model (per-stage fwd / bwd + SP comm +
    recompute per the ckpt table); stage boundaries add a P2P latency for the
    boundary activation. ``stage_slowdowns`` in the cost model propagate here,
    which is how straggler-aware replanning closes the loop.
    """

    def __init__(self, cm: CostModel, chunks: Sequence[Chunk],
                 f2b: Sequence[int], n_split: int,
                 ckpt: Optional[Sequence[Sequence[int]]] = None) -> None:
        self.cm = cm
        self.chunks = list(chunks)
        self.f2b = list(f2b)
        self.n_split = max(1, n_split)
        self.d_p = cm.cluster.d_p
        n = len(chunks)
        self.ckpt = ([[0] * n for _ in range(self.d_p)]
                     if ckpt is None else [list(r) for r in ckpt])
        self.b2f = [0] * n
        for f, b in enumerate(self.f2b):
            self.b2f[b] = f

    # -- durations ----------------------------------------------------------
    def _p2p_time(self, chunk: Chunk) -> float:
        return self.cm.t_p2p(chunk)

    def _dur(self, stage: int, op: TickOp, k: int) -> Tuple[float, float, float]:
        """(compute_s, sp_comm_s, recompute_s) for chunk k at 1-based stage.

        A straggler stage slows everything it executes — its compute AND the
        collectives it participates in — so the stage slowdown multiplies the
        whole op duration here.
        """
        c = self.chunks[k]
        slow = self.cm._slowdown(stage)
        if op is TickOp.FWD:
            comp = self.cm.t_comp(c, per_stage=True, stage=stage)
            comm = slow * self.cm.t_sp_comm(c, per_stage=True)
            return comp, comm, 0.0
        comp = self.cm.t_comp_bwd(c, per_stage=True, stage=stage)
        comm = slow * 2.0 * self.cm.t_sp_comm(c, per_stage=True)
        l = self.ckpt[stage - 1][k]
        rec = slow * (self.cm.t_recompute(c, l) / self.d_p) if l else 0.0
        return comp, comm, rec

    # -- run ------------------------------------------------------------------
    def run(self) -> SimResult:
        n = len(self.chunks)
        d_p = self.d_p
        orders = build_schedule(n, d_p, self.n_split, self.f2b)
        ptr = [0] * d_p                       # next op index per stage
        stage_free = [0.0] * d_p
        fwd_done: Dict[Tuple[int, int], float] = {}   # (stage, chunk) -> t
        bwd_done: Dict[Tuple[int, int], float] = {}
        op_times: Dict[Tuple[int, str, int], Tuple[float, float]] = {}
        busy = [0.0] * d_p
        breakdown = {"compute": 0.0, "sp_comm": 0.0, "p2p": 0.0,
                     "recompute": 0.0, "bubble": 0.0}

        def ready_time(p: int, t: Tick) -> Optional[float]:
            """Earliest start honoring cross-stage deps; None if dep missing."""
            k = t.chunk
            if t.op is TickOp.FWD:
                if p == 0:
                    return stage_free[p]
                dep = fwd_done.get((p - 1, k))
                if dep is None:
                    return None
                return max(stage_free[p], dep + self._p2p_time(self.chunks[k]))
            # BWD: needs bwd at stage p+1 and own fwd at p
            own = fwd_done.get((p, k))
            if own is None:
                return None
            if p == d_p - 1:
                return max(stage_free[p], own)
            dep = bwd_done.get((p + 1, k))
            if dep is None:
                return None
            return max(stage_free[p], own, dep + self._p2p_time(self.chunks[k]))

        remaining = sum(len(o) for o in orders)
        guard = 0
        while remaining > 0:
            guard += 1
            if guard > 8 * remaining + 64 + 8 * n * d_p:
                raise RuntimeError("simulator livelock — bad schedule")
            progressed = False
            # pick the stage whose next op can start earliest
            best: Optional[Tuple[float, int]] = None
            for p in range(d_p):
                if ptr[p] >= len(orders[p]):
                    continue
                rt = ready_time(p, orders[p][ptr[p]])
                if rt is None:
                    continue
                if best is None or rt < best[0]:
                    best = (rt, p)
            if best is None:  # pragma: no cover - defensive
                raise RuntimeError("deadlock: no ready op")
            rt, p = best
            t = orders[p][ptr[p]]
            comp, comm, rec = self._dur(p + 1, t.op, t.chunk)
            dur = comp + comm + rec
            start = rt
            end = start + dur
            breakdown["compute"] += comp
            breakdown["sp_comm"] += comm
            breakdown["recompute"] += rec
            if (t.op is TickOp.FWD and p > 0) or (t.op is TickOp.BWD and p < d_p - 1):
                breakdown["p2p"] += self._p2p_time(self.chunks[t.chunk])
            busy[p] += dur
            stage_free[p] = end
            if t.op is TickOp.FWD:
                fwd_done[(p, t.chunk)] = end
            else:
                bwd_done[(p, t.chunk)] = end
            op_times[(p + 1, t.op.value, t.chunk)] = (start, end)
            ptr[p] += 1
            remaining -= 1
            progressed = True
            if not progressed:  # pragma: no cover
                raise RuntimeError("no progress")

        makespan = max(stage_free)
        idle = sum(makespan - b for b in busy)
        breakdown["bubble"] = idle
        peak = self._peak_memory(orders)
        return SimResult(
            makespan=makespan,
            bubble_ratio=idle / (d_p * makespan) if makespan > 0 else 0.0,
            per_stage_busy=busy,
            per_stage_peak_mem=peak,
            breakdown=breakdown,
            op_times=op_times,
        )

    def _peak_memory(self, orders: List[List[Tick]]) -> List[float]:
        """Per-stage peak bytes under Eq. 8 with the solved ckpt table."""
        peaks: List[float] = []
        for p in range(1, self.d_p + 1):
            ms = self.cm.m_model_states(p)
            cur = ms
            pk = ms
            for t in orders[p - 1]:
                l = self.ckpt[p - 1][t.chunk]
                m = self.cm.m_act(p, self.chunks[t.chunk], l)
                if t.op is TickOp.FWD:
                    cur += m
                    pk = max(pk, cur)
                else:
                    cur -= m
            peaks.append(pk)
        return peaks
