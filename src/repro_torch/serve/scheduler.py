"""Tick scheduler: co-schedule chunked prefill with decode streams.

Every engine step runs ONE fixed-shape batch of ``n_items`` packed token
chunks of ``cap_t`` tokens. The scheduler decides what goes
into that shape:

* **decode first** — each running request contributes one ``k``-token
  segment (last accepted token + drafts), admitted round-robin under
  ``decode_token_budget`` so no stream starves (TPOT bound);
* **prefill fills the rest** — waiting prompts are sliced by the trainer's
  capacity logic (``core.chunking.prompt_slices``) and as many next chunks
  as fit under ``prefill_token_budget`` ride along (TTFT bound). Several
  chunks of the SAME prompt may be co-scheduled in one step, but only in
  strictly increasing item indices, so chunk ``j`` sees chunk ``i``'s KV
  rows (in the port's single-device step both chunks share one segment
  id of the step's packed KV buffer — ``runtime.serve_step``).

``prefill_mode="serial"`` is the deliberately naive baseline the serving
benchmark contrasts: while any prompt is mid-prefill, decode is stopped
entirely (stop-the-world prefill — TPOT spikes under skewed traces).

Packing is first-fit over the ``n_items`` items with the per-request
item-ordering constraint; anything that does not fit this step is simply
deferred (nothing is ever truncated).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Segment", "SchedulerConfig", "StepPlan", "TickScheduler"]


@dataclass(frozen=True)
class Segment:
    """One contiguous run of tokens for one request inside one item."""
    req_id: int
    kind: str                    # "prefill" | "decode"
    tokens: Tuple[int, ...]      # fed token ids
    base: int                    # committed cache rows at step start
    # absolute position of tokens[0] in the sequence (== base: both decode
    # ticks and prefill chunks continue exactly where the cache ends).
    # Which KV pages back those rows is engine state (the per-request page
    # table), not scheduling state — the scheduler only packs tokens.

    @property
    def start(self) -> int:
        return self.base


@dataclass
class StepPlan:
    items: List[List[Segment]]
    decode_tokens: int = 0
    prefill_tokens: int = 0
    deferred_decode: int = 0     # decode streams pushed to the next step
    deferred_prefill: int = 0    # prefill chunks pushed to the next step

    @property
    def n_segments(self) -> int:
        return sum(len(it) for it in self.items)


@dataclass
class SchedulerConfig:
    n_items: int
    cap_t: int
    k: int = 1
    # token budgets per engine step; None = derived (decode gets what it
    # needs up to half the step, prefill gets the remainder)
    decode_token_budget: Optional[int] = None
    prefill_token_budget: Optional[int] = None
    prefill_mode: str = "interleaved"    # | "serial" (stop-the-world)

    def __post_init__(self):
        if self.prefill_mode not in ("interleaved", "serial"):
            raise ValueError(f"prefill_mode must be 'interleaved' or "
                             f"'serial', got {self.prefill_mode!r}")
        if self.k > self.cap_t:
            raise ValueError(f"k={self.k} exceeds cap_t={self.cap_t}")


class TickScheduler:
    def __init__(self, config: SchedulerConfig):
        self.config = config
        # round-robin anchor: the req_id of the stream served FIRST last
        # step (None before any decode ran). Keying the rotation on stable
        # req_id order — instead of an index advanced mod the CURRENT
        # stream count — keeps it fair when streams complete/join between
        # steps: an index pointer drifts with the population and can leave
        # one stream persistently ordered last (starvation; regression
        # test in tests/test_serve_engine.py).
        self._rr_last: Optional[int] = None

    # ------------------------------------------------------------------
    def plan(self, decode_candidates: Sequence[Segment],
             prefill_candidates: Sequence[Sequence[Segment]]) -> StepPlan:
        """``decode_candidates``: one k-token segment per running stream.
        ``prefill_candidates``: per waiting request, its REMAINING prompt
        chunks in causal order (a prefix of each list may be scheduled)."""
        c = self.config
        total_cap = c.n_items * c.cap_t
        plan = StepPlan(items=[[] for _ in range(c.n_items)])
        fill = [0] * c.n_items
        # a request's next segment may only land in items AFTER its
        # previous one (pipeline ordering makes the dependency real)
        min_item: Dict[int, int] = {}

        def place(seg: Segment) -> bool:
            lo = min_item.get(seg.req_id, 0)
            for i in range(lo, c.n_items):
                if fill[i] + len(seg.tokens) <= c.cap_t:
                    plan.items[i].append(seg)
                    fill[i] += len(seg.tokens)
                    min_item[seg.req_id] = i + 1
                    return True
            return False

        # ---- decode streams, round-robin under the decode budget -------
        dec = list(decode_candidates)
        if c.prefill_mode == "serial" and any(prefill_candidates):
            # stop-the-world: no decode while any prompt is mid-prefill
            plan.deferred_decode = len(dec)
            dec = []
        d_budget = c.decode_token_budget
        if d_budget is None:
            d_budget = total_cap if not any(prefill_candidates) \
                else max(c.k, total_cap // 2)
        if dec:
            # stable rotation: req_id order, starting just past the stream
            # served first last step (wrapping), so every stream reaches
            # the front within n steps no matter who completed meanwhile
            dec.sort(key=lambda s: s.req_id)
            start = 0
            if self._rr_last is not None:
                start = len(dec)
                for i, seg in enumerate(dec):
                    if seg.req_id > self._rr_last:
                        start = i
                        break
            order = [dec[(start + i) % len(dec)] for i in range(len(dec))]
            for seg in order:
                if plan.decode_tokens + len(seg.tokens) > d_budget \
                        or not place(seg):
                    plan.deferred_decode += 1
                    continue
                if plan.decode_tokens == 0:
                    # advance past the first stream actually SERVED (not
                    # merely considered) — a fully deferred step must not
                    # rotate the anchor
                    self._rr_last = seg.req_id
                plan.decode_tokens += len(seg.tokens)

        # ---- prefill chunks, FIFO under the prefill budget -------------
        p_budget = c.prefill_token_budget
        if p_budget is None:
            p_budget = total_cap - plan.decode_tokens
        for chunks in prefill_candidates:
            placed = 0
            for seg in chunks:
                if plan.prefill_tokens + len(seg.tokens) > p_budget \
                        or not place(seg):
                    # later chunks of this request depend on this one —
                    # defer the whole rest of the prompt, and COUNT every
                    # deferred chunk (the StepPlan field is a chunk count;
                    # one-per-request undercounted skewed traces)
                    break
                placed += 1
                plan.prefill_tokens += len(seg.tokens)
            plan.deferred_prefill += len(chunks) - placed
        return plan
