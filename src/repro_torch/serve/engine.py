"""Continuous-batching serving engine on a ``(d_p, d_s)`` mesh of pipeline
stages and sequence-parallel ranks (one GPU by default, ``1x1``).

Counterpart of the JAX package's ``serve/engine.py`` with the same request
lifecycle::

    submit() ──> waiting ──admit (page table + prefix match)──> prefill ──> decode ──> done
                   │                                              │            │
                   └── queue (pages short / budget) ──────────────┴── step() packs both
                       into ONE fixed-shape engine step

Every :meth:`ServeEngine.step` packs decode segments (``k`` tokens per
running stream — speculative drafts verified on the host) with
chunked-prefill segments (prompts sliced by ``core.chunking.
prompt_slices``) into one batch for :func:`repro_torch.runtime.serve_step.
engine_step`. KV rows live in a paged pool (``kv_manager.PagedKVPool`` on
the host with global page ids, the device buffer in ``runtime.serve_step``,
its pages sharded page-blockwise over the ranks): pages are allocated on
write, chunked prefill skips pages whose chain hash is already resident
(prefix cache), shared pages are refcounted and copy-on-write protected
(a copy may cross ranks). Prompt slices come from the cost model of the
engine's mesh (``ClusterSpec(d_p, d_s)``), as the reference's. The JAX
engine's compile cache and lint hook have no counterpart here: PyTorch
runs eagerly. Its telemetry does: with a ``timeline``
(``telemetry.StepTimeline``), :meth:`ServeEngine.run` records one
``engine`` event per drained trace (TTFT and TPOT percentiles,
occupancy), its ``bucket`` the engine geometry as a string.

:func:`one_shot_generate` is the parity oracle: a full teacher-forced
recompute of (prompt + generated-so-far) through ``DecoderLM.
forward_chunk`` for every emitted token — no KV reuse, no batching.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import ClusterSpec, CostModel, prompt_slices
from repro_torch.device import resolve_device
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import DecoderLM, tree_map
from repro_torch.runtime import sp
from repro_torch.runtime.serve_step import (PackedSegment, copy_pages,
                                            engine_step, greedy_ids,
                                            init_pool, make_engine_geometry,
                                            pack_step, pool_bytes)
from repro_torch.runtime.sharding import stage_devices
from repro_torch.weights import to_stages

from .kv_manager import PagedKVPool
from .scheduler import SchedulerConfig, Segment, StepPlan, TickScheduler
from .speculative import SpecStats, propose_draft, verify_greedy

__all__ = ["EngineConfig", "Request", "RequestResult", "ServeEngine",
           "one_shot_generate", "verify_against_one_shot"]

NEAR_TIE = 1e-4      # relative top-1/top-2 logit margin a verify tolerates


@dataclass
class EngineConfig:
    """Engine knobs: (n_items, cap_t, n_pages, page_sz, pages_per_seq, k)
    are the step geometry; budgets, the prefill mode and the prefix cache
    are host policy."""
    n_items: int = 4
    cap_t: int = 64
    n_pages: int = 16
    page_sz: int = 16
    pages_per_seq: Optional[int] = None   # None = n_pages
    k: int = 1
    prefix_cache: bool = True
    prefill_chunk: Optional[int] = None   # max prefill chunk (default cap_t)
    decode_token_budget: Optional[int] = None
    prefill_token_budget: Optional[int] = None
    prefill_mode: str = "interleaved"     # | "serial" (stop-the-world)
    draft_ngram: int = 3
    sim_dt: float = 1.0          # simulated seconds per engine step
    preempt_waiting_steps: Optional[int] = None


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray           # int32 [L]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    arrival: float = 0.0         # simulated arrival time


@dataclass
class RequestResult:
    req_id: int
    prompt_len: int
    output_ids: List[int]
    submitted_step: int
    first_token_step: int
    finished_step: int
    ttft_s: float                # wall-clock submit -> first token
    tpot_s: Optional[float]      # None when fewer than 2 tokens emitted
    preempted: int = 0

    @property
    def ttft_steps(self) -> int:
        return self.first_token_step - self.submitted_step


@dataclass
class _ReqState:
    req: Request
    phase: str = "waiting"       # waiting | prefill | decode | done
    committed: int = 0
    chunks: List[Tuple[int, int]] = field(default_factory=list)
    next_chunk: int = 0
    prefill_target: List[int] = field(default_factory=list)
    waiting_since: int = 0
    next_token: int = -1
    output: List[int] = field(default_factory=list)
    history: List[int] = field(default_factory=list)
    submitted_step: int = 0
    submit_wall: float = 0.0
    first_token_step: int = -1
    first_wall: float = 0.0
    finished_step: int = -1
    done_wall: float = 0.0
    preempted: int = 0


class ServeEngine:
    """Continuous-batching engine over :func:`engine_step` on ``d_p``
    stages of ``d_s`` sequence-parallel ranks: stage ``p`` on card ``p mod
    len(cards)`` (``sharding.stage_devices``; ``cards`` default: the
    device), its ranks on its card. ``params``: the model's layout (kept
    as :attr:`params`; each stage's are views of it, :attr:`stages`).
    ``timeline``: a ``telemetry.StepTimeline`` that :meth:`run` records
    its ``engine`` event in."""

    def __init__(self, cfg_arch, config: EngineConfig, *,
                 params: Optional[Dict] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 device=None, seed: int = 0, d_p: int = 1, d_s: int = 1,
                 cards: Optional[Sequence] = None, timeline=None):
        self.device = resolve_device(device)
        self.cfg_arch = cfg_arch
        self.config = config
        self.timeline = timeline
        param_dtype = param_dtype or torch.float32
        compute_dtype = compute_dtype or param_dtype
        self.geom = make_engine_geometry(
            cfg_arch, n_items=config.n_items, cap_t=config.cap_t,
            n_pages=config.n_pages, page_sz=config.page_sz,
            pages_per_seq=config.pages_per_seq, k=config.k, d_p=d_p,
            d_s=d_s, compute_dtype=compute_dtype)
        self.devices = stage_devices(
            d_p, [resolve_device(c) for c in cards] if cards
            else [self.device], d_s)
        self.device = self.devices[0]
        self.model = DecoderLM(cfg_arch)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, dtype=param_dtype,
                                     device=self.device)
        self.params = params
        self.stages = [tree_map(lambda t, dev=dev: t.to(dev), st)
                       for st, dev in zip(to_stages(cfg_arch, params, d_p,
                                                    decode=True),
                                          self.devices)]
        self.pool_state = init_pool(cfg_arch, self.geom, self.devices)
        self.pool = PagedKVPool(config.n_pages, config.page_sz,
                                prefix_cache=config.prefix_cache)
        self.scheduler = TickScheduler(SchedulerConfig(
            n_items=config.n_items, cap_t=config.cap_t, k=config.k,
            decode_token_budget=config.decode_token_budget,
            prefill_token_budget=config.prefill_token_budget,
            prefill_mode=config.prefill_mode))
        # prompt slicing reuses the trainer's workload-balanced capacity
        # logic (Alg. 1 line 1) at the engine's mesh
        self._cm = CostModel(cfg_arch.spec, ClusterSpec(d_p=d_p, d_s=d_s))
        self.spec_stats = SpecStats()
        self._waiting: "deque[_ReqState]" = deque()
        self._running: List[_ReqState] = []
        self._states: Dict[int, _ReqState] = {}
        self.results: Dict[int, RequestResult] = {}
        self.rejected: Dict[int, str] = {}
        self.step_count = 0
        self.sim_time = 0.0
        self._emitted_total = 0
        self._prefill_fed = 0
        self._run_wall = 0.0
        self._collective_bytes = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request; an over-long prompt is rejected, never
        truncated."""
        plen = int(len(req.prompt))
        need = plen + req.max_new_tokens
        if plen < 1:
            raise ValueError(f"request {req.req_id}: empty prompt")
        if req.req_id in self._states:
            raise ValueError(f"request id {req.req_id} already submitted")
        if need > self.geom.max_ctx:
            raise ValueError(
                f"request {req.req_id}: prompt ({plen}) + max_new_tokens "
                f"({req.max_new_tokens}) = {need} exceeds the page-table "
                f"capacity pages_per_seq * page_sz = {self.geom.max_ctx}")
        st = _ReqState(req=req, submitted_step=self.step_count,
                       submit_wall=time.perf_counter(),
                       waiting_since=self.step_count,
                       history=[int(t) for t in req.prompt])
        self._states[req.req_id] = st
        self._waiting.append(st)

    @property
    def n_active(self) -> int:
        return len(self._waiting) + len(self._running)

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        cap = min(self.config.prefill_chunk or self.geom.cap_t,
                  self.geom.cap_t)
        ps = self.geom.page_sz
        while self._waiting:
            st = self._waiting[0]
            rid = st.req.req_id
            # resume after preemption re-prefills history[:-1]; a fresh
            # request must FEED at least its last prompt token
            target = st.history[:-1] if st.output \
                else [int(t) for t in st.req.prompt]
            mr = len(target) if st.output else len(target) - 1
            pages_hit, rows_hit = self.pool.match_prefix(target, mr)
            remaining = len(target) - rows_hit
            # admission gate: the first chunk must be able to allocate
            first_rows = min(remaining, cap) if remaining else 1
            end = rows_hit + first_rows
            needed = -(-end // ps) - len(pages_hit)
            if rows_hit % ps and pages_hit:
                needed += 1      # shared partial tail: first write may COW
            # adopting a free-but-cached page costs a free slot too
            needed += sum(1 for p in pages_hit
                          if self.pool.refcount(p) == 0)
            if needed > self.pool.n_free and self.pool.in_use > 0:
                if self._maybe_preempt(st):
                    continue
                return
            self._waiting.popleft()
            self.pool.alloc_table(rid)
            if pages_hit:
                self.pool.adopt_prefix(rid, pages_hit, rows_hit)
            st.phase = "prefill"
            st.committed = rows_hit
            st.next_chunk = 0
            st.prefill_target = target
            off, st.chunks = rows_hit, []
            if remaining:
                for ln in prompt_slices(self._cm, remaining, cap):
                    st.chunks.append((off, ln))
                    off += ln
            else:
                st.phase = "decode"
            self._running.append(st)

    def _preempt_stream(self, victim: _ReqState) -> None:
        """Publish then free the victim's pages and requeue it for a
        resume-prefill (greedy outputs are unchanged, only latency)."""
        rid = victim.req.req_id
        self.pool.publish_ready(rid, victim.history, victim.committed)
        self.pool.preempt(rid)
        victim.phase = "waiting"
        victim.preempted += 1
        victim.waiting_since = self.step_count
        self._running.remove(victim)
        self._waiting.append(victim)

    def _maybe_preempt(self, head: _ReqState) -> bool:
        n = self.config.preempt_waiting_steps
        if n is None or self.step_count - head.waiting_since < n:
            return False
        victims = [s for s in self._running if s.phase == "decode"]
        if not victims:
            return False
        self._preempt_stream(victims[-1])
        return True

    # ------------------------------------------------------------------
    def _candidates(self) -> Tuple[List[Segment], List[List[Segment]]]:
        dec: List[Segment] = []
        pre: List[List[Segment]] = []
        k = self.geom.k
        for st in self._running:
            rid = st.req.req_id
            if st.phase == "decode":
                n_draft = max(0, min(k - 1, st.req.max_new_tokens
                                     - len(st.output) - 1))
                draft = propose_draft(st.history, n_draft,
                                      ngram=self.config.draft_ngram)
                dec.append(Segment(
                    req_id=rid, kind="decode",
                    tokens=(st.next_token, *draft), base=st.committed))
            elif st.phase == "prefill":
                pre.append([Segment(
                    req_id=rid, kind="prefill",
                    tokens=tuple(st.prefill_target[off:off + ln]), base=off)
                    for off, ln in st.chunks[st.next_chunk:]])
        return dec, pre

    def _secure_pages(self, plan: StepPlan) -> List[Tuple[int, int]]:
        """Make every page each planned segment writes allocated and
        writable (COW pairs are returned); a segment whose pages cannot be
        secured is deferred with every later segment of its request."""
        ps, pp = self.geom.page_sz, self.geom.pages_per_seq
        copies: List[Tuple[int, int]] = []
        dropped: set = set()
        for item in plan.items:
            kept = []
            for sg in item:
                rid = sg.req_id
                ok = rid not in dropped
                if ok:
                    table = self.pool.table_of(rid)
                    end = min(sg.start + len(sg.tokens), pp * ps)
                    for idx in range(sg.start // ps,
                                     max(end - 1, sg.start) // ps + 1):
                        if idx < len(table):
                            status, pair = self.pool.ensure_writable(
                                rid, idx)
                            if status == "fail":
                                ok = False
                                break
                            if pair is not None:
                                copies.append(pair)
                        else:
                            while ok and len(table) <= idx:
                                ok = self.pool.append_page(rid) is not None
                            if not ok:
                                break
                if ok:
                    kept.append(sg)
                else:
                    dropped.add(rid)
                    if sg.kind == "decode":
                        plan.decode_tokens -= len(sg.tokens)
                        plan.deferred_decode += 1
                    else:
                        plan.prefill_tokens -= len(sg.tokens)
                        plan.deferred_prefill += 1
            item[:] = kept
        return copies

    def _pack(self, plan: StepPlan):
        placed, segs = [], []
        for i, item in enumerate(plan.items):
            cur = 0
            for sg in item:
                segs.append(PackedSegment(
                    item=i, offset=cur, req_id=sg.req_id, tokens=sg.tokens,
                    base=sg.base, table=self.pool.table_of(sg.req_id) or [],
                    read_all=sg.kind == "decode"))
                placed.append((sg, i, cur))
                cur += len(sg.tokens)
        return pack_step(self.geom, segs, self.device), placed

    # ------------------------------------------------------------------
    def _finish(self, st: _ReqState) -> None:
        st.phase = "done"
        st.finished_step = self.step_count
        st.done_wall = time.perf_counter()
        rid = st.req.req_id
        self.pool.publish_ready(rid, st.history, st.committed)
        self.pool.free_table(rid)
        self._running.remove(st)
        n_out = len(st.output)
        tpot = None
        if n_out > 1:
            tpot = (st.done_wall - st.first_wall) / (n_out - 1)
        self.results[rid] = RequestResult(
            req_id=rid, prompt_len=len(st.req.prompt),
            output_ids=list(st.output), submitted_step=st.submitted_step,
            first_token_step=st.first_token_step,
            finished_step=st.finished_step,
            ttft_s=st.first_wall - st.submit_wall, tpot_s=tpot,
            preempted=st.preempted)

    def _emit(self, st: _ReqState, token: int,
              events: List[Tuple[int, int]]) -> bool:
        st.output.append(int(token))
        st.history.append(int(token))
        self._emitted_total += 1
        events.append((st.req.req_id, int(token)))
        if st.first_token_step < 0:
            st.first_token_step = self.step_count
            st.first_wall = time.perf_counter()
        eos = st.req.eos_id
        if (eos is not None and token == eos) \
                or len(st.output) >= st.req.max_new_tokens:
            self._finish(st)
            return True
        st.next_token = int(token)
        return False

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """Run one engine step; returns the (req_id, token) events."""
        self._admit()
        moved = sp.STATS["bytes"]
        guard = 4 * (len(self._running) + len(self._waiting) + 1)
        while True:
            dec_c, pre_c = self._candidates()
            plan = self.scheduler.plan(dec_c, pre_c)
            copy_pages(self.geom, self.pool_state, self._secure_pages(plan))
            guard -= 1
            if plan.n_segments or not self._running or guard <= 0:
                break
            victims = [s for s in self._running
                       if self.pool.table_of(s.req.req_id)]
            if not victims:
                break
            self._preempt_stream(victims[-1])
            self._admit()
        batch, placements = self._pack(plan)
        ids = engine_step(self.model, self.geom, self.stages,
                          self.pool_state, batch)
        self._collective_bytes += sp.STATS["bytes"] - moved

        events: List[Tuple[int, int]] = []
        for sg, item, off in placements:
            st = self._states[sg.req_id]
            if st.phase == "done":
                continue
            out = ids[item, off:off + len(sg.tokens)]
            if sg.kind == "prefill":
                self._prefill_fed += len(sg.tokens)
                st.committed += len(sg.tokens)
                st.next_chunk += 1
                if st.committed == len(st.prefill_target):
                    st.phase = "decode"
                    if not st.output:
                        # the final chunk's last-row id is the first token
                        self._emit(st, int(out[-1]), events)
            else:
                emitted = verify_greedy(sg.tokens, out)
                self.spec_stats.decode_ticks += 1
                self.spec_stats.drafted += len(sg.tokens) - 1
                self.spec_stats.accepted += len(emitted) - 1
                self.spec_stats.emitted += len(emitted)
                st.committed += len(emitted)
                for tok in emitted:
                    if self._emit(st, tok, events):
                        break
        for st in list(self._running):
            self.pool.publish_ready(st.req.req_id, st.history, st.committed)
        self.pool.note_tick()
        self.step_count += 1
        self.sim_time += self.config.sim_dt
        return events

    # ------------------------------------------------------------------
    def run(self, trace: Sequence[Request], *,
            max_steps: int = 100_000) -> Dict[int, RequestResult]:
        """Drive a full trace (simulated arrival times) to completion."""
        t0 = time.perf_counter()
        pending = sorted(trace, key=lambda r: r.arrival)
        i = 0
        while (i < len(pending) or self.n_active) \
                and self.step_count < max_steps:
            while i < len(pending) and pending[i].arrival <= self.sim_time:
                try:
                    self.submit(pending[i])
                except ValueError as e:
                    self.rejected[pending[i].req_id] = str(e)
                i += 1
            if not self.n_active and i < len(pending):
                self.sim_time = pending[i].arrival
                continue
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._run_wall += time.perf_counter() - t0
        if self.timeline is not None:
            st = self.stats()
            self.timeline.record(
                "engine", self.step_count, bucket=str(self.geom),
                completed=st["completed"], steps=st["steps"],
                wall_s=st["wall_s"], tokens_per_s=st["tokens_per_s"],
                ttft_s_p50=st["ttft_s_p50"], ttft_s_p95=st["ttft_s_p95"],
                tpot_s_p50=st["tpot_s_p50"], tpot_s_p95=st["tpot_s_p95"],
                occupancy=st["kv_pool"].get("mean_occupancy"))
        if self.n_active:
            raise RuntimeError(
                f"trace did not drain in {max_steps} steps: "
                f"{self.n_active} requests still active")
        return self.results

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        res = list(self.results.values())
        ttft_s = [r.ttft_s for r in res]
        ttft_steps = [r.ttft_steps for r in res]
        tpot = [r.tpot_s for r in res if r.tpot_s is not None]

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        wall = max(self._run_wall, 1e-9)
        return {
            "completed": len(res),
            "rejected": len(self.rejected),
            "steps": self.step_count,
            "emitted_tokens": self._emitted_total,
            "prefill_tokens_fed": self._prefill_fed,
            "tokens_per_s": self._emitted_total / wall,
            "wall_s": self._run_wall,
            "ttft_s_p50": pct(ttft_s, 50),
            "ttft_s_p95": pct(ttft_s, 95),
            "ttft_steps_p50": pct(ttft_steps, 50),
            "ttft_steps_p95": pct(ttft_steps, 95),
            "tpot_s_p50": pct(tpot, 50),
            "tpot_s_p95": pct(tpot, 95),
            "tpot_measured": len(tpot),
            "kv_pool": self.pool.stats.as_dict(),
            "speculative": self.spec_stats.as_dict(),
            "mesh": f"{self.geom.d_p}x{self.geom.d_s}",
            "pool_bytes_per_rank": pool_bytes(self.cfg_arch,
                                              self.geom)["per_rank"],
            "collective_bytes": self._collective_bytes,
            "collective_bytes_per_step":
                self._collective_bytes / max(self.step_count, 1),
        }


# ===========================================================================
# The one-shot reference path (parity oracle).
# ===========================================================================

@torch.no_grad()
def _last_hidden(model: DecoderLM, params: Dict, seq: Sequence[int],
                 compute_dtype, device) -> torch.Tensor:
    n = len(seq)
    tokens = torch.as_tensor(seq, dtype=torch.int64, device=device)
    seg = torch.zeros(n, dtype=torch.int32, device=device)
    pos = torch.arange(n, dtype=torch.int32, device=device)
    x, _ = model.forward_chunk(params, tokens, seg, pos,
                               compute_dtype=compute_dtype)
    return rms_norm(x[n - 1:n], params["final_norm"], model.cfg.rms_eps)


def one_shot_generate(cfg_arch, params: Dict,
                      prompts: Sequence[Sequence[int]], max_new: int, *,
                      compute_dtype=torch.float32,
                      device=None) -> List[List[int]]:
    """Each output token from a FULL teacher-forced forward of (prompt +
    generated-so-far) — no KV reuse, one request at a time. Quadratically
    slow and exactly right: the oracle of the engine's paged incremental
    decode."""
    device = resolve_device(device)
    model = DecoderLM(cfg_arch)
    head = model.head_weights(params)
    outs: List[List[int]] = []
    for prompt in prompts:
        seq = [int(t) for t in prompt]
        gen: List[int] = []
        for _ in range(max_new):
            h = _last_hidden(model, params, seq, compute_dtype, device)
            nxt = int(greedy_ids(h, head, vocab_true=cfg_arch.spec.vocab)[0])
            gen.append(nxt)
            seq.append(nxt)
        outs.append(gen)
    return outs


@torch.no_grad()
def top2_margin(cfg_arch, params: Dict, seq: Sequence[int], *,
                compute_dtype=torch.float32, device=None
                ) -> Tuple[float, float]:
    """(top-1 minus top-2 logit, max |logit|) of the one-shot next-token
    distribution after ``seq``."""
    device = resolve_device(device)
    model = DecoderLM(cfg_arch)
    h = _last_hidden(model, params, seq, compute_dtype, device)
    head = model.head_weights(params)[:cfg_arch.spec.vocab]
    logits = (h.float() @ head.float().T)[0]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def verify_against_one_shot(cfg_arch, params: Dict,
                            prompts: Sequence[Sequence[int]],
                            outputs: Sequence[Sequence[int]], max_new: int,
                            *, compute_dtype=torch.float32, device=None,
                            reference=None) -> Tuple[bool, List[str]]:
    """Compare engine output ids with :func:`one_shot_generate`. A mismatch
    is tolerated only where the one-shot's top-1/top-2 logit margin is
    below ``NEAR_TIE * max|logit|`` (random weights at a 262,144-entry
    vocabulary give near-ties that summation order may flip); comparison of
    that request stops there. ``reference``: the one-shot ids, if the
    caller has them. Returns (ok, report lines)."""
    ref = reference if reference is not None else one_shot_generate(
        cfg_arch, params, prompts, max_new, compute_dtype=compute_dtype,
        device=device)
    ok, lines = True, []
    for i, (got, want) in enumerate(zip(outputs, ref)):
        got = list(got)
        j = next((t for t in range(max(len(got), len(want)))
                  if t >= len(got) or t >= len(want) or got[t] != want[t]),
                 None)
        if j is None:
            lines.append(f"request {i}: {len(got)} ids match")
            continue
        if j >= len(got) or j >= len(want):
            ok = False
            lines.append(f"request {i}: lengths differ ({len(got)} vs "
                         f"{len(want)})")
            continue
        seq = [int(t) for t in prompts[i]] + list(want[:j])
        margin, scale = top2_margin(cfg_arch, params, seq,
                                    compute_dtype=compute_dtype,
                                    device=device)
        tolerated = margin < NEAR_TIE * scale
        ok &= tolerated
        lines.append(f"request {i}: ids differ at {j} ({got[j]} vs "
                     f"{want[j]}); one-shot margin {margin:.3e} vs "
                     f"{NEAR_TIE:g} * max|logit| {scale:.3e} -> "
                     f"{'tolerated near-tie' if tolerated else 'MISMATCH'}")
    return ok, lines
