"""The serving engine's device step: chunked prefill and (speculative)
decode over a paged KV pool, on a ``(d_p, d_s)`` mesh of pipeline stages
and sequence-parallel ranks.

Counterpart of the JAX package's ``runtime/serve_step.py`` engine step
(``engine_step_fn``, ``engine_copy_fn``, ``engine_pool_struct``). The port
is one process: stage ``p`` lives on ``sharding.stage_devices(d_p,
cards)[p]`` and holds its ``d_s`` ranks as lists (as ``SPStage`` and the
decode state hold theirs); the collectives are ``runtime/sp``'s functions
over those lists, their bytes counted in ``sp.STATS``.

Each step packs ``n_items`` items of ``cap_t`` tokens; a token carries its
id, its position in its request and the step's segment id of its request.

The pool (:func:`init_pool`) is page-granular and sharded page-blockwise
over the ranks, as the reference's: global page ``g`` lives on rank ``g //
n_pages_loc`` at local index ``g % n_pages_loc``, and each rank keeps one
trash page of its own at local index ``n_pages_loc``; ``pool[name][p][r]``
is stage ``p``'s rank ``r`` block of K or V, ``[L_s, n_pages_loc + 1,
page_sz, Hkv, Dh]``: ``n_pages + d_s`` pages a layer slot, the bytes of
the reference's ``engine_pool_struct``. At ``d_p = d_s = 1`` that is one
``[L, n_pages + 1, ...]`` block, page ``n_pages`` the trash page.

Attention: per layer and rank the step builds ONE packed KV buffer —

* for every request in the step, its committed cache rows the layer can
  see and that live on the rank's pages, gathered once per request from
  its page table, with the request's segment id and their positions: rows
  ``0..base-1`` (``base`` = its committed length at step start) on a
  global layer, and only the last ``window - 1`` of them on a layer with a
  sliding window (the step's queries of the request sit at positions
  ``>= base``, so older rows are masked for all of them);
* on rank 0, then the step's own rows, all ``n_items * cap_t`` of them
  (the reference computes its intra-chunk rows on every rank and adds
  them once; here one rank holds them);

— and runs kernel A over all the step's queries: at one rank
:func:`repro_torch.kernels.ops.flash_attention`, at ``d_s > 1``
``ops.attention_with_lse`` on every rank (a rank with no live row for a
query gives zeros and ``-inf``, and still launches), the partials merged
by their log-sum-exps (``sp.merge_partials``, the reference's ``pmax`` /
``psum``). The host builds the gather lists once per step for each rank
and each distinct window of the model's layers
(:attr:`EngineGeometry.windows`). The packed-varlen mask (same segment,
causal, window) then selects, for each token, the same keys the
reference's ``_paged_attention`` selects: cache rows ``r < ctx_base``
within the window plus same-segment causal chunk rows.

Item order: the reference runs item ``i`` on stage ``p`` at tick ``i + p``
(``StageProgram(n_items, d_p)``), so a later item of a request reads, from
the pool, the rows an earlier item wrote in the same step. The port runs
each stage over all its items in one packed call, as the one-rank step
does: the chunks of one request in one step share the request's segment
id, so a later chunk sees the earlier one's rows among the step's own rows
under the same causal and window mask, the same keys in the same order of
positions.

Per layer on the mesh (the reference's ``step_local``): each rank takes
its block of the step's rows (``sp.row_blocks``; the reference shards each
item's ``cap_t`` tokens over the model axis) and projects it; q, k and v
are all-gathered; attention as above; each rank keeps its block for ``wo``
and for the MLP, or the MoE block over the ranks (``ep.make_moe_ep(d_s)``,
the reference's ``make_moe_ep(model_axis, d_s)``). The rank owning a row's
page scatters its K/V into ``(page, pos % page_sz)`` in place; rows whose
page is unmapped or on another rank, rows past ``max_ctx`` and padding go
to the rank's trash page. The activation moves to the next stage's device
between stages; only a stage's active layer slots run
(:func:`_layer_tables`). The last stage applies the final norm to the rows
whose ids the host reads (the last row of each prefill chunk and every
decode row) and the vocabulary-parallel argmax (``sp.sharded_greedy``:
float32 logits per vocabulary tile and row block, ties to the lowest id).

Parameters: each stage's come from ``weights.to_stages(cfg, params, d_p,
decode=True)`` (views of the caller's tensors); a stage's ranks share its
parameters on its card, as the port's decode does. The reference's engine
instead keeps ZeRO-3 shards and gathers each layer inside its step
(``gather_layer_params``); the sharded engine parameters wait for the
per-rank driver (ROADMAP.md queue 1, item 2). The embedding's and head's
row blocks are the reference's blocks of a vocabulary padded to a multiple
of ``d_s``, the padding dropped (``sp.row_blocks``).

The engine serves dense and MoE decoders. Every family of the registry
(SSM, hybrid, MLA, the encoder-decoder too) is served by the pipelined
prefill and fixed-batch decode, the counterpart of the reference's
``decode_step_fn`` and its ``pipeline_loss_fn(mode="prefill")``:
:class:`DecodeStepBuilder` (``prefill``, ``step``, ``generate``) over
:class:`DecodeGeometry` and the decode state (:func:`init_decode_state`):

* the batch splits into ``n_micro`` microbatches of ``bm`` sequences,
  which go through the ``d_p`` stages in the reference's tick order
  (microbatch ``m`` on stage ``p`` at tick ``m + p``);
* the state holds, per stage (on its device) and per sequence-parallel
  rank (a list, as ``SPStage`` holds its ranks): the KV cache (MLA: latent
  rows) in contiguous blocks of ``s_loc`` rows, the SSM state and conv
  tail in blocks of ``d_inner / d_s`` channels, the encoder's memory in
  blocks of frames; the cache is made once for the longest context the
  batch reaches, and the state's ``length`` is the current one (one
  length per batch);
* a decode step per layer: attention over the ranks' shards merged by
  their log-sum-exps (``attention.decode_attention``), the mamba step per
  channel block (``ssm.mamba_decode``), hybrid layers averaging the two,
  the encoder-decoder's cross-attention over the ranks' frames
  (``EncDecLM.cross_decode``), the MLP or the MoE block (over the ranks:
  ``ep.moe_decode``); then the final norm and the vocabulary-parallel
  argmax (``sp.sharded_greedy``). Only active layer slots run and update
  the state, in place;
* the prefill runs one sequence per chunk forward through the stages
  (``PipelineStage.prefill``; on ``d_s`` ranks the allgather_kv model of
  ``runtime/sp``), a prompt longer than the chunk cap continuing through
  the split-chunk carry; the greedy id at its last row is its first
  generated token, and its carry is copied into its slot of the state.

The residual adds the attention term, as the port's one-shot forward
does: the reference's ``decode_step_fn`` drops it (ROADMAP.md §3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import BLOCK_KV
from repro_torch.models.attention import decode_attention, project_qkv
from repro_torch.models.config import ArchConfig, LayerKind
from repro_torch.models.layers import linear, rms_norm, swiglu_apply
from repro_torch.models.model import DecoderLM, LayerCtx
from repro_torch.models.ssm import mamba_decode

from . import sp

__all__ = ["EngineGeometry", "make_engine_geometry", "init_pool",
           "pool_bytes", "read_rows", "PackedSegment", "KVRows", "RankRows",
           "EngineBatch", "pack_step", "engine_step", "copy_pages",
           "greedy_ids", "DecodeGeometry", "make_decode_geometry",
           "init_decode_state", "decode_state_bytes", "decode_step",
           "DecodeStepBuilder"]


@dataclass(frozen=True)
class EngineGeometry:
    """Static geometry of the engine step."""
    n_items: int             # packed chunk items per engine step
    cap_t: int               # tokens per item (d_s divides it)
    n_pages: int             # user KV pages pool-wide (d_s divides it)
    page_sz: int             # cache rows per page
    pages_per_seq: int       # page-table entries per request (max context)
    k: int                   # decode tokens per stream per step (1 = greedy)
    d_p: int                 # pipeline stages
    d_s: int                 # sequence-parallel ranks a stage
    layers_per_stage: int    # layer slots a stage (padded ones at the end)
    compute_dtype: torch.dtype = torch.bfloat16
    windows: Tuple[int, ...] = (0,)   # the layers' distinct windows, 0 = none

    @property
    def trash_page(self) -> int:
        """Sentinel page id: unmapped table entries and padding writes."""
        return self.n_pages

    @property
    def n_pages_loc(self) -> int:
        """User pages resident on each rank (+1 local trash page)."""
        return self.n_pages // self.d_s

    @property
    def max_ctx(self) -> int:
        """Rows a full page table can address (max prompt + generated)."""
        return self.pages_per_seq * self.page_sz

    def owner(self, page: int) -> Tuple[int, int]:
        """``(rank, local index)`` of global page ``page``."""
        return divmod(int(page), self.n_pages_loc)


def make_engine_geometry(cfg: ArchConfig, *, n_items: int, cap_t: int,
                         n_pages: int, page_sz: int,
                         pages_per_seq: Optional[int] = None, k: int = 1,
                         d_p: int = 1, d_s: int = 1,
                         compute_dtype=torch.bfloat16) -> EngineGeometry:
    """The reference's ``make_engine_geometry`` at a ``(d_p, d_s)`` mesh
    (no mesh object, as :func:`make_decode_geometry` takes none): its
    refusals and its ``ValueError``\\ s on the same conditions, in its
    order; ``ceil(n_layers / d_p)`` layer slots a stage."""
    s = cfg.spec
    if s.attn_free or s.ssm_state > 0:
        raise NotImplementedError("serving engine supports attention archs "
                                  "only")
    if s.is_encoder_decoder:
        raise NotImplementedError("serving engine is decoder-only")
    if s.kv_lora_rank > 0:
        raise NotImplementedError("MLA latent cache rows are not wired "
                                  "into the page pool")
    if min(d_p, d_s) < 1:
        raise ValueError(f"d_p={d_p} and d_s={d_s} must be >= 1")
    if cap_t % d_s:
        raise ValueError(f"cap_t={cap_t} must be divisible by the model "
                         f"axis d_s={d_s}")
    if min(n_items, cap_t, n_pages, page_sz, k) < 1:
        raise ValueError("n_items/cap_t/n_pages/page_sz/k must all be >= 1")
    if n_pages % d_s:
        raise ValueError(f"n_pages={n_pages} must be divisible by the model "
                         f"axis d_s={d_s} (the pool is sequence-sharded "
                         f"page-blockwise)")
    pp = n_pages if pages_per_seq is None else pages_per_seq
    if not (1 <= pp <= n_pages):
        raise ValueError(f"pages_per_seq={pp} must be in [1, n_pages="
                         f"{n_pages}]")
    if k > cap_t:
        raise ValueError(f"k={k} cannot exceed cap_t={cap_t}")
    return EngineGeometry(n_items=n_items, cap_t=cap_t, n_pages=n_pages,
                          page_sz=page_sz, pages_per_seq=pp, k=k, d_p=d_p,
                          d_s=d_s, layers_per_stage=-(-s.n_layers // d_p),
                          compute_dtype=compute_dtype,
                          windows=tuple(sorted(set(cfg.layer_windows()))))


def _rank_shape(cfg: ArchConfig, geom: EngineGeometry) -> tuple:
    s = cfg.spec
    return (geom.layers_per_stage, geom.n_pages_loc + 1, geom.page_sz,
            s.n_kv_heads, s.head_dim)


def init_pool(cfg: ArchConfig, geom: EngineGeometry, devices
              ) -> Dict[str, List[List[torch.Tensor]]]:
    """The paged pool, zeros: ``pool[name][p][r]`` (``name`` ``cache_k`` or
    ``cache_v``) is stage ``p``'s rank ``r`` block ``[L_s, n_pages_loc + 1,
    page_sz, Hkv, Dh]`` on ``devices[p]`` (one device: every stage on it).
    """
    devs = [devices] * geom.d_p if isinstance(devices, (str, torch.device)) \
        else list(devices)
    if len(devs) != geom.d_p:
        raise ValueError(f"{len(devs)} devices for {geom.d_p} stages")
    shape = _rank_shape(cfg, geom)
    return {name: [[torch.zeros(shape, dtype=geom.compute_dtype, device=dev)
                    for _ in range(geom.d_s)] for dev in devs]
            for name in ("cache_k", "cache_v")}


def pool_bytes(cfg: ArchConfig, geom: EngineGeometry) -> Dict[str, int]:
    """Bytes of the pool: ``per_rank`` (one rank of one stage, K and V)
    and ``total``, which equals the reference's ``engine_pool_struct``
    (``[d_p, L_s, n_pages + d_s, page_sz, Hkv, Dh]`` for K and for V)."""
    per = 2 * int(np.prod(_rank_shape(cfg, geom))) * \
        torch.empty((), dtype=geom.compute_dtype).element_size()
    return {"per_rank": per, "total": per * geom.d_p * geom.d_s}


def read_rows(cfg: ArchConfig, geom: EngineGeometry, pool: Dict,
              table: Sequence[int], n: int, name: str = "cache_k"
              ) -> torch.Tensor:
    """A request's committed rows ``0..n-1`` of every layer, read through
    its page table from the ranks that own its pages: ``[n_layers, n, Hkv,
    Dh]`` on the first stage's device."""
    ps, L_s = geom.page_sz, geom.layers_per_stage
    rows = np.arange(n)
    rank, loc = np.divmod(np.asarray(table, np.int64)[rows // ps],
                          geom.n_pages_loc)
    flat = loc * ps + rows % ps
    out = []
    for p, stage in enumerate(pool[name]):
        blk = stage[0].new_empty((L_s, n, *stage[0].shape[3:]))
        for r, buf in enumerate(stage):
            sel = np.nonzero(rank == r)[0]
            if len(sel):
                idx = torch.as_tensor(flat[sel], device=buf.device)
                blk[:, torch.as_tensor(sel, device=buf.device)] = \
                    buf.flatten(1, 2).index_select(1, idx)
        n_act = max(0, min(L_s, cfg.spec.n_layers - p * L_s))
        out.append(blk[:n_act].to(pool[name][0][0].device))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Packing (host) -> device batch.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PackedSegment:
    """One segment placed in the step: ``tokens`` at item ``item`` from
    column ``offset``, positions ``base .. base + len - 1``."""
    item: int
    offset: int
    req_id: int
    tokens: Sequence[int]
    base: int                # committed cache rows of the request
    table: Sequence[int]     # the request's page table
    read_all: bool           # host reads every row's id (decode) or the last


@dataclass
class KVRows:
    """The key rows of one window's layers on one rank: its gathered pool
    rows (padded to the kernel's KV tile; at least one tile), then on rank
    0 the step's own ``T`` rows."""
    ctx_rows: torch.Tensor   # int64 flat rows of the rank's block to gather
    seg: torch.Tensor        # int32: gathered rows' segments, then seg
    pos: torch.Tensor        # int32


@dataclass
class RankRows:
    """One rank's part of a step: its key rows per window of
    ``geom.windows`` and, for each of the step's ``T`` rows, the flat row
    of its block the row's K/V is written to (its trash page where another
    rank owns the row's page)."""
    kv: Dict[int, KVRows]
    write_rows: torch.Tensor  # [T] int64


@dataclass
class EngineBatch:
    """Device tensors of one step (``T = n_items * cap_t`` query rows)."""
    tokens: torch.Tensor     # [T] int64
    pos: torch.Tensor        # [T] int32
    seg: torch.Tensor        # [T] int32, request's step segment id, -1 pad
    ranks: List[RankRows]    # one a sequence-parallel rank
    head_rows: torch.Tensor  # [N] int64 rows whose greedy id is read

    @property
    def kv(self) -> Dict[int, KVRows]:
        """Rank 0's key rows (the whole pool's at ``d_s = 1``)."""
        return self.ranks[0].kv

    def to(self, device) -> "EngineBatch":
        def mv(t):
            return t.to(device)
        return EngineBatch(
            tokens=mv(self.tokens), pos=mv(self.pos), seg=mv(self.seg),
            ranks=[RankRows({w: KVRows(mv(kv.ctx_rows), mv(kv.seg),
                                       mv(kv.pos))
                             for w, kv in rr.kv.items()},
                            mv(rr.write_rows)) for rr in self.ranks],
            head_rows=mv(self.head_rows))


def pack_step(geom: EngineGeometry, segments: Sequence[PackedSegment],
              device) -> EngineBatch:
    """The step's device batch from its segments: any page table on any
    ranks (a request's pages fall wherever the allocator put them)."""
    n, c, ps, pp = geom.n_items, geom.cap_t, geom.page_sz, geom.pages_per_seq
    d, n_loc = geom.d_s, geom.n_pages_loc
    T = n * c
    trash0 = n_loc * ps           # each rank's own trash page
    tokens = np.zeros(T, np.int64)
    pos = np.zeros(T, np.int32)
    seg = np.full(T, -1, np.int32)
    # padding writes spread over the trash page's rows
    write = np.tile(trash0 + (np.arange(T) % ps), (d, 1))
    sid: Dict[int, int] = {}
    firsts: List[PackedSegment] = []
    head: List[int] = []
    for sg in segments:
        ln = len(sg.tokens)
        a = sg.item * c + sg.offset
        table = np.asarray(sg.table, np.int64)
        if sg.req_id not in sid:
            # first (earliest-item) segment of the request this step: its
            # committed rows come from the pool
            sid[sg.req_id] = len(sid)
            firsts.append(sg)
            if sg.base > len(table) * ps:
                raise ValueError(f"request {sg.req_id}: {sg.base} committed "
                                 f"rows but {len(table)} pages")
        p = np.arange(sg.base, sg.base + ln)
        tokens[a:a + ln] = sg.tokens
        pos[a:a + ln] = p
        seg[a:a + ln] = sid[sg.req_id]
        entry = p // ps
        mapped = (p < pp * ps) & (entry < len(table))
        rank, loc = np.divmod(table[np.minimum(entry, len(table) - 1)],
                              n_loc)
        for r in range(d):
            write[r, a:a + ln] = np.where(mapped & (rank == r),
                                          loc * ps + p % ps, trash0 + p % ps)
        head.extend(range(a, a + ln) if sg.read_all else [a + ln - 1])

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dt)
    i32, i64 = torch.int32, torch.int64
    kv: List[Dict[int, KVRows]] = [{} for _ in range(d)]
    for w in geom.windows:
        parts = [([np.zeros(0, np.int64)], [], []) for _ in range(d)]
        for sg in firsts:
            # a query at position >= base sees rows > base - w
            lo = max(0, sg.base - w + 1) if w > 0 else 0
            r = np.arange(lo, sg.base)
            rank, loc = np.divmod(np.asarray(sg.table, np.int64)[r // ps],
                                  n_loc)
            for q, (rows, kseg, kpos) in enumerate(parts):
                mine = rank == q
                rows.append(loc[mine] * ps + r[mine] % ps)
                kseg.append(np.full(int(mine.sum()), sid[sg.req_id],
                                    np.int32))
                kpos.append(r[mine].astype(np.int32))
        for q, (rows, kseg, kpos) in enumerate(parts):
            # pad the gathered part to the kernel's KV tile (seg -2 rows
            # read the trash page) so the concatenated buffer needs no
            # second padding copy; a rank with no row still gets a tile,
            # and rank 0 takes the step's own rows
            live = sum(map(len, rows))
            pad = (-live) % BLOCK_KV or (BLOCK_KV if q and not live else 0)
            rows.append(np.full(pad, trash0, np.int64))
            kseg += [np.full(pad, ops.PAD_SEG, np.int32)] + \
                ([seg] if q == 0 else [])
            kpos += [np.zeros(pad, np.int32)] + ([pos] if q == 0 else [])
            kv[q][w] = KVRows(ctx_rows=dev(np.concatenate(rows), i64),
                              seg=dev(np.concatenate(kseg), i32),
                              pos=dev(np.concatenate(kpos), i32))
    return EngineBatch(
        tokens=dev(tokens, i64), pos=dev(pos, i32), seg=dev(seg, i32),
        ranks=[RankRows(kv[q], dev(write[q], i64)) for q in range(d)],
        head_rows=dev(np.asarray(head, np.int64), i64))


# ---------------------------------------------------------------------------
# The step.
# ---------------------------------------------------------------------------

def _gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ranks' row blocks as one tensor (one rank: its own)."""
    return xs[0] if len(xs) == 1 else sp.all_gather(xs)


def _engine_layer(model, lp: Dict, window: int, xs: List[torch.Tensor],
                  b: EngineBatch, pos_blocks, ropes, ck, cv, moe_fn
                  ) -> List[torch.Tensor]:
    """One layer slot over the ranks' row blocks ``xs``; ``ck`` / ``cv``:
    the ranks' K / V rows of the slot, ``[rows, Hkv, Dh]`` views of the
    pool, written in place."""
    cfg, eps = model.cfg, model.cfg.rms_eps
    scale = 1.0 / math.sqrt(cfg.spec.head_dim)
    qkv = [project_qkv(cfg, lp["attn"], rms_norm(x, lp["ln1"], eps), ps, rp)
           for x, ps, rp in zip(xs, pos_blocks, ropes)]
    q, k, v = (_gather([t[j] for t in qkv]) for j in range(3))
    k, v = k.to(ck[0].dtype), v.to(cv[0].dtype)
    T = q.shape[0]
    if len(xs) == 1:
        kv = b.ranks[0].kv[window]
        out = ops.flash_attention(
            q, torch.cat([ck[0].index_select(0, kv.ctx_rows), k]),
            torch.cat([cv[0].index_select(0, kv.ctx_rows), v]), b.seg,
            kv.seg, b.pos, kv.pos, window=window, scale=scale)
    else:
        outs, lses = [], []
        for r, rr in enumerate(b.ranks):
            kv = rr.kv[window]
            kk = ck[r].index_select(0, kv.ctx_rows)
            vv = cv[r].index_select(0, kv.ctx_rows)
            if r == 0:
                kk, vv = torch.cat([kk, k]), torch.cat([vv, v])
            o, lse = ops.attention_with_lse(q, kk, vv, b.seg, kv.seg, b.pos,
                                            kv.pos, window=window,
                                            scale=scale)
            outs.append(o)
            lses.append(lse)
        out = sp.merge_partials(outs, lses)
    out = out.reshape(T, -1)
    ys, off = [], 0
    for x in xs:
        ys.append(linear(out[off:off + x.shape[0]], lp["attn"]["wo"]))
        off += x.shape[0]
    for r, rr in enumerate(b.ranks):
        ck[r].index_copy_(0, rr.write_rows, k)
        cv[r].index_copy_(0, rr.write_rows, v)
    xs = [x + y for x, y in zip(xs, ys)]
    h2 = [rms_norm(x, lp["ln2"], eps) for x in xs]
    fs = moe_fn(cfg, lp["moe"], h2) if moe_fn is not None \
        else [model.ffn(lp, h) for h in h2]
    return [x + f for x, f in zip(xs, fs)]


@torch.no_grad()
def engine_step(model: DecoderLM, geom: EngineGeometry,
                stages: Sequence[Dict], pool: Dict, batch: EngineBatch
                ) -> np.ndarray:
    """Run every stage's active layer slots over the packed batch, updating
    ``pool`` IN PLACE. ``stages``: the parameters of each stage
    (``weights.to_stages(..., decode=True)``), on the devices of the
    pool's stages. Returns ids ``[n_items, cap_t]`` (int64): the greedy
    next-token id after each row in ``batch.head_rows``, -1 elsewhere."""
    cfg, s = model.cfg, model.cfg.spec
    d, L_s, dt = geom.d_s, geom.layers_per_stage, geom.compute_dtype
    windows, active = _layer_tables(cfg, geom.d_p, L_s)
    blocks = sp.row_blocks(geom.n_items * geom.cap_t, d)
    moe_fn = None
    if s.n_experts > 0 and d > 1:
        from .ep import make_moe_ep
        moe_fn = make_moe_ep(d)
    xs: List[torch.Tensor] = []
    for p, stage in enumerate(stages):
        ks, vs = pool["cache_k"][p], pool["cache_v"][p]
        b = batch.to(ks[0].device)
        pos_blocks = [b.pos[a:a + n] for a, n in blocks]
        if p == 0:
            xs = [model.embed(stage, b.tokens, dt)] if d == 1 else \
                model.embed_sp(stage, [b.tokens[a:a + n] for a, n in blocks],
                               d, dt)
        else:
            xs = [x.to(ks[0].device) for x in xs]
        ropes = [model.rope_tables(pb) for pb in pos_blocks]
        for l in range(L_s):
            if not active[p, l]:
                continue

            def rows(bufs):
                return [t[l].view(-1, *t.shape[3:]) for t in bufs]
            xs = _engine_layer(model, stage["layers"][p * L_s + l],
                               int(windows[p, l]), xs, b, pos_blocks, ropes,
                               rows(ks), rows(vs), moe_fn)
    last = stages[-1]
    head_rows = batch.head_rows.to(xs[0].device)
    h = rms_norm(_gather(xs).index_select(0, head_rows), last["final_norm"],
                 cfg.rms_eps)
    ids = sp.sharded_greedy(h, model.head_weights(last), d,
                            vocab_true=s.vocab)
    out_ids = np.full(geom.n_items * geom.cap_t, -1, np.int64)
    out_ids[batch.head_rows.cpu().numpy()] = ids.cpu().numpy()
    return out_ids.reshape(geom.n_items, geom.cap_t)


@torch.no_grad()
def copy_pages(geom: EngineGeometry, pool: Dict, pairs) -> None:
    """Copy-on-write page copies, in order, in place: global page ``dst``
    of every layer slot of every stage becomes a copy of page ``src``; the
    two may live on different ranks (the reference's ``engine_copy_fn``:
    the source's owner broadcasts, the destination's writes; those bytes
    count as a collective). The sentinel ``n_pages`` is a no-op."""
    for src, dst in pairs:
        if geom.trash_page in (src, dst):
            continue
        (rs, ls), (rd, ld) = geom.owner(src), geom.owner(dst)
        for stages in pool.values():
            for ranks in stages:
                page = ranks[rs][:, ls]
                if rs != rd:
                    sp.count_bytes(page.numel() * page.element_size())
                ranks[rd][:, ld].copy_(page)


HEAD_BLOCK_V = 16384     # vocabulary rows per greedy-head tile


@torch.no_grad()
def greedy_ids(hidden: torch.Tensor, w: torch.Tensor, *,
               vocab_true: Optional[int] = None, with_max: bool = False):
    """Argmax of ``hidden @ w.T`` over the vocabulary without holding the
    ``[N, V]`` logits: float32 logits per ``HEAD_BLOCK_V``-row tile of
    ``w``, a running (max, index) with strict ``>`` across tiles and the
    first index within a tile. The result is the lowest index of the
    global maximum for any tile size; ``with_max``: ``(ids, max logits)``
    (what ``runtime/sp.sharded_greedy`` merges over vocabulary blocks)."""
    N = hidden.shape[0]
    V = w.shape[0] if vocab_true is None else min(vocab_true, w.shape[0])
    best_v = torch.full((N,), -math.inf, dtype=torch.float32,
                        device=hidden.device)
    best_i = torch.zeros((N,), dtype=torch.int64, device=hidden.device)
    hf = hidden.float()
    for v0 in range(0, V, HEAD_BLOCK_V):
        logits = hf @ w[v0:min(v0 + HEAD_BLOCK_V, V)].float().T
        m, am = logits.max(dim=1)
        take = m > best_v
        best_v = torch.where(take, m, best_v)
        best_i = torch.where(take, am + v0, best_i)
    return (best_i, best_v) if with_max else best_i


# ===========================================================================
# Pipelined prefill and fixed-batch decode (every family of the registry).
# ===========================================================================

@dataclass(frozen=True)
class DecodeGeometry:
    """Static geometry of the pipelined decode (the reference's, without its
    mesh): ``batch_per_pod`` sequences in ``n_micro`` microbatches of
    ``bm``, ``d_p`` stages of ``layers_per_stage`` layer slots (inert
    padded slots at the end), the cache's ``s_cap`` rows in ``d_s``
    blocks of ``s_loc``. ``cache_len``: the rows the cache is made for
    (the longest context the batch reaches; the reference's is one
    bucket's current length), ``s_cap = cache_len + d_s`` as the
    reference's."""
    batch_per_pod: int
    cache_len: int
    d_p: int
    d_s: int
    layers_per_stage: int
    n_micro: int
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def bm(self) -> int:
        return max(1, self.batch_per_pod // self.n_micro)

    @property
    def s_cap(self) -> int:
        return self.cache_len + self.d_s

    @property
    def s_loc(self) -> int:
        return self.s_cap // self.d_s


def make_decode_geometry(cfg: ArchConfig, *, d_p: int, d_s: int,
                         batch_per_pod: int, cache_len: int,
                         compute_dtype=torch.bfloat16) -> DecodeGeometry:
    """The reference's ``make_decode_geometry`` at a ``(d_p, d_s)`` mesh
    (no mesh object, as :func:`make_engine_geometry` takes none):
    ``n_micro = min(d_p, batch_per_pod)``, ``ceil(n_layers / d_p)`` slots
    a stage."""
    s = cfg.spec
    if min(d_p, d_s, batch_per_pod) < 1 or cache_len < 0:
        raise ValueError(f"d_p={d_p}, d_s={d_s}, batch_per_pod="
                         f"{batch_per_pod} must be >= 1 and cache_len="
                         f"{cache_len} >= 0")
    if cache_len % d_s:
        raise ValueError(f"cache_len={cache_len} must be a multiple of "
                         f"d_s={d_s}: the cache's cache_len + d_s rows "
                         f"split into d_s equal blocks")
    if s.ssm_state > 0 and s.inner % d_s:
        raise ValueError(f"d_inner={s.inner} must be a multiple of "
                         f"d_s={d_s}: each rank owns a block of channels")
    return DecodeGeometry(
        batch_per_pod=batch_per_pod, cache_len=cache_len, d_p=d_p, d_s=d_s,
        layers_per_stage=-(-s.n_layers // d_p),
        n_micro=min(d_p, batch_per_pod), compute_dtype=compute_dtype)


def _layer_tables(cfg: ArchConfig, d_p: int, L_s: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-stage ``[d_p, L_s]`` sliding windows (0: none) and active slots
    (padded slots inactive), the reference's."""
    L = cfg.spec.n_layers
    win = list(cfg.layer_windows()) + [0] * (d_p * L_s - L)
    active = np.arange(d_p * L_s) < L
    return (np.asarray(win, np.int64).reshape(d_p, L_s),
            active.reshape(d_p, L_s))


def _state_shapes(cfg: ArchConfig, geom: DecodeGeometry,
                  s_mem: Optional[int], n_pods: int = 1
                  ) -> Dict[str, Tuple[tuple, object]]:
    """Each entry's per-stage, per-rank shape and dtype (``memory``: per
    rank, no stage), the reference's ``decode_state_struct`` less the stage
    dim and the sharded dim's other blocks; its lead pod dim where
    ``n_pods > 1``, as the reference's."""
    s = cfg.spec
    nm, L_s, bm, d = geom.n_micro, geom.layers_per_stage, geom.bm, geom.d_s
    dt = geom.compute_dtype
    if n_pods < 1:
        raise ValueError(f"n_pods must be >= 1, got {n_pods}")
    out: Dict[str, Tuple[tuple, object]] = {"tokens": ((nm, bm),
                                                       torch.int32)}
    if s.is_encoder_decoder:
        if s_mem is None:       # the reference's stub: a quarter of the
            s_mem = max(d, (geom.cache_len // 4) // d * d)   # context
        if s_mem % d:
            raise ValueError(f"s_mem={s_mem} frames must be a multiple of "
                             f"d_s={d}")
        out["memory"] = ((nm, bm, s_mem // d, s.d_model), dt)
    if not s.attn_free:
        row = (1, s.kv_lora_rank + s.qk_rope_dim) if s.kv_lora_rank > 0 \
            else (s.n_kv_heads, s.head_dim)
        out["cache_k"] = ((nm, L_s, bm, geom.s_loc, *row), dt)
        if s.kv_lora_rank == 0:
            out["cache_v"] = out["cache_k"]
    if s.ssm_state > 0:
        out["ssm_h"] = ((nm, L_s, bm, s.inner // d, s.ssm_state),
                        torch.float32)
        out["conv_tail"] = ((nm, L_s, bm, s.ssm_conv - 1, s.inner // d), dt)
    lead = (n_pods,) if n_pods > 1 else ()
    return {k: ((*lead, *shape), dt) for k, (shape, dt) in out.items()}


def init_decode_state(cfg: ArchConfig, geom: DecodeGeometry, devices, *,
                      s_mem: Optional[int] = None, n_pods: int = 1) -> Dict:
    """The decode state, zeros (the reference's ``decode_state_struct``):
    ``tokens [n_micro, bm]`` int32 (each sequence's token to
    run next) and ``length`` (the rows its cache holds) on the first stage;
    per stage ``p`` (on ``devices[p]``) the list of the ranks' blocks of
    ``cache_k`` / ``cache_v`` ``[n_micro, L_s, bm, s_loc, Hkv, Dh]`` (MLA:
    ``cache_k`` latent rows ``[.., s_loc, 1, r + rr]``), ``ssm_h [n_micro,
    L_s, bm, d_inner / d_s, d_state]`` float32 and ``conv_tail [.., d_conv
    - 1, d_inner / d_s]``; the encoder-decoder's ``memory``, the ranks'
    blocks of ``s_mem`` frames ``[n_micro, bm, s_mem / d_s, D]`` on the
    first stage (default: the reference's stub size), and ``mem_len``.

    ``n_pods > 1``: every tensor leads with the reference's pod dim (each
    pod's ``batch_per_pod`` sequences; ``n_pods`` in the state), which the
    dry-run sizes; :func:`decode_step` runs one pod's state (the reference
    only lowers its decode over pods)."""
    devs = list(devices)
    if len(devs) != geom.d_p:
        raise ValueError(f"{len(devs)} devices for {geom.d_p} stages")
    state: Dict = {"length": 0}
    if n_pods > 1:
        state["n_pods"] = n_pods
    for name, (shape, dt) in _state_shapes(cfg, geom, s_mem,
                                           n_pods).items():
        if name == "tokens":
            state[name] = torch.zeros(shape, dtype=dt, device=devs[0])
        elif name == "memory":
            state[name] = [torch.zeros(shape, dtype=dt, device=devs[0])
                           for _ in range(geom.d_s)]
            state["mem_len"] = shape[-2] * geom.d_s
        else:
            state[name] = [[torch.zeros(shape, dtype=dt, device=dev)
                            for _ in range(geom.d_s)] for dev in devs]
    return state


def decode_state_bytes(geom: DecodeGeometry, cfg: ArchConfig, *,
                       s_mem: Optional[int] = None, n_pods: int = 1) -> int:
    """Bytes of the decode state (:func:`init_decode_state`): the
    reference's ``decode_state_struct`` (its pod dim where ``n_pods > 1``),
    every stage and rank counted once."""
    total = 0
    for name, (shape, dt) in _state_shapes(cfg, geom, s_mem,
                                           n_pods).items():
        n = int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
        if name == "memory":
            n *= geom.d_s
        elif name != "tokens":
            n *= geom.d_p * geom.d_s
        total += n
    return total


def _decode_ffn(model, lp: Dict, h: torch.Tensor, d_s: int) -> torch.Tensor:
    if "moe" in lp:
        from .ep import moe_decode
        return moe_decode(model.cfg, lp["moe"], h, d_s)
    return swiglu_apply(lp["mlp"], h)


def _decode_layers(model, geom: DecodeGeometry, stage: Dict, state: Dict,
                   p: int, m: int, x: torch.Tensor, rope, memory):
    """Microbatch ``m``'s hidden rows ``x [bm, D]`` through stage ``p``'s
    active layer slots, the state's slots updated in place."""
    cfg, s = model.cfg, model.cfg.spec
    eps = cfg.rms_eps
    L_s = geom.layers_per_stage
    windows, active = _layer_tables(cfg, geom.d_p, L_s)
    length = state["length"]

    def slot(name, l):
        return None if name not in state else \
            [c[m, l] for c in state[name][p]]
    for l in range(L_s):
        if not active[p, l]:
            continue
        lp = stage["layers"][p * L_s + l]
        h = rms_norm(x, lp["ln1"], eps)
        mix = None
        if not s.attn_free:
            y = decode_attention(cfg, lp["attn"], h, slot("cache_k", l),
                                 slot("cache_v", l), length=length,
                                 window=int(windows[p, l]), rope=rope)
            if s.is_encoder_decoder:
                hx = rms_norm(x + y, lp["ln_x"], eps)
                y = y + model.cross_decode(lp["cross"], hx,
                                           [c[m] for c in memory],
                                           state["mem_len"])
            mix = y
        if s.ssm_state > 0:
            y2 = mamba_decode(cfg, lp["mamba"], h, slot("ssm_h", l),
                              slot("conv_tail", l))
            mix = y2 if mix is None else 0.5 * (mix + y2)
        # the attention term enters the residual, as in the port's one-shot
        # forward; the reference's decode_step_fn never assigns it to its
        # ``mix`` and drops it (src/repro/runtime/serve_step.py:358-385)
        x = x + mix
        if cfg.layer_kind != LayerKind.MAMBA:
            x = x + _decode_ffn(model, lp, rms_norm(x, lp["ln2"], eps),
                                geom.d_s)
    return x


@torch.no_grad()
def decode_step(model, geom: DecodeGeometry, stages: Sequence[Dict],
                state: Dict, devices) -> torch.Tensor:
    """One decode step of every sequence (the counterpart of the reference's
    ``decode_step_fn``'s ``step_local``, its dropped attention term
    restored): each sequence's ``tokens`` at position ``length``; the
    microbatches through the stages in tick order; per layer the decode
    attention, the mamba step (hybrid: their mean), the encoder-decoder's
    cross-attention, the MLP or MoE block; then the final norm and the
    vocabulary-parallel argmax. Updates ``state`` in place (the cache rows
    at ``length``, the SSM state and tails, ``tokens`` the new ids,
    ``length + 1``) and returns the ids ``[n_micro, bm]`` (int64, on the
    last stage's device). ``stages``: the decode layout's parameters
    (``weights.to_stages(..., decode=True)``), stage ``p`` on
    ``devices[p]``."""
    if state.get("n_pods", 1) > 1:
        raise NotImplementedError(
            "decode over pods: the reference only lowers it (its dry-run); "
            "run one pod's state (init_decode_state with n_pods=1)")
    s = model.cfg.spec
    d_p, nm = geom.d_p, geom.n_micro
    length = state["length"]
    if length >= geom.s_cap:
        raise ValueError(f"the cache's {geom.s_cap} rows are full")
    if s.is_encoder_decoder:
        rope = None
    else:
        rope = {dev: model.rope_tables(torch.full(
            (geom.bm,), length, dtype=torch.int32, device=dev))
            for dev in set(devices)}
    memory = {dev: [t.to(dev) for t in state["memory"]]
              for dev in set(devices)} if "memory" in state else {}
    ids = torch.empty((nm, geom.bm), dtype=torch.int64, device=devices[-1])
    streams = {}
    for t in range(nm + d_p - 1):
        for p in reversed(range(d_p)):      # stage p runs microbatch t - p
            m, dev = t - p, devices[p]
            if not 0 <= m < nm:
                continue
            if p == 0:
                x = model.embed(stages[0], state["tokens"][m].long(),
                                geom.compute_dtype)
            else:
                x = streams.pop((p - 1, m)).to(dev)
            x = _decode_layers(model, geom, stages[p], state, p, m, x,
                               None if rope is None else rope[dev],
                               memory.get(dev))
            if p < d_p - 1:
                streams[(p, m)] = x
                continue
            last = stages[-1]
            h = rms_norm(x, last["final_norm"], model.cfg.rms_eps)
            ids[m] = sp.sharded_greedy(
                h, last["unembed"] if "unembed" in last else last["embed"],
                geom.d_s, vocab_true=s.vocab)
    state["tokens"].copy_(ids.to(state["tokens"].device))
    state["length"] = length + 1
    return ids


class DecodeStepBuilder:
    """The pipelined prefill and fixed-batch decode of one model (any family
    of the registry; the reference names ``DecodeStepBuilder`` but never
    defines it): the decode layout's parameters on ``d_p`` stage devices
    (``weights.to_stages(..., decode=True)``: views of the caller's
    tensors, moved only if on another device), ``d_s`` sequence-parallel
    ranks a stage, the compute dtype; per batch the geometry
    (:attr:`geom`, set by :meth:`prefill`).

    * :meth:`prefill` ``(prompts, frames=None, max_new=1) -> (first ids,
      state)``: every prompt the same length (one length per batch);
      the cache made for ``max_new`` tokens more; a batch that does not
      fill ``n_micro`` microbatches evenly is padded with copies of its
      last prompt, whose ids are dropped;
    * :meth:`step` ``(state) -> ids``: one decode step of every sequence;
    * :meth:`generate` ``(prompts, max_new, frames=None)``: ``max_new``
      ids a prompt.

    ``frames``: the encoder-decoder's requests' frame embeddings (each
    ``[S, D]``, one ``S`` a batch). ``chunk_cap``: the prefill's rows a
    chunk (a longer prompt continues through the carry; None: whole
    prompts). Entry point: every stage on ``cuda`` unless ``device`` says
    otherwise."""

    def __init__(self, cfg: ArchConfig, params: Dict, *, d_p: int = 1,
                 d_s: int = 1, compute_dtype=torch.bfloat16, device=None,
                 chunk_cap: Optional[int] = None):
        from repro_torch.device import resolve_device
        from repro_torch.models.encdec import EncDecLM
        from repro_torch.models.model import tree_map
        from repro_torch.weights import to_stages

        from .encdec_pipeline import EncDecDecodeStage
        from .pipeline import PipelineGeometry, PipelineStage
        from .sharding import stage_blocks
        s = cfg.spec
        self.cfg, self.d_p, self.d_s = cfg, d_p, d_s
        self.dtype = compute_dtype
        self.devices = [resolve_device(device)] * d_p
        if chunk_cap is not None and chunk_cap < 1:
            raise ValueError(f"chunk_cap={chunk_cap} must be >= 1")
        self.chunk_cap = chunk_cap
        self.encdec = s.is_encoder_decoder
        self.model = EncDecLM(cfg) if self.encdec else DecoderLM(cfg)
        self.stages = [tree_map(lambda t, dev=dev: t.to(dev), st)
                       for st, dev in zip(to_stages(cfg, params, d_p,
                                                    decode=True),
                                          self.devices)]
        blocks = stage_blocks(d_p, s.n_layers)
        # the prefill's stages: on d_s > 1 ranks the decoder runs the
        # allgather_kv model (the encoder-decoder's prefill runs on one)
        self.sp_prefill = d_s > 1 and not self.encdec
        pmodel = sp.make_model(cfg, "allgather_kv", d_s) \
            if self.sp_prefill else self.model
        if self.encdec:
            self.pstages = [EncDecDecodeStage(self.model, p, d_p, blocks[p],
                                              st, dev, compute_dtype)
                            for p, (st, dev) in enumerate(zip(
                                self.stages, self.devices))]
        else:
            self.pstages = [PipelineStage(pmodel, p, PipelineGeometry(d_p),
                                          blocks[p], st, dev, compute_dtype)
                            for p, (st, dev) in enumerate(zip(
                                self.stages, self.devices))]
        self.geom: Optional[DecodeGeometry] = None
        self.batch = 0

    # ------------------------------------------------------------------
    def _zero_carry(self, p: int):
        """Stage ``p``'s empty carry: a ``LayerCtx`` of per-layer lists (on
        SP ranks, the allgather_kv layout: a list of one per layer)."""
        st = self.pstages[p]
        n = len(st.blocks[0])
        if self.encdec:
            s = self.cfg.spec
            z = [torch.zeros((0, s.n_kv_heads, s.head_dim), dtype=self.dtype,
                             device=st.device) for _ in range(n)]
            return LayerCtx(z, [t.clone() for t in z])
        ctx = st._zero_carry(n)
        if self.sp_prefill:
            ctx = LayerCtx(*[None if f is None else [[t] for t in f]
                             for f in ctx])
        return ctx

    def _chunk(self, p: int, tokens, lo: int, hi: int):
        """Rows ``lo..hi-1`` of one prompt on stage ``p``'s device:
        ``(tokens, seg, pos)``; on SP ranks lists over ``d_s`` contiguous
        blocks, the last ones padded (segment -1)."""
        dev = self.pstages[p].device
        n = hi - lo
        tok = torch.as_tensor(tokens[lo:hi], dtype=torch.int64, device=dev)
        pos = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        seg = torch.zeros(n, dtype=torch.int32, device=dev)
        if not self.sp_prefill:
            return tok, seg, pos
        b = -(-n // self.d_s)
        pad = b * self.d_s - n
        tok = torch.cat([tok, tok.new_zeros(pad)])
        pos = torch.cat([pos, pos.new_zeros(pad)])
        seg = torch.cat([seg, seg.new_full((pad,), -1)])
        return tuple(list(t.split(b)) for t in (tok, seg, pos))

    def _store(self, state: Dict, p: int, ctx, m: int, b: int, n: int):
        """Stage ``p``'s carry of one sequence (``n`` rows) into its slot
        ``(m, b)`` of the state: KV rows into the ranks' blocks, the SSM
        state and tail into their channel blocks."""
        geom = self.geom
        s_loc, d = geom.s_loc, geom.d_s

        def one(f):
            return f[0] if self.sp_prefill else f
        for l in range(len(self.pstages[p].blocks[0])):
            for name, f in (("cache_k", ctx.k), ("cache_v", ctx.v)):
                if name not in state:
                    continue
                rows = one(f[l])
                for r, blk in enumerate(state[name][p]):
                    lo = r * s_loc
                    cnt = max(0, min(n - lo, s_loc))
                    if cnt:
                        blk[m, l, b, :cnt] = rows[lo:lo + cnt]
            if "ssm_h" in state:
                h, tail = one(ctx.ssm_h[l]), one(ctx.ssm_tail[l])
                dl = h.shape[0] // d
                for r in range(d):
                    c = slice(r * dl, (r + 1) * dl)
                    state["ssm_h"][p][r][m, l, b] = h[c]
                    state["conv_tail"][p][r][m, l, b] = tail[:, c]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, prompts: Sequence[Sequence[int]], frames=None, *,
                max_new: int = 1) -> Tuple[List[int], Dict]:
        """Each prompt's cache and its first generated id (the greedy id at
        its last row): one sequence a chunk through the stages
        (``PipelineStage.prefill``), chunks of ``chunk_cap`` rows, the
        carry copied into the sequence's slot at its end. Returns the
        first ids (one a prompt) and the decode state, ``length`` the
        prompts' length and ``tokens`` those ids."""
        s = self.cfg.spec
        lens = {len(p) for p in prompts}
        if len(lens) != 1 or 0 in lens:
            raise ValueError(f"one prompt length a batch, not {sorted(lens)}"
                             f": per-sequence lengths are ROADMAP.md queue "
                             f"1, item 7")
        if self.encdec != (frames is not None):
            raise ValueError("frames are the encoder-decoder's input, and "
                             "it needs them")
        n, B = lens.pop(), len(prompts)
        nm = min(self.d_p, B)
        B_pad = -(-B // nm) * nm
        prompts = list(prompts) + [prompts[-1]] * (B_pad - B)
        if frames is not None:
            frames = list(frames) + [frames[-1]] * (B_pad - B)
        # rows 0 .. n + max_new - 2 are written; s_loc a multiple of 64
        rows = n + max(0, max_new - 1)
        s_loc = -(-rows // (64 * self.d_s)) * 64
        self.geom = geom = make_decode_geometry(
            self.cfg, d_p=self.d_p, d_s=self.d_s, batch_per_pod=B_pad,
            cache_len=s_loc * self.d_s - self.d_s,
            compute_dtype=self.dtype)
        self.batch = B
        s_mem = None
        if frames is not None:
            s_mem = -(-frames[0].shape[0] // self.d_s) * self.d_s
        state = init_decode_state(self.cfg, geom, self.devices, s_mem=s_mem)
        if frames is not None:
            state["mem_len"] = frames[0].shape[0]
        cap = self.chunk_cap or n
        first = []
        for i, prompt in enumerate(prompts):
            m, b = divmod(i, geom.bm)
            extra = {}
            if self.encdec:
                mem = self.pstages[0].encode(frames[i])
                ml = mem.shape[0]
                for r, blk in enumerate(state["memory"]):
                    lo = r * blk.shape[2]
                    cnt = max(0, min(ml - lo, blk.shape[2]))
                    if cnt:
                        blk[m, b, :cnt] = mem[lo:lo + cnt]
            ctxs = [self._zero_carry(p) for p in range(self.d_p)]
            for lo in range(0, n, cap):
                hi = min(n, lo + cap)
                x = None
                for p, st in enumerate(self.pstages):
                    tok, seg, pos = self._chunk(p, prompt, lo, hi)
                    if self.encdec:
                        mm = mem.to(st.device)
                        extra = dict(memory=mm, seg_mem=torch.zeros(
                            mm.shape[0], dtype=torch.int32,
                            device=st.device))
                    if x is not None:
                        x = [t.to(st.device) for t in x] \
                            if isinstance(x, list) else x.to(st.device)
                    x, ctxs[p] = st.prefill(x, tok, seg, pos, ctxs[p], lo,
                                            **extra)
            last = self.stages[-1]
            head = last["unembed"] if "unembed" in last else last["embed"]
            eps = self.cfg.rms_eps
            row = torch.tensor([hi - lo - 1], device=self.devices[-1])
            if isinstance(x, list):
                h = [rms_norm(t, last["final_norm"], eps) for t in x]
            else:
                h = rms_norm(x, last["final_norm"], eps)
            first.append(int(sp.sharded_greedy(h, head, self.d_s,
                                               vocab_true=s.vocab,
                                               rows=row)[0]))
            for p in range(self.d_p):
                self._store(state, p, ctxs[p], m, b, n)
        state["tokens"].copy_(torch.as_tensor(first, dtype=torch.int32)
                              .reshape(geom.n_micro, geom.bm))
        state["length"] = n
        return first[:B], state

    def step(self, state: Dict) -> List[int]:
        """One decode step of every sequence: the next id of each (the
        batch's, its padding dropped)."""
        ids = decode_step(self.model, self.geom, self.stages, state,
                          self.devices)
        return ids.reshape(-1)[:self.batch].tolist()

    def generate(self, prompts: Sequence[Sequence[int]], max_new: int,
                 frames=None) -> List[List[int]]:
        """``max_new`` greedy ids for each prompt: :meth:`prefill`, then
        ``max_new - 1`` steps."""
        first, state = self.prefill(prompts, frames, max_new=max_new)
        out = [[t] for t in first]
        for _ in range(max_new - 1):
            for o, t in zip(out, self.step(state)):
                o.append(t)
        return out
