"""The serving engine's device step on one GPU: chunked prefill and
(speculative) decode over a paged KV pool.

Counterpart of the JAX package's ``runtime/serve_step.py`` engine step
(``engine_step_fn``, ``engine_copy_fn``) at ``d_p = d_s = 1``: no
``shard_map``, no pipeline ticks, one step over all ``n_items`` items.

Each step packs ``n_items`` items of ``cap_t`` tokens; a token carries its
id, its position in its request and the step's segment id of its request.
The pool is ``[L, n_pages + 1, page_sz, Hkv, Dh]`` for K and for V; page
``n_pages`` is the trash page that padding and unmapped writes land in.

Attention: per layer the step builds ONE packed KV buffer —

* for every request in the step, its committed cache rows the layer can
  see, gathered once per request from its page table, with the request's
  segment id and their positions: rows ``0..base-1`` (``base`` = its
  committed length at step start) on a global layer, and only the last
  ``window - 1`` of them on a layer with a sliding window (the step's
  queries of the request sit at positions ``>= base``, so older rows are
  masked for all of them);
* then the step's own rows, all ``n_items * cap_t`` of them;

— and calls :func:`repro_torch.kernels.ops.flash_attention` once over all
queries. The host builds the gather list once per step for each distinct
window of the model's layers (:attr:`EngineGeometry.windows`). Several
chunks of one request in one step (later items) share the
request's segment id, so a later chunk sees the earlier one's rows exactly
as the reference's item-by-item pipeline order does. The packed-varlen
mask (same segment, causal, window) then selects, for each token, the
same keys the reference's ``_paged_attention`` selects: cache rows
``r < ctx_base`` within the window plus same-segment causal chunk rows.
After attention the chunk's K/V rows are scattered into
``(page, pos % page_sz)`` in place.

The greedy head runs only on the rows whose ids the host reads (the last
row of each prefill chunk and every decode row), vocabulary-tiled with a
running max in float32: the first index within a tile and strict ``>``
across tiles, so ties resolve to the lowest id as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import BLOCK_KV
from repro_torch.models.attention import project_qkv
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import linear, rms_norm
from repro_torch.models.model import DecoderLM, layer_params

__all__ = ["EngineGeometry", "make_engine_geometry", "init_pool",
           "PackedSegment", "KVRows", "EngineBatch", "pack_step",
           "engine_step", "copy_pages", "greedy_ids"]


@dataclass(frozen=True)
class EngineGeometry:
    """Static geometry of the engine step."""
    n_items: int             # packed chunk items per engine step
    cap_t: int               # tokens per item
    n_pages: int             # user KV pages
    page_sz: int             # cache rows per page
    pages_per_seq: int       # page-table entries per request (max context)
    k: int                   # decode tokens per stream per step (1 = greedy)
    compute_dtype: torch.dtype = torch.bfloat16
    windows: Tuple[int, ...] = (0,)   # the layers' distinct windows, 0 = none

    @property
    def trash_page(self) -> int:
        """Sentinel page id: unmapped table entries and padding writes."""
        return self.n_pages

    @property
    def max_ctx(self) -> int:
        """Rows a full page table can address (max prompt + generated)."""
        return self.pages_per_seq * self.page_sz


def make_engine_geometry(cfg: ArchConfig, *, n_items: int, cap_t: int,
                         n_pages: int, page_sz: int,
                         pages_per_seq: Optional[int] = None, k: int = 1,
                         compute_dtype=torch.bfloat16) -> EngineGeometry:
    s = cfg.spec
    if s.attn_free or s.ssm_state > 0:
        raise NotImplementedError("serving engine supports attention archs "
                                  "only")
    if s.is_encoder_decoder:
        raise NotImplementedError("serving engine is decoder-only")
    if s.kv_lora_rank > 0:
        raise NotImplementedError("MLA latent cache rows are not wired "
                                  "into the page pool")
    if min(n_items, cap_t, n_pages, page_sz, k) < 1:
        raise ValueError("n_items/cap_t/n_pages/page_sz/k must all be >= 1")
    pp = n_pages if pages_per_seq is None else pages_per_seq
    if not (1 <= pp <= n_pages):
        raise ValueError(f"pages_per_seq={pp} must be in [1, n_pages="
                         f"{n_pages}]")
    if k > cap_t:
        raise ValueError(f"k={k} cannot exceed cap_t={cap_t}")
    return EngineGeometry(n_items=n_items, cap_t=cap_t, n_pages=n_pages,
                          page_sz=page_sz, pages_per_seq=pp, k=k,
                          compute_dtype=compute_dtype,
                          windows=tuple(sorted(set(cfg.layer_windows()))))


def init_pool(cfg: ArchConfig, geom: EngineGeometry,
              device) -> Dict[str, torch.Tensor]:
    s = cfg.spec
    shape = (s.n_layers, geom.n_pages + 1, geom.page_sz, s.n_kv_heads,
             s.head_dim)
    return {name: torch.zeros(shape, dtype=geom.compute_dtype, device=device)
            for name in ("cache_k", "cache_v")}


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
    """The key rows of one window's layers: ``S - T`` gathered pool rows
    (padded to the kernel's KV tile), then the step's own ``T`` rows."""
    ctx_rows: torch.Tensor   # [S - T] int64 flat pool rows to gather
    seg: torch.Tensor        # [S] int32: gathered rows' segments, then seg
    pos: torch.Tensor        # [S] int32


@dataclass
class EngineBatch:
    """Device tensors of one step (``T = n_items * cap_t`` query rows)."""
    tokens: torch.Tensor     # [T] int64
    pos: torch.Tensor        # [T] int32
    seg: torch.Tensor        # [T] int32, request's step segment id, -1 pad
    kv: Dict[int, KVRows]    # key rows per window of geom.windows
    write_rows: torch.Tensor  # [T] int64 flat pool rows to write
    head_rows: torch.Tensor  # [N] int64 rows whose greedy id is read


def pack_step(geom: EngineGeometry, segments: Sequence[PackedSegment],
              device) -> EngineBatch:
    n, c, ps, pp = geom.n_items, geom.cap_t, geom.page_sz, geom.pages_per_seq
    T = n * c
    trash0 = geom.trash_page * ps
    tokens = np.zeros(T, np.int64)
    pos = np.zeros(T, np.int32)
    seg = np.full(T, -1, np.int32)
    # padding writes spread over the trash page's rows
    write = trash0 + (np.arange(T) % ps)
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
        page = table[np.minimum(entry, len(table) - 1)]
        write[a:a + ln] = np.where(mapped, page * ps + p % ps,
                                   trash0 + p % ps)
        head.extend(range(a, a + ln) if sg.read_all else [a + ln - 1])

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dt)
    i32, i64 = torch.int32, torch.int64
    kv = {}
    for w in geom.windows:
        rows, kseg, kpos = [np.zeros(0, np.int64)], [], []
        for sg in firsts:
            # a query at position >= base sees rows > base - w
            lo = max(0, sg.base - w + 1) if w > 0 else 0
            r = np.arange(lo, sg.base)
            table = np.asarray(sg.table, np.int64)
            rows.append(table[r // ps] * ps + r % ps)
            kseg.append(np.full(len(r), sid[sg.req_id], np.int32))
            kpos.append(r.astype(np.int32))
        # pad the gathered part to the kernel's KV tile (seg -2 rows read
        # the trash page) so the concatenated buffer needs no second
        # padding copy
        pad = (-sum(map(len, rows))) % BLOCK_KV
        rows.append(np.full(pad, trash0, np.int64))
        kseg += [np.full(pad, ops.PAD_SEG, np.int32), seg]
        kpos += [np.zeros(pad, np.int32), pos]
        kv[w] = KVRows(ctx_rows=dev(np.concatenate(rows), i64),
                       seg=dev(np.concatenate(kseg), i32),
                       pos=dev(np.concatenate(kpos), i32))
    return EngineBatch(
        tokens=dev(tokens, i64), pos=dev(pos, i32), seg=dev(seg, i32), kv=kv,
        write_rows=dev(write, i64),
        head_rows=dev(np.asarray(head, np.int64), i64))


# ---------------------------------------------------------------------------
# The step.
# ---------------------------------------------------------------------------

@torch.no_grad()
def engine_step(model: DecoderLM, geom: EngineGeometry, params: Dict,
                pool: Dict[str, torch.Tensor], batch: EngineBatch
                ) -> np.ndarray:
    """Run all layers over the packed batch, updating ``pool`` IN PLACE.
    Returns ids ``[n_items, cap_t]`` (int64): the greedy next-token id
    after each row in ``batch.head_rows``, -1 elsewhere."""
    cfg, s = model.cfg, model.cfg.spec
    dt = geom.compute_dtype
    scale = 1.0 / math.sqrt(s.head_dim)
    x = model.embed(params, batch.tokens, dt)
    T = x.shape[0]
    rope = model.rope_tables(batch.pos)
    for i, w in enumerate(cfg.layer_windows()):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = project_qkv(cfg, lp["attn"], h, batch.pos, rope)
        ck = pool["cache_k"][i].view(-1, s.n_kv_heads, s.head_dim)
        cv = pool["cache_v"][i].view(-1, s.n_kv_heads, s.head_dim)
        k, v = k.to(ck.dtype), v.to(cv.dtype)
        kv = batch.kv[w]
        kk = torch.cat([ck.index_select(0, kv.ctx_rows), k])
        vv = torch.cat([cv.index_select(0, kv.ctx_rows), v])
        out = ops.flash_attention(q, kk, vv, batch.seg, kv.seg, batch.pos,
                                  kv.pos, window=w, scale=scale)
        y = linear(out.reshape(T, -1), lp["attn"]["wo"])
        ck.index_copy_(0, batch.write_rows, k)
        cv.index_copy_(0, batch.write_rows, v)
        x = x + y
        h2 = rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + model.ffn(lp, h2)
    h_last = rms_norm(x.index_select(0, batch.head_rows),
                      params["final_norm"], cfg.rms_eps)
    ids = greedy_ids(h_last, model.head_weights(params), vocab_true=s.vocab)
    out_ids = np.full(geom.n_items * geom.cap_t, -1, np.int64)
    out_ids[batch.head_rows.cpu().numpy()] = ids.cpu().numpy()
    return out_ids.reshape(geom.n_items, geom.cap_t)


@torch.no_grad()
def copy_pages(pool: Dict[str, torch.Tensor], pairs) -> None:
    """Copy-on-write page copies, in order, in place: page ``dst`` of every
    layer becomes a copy of page ``src``."""
    for src, dst in pairs:
        for buf in pool.values():
            buf[:, dst].copy_(buf[:, src])


HEAD_BLOCK_V = 16384     # vocabulary rows per greedy-head tile


@torch.no_grad()
def greedy_ids(hidden: torch.Tensor, w: torch.Tensor, *,
               vocab_true: Optional[int] = None) -> torch.Tensor:
    """Argmax of ``hidden @ w.T`` over the vocabulary without holding the
    ``[N, V]`` logits: float32 logits per ``HEAD_BLOCK_V``-row tile of
    ``w``, a running (max, index) with strict ``>`` across tiles and the
    first index within a tile. The result is the lowest index of the
    global maximum for any tile size."""
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
    return best_i
