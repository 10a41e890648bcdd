"""Attention: GQA projection (+RoPE, +qk-norm), MLA (deepseek-v2's latent
attention), the encoder-decoder's cross-attention, the local attention
policy and the attention block.

Counterpart of the JAX package's ``models/attention.py`` (GQA with RoPE
or qwen2-vl's M-RoPE, qk-norm, and MLA). Packed-varlen semantics: a chunk
is a flat token buffer ``[T]`` with ``seg`` (segment id per token, -1 =
padding) and ``pos`` (position within the owning sequence). Split-chunk
context arrives as KV buffers whose first ``ctx_len`` entries are valid;
context rows belong to segment 0 and carry positions ``0..ctx_len-1``.

MLA (``kv_lora_rank > 0``): a token's KV state is one latent row ``[1, r +
rr]`` (the compressed ``c_kv`` and the shared rope key ``k_r``); the
policy expands the carry's and the chunk's latent rows into per-head keys
``[S, Hq, Dh + rr]`` and values ``[S, Hq, Dh]`` just before kernel A
(:func:`mla_expand_ctx`), whose key width is then ``Dh + rr`` (192 at
deepseek-v2-lite) and value width ``Dh`` (128). The carry holds the latent
rows only; its value field is None. Under autograd the expansion and the
attention are one function (:func:`mla_attention`) that keeps the latent
rows and makes the keys and values again in its backward, so a layer
keeps ``r + rr`` values a key row rather than ``Hq (2 Dh + rr)``.

Cross-attention (:func:`cross_attention`, seamless-m4t-v2's decoder)
attends a chunk's token rows to the encoder's memory rows, non-causal at
zero positions; under autograd it keeps the memory rows, which every
decoder layer shares, and makes each layer's keys and values again in its
backward. The encoder's self-attention is the attention block with
``causal=False``.

Decode (:func:`decode_attention`, the reference's ``_attn_decode``): one
new row for each of ``bm`` sequences against a cache sharded over the
sequence-parallel ranks in contiguous row blocks; the new key and value
(MLA: the latent row) go into the rank that owns their row, each rank
runs kernel A with its log-sum-exp over its own rows (each sequence its
own segment), and the ranks' partials merge by their log-sum-exps
(``runtime/sp.merge_partials``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import apply_rope, dense_init, linear, rms_norm, \
    weight_grad_store, weight_key

__all__ = ["init_attention", "project_qkv", "mla_expand_ctx",
           "mla_attention", "cross_attention", "attention_block",
           "attention_block_sp", "context_keys",
           "make_local_attention_policy", "decode_attention", "decode_meta"]


def init_attention(cfg: ArchConfig, gen: torch.Generator, *, device,
                   dtype=torch.float32) -> Dict:
    s = cfg.spec
    D, Dh, Hq, Hkv = s.d_model, s.head_dim, s.n_heads, s.n_kv_heads
    kw = dict(dtype=dtype, device=device)
    if s.kv_lora_rank > 0:  # MLA, the reference's leaves
        r, rr = s.kv_lora_rank, s.qk_rope_dim
        return {"wq": dense_init(gen, D, Hq * (Dh + rr), **kw),
                "w_dkv": dense_init(gen, D, r, **kw),
                "w_kr": dense_init(gen, D, rr, **kw),
                "w_uk": dense_init(gen, r, Hq * Dh, **kw),
                "w_uv": dense_init(gen, r, Hq * Dh, **kw),
                "wo": dense_init(gen, Hq * Dh, D, **kw)}
    p = {"wq": dense_init(gen, D, Hq * Dh, **kw),
         "wk": dense_init(gen, D, Hkv * Dh, **kw),
         "wv": dense_init(gen, D, Hkv * Dh, **kw),
         "wo": dense_init(gen, Hq * Dh, D, **kw)}
    if s.qk_norm:
        p["q_norm"] = torch.zeros((Dh,), **kw)
        p["k_norm"] = torch.zeros((Dh,), **kw)
    return p


def project_qkv(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                pos: torch.Tensor, rope: Optional[Tuple] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
    """x: [T, D] -> q [T, Hq, Dh], k [T, Hkv, Dh], v [T, Hkv, Dh].
    ``rope``: precomputed ``layers.rope_tables(pos, ...)``, if any (for
    MLA, tables of ``qk_rope_dim`` channels; for M-RoPE,
    ``layers.mrope_tables``). M-RoPE without tables rotates at ``pos``
    on all three position rows (text tokens, the reference's default),
    whose tables are RoPE's to the bit.

    MLA: q ``[T, Hq, Dh + rr]`` (its last ``rr`` channels rotated), k the
    latent row ``[T, 1, r + rr]`` (``c_kv`` and the rotated shared rope
    key) and v None: the values live in the latent rows."""
    s = cfg.spec
    Dh, Hq, Hkv = s.head_dim, s.n_heads, s.n_kv_heads
    if s.kv_lora_rank > 0:
        q = linear(x, p["wq"]).reshape(-1, Hq, Dh + s.qk_rope_dim)
        q = torch.cat([q[..., :Dh], apply_rope(q[..., Dh:], pos,
                                               cfg.rope_theta, rope)],
                      dim=-1)
        k_r = apply_rope(linear(x, p["w_kr"])[:, None, :], pos,
                         cfg.rope_theta, rope)
        rows = torch.cat([linear(x, p["w_dkv"])[:, None, :], k_r], dim=-1)
        return q, rows, None
    q = linear(x, p["wq"]).reshape(-1, Hq, Dh)
    k = linear(x, p["wk"]).reshape(-1, Hkv, Dh)
    v = linear(x, p["wv"]).reshape(-1, Hkv, Dh)
    if s.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if cfg.rope_kind in ("rope", "mrope"):
        q = apply_rope(q, pos, cfg.rope_theta, rope)
        k = apply_rope(k, pos, cfg.rope_theta, rope)
    return q, k, v


def mla_expand_ctx(cfg: ArchConfig, p: Dict, rows: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand MLA latent rows ``[S, 1, r + rr]`` into per-head keys ``[S,
    Hq, Dh + rr]`` (the up-projected ``c_kv``, then the shared rope key on
    every head) and values ``[S, Hq, Dh]``."""
    k, v, _ = _expand(rows, p["w_uk"], p["w_uv"], cfg.spec.n_heads,
                      cfg.spec.head_dim)
    return k, v


def _expand(rows, w_uk, w_uv, heads: int, Dh: int):
    """The expansion of :func:`mla_expand_ctx`: ``(k, v, c)``, ``c`` the
    latent part of ``rows`` (``[S, r]``)."""
    r = w_uk.shape[1]
    c, k_r = rows[:, 0, :r], rows[:, 0, r:]
    k = torch.cat([F.linear(c, w_uk.to(c.dtype)).reshape(-1, heads, Dh),
                   k_r[:, None, :].expand(-1, heads, -1)], dim=-1)
    return k, F.linear(c, w_uv.to(c.dtype)).reshape(-1, heads, Dh), c


class _MLAAttention(torch.autograd.Function):
    """Attention over MLA latent rows: the expansion (:func:`_expand`),
    then kernel A (``ops.attention_forward``). It keeps q, the latent rows,
    the up-projections and what kernel A′ reads (the output, its lse, the
    tile ranges), not the expanded keys and values: the backward makes
    them again (two products of ``r`` columns), runs kernel A′
    (``ops.attention_backward``) and takes their gradients back through
    the expansion (the rope key's summed over the heads). The weight
    gradients are the products autograd's linear backward computes
    (``dy.T @ c``); under ``layers.deferred_weight_grads`` they go to the
    store."""

    @staticmethod
    def forward(ctx, q, rows, w_uk, w_uv, seg_q, seg_kv, pos_q, pos_kv,
                heads, Dh, causal, window, scale):
        from repro_torch.kernels.ops import attention_forward
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        ctx.shape, ctx.store = (heads, Dh), weight_grad_store()
        ctx.leaves = (weight_key(w_uk), weight_key(w_uv))
        k, v, _ = _expand(rows, w_uk, w_uv, heads, Dh)
        out, saved, _, ctx.tiles = attention_forward(
            q, k, v, seg_q, seg_kv, pos_q, pos_kv, **ctx.opts)
        ctx.save_for_backward(rows, w_uk, w_uv, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.ops import attention_backward
        rows, w_uk, w_uv, *saved = ctx.saved_tensors
        heads, Dh = ctx.shape
        k, v, c = _expand(rows, w_uk, w_uv, heads, Dh)
        dq, dk, dv = attention_backward(saved, ctx.tiles, k, v, dout,
                                        **ctx.opts)
        del k, v
        S = rows.shape[0]
        dk_nope = dk[..., :Dh].reshape(S, heads * Dh)
        dv = dv.reshape(S, heads * Dh)
        dc = dk_nope.mm(w_uk.to(c.dtype)) + dv.mm(w_uv.to(c.dtype))
        drows = torch.cat([dc, dk[..., Dh:].sum(1)], dim=-1)[:, None, :]
        # (the products keep the weights' dtype, not the weights: a
        # ZeRO-3 gathered copy must not live on in the W store)
        products = [lambda dy=dy, dt=w.dtype: dy.t().mm(c).to(dt)
                    for dy, w in ((dk_nope, w_uk), (dv, w_uv))]
        if ctx.store is not None:
            ctx.store.extend(zip(ctx.leaves, products))
            grads = (None, None)
        else:
            grads = tuple(p() if need else None for p, need in
                          zip(products, ctx.needs_input_grad[2:4]))
        return (dq, drows, *grads, None, None, None, None, None, None,
                None, None, None)


def mla_attention(cfg: ArchConfig, p: Dict, q, rows, seg_q, seg_kv, pos_q,
                  pos_kv, *, causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """MLA's attention over latent rows ``[S, 1, r + rr]`` (the carry's
    and the chunk's) for queries ``q [T, Hq, Dh + rr]``: the same as
    ``flash_attention(q, *mla_expand_ctx(cfg, p, rows), ...)``, ``[T, Hq,
    Dh]``; under autograd one function that keeps the latent rows, not the
    expanded keys and values (:class:`_MLAAttention`)."""
    from repro_torch.kernels.ops import flash_attention
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, rows, p["w_uk"], p["w_uv"])):
        s = cfg.spec
        return _MLAAttention.apply(q, rows, p["w_uk"], p["w_uv"], seg_q,
                                   seg_kv, pos_q, pos_kv, s.n_heads,
                                   s.head_dim, causal, int(window), scale)
    k, v = mla_expand_ctx(cfg, p, rows)
    return flash_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                           causal=causal, window=window, scale=scale)


def _cross_kv(memory, wk, wv, heads: int, Dh: int):
    """The keys and values ``[S, heads, Dh]`` of the memory rows."""
    return (F.linear(memory, wk.to(memory.dtype)).reshape(-1, heads, Dh),
            F.linear(memory, wv.to(memory.dtype)).reshape(-1, heads, Dh))


class _CrossAttention(torch.autograd.Function):
    """Cross-attention over the memory rows (the encoder's output, ``[S,
    D]``): the key and value projections, then kernel A, non-causal at
    zero positions, queries paired with memory rows by segment id. It
    keeps q, the memory (which every decoder layer of a stage shares), the
    two projections and what kernel A′ reads (the output, its lse, the
    tile ranges), not the layer's keys and values: the backward makes them
    again (two products), runs kernel A′ and takes their gradients back
    through the projections (the memory's summed over both). The weight
    gradients are the products autograd's linear backward computes (``dy.T
    @ memory``); under ``layers.deferred_weight_grads`` they are made in
    the backward and the store hands them to the W pass (so no ``[S,
    Hkv Dh]`` gradient waits for it)."""

    @staticmethod
    def forward(ctx, q, memory, wk, wv, seg_q, seg_kv, heads, Dh, scale):
        from repro_torch.kernels.ops import attention_forward
        ctx.opts = dict(causal=False, window=0, scale=scale)
        ctx.shape, ctx.store = (heads, Dh), weight_grad_store()
        ctx.leaves = (weight_key(wk), weight_key(wv))
        k, v = _cross_kv(memory, wk, wv, heads, Dh)
        out, saved, _, ctx.tiles = attention_forward(
            q, k, v, seg_q, seg_kv, *_zero_pos(seg_q, seg_kv), **ctx.opts)
        ctx.save_for_backward(memory, wk, wv, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.ops import attention_backward
        memory, wk, wv, *saved = ctx.saved_tensors
        heads, Dh = ctx.shape
        k, v = _cross_kv(memory, wk, wv, heads, Dh)
        dq, dk, dv = attention_backward(saved, ctx.tiles, k, v, dout,
                                        **ctx.opts)
        del k, v
        S, dt = memory.shape[0], memory.dtype
        dk, dv = dk.reshape(S, -1), dv.reshape(S, -1)
        dmem = dk.mm(wk.to(dt)) + dv.mm(wv.to(dt))
        mem = memory.detach()
        if ctx.store is not None:
            # the split backward's W pass takes the two products made
            # here: deferred, they would keep this rank's dK and dV of the
            # whole memory (2 S Hkv Dh values a layer) until the W pass
            # (the dry-run's seamless-m4t-v2 train_4k cell: 8.4 GB a rank)
            made = [dy.t().mm(mem).to(w.dtype)
                    for dy, w in ((dk, wk), (dv, wv))]
            ctx.store.extend((leaf, lambda g=g: g)
                             for leaf, g in zip(ctx.leaves, made))
            grads = (None, None)
        else:
            grads = tuple(dy.t().mm(mem).to(w.dtype) if need else None
                          for dy, w, need in zip((dk, dv), (wk, wv),
                                                 ctx.needs_input_grad[2:4]))
        return (dq, dmem, *grads, None, None, None, None, None)


def _zero_pos(seg_q, seg_kv):
    return (torch.zeros_like(seg_q, dtype=torch.int32),
            torch.zeros_like(seg_kv, dtype=torch.int32))


def cross_attention(q, memory, wk, wv, seg_q, seg_kv, *, heads: int,
                    scale: float) -> torch.Tensor:
    """Encoder-decoder cross-attention: queries ``q [T, Hq, Dh]`` over
    the memory rows ``memory [S, D]`` (``S`` unrelated to ``T``), through
    the memory's keys and values ``memory @ wk.T``, ``memory @ wv.T``
    (``heads`` KV heads of ``Dh``), non-causal at zero positions, a query
    row attending to the memory rows of its own segment (``seg_q``,
    ``seg_kv``; -1 = padding): ``[T, Hq, Dh]``. Under autograd one
    function that keeps the memory, not the keys and values
    (:class:`_CrossAttention`)."""
    from repro_torch.kernels.ops import flash_attention
    Dh = q.shape[-1]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, memory, wk, wv)):
        return _CrossAttention.apply(q, memory, wk, wv, seg_q, seg_kv,
                                     heads, Dh, scale)
    k, v = _cross_kv(memory, wk, wv, heads, Dh)
    return flash_attention(q, k, v, seg_q, seg_kv, *_zero_pos(seg_q, seg_kv),
                           causal=False, scale=scale)


def _append(buf: torch.Tensor, rows: torch.Tensor, offset: int
            ) -> torch.Tensor:
    """Copy of ``buf`` with ``rows`` written at ``offset`` (where they
    fit)."""
    out = buf.clone()
    out[offset:offset + rows.shape[0]] = rows.to(buf.dtype)
    return out


def context_keys(ctx_k, ctx_v, k_cur, v_cur, seg_kv, pos_kv, ctx_len: int):
    """The keys a chunk attends to behind a context carry: the carry's
    ``ctx_len`` live rows (segment 0, positions ``0..ctx_len-1``) in front
    of the chunk's KV rows ``k_cur``, ``v_cur`` (segments ``seg_kv``,
    positions ``pos_kv``), dead rows after them up to a multiple of the
    kernel's KV tile: ``(kk, vv, kv_seg, kv_pos, new_k, new_v)``. The new
    carry is the old one with the chunk's rows at ``ctx_len``: a copy when
    the old one has room for them, else that very concatenation (a carry
    that grows with its sequence, as the training steps' do: they start
    each one empty, so each chunk keeps its context once, in the keys its
    attention saves). MLA: ``ctx_v`` and ``v_cur`` are None."""
    from repro_torch.kernels.flash_attention import BLOCK_KV
    C, T = int(ctx_len), k_cur.shape[0]
    pad = -(C + T) % BLOCK_KV

    def keys(ctx, cur):
        if ctx is None:
            return None
        return torch.cat([ctx[:C], cur.to(ctx.dtype),
                          ctx.new_zeros((pad, *ctx.shape[1:]))])
    kk, vv = keys(ctx_k, k_cur), keys(ctx_v, v_cur)
    kv_seg = torch.cat([seg_kv.new_zeros(C), seg_kv,
                        seg_kv.new_full((pad,), -1)])
    kv_pos = torch.cat([torch.arange(C, dtype=pos_kv.dtype,
                                     device=pos_kv.device), pos_kv,
                        pos_kv.new_zeros(pad)])
    if C + T > ctx_k.shape[0]:
        new_k, new_v = kk, vv
    else:
        new_k = _append(ctx_k, k_cur, C)
        new_v = None if ctx_v is None else _append(ctx_v, v_cur, C)
    return kk, vv, kv_seg, kv_pos, new_k, new_v


def make_local_attention_policy() -> Callable:
    """Single-device attention policy: the chunk's KV rows behind the
    carry's live rows (:func:`context_keys`), attended through the kernel
    dispatch :func:`repro_torch.kernels.ops.flash_attention`. MLA: the
    carry and the chunk's rows are latent rows (``ctx_v`` and ``v_cur``
    None), which ``mla_fn`` (:func:`mla_attention` with the layer's
    weights) attends in place of the kernel dispatch."""
    from repro_torch.kernels.ops import flash_attention

    def policy(q, k_cur, v_cur, *, seg, pos, ctx_k, ctx_v, ctx_len,
               causal, window, scale, mla_fn=None):
        if ctx_k is not None:
            kk, vv, kv_seg, kv_pos, new_k, new_v = context_keys(
                ctx_k, ctx_v, k_cur, v_cur, seg, pos, ctx_len)
        else:
            kk, vv, kv_seg, kv_pos = k_cur, v_cur, seg, pos
            new_k = new_v = None
        opts = dict(causal=causal, window=window, scale=scale)
        if mla_fn is None:
            out = flash_attention(q, kk, vv, seg, kv_seg, pos, kv_pos, **opts)
        else:
            out = mla_fn(q, kk, seg, kv_seg, pos, kv_pos, **opts)
        return out, new_k, new_v

    return policy


def attention_block(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                    pos: torch.Tensor, seg: torch.Tensor,
                    ctx_k: Optional[torch.Tensor],
                    ctx_v: Optional[torch.Tensor], ctx_len: int,
                    window: int, attn_fn: Callable, causal: bool = True,
                    rope: Optional[Tuple] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """Returns (block_out [T, D], new_ctx_k, new_ctx_v). ``rope``: the
    chunk's ``layers.rope_tables`` (or ``mrope_tables``), if the caller has
    them (M-RoPE at 3-D positions needs them). MLA scales the
    scores by ``1/sqrt(Dh + rr)``, its keys' width; its output is the
    values' ``Dh`` columns."""
    T = x.shape[0]
    q, k_cur, v_cur = project_qkv(cfg, p, x, pos, rope)
    scale, mla_fn = _scale_and_mla(cfg, p)
    out, new_k, new_v = attn_fn(
        q, k_cur, v_cur, seg=seg, pos=pos, ctx_k=ctx_k, ctx_v=ctx_v,
        ctx_len=ctx_len, causal=causal, window=window, scale=scale,
        mla_fn=mla_fn)
    y = linear(out.reshape(T, -1), p["wo"])
    return y, new_k, new_v


def _scale_and_mla(cfg: ArchConfig, p: Dict):
    """The scores' scale and, for MLA, the attention over latent rows
    (scaled by ``1/sqrt(Dh + rr)``, its keys' width)."""
    s = cfg.spec
    if s.kv_lora_rank > 0:
        return (1.0 / math.sqrt(s.head_dim + s.qk_rope_dim),
                functools.partial(mla_attention, cfg, p))
    return 1.0 / math.sqrt(s.head_dim), None


def attention_block_sp(cfg: ArchConfig, p: Dict, xs, *, poss, segs,
                       ctx_k, ctx_v, ctx_len: int, window: int,
                       attn_fn: Callable, ropes, causal: bool = True
                       ) -> Tuple[list, object, object]:
    """:func:`attention_block` over an SP group's token blocks ``xs`` (a
    list, rank order): the projections per rank (each at its own positions
    and rotation tables ``ropes``), the group's attention policy
    (``runtime/sp``) on the lists, the output projection per rank. The
    carries ``ctx_k``, ``ctx_v`` are lists in the policy's layout;
    ``causal=False``: the encoder's self-attention over frame blocks."""
    qs, ks, vs = zip(*[project_qkv(cfg, p, x, pos, rope)
                       for x, pos, rope in zip(xs, poss, ropes)])
    scale, mla_fn = _scale_and_mla(cfg, p)
    outs, new_k, new_v = attn_fn(
        qs, ks, vs, segs=segs, poss=poss, ctx_k=ctx_k, ctx_v=ctx_v,
        ctx_len=ctx_len, causal=causal, window=window, scale=scale,
        mla_fn=mla_fn)
    ys = [linear(o.reshape(o.shape[0], -1), p["wo"]) for o in outs]
    return ys, new_k, new_v


@functools.lru_cache(maxsize=64)
def decode_meta(bm: int, rows: int, offset: int, device):
    """The key metadata of one rank's cache block for :func:`decode_attention`
    and the encoder-decoder's cross-attention: ``(seg_q [bm], seg_kv
    [bm * rows], row [bm * rows])``, int32: query ``b`` is segment ``b``,
    and so are sequence ``b``'s ``rows`` key rows, whose global row ids
    start at ``offset``. Made once per shape and device (read-only)."""
    seq = torch.arange(bm, dtype=torch.int32, device=device)
    row = offset + torch.arange(rows, dtype=torch.int32, device=device)
    return seq, seq.repeat_interleave(rows), row.repeat(bm)


def decode_attention(cfg: ArchConfig, p: Dict, x: torch.Tensor, cache_k,
                     cache_v, *, length: int, window: int,
                     rope: Optional[Tuple] = None) -> torch.Tensor:
    """One decode step of attention: ``x [bm, D]`` (the normed rows of
    ``bm`` sequences' new tokens, all at position ``length``) -> ``[bm,
    D]``. ``cache_k`` / ``cache_v``: the ranks' cache blocks, a list of
    ``[bm, s_loc, Hkv, Dh]`` (rank ``r`` holds rows ``r * s_loc`` to ``(r
    + 1) * s_loc - 1`` of every sequence; MLA: latent rows ``[bm, s_loc,
    1, r + rr]`` and ``cache_v`` None). The new key and value are written
    IN PLACE at row ``length`` of the rank that owns it; every rank then
    attends its rows ``<= length`` inside the ``window`` (kernel A with
    the rows' log-sum-exp, ``ops.attention_with_lse``; MLA expands its
    latent rows first, ``mla_expand_ctx``, and runs A at (Dh + rr, Dh)),
    a rank without a live row adding nothing to the merge
    (``runtime/sp.merge_partials``); the output projection."""
    from repro_torch.kernels.ops import attention_with_lse
    from repro_torch.runtime.sp import merge_partials
    bm, dev = x.shape[0], x.device
    s_loc = cache_k[0].shape[1]
    pos = torch.full((bm,), int(length), dtype=torch.int32, device=dev)
    q, k_new, v_new = project_qkv(cfg, p, x, pos, rope)
    own, loc = divmod(int(length), s_loc)
    if own >= len(cache_k):
        raise ValueError(f"row {length} is past the cache's "
                         f"{len(cache_k) * s_loc} rows")
    cache_k[own][:, loc] = k_new.to(cache_k[own].dtype)
    if cache_v is not None:
        cache_v[own][:, loc] = v_new.to(cache_v[own].dtype)
    scale, mla_fn = _scale_and_mla(cfg, p)
    outs, lses = [], []
    for r, ck in enumerate(cache_k):
        seg_q, seg_kv, row = decode_meta(bm, s_loc, r * s_loc, dev)
        rows = ck.reshape(bm * s_loc, *ck.shape[2:])
        if mla_fn is not None:
            kk, vv = mla_expand_ctx(cfg, p, rows)
        else:
            kk, vv = rows, cache_v[r].reshape(rows.shape)
        out, lse = attention_with_lse(q, kk, vv, seg_q, seg_kv, pos, row,
                                      window=window, scale=scale)
        outs.append(out)
        lses.append(lse)
    return linear(merge_partials(outs, lses).reshape(bm, -1), p["wo"])
