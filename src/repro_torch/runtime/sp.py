"""The sequence-parallel axis: the attention policies over a stage's ranks,
the vocabulary-parallel embedding and cross-entropy, and the SSM prefix
scan with its conv halo.

Counterpart of the JAX package's ``runtime/sp.py``. The reference runs
inside ``shard_map``: each device holds one token block of a chunk and
the collectives are ``all_gather``, ``all_to_all``, ``psum_scatter``,
``pmax``/``psum`` and ``ppermute``. The port is one process: a stage holds
its ``d_s`` ranks as a list, each rank's token block a tensor of its own,
and every collective here is a plain function over the list of per-rank
tensors written with differentiable torch ops (``cat``, ``split``, sums),
so autograd gives each its transpose (the all-gather's is a
reduce-scatter). Token-wise work runs once per rank on the rank's rows, so
each kernel sees the shapes it would see on ``d_s`` cards:

* ``allgather_kv`` (:func:`make_allgather_kv_policy`): the chunk's keys
  and values (MLA: its latent rows) are gathered; each rank's ``T / S``
  query rows, at the rank's own positions, attend to the context rows and
  the gathered rows (kernel A, and A′ in the backward). The context carry
  is replicated over the group: one carry the group's ranks read (they
  share a card);
* ``ulysses`` (:func:`make_ulysses_policy`): four all-to-alls; each rank
  attends all ``T`` rows with ``Hq / S`` query and ``Hkv / S`` KV heads;
  the context carry is head-sharded, one per rank;
* :func:`sharded_embed`, :func:`sharded_ce`: the vocabulary in row blocks
  over the full ``d_s`` (unequal blocks where ``V % d_s != 0``, the
  reference's padded rows dropped); the CE runs kernel B on each block,
  merges the blocks' log-sum-exps (the max under ``no_grad``) and their
  target logits, and C1 and C2 take the merged log-sum-exp;
* :func:`make_sp_ssm_scan`: each rank's summary ``(a_prod, h_last0)``
  (kernel D from a zero state), an exclusive fold over the ranks, then
  kernel D from each rank's folded ``h0`` (``dh0`` flows back to the
  fold);
* :func:`make_sp_conv_tail_exchange`: the conv halo. A rank receives the
  last ``K - 1`` **live** rows before its block, which may span several
  earlier ranks (a rank of pad rows passes the tail on unchanged); the
  reference hands on its neighbour's last rows, pad rows included, the
  defect the port fixed for chunks (``ROADMAP.md`` §3).

Sub-groups (``d_s_eff < d_s``, :func:`subgroup_info`): rank ``m`` holds
token block ``m // r`` of replica group ``m % r``; the ``r`` groups
compute the same chunk and only group 0 feeds the loss, so every token
counts once. The vocabulary stays sharded over the full ``d_s``.

:data:`STATS` counts the collectives and the bytes they would move
between ranks (forward only: the backward's transposes move the same),
and :data:`KINDS` the same by kind; ``launch/analysis.collective_counts``
reads them.

The encoder-decoder's cross-attention reads the memory of every rank:
:func:`gather_memory` gathers the ranks' memory blocks once per decoder
stage and chunk (the reference gathers each layer's keys and values,
twice the bytes a layer; :data:`STATS` counts the memory's gathers and
bytes apart, as ``memory_gathers`` and ``memory_bytes``).

The pipelined prefill and decode (``runtime/serve_step``) add two
functions: :func:`sharded_greedy`, the vocabulary-parallel argmax over the
head's row blocks, and :func:`merge_partials`, the log-sum-exp merge of
the ranks' attention over their shards of a sequence-sharded cache (the
reference's flash-decode ``pmax`` / ``psum``).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.sp import choose_sp_policy

__all__ = ["choose_policy", "subgroup_info", "row_blocks", "row_views",
           "STATS", "KINDS", "COLLECTIVE_KINDS", "count_bytes",
           "all_gather", "reduce_scatter", "all_to_all",
           "make_none_policy", "make_allgather_kv_policy",
           "make_ulysses_policy", "sharded_embed", "sharded_ce", "merge_lse",
           "sharded_greedy", "merge_partials", "gather_memory",
           "make_sp_ssm_scan", "make_sp_conv_tail_exchange", "make_model"]

# collectives run and the bytes they would move between ranks; of them,
# the encoder-decoder's memory gathers (:func:`gather_memory`)
STATS = {"collectives": 0, "bytes": 0, "memory_gathers": 0,
         "memory_bytes": 0}
# the same collectives by kind (:data:`COLLECTIVE_KINDS`): count and bytes
KINDS = {}
COLLECTIVE_KINDS = ("all-gather", "reduce-scatter", "all-to-all",
                    "all-reduce", "send-recv")


def _count(nbytes: float, kind: str) -> None:
    STATS["collectives"] += 1
    STATS["bytes"] += int(nbytes)
    rec = KINDS.setdefault(kind, {"count": 0, "bytes": 0})
    rec["count"] += 1
    rec["bytes"] += int(nbytes)


def count_bytes(nbytes: float) -> None:
    """Count one collective of ``nbytes`` that its caller moves itself
    (the serving engine's page copies between ranks: a send-recv)."""
    _count(nbytes, "send-recv")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def choose_policy(cfg, d_s: int) -> str:
    """Default SP policy at effective degree ``d_s``: the one heuristic of
    ``core/sp.py``, which the planner and the cost model resolve too."""
    return choose_sp_policy(cfg.spec, d_s)


def subgroup_info(d_s: int, d_s_eff: int):
    """``(r, sp_groups, replica_groups)`` for ``d_s_eff <= d_s``, as the
    reference's: rank ``m`` holds token block ``m // r``; ``sp_groups[j]``
    the ranks of replica group ``j`` in block order, ``replica_groups[k]``
    the ``r`` ranks of block ``k``. Both None at ``r == 1``."""
    d_s_eff = d_s_eff or d_s
    if d_s % d_s_eff:
        raise ValueError(f"d_s_eff={d_s_eff} must divide d_s={d_s}")
    r = d_s // d_s_eff
    if r == 1:
        return 1, None, None
    sp_groups = [[k * r + j for k in range(d_s_eff)] for j in range(r)]
    replica_groups = [[s * r + j for j in range(r)] for s in range(d_s_eff)]
    return r, sp_groups, replica_groups


def row_blocks(n: int, d: int) -> List[Tuple[int, int]]:
    """``(offset, rows)`` of ``d`` row blocks of ``n`` rows, each
    ``ceil(n / d)`` but the last: the reference's blocks of a table padded
    to a multiple of ``d``, the padding dropped."""
    b = -(-n // d)
    return [(min(r * b, n), max(0, min(b, n - r * b))) for r in range(d)]


# ---------------------------------------------------------------------------
# collectives over a list of per-rank tensors (the ranks share one card)

def all_gather(xs: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The rank blocks concatenated along ``dim``: every rank's view (its
    transpose splits the summed gradient of every rank's use back into the
    blocks: a reduce-scatter). A ZeRO-3 leaf gathers along its shard dim
    (``runtime/sharding.zero3_dim``)."""
    full = torch.cat(list(xs), dim=dim)
    _count((len(xs) - 1) * _nbytes(full), "all-gather")
    return full


def reduce_scatter(xs: Sequence[torch.Tensor], sizes: Sequence[int],
                   dim: int = 0) -> List[torch.Tensor]:
    """The ranks' tensors summed in rank order, split along ``dim`` into
    blocks of ``sizes`` (rank ``r`` keeps block ``r``)."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    _count((len(xs) - 1) * _nbytes(total), "reduce-scatter")
    return list(total.split(list(sizes), dim=dim))


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int, concat_dim: int
               ) -> List[torch.Tensor]:
    """Rank ``r`` receives block ``r`` (along ``split_dim``) of every
    rank's tensor, concatenated along ``concat_dim`` in rank order."""
    S = len(xs)
    parts = [x.chunk(S, dim=split_dim) for x in xs]
    _count(sum(_nbytes(x) for x in xs) * (S - 1) / S, "all-to-all")
    return [torch.cat([p[r] for p in parts], dim=concat_dim)
            for r in range(S)]


def gather_memory(memory: Sequence[torch.Tensor],
                  seg_mem: Sequence[torch.Tensor]) -> List[Tuple]:
    """The memory rows each rank's cross-attention reads: the ranks' memory
    blocks ``memory`` (the normed encoder rows, ``[S / d, D]`` each) and
    their frames' segments ``seg_mem`` gathered once (:func:`all_gather`;
    its transpose sums every rank's gradient of the memory into the
    blocks), ``(rows, segments)`` for every rank. The reference gathers
    each layer's keys and values instead (``encdec_pipeline.py:223-225``):
    the same attention, ``2 Hkv Dh`` values a frame and layer gathered
    where this gathers ``D`` a frame once a stage."""
    before = STATS["bytes"]
    rows, segs = all_gather(memory), all_gather(seg_mem)
    STATS["memory_gathers"] += 1
    STATS["memory_bytes"] += STATS["bytes"] - before
    return [(rows, segs)] * len(memory)


# ---------------------------------------------------------------------------
# attention policies: policy(qs, ks, vs, *, segs, poss, ctx_k, ctx_v,
# ctx_len, causal, window, scale, mla_fn) -> (outs, new_k, new_v); the
# carries are lists of tensors in the policy's layout (None: no context)

def _attend(q, kk, vv, seg_q, kv_seg, pos_q, kv_pos, mla_fn, opts):
    from repro_torch.kernels.ops import flash_attention
    if mla_fn is not None:
        return mla_fn(q, kk, seg_q, kv_seg, pos_q, kv_pos, **opts)
    return flash_attention(q, kk, vv, seg_q, kv_seg, pos_q, kv_pos, **opts)


def make_none_policy() -> Callable:
    """A group of one rank holds the whole chunk: the local policy
    (``models/attention.make_local_attention_policy``) on it."""
    from repro_torch.models.attention import make_local_attention_policy
    local = make_local_attention_policy()

    def policy(qs, ks, vs, *, segs, poss, ctx_k, ctx_v, ctx_len, causal,
               window, scale, mla_fn=None):
        if len(qs) != 1:
            raise ValueError(f"policy 'none' runs one rank a group, got "
                             f"{len(qs)}")
        out, nk, nv = local(qs[0], ks[0], vs[0], seg=segs[0], pos=poss[0],
                            ctx_k=None if ctx_k is None else ctx_k[0],
                            ctx_v=None if ctx_v is None else ctx_v[0],
                            ctx_len=ctx_len, causal=causal, window=window,
                            scale=scale, mla_fn=mla_fn)
        return [out], _one(nk), _one(nv)

    return policy


def _one(t):
    return None if t is None else [t]


def make_allgather_kv_policy() -> Callable:
    """The chunk's KV rows (MLA: latent rows, ``vs`` None) and their
    segments and positions gathered; each rank's queries attend to the
    replicated context's ``ctx_len`` live rows and the gathered rows
    (``models/attention.context_keys``); the new carry is one for the
    group."""
    from repro_torch.models.attention import context_keys

    def policy(qs, ks, vs, *, segs, poss, ctx_k, ctx_v, ctx_len, causal,
               window, scale, mla_fn=None):
        k_g = all_gather(ks)
        v_g = None if vs is None or vs[0] is None else all_gather(vs)
        seg_g, pos_g = all_gather(segs), all_gather(poss)
        new_k = new_v = None
        if ctx_k is not None:
            kk, vv, kv_seg, kv_pos, nk, nv = context_keys(
                ctx_k[0], None if ctx_v is None else ctx_v[0], k_g, v_g,
                seg_g, pos_g, ctx_len)
            new_k, new_v = [nk], _one(nv)
        else:
            kk, vv, kv_seg, kv_pos = k_g, v_g, seg_g, pos_g
        opts = dict(causal=causal, window=window, scale=scale)
        outs = [_attend(q, kk, vv, s, kv_seg, p, kv_pos, mla_fn, opts)
                for q, s, p in zip(qs, segs, poss)]
        return outs, new_k, new_v

    return policy


def make_ulysses_policy(d: int) -> Callable:
    """Tokens gathered and heads scattered around the attention (the
    reference's four all-to-alls: q, k, v, out); rank ``r`` attends every
    row of the chunk with query heads ``[r Hq / d, (r + 1) Hq / d)`` and
    their KV heads, against its own head-sharded context."""
    from repro_torch.models.attention import context_keys

    def policy(qs, ks, vs, *, segs, poss, ctx_k, ctx_v, ctx_len, causal,
               window, scale, mla_fn=None):
        if mla_fn is not None:
            raise ValueError("MLA runs the allgather_kv policy")
        if len(qs) != d:
            raise ValueError(f"ulysses over {d} ranks got {len(qs)}")
        q_g = all_to_all(qs, 1, 0)
        k_g = all_to_all(ks, 1, 0)
        v_g = all_to_all(vs, 1, 0)
        seg_g, pos_g = all_gather(segs), all_gather(poss)
        opts = dict(causal=causal, window=window, scale=scale)
        outs_g, new_k, new_v = [], [], []
        for r in range(d):
            if ctx_k is not None:
                kk, vv, kv_seg, kv_pos, nk, nv = context_keys(
                    ctx_k[r], ctx_v[r], k_g[r], v_g[r], seg_g, pos_g,
                    ctx_len)
                new_k.append(nk)
                new_v.append(nv)
            else:
                kk, vv, kv_seg, kv_pos = k_g[r], v_g[r], seg_g, pos_g
            outs_g.append(_attend(q_g[r], kk, vv, seg_g, kv_seg, pos_g,
                                  kv_pos, None, opts))
        outs = all_to_all(outs_g, 0, 1)
        if ctx_k is None:
            return outs, None, None
        return outs, new_k, new_v

    return policy


# ---------------------------------------------------------------------------
# vocabulary-parallel embedding and cross-entropy

def row_views(w, d_s: int) -> List[torch.Tensor]:
    """The vocabulary's row blocks over ``d_s`` ranks: ``w`` itself when it
    is a list (each rank's own shard, ``runtime/sharding``), else row views
    of the whole table over :func:`row_blocks`."""
    if isinstance(w, (list, tuple)):
        return list(w)
    return [w[off:off + rows] for off, rows in row_blocks(w.shape[0], d_s)]


def _offsets(blocks: Sequence[torch.Tensor]) -> List[int]:
    out, off = [], 0
    for b in blocks:
        out.append(off)
        off += b.shape[0]
    return out


def sharded_embed(embed, tokens: Sequence[torch.Tensor], d_s: int,
                  compute_dtype=torch.bfloat16) -> List[torch.Tensor]:
    """Each rank's rows of the embedding ``[V, D]`` (rank ``r``'s block of
    :func:`row_blocks` over ``d_s`` ranks: :func:`row_views`, a list of the
    ranks' shards or one table) looked up for the gathered ids of the
    blocks ``tokens`` (zero where an id is not in its block), then
    reduce-scattered back to the token blocks: exactly ``embed[tokens]``."""
    ids = all_gather(tokens)
    parts = []
    blocks = row_views(embed, d_s)
    for off, shard in zip(_offsets(blocks), blocks):
        rows = shard.shape[0]
        loc = ids - off
        ok = (loc >= 0) & (loc < rows)
        got = shard[loc.clamp(0, max(rows - 1, 0))].to(compute_dtype)
        parts.append(torch.where(ok[:, None], got, 0))
    return reduce_scatter(parts, [t.shape[0] for t in tokens])


class _ShardedCE(torch.autograd.Function):
    """(sum of the valid rows' losses, n_valid) over the gathered hidden
    rows against the vocabulary's row blocks ``ws`` (each rank's shard):
    kernel B per block with the targets shifted by the block's offset (a
    target outside a block matches none of its rows), the blocks'
    log-sum-exps merged (their max as a constant shift, the sum of
    exponentials, the target logits summed); backward: C1 and C2 per block
    with the merged log-sum-exp, the hidden rows' gradient summed over the
    blocks, each block's weight gradient its own shard's."""

    @staticmethod
    def forward(ctx, hidden, targets, valid, *ws):
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels.cross_entropy import TOKEN_MULTIPLE
        T = hidden.shape[0]
        hp = ops._dense(ops.pad_rows(hidden, TOKEN_MULTIPLE))
        tp = ops.pad_rows(targets.to(torch.int32), TOKEN_MULTIPLE,
                          -1).contiguous()
        vf = ops.pad_rows(valid, TOKEN_MULTIPLE, False).float()
        live = [(i, off) for i, (off, w) in enumerate(zip(_offsets(ws), ws))
                if w.shape[0]]
        lses, tls = [], []
        for i, off in live:
            wr, tr = ws[i], (tp - off).contiguous()
            if ops.on_card(hidden):
                from repro_torch.kernels.cross_entropy import ce_fwd_cuda
                lse, tl = ce_fwd_cuda(hp, ops._dense(wr), tr)
            else:
                ops.fused_cross_entropy.plain_calls += 1
                lse, tl = ref.cross_entropy_fwd_plain(hp, wr, tr)
            lses.append(lse)
            tls.append(tl)
        stack = torch.stack(lses)
        _count(2 * (len(live) - 1) * _nbytes(stack),      # lse and tl
               "all-reduce")
        lse = merge_lse(stack)
        tl = torch.stack(tls).sum(0)
        ctx.save_for_backward(hp, tp, lse, vf, *ws)
        ctx.T, ctx.live = T, live
        return ((lse - tl) * vf).sum(), vf.sum()

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        from repro_torch.kernels import ops, ref
        hp, tp, lse, vf, *ws = ctx.saved_tensors
        g_rows = (vf * g_loss.float()).contiguous()
        dh = None
        # (a block of no rows takes a zero gradient of no rows)
        dws = [torch.zeros_like(w) if ctx.needs_input_grad[3 + i]
               and not w.shape[0] else None for i, w in enumerate(ws)]
        for i, off in ctx.live:
            wr, tr = ws[i], (tp - off).contiguous()
            want_dw = ctx.needs_input_grad[3 + i]
            if ops.on_card(hp):
                from repro_torch.kernels.cross_entropy import (
                    ce_bwd_dh_cuda, ce_bwd_dw_cuda)
                wd = ops._dense(wr)
                part = ce_bwd_dh_cuda(hp, wd, tr, lse, g_rows) \
                    if ctx.needs_input_grad[0] else None
                if want_dw:
                    dws[i] = ce_bwd_dw_cuda(hp, wd, tr, lse, g_rows)
            else:
                ops.fused_cross_entropy.plain_calls += 1
                part = ref.cross_entropy_bwd_dh_plain(hp, wr, tr, lse,
                                                      g_rows) \
                    if ctx.needs_input_grad[0] else None
                if want_dw:
                    dws[i] = ref.cross_entropy_bwd_dw_plain(
                        hp, wr, tr, lse, g_rows)
            if part is not None:
                dh = part if dh is None else dh + part
        if dh is not None:
            dh = dh[:ctx.T]
        return (dh, None, None, *dws)


def merge_lse(lses: torch.Tensor) -> torch.Tensor:
    """The log-sum-exp over the whole vocabulary from the blocks' ``[d,
    T]``: their max as a constant shift (no gradient flows through it:
    logsumexp is shift-invariant), the sum of the shifted exponentials."""
    m = lses.max(0).values
    return m + torch.log(torch.exp(lses - m).sum(0).clamp_min(1e-30))


def sharded_ce(hidden: Sequence[torch.Tensor], w,
               targets: Sequence[torch.Tensor], valid: Sequence[torch.Tensor],
               d_s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vocabulary-parallel streaming CE over the token blocks ``hidden``
    (the final-normed rows), their ``targets`` and ``valid`` masks, the
    head ``w [V, D]`` in :func:`row_blocks` over ``d_s`` ranks (a list of
    the ranks' shards, or one table: :func:`row_views`; logits never
    made): ``(sum_loss, n_valid)``, as the reference's ``sharded_ce``."""
    from repro_torch.kernels.ops import _known_device
    h_g = all_gather(hidden)
    _known_device(h_g, "sharded_ce")
    t_g = all_gather(targets)
    v_g = all_gather(valid)
    return _ShardedCE.apply(h_g, t_g, v_g, *row_views(w, d_s))


@torch.no_grad()
def sharded_greedy(hidden, w, d_s: int, *, vocab_true=None, rows=None
                   ) -> torch.Tensor:
    """Vocabulary-parallel greedy ids, the reference's ``sharded_greedy``
    as ``executor.fold_greedy_ids`` calls it: the argmax of ``hidden @
    w.T`` over the vocabulary without the ``[T, V]`` logits. Each rank's
    row block of the head (:func:`row_views` over ``d_s`` ranks; a block's
    rows at or past ``vocab_true`` never win) gives its best id and logit
    (``serve_step.greedy_ids``); the ranks' bests merge as the reference's
    ``pmax`` then ``pmin``: the largest logit, ties to the lowest id.

    ``hidden``: one ``[T, D]`` tensor, the same rows on every rank (the
    decode case), or a list of the ranks' token blocks (the prefill case:
    gathered first); ``rows`` (an index tensor) picks the gathered rows to
    score, all of them if None. Returns int64 ids on ``hidden``'s
    device."""
    from .serve_step import greedy_ids
    if isinstance(hidden, (list, tuple)):
        hidden = all_gather(hidden)
    if rows is not None:
        hidden = hidden.index_select(0, rows)
    blocks = row_views(w, d_s)
    V = sum(b.shape[0] for b in blocks)
    V = V if vocab_true is None else min(V, int(vocab_true))
    best_i = best_v = None
    for off, block in zip(_offsets(blocks), blocks):
        n = min(block.shape[0], V - off)
        if n <= 0:
            continue
        ids, vals = greedy_ids(hidden, block[:n], with_max=True)
        ids = ids + off
        if best_v is None:
            best_i, best_v = ids, vals
        else:               # blocks in id order: strict > keeps the lowest
            take = vals > best_v
            best_i = torch.where(take, ids, best_i)
            best_v = torch.where(take, vals, best_v)
    _count(2 * (len(blocks) - 1) * 8 * hidden.shape[0],    # pmax, pmin
           "all-reduce")
    return best_i


def merge_partials(outs: Sequence[torch.Tensor],
                   lses: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ranks' attention over their own key rows merged into attention
    over all of them (the reference's flash-decode ``pmax`` / ``psum``
    merge): ``outs[r]`` ``[T, H, Dv]``, rank ``r``'s output normalised over
    its keys, ``lses[r]`` ``[H, T]`` its rows' log-sum-exps (``-inf`` where
    the rank holds no live key for a row, whose output adds nothing). A
    row with no live key on any rank is zero, as the port's kernel gives
    it (ROADMAP.md §3). One rank: its output unchanged. In float32, cast
    to the outputs' dtype."""
    if len(outs) == 1:
        return outs[0]
    lse = torch.stack([x.float() for x in lses])            # [d, H, T]
    m = lse.max(0).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m).transpose(1, 2)[..., None]       # [d, T, H, 1]
    den = w.sum(0)
    num = (w * torch.stack([o.float() for o in outs])).sum(0)
    out = torch.where(den > 0, num / den.clamp_min(1e-30),
                      torch.zeros_like(num))
    _count((len(outs) - 1) * (_nbytes(num) + 2 * _nbytes(m)), "all-reduce")
    return out.to(outs[0].dtype)


# ---------------------------------------------------------------------------
# the SSM prefix scan and conv halo

class ScanShard(NamedTuple):
    """One rank's inputs to the mixer's gated scan (``models/ssm``)."""
    xc: torch.Tensor
    dt_in: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    z: torch.Tensor
    live: torch.Tensor
    reset: torch.Tensor


def make_sp_ssm_scan() -> Callable:
    """``scan(p, shards, h0) -> (outs, h_last)`` over a group's
    :class:`ScanShard` list: each rank but the last makes its summary
    ``(a_prod, h_last0)``: ``h_last0`` the state leaving its block from a
    zero state (kernel D), ``a_prod`` the product of its rows' decays (0
    where a sequence starts inside the block: ``models/ssm.shard_decay``);
    the summaries are gathered and folded from ``h0`` into the state
    entering each rank; each rank then scans from its own (kernel D); the
    group's final state is the one leaving the last rank. Differentiable
    in ``h0`` and through the fold."""

    def scan(p, shards: Sequence[ScanShard], h0):
        from repro_torch.models.ssm import gated_scan, shard_decay
        zero = torch.zeros_like(h0)
        summ = []
        for a in shards[:-1]:
            _, h_last0 = gated_scan(p, *a, zero)
            summ.append((shard_decay(p, a.dt_in, a.live, a.reset), h_last0))
        if summ:
            _count(2 * (len(shards) - 1) * len(shards) * _nbytes(h0),
                   "all-gather")
        entering = [h0]
        for a_prod, h_last0 in summ:
            entering.append(a_prod * entering[-1] + h_last0)
        outs = []
        h_last = h0
        for a, h_in in zip(shards, entering):
            y, h_last = gated_scan(p, *a, h_in)
            outs.append(y)
        return outs, h_last

    return scan


def make_sp_conv_tail_exchange() -> Callable:
    """``exchange(xs, lives, resets, carried) -> (tails, new_carried)``: the
    conv halo of a group's ranks. Rank ``r``'s tail is the last ``K - 1``
    live conv inputs before its block: the carried tail (the previous
    chunk's) followed by the live rows of ranks ``< r`` (the all-gather of
    each rank's last live rows, composed from the left: ``models/ssm.
    live_tail``), rows before the last sequence start among them zeroed
    (another sequence's, which the reference's halo hands on too); the
    chunk's carried tail is the last ``K - 1`` live rows of the whole
    chunk."""

    def exchange(xs: Sequence[torch.Tensor], lives, resets, carried):
        from repro_torch.models.ssm import live_tail
        _count(len(xs) * (len(xs) - 1) * _nbytes(carried), "all-gather")
        tails, t = [], carried
        for x, live, reset in zip(xs, lives, resets):
            tails.append(t)
            t = live_tail(t, x, live, reset)
        return tails, t

    return exchange


# ---------------------------------------------------------------------------

def make_model(cfg, policy: str, d_s_eff: int):
    """The decoder of one SP group of ``d_s_eff`` ranks under ``policy``
    (the reference's ``_make_model``): the attention policy, expert
    parallelism (``runtime/ep.py``), the SSM prefix scan and conv halo."""
    from repro_torch.models.model import DecoderLM
    if policy == "ulysses":
        if d_s_eff < 2:
            raise ValueError("ulysses at d_s_eff=1 is meaningless; the "
                             "planner emits policy 'none' there")
        attn = make_ulysses_policy(d_s_eff)
    elif policy == "allgather_kv":
        attn = make_allgather_kv_policy()
    elif policy == "none":
        attn = make_none_policy()
    else:
        raise ValueError(f"unknown SP policy {policy!r}")
    moe_fn = None
    if cfg.spec.n_experts > 0:      # (one rank holding whole experts: the
        from .ep import make_moe_ep     # routed block itself, ZeRO-3's
        moe_fn = make_moe_ep(d_s_eff)   # expert shards: each its own)
    scan = tail = None
    if cfg.spec.ssm_state > 0:
        scan, tail = make_sp_ssm_scan(), make_sp_conv_tail_exchange()
    return DecoderLM(cfg, attn_fn=attn, moe_fn=moe_fn, ssm_scan_fn=scan,
                     ssm_tail_exchange=tail)
