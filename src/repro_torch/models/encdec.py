"""Encoder-decoder backbone (seamless-m4t-v2): a bidirectional encoder over
(stub) audio-frame embeddings, then a causal decoder whose every layer
also attends to the encoder's output.

Counterpart of the JAX package's ``models/encdec.py``, in the port's
init/apply idiom: parameters are plain dicts of tensors, dense weights
``[d_out, d_in]``, and the layers are per-layer lists (each layer's
weights their own autograd leaves)::

    {"embed": [V, D], "enc_layers": [enc layer] * L_enc, "enc_norm": [D],
     "dec_layers": [dec layer] * L_dec, "final_norm": [D]}

An encoder layer holds ``ln1``, ``attn`` (wq, wk, wv, wo), ``ln2``,
``mlp``; a decoder layer adds ``ln_x`` and ``cross`` (wq, wk, wv, wo)
between its self-attention and its MLP.

* the encoder runs the attention block non-causally over a chunk's frames
  (``causal=False``, the frames' own positions); its output, normed once
  by ``enc_norm``, is the memory;
* a decoder layer runs causal self-attention over the chunk's tokens, then
  cross-attention from the tokens to the memory
  (:func:`~.attention.cross_attention`: zero positions, a token attending
  to the frames of its own segment), then the SwiGLU MLP;
* the loss is the final norm and the fused cross-entropy against the tied
  embedding (kernels B, C1, C2 on the card).

What a layer keeps for its backward: its MLP keeps its input only and
makes the gate and up projections again (``swiglu_apply(...,
recompute=True)``, one row of D a token where two of d_ff would be 16
times as many at seamless-m4t-v2's widths), and cross-attention keeps the
shared memory rows, not the layer's keys and values. The planner's memory
model, a copy of the reference's, charges an encoder-decoder stage the
activations of ``n_layers / d_p`` decoder layers, while the stage runs
all the layers of its share of the encoder or of the decoder (24 of 48 at
``d_p = 2``): the two savings keep what a stage holds under its charge.

Kernel A runs in its non-causal mode for the encoder and cross-attention,
causal for the decoder's self-attention; under autograd A′ runs for all
three. The encoder is pack-only: splitting a bidirectional encoder's input
would change the math, so no chunk carries context (the planner is pinned
to ``fixed_k=1``, as the reference's train step pins it).

On the sequence-parallel axis (the reference's ``encdec_pipeline_loss_fn``
over its model axis) the ``*_sp`` methods take a stage's ``d_s`` row
blocks, rank order, and optionally a ``runtime/sharding.Zero3`` view whose
keys name the layers (gathered inside each layer's run, as
``DecoderLM.run_layers_sp`` gathers them): the encoder's and the
decoder's self-attention run the allgather_kv policy
(``runtime/sp.make_allgather_kv_policy``: a rank's frame or token block
against the gathered rows; the encoder non-causal), the token embedding
and the loss are vocabulary-parallel (``sp.sharded_embed``,
``sp.sharded_ce``: B, C1, C2 on each vocabulary block), and the decoder's
cross-attention reads the memory of every rank: the ranks' memory blocks
gathered once per decoder stage and chunk (``sp.gather_memory``), each
rank's token block then attending to those rows through
:func:`~.attention.cross_attention`, which keeps the memory and not a
layer's keys and values. The reference gathers each layer's keys and
values instead (``encdec_pipeline.py:223-225``): the same attention, and at
seamless-m4t-v2's widths (``2 Hkv Dh = 2 D``) twice the bytes a layer
where this gathers once a stage.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (attention_block, attention_block_sp,
                        cross_attention, init_attention,
                        make_local_attention_policy)
from .config import ArchConfig, LayerKind
from .layers import (dense_init, embed_init, linear, rms_norm, swiglu_apply,
                     swiglu_init)

__all__ = ["EncDecLM"]


def _init_cross(cfg: ArchConfig, gen: torch.Generator, **kw) -> Dict:
    s = cfg.spec
    D, Dh, Hq, Hkv = s.d_model, s.head_dim, s.n_heads, s.n_kv_heads
    return {"wq": dense_init(gen, D, Hq * Dh, **kw),
            "wk": dense_init(gen, D, Hkv * Dh, **kw),
            "wv": dense_init(gen, D, Hkv * Dh, **kw),
            "wo": dense_init(gen, Hq * Dh, D, **kw)}


class EncDecLM:
    """init/apply-style encoder-decoder parameterized by ArchConfig."""

    def __init__(self, cfg: ArchConfig, attn_fn=None):
        """``attn_fn``: the self-attention policy (default: the local one;
        the ``*_sp`` methods take an SP policy over lists,
        ``runtime/sp.make_allgather_kv_policy``)."""
        s = cfg.spec
        if (not s.is_encoder_decoder or cfg.layer_kind != LayerKind.ATTN
                or s.n_experts or s.ssm_state or s.kv_lora_rank
                or cfg.local_window or cfg.rope_kind != "none"):
            raise NotImplementedError(
                f"{cfg.name}: EncDecLM runs encoder-decoders of dense "
                f"global attention layers without rope (seamless-m4t-v2)")
        self.cfg = cfg
        self.attn_fn = attn_fn or make_local_attention_policy()

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, *, device,
             dtype=torch.float32) -> Dict:
        """Random parameters with the reference's distributions (truncated
        fan-in normal dense weights, N(0, 0.02) embeddings, zero norm
        offsets), drawn from ``gen`` on ``device``; the numbers differ from
        ``jax.random``'s (:mod:`repro_torch.weights` imports the
        reference's own)."""
        s = self.cfg.spec
        kw = dict(dtype=dtype, device=device)

        def layer(dec: bool) -> Dict:
            lp = {"ln1": torch.zeros((s.d_model,), **kw),
                  "attn": init_attention(self.cfg, gen, **kw)}
            if dec:
                lp["ln_x"] = torch.zeros((s.d_model,), **kw)
                lp["cross"] = _init_cross(self.cfg, gen, **kw)
            lp["ln2"] = torch.zeros((s.d_model,), **kw)
            lp["mlp"] = swiglu_init(gen, s.d_model, s.d_ff, **kw)
            return lp
        return {"embed": embed_init(gen, s.vocab, s.d_model, **kw),
                "enc_layers": [layer(False)
                               for _ in range(s.n_encoder_layers)],
                "enc_norm": torch.zeros((s.d_model,), **kw),
                "dec_layers": [layer(True) for _ in range(s.n_layers)],
                "final_norm": torch.zeros((s.d_model,), **kw)}

    # ------------------------------------------------------------------
    def enc_layer_apply(self, lp: Dict, x: torch.Tensor, *,
                        seg: torch.Tensor, pos: torch.Tensor
                        ) -> torch.Tensor:
        """One encoder layer over frame rows ``x [S, D]``: non-causal
        self-attention, then the MLP."""
        eps = self.cfg.rms_eps
        out, _, _ = attention_block(
            self.cfg, lp["attn"], rms_norm(x, lp["ln1"], eps), pos=pos,
            seg=seg, ctx_k=None, ctx_v=None, ctx_len=0, window=0,
            attn_fn=self.attn_fn, causal=False)
        x = x + out
        return x + swiglu_apply(lp["mlp"], rms_norm(x, lp["ln2"], eps),
                                recompute=True)

    def cross_attend(self, lp: Dict, h: torch.Tensor, memory: torch.Tensor,
                     *, seg_q: torch.Tensor, seg_mem: torch.Tensor
                     ) -> torch.Tensor:
        """Cross-attention of the token rows ``h [T, D]`` to ``memory [S,
        D]``: ``[T, D]``."""
        s = self.cfg.spec
        q = linear(h, lp["wq"]).reshape(-1, s.n_heads, s.head_dim)
        out = cross_attention(q, memory, lp["wk"], lp["wv"], seg_q, seg_mem,
                              heads=s.n_kv_heads,
                              scale=1.0 / math.sqrt(s.head_dim))
        return linear(out.reshape(h.shape[0], -1), lp["wo"])

    def dec_layer_apply(self, lp: Dict, x: torch.Tensor, *,
                        pos: torch.Tensor, seg: torch.Tensor,
                        memory: torch.Tensor, seg_mem: torch.Tensor
                        ) -> torch.Tensor:
        """One decoder layer over token rows ``x [T, D]``: causal
        self-attention, cross-attention to ``memory``, the MLP."""
        return self.dec_layer_carry(lp, x, pos=pos, seg=seg, memory=memory,
                                    seg_mem=seg_mem)[0]

    def dec_layer_carry(self, lp: Dict, x: torch.Tensor, *,
                        pos: torch.Tensor, seg: torch.Tensor,
                        memory: torch.Tensor, seg_mem: torch.Tensor,
                        ctx_k=None, ctx_v=None, ctx_len: int = 0):
        """:meth:`dec_layer_apply` behind the self-attention's KV carry
        (``ctx_k``, ``ctx_v``: ``[C_cap, Hkv, Dh]``, ``ctx_len`` rows live;
        the reference's ``dec_layer_apply`` with ``ctx``): ``(x, new_k,
        new_v)``, the carry None without one (the prefill's chunks of a
        prompt hand it on)."""
        eps = self.cfg.rms_eps
        out, nk, nv = attention_block(
            self.cfg, lp["attn"], rms_norm(x, lp["ln1"], eps), pos=pos,
            seg=seg, ctx_k=ctx_k, ctx_v=ctx_v, ctx_len=ctx_len, window=0,
            attn_fn=self.attn_fn, causal=True)
        x = x + out
        x = x + self.cross_attend(lp["cross"], rms_norm(x, lp["ln_x"], eps),
                                  memory, seg_q=seg, seg_mem=seg_mem)
        return (x + swiglu_apply(lp["mlp"], rms_norm(x, lp["ln2"], eps),
                                 recompute=True), nk, nv)

    def cross_decode(self, lp: Dict, h: torch.Tensor, memory,
                     mem_len: int) -> torch.Tensor:
        """Cross-attention of one decode step (the reference's
        ``_cross_decode``): ``h [bm, D]`` (``bm`` sequences' normed rows)
        over ``memory``, the ranks' blocks of each sequence's frames
        (a list of ``[bm, s_mem_loc, D]``; frames at or past ``mem_len``
        are padding): per rank the keys and values of its frames and
        kernel A, non-causal at zero positions, with the rows'
        log-sum-exp (``ops.attention_with_lse``); the ranks' partials
        merged (``runtime/sp.merge_partials``); the output projection."""
        from repro_torch.kernels.ops import attention_with_lse
        from repro_torch.runtime.sp import merge_partials

        from .attention import _cross_kv, _zero_pos, decode_meta
        s = self.cfg.spec
        bm = h.shape[0]
        q = linear(h, lp["wq"]).reshape(bm, s.n_heads, s.head_dim)
        outs, lses = [], []
        for r, mem in enumerate(memory):
            n = mem.shape[1]
            seg_q, seg_kv, row = decode_meta(bm, n, r * n, h.device)
            seg_kv = torch.where(row < mem_len, seg_kv, -1)
            k, v = _cross_kv(mem.reshape(bm * n, -1), lp["wk"], lp["wv"],
                             s.n_kv_heads, s.head_dim)
            out, lse = attention_with_lse(
                q, k, v, seg_q, seg_kv, *_zero_pos(seg_q, seg_kv),
                causal=False, scale=1.0 / math.sqrt(s.head_dim))
            outs.append(out)
            lses.append(lse)
        return linear(merge_partials(outs, lses).reshape(bm, -1), lp["wo"])

    # ------------------------------------------------------------------
    def run_enc_layers(self, layers: Sequence[Dict], x: torch.Tensor,
                       seg: torch.Tensor, pos: torch.Tensor, *,
                       remat: int = 0) -> torch.Tensor:
        """``layers`` (encoder layers' parameters, in order) over the
        frame rows ``x``; the leading ``remat`` of them under
        non-reentrant checkpoint (recomputed in the backward)."""
        for i, lp in enumerate(layers):
            if i < remat:
                x = checkpoint(self._enc_layer, lp, x, seg, pos,
                               use_reentrant=False)
            else:
                x = self._enc_layer(lp, x, seg, pos)
        return x

    def run_dec_layers(self, layers: Sequence[Dict], x: torch.Tensor,
                       seg: torch.Tensor, pos: torch.Tensor,
                       memory: torch.Tensor, seg_mem: torch.Tensor, *,
                       remat: int = 0) -> torch.Tensor:
        """``layers`` (decoder layers' parameters) over the token rows
        ``x`` with cross-attention to ``memory``; the leading ``remat``
        under checkpoint."""
        for i, lp in enumerate(layers):
            args = (lp, x, seg, pos, memory, seg_mem)
            x = (checkpoint(self._dec_layer, *args, use_reentrant=False)
                 if i < remat else self._dec_layer(*args))
        return x

    def _enc_layer(self, lp, x, seg, pos):
        return self.enc_layer_apply(lp, x, seg=seg, pos=pos)

    def _dec_layer(self, lp, x, seg, pos, memory, seg_mem):
        return self.dec_layer_apply(lp, x, pos=pos, seg=seg, memory=memory,
                                    seg_mem=seg_mem)

    # ------------------------------------------------------------------
    # the sequence-parallel axis: lists of the ranks' row blocks

    def enc_layer_apply_sp(self, lp: Dict, xs: List[torch.Tensor], *,
                           segs, poss) -> List[torch.Tensor]:
        """:meth:`enc_layer_apply` over the ranks' frame blocks ``xs``: the
        norms, projections and MLP per rank, the self-attention non-causal
        through the SP policy (a rank's frames against every rank's)."""
        eps = self.cfg.rms_eps
        outs, _, _ = attention_block_sp(
            self.cfg, lp["attn"], [rms_norm(x, lp["ln1"], eps) for x in xs],
            poss=poss, segs=segs, ctx_k=None, ctx_v=None, ctx_len=0,
            window=0, attn_fn=self.attn_fn, ropes=[None] * len(xs),
            causal=False)
        xs = [x + o for x, o in zip(xs, outs)]
        return [x + swiglu_apply(lp["mlp"], rms_norm(x, lp["ln2"], eps),
                                 recompute=True) for x in xs]

    def dec_layer_apply_sp(self, lp: Dict, xs: List[torch.Tensor], *,
                           segs, poss, memory: Sequence[Tuple]
                           ) -> List[torch.Tensor]:
        """:meth:`dec_layer_apply` over the ranks' token blocks ``xs``:
        causal self-attention through the SP policy, then each rank's
        cross-attention to ``memory[r]`` (``(rows, segments)``:
        ``sp.gather_memory``'s), the MLP per rank."""
        eps = self.cfg.rms_eps
        outs, _, _ = attention_block_sp(
            self.cfg, lp["attn"], [rms_norm(x, lp["ln1"], eps) for x in xs],
            poss=poss, segs=segs, ctx_k=None, ctx_v=None, ctx_len=0,
            window=0, attn_fn=self.attn_fn, ropes=[None] * len(xs),
            causal=True)
        xs = [x + o for x, o in zip(xs, outs)]
        xs = [x + self.cross_attend(lp["cross"], rms_norm(x, lp["ln_x"], eps),
                                    rows, seg_q=seg, seg_mem=seg_mem)
              for x, seg, (rows, seg_mem) in zip(xs, segs, memory)]
        return [x + swiglu_apply(lp["mlp"], rms_norm(x, lp["ln2"], eps),
                                 recompute=True) for x in xs]

    def run_enc_layers_sp(self, layers: Sequence, xs: List[torch.Tensor],
                          segs, poss, *, remat: int = 0, zero3=None
                          ) -> List[torch.Tensor]:
        """:meth:`run_enc_layers` over the ranks' frame blocks; ``layers``
        the layers' parameters, or their keys in ``zero3`` (each layer
        gathered inside its run, so a remat'd layer gathers again in its
        backward; a layer without remat runs under
        ``zero3.keep_shards()``)."""
        for i, lp in enumerate(layers):
            xs = self._run_sp(self._enc_layer_sp, i < remat, zero3,
                              (lp, segs, poss, len(xs), zero3, *xs))
        return xs

    def run_dec_layers_sp(self, layers: Sequence, xs: List[torch.Tensor],
                          segs, poss, memory: List[torch.Tensor],
                          seg_mem: List[torch.Tensor], *, remat: int = 0,
                          zero3=None) -> List[torch.Tensor]:
        """:meth:`run_dec_layers` over the ranks' token blocks, the ranks'
        memory blocks ``memory`` (their frames' segments ``seg_mem``)
        gathered once for every layer (``sp.gather_memory``); ``layers``,
        ``remat`` and ``zero3`` as :meth:`run_enc_layers_sp`."""
        from repro_torch.runtime import sp
        rows = sp.gather_memory(memory, seg_mem)
        for i, lp in enumerate(layers):
            xs = self._run_sp(self._dec_layer_sp, i < remat, zero3,
                              (lp, segs, poss, rows, len(xs), zero3, *xs))
        return xs

    @staticmethod
    def _run_sp(fn, remat: bool, zero3, args) -> List[torch.Tensor]:
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        if zero3 is not None:
            with zero3.keep_shards():
                return fn(*args)
        return fn(*args)

    def _enc_layer_sp(self, lp, segs, poss, n, zero3, *xs):
        if zero3 is not None:
            lp = zero3.layer(lp)
        return self.enc_layer_apply_sp(lp, list(xs[:n]), segs=segs,
                                       poss=poss)

    def _dec_layer_sp(self, lp, segs, poss, memory, n, zero3, *xs):
        if zero3 is not None:
            lp = zero3.layer(lp)
        return self.dec_layer_apply_sp(lp, list(xs[:n]), segs=segs,
                                       poss=poss, memory=memory)

    def enc_norm_sp(self, params: Dict, xs: List[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """:meth:`enc_norm` per rank block: the memory's blocks."""
        return [self.enc_norm(params, x) for x in xs]

    def embed_sp(self, params: Dict, tokens: List[torch.Tensor], d_s: int,
                 compute_dtype=torch.bfloat16) -> List[torch.Tensor]:
        """:meth:`embed` of the ranks' token blocks, vocabulary-parallel
        over ``d_s`` row blocks of ``params["embed"]`` (the ranks' shards,
        or one table: ``runtime/sp.sharded_embed``)."""
        from repro_torch.runtime.sp import sharded_embed
        return sharded_embed(params["embed"], tokens, d_s, compute_dtype)

    def chunk_loss_sp(self, params: Dict, hidden: List[torch.Tensor],
                      targets: List[torch.Tensor], segs: List[torch.Tensor],
                      d_s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`chunk_loss` over the ranks' token blocks: the final norm
        per rank, then the vocabulary-parallel CE against ``d_s`` row
        blocks of the tied embedding (``runtime/sp.sharded_ce``: B per
        block, the log-sum-exps merged, C1 and C2 per block)."""
        from repro_torch.runtime.sp import sharded_ce
        hs = [rms_norm(h, params["final_norm"], self.cfg.rms_eps)
              for h in hidden]
        w = params["embed"]
        w = [b.to(hs[0].dtype) for b in w] if isinstance(w, (list, tuple)) \
            else w.to(hs[0].dtype)
        return sharded_ce(hs, w, [t.clamp(min=0) for t in targets],
                          [(s >= 0) & (t >= 0) for s, t in zip(segs, targets)],
                          d_s)

    # ------------------------------------------------------------------
    def enc_norm(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """The finished encoder rows normed once: the memory."""
        return rms_norm(x, params["enc_norm"], self.cfg.rms_eps)

    def encode(self, params: Dict, frames: torch.Tensor, seg: torch.Tensor,
               pos: torch.Tensor, *, remat: int = 0) -> torch.Tensor:
        """frames ``[S, D]`` (the frontend stub's embeddings, in the
        compute dtype) -> the memory ``[S, D]``."""
        return self.enc_norm(params, self.run_enc_layers(
            params["enc_layers"], frames, seg, pos, remat=remat))

    def embed(self, params: Dict, tokens: torch.Tensor,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
        return params["embed"][tokens].to(compute_dtype)

    def decode(self, params: Dict, tokens: torch.Tensor, seg: torch.Tensor,
               pos: torch.Tensor, memory: torch.Tensor,
               seg_mem: torch.Tensor, *, compute_dtype=torch.bfloat16,
               remat: int = 0) -> torch.Tensor:
        """The decoder's hidden rows ``[T, D]`` of ``tokens`` against
        ``memory`` (before the final norm)."""
        return self.run_dec_layers(
            params["dec_layers"], self.embed(params, tokens, compute_dtype),
            seg, pos, memory, seg_mem, remat=remat)

    def chunk_loss(self, params: Dict, hidden: torch.Tensor,
                   targets: torch.Tensor, seg: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum_loss, n_valid): final norm, then the fused streaming
        cross-entropy against the tied embedding (kernels B, C1, C2)."""
        from repro_torch.kernels.ops import fused_cross_entropy
        h = rms_norm(hidden, params["final_norm"], self.cfg.rms_eps)
        valid = (seg >= 0) & (targets >= 0)
        return fused_cross_entropy(h, params["embed"].to(h.dtype),
                                   targets.clamp(min=0), valid)

    def loss(self, params: Dict, frames, seg_enc, pos_enc, tokens, targets,
             seg, pos, *, compute_dtype=torch.bfloat16
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum_loss, n_valid) of one packed chunk: the frames encoded,
        the tokens decoded against that memory, the loss."""
        memory = self.encode(params, frames.to(compute_dtype), seg_enc,
                             pos_enc)
        hidden = self.decode(params, tokens, seg, pos, memory, seg_enc,
                             compute_dtype=compute_dtype)
        return self.chunk_loss(params, hidden, targets, seg)

