"""Decoder language model: dense attention, SSM (mamba) and hybrid
families.

Counterpart of the JAX package's ``models/model.py``. Parameters are plain
nested dicts of tensors in the reference's layout: layer leaves stacked
along a leading ``L`` axis, plus ``embed``, ``final_norm`` and an optional
``unembed``; dense weights are ``[d_out, d_in]``. For training,
``params["layers"]`` may instead be a list of per-layer dicts
(:func:`unstack_layers`): each layer's weights are then their own autograd
leaves, and a layer's gradient is not scattered into a zeroed ``[L, ...]``
buffer. Every layer exposes a context carry (:class:`LayerCtx`) so a later
chunk of a sequence continues the earlier ones: attention reads their KV
rows, the mamba mixer starts from their state ``(h, conv_tail)``; the
carry's gradient is the paper's dKV term (Eq. 5) and its SSM counterpart.

Layer kinds (as the reference's ``layer_apply``): ``ATTN`` (attention,
then the SwiGLU MLP), ``MOE`` (attention, then the MoE block of
:mod:`.moe`; olmoe), ``MAMBA`` (the mamba mixer alone, falcon-mamba) and
``HYBRID`` (attention and the mamba mixer in parallel on the same normed
input, averaged, then the MLP; hymba). Attention is GQA (RoPE, or
qwen2-vl's M-RoPE at ``positions3`` ``[3, T]``: text positions on all
three rows unless the caller gives them) or MLA (deepseek-v2-lite, whose
carry holds latent rows). Encoder-decoder models are
:class:`~.encdec.EncDecLM`'s.

The loss head (:meth:`DecoderLM.chunk_loss`) runs the final norm and the
fused streaming cross-entropy (kernels B, C1, C2 on the card).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (attention_block, attention_block_sp,
                        init_attention, make_local_attention_policy)
from .config import ArchConfig, LayerKind
from .layers import (embed_init, mrope_tables, rms_norm, rope_tables,
                     swiglu_apply, swiglu_init)
from .moe import init_moe, moe_apply
from .ssm import init_mamba, mamba_apply, mamba_apply_sp, ssm_state_shape

__all__ = ["DecoderLM", "LayerCtx", "layer_params", "tree_map",
           "tree_leaves", "tree_unflatten", "unstack_layers"]


class LayerCtx(NamedTuple):
    """Split-chunk context carry, per layer (``[L, ...]`` stacked, or a list
    of ``L`` tensors); a field is None where the family has no such state,
    and the whole carry is None for a context-free run.

    * ``k``, ``v``: KV buffers ``[C_cap, Hkv, Dh]`` (attention layers), in
      the compute dtype; a chunk appends its rows at its context length.
      MLA: ``k`` holds the latent rows ``[C_cap, 1, r + rr]`` and ``v`` is
      None (the reference's zero-width buffer: no values, and no leaf for
      the carry's gradient hand-off);
    * ``ssm_h``: the mamba state ``[d_inner, d_state]``, float32;
    * ``ssm_tail``: the last ``d_conv - 1`` conv inputs ``[d_conv - 1,
      d_inner]``, in the compute dtype.
    """
    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    ssm_h: Optional[torch.Tensor] = None
    ssm_tail: Optional[torch.Tensor] = None


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of nested dicts and lists (anything else,
    tuples included, is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in a fixed order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` in the order of
    :func:`tree_leaves`."""
    return _build(template, iter(leaves))


def _build(t, it):
    # a module-level function: a nested one that calls itself is a
    # reference cycle, which would keep ``leaves`` (a step's gradient
    # sums) alive until the garbage collector runs
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, list):
        return [_build(v, it) for v in t]
    return next(it)


def layer_params(params: Dict, idx: int) -> Dict:
    """Layer ``idx``'s parameters: views out of the stacked ``layers``, or
    the dict itself when ``layers`` is a per-layer list."""
    layers = params["layers"]
    if isinstance(layers, list):
        return layers[idx]
    return tree_map(lambda a: a[idx], layers)


def unstack_layers(params: Dict) -> Dict:
    """A copy of ``params`` whose ``layers`` is a list of per-layer dicts
    (fresh tensors, not views)."""
    layers = params["layers"]
    if isinstance(layers, list):
        return dict(params)
    n = len(tree_leaves(layers)[0])
    out = dict(params)
    out["layers"] = [tree_map(lambda a: a[i].clone(), layers)
                     for i in range(n)]
    return out


class DecoderLM:
    """init/apply-style decoder LM parameterized by ArchConfig.

    The sequence-parallel hooks (the reference's ``attn_fn``, ``moe_fn``,
    ``ssm_scan_fn``, ``ssm_tail_exchange``; built by ``runtime/sp.
    make_model``) serve :meth:`run_layers_sp`, which runs one SP group's
    token blocks; without them (the one-rank path, :meth:`run_layers`) the
    attention policy is the local one."""

    def __init__(self, cfg: ArchConfig, *, attn_fn: Optional[Callable] = None,
                 moe_fn: Optional[Callable] = None,
                 ssm_scan_fn: Optional[Callable] = None,
                 ssm_tail_exchange: Optional[Callable] = None):
        s = cfg.spec
        kind = cfg.layer_kind
        ssm = kind in (LayerKind.MAMBA, LayerKind.HYBRID)
        if (kind not in (LayerKind.ATTN, LayerKind.MOE, LayerKind.MAMBA,
                         LayerKind.HYBRID)
                or s.is_encoder_decoder
                or ssm != (s.ssm_state > 0)
                or s.attn_free != (kind == LayerKind.MAMBA)
                or (kind == LayerKind.MOE) != (s.n_experts > 0)):
            raise NotImplementedError(
                f"{cfg.name}: DecoderLM runs dense attention, MLA, MoE, "
                f"mamba and hybrid decoders"
                + ("; encoder-decoders run in models/encdec.EncDecLM"
                   if s.is_encoder_decoder else ""))
        self.cfg = cfg
        self.has_attn = kind != LayerKind.MAMBA
        self.has_ssm = ssm
        self.attn_fn = attn_fn or make_local_attention_policy()
        self.moe_fn = moe_fn
        self.ssm_scan_fn, self.ssm_tail_exchange = ssm_scan_fn, \
            ssm_tail_exchange

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, *, device,
             dtype=torch.float32) -> Dict:
        """Random parameters with the reference's distributions (truncated
        fan-in normal for dense weights, N(0, 0.02) embeddings, zero norm
        offsets), drawn from ``gen`` on ``device`` (which the caller names:
        there is no default) — the numbers differ from ``jax.random``'s;
        :mod:`repro_torch.weights` imports the reference's own. Each
        layer is drawn, then copied into the stacked ``[L, ...]`` leaves:
        the model's weights are held once (deepseek-v2-lite's 27 layers
        take 31.6 GB in bf16)."""
        s = self.cfg.spec
        kw = dict(dtype=dtype, device=device)
        embed = embed_init(gen, s.vocab, s.d_model, **kw)
        layers = None
        for i in range(s.n_layers):
            lp = {"ln1": torch.zeros((s.d_model,), **kw)}
            if self.has_attn:
                lp["attn"] = init_attention(self.cfg, gen, **kw)
            if self.has_ssm:
                lp["mamba"] = init_mamba(self.cfg, gen, **kw)
            if self.cfg.layer_kind != LayerKind.MAMBA:
                lp["ln2"] = torch.zeros((s.d_model,), **kw)
                if s.n_experts > 0:
                    lp["moe"] = init_moe(self.cfg, gen, **kw)
                else:
                    lp["mlp"] = swiglu_init(gen, s.d_model, s.d_ff, **kw)
            if layers is None:
                layers = tree_map(lambda a: a.new_empty((s.n_layers,
                                                         *a.shape)), lp)
            for dst, src in zip(tree_leaves(layers), tree_leaves(lp)):
                dst[i] = src
            del lp
        params = {"embed": embed, "layers": layers,
                  "final_norm": torch.zeros((s.d_model,), **kw)}
        if not self.cfg.tie_embeddings:
            params["unembed"] = embed_init(gen, s.vocab, s.d_model, **kw)
        return params

    @staticmethod
    def head_weights(params: Dict) -> torch.Tensor:
        # (a pipeline's last stage holds no embed when the head is untied)
        return params["unembed"] if "unembed" in params else params["embed"]

    def chunk_loss(self, params: Dict, hidden: torch.Tensor,
                   targets: torch.Tensor, seg: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum_loss, n_valid) of one chunk: final norm, then the fused
        streaming cross-entropy against the head weights (the reference's
        ``streaming_cross_entropy``; kernels B, C1, C2 on the card)."""
        from repro_torch.kernels.ops import fused_cross_entropy
        h = rms_norm(hidden, params["final_norm"], self.cfg.rms_eps)
        valid = (seg >= 0) & (targets >= 0)
        return fused_cross_entropy(h, self.head_weights(params).to(h.dtype),
                                   targets.clamp(min=0), valid)

    def chunk_loss_sp(self, params: Dict, hidden: List[torch.Tensor],
                      targets: List[torch.Tensor], segs: List[torch.Tensor],
                      d_s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`chunk_loss` over an SP group's token blocks: the final
        norm per rank, then the vocabulary-parallel CE over ``d_s`` row
        blocks of the head (``runtime/sp.sharded_ce``: kernel B per block,
        the log-sum-exps merged, C1 and C2 per block)."""
        from repro_torch.runtime.sp import sharded_ce
        hs = [rms_norm(h, params["final_norm"], self.cfg.rms_eps)
              for h in hidden]
        w = self.head_weights(params)
        w = [b.to(hs[0].dtype) for b in w] if isinstance(w, (list, tuple)) \
            else w.to(hs[0].dtype)
        return sharded_ce(hs, w,
                          [t.clamp(min=0) for t in targets],
                          [(s >= 0) & (t >= 0) for s, t in zip(segs, targets)],
                          d_s)

    def embed_sp(self, params: Dict, tokens: List[torch.Tensor], d_s: int,
                 compute_dtype=torch.bfloat16) -> List[torch.Tensor]:
        """:meth:`embed` of an SP group's token blocks, vocabulary-parallel
        over ``d_s`` row blocks (``runtime/sp.sharded_embed``)."""
        from repro_torch.runtime.sp import sharded_embed
        xs = sharded_embed(params["embed"], tokens, d_s, compute_dtype)
        if self.cfg.embed_scale:
            scale = torch.tensor(self.cfg.spec.d_model ** 0.5,
                                 dtype=compute_dtype).item()
            xs = [x * scale for x in xs]
        return xs

    def loss(self, params: Dict, tokens, targets, seg, pos, *,
             positions3: Optional[torch.Tensor] = None,
             compute_dtype=torch.bfloat16
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum_loss, n_valid) of one context-free chunk."""
        hidden, _ = self.forward_chunk(params, tokens, seg, pos,
                                       positions3=positions3,
                                       compute_dtype=compute_dtype)
        return self.chunk_loss(params, hidden, targets, seg)

    # ------------------------------------------------------------------
    def embed(self, params: Dict, tokens: torch.Tensor,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
        x = params["embed"][tokens].to(compute_dtype)
        if self.cfg.embed_scale:
            # the scale is rounded to the compute dtype, as the reference
            # rounds it; a host scalar keeps a device copy out of the step
            scale = torch.tensor(self.cfg.spec.d_model ** 0.5,
                                 dtype=compute_dtype).item()
            x = x * scale
        return x

    def layer_apply(self, lparams: Dict, x: torch.Tensor, *,
                    pos: torch.Tensor, seg: torch.Tensor, ctx: LayerCtx,
                    ctx_len: int, window: int, rope: Optional[Tuple] = None
                    ) -> Tuple[torch.Tensor, LayerCtx]:
        """x: [T, D] -> (x', updated context carry): the KV rows appended
        at ``ctx_len``, the SSM state advanced to the chunk's last live
        row. ``rope``: the chunk's :meth:`rope_tables` (computed here from
        ``pos`` if None; M-RoPE at 3-D positions needs them)."""
        cfg = self.cfg
        kind = cfg.layer_kind
        h = rms_norm(x, lparams["ln1"], cfg.rms_eps)
        nk, nv, nh, ntail = ctx
        mixer = None
        if self.has_attn:
            mixer, nk, nv = attention_block(
                cfg, lparams["attn"], h, pos=pos, seg=seg, ctx_k=ctx.k,
                ctx_v=ctx.v, ctx_len=ctx_len, window=window,
                attn_fn=self.attn_fn, rope=rope)
        if self.has_ssm:
            m_out, nh, ntail = mamba_apply(
                cfg, lparams["mamba"], h, pos=pos, seg=seg,
                state=ctx.ssm_h, conv_tail=ctx.ssm_tail)
            mixer = m_out if mixer is None else 0.5 * (mixer + m_out)
        x = x + mixer
        if kind != LayerKind.MAMBA:
            h2 = rms_norm(x, lparams["ln2"], cfg.rms_eps)
            x = x + self.ffn(lparams, h2)
        return x, LayerCtx(nk, nv, nh, ntail)

    def ffn(self, lparams: Dict, h: torch.Tensor) -> torch.Tensor:
        """The layer's feed-forward block on its normed rows ``h``: the
        MoE block, or the SwiGLU MLP."""
        if "moe" in lparams:
            return moe_apply(self.cfg, lparams["moe"], h)
        return swiglu_apply(lparams["mlp"], h)

    # ------------------------------------------------------------------
    def init_ctx(self, cap: int, compute_dtype=torch.bfloat16,
                 n_layers: Optional[int] = None, *, device) -> LayerCtx:
        """Stacked context carry (zeros): KV ``[L, cap, Hkv, Dh]`` for
        attention layers (MLA: latent rows ``[L, cap, 1, r + rr]``, no
        values), ``ssm_h [L, d_inner, d_state]`` (float32) and ``ssm_tail
        [L, d_conv - 1, d_inner]`` for mamba layers."""
        s = self.cfg.spec
        L = n_layers if n_layers is not None else s.n_layers
        k = v = hh = tail = None
        if self.has_attn and s.kv_lora_rank > 0:
            k = torch.zeros((L, cap, 1, s.kv_lora_rank + s.qk_rope_dim),
                            dtype=compute_dtype, device=device)
        elif self.has_attn:
            shape = (L, cap, s.n_kv_heads, s.head_dim)
            k = torch.zeros(shape, dtype=compute_dtype, device=device)
            v = torch.zeros(shape, dtype=compute_dtype, device=device)
        if self.has_ssm:
            hs, ts = ssm_state_shape(self.cfg)
            hh = torch.zeros((L, *hs), dtype=torch.float32, device=device)
            tail = torch.zeros((L, *ts), dtype=compute_dtype, device=device)
        return LayerCtx(k, v, hh, tail)

    def forward_chunk(self, params: Dict, tokens: torch.Tensor,
                      seg: torch.Tensor, pos: torch.Tensor, *,
                      ctx: Optional[LayerCtx] = None, ctx_len: int = 0,
                      positions3: Optional[torch.Tensor] = None,
                      compute_dtype=torch.bfloat16, remat: int = 0
                      ) -> Tuple[torch.Tensor, Optional[LayerCtx]]:
        """Run all layers over one packed chunk. Returns (hidden, new ctx);
        the new ctx is None when ``ctx`` is None (context-free run), and
        stacked or a list as ``ctx`` is.

        ``remat``: the leading ``remat`` layers run under non-reentrant
        ``torch.utils.checkpoint`` (their activations are recomputed in the
        backward), as the reference executor remats the leading
        ``l_ckpt`` layers of a stage; remat never changes the math.
        ``positions3``: M-RoPE's ``[3, T]`` position rows (default: ``pos``
        on each)."""
        x = self.embed(params, tokens, compute_dtype)
        layers = [(layer_params(params, i), w)
                  for i, w in enumerate(self.cfg.layer_windows())]
        return self.run_layers(layers, x, seg, pos, ctx=ctx,
                               ctx_len=ctx_len, remat=remat,
                               rope=self.rope_tables(pos, positions3))

    def rope_tables(self, pos: torch.Tensor,
                    positions3: Optional[torch.Tensor] = None
                    ) -> Optional[Tuple]:
        """The rotation tables of a chunk's positions, None without rope
        (MLA rotates only its ``qk_rope_dim`` rope channels). M-RoPE's
        come from ``positions3`` ``[3, T]``, or from ``pos`` on all three
        rows (text tokens: then they are RoPE's, bit for bit)."""
        s, cfg = self.cfg.spec, self.cfg
        if not self.has_attn:
            return None
        if cfg.rope_kind == "mrope":
            rows = torch.stack([pos, pos, pos]) if positions3 is None \
                else positions3
            return mrope_tables(rows, s.head_dim, cfg.rope_theta,
                                cfg.mrope_sections)
        if cfg.rope_kind == "rope":
            dim = s.qk_rope_dim if s.kv_lora_rank > 0 else s.head_dim
            return rope_tables(pos, dim, cfg.rope_theta)
        return None

    def run_layers(self, layers, x: torch.Tensor, seg: torch.Tensor,
                   pos: torch.Tensor, *, ctx: Optional[LayerCtx] = None,
                   ctx_len: int = 0, remat: int = 0,
                   rope: Optional[Tuple] = None
                   ) -> Tuple[torch.Tensor, Optional[LayerCtx]]:
        """Run ``layers`` (a sequence of ``(layer params, window)``) over
        the hidden rows ``x``: the body of :meth:`forward_chunk`, and of a
        pipeline stage, which runs its own layers. ``ctx`` holds one carry
        entry per layer of ``layers``; the leading ``remat`` layers run
        under checkpoint; ``rope``: the chunk's :meth:`rope_tables`
        (computed here from ``pos`` if None)."""
        # one pair of rotation tables for every layer, so that the layers'
        # saved activations share it (16 MB a table on a 31k-row gemma3-1b
        # chunk)
        if rope is None:
            rope = self.rope_tables(pos)
        new = [[], [], [], []]
        for i, (lp, w) in enumerate(layers):
            lctx = [None if f is None else f[i]
                    for f in (ctx if ctx is not None else (None,) * 4)]
            args = (lp, x, pos, seg, *lctx, int(ctx_len), w, rope)
            if i < remat:
                x, *out = checkpoint(self._layer, *args,
                                     use_reentrant=False)
            else:
                x, *out = self._layer(*args)
            for acc, o in zip(new, out):
                acc.append(o)
        if ctx is None:
            return x, None
        fields = []
        for f, vals in zip(ctx, new):
            if f is None:
                fields.append(None)
            elif isinstance(f, (list, tuple)):
                fields.append(vals)
            else:
                fields.append(torch.stack(vals))
        return x, LayerCtx(*fields)

    # ------------------------------------------------------------------
    def layer_apply_sp(self, lparams: Dict, xs: List[torch.Tensor], *,
                       poss, segs, ctx: LayerCtx, ctx_len: int, window: int,
                       ropes) -> Tuple[List[torch.Tensor], LayerCtx]:
        """:meth:`layer_apply` over one SP group's token blocks ``xs`` (rank
        order; ``poss``, ``segs``, ``ropes`` per rank): norms, projections
        and MLPs per rank, attention through the group's policy, the mamba
        mixer through the prefix scan and conv halo, MoE through expert
        parallelism (one rank: the routed block). ``ctx`` fields: the
        policy's KV carry lists, ``[h]`` and ``[tail]`` (None: none)."""
        cfg = self.cfg
        hs = [rms_norm(x, lparams["ln1"], cfg.rms_eps) for x in xs]
        nk, nv, nh, ntail = ctx
        mixer = None
        if self.has_attn:
            mixer, nk, nv = attention_block_sp(
                cfg, lparams["attn"], hs, poss=poss, segs=segs, ctx_k=ctx.k,
                ctx_v=ctx.v, ctx_len=ctx_len, window=window,
                attn_fn=self.attn_fn, ropes=ropes)
        if self.has_ssm:
            m_out, h, tail = mamba_apply_sp(
                cfg, lparams["mamba"], hs, poss=poss, segs=segs,
                state=None if ctx.ssm_h is None else ctx.ssm_h[0],
                conv_tail=None if ctx.ssm_tail is None else ctx.ssm_tail[0],
                scan_fn=self.ssm_scan_fn,
                tail_exchange=self.ssm_tail_exchange)
            nh, ntail = [h], [tail]
            mixer = m_out if mixer is None else [
                0.5 * (a + b) for a, b in zip(mixer, m_out)]
        xs = [x + m for x, m in zip(xs, mixer)]
        if cfg.layer_kind != LayerKind.MAMBA:
            h2 = [rms_norm(x, lparams["ln2"], cfg.rms_eps) for x in xs]
            if "moe" in lparams and self.moe_fn is not None:
                ys = self.moe_fn(cfg, lparams["moe"], h2)
            else:
                ys = [self.ffn(lparams, h) for h in h2]
            xs = [x + y for x, y in zip(xs, ys)]
        return xs, LayerCtx(nk, nv, nh, ntail)

    def run_layers_sp(self, layers, xs: List[torch.Tensor], segs, poss, *,
                      ctx: Optional[LayerCtx] = None, ctx_len: int = 0,
                      remat: int = 0, ropes=None, zero3=None
                      ) -> Tuple[List[torch.Tensor], Optional[LayerCtx]]:
        """:meth:`run_layers` over one SP group's token blocks: ``ctx``
        fields are lists over ``layers`` of each layer's carry list (the
        policy's layout, ``[h]``, ``[tail]``); the leading ``remat`` layers
        run under checkpoint, the rank blocks and carries passed as
        separate tensor arguments. ``zero3`` (``runtime/sharding.Zero3``):
        each layer's parameters are its key, gathered inside the layer's
        run (so a remat'd layer gathers them again in its backward), and a
        layer without remat runs under ``zero3.keep_shards()``."""
        if ropes is None:
            ropes = [self.rope_tables(p) for p in poss]
        n = len(xs)
        new = [[], [], [], []]
        for i, (lp, w) in enumerate(layers):
            lctx = [None if f is None else f[i]
                    for f in (ctx if ctx is not None else (None,) * 4)]
            counts = tuple(-1 if f is None else len(f) for f in lctx)
            flat = [t for f in lctx if f is not None for t in f]
            args = (lp, int(w), int(ctx_len), segs, poss, ropes, n, counts,
                    zero3, *xs, *flat)
            if i < remat:
                out = checkpoint(self._layer_sp, *args, use_reentrant=False)
            elif zero3 is not None:
                with zero3.keep_shards():
                    out = self._layer_sp(*args)
            else:
                out = self._layer_sp(*args)
            xs, lctx_out = out
            for acc, o in zip(new, lctx_out):
                acc.append(o)
        if ctx is None:
            return xs, None
        return xs, LayerCtx(*[None if f is None else vals
                              for f, vals in zip(ctx, new)])

    def _layer_sp(self, lparams, window, ctx_len, segs, poss, ropes, n,
                  counts, zero3, *tensors):
        if zero3 is not None:
            lparams = zero3.layer(lparams)
        xs, rest = list(tensors[:n]), list(tensors[n:])
        fields = []
        for c in counts:
            fields.append(None if c < 0 else rest[:c])
            rest = rest[max(c, 0):]
        return self.layer_apply_sp(lparams, xs, poss=poss, segs=segs,
                                   ctx=LayerCtx(*fields), ctx_len=ctx_len,
                                   window=window, ropes=ropes)

    def _layer(self, lparams, x, pos, seg, ctx_k, ctx_v, ctx_h, ctx_tail,
               ctx_len, window, rope):
        x, out = self.layer_apply(lparams, x, pos=pos, seg=seg,
                                  ctx=LayerCtx(ctx_k, ctx_v, ctx_h, ctx_tail),
                                  ctx_len=ctx_len, window=window, rope=rope)
        return (x, *out)
