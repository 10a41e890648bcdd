"""Decoder language model (dense attention family).

Counterpart of the JAX package's ``models/model.py``. Parameters are plain
nested dicts of tensors in the reference's layout: layer leaves stacked
along a leading ``L`` axis, plus ``embed``, ``final_norm`` and an optional
``unembed``; dense weights are ``[d_out, d_in]``. For training,
``params["layers"]`` may instead be a list of per-layer dicts
(:func:`unstack_layers`): each layer's weights are then their own autograd
leaves, and a layer's gradient is not scattered into a zeroed ``[L, ...]``
buffer. Every layer exposes a context carry (:class:`LayerCtx`) so a later
chunk of a sequence attends to the KV rows of the earlier ones; the carry's
gradient is the paper's dKV term (Eq. 5).

The loss head (:meth:`DecoderLM.chunk_loss`) runs the final norm and the
fused streaming cross-entropy (kernels B, C1, C2 on the card).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (attention_block, init_attention,
                        make_local_attention_policy)
from .config import ArchConfig, LayerKind
from .layers import embed_init, rms_norm, swiglu_apply, swiglu_init

__all__ = ["DecoderLM", "LayerCtx", "layer_params", "tree_map",
           "tree_leaves", "tree_unflatten", "unstack_layers"]


class LayerCtx(NamedTuple):
    """Split-chunk context carry: KV buffers ``[C_cap, Hkv, Dh]`` per layer
    (``[L, ...]`` stacked, or a list of ``L`` buffers), None for a
    context-free run. The reference's SSM fields join with the SSM
    family."""
    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]


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
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(template)


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
    """init/apply-style decoder LM parameterized by ArchConfig."""

    def __init__(self, cfg: ArchConfig):
        s = cfg.spec
        if (cfg.layer_kind != LayerKind.ATTN or s.n_experts or s.ssm_state
                or s.kv_lora_rank or s.attn_free or s.is_encoder_decoder):
            raise NotImplementedError(
                f"{cfg.name}: only dense attention decoders are ported")
        self.cfg = cfg
        self.attn_fn = make_local_attention_policy()

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, *, device,
             dtype=torch.float32) -> Dict:
        """Random parameters with the reference's distributions (truncated
        fan-in normal for dense weights, N(0, 0.02) embeddings, zero norm
        offsets), drawn from ``gen`` on ``device`` (which the caller names:
        there is no default) — the numbers differ from ``jax.random``'s;
        :mod:`repro_torch.weights` imports the reference's own."""
        s = self.cfg.spec
        kw = dict(dtype=dtype, device=device)
        embed = embed_init(gen, s.vocab, s.d_model, **kw)
        layers = []
        for _ in range(s.n_layers):
            layers.append({
                "ln1": torch.zeros((s.d_model,), **kw),
                "attn": init_attention(self.cfg, gen, **kw),
                "ln2": torch.zeros((s.d_model,), **kw),
                "mlp": swiglu_init(gen, s.d_model, s.d_ff, **kw),
            })
        params = {"embed": embed, "layers": _stack(layers),
                  "final_norm": torch.zeros((s.d_model,), **kw)}
        if not self.cfg.tie_embeddings:
            params["unembed"] = embed_init(gen, s.vocab, s.d_model, **kw)
        return params

    @staticmethod
    def head_weights(params: Dict) -> torch.Tensor:
        return params.get("unembed", params["embed"])

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

    def loss(self, params: Dict, tokens, targets, seg, pos, *,
             compute_dtype=torch.bfloat16
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum_loss, n_valid) of one context-free chunk."""
        hidden, _ = self.forward_chunk(params, tokens, seg, pos,
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
                    ctx_len: int, window: int
                    ) -> Tuple[torch.Tensor, LayerCtx]:
        """x: [T, D] -> (x', updated context carry)."""
        cfg = self.cfg
        h = rms_norm(x, lparams["ln1"], cfg.rms_eps)
        attn_out, nk, nv = attention_block(
            cfg, lparams["attn"], h, pos=pos, seg=seg, ctx_k=ctx.k,
            ctx_v=ctx.v, ctx_len=ctx_len, window=window,
            attn_fn=self.attn_fn)
        x = x + attn_out
        h2 = rms_norm(x, lparams["ln2"], cfg.rms_eps)
        x = x + swiglu_apply(lparams["mlp"], h2)
        return x, LayerCtx(nk, nv)

    # ------------------------------------------------------------------
    def init_ctx(self, cap: int, compute_dtype=torch.bfloat16,
                 n_layers: Optional[int] = None, *, device) -> LayerCtx:
        """Stacked context carry ``[L, cap, Hkv, Dh]`` (zeros)."""
        s = self.cfg.spec
        L = n_layers if n_layers is not None else s.n_layers
        shape = (L, cap, s.n_kv_heads, s.head_dim)
        return LayerCtx(torch.zeros(shape, dtype=compute_dtype, device=device),
                        torch.zeros(shape, dtype=compute_dtype, device=device))

    def forward_chunk(self, params: Dict, tokens: torch.Tensor,
                      seg: torch.Tensor, pos: torch.Tensor, *,
                      ctx: Optional[LayerCtx] = None, ctx_len: int = 0,
                      compute_dtype=torch.bfloat16, remat: int = 0
                      ) -> Tuple[torch.Tensor, Optional[LayerCtx]]:
        """Run all layers over one packed chunk. Returns (hidden, new ctx);
        the new ctx is None when ``ctx`` is None (context-free run), and
        stacked or a list as ``ctx`` is.

        ``remat``: the leading ``remat`` layers run under non-reentrant
        ``torch.utils.checkpoint`` (their activations are recomputed in the
        backward), as the reference executor remats the leading
        ``l_ckpt`` layers of a stage; remat never changes the math."""
        x = self.embed(params, tokens, compute_dtype)
        new_k, new_v = [], []
        for i, w in enumerate(self.cfg.layer_windows()):
            ck = None if ctx is None else ctx.k[i]
            cv = None if ctx is None else ctx.v[i]
            args = (layer_params(params, i), x, pos, seg, ck, cv,
                    int(ctx_len), w)
            if i < remat:
                x, nk, nv = checkpoint(self._layer, *args,
                                       use_reentrant=False)
            else:
                x, nk, nv = self._layer(*args)
            new_k.append(nk)
            new_v.append(nv)
        if ctx is None:
            return x, None
        if isinstance(ctx.k, (list, tuple)):
            return x, LayerCtx(new_k, new_v)
        return x, LayerCtx(torch.stack(new_k), torch.stack(new_v))

    def _layer(self, lparams, x, pos, seg, ctx_k, ctx_v, ctx_len, window):
        x, out = self.layer_apply(lparams, x, pos=pos, seg=seg,
                                  ctx=LayerCtx(ctx_k, ctx_v),
                                  ctx_len=ctx_len, window=window)
        return x, out.k, out.v


def _stack(layers):
    """List of per-layer trees -> one tree of ``[L, ...]`` leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers)
