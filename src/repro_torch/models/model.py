"""Decoder language model (dense attention family).

Counterpart of the JAX package's ``models/model.py``. Parameters are plain
nested dicts of tensors in the reference's layout: layer leaves stacked
along a leading ``L`` axis, plus ``embed``, ``final_norm`` and an optional
``unembed``; dense weights are ``[d_out, d_in]``. Every layer exposes a
context carry (:class:`LayerCtx`) so a later chunk of a sequence attends
to the KV rows of the earlier ones.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .attention import (attention_block, init_attention,
                        make_local_attention_policy)
from .config import ArchConfig, LayerKind
from .layers import embed_init, rms_norm, swiglu_apply, swiglu_init

__all__ = ["DecoderLM", "LayerCtx", "layer_params", "tree_map"]


class LayerCtx(NamedTuple):
    """Split-chunk context carry: KV buffers ``[C_cap, Hkv, Dh]`` per layer
    (``[L, ...]`` stacked), None for a context-free run. The reference's
    SSM fields join with the SSM family."""
    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(params: Dict, idx: int) -> Dict:
    """Views of layer ``idx``'s parameters out of the stacked ``layers``."""
    return tree_map(lambda a: a[idx], params["layers"])


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
                      compute_dtype=torch.bfloat16
                      ) -> Tuple[torch.Tensor, Optional[LayerCtx]]:
        """Run all layers over one packed chunk. Returns (hidden, new ctx);
        the new ctx is None when ``ctx`` is None (context-free run)."""
        x = self.embed(params, tokens, compute_dtype)
        new_k, new_v = [], []
        for i, w in enumerate(self.cfg.layer_windows()):
            lctx = LayerCtx(None, None) if ctx is None \
                else LayerCtx(ctx.k[i], ctx.v[i])
            x, out_ctx = self.layer_apply(
                layer_params(params, i), x, pos=pos, seg=seg, ctx=lctx,
                ctx_len=ctx_len, window=w)
            new_k.append(out_ctx.k)
            new_v.append(out_ctx.v)
        if ctx is None:
            return x, None
        return x, LayerCtx(torch.stack(new_k), torch.stack(new_v))


def _stack(layers):
    """List of per-layer trees -> one tree of ``[L, ...]`` leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers)
