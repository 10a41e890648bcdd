"""Attention: GQA projection (+RoPE, +qk-norm), the local attention policy
and the attention block.

Counterpart of the JAX package's ``models/attention.py`` (the GQA path;
MLA and M-RoPE come with their families). Packed-varlen semantics: a chunk
is a flat token buffer ``[T]`` with ``seg`` (segment id per token, -1 =
padding) and ``pos`` (position within the owning sequence). Split-chunk
context arrives as KV buffers whose first ``ctx_len`` entries are valid;
context rows belong to segment 0 and carry positions ``0..ctx_len-1``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from .config import ArchConfig
from .layers import apply_rope, dense_init, linear, rms_norm

__all__ = ["init_attention", "project_qkv", "attention_block",
           "make_local_attention_policy"]


def init_attention(cfg: ArchConfig, gen: torch.Generator, *, device,
                   dtype=torch.float32) -> Dict:
    s = cfg.spec
    D, Dh, Hq, Hkv = s.d_model, s.head_dim, s.n_heads, s.n_kv_heads
    kw = dict(dtype=dtype, device=device)
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
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [T, D] -> q [T, Hq, Dh], k [T, Hkv, Dh], v [T, Hkv, Dh].
    ``rope``: precomputed ``layers.rope_tables(pos, ...)``, if any."""
    s = cfg.spec
    if s.kv_lora_rank > 0 or cfg.rope_kind == "mrope":
        raise NotImplementedError("MLA and M-RoPE are not ported yet")
    Dh, Hq, Hkv = s.head_dim, s.n_heads, s.n_kv_heads
    q = linear(x, p["wq"]).reshape(-1, Hq, Dh)
    k = linear(x, p["wk"]).reshape(-1, Hkv, Dh)
    v = linear(x, p["wv"]).reshape(-1, Hkv, Dh)
    if s.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if cfg.rope_kind == "rope":
        q = apply_rope(q, pos, cfg.rope_theta, rope)
        k = apply_rope(k, pos, cfg.rope_theta, rope)
    return q, k, v


def _append(buf: torch.Tensor, rows: torch.Tensor, offset: int
            ) -> torch.Tensor:
    """Copy of ``buf`` with ``rows`` written at ``offset`` (where they
    fit)."""
    out = buf.clone()
    out[offset:offset + rows.shape[0]] = rows.to(buf.dtype)
    return out


def make_local_attention_policy() -> Callable:
    """Single-device attention policy: the carry's ``ctx_len`` live rows in
    front of the chunk's KV rows (dead rows after them up to a multiple of
    the kernel's KV tile), attended through the kernel dispatch
    :func:`repro_torch.kernels.ops.flash_attention`. The new carry is the
    old one with the chunk's rows at ``ctx_len``: a copy when the old one
    has room for them, else that very concatenation (a carry that grows
    with its sequence, as the training steps' do: they start each one
    empty, so each chunk keeps its context once, in the keys its
    attention saves)."""
    from repro_torch.kernels.flash_attention import BLOCK_KV
    from repro_torch.kernels.ops import flash_attention

    def policy(q, k_cur, v_cur, *, seg, pos, ctx_k, ctx_v, ctx_len,
               causal, window, scale):
        if ctx_k is not None:
            C, T = int(ctx_len), k_cur.shape[0]
            pad = -(C + T) % BLOCK_KV

            def keys(ctx, cur):
                return torch.cat([ctx[:C], cur.to(ctx.dtype),
                                  ctx.new_zeros((pad, *ctx.shape[1:]))])
            kk, vv = keys(ctx_k, k_cur), keys(ctx_v, v_cur)
            kv_seg = torch.cat([seg.new_zeros(C), seg, seg.new_full((pad,),
                                                                    -1)])
            kv_pos = torch.cat([torch.arange(C, dtype=pos.dtype,
                                             device=pos.device), pos,
                                pos.new_zeros(pad)])
            if C + T > ctx_k.shape[0]:
                new_k, new_v = kk, vv
            else:
                new_k = _append(ctx_k, k_cur, C)
                new_v = _append(ctx_v, v_cur, C)
        else:
            kk, vv, kv_seg, kv_pos = k_cur, v_cur, seg, pos
            new_k = new_v = None
        out = flash_attention(q, kk, vv, seg, kv_seg, pos, kv_pos,
                              causal=causal, window=window, scale=scale)
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
    chunk's ``layers.rope_tables``, if the caller has them."""
    T = x.shape[0]
    q, k_cur, v_cur = project_qkv(cfg, p, x, pos, rope)
    scale = 1.0 / math.sqrt(cfg.spec.head_dim)
    out, new_k, new_v = attn_fn(
        q, k_cur, v_cur, seg=seg, pos=pos, ctx_k=ctx_k, ctx_v=ctx_v,
        ctx_len=ctx_len, causal=causal, window=window, scale=scale)
    y = linear(out.reshape(T, -1), p["wo"])
    return y, new_k, new_v
