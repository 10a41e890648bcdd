"""Kernel dispatch: the port's public attention and cross-entropy ops.

CUDA tensors go to the Hopper kernels (:mod:`.flash_attention`,
:mod:`.cross_entropy`) after the padding rules of the JAX package's
``kernels/ops.py``: attention rows are padded to the kernel's tile sizes
(pad rows get ``seg = -2``, which matches nothing and is never a live
query) and cross-entropy tokens to :data:`~.cross_entropy.TOKEN_MULTIPLE`
(target -1, not valid); outputs are sliced back. CPU tensors go to the
plain versions (:mod:`.ref`). There is no fallback: a CUDA tensor
launches the kernels or raises.

Both ops are ``torch.autograd.Function``\\ s when a gradient is wanted:

* :func:`flash_attention` — forward: kernel A with the rows' log-sum-exp;
  backward: the two backward kernels (dk/dv pass, dq pass);
* :func:`fused_cross_entropy` — forward: kernel B; backward: C1 (d hidden)
  and C2 (d W), the counterpart of the JAX package's ``_fused_ce``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .cross_entropy import (TOKEN_MULTIPLE, ce_bwd_dh_cuda, ce_bwd_dw_cuda,
                            ce_fwd_cuda)
from .flash_attention import (BLOCK_KV, BLOCK_Q, flash_attention_cuda,
                              flash_bwd_dkdv_cuda, flash_bwd_dq_cuda)

__all__ = ["flash_attention", "fused_cross_entropy", "pad_rows",
           "pad_for_kernel"]

PAD_SEG = -2


def pad_rows(x: torch.Tensor, mult: int, fill=0) -> torch.Tensor:
    """Pad dim 0 of ``x`` up to a multiple of ``mult`` with ``fill``."""
    pad = (-x.shape[0]) % mult
    if pad == 0:
        return x
    tail = torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail], dim=0)


def _dense(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and starting on a 16-byte boundary (copied if not)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def pad_for_kernel(q, k, v, seg_q, seg_kv, pos_q, pos_kv):
    """Pad queries to ``BLOCK_Q`` and keys to ``BLOCK_KV`` rows; pad rows get
    ``seg = -2`` and position 0. Returns int32, contiguous tensors."""
    i32 = torch.int32
    return (_dense(pad_rows(q, BLOCK_Q)),
            _dense(pad_rows(k, BLOCK_KV)),
            _dense(pad_rows(v, BLOCK_KV)),
            pad_rows(seg_q.to(i32), BLOCK_Q, PAD_SEG).contiguous(),
            pad_rows(seg_kv.to(i32), BLOCK_KV, PAD_SEG).contiguous(),
            pad_rows(pos_q.to(i32), BLOCK_Q).contiguous(),
            pad_rows(pos_kv.to(i32), BLOCK_KV).contiguous())


def _known_device(t: torch.Tensor, op: str):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {t.device}")


class _FlashAttention(torch.autograd.Function):
    """Attention with a kernel backward. CUDA: the forward saves the padded
    inputs, the output and the rows' log-sum-exp for the two backward
    passes. CPU: plain forward, plain gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, pos_q, pos_kv, causal, window,
                scale):
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        ctx.rows = (q.shape[0], k.shape[0])
        if q.is_cuda:
            padded = pad_for_kernel(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
            out, lse = flash_attention_cuda(*padded, with_lse=True,
                                            **ctx.opts)
            ctx.save_for_backward(*padded, out, lse)
            return out[:q.shape[0]]
        flash_attention.plain_calls += 1
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
        return ref.blocked_flash_attention(q, k, v, seg_q, seg_kv, pos_q,
                                           pos_kv, **ctx.opts)

    @staticmethod
    def backward(ctx, dout):
        T, S = ctx.rows
        if dout.is_cuda:
            q, k, v, seg_q, seg_kv, pos_q, pos_kv, out, lse = \
                ctx.saved_tensors
            do = _dense(pad_rows(dout.to(q.dtype), BLOCK_Q))
            meta = (seg_q, seg_kv, pos_q, pos_kv)
            dk, dv = flash_bwd_dkdv_cuda(q, k, v, out, do, lse, *meta,
                                         **ctx.opts)
            dq = flash_bwd_dq_cuda(q, k, v, out, do, lse, *meta, **ctx.opts)
            dq, dk, dv = dq[:T], dk[:S], dv[:S]
        else:
            flash_attention.plain_calls += 1
            dq, dk, dv = ref.flash_attention_grad(*ctx.saved_tensors, dout,
                                                  **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Packed-varlen attention: q [T, Hq, D], k/v [S, Hkv, D] -> [T, Hq, D].
    Differentiable in q, k and v.

    ``flash_attention.plain_calls`` counts the forward and backward calls
    served by the plain versions (CPU tensors)."""
    window = int(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _known_device(q, "flash_attention")
        return _FlashAttention.apply(q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                                     causal, window, scale)
    if q.is_cuda:
        T = q.shape[0]
        out = flash_attention_cuda(
            *pad_for_kernel(q, k, v, seg_q, seg_kv, pos_q, pos_kv),
            causal=causal, window=window, scale=scale)
        return out[:T]
    _known_device(q, "flash_attention")
    flash_attention.plain_calls += 1
    return ref.blocked_flash_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                                       causal=causal, window=window,
                                       scale=scale)


flash_attention.plain_calls = 0


class _FusedCrossEntropy(torch.autograd.Function):
    """(sum of the valid rows' losses, n_valid); logits never stored.
    Forward: kernel B; backward: C1 and C2 (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, hidden, w, targets, valid):
        T = hidden.shape[0]
        hp = _dense(pad_rows(hidden, TOKEN_MULTIPLE))
        tp = pad_rows(targets.to(torch.int32), TOKEN_MULTIPLE,
                      -1).contiguous()
        vf = pad_rows(valid, TOKEN_MULTIPLE, False).float()
        if hidden.is_cuda:
            lse, tl = ce_fwd_cuda(hp, _dense(w), tp)
        else:
            fused_cross_entropy.plain_calls += 1
            lse, tl = ref.cross_entropy_fwd_plain(hp, w, tp)
        ctx.save_for_backward(hp, w, tp, lse, vf)
        ctx.T = T
        return ((lse - tl) * vf).sum(), vf.sum()

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        hp, w, tp, lse, vf = ctx.saved_tensors
        g_rows = (vf * g_loss.float()).contiguous()
        dh = dw = None
        if hp.is_cuda:
            wd = _dense(w)
            if ctx.needs_input_grad[0]:
                dh = ce_bwd_dh_cuda(hp, wd, tp, lse, g_rows)[:ctx.T]
            if ctx.needs_input_grad[1]:
                dw = ce_bwd_dw_cuda(hp, wd, tp, lse, g_rows)
        else:
            fused_cross_entropy.plain_calls += 1
            if ctx.needs_input_grad[0]:
                dh = ref.cross_entropy_bwd_dh_plain(hp, w, tp, lse,
                                                    g_rows)[:ctx.T]
            if ctx.needs_input_grad[1]:
                dw = ref.cross_entropy_bwd_dw_plain(hp, w, tp, lse, g_rows)
        return dh, dw, None, None


def fused_cross_entropy(hidden: torch.Tensor, w_vocab: torch.Tensor,
                        targets: torch.Tensor, valid: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_loss, n_valid) float32 scalars over ``hidden [T, D]`` against
    the vocabulary ``w_vocab [V, D]``; rows where ``valid`` is False carry
    no loss. ``fused_cross_entropy.plain_calls`` counts the forward and
    backward calls served by the plain versions (CPU tensors)."""
    _known_device(hidden, "fused_cross_entropy")
    return _FusedCrossEntropy.apply(hidden, w_vocab, targets, valid)


fused_cross_entropy.plain_calls = 0
