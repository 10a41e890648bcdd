"""Kernel dispatch: the port's public attention, cross-entropy and
selective-scan ops.

CUDA tensors go to the Hopper kernels (:mod:`.flash_attention`,
:mod:`.cross_entropy`, :mod:`.mamba_scan`) after the padding rules of the
JAX package's ``kernels/ops.py``: attention rows are padded to the
kernel's tile sizes (pad rows get ``seg = -2``, which matches nothing and
is never a live query) and cross-entropy tokens to
:data:`~.cross_entropy.TOKEN_MULTIPLE` (target -1, not valid); outputs are
sliced back. The scan kernels mask their ragged last time tile
themselves: their inputs go unpadded. CPU tensors go to the plain versions
(:mod:`.ref`). There is no fallback: a CUDA tensor launches the kernels
or raises. Meta tensors take the CUDA route and stop where it would
launch (:mod:`.meta`, the dry-run's trace): never the plain version.

The ops are ``torch.autograd.Function``\\ s when a gradient is wanted:

* :func:`flash_attention` — forward: the tile ranges (:func:`bwd_tiles`:
  ``flash_bwd_tiles_kernel``, tiles of ``BWD_BLOCK[dtype]`` rows; the bf16
  forward walks them, float32's ignores them), then kernel A with the
  rows' log-sum-exp; backward: the two backward kernels (dq pass, then
  dk/dv pass) on the forward's tile ranges;
* :func:`fused_cross_entropy` — forward: kernel B; backward: C1 (d hidden)
  and C2 (d W), the counterpart of the JAX package's ``_fused_ce``;
* :func:`mamba_scan` — forward: kernel D, which also checkpoints the state
  every :data:`~.mamba_scan.SCAN_TILE` rows; backward: kernel D' (with the
  fixed-order sums of its partials). :func:`mamba_scan_fwd` and
  :func:`mamba_scan_bwd` are its two halves; :func:`mamba_scan_gated_fwd`
  and :func:`mamba_scan_gated_bwd` the halves of the mamba mixer's scan
  with its softplus prologue and skip-and-gate epilogue folded into D and
  D', for the mixer's own autograd function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .cross_entropy import (TOKEN_MULTIPLE, ce_bwd_dh_cuda, ce_bwd_dw_cuda,
                            ce_fwd_cuda)
from .flash_attention import (BLOCK_KV, BLOCK_Q, BWD_BLOCK,
                              BwdTiles, flash_attention_cuda,
                              flash_bwd_dkdv_cuda, flash_bwd_dq_cuda,
                              flash_bwd_tiles_cuda)
from .mamba_scan import Gate, mamba_scan_bwd_cuda, mamba_scan_fwd_cuda
from .meta import on_card

__all__ = ["on_card", "flash_attention", "attention_forward",
           "attention_backward", "attention_with_lse", "bwd_tiles",
           "fused_cross_entropy",
           "mamba_scan", "mamba_scan_fwd", "mamba_scan_bwd",
           "mamba_scan_gated_fwd", "mamba_scan_gated_bwd", "pad_rows",
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
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{op}: no kernel for device {t.device}")


def _fwd_tiles(padded, causal, window) -> BwdTiles:
    """The tile ranges of the padded inputs for tiles of the backward's
    ``BWD_BLOCK[dtype]`` rows: the bf16 forward walks them (its
    ``FWD_BLOCK`` is the same 64 rows), the float32 forward ignores them,
    and the backward of either reuses them."""
    return bwd_tiles(*padded[3:], causal=causal, window=window,
                     block=BWD_BLOCK[padded[0].dtype])


def attention_forward(q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None):
    """The forward of :func:`flash_attention` as its autograd function
    runs it: ``(out, saved, kv, tiles)``. CUDA: the tile ranges, then
    kernel A with the rows' log-sum-exp; ``saved`` = the padded q and
    metadata, the padded output and the lse, ``kv`` = the padded keys and
    values, ``tiles`` = the tile ranges. CPU: the plain forward; ``saved``
    = q and the metadata, ``kv`` = (k, v), ``tiles`` None.
    :func:`attention_backward` takes ``saved`` and ``tiles`` with these
    keys and values (or the same ones made again)."""
    opts = dict(causal=causal, window=window, scale=scale)
    if on_card(q):
        padded = pad_for_kernel(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
        tiles = _fwd_tiles(padded, causal, window)
        out, lse = flash_attention_cuda(*padded, with_lse=True, tiles=tiles,
                                        **opts)
        return (out[:q.shape[0]], (padded[0], *padded[3:], out, lse),
                padded[1:3], tiles)
    flash_attention.plain_calls += 1
    out = ref.blocked_flash_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                                      **opts)
    return out, (q, seg_q, seg_kv, pos_q, pos_kv), (k, v), None


def attention_with_lse(q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                       causal: bool = True, window: int = 0,
                       scale: Optional[float] = None):
    """``(out [T, Hq, Dv], lse [Hq, T])``: :func:`attention_forward`'s
    output and its rows' log-sum-exp (float32, ``-inf`` on a row with no
    live key), what a rank of a sequence-sharded cache hands to the merge
    (``runtime/sp.merge_partials``). CUDA: kernel A with its lse (the tile
    ranges, the forward, the merge pass where the keys split); CPU: the
    plain forward and ``ref.flash_attention_lse``."""
    opts = dict(causal=causal, window=int(window), scale=scale)
    out, saved, _, _ = attention_forward(q, k, v, seg_q, seg_kv, pos_q,
                                         pos_kv, **opts)
    if on_card(q):
        return out, saved[-1][:, :q.shape[0]]
    return out, ref.flash_attention_lse(q, k, seg_q, seg_kv, pos_q, pos_kv,
                                        **opts)


def attention_backward(saved, tiles, k, v, dout, *, causal: bool = True,
                       window: int = 0, scale: Optional[float] = None):
    """``(dq, dk, dv)`` of an :func:`attention_forward` call from its
    ``saved`` tensors and ``tiles``, the keys and values ``k``, ``v`` (its
    own, or the same values made again; padded here as the forward padded
    them) and the output's gradient ``dout``, shaped as the unpadded
    inputs. CUDA: the dq pass, then the dk/dv pass (kernel A′); CPU: the
    plain gradient."""
    opts = dict(causal=causal, window=window, scale=scale)
    if on_card(dout):
        q, seg_q, seg_kv, pos_q, pos_kv, out, lse = saved
        T, S = dout.shape[0], k.shape[0]
        k, v = (_dense(pad_rows(t, BLOCK_KV)) for t in (k, v))
        do = _dense(pad_rows(dout.to(q.dtype), BLOCK_Q))
        meta = (seg_q, seg_kv, pos_q, pos_kv)
        # the dq pass on the forward's tile ranges: it writes the rows'
        # Delta for the dk/dv pass
        delta = torch.empty_like(lse)
        dq = flash_bwd_dq_cuda(q, k, v, out, do, lse, *meta, delta=delta,
                               tiles=tiles, **opts)
        dk, dv = flash_bwd_dkdv_cuda(q, k, v, out, do, lse, *meta,
                                     delta=delta, tiles=tiles, **opts)
        return dq[:T], dk[:S], dv[:S]
    flash_attention.plain_calls += 1
    q, *meta = saved
    return ref.flash_attention_grad(q, k, v, *meta, dout, **opts)


class _FlashAttention(torch.autograd.Function):
    """Attention with a kernel backward (:func:`attention_forward`,
    :func:`attention_backward`). CUDA: the forward saves the padded
    inputs, the output, the rows' log-sum-exp and the tile ranges for the
    two backward passes. CPU: plain forward, plain gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, pos_q, pos_kv, causal, window,
                scale):
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        ctx.rows = k.shape[0]
        out, saved, kv, ctx.tiles = attention_forward(
            q, k, v, seg_q, seg_kv, pos_q, pos_kv, **ctx.opts)
        ctx.save_for_backward(*saved, *kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        *saved, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(saved, ctx.tiles, k, v, dout,
                                        **ctx.opts)
        S = ctx.rows
        return dq, dk[:S], dv[:S], None, None, None, None, None, None, None


def flash_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Packed-varlen attention: q [T, Hq, Dk], k [S, Hkv, Dk], v [S, Hkv,
    Dv] -> [T, Hq, Dv] (the kernels take the (Dk, Dv) pairs of
    :data:`~.flash_attention.HEAD_DIMS`). Differentiable in q, k and v.

    ``flash_attention.plain_calls`` counts the forward and backward calls
    served by the plain versions (CPU tensors)."""
    window = int(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _known_device(q, "flash_attention")
        return _FlashAttention.apply(q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                                     causal, window, scale)
    if on_card(q):
        T = q.shape[0]
        padded = pad_for_kernel(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
        tiles = (_fwd_tiles(padded, causal, window)
                 if q.dtype == torch.bfloat16 else None)
        out = flash_attention_cuda(*padded, causal=causal, window=window,
                                   scale=scale, tiles=tiles)
        return out[:T]
    _known_device(q, "flash_attention")
    flash_attention.plain_calls += 1
    return ref.blocked_flash_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                                       causal=causal, window=window,
                                       scale=scale)


flash_attention.plain_calls = 0


def bwd_tiles(seg_q, seg_kv, pos_q, pos_kv, *, causal: bool = True,
              window: int = 0, block: int = 64) -> BwdTiles:
    """The tile ranges and summaries the attention backward walks
    (:class:`~.flash_attention.BwdTiles`) for tiles of ``block`` rows:
    ``flash_bwd_tiles_kernel`` on CUDA metadata (int32, contiguous, padded
    as the kernels take it), its plain version on the CPU."""
    if on_card(seg_q):
        return flash_bwd_tiles_cuda(seg_q, seg_kv, pos_q, pos_kv,
                                    causal=causal, window=int(window),
                                    block=block)
    _known_device(seg_q, "bwd_tiles")
    kv_range, q_range, q_sum, kv_sum = ref.flash_attention_tiles(
        seg_q, seg_kv, pos_q, pos_kv, causal=causal, window=int(window),
        block=block)
    return BwdTiles(block=block, kv_range=kv_range, q_range=q_range,
                    q_summary=q_sum, kv_summary=kv_sum)


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
        if on_card(hidden):
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
        if on_card(hp):
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


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its columns are contiguous (a row slice is fine), else a
    contiguous copy."""
    return t if t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1) \
        else t.contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _flags(x: torch.Tensor) -> torch.Tensor:
    """A ``[T]`` mask as the kernels take it: contiguous bool."""
    x = x.reshape(-1)
    return (x if x.dtype == torch.bool else x != 0).contiguous()


def mamba_scan_fwd(delta, xs, B, C, A, reset, h0):
    """Kernel D (or its plain version on the CPU): ``(y [T, DI], h_last
    [DI, DS], ckpt)``, y and h_last float32; ``ckpt`` is what
    :func:`mamba_scan_bwd` needs besides the inputs (the state entering
    every time tile on the card, None on the CPU)."""
    if on_card(delta):
        return mamba_scan_fwd_cuda(_rows(delta.float()), _rows(xs),
                                   _rows(B.float()), _rows(C.float()),
                                   _f32(A), _flags(reset), _f32(h0))
    _known_device(delta, "mamba_scan")
    mamba_scan.plain_calls += 1
    y, h_last = ref.mamba_scan_reference(delta, xs, B, C, A, reset, h0)
    return y, h_last, None


def mamba_scan_bwd(delta, xs, B, C, A, reset, h0, ckpt, dy, dh_last=None):
    """Kernel D' (or the plain gradient on the CPU) for the forward's
    inputs and ``ckpt``, the output gradient ``dy [T, DI]`` and ``dh_last
    [DI, DS]`` (None: zero). Returns ``(d_delta, d_xs, dB, dC, dA, dh0)``,
    float32."""
    if on_card(delta):
        return mamba_scan_bwd_cuda(
            _rows(delta.float()), _rows(xs), _rows(B.float()),
            _rows(C.float()), _f32(A), _flags(reset), ckpt,
            _rows(dy.float()), None if dh_last is None else _f32(dh_last))
    _known_device(delta, "mamba_scan")
    mamba_scan.plain_calls += 1
    return ref.mamba_scan_grad(delta, xs, B, C, A, reset, h0, dy,
                               dh_last)[1:]


def _gate(z, dt_bias, d_skip, live) -> Gate:
    return Gate(bias=_f32(dt_bias), live=_flags(live), z=_rows(z),
                d_skip=_f32(d_skip))


def mamba_scan_gated_fwd(dt_pre, xc, B, C, z, dt_bias, A, d_skip, live,
                         reset, h0):
    """The mamba mixer's scan with its prologue and epilogue (kernel D
    gated, or its plain version on the CPU): ``delta = softplus(dt_pre +
    dt_bias)`` in float32, 0 where ``live`` is False (a state-neutral pad
    row), the scan, and ``out = (y + d_skip xc) silu(z)`` rounded to xc's
    dtype. ``dt_pre``, ``xc``, ``z`` ``[T, DI]`` and ``B``, ``C`` ``[T,
    DS]`` all in one dtype (row slices are fine), ``A``, ``h0`` ``[DI, DS]``,
    ``live``, ``reset`` ``[T]``. Returns ``(out, h_last, ckpt)``: h_last
    float32, ckpt for :func:`mamba_scan_gated_bwd` (None on the CPU)."""
    if on_card(dt_pre):
        return mamba_scan_fwd_cuda(
            _rows(dt_pre), _rows(xc), _rows(B), _rows(C), _f32(A),
            _flags(reset), _f32(h0), gate=_gate(z, dt_bias, d_skip, live))
    _known_device(dt_pre, "mamba_scan")
    mamba_scan.plain_calls += 1
    out, h_last = ref.mamba_scan_gated(dt_pre, xc, B, C, z, dt_bias, A,
                                       d_skip, live, reset, h0)
    return out, h_last, None


def mamba_scan_gated_bwd(dt_pre, xc, B, C, z, dt_bias, A, d_skip, live,
                         reset, h0, ckpt, dout, dh_last=None):
    """The gradient of :func:`mamba_scan_gated_fwd` (kernel D' gated, or
    the plain gradient on the CPU) for the output gradient ``dout [T,
    DI]`` and ``dh_last [DI, DS]`` (None: zero): ``(d_pre, d_xc, dz, dB,
    dC, dA, d_bias, d_dskip, dh0)``, the first three in xc's dtype (d_pre
    0 on pad rows), the rest float32."""
    if on_card(dt_pre):
        return mamba_scan_bwd_cuda(
            _rows(dt_pre), _rows(xc), _rows(B), _rows(C), _f32(A),
            _flags(reset), ckpt, _rows(dout),
            None if dh_last is None else _f32(dh_last),
            gate=_gate(z, dt_bias, d_skip, live))
    _known_device(dt_pre, "mamba_scan")
    mamba_scan.plain_calls += 1
    return ref.mamba_scan_gated_grad(dt_pre, xc, B, C, z, dt_bias, A, d_skip,
                                     live, reset, h0, dout, dh_last)


class _MambaScan(torch.autograd.Function):
    """The selective scan with a kernel backward: the forward keeps its
    inputs and the state checkpoints; the backward runs D'."""

    @staticmethod
    def forward(ctx, delta, xs, B, C, A, h0, reset):
        y, h_last, ckpt = mamba_scan_fwd(delta, xs, B, C, A, reset, h0)
        ctx.save_for_backward(delta, xs, B, C, A, h0, reset,
                              *([] if ckpt is None else [ckpt]))
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        delta, xs, B, C, A, h0, reset, *ckpt = ctx.saved_tensors
        dd, dx, dB, dC, dA, dh0 = mamba_scan_bwd(
            delta, xs, B, C, A, reset, h0, ckpt[0] if ckpt else None, dy,
            dh_last)
        return (dd.to(delta.dtype), dx.to(xs.dtype), dB.to(B.dtype),
                dC.to(C.dtype), dA.to(A.dtype), dh0.to(h0.dtype), None)


def mamba_scan(delta, xs, B, C, A, reset, h0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan (the JAX package's ``ops.mamba_scan``):
    delta, xs ``[T, DI]``, B, C ``[T, DS]``, A, h0 ``[DI, DS]``, reset
    ``[T]`` (non-zero where a sequence starts) -> ``(y [T, DI], h_last [DI,
    DS])``, both float32 (y before the D skip and the gating).
    Differentiable in delta, xs, B, C, A and h0.
    ``mamba_scan.plain_calls`` counts the forward and backward calls served
    by the plain versions (CPU tensors), of this function and of the gated
    pair."""
    _known_device(delta, "mamba_scan")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (delta, xs, B, C, A, h0)):
        return _MambaScan.apply(delta, xs, B, C, A, h0, reset)
    y, h_last, _ = mamba_scan_fwd(delta, xs, B, C, A, reset, h0)
    return y, h_last


mamba_scan.plain_calls = 0
