"""Kernel dispatch: the port's public attention op.

CUDA tensors go to the Hopper kernel (:mod:`.flash_attention`) after the
padding rules of the JAX package's ``kernels/ops.py``: rows are padded to
the kernel's tile sizes, pad rows get ``seg = -2`` (which matches nothing
and is never a live query), and the output is sliced back to ``T``. CPU
tensors go to the plain version (:func:`.ref.blocked_flash_attention`).
There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import BLOCK_KV, BLOCK_Q, flash_attention_cuda

__all__ = ["flash_attention", "pad_rows", "pad_for_kernel"]

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


def flash_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Packed-varlen attention: q [T, Hq, D], k/v [S, Hkv, D] -> [T, Hq, D].

    ``flash_attention.plain_calls`` counts the calls served by the plain
    version (CPU tensors)."""
    window = int(window)
    if q.is_cuda:
        T = q.shape[0]
        out = flash_attention_cuda(
            *pad_for_kernel(q, k, v, seg_q, seg_kv, pos_q, pos_kv),
            causal=causal, window=window, scale=scale)
        return out[:T]
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    flash_attention.plain_calls += 1
    return ref.blocked_flash_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                                       causal=causal, window=window,
                                       scale=scale)


flash_attention.plain_calls = 0
