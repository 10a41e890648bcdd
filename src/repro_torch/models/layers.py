"""Shared neural building blocks (plain functions on tensors).

Counterparts of the JAX package's ``models/layers.py``, with the casts in
the same places (after each projection, after ``rms_norm``, after
``silu``) so bf16 rounds where the reference rounds. Dense weights are
stored ``[d_out, d_in]`` (``F.linear``'s layout); the weight bridge
(:mod:`repro_torch.weights`) transposes the reference's ``[d_in, d_out]``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "embed_init", "rms_norm", "swiglu_init",
           "swiglu_apply", "rope_freqs", "rope_tables", "apply_rope",
           "linear"]

Params = Dict[str, torch.Tensor]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
               dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init, stored ``[d_out, d_in]``."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((d_out, d_in), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * s).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, *, device,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                    device=device) * 0.02
    return w.to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in x's dtype (the reference's
    ``einsum(x, w.astype(dt))``)."""
    return F.linear(x, w.to(x.dtype))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """Gemma-style RMSNorm: the learned scale is ``1 + gamma``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, *, device,
                dtype=torch.float32) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {"w_gate": dense_init(gen, d_model, d_ff, **kw),
            "w_up": dense_init(gen, d_model, d_ff, **kw),
            "w_down": dense_init(gen, d_ff, d_model, **kw)}


def swiglu_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, p["w_gate"])
    u = linear(x, p["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return linear(h, p["w_down"])


@functools.lru_cache(maxsize=32)
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies for half the head dim (float32), computed once
    on the CPU per (head_dim, theta, device) and shared by every caller —
    read-only. Computing them on the CPU keeps CPU and GPU runs on the same
    frequencies and keeps a host-to-device copy (which waits for the
    device) out of every layer."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    return freqs.to(device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotation angles, ``[T, 1, head_dim/2]`` float32.
    Every layer rotates with the same tables, so a caller running many
    layers over one batch computes them once."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """x: [T, H, Dh]; positions: [T] int. Rotates the two halves of Dh;
    ``tables`` are :func:`rope_tables` of these positions, if the caller
    has them."""
    half = x.shape[-1] // 2
    cos, sin = tables if tables is not None else \
        rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
