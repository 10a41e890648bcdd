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


class _RMSNorm(torch.autograd.Function):
    """RMSNorm whose backward recomputes from the input: it keeps ``x`` (in
    its own dtype) and the float32 ``1/rms`` per row, not the float32
    intermediates autograd would keep (2.3 KB instead of ~12 KB per token
    at gemma3-1b's width), so the activations match the planner's
    per-token memory model."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        x32 = x.float()
        rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, gamma, rstd)
        return (x32 * rstd * (1.0 + gamma.float())).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, rstd = ctx.saved_tensors
        xhat = x.float() * rstd
        dy32 = dy.float()
        dgamma = (dy32 * xhat).reshape(-1, x.shape[-1]).sum(0)
        dxhat = dy32 * (1.0 + gamma.float())
        dx = rstd * (dxhat - xhat * (dxhat * xhat).mean(dim=-1,
                                                         keepdim=True))
        return dx.to(x.dtype), dgamma.to(gamma.dtype), None


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """Gemma-style RMSNorm: the learned scale is ``1 + gamma``."""
    return _RMSNorm.apply(x, gamma, eps)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, *, device,
                dtype=torch.float32) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {"w_gate": dense_init(gen, d_model, d_ff, **kw),
            "w_up": dense_init(gen, d_model, d_ff, **kw),
            "w_down": dense_init(gen, d_ff, d_model, **kw)}


class _SiluGate(torch.autograd.Function):
    """``silu(g) * u`` (silu in float32, rounded to g's dtype, as the
    reference rounds) keeping only ``g`` and ``u``: the float32 copies
    autograd would keep are recomputed in the backward (27.6 KB instead of
    ~55 KB per token at gemma3-1b's d_ff)."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return F.silu(g.float()).to(g.dtype) * u

    @staticmethod
    def backward(ctx, dh):
        g, u = ctx.saved_tensors
        g32 = g.float()
        sig = torch.sigmoid(g32)
        du = dh * (g32 * sig).to(g.dtype)
        da = (dh * u).float()
        dg = da * sig * (1.0 + g32 * (1.0 - sig))
        return dg.to(g.dtype), du


def swiglu_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, p["w_gate"])
    u = linear(x, p["w_up"])
    return linear(_SiluGate.apply(g, u), p["w_down"])


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
