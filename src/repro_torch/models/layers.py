"""Shared neural building blocks (plain functions on tensors).

Counterparts of the JAX package's ``models/layers.py``, with the casts in
the same places (after each projection, after ``rms_norm``, after
``silu``) so bf16 rounds where the reference rounds. Dense weights are
stored ``[d_out, d_in]`` (``F.linear``'s layout); the weight bridge
(:mod:`repro_torch.weights`) transposes the reference's ``[d_in, d_out]``.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "embed_init", "rms_norm", "swiglu_init",
           "swiglu_apply", "rope_freqs", "rope_tables", "mrope_tables",
           "apply_rope", "apply_mrope", "linear", "deferred_weight_grads",
           "weight_grad_store", "weight_key"]

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


# the zero-bubble split backward's weight-gradient store: while a list is
# set here (deferred_weight_grads), linear layers leave their weight
# gradient out of the backward and append ``(weight, product)`` to it,
# ``product()`` being that gradient; a pipeline's W action runs them later
_WEIGHT_GRADS: Optional[List] = None


@contextlib.contextmanager
def deferred_weight_grads(store: Optional[List]):
    """Within the block (a forward, and the backward it feeds, which may
    recompute remat'd layers), linear layers defer their weight gradients
    to ``store``; None leaves them in the backward."""
    global _WEIGHT_GRADS
    prev, _WEIGHT_GRADS = _WEIGHT_GRADS, store
    try:
        yield
    finally:
        _WEIGHT_GRADS = prev


def weight_grad_store() -> Optional[List]:
    """The store linear layers defer their weight gradients to, if any."""
    return _WEIGHT_GRADS


def weight_key(w: torch.Tensor):
    """What a deferred weight gradient is filed under, and what an autograd
    node may keep of its weight beside the saved tensors: the weight
    itself, or for a ZeRO-3 gathered copy its shards'
    ``runtime/sharding.ShardedLeaf`` (holding the copy would keep it alive
    from the forward to the backward)."""
    return getattr(w, "zero3_key", w)


class _DeferredLinear(torch.autograd.Function):
    """``F.linear(x, w)`` whose backward computes only ``dx`` and appends
    ``(w, product)`` to its store. Both products are the ones autograd's
    ``mm`` backward computes for ``x @ w.T`` (``dy @ w`` and ``dy.T @ x``
    for a row-major ``x``), so the split backward has the fused one's
    bits."""

    @staticmethod
    def forward(ctx, x, w, store):
        if x.dim() != 2 or w.dtype != x.dtype or not w.is_contiguous():
            raise ValueError("a deferred linear takes a 2-D input and a "
                             "contiguous weight of its dtype")
        ctx.save_for_backward(x, w)
        # the leaf itself: under remat the saved ``w`` comes back as an
        # alias of it
        ctx.store, ctx.weight = store, weight_key(w)
        return F.linear(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (w.t().mm(dy.t()).t() if x.stride(0) == 1
                  and x.stride(1) == x.shape[0] else dy.mm(w))
        # detached: a closure over x itself would hold its graph, and
        # through it this node and its store (a cycle the GC cannot see)
        x = x.detach()
        ctx.store.append((ctx.weight, lambda: dy.t().mm(x)))
        return dx, None, None


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in x's dtype (the reference's
    ``einsum(x, w.astype(dt))``); under :func:`deferred_weight_grads` the
    weight's gradient goes to the store."""
    if _WEIGHT_GRADS is not None and torch.is_grad_enabled():
        return _DeferredLinear.apply(x, w, _WEIGHT_GRADS)
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


# bytes of one float32 [rows, d_ff] temporary of the gated activation's
# silu (forward and backward), which sets its blocks' rows: over a whole
# chunk its ~6 temporaries would take 5.2 GB at gemma3-1b's d_ff and a
# 31k-row chunk, which the planner's memory model does not charge; blocks
# of 2^28 bytes (9,709 rows at gemma's d_ff, 12,192 at hymba's) keep them
# under 1.7 GB in 2-4 blocks per chunk, each block ~15 more elementwise
# launches
SILU_BLOCK_BYTES = 2 ** 28


def _silu_rows(g: torch.Tensor) -> int:
    return max(1, SILU_BLOCK_BYTES // (4 * g[0].numel()))


class _SwiGLUDown(torch.autograd.Function):
    """``(silu(g) * u) @ w_down.T`` keeping only ``g``, ``u`` and the
    weight. The gated activation ``h`` (``[T, d_ff]``, with ``g`` and ``u``
    the largest tensors of a layer) is recomputed in the backward, in the
    pass that computes ``dg`` and ``du`` from the same silu, so a layer
    keeps 2 ``d_ff`` values a token where the planner's memory model
    charges 3. silu in float32 and rounded to g's dtype, as the reference
    rounds; both directions run over blocks of rows whose float32
    temporaries take SILU_BLOCK_BYTES each (elementwise: the same bits).
    The products are autograd's for ``h @ w.T`` (``dy @ w``, taken a block
    of rows at a time, and ``dy.T @ h``); under
    :func:`deferred_weight_grads` the weight's goes to the store. Where
    ``g`` and ``u`` are intermediates (not leaves: :func:`swiglu_apply`'s
    own projections, which nothing else keeps), the backward writes ``dg``
    and ``du`` over their rows, each block read first, so beside the saved
    tensors it holds ``h`` and one block's temporaries, not four ``[T,
    d_ff]`` tensors: the planner charges none of them, and stablelm-12b's
    four (5.2 GB on a 47k-row chunk) took its step over the plan's
    estimate."""

    @staticmethod
    def forward(ctx, g, u, w):
        ctx.save_for_backward(g, u, w)
        ctx.reuse = not (g.is_leaf or u.is_leaf)
        ctx.store, ctx.weight = _WEIGHT_GRADS, weight_key(w)
        return F.linear(_silu_gate(g, u), w.to(g.dtype))

    @staticmethod
    def backward(ctx, dy):
        g, u, w = ctx.saved_tensors
        # detached aliases: a gradient that carried g's own grad_fn held
        # its graph (a stage's parameters outlived their trainer)
        h, dg, du = _silu_gate_backward(
            g, u, w, dy, (g.detach(), u.detach()) if ctx.reuse else None)
        if ctx.store is not None:
            wdt = w.dtype               # (the dtype, not the weight)
            ctx.store.append((ctx.weight, lambda: dy.t().mm(h).to(wdt)))
            return dg, du, None
        return dg, du, dy.t().mm(h).to(w.dtype)


def _silu_gate(g, u):
    """``silu(g) * u`` (silu in float32, rounded to g's dtype), over blocks
    of rows (SILU_BLOCK_BYTES)."""
    h, n = torch.empty_like(u), _silu_rows(g)
    for a in range(0, g.shape[0], n):
        b = slice(a, a + n)
        g32 = g[b].float()
        h[b] = (g32 * torch.sigmoid(g32)).to(g.dtype) * u[b]
    return h


def _silu_gate_backward(g, u, w, dy, out=None):
    """``(h, dg, du)`` of ``(silu(g) * u) @ w.T`` for the output gradient
    ``dy``, over blocks of rows (SILU_BLOCK_BYTES): ``h`` the gated
    activation made again; ``dg``, ``du`` written into ``out`` (a pair of
    tensors shaped as g and u, each block read before it is written) or
    new tensors."""
    wt = w.to(g.dtype)
    h = torch.empty_like(u)
    dg, du = out if out is not None else \
        (torch.empty_like(g), torch.empty_like(u))
    n = _silu_rows(g)
    for a in range(0, g.shape[0], n):
        b = slice(a, a + n)
        dh = dy[b].mm(wt)
        g32 = g[b].float()
        sig = torch.sigmoid(g32)
        s = (g32 * sig).to(g.dtype)
        h[b] = s * u[b]
        da = (dh * u[b]).float()
        du[b] = dh * s
        dg[b] = da * sig * (1.0 + g32 * (1.0 - sig))
    return h, dg, du


class _SwiGLURecompute(torch.autograd.Function):
    """The whole SwiGLU MLP keeping only its input ``x`` (a row of D a
    token) and the weights: the backward makes the gate and up
    projections ``g``, ``u`` again (two products), then runs
    :class:`_SwiGLUDown`'s backward over them (``dg``, ``du`` written over
    g and u) and the two projections' backward (``dx = dg @ w_gate + du @
    w_up``, their weights' ``dg.T @ x``, ``du.T @ x``): the same products
    as autograd's, so the same bits as :func:`swiglu_apply` without it.
    Under :func:`deferred_weight_grads` the three weight gradients go to
    the store, which keeps ``x`` and ``dy`` (what the residuals held) and
    makes ``g``, ``u``, ``h``, ``dg`` and ``du`` again when the first of
    them is taken (the same bits): keeping those five would hold five
    ``d_ff`` rows a token from each chunk's backward to its ``W``."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        # the leaves themselves: under remat the saved weights come back
        # as aliases of them, which the store cannot key on
        ctx.store = _WEIGHT_GRADS
        ctx.leaves = tuple(weight_key(w) for w in (w_gate, w_up, w_down))
        h = _silu_gate(F.linear(x, w_gate.to(x.dtype)),
                       F.linear(x, w_up.to(x.dtype)))
        return F.linear(h, w_down.to(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, wg, wu, wd = ctx.saved_tensors
        h, dg, du = _swiglu_grads(x, wg, wu, wd, dy)
        dx = dg.mm(wg.to(x.dtype)) + du.mm(wu.to(x.dtype))
        if ctx.store is not None:
            del h, dg, du
            xd, dyd, made = x.detach(), dy.detach(), []

            def weight_grad(i):
                if not made:
                    made.append(_swiglu_weight_grads(
                        xd, dyd, wg, wu, wd, *_swiglu_grads(xd, wg, wu, wd,
                                                            dyd)))
                return made[0][i]
            ctx.store.extend((w, functools.partial(weight_grad, i))
                             for i, w in enumerate(ctx.leaves))
            return dx, None, None, None
        grads = _swiglu_weight_grads(x, dy, wg, wu, wd, h, dg, du)
        return (dx, *(g if need else None for g, need in
                      zip(grads, ctx.needs_input_grad[1:])))


def _swiglu_grads(x, wg, wu, wd, dy):
    """``(h, dg, du)`` of the SwiGLU MLP at its input ``x`` for the output
    gradient ``dy``: the gate and up projections made again, then
    :func:`_silu_gate_backward` (``dg``, ``du`` over them)."""
    g, u = F.linear(x, wg.to(x.dtype)), F.linear(x, wu.to(x.dtype))
    return _silu_gate_backward(g, u, wd, dy, (g, u))


def _swiglu_weight_grads(x, dy, wg, wu, wd, h, dg, du):
    """The gradients of ``w_gate``, ``w_up`` and ``w_down``: autograd's
    products for the three linear layers."""
    return (dg.t().mm(x).to(wg.dtype), du.t().mm(x).to(wu.dtype),
            dy.t().mm(h).to(wd.dtype))


def swiglu_apply(p: Params, x: torch.Tensor, *,
                 recompute: bool = False) -> torch.Tensor:
    """The SwiGLU MLP ``(silu(x @ w_gate.T) * (x @ w_up.T)) @ w_down.T``.
    ``recompute``: under autograd keep only ``x``, and make the gate and
    up projections again in the backward (:class:`_SwiGLURecompute`: one
    row of D a token kept, not two of d_ff)."""
    if recompute and torch.is_grad_enabled() and (
            x.requires_grad or p["w_gate"].requires_grad):
        return _SwiGLURecompute.apply(x, p["w_gate"], p["w_up"],
                                      p["w_down"])
    g = linear(x, p["w_gate"])
    u = linear(x, p["w_up"])
    return _SwiGLUDown.apply(g, u, p["w_down"])


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


def mrope_tables(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qwen2-vl's M-RoPE as :func:`rope_tables`: ``positions3`` ``[3, T]``
    (temporal, height and width ids, all equal for text tokens), and
    ``sections`` split the ``head_dim/2`` frequencies among the three rows
    in that order. With three equal rows the tables are
    :func:`rope_tables`' to the bit; :func:`apply_rope` takes either."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim/2 = {half}")
    freqs = rope_freqs(head_dim, theta, device=positions3.device)
    parts, off = [], 0
    for row, sec in zip(positions3, sections):
        parts.append(row.float()[:, None] * freqs[None, off:off + sec])
        off += sec
    angles = torch.cat(parts, dim=-1)
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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """x: [T, H, Dh] rotated by M-RoPE (:func:`mrope_tables`) at
    ``positions3`` ``[3, T]``."""
    return apply_rope(x, positions3[0], theta,
                      mrope_tables(positions3, x.shape[-1], theta, sections))
