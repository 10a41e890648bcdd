"""Mamba-1 selective-scan mixer with packed-segment resets and the O(1)
split-chunk carry ``(h, conv_tail)``.

Counterpart of the JAX package's ``models/ssm.py``, with the same
parameters (dense weights stored ``[d_out, d_in]``, as everywhere in the
port) and the same casts. Two differences:

* **The scan's seam.** The reference materialises the ``[T, d_inner,
  d_state]`` decay and input tensors and scans them; here the raw
  per-token ``dt_pre, xc, B, C, z`` go to the gated kernel D
  (:func:`ops.mamba_scan_gated_fwd`), which forms the outer products in
  registers and folds in the softplus, the skip and the gate, and the
  gradient is the gated kernel D'. At hymba-1.5b's width one such float32
  tensor of a 16,384-token chunk would take 3.4 GB per layer.
* **Pad rows are state-neutral.** A row with ``seg < 0`` does not reset
  the state, leaves it unchanged (``delta = 0``: decay 1, no input) and
  does not enter the conv tail, so ``h_last`` and the tail handed to the
  next chunk of a sequence are those of the chunk's last live row. The
  reference resets on ``pos == 0``, which pad rows carry, and takes both
  after the pad rows: its carry out of a padded split chunk is wrong
  (``ROADMAP.md``, reference caveats).

On a sequence-parallel axis :func:`mamba_apply_sp` runs the mixer over a
group's token blocks (the reference's ``scan_fn`` and ``tail_exchange``
hooks, ``runtime/sp``): the conv halo is the last ``K-1`` live rows before
a block, none of them from before a sequence start (:func:`live_tail`),
and the scan folds each block's summary (:func:`gated_scan` from a zero
state, :func:`shard_decay`) into the state entering the next.

Decode (:func:`mamba_decode`, the reference's ``_mamba_decode``): the
one-step update of ``bm`` sequences' states, each sequence-parallel rank
owning a contiguous block of the channels, in plain PyTorch (the
reference computes this step outside its Pallas kernel, and kernel D's
single-sequence ``h0`` cannot batch sequences).

Memory. The mixer keeps what the planner's per-token model charges it and
no float32 ``[T, d_inner]`` tensor: the conv (with its SiLU) and the scan
with its gating are autograd functions that keep their inputs (bf16 in
training) and recompute ``dt_in dt_proj`` and the conv output in their
backward (the gated kernels recompute delta and the gating terms inside);
the scan keeps only its state checkpoints (``d_inner * d_state`` floats
every 64 rows).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import dense_init, linear, weight_grad_store, weight_key

__all__ = ["init_mamba", "mamba_apply", "mamba_apply_sp", "gated_scan",
           "shard_decay", "live_tail", "ssm_state_shape", "dt_rank_of",
           "mamba_decode"]


def ssm_state_shape(cfg: ArchConfig) -> Tuple[Tuple[int, int],
                                              Tuple[int, int]]:
    """((d_inner, d_state), (d_conv - 1, d_inner)): h and the conv tail."""
    s = cfg.spec
    return ((s.inner, s.ssm_state), (s.ssm_conv - 1, s.inner))


def dt_rank_of(cfg: ArchConfig) -> int:
    return max(1, math.ceil(cfg.spec.d_model / 16))


def init_mamba(cfg: ArchConfig, gen: torch.Generator, *, device,
               dtype=torch.float32) -> Dict:
    """The reference's distributions (drawn from ``gen``; the numbers
    differ from ``jax.random``'s)."""
    s = cfg.spec
    D, di, ds = s.d_model, s.inner, s.ssm_state
    R = dt_rank_of(cfg)
    kw = dict(dtype=dtype, device=device)
    a_init = torch.arange(1, ds + 1, dtype=torch.float32,
                          device=device)[None, :].repeat(di, 1)
    conv_w = torch.randn((s.ssm_conv, di), generator=gen,
                         dtype=torch.float32, device=device) * 0.1
    return {
        "in_proj": dense_init(gen, D, 2 * di, **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((di,), **kw),
        "x_proj": dense_init(gen, di, R + 2 * ds, **kw),
        "dt_proj": dense_init(gen, R, di, **kw),
        "dt_bias": torch.full((di,), -4.6, **kw),     # softplus^-1(0.01)
        "a_log": torch.log(a_init).to(dtype),
        "d_skip": torch.ones((di,), **kw),
        "out_proj": dense_init(gen, di, D, **kw),
    }


def _conv_pre(xs, w, b, tail, reset):
    """The depthwise causal conv before its SiLU, rounded to xs's dtype as
    the reference rounds it: ``xs [T, di]``, ``w [K, di]``, ``tail [K-1,
    di]`` (the inputs before row 0), ``reset [T]`` bool. A window element
    contributes to row t only if no reset lies in ``(j, t]``; the tail
    belongs to the block before the first reset."""
    K, T = w.shape[0], xs.shape[0]
    xp = torch.cat([tail.to(xs.dtype), xs], dim=0)
    blk = torch.cumsum(reset.to(torch.int32), 0)
    blk_p = torch.cat([blk.new_zeros(K - 1), blk])
    out = torch.zeros(xs.shape, dtype=torch.float32, device=xs.device)
    for j in range(K):
        ok = (blk_p[j:j + T] == blk)[:, None]
        out += torch.where(ok, xp[j:j + T].float() * w[j].float(), 0.0)
    return (out + b.float()).to(xs.dtype), xp, blk, blk_p


class _ConvSilu(torch.autograd.Function):
    """``silu(conv(xs))`` (each rounded to xs's dtype, as the reference
    rounds), keeping only its inputs: the float32 window products autograd
    would keep (``K`` copies of ``[T, di]``) are recomputed."""

    @staticmethod
    def forward(ctx, xs, w, b, tail, reset):
        pre = _conv_pre(xs, w, b, tail, reset)[0]
        ctx.save_for_backward(xs, w, b, tail, reset)
        return F.silu(pre.float()).to(xs.dtype)

    @staticmethod
    def backward(ctx, dxc):
        xs, w, b, tail, reset = ctx.saved_tensors
        pre, xp, blk, blk_p = _conv_pre(xs, w, b, tail, reset)
        p32 = pre.float()
        sig = torch.sigmoid(p32)
        dpre = (dxc.float() * sig * (1.0 + p32 * (1.0 - sig))).to(
            xs.dtype).float()
        K, T = w.shape[0], xs.shape[0]
        dxp = torch.zeros(xp.shape, dtype=torch.float32, device=xs.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        for j in range(K):
            g = torch.where((blk_p[j:j + T] == blk)[:, None], dpre, 0.0)
            dw[j] = (xp[j:j + T].float() * g).sum(0)
            dxp[j:j + T] += g * w[j].float()
        return (dxp[K - 1:].to(xs.dtype), dw.to(w.dtype),
                dpre.sum(0).to(b.dtype), dxp[:K - 1].to(tail.dtype), None)


class _ScanGate(torch.autograd.Function):
    """The selective scan with the mixer's prologue and gating, ``(y_scan
    + D xc) * silu(z)``, from the x-projection's outputs: ``dt_pre = dt_in
    dt_proj^T`` (a matmul, as the reference leaves it to XLA), then the
    gated kernel pair (:func:`ops.mamba_scan_gated_fwd` / ``_bwd``), which
    computes ``delta = softplus(dt_pre + dt_bias)`` (0 on pad rows), the
    scan, the skip and the gate in its prologue and epilogue, and their
    gradients in D'. Keeps its inputs (``dt_in``, not ``dt_pre``) and the
    scan's state checkpoints; the backward recomputes ``dt_pre``. Returns
    ``(out [T, di] in xc's dtype, h_last [di, ds] float32)``."""

    @staticmethod
    def forward(ctx, xc, dt_in, B, C, z, dt_proj, dt_bias, a_log, d_skip,
                live, reset, h0):
        from repro_torch.kernels.ops import mamba_scan_gated_fwd
        A = -torch.exp(a_log.float())
        out, h_last, ckpt = mamba_scan_gated_fwd(
            linear(dt_in, dt_proj), xc, B, C, z, dt_bias, A, d_skip, live,
            reset, h0)
        ctx.save_for_backward(xc, dt_in, B, C, z, dt_proj, dt_bias, a_log,
                              d_skip, live, reset, h0,
                              *([] if ckpt is None else [ckpt]))
        ctx.store, ctx.dt_proj = weight_grad_store(), weight_key(dt_proj)
        return out, h_last

    @staticmethod
    def backward(ctx, dout, dh_last):
        from repro_torch.kernels.ops import mamba_scan_gated_bwd
        (xc, dt_in, B, C, z, dt_proj, dt_bias, a_log, d_skip, live, reset,
         h0, *ckpt) = ctx.saved_tensors
        dt = xc.dtype
        A = -torch.exp(a_log.float())
        d_pre, d_xc, dz, dB, dC, dA, d_bias, d_dskip, dh0 = \
            mamba_scan_gated_bwd(linear(dt_in, dt_proj), xc, B, C, z,
                                 dt_bias, A, d_skip, live, reset, h0,
                                 ckpt[0] if ckpt else None, dout, dh_last)
        d_dt_in = d_pre @ dt_proj.to(dt)
        if ctx.store is not None:       # dt_proj's product deferred to W
            x = dt_in.detach()          # no reference back to the graph
            wdt = dt_proj.dtype         # (the dtype, not the weight)
            ctx.store.append((ctx.dt_proj, lambda: (d_pre.T @ x).to(wdt)))
            d_dt_proj = None
        else:
            d_dt_proj = (d_pre.T @ dt_in).to(dt_proj.dtype)
        return (d_xc, d_dt_in, dB.to(B.dtype), dC.to(C.dtype), dz,
                d_dt_proj, d_bias.to(dt_bias.dtype),
                (dA * A).to(a_log.dtype), d_dskip.to(d_skip.dtype), None,
                None, dh0.to(h0.dtype))


def live_tail(conv_tail, xs, live, reset):
    """The ``K-1`` conv inputs ending at the last live row of ``xs`` (the
    incoming tail's rows where ``xs`` has fewer live rows; the tail itself
    where it has none), gathered without a host sync; rows before the last
    live reset of ``xs`` are zeroed: they belong to an earlier sequence,
    which a later conv window must not read (between SP ranks,
    ``runtime/sp``; a chunk that hands its tail on holds one sequence from
    row 0, so there they are the incoming tail's zeros)."""
    K1, T = conv_tail.shape[0], xs.shape[0]
    rows = torch.arange(T, device=xs.device)
    last = (torch.where(live, rows, -1)).max() if T else rows.new_tensor(-1)
    p = last + 1 + torch.arange(K1, device=xs.device)   # in [tail; xs] rows
    from_tail = conv_tail.to(xs.dtype)[p.clamp(max=K1 - 1)]
    from_xs = xs[(p - K1).clamp(min=0)]
    out = torch.where((p < K1)[:, None], from_tail, from_xs)
    start = (torch.where(reset & live, rows, -1)).max() if T \
        else rows.new_tensor(-1)
    keep = (start < 0) | (p - K1 >= start)
    return torch.where(keep[:, None], out, 0)


def mamba_apply(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                pos: torch.Tensor, seg: torch.Tensor,
                state: Optional[torch.Tensor] = None,
                conv_tail: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: ``[T, D]`` packed tokens -> ``(out [T, D], h_last [di, ds]
    float32, conv_tail [K-1, di])``. A live row with ``pos == 0`` starts a
    sequence (the state and the conv window restart); ``state`` and
    ``conv_tail`` (default zeros) carry a split sequence in from its
    previous chunk."""
    s = cfg.spec
    di, ds = s.inner, s.ssm_state
    R = dt_rank_of(cfg)
    dt = x.dtype
    if state is None:
        state = torch.zeros((di, ds), dtype=torch.float32, device=x.device)
    if conv_tail is None:
        conv_tail = torch.zeros((s.ssm_conv - 1, di), dtype=dt,
                                device=x.device)
    live = seg >= 0
    reset = (pos == 0) & live
    xz = linear(x, p["in_proj"])
    xs, z = xz[:, :di], xz[:, di:]
    xc = _ConvSilu.apply(xs, p["conv_w"], p["conv_b"], conv_tail, reset)
    proj = linear(xc, p["x_proj"])
    y, h_last = _ScanGate.apply(
        xc, proj[:, :R], proj[:, R:R + ds], proj[:, R + ds:R + 2 * ds], z,
        p["dt_proj"], p["dt_bias"], p["a_log"], p["d_skip"], live, reset,
        state)
    out = linear(y, p["out_proj"])
    return out, h_last, live_tail(conv_tail, xs, live, reset)


def gated_scan(p: Dict, xc, dt_in, B, C, z, live, reset, h0):
    """The mixer's gated scan (kernels D and D′ on the card) of one token
    block from the state ``h0``: ``(out [T, di], h_last [di, ds])``,
    differentiable in ``h0``."""
    return _ScanGate.apply(xc, dt_in, B, C, z, p["dt_proj"], p["dt_bias"],
                           p["a_log"], p["d_skip"], live, reset, h0)


def shard_decay(p: Dict, dt_in, live, reset) -> torch.Tensor:
    """``a_prod [di, ds]``: the product over a token block's rows of the
    scan's decays ``exp(delta A)`` (float32), the factor by which the state
    entering the block reaches its end: ``exp(A sum(delta))``, pad rows
    contributing ``delta = 0``, and 0 where a sequence starts inside the
    block (its reset drops the state)."""
    delta = torch.where(live[:, None], F.softplus(
        linear(dt_in, p["dt_proj"]).float() + p["dt_bias"].float()), 0.0)
    A = -torch.exp(p["a_log"].float())
    keep = (~(reset & live).any()).float()
    return torch.exp(delta.sum(0)[:, None] * A) * keep


def mamba_apply_sp(cfg: ArchConfig, p: Dict, xs, *, poss, segs,
                   state: Optional[torch.Tensor] = None,
                   conv_tail: Optional[torch.Tensor] = None,
                   scan_fn, tail_exchange):
    """:func:`mamba_apply` over an SP group's token blocks ``xs`` (a list,
    rank order): the projections per rank, the conv over each block with
    its halo (``tail_exchange(conv inputs, lives, resets, carried tail) ->
    (tails, new tail)``) and the scan across the blocks (``scan_fn(p,
    shards, h0) -> (outs, h_last)``: ``runtime/sp.make_sp_ssm_scan``). Returns ``(outs,
    h_last, conv_tail)``: the group's final state and the chunk's last
    ``K-1`` live conv inputs."""
    from repro_torch.runtime.sp import ScanShard
    s = cfg.spec
    di, ds = s.inner, s.ssm_state
    R = dt_rank_of(cfg)
    dt = xs[0].dtype
    dev = xs[0].device
    if state is None:
        state = torch.zeros((di, ds), dtype=torch.float32, device=dev)
    if conv_tail is None:
        conv_tail = torch.zeros((s.ssm_conv - 1, di), dtype=dt, device=dev)
    lives = [seg >= 0 for seg in segs]
    resets = [(pos == 0) & live for pos, live in zip(poss, lives)]
    xz = [linear(x, p["in_proj"]) for x in xs]
    x_in = [a[:, :di] for a in xz]
    tails, new_tail = tail_exchange(x_in, lives, resets, conv_tail)
    shards = []
    for a, tail, live, reset in zip(xz, tails, lives, resets):
        xc = _ConvSilu.apply(a[:, :di], p["conv_w"], p["conv_b"], tail,
                             reset)
        proj = linear(xc, p["x_proj"])
        shards.append(ScanShard(xc, proj[:, :R], proj[:, R:R + ds],
                                proj[:, R + ds:R + 2 * ds], a[:, di:], live,
                                reset))
    ys, h_last = scan_fn(p, shards, state)
    return ([linear(y, p["out_proj"]) for y in ys], h_last,
            new_tail.to(dt))


@torch.no_grad()
def mamba_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor, states,
                 tails) -> torch.Tensor:
    """One decode step of the mixer: ``x [bm, D]`` (the normed rows of
    ``bm`` sequences' new tokens) -> ``[bm, D]``. ``states`` / ``tails``:
    the ranks' blocks of the channels, ``[bm, d_inner / d_s, d_state]``
    float32 and ``[bm, d_conv - 1, d_inner / d_s]``, updated IN PLACE.
    Per rank: the conv window (its tail, then the new input) with the
    mixer's roundings (the pre-activation rounded to x's dtype, then
    SiLU), the channels gathered for ``x_proj``, ``delta = softplus(dt_in
    dt_proj^T + dt_bias)`` in float32, ``h = exp(delta A) h + delta x B``,
    ``y = h C + D x``, gated by ``silu(z)``; the outputs gathered for
    ``out_proj``; each tail shifted by one row."""
    from repro_torch.runtime.sp import all_gather
    s = cfg.spec
    di, ds, K = s.inner, s.ssm_state, s.ssm_conv
    R = dt_rank_of(cfg)
    dt = x.dtype
    d = len(states)
    dl = di // d
    xz = linear(x, p["in_proj"])
    xcs = []
    for r, tail in enumerate(tails):
        c = slice(r * dl, (r + 1) * dl)
        win = torch.cat([tail.to(dt), xz[:, None, c]], dim=1)  # [bm, K, dl]
        acc = torch.zeros((x.shape[0], dl), dtype=torch.float32,
                          device=x.device)
        for j in range(K):
            acc += win[:, j].float() * p["conv_w"][j, c].float()
        pre = (acc + p["conv_b"][c].float()).to(dt)
        xcs.append(F.silu(pre.float()).to(dt))
        tail.copy_(win[:, 1:])
    proj = linear(all_gather(xcs, dim=1), p["x_proj"])
    B = proj[:, R:R + ds].float()
    C = proj[:, R + ds:R + 2 * ds].float()
    delta = F.softplus(linear(proj[:, :R], p["dt_proj"]).float()
                       + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    z = xz[:, di:]
    ys = []
    for r, (h, xc) in enumerate(zip(states, xcs)):
        c = slice(r * dl, (r + 1) * dl)
        dlt, xf = delta[:, c], xc.float()
        h.copy_(torch.exp(dlt[..., None] * A[c]) * h
                + (dlt * xf)[..., None] * B[:, None, :])
        y = (h * C[:, None, :]).sum(-1) + p["d_skip"][c].float() * xf
        ys.append((y * F.silu(z[:, c].float())).to(dt))
    return linear(all_gather(ys, dim=1), p["out_proj"])
