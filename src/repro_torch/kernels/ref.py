"""Plain PyTorch versions of the port's kernels: the oracles of the kernel
tests and what :mod:`repro_torch.kernels.ops` runs on CPU tensors.

* :func:`flash_attention_reference` — naive ``[H, T, S]`` score
  materialization; bitwise-simple, the oracle.
* :func:`blocked_flash_attention` — online softmax over KV tiles, memory
  ``O(T * block_kv)``; the plain version the dispatcher runs on the CPU.
* :func:`combine_partials` — the merge of split-KV partial states, the
  plain version of the kernel's second pass.
* :func:`flash_attention_lse` — each query row's log-sum-exp (what the
  forward writes for training); :func:`flash_attention_grad` — dq, dk, dv
  by autograd through :func:`flash_attention_reference` (the plain version
  of the two backward passes); :func:`flash_attention_tiles` — the tile
  ranges and summaries the backward passes walk, from the mask (the plain
  version of ``flash_bwd_tiles_kernel``).
* :func:`cross_entropy_fwd_plain`, :func:`cross_entropy_bwd_dh_plain`,
  :func:`cross_entropy_bwd_dw_plain` — the plain versions of the streaming
  cross-entropy kernels B, C1 and C2 (materialised logits);
  :func:`cross_entropy_reference` and :func:`streaming_cross_entropy` — the
  JAX package's two loss oracles.
* :func:`mamba_scan_reference` — the plain version of the selective-scan
  kernel D (a sequential scan in float32, differentiable by autograd);
  :func:`mamba_scan_grad` — its gradient by a stepwise reverse pass over
  the materialised ``[T, DI, DS]`` terms (the plain version of the
  backward kernel D'), checked against ``jax.grad`` in
  ``tests/test_torch_ssm.py``; :func:`mamba_scan_gated` and
  :func:`mamba_scan_gated_grad` — the same composed with the mamba mixer's
  softplus prologue and skip-and-gate epilogue in float32 (the plain
  versions of the gated D and D').

Packed-varlen mask rule (shared by every implementation):
  attend(qi, kj)  iff  seg_q[i] == seg_kv[j]  and  seg_q[i] >= 0
                  and (not causal or pos_kv[j] <= pos_q[i])
                  and (window <= 0 or pos_q[i] - pos_kv[j] < window)
A row with no attended key (padding, ``seg = -2`` pad rows) is exact zeros.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["flash_attention_reference", "blocked_flash_attention",
           "attention_mask", "combine_partials", "flash_attention_lse",
           "flash_attention_grad", "flash_attention_tiles",
           "cross_entropy_reference", "streaming_cross_entropy",
           "cross_entropy_fwd_plain", "cross_entropy_bwd_dh_plain",
           "cross_entropy_bwd_dw_plain",
           "mamba_scan_reference", "mamba_scan_grad", "mamba_scan_gated",
           "mamba_scan_gated_grad"]

NEG_INF = -1e30


def attention_mask(seg_q, seg_kv, pos_q, pos_kv, causal: bool = True,
                   window: int = 0) -> torch.Tensor:
    """[T, S] bool: the packed-varlen mask rule above."""
    m = (seg_q[:, None] == seg_kv[None, :]) & (seg_q[:, None] >= 0)
    if causal:
        m &= pos_kv[None, :] <= pos_q[:, None]
    if window > 0:
        m &= (pos_q[:, None] - pos_kv[None, :]) < window
    return m


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[T, Hq, D] -> [T, Hkv, G, D]: query head h reads kv head h // G."""
    T, Hq, D = q.shape
    return q.reshape(T, n_kv, Hq // n_kv, D)


def flash_attention_reference(q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                              causal: bool = True, window: int = 0,
                              scale: Optional[float] = None) -> torch.Tensor:
    """q: [T, Hq, Dh]; k: [S, Hkv, Dh]; v: [S, Hkv, Dv] -> [T, Hq, Dv]."""
    T, Hq, Dh = q.shape
    Hkv = k.shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    qg = _grouped(q.float(), Hkv)
    s = torch.einsum("tkgd,skd->kgts", qg, k.float()) * scale
    m = attention_mask(seg_q, seg_kv, pos_q, pos_kv, causal, window)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m.any(dim=-1)[:, None], p, torch.zeros_like(p))
    out = torch.einsum("kgts,skd->tkgd", p, v.float())
    return out.reshape(T, Hq, -1).to(q.dtype)


def blocked_flash_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                            causal: bool = True, window: int = 0,
                            scale: Optional[float] = None,
                            block_kv: int = 512) -> torch.Tensor:
    """Online softmax over KV tiles (float32 running ``m, l, acc``)."""
    T, Hq, Dh = q.shape
    S, Hkv, Dv = v.shape
    scale = scale if scale is not None else Dh ** -0.5
    G = Hq // Hkv
    qg = _grouped(q.float(), Hkv)
    acc = torch.zeros((Hkv, G, T, Dv), dtype=torch.float32, device=q.device)
    m_run = torch.full((Hkv, G, T), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((Hkv, G, T), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, block_kv):
        sl = slice(s0, min(s0 + block_kv, S))
        s = torch.einsum("tkgd,skd->kgts", qg, k[sl].float()) * scale
        msk = attention_mask(seg_q, seg_kv[sl], pos_q, pos_kv[sl], causal,
                             window)
        s = torch.where(msk, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        # masked keys contribute exact zeros, so a row that never meets a
        # live key keeps l = 0 and is written as zeros below
        p = torch.where(msk, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "kgts,skd->kgtd", p, v[sl].float())
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    out = torch.where(l_run[..., None] > 0, out, torch.zeros_like(out))
    return out.permute(2, 0, 1, 3).reshape(T, Hq, Dv).to(q.dtype)


def combine_partials(ws_ml: torch.Tensor, ws_acc: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Merge split-KV partial states (the kernel's second pass):
    ``ws_ml [n, T, H, 2]`` holds each split's running max ``m`` and sum
    ``l``, ``ws_acc [n, T, H, D]`` its unnormalised output, meaningful only
    where ``l > 0``. Returns ``sum_z acc_z e^(m_z - M) / sum_z l_z
    e^(m_z - M)`` over the splits with ``l > 0`` (``M`` their largest
    ``m``), and zeros where no split has ``l > 0``."""
    m, l = ws_ml[..., 0], ws_ml[..., 1]
    live = l > 0
    big = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(dim=0)
    w = torch.where(live, torch.exp(m - big), torch.zeros_like(m))
    den = (l * w).sum(dim=0)
    num = torch.where(live[..., None], ws_acc * w[..., None],
                      torch.zeros_like(ws_acc)).sum(dim=0)
    out = torch.where(den[..., None] > 0,
                      num / torch.clamp(den[..., None], min=1e-30),
                      torch.zeros_like(num))
    return out.to(dtype)


def flash_attention_lse(q, k, seg_q, seg_kv, pos_q, pos_kv, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """``[Hq, T]`` float32: log-sum-exp of each query row's masked, scaled
    scores; ``-inf`` on a row with no attended key."""
    T, Hq, Dh = q.shape
    Hkv = k.shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    s = torch.einsum("tkgd,skd->kgts", _grouped(q.float(), Hkv),
                     k.float()) * scale
    m = attention_mask(seg_q, seg_kv, pos_q, pos_kv, causal, window)
    s = torch.where(m, s, torch.full_like(s, float("-inf")))
    return torch.logsumexp(s, dim=-1).reshape(Hq, T)


def flash_attention_grad(q, k, v, seg_q, seg_kv, pos_q, pos_kv, dout, *,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``sum(dout * flash_attention_reference(...))``,
    by autograd through the reference, in the inputs' dtypes."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_reference(qq, kk, vv, seg_q, seg_kv, pos_q,
                                        pos_kv, causal=causal, window=window,
                                        scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout.to(out.dtype))


_I32_MAX, _I32_MIN = 2 ** 31 - 1, -2 ** 31


def _tile_summaries(seg, pos, block):
    """[n, 4] int32 per tile of ``block`` rows: segment min, max, position
    min, max of its live rows (``[2^31 - 1, -1, 2^31 - 1, -2^31]`` if
    none)."""
    n = -(-seg.shape[0] // block)
    pad = n * block - seg.shape[0]
    seg = torch.nn.functional.pad(seg, (0, pad), value=-2)
    pos = torch.nn.functional.pad(pos, (0, pad), value=0)
    live = seg >= 0

    def red(x, fill, op):
        return getattr(torch.where(live, x, fill).view(n, block), op)(dim=1)
    return torch.stack([red(seg, _I32_MAX, "amin"), red(seg, -1, "amax"),
                        red(pos, _I32_MAX, "amin"),
                        red(pos, _I32_MIN, "amax")],
                       dim=1).to(torch.int32).contiguous()


def _first_last(live: torch.Tensor) -> torch.Tensor:
    """[n, 2] int32: per row of ``live [n, m]`` its first and last True
    column, ``[m, -1]`` where none."""
    m = live.shape[1]
    any_ = live.any(dim=1)
    first = live.int().argmax(dim=1)
    last = m - 1 - live.flip(1).int().argmax(dim=1)
    return torch.stack([torch.where(any_, first, m),
                        torch.where(any_, last, -1)],
                       dim=1).to(torch.int32).contiguous()


def flash_attention_tiles(seg_q, seg_kv, pos_q, pos_kv, *,
                          causal: bool = True, window: int = 0,
                          block: int = 64, row_block: int = 4096):
    """What the backward passes walk, for tiles of ``block`` rows (the
    plain version of ``flash_bwd_tiles_kernel``): ``(kv_range [n_q, 2],
    q_range [n_kv, 2], q_summary [n_q, 4], kv_summary [n_kv, 4])``, int32.
    A range is the first and the last tile of the other side that holds a
    pair the mask rule lets attend (``[n, -1]`` if none); a summary is the
    tile's live rows' segment min, max and position min, max. The mask is
    formed over ``row_block`` query rows at a time."""
    T, S = seg_q.shape[0], seg_kv.shape[0]
    n_q, n_kv = -(-T // block), -(-S // block)
    live = torch.zeros((n_q, n_kv), dtype=torch.bool, device=seg_q.device)
    row_block = -(-row_block // block) * block
    for a in range(0, T, row_block):
        m = attention_mask(seg_q[a:a + row_block], seg_kv,
                           pos_q[a:a + row_block], pos_kv, causal, window)
        rows = m.shape[0]
        m = torch.nn.functional.pad(m, (0, n_kv * block - S,
                                        0, -(-rows // block) * block - rows))
        live[a // block:a // block + m.shape[0] // block] = \
            m.view(-1, block, n_kv, block).any(dim=3).any(dim=1)
    return (_first_last(live), _first_last(live.T),
            _tile_summaries(seg_q, pos_q, block),
            _tile_summaries(seg_kv, pos_kv, block))


# ---------------------------------------------------------------------------
# Cross entropy.
# ---------------------------------------------------------------------------

def _logits(hidden, w):
    return hidden.float() @ w.float().T


def _target_hits(targets, V):
    """Targets clamped into range and whether they lie in ``[0, V)`` (a
    target outside it never matches, as in the kernels)."""
    t = targets.long()
    ok = (t >= 0) & (t < V)
    return torch.where(ok, t, torch.zeros_like(t)), ok


def cross_entropy_fwd_plain(hidden, w, targets
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's function: per token ``lse`` and target logit (float32;
    0 where the target is outside ``[0, V)``)."""
    logits = _logits(hidden, w)
    t, ok = _target_hits(targets, w.shape[0])
    tl = logits.gather(1, t[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1), torch.where(ok, tl, 0.0)


def _coef(hidden, w, targets, lse, g_rows):
    """``(softmax - onehot) * g`` per (token, vocab entry), float32."""
    t, ok = _target_hits(targets, w.shape[0])
    coef = _logits(hidden, w).sub_(lse.float()[:, None]).exp_()
    coef.scatter_add_(1, t[:, None], -ok.float()[:, None])
    return coef.mul_(g_rows.float()[:, None])


def cross_entropy_bwd_dh_plain(hidden, w, targets, lse, g_rows
                               ) -> torch.Tensor:
    """Kernel C1's function: ``coef @ w`` in hidden's dtype."""
    return (_coef(hidden, w, targets, lse, g_rows) @ w.float()).to(
        hidden.dtype)


def cross_entropy_bwd_dw_plain(hidden, w, targets, lse, g_rows
                               ) -> torch.Tensor:
    """Kernel C2's function: ``coef^T @ hidden`` in w's dtype."""
    return (_coef(hidden, w, targets, lse, g_rows).T @ hidden.float()).to(
        w.dtype)


def cross_entropy_reference(hidden, w_vocab, targets, valid
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive full-logits CE: (sum of the valid rows' losses, n_valid),
    float32 scalars."""
    logits = _logits(hidden, w_vocab)
    tgt = logits.gather(1, targets.long()[:, None])[:, 0]
    loss = torch.where(valid, torch.logsumexp(logits, dim=-1) - tgt, 0.0)
    return loss.sum(), valid.float().sum()


def streaming_cross_entropy(hidden, w_vocab, targets, valid, *,
                            block_v: int = 2048
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vocab-tiled online log-sum-exp CE (never holds ``[T, V]``); the
    same function as :func:`cross_entropy_reference`."""
    T, V = hidden.shape[0], w_vocab.shape[0]
    m = torch.full((T,), NEG_INF, dtype=torch.float32, device=hidden.device)
    l = torch.zeros((T,), dtype=torch.float32, device=hidden.device)
    t_run = torch.zeros_like(l)
    tgt = targets.long()
    for v0 in range(0, V, block_v):
        logits = _logits(hidden, w_vocab[v0:v0 + block_v])
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        ids = torch.arange(v0, v0 + logits.shape[1], device=hidden.device)
        hit = ids[None, :] == tgt[:, None]
        t_run = t_run + torch.where(hit, logits, 0.0).sum(dim=-1)
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    loss = torch.where(valid, lse - t_run, 0.0)
    return loss.sum(), valid.float().sum()


# ---------------------------------------------------------------------------
# Mamba-1 selective scan.
# ---------------------------------------------------------------------------

def _scan_terms(delta, xs, B, C, A, reset):
    """float32 views of the inputs and the per-step decay ``a [T, DI, DS]``
    (0 where a sequence starts) and input ``bx = (delta x) B``."""
    d, x = delta.float(), xs.float()
    Bf, Cf, Af = B.float(), C.float(), A.float()
    keep = (reset.reshape(-1) == 0)[:, None, None]
    a = torch.where(keep, torch.exp(d[:, :, None] * Af), 0.0)
    bx = (d * x)[:, :, None] * Bf[:, None, :]
    return d, x, Bf, Cf, Af, a, bx


def _states(a, bx, h):
    """``h_t = a_t h_{t-1} + bx_t`` one step after another: ``[T, DI,
    DS]``."""
    hs = torch.empty_like(bx)
    for t in range(a.shape[0]):
        h = torch.addcmul(bx[t], a[t], h)
        hs[t] = h
    return hs


def mamba_scan_reference(delta, xs, B, C, A, reset, h0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's function, one time step after another in float32:
    ``a_t = exp(delta_t A)`` (0 where ``reset_t``), ``h_t = a_t h_{t-1} +
    (delta_t x_t) B_t`` from ``h_{-1} = h0``, ``y_t = h_t . C_t``.
    delta, xs ``[T, DI]``; B, C ``[T, DS]``; A, h0 ``[DI, DS]``; reset
    ``[T]`` (non-zero: a sequence starts). Returns ``(y [T, DI], h_last
    [DI, DS])``, float32. It holds the ``[T, DI, DS]`` decays, inputs and
    states (the kernel holds none)."""
    _, _, _, Cf, _, a, bx = _scan_terms(delta, xs, B, C, A, reset)
    hs = _states(a, bx, h0.float())
    h_last = hs[-1] if hs.shape[0] else h0.float()
    return torch.einsum("tds,ts->td", hs, Cf), h_last


def mamba_scan_grad(delta, xs, B, C, A, reset, h0, dy, dh_last=None):
    """Kernel D''s function: ``y`` and the gradients of ``sum(dy * y) +
    sum(dh_last * h_last)`` in every input, in float32: the states forward,
    then ``dh_t = dh_{t+1} a_{t+1} + dy_t C_t`` backward one step after
    another, the rest as sums over the ``[T, DI, DS]`` terms (checked
    against ``jax.grad`` in ``tests/test_torch_ssm.py``). Returns ``(y, d_delta, d_xs,
    dB, dC, dA, dh0)``."""
    d, x, Bf, Cf, Af, a, bx = _scan_terms(delta, xs, B, C, A, reset)
    h0f = h0.float()
    hs = _states(a, bx, h0f)
    del bx
    dyf = dy.float()
    y = torch.einsum("tds,ts->td", hs, Cf)
    dh = (torch.zeros_like(h0f) if dh_last is None
          else dh_last.float().clone())
    dhs = torch.empty_like(hs)
    for t in range(a.shape[0] - 1, -1, -1):
        dh = torch.addr(dh, dyf[t], Cf[t])
        dhs[t] = dh
        dh = dh * a[t]
    dC = torch.einsum("td,tds->ts", dyf, hs)
    # d(loss)/d(delta_t A): dh_t h_{t-1} a_t
    dadt = dhs * a
    del a
    if hs.shape[0]:
        dadt[1:] *= hs[:-1]
        dadt[0] *= h0f
    del hs
    dA = torch.einsum("tds,td->ds", dadt, d)
    d_delta = torch.einsum("tds,ds->td", dadt, Af)
    del dadt
    dhB = torch.einsum("tds,ts->td", dhs, Bf)
    d_delta += dhB * x
    d_xs = dhB * d
    dB = torch.einsum("tds,td->ts", dhs, d * x)
    return y, d_delta, d_xs, dB, dC, dA, dh


def _gate_terms(dt_pre, z, dt_bias, live):
    """The mixer's prologue and gate in float32: ``pre = dt_pre +
    dt_bias``, ``delta = softplus(pre)`` (0 where ``live`` is False),
    ``z`` and ``sigmoid(z)``."""
    pre = dt_pre.float() + dt_bias.float()
    delta = torch.where(live.reshape(-1)[:, None],
                        torch.nn.functional.softplus(pre), 0.0)
    z32 = z.float()
    return pre, delta, z32, torch.sigmoid(z32)


def mamba_scan_gated(dt_pre, xc, B, C, z, dt_bias, A, d_skip, live, reset,
                     h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gated kernel D's function (the mamba mixer's scan): ``delta =
    softplus(dt_pre + dt_bias)`` in float32, 0 on a row where ``live`` is
    False, the scan of :func:`mamba_scan_reference` on ``(delta, xc, B,
    C)``, then ``out = (y + d_skip xc) silu(z)`` rounded to xc's dtype.
    Returns ``(out [T, DI], h_last [DI, DS] float32)``."""
    _, delta, z32, _ = _gate_terms(dt_pre, z, dt_bias, live)
    y, h_last = mamba_scan_reference(delta, xc, B, C, A, reset, h0)
    y += xc.float() * d_skip.float()
    return (y * torch.nn.functional.silu(z32)).to(xc.dtype), h_last


def mamba_scan_gated_grad(dt_pre, xc, B, C, z, dt_bias, A, d_skip, live,
                          reset, h0, dout, dh_last=None):
    """The gated kernel D''s function: the gradients of ``sum(dout * out)
    + sum(dh_last * h_last)`` for :func:`mamba_scan_gated`, through
    :func:`mamba_scan_grad` and the prologue and epilogue in float32.
    Returns ``(d_pre, d_xc, dz, dB, dC, dA, d_bias, d_dskip, dh0)``: d_pre
    (0 on pad rows), d_xc and dz in xc's, dt_pre's and z's dtypes, the rest
    float32 (dA is the gradient in A, d_bias the float32 sum of d_pre)."""
    pre, delta, z32, sig = _gate_terms(dt_pre, z, dt_bias, live)
    g = dout.float()
    dy = g * (z32 * sig)
    y, d_delta, d_xs, dB, dC, dA, dh0 = mamba_scan_grad(
        delta, xc, B, C, A, reset, h0, dy, dh_last)
    xc32, dsk = xc.float(), d_skip.float()
    d_dskip = (dy * xc32).sum(0)
    d_xs += dy * dsk                      # d xc: the scan and the skip
    y += xc32 * dsk                       # the gate's input
    dz = (g * y * sig * (1.0 + z32 * (1.0 - sig))).to(z.dtype)
    d_pre = torch.where(live.reshape(-1)[:, None],
                        d_delta * torch.sigmoid(pre), 0.0)
    return (d_pre.to(dt_pre.dtype), d_xs.to(xc.dtype), dz, dB, dC, dA,
            d_pre.sum(0), d_dskip, dh0)
