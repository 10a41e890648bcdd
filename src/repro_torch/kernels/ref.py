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
  of the two backward passes).
* :func:`cross_entropy_fwd_plain`, :func:`cross_entropy_bwd_dh_plain`,
  :func:`cross_entropy_bwd_dw_plain` — the plain versions of the streaming
  cross-entropy kernels B, C1 and C2 (materialised logits);
  :func:`cross_entropy_reference` and :func:`streaming_cross_entropy` — the
  JAX package's two loss oracles.

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
           "flash_attention_grad", "cross_entropy_reference",
           "streaming_cross_entropy", "cross_entropy_fwd_plain",
           "cross_entropy_bwd_dh_plain", "cross_entropy_bwd_dw_plain"]

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
