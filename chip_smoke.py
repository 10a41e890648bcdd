"""Chip smoke test of the PyTorch port: drives its main paths on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (a failed phase stops the script with a non-zero
exit and no result line):

  build    compile the CUDA kernels for sm_90a, one nvcc per source, side
           by side (nvcc -Xptxas -v lines), and the card's name and power
           limit from nvidia-smi;
  kernel   every kernel against its plain PyTorch version on the card,
           each case with its max error against the tolerance, kernel_ms /
           plain_ms / library_ms (CUDA events) and the roofline bound, and
           proof that the tolerance catches a wrong kernel (the kernel fed
           a fault must fall outside it):
           * the flash-attention op (split pass ``flash_fwd_kernel``,
             merge pass ``flash_combine_kernel``) at engine-step shapes of
             gemma3-1b (window 512 and 0, bf16 and float32) and
             llama3.2-3b (bf16), and the merge pass alone (faults: a
             window or causal limit one off, a live KV tile or a KV split
             dropped);
           * the attention backward (``flash_bwd_dkdv_kernel``,
             ``flash_bwd_dq_kernel``), the forward's output and its
             log-sum-exp on the train phase's largest chunk of step 0 (its
             own segments and positions, no context; gemma3-1b global and
             window-512 layers, bf16), then on a training chunk with
             context rows, for gemma3-1b global and window-512 layers and
             llama3.2-3b (faults: a window or causal limit one off, a live
             KV tile dropped);
           * the cross-entropy kernels B (``ce_fwd_kernel``), C1 and C2
             (``ce_bwd_kernel``) on that chunk's targets (gemma3-1b head,
             bf16), then at T = 8192 tokens on gemma3-1b's (D 1152,
             V 262144) and llama3.2-3b's (D 3072, V 128256) head, bf16 and
             float32 (faults: a target shifted by one, one vocab tile
             dropped);
           the plain versions run over blocks of rows, so that their
           materialised scores or logits fit the card; the kernels line
           reports the train-chunk cases of the training kernels;
  serve    gemma3-1b at full width, bf16, random weights from --seed, 16
           requests of the "github" trace served by the continuous-batching
           engine (n_items=4, cap_t=512, page_sz=16, k=1); every request
           must complete, the split pass must launch 26 times per engine
           step, the merge pass at least once, and the plain attention
           never;
  verify   the same engine in float32 on the first 2 requests (8 new
           tokens) against the port's one_shot_generate;
  train    gemma3-1b at full width, bf16 with a float32 AdamW master, 3
           steps of ``launch/train.train`` on github batches of 8 x 16384
           tokens planned for one H100: per step
           loss, tokens, wall time, tokens/s, peak device memory and the
           plan's own estimate; every loss finite, every kernel launched
           exactly as the plan predicts (attention forward 26 x chunks +
           remat depths, each backward pass 26 x chunks, B, C1, C2 once
           per chunk) and no plain call;
  train_verify  float32 at full width on a short batch (one sequence
           split over 3 chunks, one packed chunk, a non-zero remat table):
           the chunked step with the plan's remat table launches the
           attention forward 26 x chunks + the remat depths times, and
           it, the same step with the table zeroed, and one unchunked
           forward and backward per sequence agree (loss and gradients
           within 1e-5 relative);
  kernels  every kernel of the port with its launch counts in serve and
           train.

The last two lines are the kernels JSON and the device JSON.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense): operations per second by the
# inputs' type, and HBM3 bytes per second
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_BYTES_PER_S = 3.35e12
# bf16: a few units of the output's last place (its values are O(0.03) to
# O(1)); float32: the JAX package's kernel-test tolerance
TOL = {"bfloat16": dict(rtol=1e-2, atol=4e-3),
       "float32": dict(rtol=2e-5, atol=2e-5)}


class PhaseError(RuntimeError):
    pass


def _nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


KERNEL_NAMES = ("flash_fwd_kernel", "flash_combine_kernel",
                "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                "ce_fwd_kernel", "ce_bwd_kernel")


def _ptxas_summary(log: str):
    """One line per compiled kernel: name, dtype, head dim or variant,
    registers, shared memory, stack and spills (from ``nvcc -Xptxas -v``)."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kind = next((k for k in KERNEL_NAMES if k in ln), "?")
            dt = "bf16" if "bfloat16" in ln else "f32"
            m = re.search(r"Li(\d+)E", ln)
            var = m.group(1) if m else ("dw" if "Lb1E" in ln else
                                        "dh" if "Lb0E" in ln else "")
            name = f"{kind}<{dt}{',' + var if var else ''}>"
        elif "spill" in ln:
            spill = ln.strip()
        elif "ptxas info" in ln and "Used" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return out


def _cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _engine_like(rng, segments, n_items, cap_t, Hq, Hkv, D, dtype, dev,
                 window=0):
    """Inputs shaped like one engine step: ``segments`` = [(ctx, n_tok)]
    placed first-fit into ``n_items`` items of ``cap_t`` tokens; the KV
    buffer holds every segment's context rows (with a window, only the
    last ``window - 1``, as the engine gathers them), then all chunk
    rows."""
    import numpy as np
    import torch
    T = n_items * cap_t
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    fill = [0] * n_items
    ctx_seg, ctx_pos = [], []
    for g, (ctx, n) in enumerate(segments):
        i = next(i for i in range(n_items) if fill[i] + n <= cap_t)
        a = i * cap_t + fill[i]
        seg[a:a + n] = g
        pos[a:a + n] = np.arange(ctx, ctx + n)
        fill[i] += n
        lo = max(0, ctx - window + 1) if window > 0 else 0
        ctx_seg.append(np.full(ctx - lo, g, np.int32))
        ctx_pos.append(np.arange(lo, ctx, dtype=np.int32))
    kseg = np.concatenate(ctx_seg + [seg])
    kpos = np.concatenate(ctx_pos + [pos])
    pad = (-len(kseg)) % 32
    kseg = np.concatenate([kseg, np.full(pad, -2, np.int32)])
    kpos = np.concatenate([kpos, np.zeros(pad, np.int32)])
    S = len(kseg)

    def mk(*shape):
        x = torch.randn(shape, generator=rng, device=dev, dtype=torch.float32)
        return x.to(dtype)
    meta = [torch.from_numpy(a).to(dev) for a in (seg, kseg, pos, kpos)]
    return mk(T, Hq, D), mk(S, Hkv, D), mk(S, Hkv, D), meta


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _within(got, want, dtype) -> tuple:
    """(max |got - want|, whether every element is within TOL)."""
    tol = TOL[_dtype_name(dtype)]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
    return float(err.max()), ok


def _bound(flops, nbytes, dtype):
    t_ops = flops / H100_FLOPS[_dtype_name(dtype)]
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def _mutants(window, seg_kv, pos_q):
    """Inputs under which the kernel computes what a kernel with one of
    these faults would: a causal or window limit one off, one live KV tile
    of segment 0's context (the one just before its chunk) dropped."""
    n0 = int((seg_kv != 0).nonzero()[0])    # segment 0's context rows
    seg_drop = seg_kv.clone()
    seg_drop[n0 - 32:n0] = -2
    out = {"causal off by one": dict(pos_q=pos_q - 1),
           "one KV tile dropped": dict(seg_kv=seg_drop)}
    if window > 0:
        out["window + 1"] = dict(window=window + 1)
        out["window - 1"] = dict(window=window - 1)
    return out


def _kernel_case(name, segments, Hq, Hkv, D, window, dtype, dev, seed):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, meta = _engine_like(gen, segments, 4, 512, Hq, Hkv, D, dtype,
                                 dev, window)
    seg_q, seg_kv, pos_q, pos_kv = meta
    args = dict(q=q, k=k, v=v, seg_q=seg_q, seg_kv=seg_kv, pos_q=pos_q,
                pos_kv=pos_kv, window=window)
    got = ops.flash_attention(**args)
    want = ref.flash_attention_reference(**args)
    max_err, ok = _within(got, want, dtype)
    zeros_ok = int(torch.count_nonzero(got[seg_q < 0])) == 0
    caught, missed = {}, []
    for fault, change in _mutants(window, seg_kv, pos_q).items():
        caught[fault], inside = _within(
            ops.flash_attention(**{**args, **change}), want, dtype)
        if inside:
            missed.append(fault)
    kernel_ms = _cuda_ms(lambda: ops.flash_attention(**args))
    plain_ms = _cuda_ms(lambda: ref.flash_attention_reference(**args),
                        iters=5, warmup=1)
    mask = ref.attention_mask(seg_q, seg_kv, pos_q, pos_kv, True, window)
    G = Hq // Hkv
    ke = k.repeat_interleave(G, dim=1).transpose(0, 1)[None]
    ve = v.repeat_interleave(G, dim=1).transpose(0, 1)[None]
    qe = q.transpose(0, 1)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _cuda_ms(lambda: sdpa(qe, ke, ve, attn_mask=mask),
                          iters=5, warmup=1)
    pairs = int(mask.sum()) * Hq
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got)) + \
        sum(t.numel() * 4 for t in meta)
    bound_ms, bound_by = _bound(4.0 * D * pairs, nbytes, dtype)  # QK^T, PV
    rec = dict(case=name, dtype=_dtype_name(dtype), T=q.shape[0],
               S=k.shape[0], Hq=Hq, Hkv=Hkv, D=D, window=window,
               live_pairs=pairs, max_abs_err=max_err,
               tol=TOL[_dtype_name(dtype)], within_tol=ok,
               masked_rows_zero=zeros_ok, faults_max_abs_err=caught,
               faults_within_tol=missed, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    del ke, ve, mask
    if not (ok and zeros_ok):
        raise PhaseError(f"kernel disagrees with the plain version: {rec}")
    if missed:
        raise PhaseError(f"the tolerance does not catch {missed}: {rec}")
    return rec


def _combine_case(name, segments, Hq, Hkv, D, window, dtype, dev, seed):
    """The merge pass alone, on the split pass's partial states of one
    engine-step case, against :func:`ref.combine_partials`."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_combine_cuda,
                                                     kv_splits)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, meta = _engine_like(gen, segments, 4, 512, Hq, Hkv, D, dtype,
                                 dev, window)
    padded = ops.pad_for_kernel(q, k, v, *meta)
    n_split = kv_splits(padded[1].shape[0])
    ws_ml, ws_acc = flash_attention_cuda.partials(*padded, n_split=n_split,
                                                  window=window)
    got = flash_combine_cuda(ws_ml, ws_acc, dtype)
    want = ref.combine_partials(ws_ml, ws_acc, dtype)
    max_err, ok = _within(got, want, dtype)
    # a merge that loses one split: split 0's sums zeroed
    lost = ws_ml.clone()
    lost[0, ..., 1] = 0
    fault_err, missed = _within(flash_combine_cuda(lost, ws_acc, dtype),
                                want, dtype)
    live = int((ws_ml[..., 1] > 0).sum())
    kernel_ms = _cuda_ms(lambda: flash_combine_cuda(ws_ml, ws_acc, dtype))
    plain_ms = _cuda_ms(lambda: ref.combine_partials(ws_ml, ws_acc, dtype),
                        iters=5, warmup=1)
    # reads every (m, l) and the live splits' acc rows, writes the output;
    # a multiply-add per live element
    nbytes = ws_ml.numel() * 4 + live * D * 4 + got.numel() * \
        got.element_size()
    bound_ms, bound_by = _bound(2.0 * live * D, nbytes, torch.float32)
    rec = dict(case=name, dtype=_dtype_name(dtype), T=q.shape[0],
               n_split=n_split, live_partials=live, max_abs_err=max_err,
               tol=TOL[_dtype_name(dtype)], within_tol=ok,
               faults_max_abs_err={"one split dropped": fault_err},
               faults_within_tol=["one split dropped"] if missed else [],
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by)
    if not ok:
        raise PhaseError(f"merge disagrees with the plain version: {rec}")
    if missed:
        raise PhaseError(f"the tolerance does not catch a lost split: {rec}")
    return rec


def phase_kernel(dev):
    import torch
    # one gemma3-1b engine step: a long prompt's last chunk, a middle
    # chunk, two short prompts, twelve decode streams, padding
    dec = [(500 + 300 * i, 1) for i in range(12)]
    gemma = [(3584, 512), (1024, 512), (0, 300), (800, 200)] + dec
    llama = [(1024, 512), (0, 512), (256, 400), (0, 500)] + dec[:4]
    bf16, f32 = torch.bfloat16, torch.float32
    attn = [
        _kernel_case("gemma3-1b global", gemma, 4, 1, 256, 0, bf16, dev, 1),
        _kernel_case("gemma3-1b local", gemma, 4, 1, 256, 512, bf16, dev, 2),
        _kernel_case("llama3.2-3b", llama, 24, 8, 128, 0, bf16, dev, 3),
        _kernel_case("gemma3-1b global", gemma, 4, 1, 256, 0, f32, dev, 4),
        _kernel_case("gemma3-1b local", gemma, 4, 1, 256, 512, f32, dev, 5),
    ]
    merge = [
        _combine_case("gemma3-1b global", gemma, 4, 1, 256, 0, bf16, dev, 1),
        _combine_case("gemma3-1b global", gemma, 4, 1, 256, 0, f32, dev, 4),
    ]
    return attn, merge


def _close_scaled(got, want, dtype) -> tuple:
    """(max |got - want|, within TOL[dtype] with atol scaled by max |want|):
    for gradients and cross-entropy outputs, sums of many terms of both
    signs whose size varies by case."""
    tol = TOL[_dtype_name(dtype)]
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max()) or 1.0
    err = (got - want).abs()
    ok = bool((err <= tol["atol"] * scale + tol["rtol"] * want.abs()).all())
    return float(err.max()), ok


def _train_chunk(gen, C, pieces, Hq, Hkv, D, dtype, dev):
    """Inputs shaped like one training chunk: ``C`` context rows of
    segment 0 (the carry), 64 stale carry rows beyond the context length
    (seg -1), then the chunk: ``pieces[0]`` rows continuing segment 0 at
    position C, the other pieces packed short sequences, padding to a
    multiple of 64."""
    import numpy as np
    import torch
    T = -(-sum(pieces) // 64) * 64
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    a = 0
    for g, n in enumerate(pieces):
        seg[a:a + n] = g
        pos[a:a + n] = np.arange(n) + (C if g == 0 else 0)
        a += n
    stale = 64
    kseg = np.concatenate([np.zeros(C, np.int32),
                           np.full(stale, -1, np.int32), seg])
    kpos = np.concatenate([np.arange(C + stale, dtype=np.int32), pos])

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)
    S = len(kseg)
    meta = [torch.from_numpy(x).to(dev) for x in (seg, kseg, pos, kpos)]
    return mk(T, Hq, D), mk(S, Hkv, D), mk(S, Hkv, D), mk(T, Hq, D), meta


def _plan_chunk(gen, seg, pos, Hq, Hkv, D, dtype, dev):
    """Inputs shaped like one of the train phase's context-free chunks:
    its own seg and pos rows as queries and keys, random q, k, v and
    output gradient."""
    import torch

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)
    T = len(seg)
    meta = [torch.from_numpy(x).to(dev) for x in (seg, seg, pos, pos)]
    return mk(T, Hq, D), mk(T, Hkv, D), mk(T, Hkv, D), mk(T, Hq, D), meta


# the plain versions run over blocks of this many rows, so that their
# materialised [Hq, rows, S] scores or [rows, V] logits fit the card at a
# training chunk's length; a case of at most this many rows is one block
ATTN_ROW_BLOCK = 4096
CE_ROW_BLOCK = 8192


def _plain_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv, dout, window):
    """(out, lse, dq, dk, dv) of the plain attention, over blocks of query
    rows: ``ref.flash_attention_reference``, ``ref.flash_attention_lse``
    and ``ref.flash_attention_grad`` of each block (rows are independent;
    dk and dv are the blocks' sum, in float32)."""
    import torch

    from repro_torch.kernels import ref
    outs, lses, dqs, dk, dv = [], [], [], 0.0, 0.0
    for a in range(0, q.shape[0], ATTN_ROW_BLOCK):
        b = slice(a, a + ATTN_ROW_BLOCK)
        rows = (seg_q[b], seg_kv, pos_q[b], pos_kv)
        outs.append(ref.flash_attention_reference(q[b], k, v, *rows,
                                                  window=window))
        lses.append(ref.flash_attention_lse(q[b], k, *rows, window=window))
        gq, gk, gv = ref.flash_attention_grad(q[b], k, v, *rows, dout[b],
                                              window=window)
        dqs.append(gq)
        dk, dv = dk + gk.float(), dv + gv.float()
    return (torch.cat(outs), torch.cat(lses, dim=1), torch.cat(dqs),
            dk.to(k.dtype), dv.to(v.dtype))


def _attn_bwd_case(name, inputs, drop, window, dtype, dev, seed):
    """The attention backward (both passes), the forward's output and its
    lse on one training chunk made by ``inputs(gen, dtype)``, against
    autograd of the plain attention in float32. ``drop``: the KV rows of
    one live tile, for the dropped-tile fault."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout, meta = inputs(gen, dtype)
    (T, Hq, D), Hkv = q.shape, k.shape[1]
    seg_q, seg_kv, pos_q, pos_kv = meta

    def grads(seg_kv=seg_kv, pos_q=pos_q, window=window):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = ops.flash_attention(qq, kk, vv, seg_q, seg_kv, pos_q, pos_kv,
                                  window=window)
        out.backward(dout)
        return qq.grad, kk.grad, vv.grad

    def err_of(got):
        errs = [_close_scaled(g, w, dtype) for g, w in zip(got, want)]
        return max(e for e, _ in errs), all(ok for _, ok in errs)
    want_out, want_lse, *want = _plain_attention(
        q.float(), k.float(), v.float(), *meta, dout.float(), window)
    max_err, ok = err_of(grads())
    padded = ops.pad_for_kernel(q, k, v, *meta)
    out, lse = flash_attention_cuda(*padded, window=window, with_lse=True)
    out_err, out_ok = _within(out[:T], want_out, dtype)
    live, got_lse = torch.isfinite(want_lse), lse[:, :T]
    lse_err = float((got_lse[live] - want_lse[live]).abs().max())
    lse_ok = bool(torch.equal(torch.isfinite(got_lse), live)) and \
        lse_err <= TOL["float32"]["atol"] + TOL["float32"]["rtol"] * float(
            want_lse[live].abs().max())
    del want_out, want_lse, got_lse
    # faults: a causal limit one off, a live KV tile dropped, a window one
    # off
    seg_drop = seg_kv.clone()
    seg_drop[drop] = -2
    faults = {"causal off by one": dict(pos_q=pos_q - 1),
              "one KV tile dropped": dict(seg_kv=seg_drop)}
    if window > 0:
        faults["window + 1"] = dict(window=window + 1)
        faults["window - 1"] = dict(window=window - 1)
    caught, missed = {}, []
    for fault, change in faults.items():
        caught[fault], inside = err_of(grads(**change))
        if inside:
            missed.append(fault)
    pm = [t.contiguous() for t in padded[3:]]
    do = ops.pad_rows(dout, 32).contiguous()

    ms = {"dkdv": _cuda_ms(lambda: flash_bwd_dkdv_cuda(
              *padded[:3], out, do, lse, *pm, window=window), iters=3,
              warmup=1),
          "dq": _cuda_ms(lambda: flash_bwd_dq_cuda(
              *padded[:3], out, do, lse, *pm, window=window), iters=3,
              warmup=1)}
    plain_ms = _cuda_ms(lambda: [ref.flash_attention_grad(
        q[b], k, v, seg_q[b], seg_kv, pos_q[b], pos_kv, dout[b],
        window=window) for b in (slice(a, a + ATTN_ROW_BLOCK) for a in
                                 range(0, T, ATTN_ROW_BLOCK))],
        iters=2, warmup=1)
    mask = ref.attention_mask(seg_q, seg_kv, pos_q, pos_kv, True, window)
    pairs = int(mask.sum()) * Hq
    del mask
    # per live (query, key, head), products of 2 D flops: the backward as a
    # whole needs 5 (S = Q K^T recomputed, dP = dO V^T, dV = P^T dO,
    # dQ = dS K, dK = dS^T Q); the dk/dv pass alone 4 (S, dP, dV, dK), the
    # dq pass alone 3 (S, dP, dQ). Bytes: q, k, v, out, dout, lse and the
    # metadata read once, the pass's gradients written once.
    size = {n: t.numel() * t.element_size() for n, t in
            (("q", q), ("k", k), ("v", v))}
    common = 3 * size["q"] + size["k"] + size["v"] + lse.numel() * 4 + \
        sum(t.numel() * 4 for t in meta)
    bounds = {"all": _bound(10.0 * D * pairs, common + size["q"] + size["k"]
                            + size["v"], dtype),
              "dkdv": _bound(8.0 * D * pairs, common + size["k"] + size["v"],
                             dtype),
              "dq": _bound(6.0 * D * pairs, common + size["q"], dtype)}
    bound_ms, bound_by = bounds["all"]
    kernel_ms = ms["dkdv"] + ms["dq"]
    rec = dict(case=name, dtype=_dtype_name(dtype), T=q.shape[0],
               S=k.shape[0], Hq=Hq, Hkv=Hkv, D=D, window=window,
               live_pairs=pairs, max_abs_err=max_err, lse_max_abs_err=lse_err,
               out_max_abs_err=out_err, tol=TOL[_dtype_name(dtype)],
               within_tol=ok and lse_ok and out_ok,
               faults_max_abs_err=caught, faults_within_tol=missed,
               kernel_ms=kernel_ms, kernel_ms_covers="dk/dv pass + dq pass",
               kernel_ms_dkdv=ms["dkdv"], kernel_ms_dq=ms["dq"],
               bound_ms_dkdv=bounds["dkdv"][0],
               bound_by_dkdv=bounds["dkdv"][1], bound_ms_dq=bounds["dq"][0],
               bound_by_dq=bounds["dq"][1], plain_ms=plain_ms,
               plain_is=f"autograd of the plain attention: dq, dk, dv at "
                        f"once, over blocks of {ATTN_ROW_BLOCK} query rows",
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    if not (ok and lse_ok and out_ok):
        raise PhaseError(f"attention backward disagrees with the plain "
                         f"version: {rec}")
    if missed:
        raise PhaseError(f"the tolerance does not catch {missed}: {rec}")
    return rec


CE_HEADS = {"gemma3-1b": (1152, 262144), "llama3.2-3b": (3072, 128256)}
CE_T = 8192
# the train phase: github batches of 8 sequences of up to 16,384 tokens
TRAIN_BATCH, TRAIN_CONTEXT, TRAIN_STEPS = 8, 16384, 3


def _plain_ce(key, h, w, tgt, lse, g):
    """The plain version of B, C1 or C2 (``ref``) over blocks of
    CE_ROW_BLOCK tokens: rows are independent in B and C1; C2 is the sum
    of its blocks in float32 (the plain version upcasts its inputs and
    casts its result to w's dtype)."""
    import torch

    from repro_torch.kernels import ref
    blocks = [slice(a, a + CE_ROW_BLOCK)
              for a in range(0, h.shape[0], CE_ROW_BLOCK)]
    if key == "B":
        parts = [ref.cross_entropy_fwd_plain(h[b], w, tgt[b])
                 for b in blocks]
        return tuple(torch.cat(x) for x in zip(*parts))
    if key == "C1":
        return torch.cat([ref.cross_entropy_bwd_dh_plain(
            h[b], w, tgt[b], lse[b], g[b]) for b in blocks])
    wf = w.float()
    return sum(ref.cross_entropy_bwd_dw_plain(h[b].float(), wf, tgt[b],
                                              lse[b], g[b])
               for b in blocks).to(w.dtype)


def _ce_case(arch, dtype, dev, seed, targets=None, case=None):
    """Kernels B, C1 and C2 on one chunk against their plain versions
    (materialised logits in float32): ``targets`` (int32, -1 on rows
    without a target) as the train step feeds them, each valid row's loss
    weighted 1 / n_valid; else CE_T random targets weighted 1 / CE_T. Two
    targets are moved into the last vocab tile."""
    import torch

    from repro_torch.kernels.cross_entropy import (VOCAB_TILE,
                                                   ce_bwd_dh_cuda,
                                                   ce_bwd_dw_cuda,
                                                   ce_fwd_cuda, d_slices)
    D, V = CE_HEADS[arch]
    gen = torch.Generator(device=dev).manual_seed(seed)
    if targets is None:
        tgt = torch.randint(0, V, (CE_T,), generator=gen, device=dev,
                            dtype=torch.int32)
    else:
        tgt = targets.to(dev, torch.int32).clone()
    T = tgt.shape[0]
    h = torch.randn((T, D), generator=gen, device=dev).to(dtype)
    w = (torch.randn((V, D), generator=gen, device=dev) * 0.02).to(dtype)
    tgt[0], tgt[1] = V - 1, V - 2        # targets in the last vocab tile
    valid = (tgt >= 0).float()
    g = valid / valid.sum()
    lse_p, tl_p = _plain_ce("B", h, w, tgt, None, None)
    f32 = torch.float32
    recs = {}
    # faults: a target shifted by one; the last vocab tile dropped
    shifted = tgt + 1
    w_cut = w[:V - VOCAB_TILE]

    # lse is held to an absolute limit (its values are ~log V; a dropped
    # tile moves it by ~1e-4)
    lse_tol = TOL["float32"]["atol"]

    def fwd_check(out):
        lse, tl = out
        e_tl, ok_tl = _close_scaled(tl, tl_p, f32)
        e_lse = float((lse - lse_p).abs().max())
        return max(e_tl, e_lse), ok_tl and e_lse <= lse_tol
    plain = {key: functools.partial(_plain_ce, key, h, w, tgt, lse_p, g)
             for key in ("B", "C1", "C2")}
    kern = {"B": lambda t=tgt, ww=w: ce_fwd_cuda(h, ww, t),
            "C1": lambda t=tgt, ww=w: ce_bwd_dh_cuda(h, ww, t, lse_p, g),
            "C2": lambda t=tgt, ww=w: ce_bwd_dw_cuda(h, ww, t, lse_p, g)}
    names = {"B": "ce_fwd_kernel", "C1": "ce_bwd_kernel<dh>",
             "C2": "ce_bwd_kernel<dw>"}
    eb = 2 if dtype == torch.bfloat16 else 4
    in_bytes = (T * D + V * D) * eb + T * 4
    for key in ("B", "C1", "C2"):
        want = plain[key]()

        def check(out, want=want, key=key):
            if key == "B":
                return fwd_check(out)
            if key == "C2" and out.shape[0] != want.shape[0]:
                out = torch.cat([out, torch.zeros_like(want[out.shape[0]:])])
            return _close_scaled(out, want, dtype)
        max_err, ok = check(kern[key]())
        caught, missed = {}, []
        for fault, out in (("target shifted by one", kern[key](t=shifted)),
                           ("one vocab tile dropped", kern[key](ww=w_cut))):
            caught[fault], inside = check(out)
            if inside:
                missed.append(fault)
        kernel_ms = _cuda_ms(kern[key], iters=2, warmup=1)
        plain_ms = _cuda_ms(plain[key], iters=1, warmup=1)
        library_ms = None
        if key == "B":      # the materialised-logits yardstick
            library_ms = _cuda_ms(lambda: torch.logsumexp(
                h.float() @ w.float().T, dim=-1), iters=1, warmup=1)
        products = 1 if key == "B" else 2     # C1/C2: logits, contraction
        out_bytes = {"B": 8 * T, "C1": T * D * eb, "C2": V * D * eb}[key]
        extra = 0 if key == "B" else 8 * T    # lse, g
        bound_ms, bound_by = _bound(2.0 * T * V * D * products,
                                    in_bytes + extra + out_bytes, dtype)
        rec = dict(name=names[key], kernel=key, case=case or arch,
                   dtype=_dtype_name(dtype), T=T, D=D, V=V,
                   d_slices=d_slices(D) if key != "B" else None,
                   max_abs_err=max_err, tol=TOL[_dtype_name(dtype)],
                   within_tol=ok, faults_max_abs_err=caught,
                   faults_within_tol=missed, kernel_ms=kernel_ms,
                   plain_ms=plain_ms,
                   plain_is=f"ref's plain version over blocks of "
                            f"{CE_ROW_BLOCK} tokens",
                   library_ms=library_ms,
                   library_is=("h @ W.T + logsumexp, logits materialised"
                               if key == "B" else None),
                   bound_ms=bound_ms, bound_by=bound_by)
        del want
        if not ok:
            raise PhaseError(f"{key} disagrees with the plain version: {rec}")
        if missed:
            raise PhaseError(f"the tolerance does not catch {missed}: {rec}")
        recs[key] = rec
    return recs


def _largest_train_chunk(seed):
    """Step 0's largest chunk in the train phase, as the step feeds it to
    the model: ``(chunk, targets, seg, pos)`` (numpy rows)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import ClusterSpec, CostModel
    from repro_torch.data.batching import materialize_plan
    from repro_torch.launch.train import plan_step
    from repro_torch.runtime.train_step import chunk_arrays
    cfg = get_arch("gemma3-1b")
    corpus, plan = plan_step(CostModel(cfg.spec, ClusterSpec()),
                             _train_loop(seed), 0)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    k = max(range(len(chunks)), key=lambda i: chunks[i].tokens)
    if chunks[k].context:
        raise PhaseError(f"step 0's largest chunk continues a sequence; "
                         f"its kernel cases need the carry rows: {chunks[k]}")
    _, tgt, seg, pos = chunk_arrays(materialize_plan(plan, corpus), k,
                                    chunks[k].tokens)
    return chunks[k], tgt, seg, pos


def phase_kernel_training(dev, seed):
    """The attention backward and B, C1, C2: first at the shapes of the
    train phase's largest chunk of step 0 (gemma3-1b, bf16, the chunk's
    own segments, positions and targets), then on chunks with context rows
    and on both archs' heads at CE_T tokens, bf16 and float32."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    chunk, tgt, seg, pos = _largest_train_chunk(seed)
    name = f"gemma3-1b train chunk ({chunk.tokens} tokens)"
    a0 = int((seg >= 0).argmax())           # a live tile inside segment 0
    plan_rows = slice(a0 + 1024, a0 + 1056)

    def from_plan(gen, dtype):
        return _plan_chunk(gen, seg, pos, 4, 1, 256, dtype, dev)

    def with_context(C, pieces, Hq, Hkv, D):
        return lambda gen, dtype: _train_chunk(gen, C, pieces, Hq, Hkv, D,
                                               dtype, dev)
    gemma = with_context(12288, (3072, 600, 400), 4, 1, 256)
    llama = with_context(4096, (1536, 300, 200), 24, 8, 128)
    # the dropped tile: 32 rows inside segment 0, or with context rows the
    # last context tile before the chunk
    bwd = []
    for args in ((f"{name} global", from_plan, plan_rows, 0, bf16),
                 (f"{name} local", from_plan, plan_rows, 512, bf16),
                 ("gemma3-1b global", gemma, slice(12288 - 32, 12288), 0,
                  bf16),
                 ("gemma3-1b local", gemma, slice(12288 - 32, 12288), 512,
                  bf16),
                 ("llama3.2-3b", llama, slice(4096 - 32, 4096), 0, bf16),
                 ("gemma3-1b global", gemma, slice(12288 - 32, 12288), 0,
                  f32)):
        bwd.append(_attn_bwd_case(*args, dev, 11 + len(bwd)))
        print(f"[kernel] attention backward {json.dumps(bwd[-1])}",
              flush=True)
        torch.cuda.empty_cache()
    ce = [_ce_case("gemma3-1b", bf16, dev, 19, targets=torch.from_numpy(tgt),
                   case=name)]
    for rec in ce[-1].values():
        print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
    torch.cuda.empty_cache()
    for i, (arch, dt) in enumerate([("gemma3-1b", bf16), ("gemma3-1b", f32),
                                    ("llama3.2-3b", bf16),
                                    ("llama3.2-3b", f32)]):
        ce.append(_ce_case(arch, dt, dev, 20 + i))
        for rec in ce[-1].values():
            print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
        torch.cuda.empty_cache()
    return bwd, ce


# ---------------------------------------------------------------------------
# serve / verify phases
# ---------------------------------------------------------------------------

def _requests(trace, max_new=None):
    from repro_torch.serve.engine import Request
    return [Request(req_id=i, prompt=t["prompt"],
                    max_new_tokens=max_new or t["max_new_tokens"],
                    arrival=t["arrival"]) for i, t in enumerate(trace)]


def _econf(trace, max_new):
    from repro_torch.serve.engine import EngineConfig
    page_sz = 16
    longest = max(len(t["prompt"]) for t in trace)
    pp = -(-(longest + max_new) // page_sz)
    return EngineConfig(n_items=4, cap_t=512, n_pages=6 * pp,
                        page_sz=page_sz, pages_per_seq=pp, k=1)


def phase_serve(dev, cfg, params32, trace):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_combine_cuda)
    from repro_torch.models.model import tree_map
    from repro_torch.serve.engine import ServeEngine
    params = tree_map(lambda a: a.to(torch.bfloat16), params32)
    econf = _econf(trace, 32)
    # warm-up (cuBLAS handles, the kernel's first launch): one request
    warm = ServeEngine(cfg, econf, params=params,
                       param_dtype=torch.bfloat16, device=dev)
    warm.run(_requests(trace[:1], max_new=2))
    del warm
    eng = ServeEngine(cfg, econf, params=params, param_dtype=torch.bfloat16,
                      device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention_cuda.launches = 0
    flash_combine_cuda.launches = 0
    ops.flash_attention.plain_calls = 0
    results = eng.run(_requests(trace))
    launches = flash_attention_cuda.launches
    merges = flash_combine_cuda.launches
    plain = ops.flash_attention.plain_calls
    st = eng.stats()
    rec = dict(completed=st["completed"], requests=len(trace),
               steps=st["steps"], tokens_per_s=st["tokens_per_s"],
               wall_s=st["wall_s"], ttft_s_p50=st["ttft_s_p50"],
               ttft_s_p95=st["ttft_s_p95"], tpot_s_p50=st["tpot_s_p50"],
               tpot_s_p95=st["tpot_s_p95"],
               prefill_tokens_fed=st["prefill_tokens_fed"],
               emitted_tokens=st["emitted_tokens"],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               flash_launches=launches,
               flash_launches_expected=cfg.spec.n_layers * st["steps"],
               combine_launches=merges, plain_attention_calls=plain)
    bad = [r for r in results.values() if len(r.output_ids) != 32]
    if st["completed"] != len(trace) or bad:
        raise PhaseError(f"not every request completed: {rec}")
    if launches != cfg.spec.n_layers * st["steps"] or merges == 0 \
            or plain != 0:
        raise PhaseError(f"serve path did not run on the kernel: {rec}")
    return rec


def phase_verify(dev, cfg, params32, trace):
    import torch

    from repro_torch.serve.engine import ServeEngine, verify_against_one_shot
    sub = trace[:2]
    eng = ServeEngine(cfg, _econf(sub, 8), params=params32,
                      param_dtype=torch.float32, device=dev)
    res = eng.run(_requests(sub, max_new=8))
    ok, lines = verify_against_one_shot(
        cfg, params32, [t["prompt"] for t in sub],
        [res[i].output_ids for i in range(len(sub))], 8,
        compute_dtype=torch.float32, device=dev)
    if not ok:
        raise PhaseError("; ".join(lines))
    return lines


# ---------------------------------------------------------------------------
# train / train_verify phases
# ---------------------------------------------------------------------------

def _train_counters():
    from repro_torch.kernels import ops
    from repro_torch.kernels.cross_entropy import (ce_bwd_dh_cuda,
                                                   ce_bwd_dw_cuda,
                                                   ce_fwd_cuda)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda,
                                                     flash_combine_cuda)
    return {"flash_fwd_kernel": flash_attention_cuda,
            "flash_combine_kernel": flash_combine_cuda,
            "flash_bwd_dkdv_kernel": flash_bwd_dkdv_cuda,
            "flash_bwd_dq_kernel": flash_bwd_dq_cuda,
            "ce_fwd_kernel": ce_fwd_cuda,
            "ce_bwd_kernel<dh>": ce_bwd_dh_cuda,
            "ce_bwd_kernel<dw>": ce_bwd_dw_cuda,
            "plain_attention": ops.flash_attention,
            "plain_cross_entropy": ops.fused_cross_entropy}


def _read_counts(ctr):
    return {k: (c.plain_calls if k.startswith("plain") else c.launches)
            for k, c in ctr.items()}


def _zero_counts(ctr):
    for k, c in ctr.items():
        if k.startswith("plain"):
            c.plain_calls = 0
        else:
            c.launches = 0


def _train_loop(seed):
    from repro_torch.launch.train import TrainConfig
    return TrainConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                       context=TRAIN_CONTEXT, seed=seed,
                       compute_dtype="bfloat16")


def phase_train(dev, seed):
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.runtime.train_step import remat_depths
    cfg = get_arch("gemma3-1b")
    L = cfg.spec.n_layers
    ctr = _train_counters()
    steps_out, expected = [], {}

    def on_step(step, plan, corpus):
        if expected:
            steps_out[-1]["launches"] = _read_counts(ctr)
        n = plan.n_chunks
        depth = sum(remat_depths(plan, L))
        expected.clear()
        expected.update({"flash_fwd_kernel": L * n + depth,
                         "flash_bwd_dkdv_kernel": L * n,
                         "flash_bwd_dq_kernel": L * n,
                         "ce_fwd_kernel": n, "ce_bwd_kernel<dh>": n,
                         "ce_bwd_kernel<dw>": n, "plain_attention": 0,
                         "plain_cross_entropy": 0})
        steps_out.append({"expected": dict(expected), "remat_depths": depth,
                          "chunks": n,
                          "chunk_tokens": [c.tokens for p in plan.pipelines
                                           for c in p.chunks]})
        _zero_counts(ctr)
    lines = []
    _, hist = train(cfg, _train_loop(seed), device=dev, on_step=on_step,
                    log=lines.append)
    steps_out[-1]["launches"] = _read_counts(ctr)
    recs = []
    for h, st, ln in zip(hist, steps_out, lines):
        rec = dict(h, **st)
        recs.append(rec)
        print(f"[train] {ln}", flush=True)
        if not math.isfinite(h["loss"]):
            raise PhaseError(f"non-finite loss: {rec}")
        bad = {k: (st["launches"][k], v) for k, v in st["expected"].items()
               if st["launches"][k] != v}
        if bad:
            raise PhaseError(f"launch counts differ from the plan's "
                             f"(got, expected): {bad}; {rec}")
    torch.cuda.empty_cache()
    return recs


def phase_train_verify(dev, seed):
    """float32, full width: the chunked step with the plan's remat table ==
    the same step with the table zeroed == one unchunked forward/backward
    per sequence (loss and every gradient within 1e-5 relative)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.train_step import ChunkedTrainer, remat_depths
    cfg = get_arch("gemma3-1b")
    rng = np.random.default_rng(seed)
    lens = [3000, 900, 500, 300]
    corpus = {i: rng.integers(0, cfg.spec.vocab, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec())
    # a 2 GB activation budget: the ILP checkpoints layers of some chunks
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=64, remat_mode="stage_aware",
        capacity_bytes=cm.m_model_states(1) + 2e9))
    chunks = [c for p in plan.pipelines for c in p.chunks]
    if max(s.n_chunks for s in plan.sequences) < 3 or not any(
            c.kind.value == "hybrid" for c in chunks) or not any(
            plan.ckpt_table()[0]):
        raise PhaseError(f"the verify plan lacks a 3-chunk split, a packed "
                         f"chunk or remat: {plan.ckpt_table()}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tr = ChunkedTrainer(cfg, DecoderLM(cfg).init(gen, device=dev), device=dev,
                        compute_dtype=torch.float32)
    # the remat'd layers' forwards run again in the backward: the attention
    # forward launches 26 x chunks + the sum of the remat depths
    ctr = _train_counters()
    L, n = cfg.spec.n_layers, len(chunks)
    expected = {"flash_fwd_kernel": L * n + sum(remat_depths(plan, L)),
                "flash_bwd_dkdv_kernel": L * n, "flash_bwd_dq_kernel": L * n,
                "ce_fwd_kernel": n, "ce_bwd_kernel<dh>": n,
                "ce_bwd_kernel<dw>": n, "plain_attention": 0,
                "plain_cross_entropy": 0}
    _zero_counts(ctr)
    runs = {"plan table": tr.loss_and_grads(plan, corpus)}
    launches = {k: v for k, v in _read_counts(ctr).items() if k in expected}
    if launches != expected:
        raise PhaseError(f"launch counts with remat (got, expected): "
                         f"{launches}, {expected}")
    runs["table zeroed"] = tr.loss_and_grads(plan, corpus,
                                             remat_policy="none")
    runs["unchunked"] = tr.sequence_loss_and_grads(corpus)
    base = runs["plan table"]
    out = {"chunks": [(c.kind.value, c.context, c.tokens) for c in chunks],
           "remat_table": plan.ckpt_table()[0], "launches": launches,
           "loss": base.loss}
    for name, r in runs.items():
        if name == "plan table":
            continue
        worst = 0.0
        for a, b in zip(tree_leaves(r.grads), tree_leaves(base.grads)):
            worst = max(worst, float((a - b).abs().max()) /
                        max(float(b.abs().max()), 1e-30))
        rel_loss = abs(r.loss - base.loss) / abs(base.loss)
        out[name] = {"loss": r.loss, "loss_rel_diff": rel_loss,
                     "grad_max_rel_diff": worst}
        if rel_loss > 1e-5 or worst > 1e-5 or r.n_valid != base.n_valid:
            raise PhaseError(f"{name} differs from the chunked step: {out}")
    del runs, base, tr
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; chip_smoke.py "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_arch
        from repro_torch.data import sample_request_trace
        from repro_torch.kernels.build import load_libraries
        from repro_torch.models import DecoderLM
    except ImportError as e:
        print(f"error: the port is not importable from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s",
                  flush=True)
            raise SystemExit(1)
        return out, time.perf_counter() - t0

    smi, _ = run("build", _nvidia_smi)
    libs, dt = run("build", load_libraries)
    for b in libs.values():
        for ln in _ptxas_summary(b.build_log):
            print(f"[build] {ln}")
    print(f"[build] ok sm_90a {', '.join(b.path.name for b in libs.values())}"
          f" in {dt:.1f}s; card: {smi}", flush=True)

    (cases, merges), dt = run("kernel", lambda: phase_kernel(dev))
    for rec in cases:
        print(f"[kernel] {json.dumps(rec)}", flush=True)
    for rec in merges:
        print(f"[kernel] merge pass {json.dumps(rec)}", flush=True)
    (bwd, ce), dt2 = run("kernel", lambda: phase_kernel_training(
        dev, args.seed))
    print(f"[kernel] ok in {dt + dt2:.1f}s", flush=True)

    cfg = get_arch("gemma3-1b")
    trace = sample_request_trace("github", 16, 4096, cfg.spec.vocab,
                                 seed=0, max_new_tokens=32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params32 = DecoderLM(cfg).init(gen, dtype=torch.float32, device=dev)
    ctr = _train_counters()
    _zero_counts(ctr)
    srv, dt = run("serve", lambda: phase_serve(dev, cfg, params32, trace))
    serve_counts = _read_counts(ctr)
    print(f"[serve] {json.dumps(srv)} in {dt:.1f}s", flush=True)

    lines, dt = run("verify", lambda: phase_verify(dev, cfg, params32,
                                                   trace))
    print(f"[verify] ok in {dt:.1f}s: " + "; ".join(lines), flush=True)
    del params32
    torch.cuda.empty_cache()

    trn, dt = run("train", lambda: phase_train(dev, args.seed))
    for rec in trn:
        print(f"[train] {json.dumps(rec)}", flush=True)
    print(f"[train] ok in {dt:.1f}s", flush=True)
    train_counts = {k: sum(r["launches"][k] for r in trn) for k in ctr}

    ver, dt = run("train_verify", lambda: phase_train_verify(dev, args.seed))
    print(f"[train_verify] ok in {dt:.1f}s: {json.dumps(ver)}", flush=True)

    print(f"[kernels] serve: {json.dumps(serve_counts)}; train "
          f"({len(trn)} steps): {json.dumps(train_counts)}; total "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    fa = "src/repro_torch/kernels/csrc/flash_attention.cu"
    cs = "src/repro_torch/kernels/csrc/cross_entropy.cu"
    tpu_fa = "src/repro/kernels/flash_attention.py:89"
    g, m = cases[0], merges[0]          # gemma3-1b global layer, bf16
    gb = bwd[0]             # step 0's largest train chunk, global, bf16
    gce = ce[0]             # the gemma3-1b head on that chunk, bf16

    def entry(name, src, tpu, rec, **kw):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": tpu,
                "launches": serve_counts[name] + train_counts[name],
                "launches_serve": serve_counts[name],
                "launches_train": train_counts[name],
                "case": rec["case"], "max_abs_err": rec["max_abs_err"],
                "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]} | kw
    kernels = {"kernels": [
        entry("flash_fwd_kernel", fa, tpu_fa, g,
              ms_covers="the attention op: split pass and merge pass"),
        entry("flash_combine_kernel", fa, tpu_fa, m),
        entry("flash_bwd_dkdv_kernel", fa, tpu_fa + " (its gradient)", gb,
              ms=gb["kernel_ms_dkdv"], bound_ms=gb["bound_ms_dkdv"],
              bound_by=gb["bound_by_dkdv"], plain_is=gb["plain_is"]),
        entry("flash_bwd_dq_kernel", fa, tpu_fa + " (its gradient)", gb,
              ms=gb["kernel_ms_dq"], bound_ms=gb["bound_ms_dq"],
              bound_by=gb["bound_by_dq"], plain_is=gb["plain_is"]),
        entry("ce_fwd_kernel", cs, "src/repro/kernels/cross_entropy.py:79",
              gce["B"], library_is=gce["B"]["library_is"]),
        entry("ce_bwd_kernel<dh>", cs,
              "src/repro/kernels/cross_entropy.py:159", gce["C1"]),
        entry("ce_bwd_kernel<dw>", cs,
              "src/repro/kernels/cross_entropy.py:222", gce["C2"])]}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
