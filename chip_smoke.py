"""Chip smoke test of the PyTorch port: drives its main path on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (a failed phase stops the script with a non-zero
exit and no result line):

  build    compile the CUDA kernels for sm_90a (nvcc -Xptxas -v lines),
           and the card's name and power limit from nvidia-smi;
  kernel   the flash-attention op (split pass ``flash_fwd_kernel`` and
           merge pass ``flash_combine_kernel``) against its plain PyTorch
           version on the card, at engine-step shapes of gemma3-1b (Hq=4,
           Hkv=1, Dh=256; window 512 and 0) in bf16 and float32, and of
           llama3.2-3b (Hq=24, Hkv=8, Dh=128) in bf16; the merge pass alone
           against its plain version on the split pass's own partial
           states. Each case prints its max error against the tolerance
           (bf16: the output's own rounding, atol 4e-3 + rtol 1e-2;
           float32: 2e-5), exact zeros on masked rows, kernel_ms /
           plain_ms / library_ms (CUDA events) and the roofline bound, and
           shows that the tolerance catches a wrong kernel: the kernel fed
           a window or causal limit one off, or with one live KV tile or one
           KV split dropped, must fall outside it;
  serve    gemma3-1b at full width, bf16, random weights from --seed, 16
           requests of the "github" trace served by the continuous-batching
           engine (n_items=4, cap_t=512, page_sz=16, k=1); every request
           must complete, the split pass must launch 26 times per engine
           step, the merge pass at least once, and the plain attention
           never;
  verify   the same engine in float32 on the first 2 requests (8 new
           tokens) against the port's one_shot_generate;
  kernels  every kernel of the port with its launch count in ``serve``.

The last two lines are the kernels JSON and the device JSON.
"""

from __future__ import annotations

import argparse
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


def _ptxas_summary(log: str):
    """One line per compiled kernel: name, dtype, head dim, registers,
    shared memory, stack and spills (from ``nvcc -Xptxas -v``)."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kind = "combine" if "combine" in ln else "fwd"
            dt = "bf16" if "bfloat16" in ln else "f32"
            m = re.search(r"Li(\d+)E", ln)
            name = f"{kind}<{dt},{m.group(1) if m else '?'}>"
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
        from repro_torch.kernels.flash_attention import load_library
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
    lib, dt = run("build", load_library)
    for ln in _ptxas_summary(lib.build_log):
        print(f"[build] {ln}")
    print(f"[build] ok sm_90a {lib.path.name} in {dt:.1f}s; card: {smi}",
          flush=True)

    (cases, merges), dt = run("kernel", lambda: phase_kernel(dev))
    for rec in cases:
        print(f"[kernel] {json.dumps(rec)}", flush=True)
    for rec in merges:
        print(f"[kernel] merge pass {json.dumps(rec)}", flush=True)

    cfg = get_arch("gemma3-1b")
    trace = sample_request_trace("github", 16, 4096, cfg.spec.vocab,
                                 seed=0, max_new_tokens=32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params32 = DecoderLM(cfg).init(gen, dtype=torch.float32, device=dev)
    srv, dt = run("serve", lambda: phase_serve(dev, cfg, params32, trace))
    print(f"[serve] {json.dumps(srv)} in {dt:.1f}s", flush=True)

    lines, dt = run("verify", lambda: phase_verify(dev, cfg, params32,
                                                   trace))
    print(f"[verify] ok in {dt:.1f}s: " + "; ".join(lines), flush=True)

    print(f"[kernels] flash_fwd_kernel: {srv['flash_launches']} launches "
          f"in serve ({cfg.spec.n_layers} x {srv['steps']} steps); "
          f"flash_combine_kernel: {srv['combine_launches']} launches; "
          f"total {time.perf_counter() - t_start:.1f}s", flush=True)
    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    tpu = "src/repro/kernels/flash_attention.py:89"
    g, m = cases[0], merges[0]          # gemma3-1b global layer, bf16
    kernels = {"kernels": [
        {"name": "flash_fwd_kernel", "route": "cuda", "source": src,
         "replaces": tpu, "launches": srv["flash_launches"],
         "max_abs_err": g["max_abs_err"], "ms": g["kernel_ms"],
         "ms_covers": "the attention op: split pass and merge pass",
         "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": g["bound_by"], "library_ms": g["library_ms"]},
        {"name": "flash_combine_kernel", "route": "cuda", "source": src,
         "replaces": tpu, "launches": srv["combine_launches"],
         "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
         "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "bound_by": m["bound_by"], "library_ms": None}]}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
