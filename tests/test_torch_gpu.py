"""The port on the card: the CUDA kernels against their plain versions
(flash attention forward, its log-sum-exp, backward and tile ranges, at
equal key and value widths from 16 to 256 and at MLA's q/k 192, v 128;
cross-entropy B, C1, C2; the selective scan D and its gradient D', ungated
and with the mamba mixer's prologue and gate), the engine on CUDA against
the engine on the CPU, and one reduced training step on CUDA against the
same step on the CPU (dense, hybrid and mamba families, and the
encoder-decoder's pipelined step after its non-causal and cross
attention).

Every test here is marked ``gpu`` and skips without a CUDA card. This
file imports torch only (no jax), so it runs where the card is:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 ``2e-5`` (that of the JAX package's kernel tests;
the kernel sums in another order than the plain version) and, for bf16,
a few units of the output's last place: ``atol 4e-3 + rtol 1e-2``.
Gradients and cross-entropy outputs are held to the same relative limits
with ``atol`` scaled by the largest magnitude of the plain result (they
are sums of many terms of both signs, so their size varies by case).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=4e-3)}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _packed(rng, T, n_seq, ctx):
    cuts = np.sort(rng.choice(np.arange(1, T), n_seq - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [T]])
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    for s in range(n_seq):
        a, b = bounds[s], bounds[s + 1]
        seg[a:b] = s
        pos[a:b] = np.arange(b - a) + (ctx if s == 0 else 0)
    return seg, pos


@pytest.mark.gpu
@pytest.mark.parametrize("C", [150, 4000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Dh,window", [
    (4, 1, 256, 512),       # gemma3-1b local layer
    (4, 1, 256, 0),         # gemma3-1b global layer
    (24, 8, 128, 0),        # llama3.2-3b
    (8, 2, 64, 16),
    (32, 8, 160, 0),        # stablelm-12b
    (4, 2, 32, 8),          # fig11's reduced heads, a window
    (4, 2, 16, 0),          # fig13's and --reduced's
])
def test_kernel_matches_plain(dtype, Hq, Hkv, Dh, window, C):
    """``C`` context rows of segment 0, then a 300-row chunk: float32 at
    C=150 one block walks all KV tiles of its query tile, at C=4000 they
    are split over blocks and merged (``kv_splits``); bf16 splits both (a
    grid of 5 query tiles x Hq heads does not fill the card)."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import (FWD_KERNELS,
                                                     flash_attention_cuda,
                                                     flash_combine_cuda,
                                                     kv_splits)
    rng = np.random.default_rng(Hq * Dh + window + C)
    T = 300
    seg_q, pos_q = _packed(rng, T, 3, ctx=C)
    seg_q[-5:] = -1                  # padding rows -> exact zeros
    seg_kv = np.concatenate([np.zeros(C, np.int32), seg_q])
    pos_kv = np.concatenate([np.arange(C, dtype=np.int32), pos_q])

    def mk(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev, dtype)
    q, k, v = mk(T, Hq, Dh), mk(C + T, Hkv, Dh), mk(C + T, Hkv, Dh)
    meta = [torch.from_numpy(a).to(dev) for a in
            (seg_q, seg_kv, pos_q, pos_kv)]
    S = -(-(C + T) // 32) * 32       # rows after ops pads the keys
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split = kv_splits(320, S, Hq, n_sm, dtype) > 1
    assert split == (C > 400 or dtype == torch.bfloat16)
    kernel = FWD_KERNELS[dtype]
    before = (flash_attention_cuda.launches, flash_combine_cuda.launches,
              flash_attention_cuda.by_kernel[kernel])
    got = ops.flash_attention(q, k, v, *meta, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before[0] + 1
    assert flash_combine_cuda.launches == before[1] + split
    assert flash_attention_cuda.by_kernel[kernel] == before[2] + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_reference(q, k, v, *meta, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    assert torch.count_nonzero(got[-5:]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [2, 16])
def test_combine_matches_plain(dtype, n_split):
    """The merge pass alone, on the split pass's own partial states,
    against ``ref.combine_partials``; merging them gives the attention."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_combine_cuda)
    rng = np.random.default_rng(n_split)
    T, C, Hq, Hkv, Dh = 96, 1500, 4, 1, 256
    seg_q, pos_q = _packed(rng, T, 3, ctx=C)
    seg_q[-5:] = -1
    seg_kv = np.concatenate([np.zeros(C, np.int32), seg_q])
    pos_kv = np.concatenate([np.arange(C, dtype=np.int32), pos_q])

    def mk(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev, dtype)
    q, k, v = mk(T, Hq, Dh), mk(C + T, Hkv, Dh), mk(C + T, Hkv, Dh)
    args = ops.pad_for_kernel(q, k, v, *[torch.from_numpy(a).to(dev) for a
                                         in (seg_q, seg_kv, pos_q, pos_kv)])
    ws_ml, ws_acc = flash_attention_cuda.partials(
        *args, n_split=n_split, tiles=ops._fwd_tiles(args, True, 0))
    got = flash_combine_cuda(ws_ml, ws_acc, dtype)
    want = ref.combine_partials(ws_ml, ws_acc, dtype)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    full = ref.flash_attention_reference(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               full.float().cpu().numpy(), **TOL[dtype])
    assert torch.count_nonzero(got[T - 5:]) == 0


# (Hq, Hkv, Dh, window, C): the bf16 forward at Dh 16 to 256, GQA groups
# 1, 2, 4 and 5, windows 0, 8 and 512, with and without context rows; split
# (n_split 3, 16), the merge pass runs at each value width
FWD_CASES = [
    (4, 1, 256, 512, 720),      # gemma3-1b local layer
    (4, 1, 256, 0, 720),        # gemma3-1b global layer
    (25, 5, 64, 0, 0),          # hymba-1.5b, no context
    (24, 8, 128, 0, 150),       # llama3.2-3b
    (4, 4, 128, 512, 0),        # group 1, a window, no context
    (8, 2, 64, 16, 24),
    (32, 8, 160, 0, 720),       # stablelm-12b
    (4, 2, 32, 8, 150),         # fig11's reduced heads, a window
    (4, 2, 16, 0, 0),           # fig13's and --reduced's, no context
]


def _fwd_mma(q, k, v, meta, window, n_split, with_lse=True):
    """The bf16 forward as the op runs it, at ``n_split`` KV splits
    (n_split 1: written directly; else the split pass and the merge)."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_combine_cuda)
    padded = ops.pad_for_kernel(q, k, v, *meta)
    tiles = ops._fwd_tiles(padded, True, window)
    if n_split == 1:
        T = padded[0].shape[0]
        out = padded[0].new_empty((*padded[0].shape[:2],
                                   padded[2].shape[2]))
        lse = torch.empty((q.shape[1], T), dtype=torch.float32,
                          device=q.device)
        flash_attention_cuda._launch(*padded, out, None, None, lse, 1, True,
                                     window, None, tiles)
        return padded, out, lse
    ws_ml, ws_acc = flash_attention_cuda.partials(
        *padded, n_split=n_split, window=window, tiles=tiles)
    lse = torch.empty((q.shape[1], ws_ml.shape[1]), dtype=torch.float32,
                      device=q.device)
    return padded, flash_combine_cuda(ws_ml, ws_acc, q.dtype, lse=lse), lse


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [1, 3, 16])
@pytest.mark.parametrize("Hq,Hkv,Dh,window,C", FWD_CASES)
def test_fwd_mma_matches_plain(Hq, Hkv, Dh, window, C, n_split):
    """``flash_fwd_mma_kernel`` (bf16, tensor cores) on a training chunk
    (``_bwd_chunk``: T = 333 rows padded to 352, S = C + 40 + 333, neither
    a multiple of its 64-row tiles; stale and padding rows) unsplit and
    split into 3 and 16 pieces of each query tile's range, against the
    plain output and lse; padding rows are exact zeros with lse -inf; two
    more launches give the same bits."""
    dev = _cuda()
    dtype = torch.bfloat16
    rng = np.random.default_rng(Hq + Dh + window + C + n_split)
    q, k, v, _, meta = _bwd_chunk(rng, dev, dtype, Hq, Hkv, Dh, C)
    padded, out, lse = _fwd_mma(q, k, v, meta, window, n_split)
    T = q.shape[0]
    want = ref.flash_attention_reference(q, k, v, *meta, window=window)
    np.testing.assert_allclose(out[:T].float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    assert torch.count_nonzero(out[T - 5:]) == 0
    want_lse = ref.flash_attention_lse(*padded[:2], *padded[3:],
                                       window=window)
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    _close(lse[live], want_lse[live], torch.float32)
    again = [_fwd_mma(q, k, v, meta, window, n_split)[1:] for _ in range(2)]
    torch.cuda.synchronize()
    for o2, l2 in again:
        assert torch.equal(o2, out) and torch.equal(l2, lse)


@pytest.mark.gpu
def test_fwd_mma_needs_the_tile_ranges():
    """The bf16 forward raises without the tile ranges, or with ranges of
    another tile size."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    seg = torch.zeros(64, dtype=torch.int32, device=dev)
    q = torch.zeros((64, 4, 64), device=dev, dtype=torch.bfloat16)
    kv = torch.zeros((64, 1, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tiles"):
        flash_attention_cuda(q, kv, kv, seg, seg, seg, seg)
    tiles = ops.bwd_tiles(seg, seg, seg, seg, block=32)
    with pytest.raises(ValueError, match="tiles"):
        flash_attention_cuda(q, kv, kv, seg, seg, seg, seg, tiles=tiles)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    seg = torch.zeros(32, dtype=torch.int32, device=dev)
    q = torch.zeros((32, 4, 96), device=dev)          # head_dim 96
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q[:, :1], q[:, :1], seg, seg, seg, seg)
    q = torch.zeros((32, 3, 64), device=dev)          # Hq % Hkv != 0
    k = torch.zeros((32, 2, 64), device=dev)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, k, seg, seg, seg, seg)
    q = torch.zeros((32, 4, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):                   # dtype
        flash_attention_cuda(q, q[:, :1], q[:, :1], seg, seg, seg, seg)
    with pytest.raises(ValueError):                   # CPU tensors
        flash_attention_cuda(*(t.cpu() for t in (q, q, q, seg, seg, seg,
                                                 seg)))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-1b", "llama3.2-3b"])
def test_engine_on_card_matches_cpu(arch):
    """Same float32 weights, same trace: the engine on the card (through
    the kernel) emits the CPU engine's ids (through the plain version)."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_map
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    cfg = get_arch(arch).reduced(n_layers=6, head_dim=64)
    params = DecoderLM(cfg).init(torch.Generator().manual_seed(1),
                                 device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.spec.vocab, int(n)).astype(np.int32)
               for n in rng.integers(3, 60, 6)]
    econf = EngineConfig(n_items=4, cap_t=16, n_pages=64, page_sz=8,
                         pages_per_seq=10, k=2)
    ids = {}
    for d in ("cpu", dev):
        eng = ServeEngine(cfg, econf, device=d,
                          params=tree_map(lambda a: a.to(d), params))
        res = eng.run([Request(req_id=i, prompt=p, max_new_tokens=6,
                               arrival=0.5 * i)
                       for i, p in enumerate(prompts)])
        ids[str(d)] = {r: res[r].output_ids for r in res}
        if d is dev:
            assert flash_attention_cuda.launches > 0
    assert ids["cpu"] == ids[str(dev)]


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_mesh_engine_on_card_matches_cpu(mesh):
    """The engine on a ``(d_p, d_s)`` mesh of the card: every rank of every
    layer slot launches kernel A once a step, and the ids equal the CPU
    mesh engine's (the plain versions)."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_map
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    cfg = get_arch("gemma3-1b").reduced(n_layers=6, head_dim=64)
    params = DecoderLM(cfg).init(torch.Generator().manual_seed(1),
                                 device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.spec.vocab, int(n)).astype(np.int32)
               for n in rng.integers(3, 60, 6)]
    econf = EngineConfig(n_items=4, cap_t=16, n_pages=64, page_sz=8,
                         pages_per_seq=10, k=1)
    ids = {}
    for d in ("cpu", dev):
        eng = ServeEngine(cfg, econf, device=d, d_p=mesh[0], d_s=mesh[1],
                          params=tree_map(lambda a: a.to(d), params))
        before = flash_attention_cuda.launches
        res = eng.run([Request(req_id=i, prompt=p, max_new_tokens=6,
                               arrival=0.5 * i)
                       for i, p in enumerate(prompts)])
        ids[str(d)] = {r: res[r].output_ids for r in res}
        if d is dev:
            assert flash_attention_cuda.launches - before == \
                cfg.spec.n_layers * mesh[1] * eng.step_count
    assert ids["cpu"] == ids[str(dev)]


def _close(got, want, dtype):
    """Within TOL[dtype], atol scaled by max |want|; returns the error."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    tol = TOL[dtype]
    scale = float(want.abs().max()) or 1.0
    err = (got - want).abs()
    lim = tol["atol"] * scale + tol["rtol"] * want.abs()
    assert bool((err <= lim).all()), (float(err.max()), scale)
    return float(err.max())


def _bwd_chunk(rng, dev, dtype, Hq, Hkv, Dh, C, T=333, stale=40, Dv=None):
    """A training chunk with context rows: ``C`` valid context rows of
    segment 0, ``stale`` carry rows beyond ``ctx_len`` (seg -1), then a
    packed chunk of ``T`` rows in 3 sequences whose last 5 rows are
    padding. Returns q, k, v, dout and the metadata, on ``dev``; q and k
    are ``Dh`` wide, v and dout ``Dv`` (default ``Dh``)."""
    Dv = Dv or Dh
    seg_q, pos_q = _packed(rng, T, 3, ctx=C)
    seg_q[-5:] = -1
    seg_kv = np.concatenate([np.zeros(C, np.int32),
                             np.full(stale, -1, np.int32), seg_q])
    pos_kv = np.concatenate([np.arange(C + stale, dtype=np.int32), pos_q])

    def mk(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev, dtype)
    S = C + stale + T
    q, k, v = mk(T, Hq, Dh), mk(S, Hkv, Dh), mk(S, Hkv, Dv)
    meta = [torch.from_numpy(a).to(dev) for a in
            (seg_q, seg_kv, pos_q, pos_kv)]
    return q, k, v, mk(T, Hq, Dv), meta


# (Hq, Hkv, Dh, window, C): GQA groups 1, 3, 4 and 5 at Dh 64, 128 and 256;
# T = 333 and S = C + 40 + 333 rows, padded to 352 and to 1120 or 416: not
# multiples of the bf16 passes' 64-row tiles
BWD_CASES = [
    (4, 1, 256, 512, 720),      # gemma3-1b local layer
    (4, 1, 256, 0, 720),        # gemma3-1b global layer
    (24, 8, 128, 0, 720),       # llama3.2-3b
    (25, 5, 64, 0, 720),        # hymba-1.5b
    (8, 2, 64, 16, 24),
    (4, 4, 128, 37, 24),        # group 1, a window
    (32, 8, 160, 0, 720),       # stablelm-12b
    (4, 2, 32, 0, 150),         # fig11's reduced heads
    (4, 2, 16, 12, 150),        # fig13's and --reduced's, a window
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Dh,window,C", BWD_CASES)
def test_attention_backward_matches_plain(dtype, Hq, Hkv, Dh, window, C):
    """The op's forward (kernel A with lse) and backward (dq pass, then
    dk/dv pass) on a training chunk with context rows (``_bwd_chunk``)
    against the plain versions; stale and padding rows get exact zero
    gradients."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda,
                                                     flash_bwd_tiles_cuda)
    rng = np.random.default_rng(Hq + Dh + window + C)
    stale = 40
    q, k, v, dout, meta = _bwd_chunk(rng, dev, dtype, Hq, Hkv, Dh, C,
                                     stale=stale)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    wrappers = (flash_attention_cuda, flash_bwd_dkdv_cuda, flash_bwd_dq_cuda,
                flash_bwd_tiles_cuda)
    before = [w.launches for w in wrappers]
    out = ops.flash_attention(qq, kk, vv, *meta, window=window)
    out.backward(dout)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    want = ref.flash_attention_reference(q, k, v, *meta, window=window)
    _close(out, want, dtype)
    grads = ref.flash_attention_grad(q.float(), k.float(), v.float(), *meta,
                                     dout.float(), window=window)
    for got, w in zip((qq.grad, kk.grad, vv.grad), grads):
        assert got.dtype == dtype
        _close(got, w, dtype)
    for g in (kk.grad, vv.grad):
        assert torch.count_nonzero(g[C:C + stale]) == 0
    assert torch.count_nonzero(qq.grad[-5:]) == 0
    padded = ops.pad_for_kernel(q, k, v, *meta)
    _, lse = flash_attention_cuda(*padded, window=window, with_lse=True,
                                  tiles=ops._fwd_tiles(padded, True, window))
    want_lse = ref.flash_attention_lse(*padded[:2], *padded[3:],
                                       window=window)
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    _close(lse[live], want_lse[live], torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Dh,window,C", [BWD_CASES[1], BWD_CASES[3],
                                                BWD_CASES[4]])
def test_attention_backward_is_deterministic(dtype, Hq, Hkv, Dh, window, C):
    """Two launches of each backward pass give the same bits, and the tile
    ranges and summaries of ``flash_bwd_tiles_kernel`` equal the plain
    version's on the CPU."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import (BWD_BLOCK,
                                                     flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda)
    rng = np.random.default_rng(7 + Dh + C)
    q, k, v, dout, meta = _bwd_chunk(rng, dev, dtype, Hq, Hkv, Dh, C)
    padded = ops.pad_for_kernel(q, k, v, *meta)
    out, lse = flash_attention_cuda(*padded, window=window, with_lse=True,
                                    tiles=ops._fwd_tiles(padded, True, window))
    do = ops.pad_rows(dout, 32).contiguous()
    pm = padded[3:]
    tiles = ops.bwd_tiles(*pm, window=window, block=BWD_BLOCK[dtype])
    on_cpu = ops.bwd_tiles(*(t.cpu() for t in pm), window=window,
                           block=BWD_BLOCK[dtype])
    for name in ("kv_range", "q_range", "q_summary", "kv_summary"):
        assert torch.equal(getattr(tiles, name).cpu(), getattr(on_cpu, name))
    runs = []
    for _ in range(2):
        delta = torch.empty_like(lse)
        dq = flash_bwd_dq_cuda(*padded[:3], out, do, lse, *pm, window=window,
                               delta=delta, tiles=tiles)
        dk, dv = flash_bwd_dkdv_cuda(*padded[:3], out, do, lse, *pm,
                                     window=window, delta=delta, tiles=tiles)
        runs.append((dq, dk, dv, delta))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# deepseek-v2-lite's MLA attention as kernel A sees it: 16 query heads,
# each its own KV head after the latent expansion, keys 192 wide (128 +
# 64 rope channels), values 128; a carry of 720 rows in front
MLA = dict(Hq=16, Hkv=16, Dh=192, Dv=128, window=0, C=720)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_attention_matches_plain(dtype):
    """At key width 192 and value width 128 (``flash_*_kernel<192, 128>``,
    nothing padded to a wider head): the op's forward, its lse and both
    backward passes against the plain versions; stale and padding rows get
    exact zero gradients; two more launches of each pass give the same
    bits."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import (BWD_BLOCK,
                                                     flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda)
    m = MLA
    rng = np.random.default_rng(192)
    stale = 40
    q, k, v, dout, meta = _bwd_chunk(rng, dev, dtype, m["Hq"], m["Hkv"],
                                     m["Dh"], m["C"], stale=stale, Dv=m["Dv"])
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    scale = m["Dh"] ** -0.5
    out = ops.flash_attention(qq, kk, vv, *meta, scale=scale)
    out.backward(dout)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (q.shape[0], m["Hq"], m["Dv"])
    _close(out, ref.flash_attention_reference(q, k, v, *meta, scale=scale),
           dtype)
    grads = ref.flash_attention_grad(q.float(), k.float(), v.float(), *meta,
                                     dout.float(), scale=scale)
    for got, w in zip((qq.grad, kk.grad, vv.grad), grads):
        assert got.dtype == dtype and got.shape == w.shape
        _close(got, w, dtype)
    for g in (kk.grad, vv.grad):
        assert torch.count_nonzero(g[m["C"]:m["C"] + stale]) == 0
    assert torch.count_nonzero(qq.grad[-5:]) == 0
    padded = ops.pad_for_kernel(q, k, v, *meta)
    out, lse = flash_attention_cuda(*padded, scale=scale, with_lse=True,
                                    tiles=ops._fwd_tiles(padded, True, 0))
    want_lse = ref.flash_attention_lse(*padded[:2], *padded[3:], scale=scale)
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    _close(lse[live], want_lse[live], torch.float32)
    do = ops.pad_rows(dout, 32).contiguous()
    pm = padded[3:]
    tiles = ops.bwd_tiles(*pm, block=BWD_BLOCK[dtype])
    runs = []
    for _ in range(2):
        delta = torch.empty_like(lse)
        dq = flash_bwd_dq_cuda(*padded[:3], out, do, lse, *pm, scale=scale,
                               delta=delta, tiles=tiles)
        dk, dv = flash_bwd_dkdv_cuda(*padded[:3], out, do, lse, *pm,
                                     scale=scale, delta=delta, tiles=tiles)
        runs.append((dq, dk, dv, delta))
    torch.cuda.synchronize()
    assert runs[0][2].shape[-1] == m["Dv"] and runs[0][1].shape[-1] == m["Dh"]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [1, 3, 16])
def test_mla_fwd_mma_matches_plain(n_split):
    """``flash_fwd_mma_kernel<192, 128>`` unsplit and split into 3 and 16
    pieces of each query tile's range (the split workspace and the merge
    pass 128 wide), against the plain output and lse; two more launches
    give the same bits."""
    dev = _cuda()
    m = MLA
    rng = np.random.default_rng(128 + n_split)
    q, k, v, _, meta = _bwd_chunk(rng, dev, torch.bfloat16, m["Hq"],
                                  m["Hkv"], m["Dh"], m["C"], Dv=m["Dv"])
    padded, out, lse = _fwd_mma(q, k, v, meta, 0, n_split)
    T = q.shape[0]
    want = ref.flash_attention_reference(q, k, v, *meta)
    _close(out[:T], want, torch.bfloat16)
    assert torch.count_nonzero(out[T - 5:]) == 0
    want_lse = ref.flash_attention_lse(*padded[:2], *padded[3:])
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    _close(lse[live], want_lse[live], torch.float32)
    again = [_fwd_mma(q, k, v, meta, 0, n_split)[1:] for _ in range(2)]
    torch.cuda.synchronize()
    for o2, l2 in again:
        assert torch.equal(o2, out) and torch.equal(l2, lse)


@pytest.mark.gpu
def test_kernel_rejects_width_pairs_it_lacks():
    """Only the instantiated (key, value) widths launch: (192, 192),
    (128, 192) and (192, 64) raise, with nothing padded."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    seg = torch.zeros(32, dtype=torch.int32, device=dev)
    for dk, dv in ((192, 192), (128, 192), (192, 64)):
        q = torch.zeros((32, 2, dk), device=dev)
        v = torch.zeros((32, 2, dv), device=dev)
        with pytest.raises(ValueError, match="widths"):
            flash_attention_cuda(q, q, v, seg, seg, seg, seg)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,V", [(64, 64, 1000), (256, 128, 517),
                                   (640, 1152, 4099), (128, 3072, 1000),
                                   (192, 1600, 32001), (320, 1152, 262144),
                                   (128, 2560, 1000), (192, 3584, 1000),
                                   (64, 5120, 1100)])
def test_cross_entropy_kernels_match_plain(dtype, T, D, V):
    """B (lse, target logit), C1 (dh) and C2 (dW) against their plain
    versions: short chunks (vocab split over blocks and merged), a vocab
    that is not a multiple of the tile, D sliced (3072 -> 3 slices; bf16 C1:
    a cluster of 8; qwen3-4b's 2,560, qwen2-vl-7b's 3,584 and stablelm-12b's
    5,120: clusters of 7, 10 and 14, a last slice of 256, 128 and 128
    columns), hymba-1.5b's head (D 1600, V 32001), T not a multiple
    of bf16 B's 128-token tile (64, 192, 320), targets outside the
    vocabulary and rows with g = 0; then all-zero g (dh and dW exactly 0)
    and a second launch of each kernel (the same bits)."""
    dev = _cuda()
    from repro_torch.kernels.cross_entropy import (ce_bwd_dh_cuda,
                                                   ce_bwd_dw_cuda,
                                                   ce_fwd_cuda)
    rng = np.random.default_rng(T + D + V)

    def mk(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(
            np.float32)).to(dev, dtype)
    h, w = mk(T, D), mk(V, D, scale=D ** -0.5)
    tgt = torch.from_numpy(rng.integers(0, V, T).astype(np.int32)).to(dev)
    tgt[::7] = -1
    tgt[1] = V - 1
    tgt[2] = V + 5
    g = torch.from_numpy(rng.uniform(0.5, 1.5, T).astype(np.float32)).to(dev)
    g[::5] = 0.0
    lse, tl = ce_fwd_cuda(h, w, tgt)
    want_lse, want_tl = ref.cross_entropy_fwd_plain(h, w, tgt)
    _close(lse, want_lse, torch.float32)
    _close(tl, want_tl, torch.float32)
    dh = ce_bwd_dh_cuda(h, w, tgt, want_lse, g)
    dw = ce_bwd_dw_cuda(h, w, tgt, want_lse, g)
    assert dh.dtype == dtype and dw.dtype == dtype
    _close(dh, ref.cross_entropy_bwd_dh_plain(h, w, tgt, want_lse, g), dtype)
    _close(dw, ref.cross_entropy_bwd_dw_plain(h, w, tgt, want_lse, g), dtype)
    zero = torch.zeros_like(g)
    assert not ce_bwd_dh_cuda(h, w, tgt, want_lse, zero).any()
    assert not ce_bwd_dw_cuda(h, w, tgt, want_lse, zero).any()
    lse2, tl2 = ce_fwd_cuda(h, w, tgt)
    dh2 = ce_bwd_dh_cuda(h, w, tgt, want_lse, g)
    dw2 = ce_bwd_dw_cuda(h, w, tgt, want_lse, g)
    torch.cuda.synchronize()
    for a, b in ((lse, lse2), (tl, tl2), (dh, dh2), (dw, dw2)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["dh", "dw"])
def test_cross_entropy_bf16_backward_takes_d_up_to_6144(which):
    """bf16 C1 and C2 run one cluster of at most 16 CTAs of at most 384
    columns: D = 6,144 runs (against the plain version), D = 6,656 raises
    with a message."""
    dev = _cuda()
    from repro_torch.kernels.cross_entropy import CrossEntropyKernel
    kern = CrossEntropyKernel(which)
    rng = np.random.default_rng(6144)
    plain = (ref.cross_entropy_bwd_dh_plain if which == "dh"
             else ref.cross_entropy_bwd_dw_plain)
    for D in (6144, 6656):
        h = torch.from_numpy(rng.standard_normal((64, D)).astype(
            np.float32)).to(dev, torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((200, D)) * D ** -0.5)
                             .astype(np.float32)).to(dev, torch.bfloat16)
        tgt = torch.from_numpy(rng.integers(0, 200, 64).astype(
            np.int32)).to(dev)
        g = torch.full((64,), 1 / 64, device=dev)
        lse, _ = ref.cross_entropy_fwd_plain(h, w, tgt)
        if D > 6144:
            with pytest.raises(ValueError, match="6144"):
                kern(h, w, tgt, lse, g)
            continue
        _close(kern(h, w, tgt, lse, g), plain(h, w, tgt, lse, g),
               torch.bfloat16)


@pytest.mark.gpu
def test_cross_entropy_clusters_fit_the_card():
    """bf16 C1's and C2's clusters launch at every head of the registry (a
    cluster of up to 16 CTAs, one an SM): the card holds at least one at
    once (``cudaOccupancyMaxActiveClusters``), and more of narrower ones."""
    _cuda()
    from repro_torch.configs import arch_names, get_arch
    from repro_torch.kernels.cross_entropy import max_active_clusters
    for which in ("dh", "dw"):
        n = {D: max_active_clusters(which, D) for D in
             sorted({get_arch(a).spec.d_model for a in arch_names()}
                    | {6144})}
        assert all(v >= 1 for v in n.values()), (which, n)
        assert n[1152] >= n[3072] >= n[5120] >= n[6144], (which, n)


@pytest.mark.gpu
def test_fused_cross_entropy_gradients_on_card():
    """The autograd function on the card against autograd of the plain
    loss, with padding of T to the kernels' multiple."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    T, D, V = 100, 64, 300
    h = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((V, D)) * 0.2).astype(
        np.float32))
    tgt = torch.from_numpy(rng.integers(0, V, T))
    valid = torch.from_numpy(np.arange(T) % 3 != 1)
    out = {}
    for d in ("cpu", dev):
        hh, ww = (t.detach().to(d).requires_grad_(True) for t in (h, w))
        s, n = ops.fused_cross_entropy(hh, ww, tgt.to(d), valid.to(d))
        (s / n).backward()
        out[str(d)] = (s.item(), hh.grad.cpu(), ww.grad.cpu())
    a, b = out["cpu"], out[str(dev)]
    assert abs(a[0] - b[0]) <= 1e-5 * abs(a[0])
    _close(b[1], a[1], torch.float32)
    _close(b[2], a[2], torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-1b", "llama3.2-3b"])
def test_train_step_on_card_matches_cpu(arch):
    """One reduced float32 chunked step (a sequence split over 3 chunks
    with the KV carry and its dKV hand-off, packed chunks, the planner's
    non-zero remat table) on the card, through the kernels, against the
    same step on the CPU through the plain versions: loss ``rtol 1e-5``,
    gradients within ``2e-5`` scaled by each leaf's largest value."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.kernels.cross_entropy import ce_fwd_cuda
    from repro_torch.kernels.flash_attention import flash_bwd_dq_cuda
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.train_step import ChunkedTrainer
    cfg = get_arch(arch).reduced(n_layers=4, d_model=128, n_heads=4,
                                 head_dim=64, vocab=512)
    rng = np.random.default_rng(2)
    lens = [400] + [int(x) for x in rng.integers(30, 150, 5)]
    corpus = {i: rng.integers(0, 512, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec())
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        capacity_bytes=cm.m_model_states(1) + 4e6))
    assert max(s.n_chunks for s in plan.sequences) >= 3
    params = DecoderLM(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    res = {}
    for d in ("cpu", dev):
        before = (flash_bwd_dq_cuda.launches, ce_fwd_cuda.launches,
                  ops.flash_attention.plain_calls,
                  ops.fused_cross_entropy.plain_calls)
        tr = ChunkedTrainer(cfg, params, device=d,
                            compute_dtype=torch.float32)
        res[str(d)] = tr.loss_and_grads(plan, corpus)
        if d is dev:
            torch.cuda.synchronize()
            after = (flash_bwd_dq_cuda.launches, ce_fwd_cuda.launches,
                     ops.flash_attention.plain_calls,
                     ops.fused_cross_entropy.plain_calls)
            assert after[0] > before[0] and after[1] > before[1]
            assert after[2:] == before[2:]
    a, b = res["cpu"], res[str(dev)]
    assert a.n_valid == b.n_valid
    assert abs(a.loss - b.loss) <= 1e-5 * abs(a.loss)
    for x, y in zip(tree_leaves(b.grads), tree_leaves(a.grads)):
        _close(x, y, torch.float32)


def _scan_case(T, DI, DS, dtypes, dev, seed):
    """Selective-scan inputs on ``dev``: delta (with B, C) and xs in the
    ``dtypes`` pair, resets at a few rows and on both sides of every tile
    edge (rows 63, 64, 127, ...), but not row 0 (so the carried h0 counts),
    non-zero h0."""
    g = torch.Generator().manual_seed(seed)
    td, tx = dtypes
    delta = torch.nn.functional.softplus(torch.randn((T, DI), generator=g))
    xs = torch.randn((T, DI), generator=g)
    B = torch.randn((T, DS), generator=g)
    C = torch.randn((T, DS), generator=g)
    A = -torch.exp(torch.randn((DI, DS), generator=g) * 0.3)
    reset = (torch.rand(T, generator=g) < 0.05).to(torch.int32)
    reset[63::64] = 1
    reset[64::64] = 1
    reset[0] = 0
    h0 = torch.randn((DI, DS), generator=g)
    return (delta.to(dev, td), xs.to(dev, tx), B.to(dev, td), C.to(dev, td),
            A.to(dev), reset.to(dev), h0.to(dev))


def _gated_case(T, DI, DS, dtype, dev, seed):
    """The gated scan's inputs on ``dev`` in ``dtype``: ``dt_pre`` around
    the mixer's softplus bias, B and C as row slices of one projection (as
    the mixer passes them), z a row slice, pad rows (live False) in the
    middle and at the end, resets as in :func:`_scan_case`."""
    g = torch.Generator().manual_seed(seed)
    _, xs, _, _, A, reset, h0 = _scan_case(T, DI, DS, (torch.float32,
                                                       dtype), dev, seed)
    proj = torch.randn((T, 3 + 2 * DS), generator=g).to(dev, dtype)
    xz = torch.randn((T, 2 * DI), generator=g).to(dev, dtype)
    dt_pre = (torch.randn((T, DI), generator=g) - 2.0).to(dev, dtype)
    live = torch.ones(T, dtype=torch.bool)
    live[T // 3:T // 3 + 5] = False
    live[-7:] = False
    live = live.to(dev)
    reset = (reset != 0) & live
    bias = torch.randn((DI,), generator=g).to(dev) * 0.5
    d_skip = torch.randn((DI,), generator=g).to(dev)
    return dict(dt_pre=dt_pre, xc=xs, B=proj[:, 3:3 + DS],
                C=proj[:, 3 + DS:], z=xz[:, DI:], dt_bias=bias, A=A,
                d_skip=d_skip, live=live, reset=reset, h0=h0)


def _launch_counts():
    from repro_torch.kernels.mamba_scan import (mamba_scan_bwd_cuda,
                                                mamba_scan_fwd_cuda)
    return {**mamba_scan_fwd_cuda.by_kernel, **mamba_scan_bwd_cuda.by_kernel,
            "plain": ops.mamba_scan.plain_calls}


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("T,DI,DS", [(100, 40, 4), (64, 16, 16),
                                     (300, 48, 16), (300, 40, 16),
                                     (257, 200, 16), (130, 3200, 16)])
def test_mamba_scan_kernels_match_plain(dtypes, T, DI, DS, gated):
    """D and D' against their plain versions on the same inputs, each
    kernel launched once (``by_kernel``) and no plain call: rows not a
    multiple of the 64-row tile (the ragged tile masked in the kernels,
    nothing padded by the caller), channels fewer than one block or with a
    partial last one (D's passes take 128 channels a block, D''s per-tile
    pass a group of 64: DI 16, 40, 48 and 200), resets on both sides of
    tile edges.

    Ungated (the two halves ``ops.mamba_scan_fwd`` and ``ops.mamba_scan_bwd``):
    y, h_last and every input's gradient, float32 delta,
    B and C beside float32 or bf16 xs; both sides compute in float32 from
    the same values, so every output is held to the float32 tolerance.
    Gated (``ops.mamba_scan_gated_fwd`` / ``_bwd``, every ``[T, *]`` input
    in xs's dtype, pad rows inside and at the end): outputs rounded to
    that dtype (out, d_pre, d_xc, dz) are held to its tolerance (bf16: a
    float32 difference can flip the last bit), the float32 ones (h_last,
    dB, dC, dA, d_bias, d_dskip, dh0) to the float32 tolerance."""
    dev = _cuda()
    f32 = torch.float32
    g = torch.Generator().manual_seed(1)
    dh = torch.randn((DI, DS), generator=g).to(dev)
    before = _launch_counts()
    if gated:
        dt = dtypes[1]
        case = _gated_case(T, DI, DS, dt, dev, T + DI + DS)
        dout = torch.randn((T, DI), generator=g).to(dev, dt)
        out, h, ckpt = ops.mamba_scan_gated_fwd(**case)
        grads = ops.mamba_scan_gated_bwd(**case, ckpt=ckpt, dout=dout,
                                         dh_last=dh)
        torch.cuda.synchronize()
        out_r, h_r = ref.mamba_scan_gated(**case)
        want = ref.mamba_scan_gated_grad(**case, dout=dout, dh_last=dh)
        _close(out, out_r, dt)
        _close(h, h_r, f32)
        for i, (got, w) in enumerate(zip(grads, want)):
            assert got.dtype == w.dtype, i
            _close(got, w, dt if i < 3 else f32)
    else:
        ins = _scan_case(T, DI, DS, dtypes, dev, seed=T + DI + DS)
        delta, xs, B, C, A, reset, h0 = ins
        dy = torch.randn((T, DI), generator=g).to(dev)
        y, h, ckpt = ops.mamba_scan_fwd(delta, xs, B, C, A, reset, h0)
        grads = ops.mamba_scan_bwd(delta, xs, B, C, A, reset, h0, ckpt, dy,
                                   dh)
        torch.cuda.synchronize()
        y_r, h_r = ref.mamba_scan_reference(delta, xs, B, C, A, reset, h0)
        _close(y, y_r, f32)
        _close(h, h_r, f32)
        _, *want = ref.mamba_scan_grad(delta, xs, B, C, A, reset, h0, dy, dh)
        for got, w in zip(grads, want):
            assert got.dtype == f32
            _close(got, w, f32)
    after = _launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        **{k: 1 for k in after}, "plain": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [False, True])
def test_mamba_scan_is_deterministic(gated):
    """D and D' launched twice on the same inputs give the same bits (no
    atomics; every sum in a fixed order), at a ragged hymba-width chunk."""
    dev = _cuda()
    T, DI, DS = 1000, 3200, 16
    g = torch.Generator().manual_seed(2)
    dh = torch.randn((DI, DS), generator=g).to(dev)
    runs = []
    for _ in range(2):
        if gated:
            case = _gated_case(T, DI, DS, torch.bfloat16, dev, 5)
            dout = torch.randn((T, DI), generator=torch.Generator(
            ).manual_seed(3)).to(dev, torch.bfloat16)
            out, h, ckpt = ops.mamba_scan_gated_fwd(**case)
            grads = ops.mamba_scan_gated_bwd(**case, ckpt=ckpt, dout=dout,
                                             dh_last=dh)
        else:
            delta, xs, B, C, A, reset, h0 = _scan_case(
                T, DI, DS, (torch.float32, torch.bfloat16), dev, 5)
            dy = torch.randn((T, DI), generator=torch.Generator(
            ).manual_seed(3)).to(dev)
            out, h, ckpt = ops.mamba_scan_fwd(delta, xs, B, C, A, reset, h0)
            grads = ops.mamba_scan_bwd(delta, xs, B, C, A, reset, h0, ckpt,
                                       dy, dh)
        runs.append([out, h, ckpt, *grads])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


_GUARD = 1024                # sentinel elements on either side of a buffer


def _rows_guarded(t, fill):
    """A copy of a ``[T, W]`` tensor as rows ``[64, 64 + T)`` and columns
    ``[0, W)`` of a ``[T + 128, W + 8]`` buffer of ``fill``."""
    T, W = t.shape
    buf = torch.full((T + 128, W + 8), fill, dtype=t.dtype, device=t.device)
    view = buf[64:64 + T, :W]
    view.copy_(t)
    return view


def _flat_guarded(t, fill):
    """A contiguous copy of ``t`` with ``_GUARD`` elements of ``fill`` on
    either side."""
    n = t.numel()
    buf = torch.full((n + 2 * _GUARD,), fill, dtype=t.dtype, device=t.device)
    view = buf[_GUARD:_GUARD + n].view(t.shape)
    view.copy_(t)
    return view


def _redirect(call, names):
    """Point the outputs and workspaces ``names`` of a prepared scan call
    into buffers with ``_GUARD`` sentinel elements on either side:
    ``{name: (tensor, buffer, sentinel)}``."""
    by_ptr = {t.data_ptr(): t for t in call.keep
              if isinstance(t, torch.Tensor)}
    out = {}
    for name in names:
        t = by_ptr[getattr(call.args, name)]
        fill = -7 if t.dtype == torch.int32 else 12345.0
        buf = torch.full((t.numel() + 2 * _GUARD,), fill, dtype=t.dtype,
                         device=t.device)
        view = buf[_GUARD:_GUARD + t.numel()].view(t.shape)
        setattr(call.args, name, view.data_ptr())
        out[name] = (view, buf, fill)
    call.keep += tuple(b for _, b, _ in out.values())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("T,DI,DS", [(100, 40, 4), (257, 200, 16)])
def test_mamba_scan_stays_inside_its_buffers(T, DI, DS, gated):
    """D and D' on a ragged T and DI write nothing outside their outputs
    and workspaces, and read nothing of their inputs beyond their rows and
    columns. Every output and workspace lies between ``_GUARD`` sentinel
    elements, which must be intact after the call; every input lies in a
    buffer of NaN (flags: True) around its rows and columns and, for a
    ``[T, *]`` input, after each row, so that a read past them would change
    a result. The results must equal the same call on plain tensors bit for
    bit (the sentinels also stand where a workspace is written before it is
    read)."""
    dev = _cuda()
    from repro_torch.kernels.mamba_scan import (Gate, mamba_scan_bwd_cuda,
                                                mamba_scan_fwd_cuda)
    g = torch.Generator().manual_seed(4)
    dh = torch.randn((DI, DS), generator=g).to(dev)
    if gated:
        dt = torch.bfloat16
        c = _gated_case(T, DI, DS, dt, dev, 7)
        ins = dict(pre=c["dt_pre"], xs=c["xc"], B=c["B"], C=c["C"], A=c["A"],
                   reset=c["reset"], h0=c["h0"], z=c["z"], bias=c["dt_bias"],
                   live=c["live"], d_skip=c["d_skip"])
        b_names = ("d_pre", "d_x", "dz", "dB", "dC", "dA", "d_bias",
                   "d_dskip", "dh0")
        work = ("uin", "dsum", "tile_reset", "ws_bc", "ws_da", "ws_ch")
    else:
        dt = torch.float32
        delta, xs, B, C, A, reset, h0 = _scan_case(
            T, DI, DS, (torch.float32, torch.bfloat16), dev, 7)
        ins = dict(pre=delta, xs=xs, B=B, C=C, A=A, reset=reset != 0, h0=h0)
        b_names = ("d_pre", "d_x", "dB", "dC", "dA", "dh0")
        work = ("uin", "dsum", "tile_reset", "ws_bc", "ws_da")
    ins["dout"] = torch.randn((T, DI), generator=g).to(dev, dt)
    ins["dh"] = dh
    f_names = ("out", "h_last", "ckpt")

    def run(a, guard):
        gate = Gate(bias=a["bias"], live=a["live"], z=a["z"],
                    d_skip=a["d_skip"]) if gated else None
        order = [a[k] for k in ("pre", "xs", "B", "C", "A", "reset")]
        fwd, f_out = mamba_scan_fwd_cuda.prepare(*order, a["h0"], gate=gate)
        fw = _redirect(fwd, f_names + ("dsum", "tile_reset")) if guard \
            else {}
        fwd.run()
        if guard:
            f_out = tuple(fw[n][0] for n in f_names)
        bwd, b_out = mamba_scan_bwd_cuda.prepare(*order, f_out[2], a["dout"],
                                                 a["dh"], gate=gate)
        bw = _redirect(bwd, b_names + work) if guard else {}
        bwd.run()
        if guard:
            b_out = tuple(bw[n][0] for n in b_names)
        torch.cuda.synchronize()
        return list(f_out) + list(b_out), {**{f"D {k}": v for k, v in
                                              fw.items()},
                                           **{f"D' {k}": v for k, v in
                                              bw.items()}}

    want, _ = run(ins, guard=False)
    rows = ("pre", "xs", "B", "C", "z", "dout")          # the [T, *] inputs
    boxed = {k: _rows_guarded(v, float("nan")) if k in rows else
             _flat_guarded(v, True if v.dtype == torch.bool else float("nan"))
             for k, v in ins.items()}
    got, guards = run(boxed, guard=True)
    for name, a, b in zip(f_names + b_names, got, want):
        assert torch.equal(a, b), name
    for name, (_, buf, fill) in guards.items():
        edge = torch.full((_GUARD,), fill, dtype=buf.dtype, device=buf.device)
        assert torch.equal(buf[:_GUARD], edge), f"{name}: written before it"
        assert torch.equal(buf[-_GUARD:], edge), f"{name}: written after it"


@pytest.mark.gpu
def test_mamba_scan_rejects_what_it_does_not_take():
    dev = _cuda()
    from repro_torch.kernels.mamba_scan import (Gate, mamba_scan_bwd_cuda,
                                                mamba_scan_fwd_cuda)
    delta, xs, B, C, A, reset, h0 = _scan_case(64, 32, 16, (
        torch.float32, torch.float32), dev, 0)
    reset = reset != 0
    with pytest.raises(ValueError):                   # DS = 32
        mamba_scan_fwd_cuda(delta, xs, B.repeat(1, 2), C.repeat(1, 2),
                            A.repeat(1, 2), reset, h0.repeat(1, 2))
    with pytest.raises(ValueError):                   # bf16 B, ungated
        mamba_scan_fwd_cuda(delta, xs, B.bfloat16(), C, A, reset, h0)
    with pytest.raises(ValueError):                   # bf16 delta, ungated
        mamba_scan_fwd_cuda(delta.bfloat16(), xs, B, C, A, reset, h0)
    with pytest.raises(ValueError):                   # int32 reset
        mamba_scan_fwd_cuda(delta, xs, B, C, A, reset.int(), h0)
    with pytest.raises(ValueError):                   # strided columns
        mamba_scan_fwd_cuda(delta, xs, B, C.T.contiguous().T, A, reset, h0)
    with pytest.raises(ValueError):                   # CPU tensors
        mamba_scan_fwd_cuda(*(t.cpu() for t in (delta, xs, B, C, A, reset,
                                                h0)))
    case = _gated_case(64, 32, 16, torch.bfloat16, dev, 0)
    gate = Gate(bias=case["dt_bias"], live=case["live"], z=case["z"],
                d_skip=case["d_skip"])
    args = [case[k] for k in ("dt_pre", "xc", "B", "C", "A", "reset")]
    out, _, ckpt = mamba_scan_fwd_cuda(*args, case["h0"], gate=gate)
    with pytest.raises(ValueError):                   # float32 dt_pre, gated
        mamba_scan_fwd_cuda(args[0].float(), *args[1:], case["h0"],
                            gate=gate)
    with pytest.raises(ValueError):                   # float32 z, bf16 xc
        mamba_scan_fwd_cuda(*args, case["h0"], gate=gate._replace(
            z=gate.z.float()))
    with pytest.raises(ValueError):                   # bf16 dt_bias
        mamba_scan_fwd_cuda(*args, case["h0"], gate=gate._replace(
            bias=gate.bias.bfloat16()))
    with pytest.raises(ValueError):                   # ckpt of 2 tiles
        mamba_scan_bwd_cuda(*args, ckpt.repeat(2, 1, 1), out, gate=gate)
    with pytest.raises(ValueError):                   # float32 dout, gated
        mamba_scan_bwd_cuda(*args, ckpt, out.float(), gate=gate)


@pytest.mark.gpu
def test_train_memory_snapshot_on_card(tmp_path, capsys):
    """``launch/train.py --memory-snapshot``: the last step's allocation
    history is written as a snapshot and its peak is summarised by site;
    the replayed peak lies above the recording's baseline and within 5% of
    the step's ``max_memory_allocated`` (the replay frees a block when its
    free completes), and blocks of the window are live there. The CLI's
    reduced falcon-mamba-7b (no attention: the snapshot holds the scan's
    and the head's blocks)."""
    import json
    import pickle

    from repro_torch.launch.train import main
    _cuda()
    path = tmp_path / "snap.pickle"
    assert main(["--arch", "falcon-mamba-7b", "--reduced", "--steps", "2",
                 "--batch", "2", "--context", "256", "--memory-snapshot",
                 str(path)]) == 0
    with open(path, "rb") as f:
        assert pickle.load(f)["device_traces"]
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[memory] "))
    summary = json.loads(line[len("[memory] "):])
    assert summary["events"] > 0 and summary["live_at_peak"]
    assert summary["baseline_gb"] < summary["peak_gb"] \
        <= 1.05 * summary["step_peak_gb"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-vl-7b"])
def test_reduced_config_trains_on_card(arch, dtype):
    """``launch/train.py --reduced`` on the card (4 layers, d_model 64, 4
    query heads of 16): kernel A and A′ launch at width (16, 16) with B,
    C1, C2 at D 64, through the dtype's kernels, and no plain version
    runs."""
    _cuda()
    from repro_torch.kernels.cross_entropy import ce_bwd_dh_cuda
    from repro_torch.kernels.flash_attention import (FWD_KERNELS,
                                                     flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda)
    from repro_torch.launch.train import main
    wrappers = (flash_attention_cuda, flash_bwd_dq_cuda, flash_bwd_dkdv_cuda,
                ce_bwd_dh_cuda)
    before = [w.launches for w in wrappers]
    kernel = FWD_KERNELS[getattr(torch, dtype)]
    fwd = flash_attention_cuda.by_kernel[kernel]
    plain = (ops.flash_attention.plain_calls,
             ops.fused_cross_entropy.plain_calls)
    assert main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "4",
                 "--context", "256", "--dtype", dtype]) == 0
    torch.cuda.synchronize()
    assert all(w.launches > b for w, b in zip(wrappers, before))
    assert flash_attention_cuda.by_kernel[kernel] > fwd
    assert (ops.flash_attention.plain_calls,
            ops.fused_cross_entropy.plain_calls) == plain


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b"])
def test_ssm_train_step_on_card_matches_cpu(arch):
    """One reduced float32 chunked step of the SSM families (a sequence
    split over 3 chunks with the ``(h, conv_tail)`` carry, and KV on
    hymba; pad rows in front of the carry; the planner's non-zero remat
    table) on the card, through the kernels, against the same step on the
    CPU through the plain versions: loss ``rtol 1e-5``, gradients within
    ``2e-5`` scaled by each leaf's largest value."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.train_step import ChunkedTrainer
    cfg = get_arch(arch).reduced(n_layers=4, d_model=128, n_heads=4,
                                 head_dim=64, vocab=512)
    rng = np.random.default_rng(2)
    lens = [400] + [int(x) for x in rng.integers(30, 150, 5)]
    corpus = {i: rng.integers(0, 512, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec())
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        capacity_bytes=cm.m_model_states(1) + 4e6))
    chunks = [c for p in plan.pipelines for c in p.chunks]
    assert max(s.n_chunks for s in plan.sequences) >= 3
    assert any(c.has_dependents and c.tokens % 64 for c in chunks)
    params = DecoderLM(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    res = {}
    for d in ("cpu", dev):
        before = _launch_counts()
        tr = ChunkedTrainer(cfg, params, device=d,
                            compute_dtype=torch.float32)
        res[str(d)] = tr.loss_and_grads(plan, corpus)
        if d is dev:
            torch.cuda.synchronize()
            after = _launch_counts()
            assert all(after[k] > before[k] for k in after if k != "plain")
            assert after["plain"] == before["plain"]
    a, b = res["cpu"], res[str(dev)]
    assert a.n_valid == b.n_valid
    assert abs(a.loss - b.loss) <= 1e-5 * abs(a.loss)
    for x, y in zip(tree_leaves(b.grads), tree_leaves(a.grads)):
        _close(x, y, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("sched", ["gpipe-1f1b", "interleaved-1f1b",
                                   "zero-bubble-h1"])
def test_pipeline_on_card_matches_whole_sequences(sched):
    """Reduced hymba-1.5b at ``d_p = 2`` (both stages on the card; a
    sequence split over 3 chunks with pad rows in front of the carries,
    the planner's non-zero remat table on both stages; the split backward
    under zero-bubble-h1) through the pipeline executor, float32, against
    one unchunked forward and backward per sequence on the card: loss
    ``rtol 1e-5``, each gradient leaf within ``1e-4`` of its largest
    value. The stages launch the attention and scan kernels and never a
    plain version."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.kernels.flash_attention import flash_bwd_dq_cuda
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.pipeline import PipelineGeometry
    from repro_torch.runtime.train_step import (ChunkedTrainer,
                                                PipelineTrainer)
    cfg = get_arch("hymba-1.5b").reduced(n_layers=4, d_model=128, n_heads=4,
                                         head_dim=64, vocab=512)
    rng = np.random.default_rng(2)
    lens = [400] + [int(x) for x in rng.integers(30, 150, 5)]
    corpus = {i: rng.integers(0, 512, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec(d_p=2))
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        capacity_bytes=max(cm.m_model_states(p) for p in (1, 2)) + 4e6))
    chunks = [c for p in plan.pipelines for c in p.chunks]
    assert max(s.n_chunks for s in plan.sequences) >= 3
    assert any(c.has_dependents and c.tokens % 64 for c in chunks)
    assert all(any(row) for row in plan.ckpt_table())
    params = DecoderLM(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    whole = ChunkedTrainer(cfg, params, device=dev,
                           compute_dtype=torch.float32
                           ).sequence_loss_and_grads(corpus)
    geom = PipelineGeometry(d_p=2, schedule=sched,
                            v_stages=2 if sched == "interleaved-1f1b" else 1,
                            split_bwd=sched == "zero-bubble-h1")
    tr = PipelineTrainer(cfg, params, geometry=geom, cards=[dev],
                         compute_dtype=torch.float32, cost_model=cm)
    before = {**_launch_counts(), "dq": flash_bwd_dq_cuda.launches,
              "plain_attn": ops.flash_attention.plain_calls,
              "plain_ce": ops.fused_cross_entropy.plain_calls}
    res = tr.loss_and_grads(plan, corpus)
    torch.cuda.synchronize()
    after = {**_launch_counts(), "dq": flash_bwd_dq_cuda.launches,
             "plain_attn": ops.flash_attention.plain_calls,
             "plain_ce": ops.fused_cross_entropy.plain_calls}
    assert all(after[k] > before[k] for k in after
               if not k.startswith("plain"))
    assert all(after[k] == before[k] for k in after if k.startswith("plain"))
    assert res.n_valid == whole.n_valid and res.remat_layers > 0
    assert abs(res.loss - whole.loss) <= 1e-5 * abs(whole.loss)
    for x, y in zip(tree_leaves(res.grads), tree_leaves(whole.grads)):
        y = y.to(x.device)
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


@pytest.mark.gpu
def test_encdec_attention_and_step_on_card():
    """The encoder-decoder's modes of kernel A and A′ against the plain
    versions, float32 and bf16: non-causal self-attention over packed
    frames at their own positions (3 segments, 5 pad rows), and
    cross-attention of 333 token rows to 200 and to 500 memory rows at
    zero positions (the same 3 segments on both sides); then one reduced
    seamless-m4t-v2 step (2 + 2 layers, d_model 128, heads of 64) at
    ``d_p = 2``, float32, on the card against the same step on the CPU:
    loss ``rtol 1e-5``, each gradient leaf within ``2e-5`` of its largest
    value, the kernels launched and no plain version."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.data.batching import sequence_frames
    from repro_torch.kernels.flash_attention import flash_bwd_dq_cuda
    from repro_torch.models import EncDecLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.encdec_pipeline import EncDecGeometry
    from repro_torch.runtime.train_step import EncDecTrainer
    rng = np.random.default_rng(22)
    T = 333
    seg_q, pos_q = _packed(rng, T, 3, ctx=0)
    seg_q[-5:] = -1
    for dtype in (torch.float32, torch.bfloat16):
        for S in (T, 200, 500):
            if S == T:
                seg_kv, pos_kv, pq = seg_q, pos_q, pos_q
            else:
                seg_kv, _ = _packed(rng, S, 3, ctx=0)
                pq, pos_kv = np.zeros(T, np.int32), np.zeros(S, np.int32)

            def mk(*s):
                return torch.from_numpy(rng.standard_normal(s).astype(
                    np.float32)).to(dev, dtype)
            q, k, v, dout = mk(T, 8, 64), mk(S, 4, 64), mk(S, 4, 64), \
                mk(T, 8, 64)
            meta = [torch.from_numpy(a).to(dev) for a in
                    (seg_q, seg_kv, pq, pos_kv)]
            qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
            dq0 = flash_bwd_dq_cuda.launches
            out = ops.flash_attention(qq, kk, vv, *meta, causal=False)
            out.backward(dout)
            torch.cuda.synchronize()
            assert flash_bwd_dq_cuda.launches == dq0 + 1
            _close(out, ref.flash_attention_reference(q, k, v, *meta,
                                                      causal=False), dtype)
            grads = ref.flash_attention_grad(q.float(), k.float(),
                                             v.float(), *meta, dout.float(),
                                             causal=False)
            for got, w in zip((qq.grad, kk.grad, vv.grad), grads):
                _close(got, w, dtype)
            if S == T:      # a causal limit would change the live rows
                causal = ref.flash_attention_reference(q, k, v, *meta)
                live = torch.from_numpy(seg_q >= 0).to(dev)
                diff = (causal - out.detach()).float()[live]
                assert float(diff.abs().max()) > 0.1

    cfg = get_arch("seamless-m4t-v2").reduced(n_layers=2, d_model=128,
                                              n_heads=4, head_dim=64,
                                              vocab=512)
    lens = [300, 120, 77, 150, 64]
    corpus = {i: rng.integers(0, 512, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec(d_p=2))
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=1, bucket_rounding=16, remat_mode="stage_aware", v_stages=1,
        sp_degree=1, schedule="gpipe-1f1b", token_capacity=320))
    for pipe in plan.pipelines:     # remat on both roles, rows that differ
        pipe.ckpt = [[1, 0] * pipe.n_chunks, [0, 2] * pipe.n_chunks]
        pipe.ckpt = [row[:pipe.n_chunks] for row in pipe.ckpt]
    assert plan.n_chunks >= 2
    params = EncDecLM(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
    frames = sequence_frames(cfg, corpus, 0, device="cpu",
                             dtype=torch.float32)
    res = {}
    for d in ("cpu", dev):
        tr = EncDecTrainer(cfg, params, geometry=EncDecGeometry(d_p=2),
                           cards=[d], compute_dtype=torch.float32,
                           cost_model=cm)
        plain = (ops.flash_attention.plain_calls,
                 ops.fused_cross_entropy.plain_calls)
        dq0 = flash_bwd_dq_cuda.launches
        res[str(d)] = tr.loss_and_grads(
            plan, corpus, {s: f.to(d) for s, f in frames.items()})
        if d is dev:
            torch.cuda.synchronize()
            assert flash_bwd_dq_cuda.launches > dq0
            assert (ops.flash_attention.plain_calls,
                    ops.fused_cross_entropy.plain_calls) == plain
    a, b = res["cpu"], res[str(dev)]
    assert a.n_valid == b.n_valid and b.remat_layers > 0
    assert abs(a.loss - b.loss) <= 1e-5 * abs(a.loss)
    for x, y in zip(tree_leaves(b.grads), tree_leaves(a.grads)):
        y = y.to(x.device)
        assert float((x - y).abs().max()) <= 2e-5 * float(y.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["per_tick", "per_step"])
def test_encdec_sp_step_on_card(mode):
    """The reduced seamless-m4t-v2 step (2 + 2 layers, d_model 128, heads
    of 64) at ``(d_p, d_s) = (2, 2)``, allgather_kv, ZeRO-3 in ``mode``,
    zero-bubble-h1 (the split backward), float32, on the card against the
    same step on the CPU: loss ``rtol 1e-5``, each gradient leaf within
    ``2e-5`` of its largest value; the kernels launched (B once a
    vocabulary block and chunk), no plain version, the memory gathered
    once a chunk."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.data.batching import sequence_frames
    from repro_torch.kernels.cross_entropy import ce_fwd_cuda
    from repro_torch.kernels.flash_attention import flash_bwd_dq_cuda
    from repro_torch.models import EncDecLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.encdec_pipeline import EncDecGeometry
    from repro_torch.runtime.train_step import EncDecTrainer
    rng = np.random.default_rng(23)
    cfg = get_arch("seamless-m4t-v2").reduced(n_layers=2, d_model=128,
                                              n_heads=4, head_dim=64,
                                              vocab=512)
    lens = [300, 120, 77, 150, 64]
    corpus = {i: rng.integers(0, 512, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec(d_p=2, d_s=2))
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=1, bucket_rounding=16, remat_mode="stage_aware", v_stages=1,
        sp_policy="allgather_kv", sp_degree=2, schedule="zero-bubble-h1",
        token_capacity=320))
    for pipe in plan.pipelines:     # remat on both roles, rows that differ
        pipe.ckpt = [([1, 0] * pipe.n_chunks)[:pipe.n_chunks],
                     ([0, 2] * pipe.n_chunks)[:pipe.n_chunks]]
    params = EncDecLM(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
    frames = sequence_frames(cfg, corpus, 0, device="cpu",
                             dtype=torch.float32)
    geom = EncDecGeometry(d_p=2, d_s=2, schedule="zero-bubble-h1",
                          split_bwd=True, zero3_mode=mode)
    res = {}
    for d in ("cpu", dev):
        tr = EncDecTrainer(cfg, params, geometry=geom, cards=[d],
                           compute_dtype=torch.float32, cost_model=cm)
        plain = (ops.flash_attention.plain_calls,
                 ops.fused_cross_entropy.plain_calls)
        dq0, b0 = flash_bwd_dq_cuda.launches, ce_fwd_cuda.launches
        res[str(d)] = tr.loss_and_grads(
            plan, corpus, {s: f.to(d) for s, f in frames.items()})
        if d is dev:
            torch.cuda.synchronize()
            assert flash_bwd_dq_cuda.launches > dq0
            assert ce_fwd_cuda.launches - b0 == 2 * plan.n_chunks
            assert (ops.flash_attention.plain_calls,
                    ops.fused_cross_entropy.plain_calls) == plain
    a, b = res["cpu"], res[str(dev)]
    assert a.n_valid == b.n_valid and b.remat_layers > 0
    assert b.pipeline["memory_gathers"] == plan.n_chunks
    assert abs(a.loss - b.loss) <= 1e-5 * abs(a.loss)
    for x, y in zip(tree_leaves(b.grads), tree_leaves(a.grads)):
        y = y.to(x.device)
        assert float((x - y).abs().max()) <= 2e-5 * float(y.abs().max())


# ---------------------------------------------------------------------------
# the sequence-parallel axis (runtime/sp.py): the kernels at the shapes a
# rank gives them, and a reduced SP step on the card against the CPU

def _sp_blocks(t, d):
    return list(t.split(t.shape[0] // d))


def _sp_policy_run(policy, d, dev, dtype, q, k, v, seg, pos, ctx, C):
    """One SP attention policy over ``d`` ranks on ``dev`` (outputs and
    the gradients in q, k, v and the carry of ``sum(out * w)``)."""
    from repro_torch.runtime import sp
    leaves = [t.detach().to(dev, dtype).clone().requires_grad_(True)
              for t in (q, k, v)]
    cks = None if ctx is None else [
        [c.detach().to(dev, dtype).clone().requires_grad_(True) for c in f]
        for f in ctx]
    outs, _, _ = policy(
        _sp_blocks(leaves[0], d), _sp_blocks(leaves[1], d),
        _sp_blocks(leaves[2], d), segs=_sp_blocks(seg.to(dev), d),
        poss=_sp_blocks(pos.to(dev), d),
        ctx_k=None if cks is None else cks[0],
        ctx_v=None if cks is None else cks[1], ctx_len=C, causal=True,
        window=0, scale=0.125)
    out = torch.cat(outs)
    w = torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)
    (out.float() * w).sum().backward()
    grads = [t.grad for t in leaves] + (
        [] if cks is None else [c.grad for f in cks for c in f])
    return out, grads


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["allgather_kv", "ulysses"])
def test_sp_attention_on_card_matches_plain(which, dtype):
    """Kernel A and A′ at a rank's shapes: allgather_kv, 2 ranks of 320
    query rows at their offset positions against 600 context rows and the
    640 gathered ones (Hkv 1), the last rank's block all pad rows but 40;
    ulysses, 4 ranks (8 query and 4 KV heads: 2 and 1 a rank) over all
    rows, against a head-sharded context. Outputs and gradients against
    the same policy on the CPU's plain versions; the kernels launch, no
    plain call on the card."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_bwd_dq_cuda)
    from repro_torch.runtime import sp
    rng = np.random.default_rng(7)
    d, T, C, Dh = (2, 640, 600, 128) if which == "allgather_kv" \
        else (4, 512, 300, 64)
    Hq, Hkv = (8, 1) if which == "allgather_kv" else (8, 4)
    seg, pos = _packed(rng, T, 3, ctx=C)
    if which == "allgather_kv":
        seg[360:] = -1                  # rank 1: 40 live rows, then pads
        pos[360:] = 0
    g = torch.Generator().manual_seed(3)
    q = torch.randn((T, Hq, Dh), generator=g)
    k = torch.randn((T, Hkv, Dh), generator=g)
    v = torch.randn((T, Hkv, Dh), generator=g)
    ck = torch.randn((C + 64, Hkv, Dh), generator=g)
    cv = torch.randn((C + 64, Hkv, Dh), generator=g)
    if which == "ulysses":
        ctx = [list(ck.chunk(d, dim=1)), list(cv.chunk(d, dim=1))]
        policy = sp.make_ulysses_policy(d)
    else:
        ctx = [[ck], [cv]]
        policy = sp.make_allgather_kv_policy()
    seg_t, pos_t = torch.from_numpy(seg), torch.from_numpy(pos)
    want = _sp_policy_run(policy, d, torch.device("cpu"), torch.float32, q,
                          k, v, seg_t, pos_t, ctx, C)
    before = (flash_attention_cuda.launches, flash_bwd_dq_cuda.launches,
              ops.flash_attention.plain_calls)
    got = _sp_policy_run(policy, d, dev, dtype, q, k, v, seg_t, pos_t, ctx,
                         C)
    torch.cuda.synchronize()
    after = (flash_attention_cuda.launches, flash_bwd_dq_cuda.launches,
             ops.flash_attention.plain_calls)
    assert after[0] - before[0] == d and after[1] - before[1] == d
    assert after[2] == before[2]
    live = seg_t >= 0
    _close(got[0][live.to(dev)], want[0][live], dtype)
    for a, b in zip(got[1], want[1]):
        _close(a, b, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_ce_on_card_matches_plain(dtype):
    """B, C1 and C2 on unequal vocabulary blocks (V 32,001 over 2 ranks:
    16,001 and 16,000 rows, D 512), most targets outside each block: B's
    target logit is exactly 0 where the target is outside the block, C1
    and C2 add no one-hot there; the merged loss and its gradients against
    the plain versions on the CPU."""
    dev = _cuda()
    from repro_torch.kernels.cross_entropy import (ce_bwd_dh_cuda,
                                                   ce_fwd_cuda)
    from repro_torch.runtime import sp
    T, D, V = 1024, 512, 32001
    g = torch.Generator().manual_seed(5)
    h = torch.randn((T, D), generator=g) * 0.5
    w = torch.randn((V, D), generator=g) * 0.05
    tgt = torch.randint(0, V, (T,), generator=g)
    valid = torch.rand((T,), generator=g) > 0.2
    # a block's targets outside it: B's target logit is 0, C1's one-hot 0
    hp, wp = h.to(dev, dtype), w[16001:].to(dev, dtype).contiguous()
    far = (tgt - 16001).to(torch.int32)
    out = far.clone()
    out[(far >= 0) & (far < 16000)] = -1
    out = out.to(dev)
    _, tl = ce_fwd_cuda(hp, wp, out)
    assert bool((tl[(out < 0) | (out >= 16000)] == 0).all())
    lse, _ = ref.cross_entropy_fwd_plain(hp.float().cpu(), wp.float().cpu(),
                                         out.cpu())
    gr = torch.ones(T, device=dev)
    dh = ce_bwd_dh_cuda(hp, wp, out, lse.to(dev), gr)
    _close(dh, ref.cross_entropy_bwd_dh_plain(
        hp.float().cpu(), wp.float().cpu(), out.cpu(), lse,
        gr.cpu()), dtype)
    res = {}
    for dv, dt in (("cpu", torch.float32), (dev, dtype)):
        hh = h.to(dv, dt).clone().requires_grad_(True)
        ww = w.to(dv, dt).clone().requires_grad_(True)
        loss, n = sp.sharded_ce(_sp_blocks(hh, 2), ww,
                                _sp_blocks(tgt.to(dv), 2),
                                _sp_blocks(valid.to(dv), 2), 2)
        loss.backward()
        res[str(dv)] = (loss.detach(), hh.grad, ww.grad)
    a, b = res["cpu"], res[str(dev)]
    _close(b[0].reshape(1), a[0].reshape(1), dtype)
    _close(b[1], a[1], dtype)
    _close(b[2], a[2], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sp_ssm_scan_on_card_matches_plain(dtype):
    """Gated D and D′ over 2 ranks from a non-zero ``h0`` (a summary scan
    from zero on rank 0, the fold, each rank's scan from its folded
    state), ``dh0`` flowing back: outputs, the final state and every
    gradient against the same fold on the CPU's plain versions."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.models import DecoderLM, layer_params
    from repro_torch.models.ssm import dt_rank_of
    from repro_torch.runtime import sp
    cfg = get_arch("hymba-1.5b").reduced(n_layers=1, d_model=256,
                                         n_heads=4, head_dim=64)
    p0 = layer_params(DecoderLM(cfg).init(torch.Generator().manual_seed(1),
                                          device="cpu"), 0)["mamba"]
    s = cfg.spec
    T, di, ds, R = 640, s.inner, s.ssm_state, dt_rank_of(cfg)
    rng = np.random.default_rng(4)
    seg, pos = _packed(rng, T, 3, ctx=50)
    seg[600:] = -1
    pos[600:] = 0
    g = torch.Generator().manual_seed(2)
    base = [torch.randn(sh, generator=g) * sc for sh, sc in (
        ((T, di), 1.0), ((T, R), 0.3), ((T, ds), 1.0), ((T, ds), 1.0),
        ((T, di), 1.0), ((di, ds), 0.5))]
    live = torch.from_numpy(seg) >= 0
    reset = (torch.from_numpy(pos) == 0) & live
    res = {}
    for dv, dt in (("cpu", torch.float32), (dev, dtype)):
        p = {k: v.to(dv, dt if v.dim() > 1 else torch.float32)
             for k, v in p0.items()}
        ins = [t.to(dv, dt if i < 5 else torch.float32).clone()
               .requires_grad_(True) for i, t in enumerate(base)]
        shards = [sp.ScanShard(*[t[r * 320:(r + 1) * 320] for t in ins[:5]],
                               live[r * 320:(r + 1) * 320].to(dv),
                               reset[r * 320:(r + 1) * 320].to(dv))
                  for r in range(2)]
        outs, h = sp.make_sp_ssm_scan()(p, shards, ins[5])
        out = torch.cat(outs)
        (out.float().sum() + h.sum()).backward()
        res[str(dv)] = [out, h] + [t.grad for t in ins]
    for a, b in zip(res[str(dev)], res["cpu"]):
        _close(a, b, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["per_tick", "per_step"])
@pytest.mark.parametrize("arch,policy", [("gemma3-1b", "allgather_kv"),
                                         ("llama3.2-3b", "ulysses"),
                                         ("hymba-1.5b", "allgather_kv")])
def test_sp_train_step_on_card_matches_cpu(arch, policy, mode):
    """A reduced float32 step at ``--mesh 1x2`` (a sequence split over 3
    chunks, the planner's remat table) under ZeRO-3's ``mode`` on the
    card, through the kernels, against the same step on the CPU: loss
    ``rtol 1e-5``, gradients within ``2e-5`` scaled by each leaf's largest
    value; no plain call on the card."""
    _sp_step_on_card(arch, policy, mode=mode)


@pytest.mark.gpu
def test_pods_train_step_on_card_matches_cpu():
    """The same step on 2 pods of a ``1 x 2`` ZeRO-3 pipeline (the plan's
    pipelines split over them, the plain all-reduce) on the card against
    the CPU."""
    _sp_step_on_card("gemma3-1b", "allgather_kv", n_pods=2)


@pytest.mark.gpu
def test_compressed_pods_on_card_stay_within_the_bound():
    """The pods' int8 all-reduce on the card (``optim/compression``, the
    trainer's ``reduce_pods``): each pod's gradient sums as on the CPU,
    and every element of their compressed sum within ``n_pods * scale /
    2`` (over ``n_valid``, as the step scales it) of their plain sum on the
    card (the card's and the CPU's sums may round an element to
    neighbouring int8 steps, so the bound, not the CPU's sum, is the
    check)."""
    dev = _cuda()
    from repro_torch.optim.compression import q8_scale
    runs = {}
    for d in ("cpu", dev):
        tr, plan, corpus = _sp_trainer("gemma3-1b", "allgather_kv", d,
                                       n_pods=2, compress=True)
        runs[str(d)] = (tr, tr.pod_runs(plan, corpus))
    (_, cpu), (tr, card) = runs["cpu"], runs[str(dev)]
    for (_, a), (_, b) in zip(cpu, card):
        for pa, pb in zip(a, b):
            for x, y in zip(pb, pa):
                _close(x.cpu(), y, torch.float32)
    n_valid = sum(r.n_valid for r, _ in card)
    accs = [a for _, a in card]
    plain = [[sum(a[p][i] for a in accs) / n_valid
              for i in range(len(accs[0][p]))] for p in range(len(accs[0]))]
    scales = [[float(q8_scale([a[p][i] for a in accs],
                              [torch.zeros_like(accs[0][p][i])] * 2))
               for i in range(len(accs[0][p]))] for p in range(len(accs[0]))]
    got = tr.reduce_pods(accs, n_valid)
    for gp, wp, sp in zip(got, plain, scales):
        for g, w, s in zip(gp, wp, sp):
            assert float((g - w).abs().max()) <= 2 * s / 2 / n_valid * \
                1.0001


def _sp_trainer(arch, policy, device, mode="per_tick", n_pods=1,
                compress=False):
    """A reduced float32 ``1 x 2`` trainer on ``device``, a plan (a
    sequence split over 3 chunks, the planner's remat table) and its
    corpus."""
    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.models import DecoderLM
    from repro_torch.runtime.pipeline import PipelineGeometry
    from repro_torch.runtime.train_step import PipelineTrainer
    cfg = get_arch(arch).reduced(n_layers=4, d_model=128, n_heads=4,
                                 head_dim=64, vocab=512)
    rng = np.random.default_rng(2)
    lens = [400] + [int(x) for x in rng.integers(30, 150, 5)]
    corpus = {i: rng.integers(0, 512, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec(d_s=2))
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        sp_policy=policy, sp_degree=2,
        capacity_bytes=cm.with_sp(policy, 2).m_model_states(1) + 2e6))
    assert max(s.n_chunks for s in plan.sequences) >= 3
    params = DecoderLM(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    geom = PipelineGeometry(d_p=1, d_s=2, policy=policy, d_s_eff=2,
                            zero3_mode=mode)
    tr = PipelineTrainer(cfg, params, geometry=geom, cards=[device],
                         compute_dtype=torch.float32, cost_model=cm,
                         n_pods=n_pods, compress_pod_grads=compress)
    return tr, plan, corpus


def _sp_step_on_card(arch, policy, mode="per_tick", n_pods=1):
    dev = _cuda()
    from repro_torch.models.model import tree_leaves
    res = {}
    for d in ("cpu", dev):
        plain = (ops.flash_attention.plain_calls,
                 ops.fused_cross_entropy.plain_calls,
                 ops.mamba_scan.plain_calls)
        tr, plan, corpus = _sp_trainer(arch, policy, d, mode, n_pods)
        res[str(d)] = tr.loss_and_grads(plan, corpus)
        if d is dev:
            torch.cuda.synchronize()
            assert plain == (ops.flash_attention.plain_calls,
                             ops.fused_cross_entropy.plain_calls,
                             ops.mamba_scan.plain_calls)
    a, b = res["cpu"], res[str(dev)]
    assert a.n_valid == b.n_valid
    assert abs(a.loss - b.loss) <= 1e-5 * abs(a.loss)
    for x, y in zip(tree_leaves(b.grads), tree_leaves(a.grads)):
        _close(x, y, torch.float32)


# ---------------------------------------------------------------------------
# the pipelined decode's layers on the card

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,d,window", [("hymba-1.5b", 2, 0),
                                           ("gemma3-1b", 3, 512),
                                           ("deepseek-v2-lite", 2, 0)])
def test_decode_attention_on_card_matches_cpu(arch, d, window, dtype):
    """``decode_attention`` at full width (hymba's 25 / 5 heads of 64,
    gemma3-1b's window, deepseek's latent rows at (192, 128)): 8
    sequences' new rows against ``d`` ranks of 128 rows, the last rank
    holding no live row; kernel A with its lse per rank and the merge on
    the card against the plain versions on the CPU in the same dtype; the
    new row written into the same place."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.models.attention import decode_attention, init_attention
    cfg = get_arch(arch)
    s = cfg.spec
    p = init_attention(cfg, torch.Generator().manual_seed(1), device="cpu")
    bm, s_loc, length = 8, 128, 128 * (d - 1) - 5
    row = (1, s.kv_lora_rank + s.qk_rope_dim) if s.kv_lora_rank else \
        (s.n_kv_heads, s.head_dim)
    g = torch.Generator().manual_seed(2)
    ck = [torch.randn((bm, s_loc, *row), generator=g) for _ in range(d)]
    cv = None if s.kv_lora_rank else \
        [torch.randn((bm, s_loc, *row), generator=g) for _ in range(d)]
    x = torch.randn((bm, s.d_model), generator=g).to(dtype)
    p = {k: v.to(dtype) for k, v in p.items()}
    ck = [t.to(dtype) for t in ck]
    cv = None if cv is None else [t.to(dtype) for t in cv]
    on = {k: v.to(dev) for k, v in p.items()}
    ck_d = [t.to(dev) for t in ck]
    cv_d = None if cv is None else [t.to(dev) for t in cv]
    plain = ops.flash_attention.plain_calls
    want = decode_attention(cfg, p, x, ck, cv, length=length, window=window)
    assert ops.flash_attention.plain_calls == plain + d
    got = decode_attention(cfg, on, x.to(dev), ck_d, cv_d, length=length,
                           window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.plain_calls == plain + d
    _close(got, want, dtype)
    for a, b in zip(ck_d, ck):
        _close(a, b, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,d", [("hymba-1.5b", 2),
                                    ("falcon-mamba-7b", 1)])
def test_mamba_decode_on_card_matches_cpu(arch, d, dtype):
    """``mamba_decode`` at full width over ``d`` channel blocks, 8
    sequences from a random state: the output, the new state and tail, on
    the card against the CPU in the same dtype."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.models.ssm import init_mamba, mamba_decode
    cfg = get_arch(arch)
    s = cfg.spec
    p = init_mamba(cfg, torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(3)
    bm, dl = 8, s.inner // d
    h = [torch.randn((bm, dl, s.ssm_state), generator=g) for _ in range(d)]
    t = [torch.randn((bm, s.ssm_conv - 1, dl), generator=g)
         for _ in range(d)]
    x = torch.randn((bm, s.d_model), generator=g).to(dtype)
    p = {k: v.to(dtype) for k, v in p.items()}
    t = [a.to(dtype) for a in t]
    h_d, t_d = [a.to(dev) for a in h], [a.to(dev) for a in t]
    got = mamba_decode(cfg, {k: v.to(dev) for k, v in p.items()},
                       x.to(dev), h_d, t_d)
    want = mamba_decode(cfg, p, x, h, t)
    torch.cuda.synchronize()
    _close(got, want, dtype)
    for a, b in zip(h_d + t_d, h + t):
        _close(a, b, dtype)


@pytest.mark.gpu
def test_dryrun_unit_on_card_matches_its_trace():
    """Reduced hymba-1.5b's train unit at 2x2 (the dry-run's largest chunk
    through the last stage, both ranks; and through the stage with the
    largest estimate), built on the card from random bf16 weights and run
    once: each rank holds the bytes the dry-run sized, each kernel
    launches as often as the meta trace booked it and no plain version
    runs, the collectives are the trace's, the outputs, carries and
    gradients have the trace's shapes and dtypes, and the peak is within
    10% of the trace's."""
    dev = _cuda()
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import DecoderLM
    cfg = get_arch("hymba-1.5b").reduced()
    shape = ShapeSpec("train_small", 2048, 8, "train")
    mesh = make_mesh((2, 2), ("data", "model"))
    traces = [dr.trace_unit(u)
              for u in dr.build_cell(cfg, shape, mesh=mesh).units]
    params = DecoderLM(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 device=dev, dtype=torch.bfloat16)
    card = dr.build_cell(cfg, shape, mesh=mesh, device=dev, params=params)
    del params
    assert len(card.units) == len(traces) >= 1
    for unit, tr in zip(card.units, traces):
        assert unit.rank_bytes == tr["rank_bytes"]
        got = dr.measure_unit(unit)
        assert got["launches"] == {k: v["calls"]
                                   for k, v in tr["kernel_ops"].items()}
        assert got["collectives"] == tr["collectives"]
        assert got["signature"] == tr["signature"]
        assert abs(got["peak_bytes"] - tr["trace_peak_bytes"]) <= \
            0.10 * tr["trace_peak_bytes"], (got["peak_bytes"],
                                            tr["trace_peak_bytes"])
