"""The port on the card: the CUDA kernels against their plain versions
(flash attention forward, its log-sum-exp and backward; cross-entropy
B, C1, C2), the engine on CUDA against the engine on the CPU, and one
reduced training step on CUDA against the same step on the CPU.

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
])
def test_kernel_matches_plain(dtype, Hq, Hkv, Dh, window, C):
    """``C`` context rows of segment 0, then a 300-row chunk: at C=150 one
    block walks all KV tiles of its query tile; at C=4000 they are split
    over blocks and merged (``kv_splits``)."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
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
    split = kv_splits(S) > 1
    assert split == (C > 400)
    before = flash_attention_cuda.launches, flash_combine_cuda.launches
    got = ops.flash_attention(q, k, v, *meta, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before[0] + 1
    assert flash_combine_cuda.launches == before[1] + split
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
    ws_ml, ws_acc = flash_attention_cuda.partials(*args, n_split=n_split)
    got = flash_combine_cuda(ws_ml, ws_acc, dtype)
    want = ref.combine_partials(ws_ml, ws_acc, dtype)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    full = ref.flash_attention_reference(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               full.float().cpu().numpy(), **TOL[dtype])
    assert torch.count_nonzero(got[T - 5:]) == 0


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


def _close(got, want, dtype):
    """Within TOL[dtype], atol scaled by max |want|; returns the error."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    tol = TOL[dtype]
    scale = float(want.abs().max()) or 1.0
    err = (got - want).abs()
    lim = tol["atol"] * scale + tol["rtol"] * want.abs()
    assert bool((err <= lim).all()), (float(err.max()), scale)
    return float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Dh,window", [
    (4, 1, 256, 512),       # gemma3-1b local layer
    (4, 1, 256, 0),         # gemma3-1b global layer
    (24, 8, 128, 0),        # llama3.2-3b
    (8, 2, 64, 16),
])
def test_attention_backward_matches_plain(dtype, Hq, Hkv, Dh, window):
    """A training chunk with context rows: ``C`` valid context rows of
    segment 0, 40 stale carry rows beyond ``ctx_len`` (seg -1), then a
    packed chunk of 3 sequences and padding. The op's forward (kernel A
    with lse) and backward (dk/dv and dq passes) against the plain
    versions; stale and padding rows get exact zero gradients."""
    dev = _cuda()
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda)
    rng = np.random.default_rng(Hq + Dh + window)
    C, stale, T = 700, 40, 300
    seg_q, pos_q = _packed(rng, T, 3, ctx=C)
    seg_q[-5:] = -1
    seg_kv = np.concatenate([np.zeros(C, np.int32),
                             np.full(stale, -1, np.int32), seg_q])
    pos_kv = np.concatenate([np.arange(C + stale, dtype=np.int32), pos_q])

    def mk(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev, dtype)
    S = C + stale + T
    q, k, v = mk(T, Hq, Dh), mk(S, Hkv, Dh), mk(S, Hkv, Dh)
    dout = mk(T, Hq, Dh)
    meta = [torch.from_numpy(a).to(dev) for a in
            (seg_q, seg_kv, pos_q, pos_kv)]
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = (flash_attention_cuda.launches, flash_bwd_dkdv_cuda.launches,
              flash_bwd_dq_cuda.launches)
    out = ops.flash_attention(qq, kk, vv, *meta, window=window)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches, flash_bwd_dkdv_cuda.launches,
            flash_bwd_dq_cuda.launches) == tuple(b + 1 for b in before)
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
    _, lse = flash_attention_cuda(*padded, window=window, with_lse=True)
    want_lse = ref.flash_attention_lse(*padded[:2], *padded[3:],
                                       window=window)
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    _close(lse[live], want_lse[live], torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,V", [(64, 64, 1000), (256, 128, 517),
                                   (640, 1152, 4099), (128, 3072, 1000)])
def test_cross_entropy_kernels_match_plain(dtype, T, D, V):
    """B (lse, target logit), C1 (dh) and C2 (dW) against their plain
    versions: short chunks (vocab split over blocks and merged), a vocab
    that is not a multiple of the tile, D sliced (3072 -> 3 slices),
    targets outside the vocabulary and rows with g = 0."""
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
