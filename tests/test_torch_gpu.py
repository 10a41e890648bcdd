"""The port on the card: the CUDA flash-attention kernel against its plain
version, and the engine on CUDA against the engine on the CPU.

Every test here is marked ``gpu`` and skips without a CUDA card. This
file imports torch only (no jax), so it runs where the card is:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 ``2e-5`` (that of the JAX package's kernel tests;
the kernel sums in another order than the plain version) and, for bf16,
a few units of the output's last place: ``atol 4e-3 + rtol 1e-2``.
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
