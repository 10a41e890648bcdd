"""Port parity: the port's flash attention against the JAX package's.

On the CPU the port's plain versions (``ref.blocked_flash_attention``,
which ``ops.flash_attention`` runs for CPU tensors, and
``ref.flash_attention_reference``) are held against JAX's
``ref.flash_attention_reference`` and the Pallas kernel
``flash_attention_pallas(..., interpret=True)`` on the cases of
``tests/test_kernels.py`` (dtypes, GQA, packed segments, context KV,
windows) at that file's tolerances: float32 ``2e-5``, bf16 ``2e-2``.
Inputs are numpy arrays from a seed, rounded to bf16 identically in both
frameworks. Plus the dispatcher's padding rule (pad rows ``seg = -2``,
output sliced back) and exact zeros for fully masked rows.

The CUDA kernel itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _varlen_meta(rng, T, n_seq, ctx=0):
    cuts = np.sort(rng.choice(np.arange(1, T), n_seq - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [T]])
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    for s in range(n_seq):
        a, b = bounds[s], bounds[s + 1]
        seg[a:b] = s
        pos[a:b] = np.arange(b - a) + (ctx if s == 0 else 0)
    return seg, pos


def _both(args, dtype):
    """numpy q/k/v + int metadata -> (jax args, torch args), q/k/v in
    ``dtype`` (both frameworks round float32 -> bf16 to nearest even)."""
    q, k, v, *meta = args
    j = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)] + \
        [jnp.asarray(m) for m in meta]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)] + \
        [torch.from_numpy(m) for m in meta]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check_all(jargs, targs, dtype, *, pallas_kw=None, **kw):
    want = jref.flash_attention_reference(*jargs, **kw)
    for got in (tref.blocked_flash_attention(*targs, block_kv=32, **kw),
                tref.flash_attention_reference(*targs, **kw),
                ops.flash_attention(*targs, **kw)):
        assert got.dtype == TDT[dtype]
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    if pallas_kw is not None:
        pal = flash_attention_pallas(*jargs, interpret=True, **pallas_kw,
                                     **kw)
        np.testing.assert_allclose(
            _f32(ops.flash_attention(*targs, **kw)), _f32(pal), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,Hq,Hkv,Dh,nseq", [
    (64, 4, 4, 32, 1),      # MHA single sequence
    (128, 8, 2, 64, 3),     # GQA packed
    (96, 4, 1, 128, 2),     # MQA (gemma3-style kv=1)
    (256, 2, 2, 16, 4),     # many segments, small heads
])
def test_plain_matches_jax_oracle_and_pallas(dtype, T, Hq, Hkv, Dh, nseq):
    rng = np.random.default_rng(T + Hq)
    q = rng.standard_normal((T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((T, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((T, Hkv, Dh)).astype(np.float32)
    seg, pos = _varlen_meta(rng, T, nseq)
    jargs, targs = _both((q, k, v, seg, seg, pos, pos), dtype)
    _check_all(jargs, targs, dtype,
               pallas_kw=dict(block_q=32, block_kv=32))


def test_context_kv_matches():
    """Split-chunk case: KV includes a context prefix of an earlier slice."""
    rng = np.random.default_rng(7)
    T, C, H, Dh = 64, 32, 4, 32
    q = rng.standard_normal((T, H, Dh)).astype(np.float32)
    k = rng.standard_normal((C + T, H, Dh)).astype(np.float32)
    v = rng.standard_normal((C + T, H, Dh)).astype(np.float32)
    seg_q, pos_q = _varlen_meta(rng, T, 2, ctx=C)
    seg_kv = np.concatenate([np.zeros(C, np.int32), seg_q])
    pos_kv = np.concatenate([np.arange(C, dtype=np.int32), pos_q])
    jargs, targs = _both((q, k, v, seg_q, seg_kv, pos_q, pos_kv), "float32")
    _check_all(jargs, targs, "float32",
               pallas_kw=dict(block_q=32, block_kv=32))


@pytest.mark.parametrize("window", [1, 8, 31])
def test_sliding_window_matches(window):
    rng = np.random.default_rng(11)
    T, H, Dh = 128, 2, 32
    q, k, v = (rng.standard_normal((T, H, Dh)).astype(np.float32)
               for _ in range(3))
    seg, pos = _varlen_meta(rng, T, 2)
    jargs, targs = _both((q, k, v, seg, seg, pos, pos), "float32")
    _check_all(jargs, targs, "float32", window=window,
               pallas_kw=dict(block_q=32, block_kv=32))


def test_padding_rule_and_masked_rows_are_zero():
    """``pad_for_kernel`` pads q to BLOCK_Q and k/v to BLOCK_KV rows with
    ``seg = -2``; attention over the padded inputs, sliced back, equals
    the unpadded result, and every row with no live key (padding, a
    ``seg = -1`` row, a segment absent from the keys) is exactly 0."""
    rng = np.random.default_rng(3)
    T, S, Hq, Hkv, Dh = 50, 70, 4, 1, 64
    q = torch.from_numpy(rng.standard_normal((T, Hq, Dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((S, Hkv, Dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((S, Hkv, Dh)).astype(np.float32))
    seg_q = torch.from_numpy(np.repeat(np.arange(5), 10).astype(np.int32))
    seg_q[7] = -1                    # a padding row inside the chunk
    seg_q[40:] = 9                   # a segment with no keys at all
    seg_kv = torch.from_numpy(np.repeat(np.arange(7), 10).astype(np.int32))
    pos_q = torch.from_numpy(np.tile(np.arange(10), 5).astype(np.int32)) + 2
    pos_kv = torch.from_numpy(np.tile(np.arange(10), 7).astype(np.int32))
    padded = ops.pad_for_kernel(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
    qp, kp, vp, sqp, skp, pqp, pkp = padded
    from repro_torch.kernels.flash_attention import BLOCK_KV, BLOCK_Q
    assert qp.shape[0] == 64 and qp.shape[0] % BLOCK_Q == 0
    assert kp.shape[0] == 96 and kp.shape[0] % BLOCK_KV == 0
    assert (sqp[T:] == ops.PAD_SEG).all() and (skp[S:] == ops.PAD_SEG).all()
    assert sqp.dtype == torch.int32 and pkp.dtype == torch.int32
    for kw in (dict(), dict(window=4)):
        full = tref.blocked_flash_attention(*padded, block_kv=32, **kw)
        want = tref.flash_attention_reference(q, k, v, seg_q, seg_kv,
                                              pos_q, pos_kv, **kw)
        np.testing.assert_allclose(full[:T].numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-5)
        assert torch.count_nonzero(full[T:]) == 0
        assert torch.count_nonzero(full[7]) == 0
        assert torch.count_nonzero(full[40:T]) == 0
        assert torch.count_nonzero(want[40:]) == 0
        assert torch.count_nonzero(full[:7]) > 0


def _split_partials(q, k, v, seg_q, seg_kv, pos_q, pos_kv, n_split, window):
    """The kernel's split pass in plain numpy: KV tiles of 32 rows dealt
    round-robin to ``n_split`` splits; per split the max ``m``, sum ``l``
    and unnormalised output ``acc`` (NaN where ``l == 0``, standing in for
    the kernel's uninitialised workspace)."""
    T, Hq, D = q.shape
    G = Hq // k.shape[1]
    s = np.einsum("thd,shd->hts", q, np.repeat(k, G, axis=1)) / np.sqrt(D)
    live = (seg_q[:, None] == seg_kv[None]) & (seg_q[:, None] >= 0) & \
        (pos_kv[None] <= pos_q[:, None]) & \
        ((window <= 0) | (pos_q[:, None] - pos_kv[None] < window))
    tile = np.arange(k.shape[0]) // 32
    ws_ml = np.zeros((n_split, T, Hq, 2), np.float32)
    ws_ml[..., 0] = -1e30
    ws_acc = np.full((n_split, T, Hq, D), np.nan, np.float32)
    for z in range(n_split):
        mz = live & (tile % n_split == z)[None]
        for h in range(Hq):
            for t in np.nonzero(mz.any(axis=1))[0]:
                sc = s[h, t, mz[t]]
                p = np.exp(sc - sc.max())
                ws_ml[z, t, h] = sc.max(), p.sum()
                ws_acc[z, t, h] = p @ v[mz[t], h // G]
    return ws_ml, ws_acc


@pytest.mark.parametrize("n_split,window", [(2, 0), (5, 40)])
def test_combine_partials_matches_jax_oracle(n_split, window):
    """Merging the split pass's partial states (``ref.combine_partials``,
    the plain version of the kernel's merge pass) gives the JAX oracle's
    attention; a row with no live split is exactly 0."""
    rng = np.random.default_rng(n_split)
    T, C, Hq, Hkv, D = 64, 200, 4, 2, 32
    q = rng.standard_normal((T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((C + T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((C + T, Hkv, D)).astype(np.float32)
    seg_q, pos_q = _varlen_meta(rng, T, 3, ctx=C)
    seg_q[-3:] = -1
    seg_kv = np.concatenate([np.zeros(C, np.int32), seg_q])
    pos_kv = np.concatenate([np.arange(C, dtype=np.int32), pos_q])
    args = (q, k, v, seg_q, seg_kv, pos_q, pos_kv)
    ws_ml, ws_acc = _split_partials(*args, n_split, window)
    got = tref.combine_partials(torch.from_numpy(ws_ml),
                                torch.from_numpy(ws_acc), torch.float32)
    want = jref.flash_attention_reference(*map(jnp.asarray, args),
                                          window=window)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=2e-5, atol=2e-5)
    assert torch.count_nonzero(got[-3:]) == 0


def test_dispatch_counts_plain_calls_on_cpu():
    q = torch.zeros((8, 2, 64))
    seg = torch.zeros(8, dtype=torch.int32)
    before = ops.flash_attention.plain_calls
    ops.flash_attention(q, q[:, :1], q[:, :1], seg, seg, seg, seg)
    assert ops.flash_attention.plain_calls == before + 1


def _jax_grads_and_lse(args, dout, fn, **kw):
    """jax.grad of sum(dout * fn(...)) w.r.t. q, k, v, for ``fn`` one of
    the JAX package's attention oracles, and the rows' log-sum-exp from
    its mask rule (-inf on a row with no live key)."""
    import jax
    q, k, v, seg_q, seg_kv, pos_q, pos_kv = map(jnp.asarray, args)

    def f(q, k, v):
        out = fn(q, k, v, seg_q, seg_kv, pos_q, pos_kv, **kw)
        return (out * jnp.asarray(dout)).sum()
    grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    Hq, D = q.shape[1], q.shape[2]
    ke = jref._expand_kv(k, Hq)
    s = jnp.einsum("thd,shd->hts", q, ke) * D ** -0.5
    m = jref._mask(seg_q, seg_kv, pos_q, pos_kv, kw.get("causal", True),
                   jnp.asarray(kw.get("window", 0)))
    lse = jax.nn.logsumexp(jnp.where(m[None], s, -jnp.inf), axis=-1)
    return [np.asarray(g) for g in grads], np.asarray(lse)


@pytest.mark.parametrize("Hq,Hkv,window,ctx", [
    (4, 4, 0, 0),           # MHA, packed, no context
    (8, 2, 0, 48),          # GQA with context rows
    (4, 1, 8, 48),          # MQA, sliding window, context
    (4, 2, 1, 0),           # window 1: only the diagonal
])
def test_attention_gradient_and_lse_match_jax(Hq, Hkv, window, ctx):
    """The plain attention gradient (``ref.flash_attention_grad``, and the
    autograd function ``ops.flash_attention`` backward on the CPU) and the
    plain log-sum-exp against ``jax.grad`` of the JAX package's
    ``blocked_flash_attention`` and ``flash_attention_reference``, float32
    ``2e-5``: packed segments,
    context rows (plus stale carry rows of segment -1), windows, GQA and
    fully masked rows (padding, a segment without keys), whose gradient
    is exactly zero and whose lse is -inf."""
    rng = np.random.default_rng(Hq * 10 + window + ctx)
    T, D, stale = 96, 32, 16
    seg_q, pos_q = _varlen_meta(rng, T, 3, ctx=ctx)
    seg_q[-4:] = -1
    seg_q[10] = 7                    # a segment absent from the keys
    seg_kv = np.concatenate([np.zeros(ctx, np.int32),
                             np.full(stale, -1, np.int32), seg_q])
    seg_kv[ctx + stale + 10] = -1
    pos_kv = np.concatenate([np.arange(ctx + stale, dtype=np.int32), pos_q])
    S = len(seg_kv)
    q = rng.standard_normal((T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((S, Hkv, D)).astype(np.float32)
    dout = rng.standard_normal((T, Hq, D)).astype(np.float32)
    args = (q, k, v, seg_q, seg_kv, pos_q, pos_kv)
    want, want_lse = _jax_grads_and_lse(args, dout,
                                        jref.flash_attention_reference,
                                        window=window)
    # the JAX package's blocked attention returns the mean of V on a fully
    # masked row where the port (and the JAX oracle) returns zeros; in a
    # training step nothing reads such a row (padding, or a token with no
    # key), so its output gradient is zero: compare on that footing
    dead = np.asarray(jnp.logical_not(np.isfinite(want_lse)).all(axis=0))
    dout_live = np.where(dead[:, None, None], 0.0, dout).astype(np.float32)
    want_blk, _ = _jax_grads_and_lse(
        args, dout_live, functools.partial(jref.blocked_flash_attention,
                                           block_kv=32), window=window)
    targs = [torch.from_numpy(a) for a in args]
    td = torch.from_numpy(dout)
    got = tref.flash_attention_grad(*targs, td, window=window)
    got_live = tref.flash_attention_grad(*targs, torch.from_numpy(dout_live),
                                         window=window)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in targs[:3])
    before = ops.flash_attention.plain_calls
    out = ops.flash_attention(qq, kk, vv, *targs[3:], window=window)
    out.backward(td)
    assert ops.flash_attention.plain_calls == before + 2  # fwd + bwd
    for g, a, gl, w, wb in zip(got, (qq.grad, kk.grad, vv.grad), got_live,
                               want, want_blk):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(a.numpy(), w, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(gl.numpy(), wb, rtol=2e-5, atol=2e-5)
    for rows in ((kk.grad, slice(ctx, ctx + stale)), (qq.grad, [10]),
                 (qq.grad, slice(T - 4, T))):
        assert torch.count_nonzero(rows[0][rows[1]]) == 0
    lse = tref.flash_attention_lse(*targs[:2], *targs[3:], window=window)
    assert np.array_equal(np.isfinite(lse.numpy()), np.isfinite(want_lse))
    live = np.isfinite(want_lse)
    assert not live[:, 10].any() and not live[:, -4:].any()
    np.testing.assert_allclose(lse.numpy()[live], want_lse[live], rtol=2e-5,
                               atol=2e-5)
