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

The backward passes' tile ranges and summaries (``ops.bwd_tiles``, on the
CPU the plain ``ref.flash_attention_tiles``) are held against the JAX
package's mask: on random metadata (hypothesis; non-monotone positions,
context rows, windows, pad rows) and on chunks made by the port's planner
and ``data/batching.py`` (with and without context rows) every range
starts at its first live tile and ends at its last, and every live tile
pair passes the summaries' test.

The bf16 forward on the tensor cores rounds P to bf16 as P V's operand
(its one rounding the TPU kernel does not make): that function, computed
plainly, is held against the Pallas kernel at ``chip_smoke.py``'s bf16
limit. Its split pieces over each query tile's range (the kernel's
formula, ``_fwd_pieces``) visit every live tile exactly once, on random
and planner-made metadata.

At the head widths the kernels gained for stablelm-12b (160) and the
reduced configs (32, 16), the plain attention and its gradient are held
against the Pallas kernel (interpret mode) and ``jax.grad`` of the JAX
reference attention, with context rows, GQA and a window.

The CUDA kernel itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import FWD_BLOCK, tile_counts
from test_torch_threads import torch_thread_share  # noqa: F401

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


# ---------------------------------------------------------------------------
# the backward passes' tile ranges
# ---------------------------------------------------------------------------

def _live_tiles(seg_q, seg_kv, pos_q, pos_kv, causal, window, block):
    """[n_q, n_kv] bool: tile pairs holding a live pair of the JAX
    package's mask (``ref._mask``), which equals the port's
    ``ref.attention_mask`` here."""
    m = np.asarray(jref._mask(jnp.asarray(seg_q), jnp.asarray(seg_kv),
                              jnp.asarray(pos_q), jnp.asarray(pos_kv),
                              causal, jnp.asarray(window)))
    mt = tref.attention_mask(*(torch.from_numpy(np.asarray(a)) for a in
                               (seg_q, seg_kv, pos_q, pos_kv)),
                             causal, window).numpy()
    assert np.array_equal(m, mt)
    T, S = m.shape
    n_q, n_kv = -(-T // block), -(-S // block)
    m = np.pad(m, ((0, n_q * block - T), (0, n_kv * block - S)))
    return m.reshape(n_q, block, n_kv, block).any(axis=(1, 3))


def _tiles_np(seg_q, seg_kv, pos_q, pos_kv, causal, window, block):
    t = ops.bwd_tiles(*(torch.from_numpy(np.asarray(a, np.int32)) for a in
                        (seg_q, seg_kv, pos_q, pos_kv)), causal=causal,
                      window=window, block=block)
    return t, t.kv_range.numpy(), t.q_range.numpy()


def _assert_tight(live, kv_rng, q_rng):
    """Each range is [first live tile, last live tile], [n, -1] if none."""
    for rng_, rows in ((kv_rng, live), (q_rng, live.T)):
        for (lo, hi), row in zip(rng_, rows):
            nz = np.flatnonzero(row)
            want = (nz[0], nz[-1]) if len(nz) else (len(row), -1)
            assert (lo, hi) == want


def _summaries_np(seg, pos, block):
    """Per tile: live rows' segment min, max, position min, max (a loop
    over tiles, independent of the op's)."""
    out = []
    for a in range(0, len(seg), block):
        s, p = np.asarray(seg[a:a + block]), np.asarray(pos[a:a + block])
        s, p = s[s >= 0], p[s >= 0]
        out.append((s.min(), s.max(), p.min(), p.max()) if len(s) else
                   (2 ** 31 - 1, -1, 2 ** 31 - 1, -2 ** 31))
    return np.array(out, np.int64)


def _summaries_meet(t, causal, window):
    """[n_q, n_kv] bool: the kernels' O(1) test of two tiles' summaries."""
    a = t.q_summary.numpy().astype(np.int64)[:, None, :]
    b = t.kv_summary.numpy().astype(np.int64)[None, :, :]
    ok = np.maximum(a[..., 0], b[..., 0]) <= np.minimum(a[..., 1], b[..., 1])
    if causal:
        ok &= b[..., 2] <= a[..., 3]
    if window > 0:
        ok &= a[..., 2] - b[..., 3] < window
    return ok


def _random_meta(rng, T, C, n_seg, order):
    """Query rows of ``n_seg`` segments (pad rows -2 and -1 among them),
    then KV rows: ``C`` context rows of segment 0, 8 stale rows (seg -1)
    and the query rows. ``order``: "rising" positions inside each segment,
    "shuffled" (the same positions, rows permuted) or "random" ints."""
    seg = rng.integers(-2, n_seg, T).astype(np.int32)
    if order != "random":
        seg = np.sort(seg)
    pos = np.zeros(T, np.int32)
    for s in range(n_seg):
        rows = np.flatnonzero(seg == s)
        pos[rows] = np.cumsum(rng.integers(0, 3, len(rows))) + \
            (C if s == 0 else 0)
    if order == "shuffled":
        perm = rng.permutation(T)
        seg, pos = seg[perm], pos[perm]
    elif order == "random":
        pos = rng.integers(0, 3 * T + C, T).astype(np.int32)
    seg_kv = np.concatenate([np.zeros(C, np.int32), np.full(8, -1, np.int32),
                             seg])
    pos_kv = np.concatenate([np.arange(C + 8, dtype=np.int32), pos])
    return seg, seg_kv, pos, pos_kv


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), T=st.integers(1, 260),
       C=st.sampled_from([0, 5, 70]), n_seg=st.integers(1, 5),
       order=st.sampled_from(["rising", "shuffled", "random"]),
       causal=st.booleans(), window=st.sampled_from([0, 1, 7, 40]),
       block=st.sampled_from([32, 64]))
def test_bwd_tile_ranges_hold_every_live_tile(seed, T, C, n_seg, order,
                                              causal, window, block):
    """Every range starts at the first tile holding a live pair and ends
    at the last, every tile's summary is its live rows' extremes, and every
    live tile pair passes the summaries' test; ``tile_counts`` counts at
    least the live pairs, and exactly them inside the ranges when the
    positions rise."""
    rng = np.random.default_rng(seed)
    meta = _random_meta(rng, T, C, n_seg, order)
    live = _live_tiles(*meta, causal, window, block)
    t, kv_rng, q_rng = _tiles_np(*meta, causal, window, block)
    _assert_tight(live, kv_rng, q_rng)
    seg_q, seg_kv, pos_q, pos_kv = meta
    assert np.array_equal(t.q_summary.numpy(),
                          _summaries_np(seg_q, pos_q, block))
    assert np.array_equal(t.kv_summary.numpy(),
                          _summaries_np(seg_kv, pos_kv, block))
    qi, kj = np.nonzero(live)
    assert _summaries_meet(t, causal, window)[qi, kj].all()
    counts = tile_counts(t, causal=causal, window=window)
    for name in ("dq", "dkdv"):
        assert counts[name]["in_range"] >= counts[name]["visited"] \
            >= int(live.sum())


def _planner_chunks(with_context):
    """Chunks of a reduced gemma3-1b batch as the port's planner and
    ``data/batching.py`` make them, with each chunk's KV rows as the
    attention op sees them: the carry (``ctx_len`` rows of segment 0, the
    rest of its capacity seg -1) before the chunk's rows."""
    from repro_torch.configs import get_arch
    from repro_torch.core import ClusterSpec, CostModel, PlannerConfig
    from repro_torch.core import plan_batch
    from repro_torch.data.batching import materialize_plan
    from repro_torch.runtime.train_step import chunk_arrays
    cfg = get_arch("gemma3-1b").reduced(n_layers=4, d_model=64, n_heads=4,
                                        head_dim=16, vocab=256)
    rng = np.random.default_rng(3)
    lens = ([700] if with_context else []) + \
        [int(x) for x in rng.integers(24, 200, 9)]
    corpus = {i: rng.integers(0, 256, n).astype(np.int32)
              for i, n in enumerate(lens)}
    conf = dict(fixed_k=3 if with_context else 1, bucket_rounding=16)
    plan = plan_batch(CostModel(cfg.spec, ClusterSpec()), lens,
                      PlannerConfig(**conf))
    chunks = [c for p in plan.pipelines for c in p.chunks]
    batch = materialize_plan(plan, corpus)
    cap = max(c.context for c in chunks) + 8
    out = []
    for k, ch in enumerate(chunks):
        _, _, seg, pos = chunk_arrays(batch, k, ch.tokens)
        n = int(batch.ctx_len[k])
        if with_context:
            rows = np.arange(cap, dtype=np.int32)
            seg_kv = np.concatenate([np.where(rows < n, 0, -1).astype(
                np.int32), seg])
            pos_kv = np.concatenate([rows, pos])
        else:
            seg_kv, pos_kv = seg, pos
        out.append((n, (seg, seg_kv, pos, pos_kv)))
    return out


@pytest.mark.parametrize("with_context", [False, True])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
@pytest.mark.parametrize("block", [32, 64])
def test_bwd_tile_ranges_are_tight_on_planner_chunks(with_context, causal,
                                                     window, block):
    """On the planner's packed chunks each range starts at the first live
    tile and ends at the last (a tile with no live pair has an empty
    range), and the summaries' test passes no tile inside a range that
    holds no live pair."""
    chunks = _planner_chunks(with_context)
    if with_context:
        assert any(n > 0 for n, _ in chunks)
    for _, meta in chunks:
        live = _live_tiles(*meta, causal, window, block)
        t, kv_rng, q_rng = _tiles_np(*meta, causal, window, block)
        _assert_tight(live, kv_rng, q_rng)
        counts = tile_counts(t, causal=causal, window=window)
        assert counts["dq"]["visited"] == counts["dkdv"]["visited"] == \
            int(live.sum())


# chip_smoke.py's bf16 limit for the attention output (its TOL["bfloat16"])
BF16_OUT_TOL = dict(rtol=1e-2, atol=4e-3)


def _fwd_rounded_p(q, k, v, seg_q, seg_kv, pos_q, pos_kv, window=0):
    """Kernel A's forward as the bf16 tensor-core kernel computes it: S of
    the bf16 inputs in float32, P = exp(S - max) in float32 (its row sums
    too), P rounded to bf16 before P V, V's bf16 values, sums in float32,
    the output in q's dtype; 0 on rows with no live key."""
    T, Hq, D = q.shape
    G = Hq // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("thd,shd->hts", q.float(), kf) * D ** -0.5
    live = tref.attention_mask(seg_q, seg_kv, pos_q, pos_kv, True, window)
    s = s.masked_fill(~live[None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("hts,shd->thd", p.to(torch.bfloat16).float(), vf)
    l = l.permute(1, 0, 2)
    return torch.where(l > 0, o / l.clamp_min(1e-30), 0.0).to(q.dtype)


@pytest.mark.parametrize("Hq,Hkv,Dh,window,ctx", [
    (4, 1, 64, 0, 0),       # gemma3-style MQA
    (4, 1, 64, 24, 64),     # a window, context rows
    (10, 2, 32, 0, 32),     # hymba-style group of 5
    (4, 4, 32, 0, 0),       # group 1
])
def test_bf16_p_rounding_matches_pallas(Hq, Hkv, Dh, window, ctx):
    """The tensor-core forward's one new rounding (P meets bf16 before P
    V) stays within the bf16 limit of the JAX package's kernel
    (``flash_attention_pallas``, interpret mode) on packed segments with
    context rows and padding rows; rows with no live key are 0."""
    rng = np.random.default_rng(Hq * Dh + window + ctx)
    T = 96
    q = rng.standard_normal((T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((ctx + T, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((ctx + T, Hkv, Dh)).astype(np.float32)
    seg_q, pos_q = _varlen_meta(rng, T, 3, ctx=ctx)
    seg_q[-5:] = -1
    seg_kv = np.concatenate([np.zeros(ctx, np.int32), seg_q])
    pos_kv = np.concatenate([np.arange(ctx, dtype=np.int32), pos_q])
    jargs, targs = _both((q, k, v, seg_q, seg_kv, pos_q, pos_kv),
                         "bfloat16")
    want = _f32(flash_attention_pallas(*jargs, window=window, block_q=32,
                                       block_kv=32, interpret=True))
    got = _fwd_rounded_p(*targs, window=window)
    assert got.dtype == torch.bfloat16
    # rows with a live key (each live row attends itself); a row with none
    # is 0 in the port, where the JAX kernel leaves a value of its own
    # (ROADMAP.md: the port's convention)
    np.testing.assert_allclose(_f32(got)[:-5], want[:-5], **BF16_OUT_TOL)
    assert torch.count_nonzero(got[-5:]) == 0
    # the rounding is a different function from the plain version's
    plain = tref.flash_attention_reference(
        *(t.float() for t in targs[:3]), *targs[3:], window=window)
    rounded = _fwd_rounded_p(*(t.float() for t in targs[:3]), *targs[3:],
                             window=window)
    assert float((rounded - plain).abs().max()) > 1e-5


def _fwd_pieces(kv_range, n_split):
    """``[n_q, n_split, 2]``: the KV tiles ``[lo, hi]`` that split ``z`` of
    each query tile walks in ``flash_fwd_mma_kernel`` (its formula):
    ``[lo + z len // n, lo + (z + 1) len // n - 1]`` of the tile's range
    ``[lo, hi]``, ``len = hi - lo + 1``; the whole range unsplit, empty
    where the range is."""
    out = []
    for lo, hi in np.asarray(kv_range, np.int64):
        if n_split == 1 or hi < lo:
            out.append([(lo, hi)] * n_split)
            continue
        n = hi - lo + 1
        cut = [lo + z * n // n_split for z in range(n_split + 1)]
        out.append([(a, b - 1) for a, b in zip(cut, cut[1:])])
    return np.array(out, np.int64).reshape(-1, n_split, 2)


def _assert_pieces_visit_live_tiles_once(meta, causal, window):
    """Each split of the bf16 forward walks a contiguous piece of its
    query tile's range; for every split count the pieces are disjoint,
    cover the range, and every live tile pair lies in exactly one piece
    and passes the summaries' test there."""
    live = _live_tiles(*meta, causal, window, FWD_BLOCK)
    t, kv_rng, _ = _tiles_np(*meta, causal, window, FWD_BLOCK)
    meet = _summaries_meet(t, causal, window)
    n_kv = live.shape[1]
    for n_split in (1, 2, 3, 7, 16):
        pieces = _fwd_pieces(t.kv_range.numpy(), n_split)
        assert pieces.shape == (len(kv_rng), n_split, 2)
        for qt, ((lo, hi), row) in enumerate(zip(kv_rng, pieces)):
            hits = np.zeros(n_kv, np.int32)
            for a, b in row:
                if b >= a:
                    hits[a:b + 1] += 1
            in_range = np.zeros(n_kv, np.int32)
            if hi >= lo:
                in_range[lo:hi + 1] = 1
            assert np.array_equal(hits, in_range), (qt, n_split)
            visited = (hits == 1) & meet[qt]
            assert (visited[live[qt]]).all(), (qt, n_split)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("window", [0, 7, 40])
def test_fwd_pieces_visit_each_live_tile_once(seed, window):
    """On random metadata (rising, shuffled and random positions, context
    rows, stale and padding rows, up to 5 segments)."""
    rng = np.random.default_rng(seed)
    order = ("rising", "shuffled", "random")[seed % 3]
    meta = _random_meta(rng, int(rng.integers(1, 400)),
                        int(rng.choice([0, 5, 70])),
                        int(rng.integers(1, 6)), order)
    _assert_pieces_visit_live_tiles_once(meta, True, window)


@pytest.mark.parametrize("with_context", [False, True])
@pytest.mark.parametrize("window", [0, 16])
def test_fwd_pieces_visit_each_live_tile_once_on_planner_chunks(
        with_context, window):
    """On the port's planner-made chunks, with and without the carry."""
    for _, meta in _planner_chunks(with_context):
        _assert_pieces_visit_live_tiles_once(meta, True, window)


@pytest.mark.parametrize("Hq,Hkv,Dh,window", [(8, 2, 160, 0),
                                              (4, 2, 32, 24),
                                              (4, 2, 16, 0)])
def test_plain_attention_at_the_new_widths(Hq, Hkv, Dh, window):
    """stablelm-12b's 160 and the reduced configs' 32 and 16 (kernel A and
    A′ instantiated there): the plain forward against the Pallas kernel in
    interpret mode, and ``ref.flash_attention_grad`` against ``jax.grad``
    of the JAX reference attention (float32, ``2e-5``), on a packed chunk
    with a context of segment 0 in front."""
    rng = np.random.default_rng(Dh + window)
    T, C = 96, 32                   # the Pallas kernel's 32-row tiles
    seg_q, pos_q = _varlen_meta(rng, T, 3, ctx=C)
    seg_kv = np.concatenate([np.zeros(C, np.int32), seg_q])
    pos_kv = np.concatenate([np.arange(C, dtype=np.int32), pos_q])
    q = rng.standard_normal((T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((C + T, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((C + T, Hkv, Dh)).astype(np.float32)
    dout = rng.standard_normal((T, Hq, Dh)).astype(np.float32)
    meta = (seg_q, seg_kv, pos_q, pos_kv)
    jargs, targs = _both((q, k, v, *meta), "float32")
    _check_all(jargs, targs, "float32", window=window,
               pallas_kw=dict(block_q=32, block_kv=32))

    def f(qq, kk, vv):
        o = jref.flash_attention_reference(qq, kk, vv,
                                           *map(jnp.asarray, meta),
                                           window=window)
        return (o * dout).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = tref.flash_attention_grad(*targs, torch.from_numpy(dout),
                                    window=window)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL["float32"])
