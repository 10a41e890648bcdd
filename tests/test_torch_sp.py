"""Port parity: the sequence-parallel primitives (``runtime/{sp,ep}.py``)
against the JAX package's, on the CPU, float32, inputs from numpy seeds.

The JAX primitives run under ``jax.vmap(axis_name=...)`` on one CPU device,
as ``tests/test_sp_primitives.py`` runs them; the port's run over lists of
per-rank tensors (the plain kernels on the CPU). At ``d_s`` 2 and 4:

* ``subgroup_info`` and the vocabulary's row blocks;
* ``allgather_kv`` without and with a context carry (outputs and the new
  carry), and over MLA latent rows (the reference's ``expand_fn``, the
  port's ``mla_attention``);
* ``ulysses`` without and with a head-sharded context carry;
* ``sharded_embed``; ``sharded_ce``, its gradients in the hidden rows and
  the head (``jax.grad``), with an unequal vocabulary split;
* the SSM prefix scan: the port's gated scan over the ranks' blocks
  against the reference's ``make_sp_ssm_scan`` on the same decays and
  inputs (a reset at a block boundary and inside one, pad rows that leave
  the state alone), outputs, final state and gradients (``h0`` too);
* ``make_moe_ep`` (gather dispatch) on a reduced olmoe-1b-7b layer.

The conv halo runs against whole-sequence functions instead (``vmap``'s
``ppermute`` refuses the reference's partial permutation): the mamba mixer
over blocks equals the JAX mixer over the whole chunk, and, on a chunk
whose last rank holds only pad rows, the port's unsharded mixer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import DecoderLM as JLM
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.runtime import ep as jep
from repro.runtime import sp as jsp
from repro_torch.configs import get_arch
from repro_torch.models import layer_params
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.runtime import ep, sp
from repro_torch.weights import DENSE_LEAVES, from_jax
from test_torch_sp_pipeline import sp_fault
from test_torch_threads import torch_thread_share  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().numpy()


def _packed(T, lengths, ctx=0):
    """seg/pos of sequences of ``lengths`` packed from row 0 (the first
    continuing at ``ctx``), pad rows after."""
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    a = 0
    for i, n in enumerate(lengths):
        seg[a:a + n] = i
        pos[a:a + n] = np.arange(n) + (ctx if i == 0 else 0)
        a += n
    return seg, pos


def _split(a, d):
    return np.split(np.asarray(a), d)


def _live_close(got, want, seg):
    """Attention outputs on the live query rows (a pad row's output is
    the reference's attention among pad rows, the port's zeros)."""
    live = np.asarray(seg) >= 0
    np.testing.assert_allclose(_np(got)[live], np.asarray(want)[live], **TOL)


# ---------------------------------------------------------------------------
# layout

@pytest.mark.parametrize("d_s,d_eff", [(2, 2), (4, 4), (4, 2), (4, 1),
                                       (8, 4), (2, 0)])
def test_subgroup_info_matches_jax(d_s, d_eff):
    assert sp.subgroup_info(d_s, d_eff) == jsp.subgroup_info(d_s, d_eff)


def test_row_blocks_are_the_padded_blocks():
    for V, d in ((256, 2), (32001, 2), (32001, 4), (10, 4)):
        blocks = sp.row_blocks(V, d)
        b = -(-V // d)
        assert [o for o, _ in blocks] == [min(r * b, V) for r in range(d)]
        assert sum(n for _, n in blocks) == V
        assert blocks[0][1] == b


# ---------------------------------------------------------------------------
# attention policies

def _attn_inputs(d, T, Hq, Hkv, Dh, C, C_cap, seed, Dv=None):
    rng = np.random.default_rng(seed)
    Dv = Dv or Dh
    q = rng.standard_normal((T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((T, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((T, Hkv, Dv)).astype(np.float32)
    seg, pos = _packed(T, [T // 2 + 3, T // 4, T // 8], ctx=C)
    ck = np.zeros((C_cap, Hkv, Dh), np.float32)
    cv = np.zeros((C_cap, Hkv, Dv), np.float32)
    ck[:C] = rng.standard_normal((C, Hkv, Dh))
    cv[:C] = rng.standard_normal((C, Hkv, Dv))
    return q, k, v, seg, pos, ck, cv


def _jax_policy(policy, d, q, k, v, seg, pos, ck, cv, C, *, ctx_axes,
                window, expand_fn=None, causal=True):
    def f(qq, kk, vv, ss, pp, ckk, cvv):
        return policy(qq, kk, vv, seg=ss, pos=pp,
                      ctx_k=None if ckk is None else ckk,
                      ctx_v=None if cvv is None else cvv,
                      ctx_len=jnp.int32(C), causal=causal, window=window,
                      scale=0.25, expand_fn=expand_fn)
    shard = lambda a: jnp.asarray(a).reshape(d, -1, *a.shape[1:])  # noqa
    args = [shard(a) for a in (q, k, v, seg, pos)]
    axes = [0] * 5
    if ck is None:
        args += [None, None]
        axes += [None, None]
    else:
        args += [jnp.asarray(ck), jnp.asarray(cv)]
        axes += [ctx_axes, ctx_axes]
    return jax.vmap(f, in_axes=axes, axis_name="x")(*args)


def _port_policy(policy, d, q, k, v, seg, pos, ctx_k, ctx_v, C, window,
                 mla_fn=None, scale=0.25, causal=True):
    return policy([_t(a) for a in _split(q, d)],
                  [_t(a) for a in _split(k, d)],
                  None if v is None else [_t(a) for a in _split(v, d)],
                  segs=[_t(a) for a in _split(seg, d)],
                  poss=[_t(a) for a in _split(pos, d)],
                  ctx_k=ctx_k, ctx_v=ctx_v, ctx_len=C, causal=causal,
                  window=window, scale=scale, mla_fn=mla_fn)


@pytest.mark.parametrize("C", [0, 40])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("d", [2, 4])
def test_allgather_kv_policy_matches_jax(d, window, C):
    T, C_cap = 128, 200
    q, k, v, seg, pos, ck, cv = _attn_inputs(d, T, 4, 1, 16, C, C_cap, d)
    ctx = C > 0
    jo, jk, jv = _jax_policy(jsp.make_allgather_kv_policy("x"), d, q, k, v,
                             seg, pos, ck if ctx else None, cv, C,
                             ctx_axes=None, window=window)
    outs, nk, nv = _port_policy(
        sp.make_allgather_kv_policy(), d, q, k, v, seg, pos,
        [_t(ck)] if ctx else None, [_t(cv)] if ctx else None, C, window)
    for r, sr in enumerate(_split(seg, d)):
        _live_close(outs[r], jo[r], sr)
    if ctx:
        assert len(nk) == len(nv) == 1           # one replicated carry
        for r in range(d):                       # every rank's the same
            np.testing.assert_allclose(_np(nk[0]), np.asarray(jk[r]), **TOL)
            np.testing.assert_allclose(_np(nv[0]), np.asarray(jv[r]), **TOL)
    else:
        assert nk is None and nv is None


@pytest.mark.parametrize("d", [2, 4])
def test_allgather_kv_non_causal_matches_jax(d):
    """The encoder's self-attention on the SP axis (the reference's
    ``nc_policy``, ``encdec_pipeline.py:199-200``): each rank's frame
    block against every rank's frames of its segments, both ways in
    position; the same policy as the decoder's, ``causal=False``."""
    T = 128
    q, k, v, seg, pos, _, _ = _attn_inputs(d, T, 4, 2, 16, 0, 0, 10 + d)
    jo, _, _ = _jax_policy(jsp.make_allgather_kv_policy("x"), d, q, k, v,
                           seg, pos, None, None, 0, ctx_axes=None, window=0,
                           causal=False)
    outs, nk, nv = _port_policy(sp.make_allgather_kv_policy(), d, q, k, v,
                                seg, pos, None, None, 0, 0, causal=False)
    assert nk is None and nv is None
    causal, _, _ = _port_policy(sp.make_allgather_kv_policy(), d, q, k, v,
                                seg, pos, None, None, 0, 0)
    for r, sr in enumerate(_split(seg, d)):
        _live_close(outs[r], jo[r], sr)
    # a rank's early rows see later rows of their segment: not causal
    assert not all(np.allclose(_np(a), _np(b), **TOL)
                   for a, b in zip(outs, causal))


@pytest.mark.parametrize("C", [0, 40])
@pytest.mark.parametrize("d", [2, 4])
def test_allgather_kv_over_mla_latent_rows_matches_jax(d, C):
    jcfg = jget("deepseek-v2-lite").reduced(n_layers=1)
    cfg = get_arch("deepseek-v2-lite").reduced(n_layers=1)
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(3)))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), raw["layers"])["attn"]
    tp = layer_params(from_jax(cfg, raw, device="cpu"), 0)["attn"]
    s = cfg.spec
    T, C_cap, W = 128, 200, s.kv_lora_rank + s.qk_rope_dim
    rng = np.random.default_rng(d + C)
    q = rng.standard_normal((T, s.n_heads, s.head_dim + s.qk_rope_dim)
                            ).astype(np.float32)
    rows = rng.standard_normal((T, 1, W)).astype(np.float32)
    seg, pos = _packed(T, [70, 30, 20], ctx=C)
    ck = np.zeros((C_cap, 1, W), np.float32)
    ck[:C] = rng.standard_normal((C, 1, W))
    cv = np.zeros((C_cap, 1, 0), np.float32)
    # the chunk's values are the latent rows (the reference projects a
    # zero-width placeholder, which vmap's all_gather refuses: a one-wide
    # one is gathered and ignored, expand_fn makes the values)
    zero_v = np.zeros((T, 1, 1), np.float32)
    scale = 1.0 / np.sqrt(s.head_dim + s.qk_rope_dim)
    policy = jsp.make_allgather_kv_policy("x")

    def f(qq, kk, vv, ss, pp, ckk, cvv):
        return policy(qq, kk, vv, seg=ss, pos=pp, ctx_k=ckk, ctx_v=cvv,
                      ctx_len=jnp.int32(C), causal=True, window=0,
                      scale=scale, expand_fn=functools.partial(
                          jattn.mla_expand_ctx, jcfg, jp))
    shard = lambda a: jnp.asarray(a).reshape(d, -1, *a.shape[1:])  # noqa
    ctx = C > 0
    jo, jk, _ = jax.vmap(f, in_axes=(0, 0, 0, 0, 0, None, None),
                         axis_name="x")(
        shard(q), shard(rows), shard(zero_v), shard(seg), shard(pos),
        jnp.asarray(ck) if ctx else None, jnp.asarray(cv) if ctx else None)
    outs, nk, nv = _port_policy(
        sp.make_allgather_kv_policy(), d, q, rows, None, seg, pos,
        [_t(ck)] if ctx else None, None, C, 0,
        mla_fn=functools.partial(tattn.mla_attention, cfg, tp), scale=scale)
    for r, sr in enumerate(_split(seg, d)):
        _live_close(outs[r], jo[r], sr)
    assert nv is None
    if ctx:
        np.testing.assert_allclose(_np(nk[0]), np.asarray(jk[0]), **TOL)


@pytest.mark.parametrize("C", [0, 40])
@pytest.mark.parametrize("d", [2, 4])
def test_ulysses_policy_matches_jax(d, C):
    T, C_cap, Hq, Hkv, Dh = 128, 200, 8, 4, 16
    q, k, v, seg, pos, ck, cv = _attn_inputs(d, T, Hq, Hkv, Dh, C, C_cap,
                                             10 + d)
    ctx = C > 0
    # the head-sharded context: rank r holds KV heads [r Hkv/d, ...)
    hs = Hkv // d
    ck_r = np.stack([ck[:, r * hs:(r + 1) * hs] for r in range(d)])
    cv_r = np.stack([cv[:, r * hs:(r + 1) * hs] for r in range(d)])
    jo, jk, jv = _jax_policy(jsp.make_ulysses_policy("x", d), d, q, k, v,
                             seg, pos, ck_r if ctx else None, cv_r, C,
                             ctx_axes=0, window=0)
    outs, nk, nv = _port_policy(
        sp.make_ulysses_policy(d), d, q, k, v, seg, pos,
        [_t(a) for a in ck_r] if ctx else None,
        [_t(a) for a in cv_r] if ctx else None, C, 0)
    for r, sr in enumerate(_split(seg, d)):
        _live_close(outs[r], jo[r], sr)
        if ctx:
            np.testing.assert_allclose(_np(nk[r]), np.asarray(jk[r]), **TOL)
            np.testing.assert_allclose(_np(nv[r]), np.asarray(jv[r]), **TOL)


# ---------------------------------------------------------------------------
# the vocabulary-parallel embedding and cross-entropy

@pytest.mark.parametrize("d", [2, 4])
def test_sharded_embed_matches_jax(d):
    V, D, T = 64, 8, 32
    rng = np.random.default_rng(d)
    emb = rng.standard_normal((V, D)).astype(np.float32)
    toks = rng.integers(0, V, T).astype(np.int32)
    want = jax.vmap(lambda e, t: jsp.sharded_embed(e, t, "x", jnp.float32),
                    axis_name="x")(jnp.asarray(emb).reshape(d, V // d, D),
                                   jnp.asarray(toks).reshape(d, T // d))
    got = sp.sharded_embed(_t(emb), [_t(a).long() for a in _split(toks, d)],
                           d, torch.float32)
    for r in range(d):
        np.testing.assert_array_equal(_np(got[r]), np.asarray(want[r]))


def _ce_inputs(d, V, seed):
    D, T = 16, 64
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((V, D)) * 0.5).astype(np.float32)
    h = rng.standard_normal((T, D)).astype(np.float32)
    tgt = rng.integers(0, V, T).astype(np.int32)
    valid = rng.uniform(size=T) > 0.25
    return w, h, tgt, valid


@pytest.mark.parametrize("V", [96, 97])
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_ce_and_grads_match_jax(d, V):
    """Loss, and the gradients in the hidden rows and in the head (``V =
    97``: unequal blocks here, the reference's padded rows masked by
    ``vocab_true``)."""
    w, h, tgt, valid = _ce_inputs(d, V, d + V)
    T, D = h.shape
    pad = -V % d
    wp = np.concatenate([w, np.zeros((pad, D), np.float32)])

    def jloss(hh, ww):
        loss, n = jax.vmap(
            lambda a, b, c, e: jsp.sharded_ce(a, b, c, e, "x", vocab_true=V),
            axis_name="x")(hh.reshape(d, T // d, D),
                           ww.reshape(d, (V + pad) // d, D),
                           jnp.asarray(tgt).reshape(d, T // d),
                           jnp.asarray(valid).reshape(d, T // d))
        return loss[0], n[0]
    (jl, jn), (jgh, jgw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(wp))
    th = _t(h).requires_grad_(True)
    tw = _t(w).requires_grad_(True)
    loss, n = sp.sharded_ce(list(th.split(T // d)), tw,
                            [_t(a).long() for a in _split(tgt, d)],
                            [_t(a) for a in _split(valid, d)], d)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(n) == float(jn) == valid.sum()
    loss.backward()
    np.testing.assert_allclose(_np(th.grad), np.asarray(jgh), **GTOL)
    np.testing.assert_allclose(_np(tw.grad), np.asarray(jgw)[:V], **GTOL)


def test_summed_lse_is_caught():
    w, h, tgt, valid = _ce_inputs(2, 96, 0)
    args = ([_t(a) for a in _split(h, 2)], _t(w),
            [_t(a).long() for a in _split(tgt, 2)],
            [_t(a) for a in _split(valid, 2)], 2)
    good, _ = sp.sharded_ce(*args)
    with sp_fault("lse summed"):
        bad, _ = sp.sharded_ce(*args)
    assert abs(float(bad) - float(good)) > 1e-2 * abs(float(good))


# ---------------------------------------------------------------------------
# the SSM prefix scan

@functools.lru_cache(maxsize=None)
def _mamba(arch="hymba-1.5b"):
    jcfg = jget(arch).reduced(n_layers=2)
    cfg = get_arch(arch).reduced(n_layers=2)
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(7)))
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), raw["layers"]["mamba"])
    tp = layer_params(from_jax(cfg, raw, device="cpu"), 1)["mamba"]
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("d", [2, 4])
def test_ssm_prefix_scan_matches_jax(d):
    """The port's fold over its ranks' gated scans against the reference's
    ``make_sp_ssm_scan`` on the decays and inputs the port's scan defines
    (resets at a block boundary and inside a block, pad rows in the last
    block that leave the state alone): outputs, the final state, and the
    gradients in the inputs and ``h0``."""
    jcfg, cfg, jp, tp = _mamba()
    s = cfg.spec
    di, ds, R = s.inner, s.ssm_state, tssm.dt_rank_of(cfg)
    T = 32 * d
    b = T // d
    seg, pos = _packed(T, [b + 5, b - 5, T - 2 * b - 9], ctx=17)
    rng = np.random.default_rng(d)
    xc, z = (rng.standard_normal((T, di)).astype(np.float32)
             for _ in range(2))
    dt_in = rng.standard_normal((T, R)).astype(np.float32)
    B, C = (rng.standard_normal((T, ds)).astype(np.float32)
            for _ in range(2))
    h0 = rng.standard_normal((di, ds)).astype(np.float32)
    w_out = rng.standard_normal((T, di)).astype(np.float32)
    w_h = rng.standard_normal((di, ds)).astype(np.float32)
    live = seg >= 0
    reset = (pos == 0) & live

    def jfun(xc, dt_in, B, C, z, h0):
        delta = jax.nn.softplus(dt_in @ jp["dt_proj"] + jp["dt_bias"])
        delta = jnp.where(jnp.asarray(live)[:, None], delta, 0.0)
        A = -jnp.exp(jp["a_log"])
        a = jnp.exp(delta[:, :, None] * A[None])
        a = jnp.where(jnp.asarray(reset)[:, None, None], 0.0, a)
        bx = delta[:, :, None] * B[:, None, :] * xc[:, :, None]
        scan = jsp.make_sp_ssm_scan("x", d, jssm._blocked_ssm)
        hs, hl = jax.vmap(lambda aa, bb: scan(aa, bb, h0), axis_name="x")(
            a.reshape(d, b, di, ds), bx.reshape(d, b, di, ds))
        y = jnp.einsum("tds,ts->td", hs.reshape(T, di, ds), C)
        y = (y + jp["d_skip"] * xc) * jax.nn.silu(z)
        return jnp.sum(y * w_out) + jnp.sum(hl[0] * w_h), (y, hl[0])
    (_, (jy, jh)), jg = jax.jit(jax.value_and_grad(
        jfun, argnums=tuple(range(6)), has_aux=True))(
            *(jnp.asarray(a) for a in (xc, dt_in, B, C, z, h0)))
    ins = [_t(a).requires_grad_(True) for a in (xc, dt_in, B, C, z, h0)]
    shards = [sp.ScanShard(*[t[r * b:(r + 1) * b] for t in ins[:5]],
                           _t(live[r * b:(r + 1) * b]),
                           _t(reset[r * b:(r + 1) * b]))
              for r in range(d)]
    outs, h_last = sp.make_sp_ssm_scan()(tp, shards, ins[5])
    y = torch.cat(outs)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(h_last), np.asarray(jh), **TOL)
    ((y * _t(w_out)).sum() + (h_last * _t(w_h)).sum()).backward()
    for t, g in zip(ins, jg):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), **GTOL)


def _mixer_case(d, T, lengths, ctx, seed):
    jcfg, cfg, jp, tp = _mamba()
    s = cfg.spec
    seg, pos = _packed(T, lengths, ctx=ctx)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, s.d_model)).astype(np.float32)
    h0 = rng.standard_normal((s.inner, s.ssm_state)).astype(np.float32)
    tail = rng.standard_normal((s.ssm_conv - 1, s.inner)).astype(np.float32)
    ws = [rng.standard_normal(a.shape).astype(np.float32)
          for a in (np.zeros((T, s.d_model)), h0, tail)]
    return jcfg, cfg, jp, tp, seg, pos, x, h0, tail, ws


def _port_mixer(cfg, tp, seg, pos, x, h0, tail, ws, d):
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx, th, tt = (_t(a).requires_grad_(True) for a in (x, h0, tail))
    if d is None:
        out, h, t = tssm.mamba_apply(cfg, p, tx, pos=_t(pos), seg=_t(seg),
                                     state=th, conv_tail=tt)
    else:
        outs, h, t = tssm.mamba_apply_sp(
            cfg, p, list(tx.split(len(x) // d)),
            poss=list(_t(pos).split(len(x) // d)),
            segs=list(_t(seg).split(len(x) // d)), state=th, conv_tail=tt,
            scan_fn=sp.make_sp_ssm_scan(),
            tail_exchange=sp.make_sp_conv_tail_exchange())
        out = torch.cat(outs)
    ((out * _t(ws[0])).sum() + (h * _t(ws[1])).sum()
     + (t * _t(ws[2])).sum()).backward()
    grads = {"x": tx.grad, "h0": th.grad, "tail": tt.grad,
             **{k: v.grad for k, v in p.items()}}
    return out, h, t, grads


@pytest.mark.parametrize("d", [2, 4])
def test_conv_halo_and_scan_match_the_jax_whole_chunk(d):
    """The mixer over ``d`` blocks (a sequence continuing from a carried
    state and tail, one starting two rows before a block boundary, one
    inside a block; no pad rows) against the JAX mixer over the whole
    chunk: outputs, state and tail handed on, every gradient."""
    T = 32 * d
    b = T // d
    lengths = [b - 2, b // 2 + 7]
    lengths.append(T - sum(lengths))
    jcfg, cfg, jp, tp, seg, pos, x, h0, tail, ws = _mixer_case(
        d, T, lengths, 30, d)
    tail_t = np.concatenate([tail, np.zeros((0, tail.shape[1]))])

    def jloss(p, x, h0, tl):
        out, h, t = jssm.mamba_apply(jcfg, p, x, pos=jnp.asarray(pos),
                                     state=h0, conv_tail=tl)
        return (jnp.sum(out * ws[0]) + jnp.sum(h * ws[1])
                + jnp.sum(t * ws[2])), (out, h, t)
    (_, (jo, jh, jt)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(
            jp, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(tail_t))
    out, h, t, g = _port_mixer(cfg, tp, seg, pos, x, h0, tail, ws, d)
    for a, b_ in ((jo, out), (jh, h), (jt, t)):
        np.testing.assert_allclose(_np(b_), np.asarray(a), **TOL)
    for name, jgv in jg[0].items():
        want = np.asarray(jgv)
        if name in DENSE_LEAVES:
            want = want.T
        np.testing.assert_allclose(_np(g[name]), want, err_msg=name, **GTOL)
    for name, jgv in zip(("x", "h0", "tail"), jg[1:]):
        np.testing.assert_allclose(_np(g[name]), np.asarray(jgv),
                                   err_msg=name, **GTOL)


@pytest.mark.parametrize("d", [2, 4])
def test_padded_last_rank_equals_the_unsharded_mixer(d):
    """A chunk whose pad rows fill its last rank (and part of the one
    before): the blocks' mixer equals the port's unsharded one, whose pad
    rows leave the state and tail alone; two planted faults (the halo from
    the rank's own rows, the fold skipping ``a_prod``) do not."""
    T = 32 * d
    b = T // d
    live = T - b - 6
    lengths = [live // 2 + 3, live - live // 2 - 3]
    args = _mixer_case(d, T, lengths, 12, 20 + d)[1:]
    cfg, tp, seg, pos, x, h0, tail, ws = args[0], *args[2:]
    assert (seg[-b:] < 0).all()
    # the loss reads live rows only (a pad row's conv window differs: the
    # halo skips pad rows; no live row reads a pad row's output)
    ws[0][seg < 0] = 0.0
    want = _port_mixer(cfg, tp, seg, pos, x, h0, tail, ws, None)
    got = _port_mixer(cfg, tp, seg, pos, x, h0, tail, ws, d)
    live = seg >= 0
    np.testing.assert_allclose(_np(got[0])[live], _np(want[0])[live], **TOL)
    for a, b_ in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(_np(a), _np(b_), **TOL)
    for name in want[3]:
        np.testing.assert_allclose(_np(got[3][name]), _np(want[3][name]),
                                   err_msg=name, **GTOL)
    for fault in ("halo from own rows", "fold skips a_prod"):
        with sp_fault(fault):
            bad = _port_mixer(cfg, tp, seg, pos, x, h0, tail, ws, d)
        err = max(float(np.abs(_np(bad[0])[live] - _np(want[0])[live]).max()),
                  float(np.abs(_np(bad[1]) - _np(want[1])).max()))
        assert err > 1e-3, (fault, err)


# ---------------------------------------------------------------------------
# expert parallelism

@pytest.mark.parametrize("d", [2, 4])
def test_moe_ep_matches_jax(d):
    jcfg = jget("olmoe-1b-7b").reduced(n_layers=1)
    cfg = get_arch("olmoe-1b-7b").reduced(n_layers=1)
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(2)))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), raw["layers"]["moe"])
    tp = layer_params(from_jax(cfg, raw, device="cpu"), 0)["moe"]
    s = cfg.spec
    T = 16 * d
    x = np.random.default_rng(d).standard_normal((T, s.d_model)).astype(
        np.float32)
    experts = ("w_gate", "w_up", "w_down")
    sharded = {k: (v.reshape(d, -1, *v.shape[1:]) if k in experts else v)
               for k, v in jp.items()}
    axes = {k: (0 if k in experts else None) for k in jp}
    moe_fn = jep.make_moe_ep("x", d)
    want = jax.vmap(lambda p, xx: moe_fn(jcfg, p, xx), in_axes=(axes, 0),
                    axis_name="x")(sharded,
                                   jnp.asarray(x).reshape(d, T // d, -1))
    got = ep.make_moe_ep(d)(cfg, tp, [_t(a) for a in _split(x, d)])
    for r in range(d):
        np.testing.assert_allclose(_np(got[r]), np.asarray(want[r]), **TOL)
