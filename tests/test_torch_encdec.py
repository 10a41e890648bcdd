"""Port parity: the encoder-decoder (seamless-m4t-v2: ``models/encdec.py``,
the cross-attention op, ``runtime/encdec_pipeline.py`` and
``train_step.EncDecTrainer``) against the JAX package, on the CPU, float32,
inputs from numpy seeds.

Reduced seamless-m4t-v2 (``reduced(n_layers=2, d_model=64, n_heads=4,
head_dim=16, vocab=256)``: 2 encoder and 2 decoder layers, 4 query heads
and 2 KV heads of 16), weights from ``EncDecLM.init`` carried across with
``weights.from_jax``. The tolerance is 1e-5 relative for float32
(``RTOL``; each gradient leaf within 1e-5 of its largest value):

* an encoder layer against ``enc_layer_apply`` (non-causal: a causal
  encoder falls outside), ``cross_attend`` and a decoder layer against
  theirs, on live rows (a pad row, which attends to nothing, is zero in the
  port and the mean of V in the reference);
* ``EncDecLM.loss`` and its gradients against ``jax.value_and_grad``;
* the port's plain non-causal and cross attention (``T != S``, ``S``
  below and above ``T``) against ``flash_attention_pallas(causal=False)``
  in interpret mode, and their gradients against ``jax.grad``;
* the pipelined trainer (``tests/test_torch_encdec_pipeline.py``, which
  imports this file's cases and checks, so that the two files run side by
  side under ``pytest -n``);
* the stage layout against ``encoder_stage_split`` and the reference's
  grouped stacking; ``d_p = 1`` refused, by the layout and by the CLI.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import EncDecLM as JEncDec
from repro_torch.configs import get_arch
from repro_torch.kernels import ref as tref
from repro_torch.models import EncDecLM
from repro_torch.weights import from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

SMALL = dict(n_layers=2, d_model=64, n_heads=4, head_dim=16, vocab=256)
RTOL = 1e-5
ARCH = "seamless-m4t-v2"


@functools.lru_cache(maxsize=None)
def _model(seed=5):
    jcfg = jget(ARCH).reduced(**SMALL)
    cfg = get_arch(ARCH).reduced(**SMALL)
    raw = jax.tree.map(np.asarray,
                       JEncDec(jcfg).init(jax.random.PRNGKey(seed),
                                          jnp.float32))
    return jcfg, cfg, raw


def _params(cfg, raw):
    return from_jax(cfg, raw, device="cpu")


def _packed(lens, pad):
    """seg / pos of sequences of ``lens`` rows packed, then ``pad`` pad
    rows (seg -1)."""
    seg = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lens)]
                         + [np.full(pad, -1, np.int32)])
    pos = np.concatenate([np.arange(n, dtype=np.int32) for n in lens]
                         + [np.zeros(pad, np.int32)])
    return seg, pos


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, (err, rtol)
    return err


def _jlayer(tree, i):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), tree)


# ---------------------------------------------------------------------------
# layers

def test_encoder_layer_matches_jax_and_is_non_causal():
    jcfg, cfg, raw = _model()
    rng = np.random.default_rng(0)
    seg, pos = _packed([40, 17], 7)
    x = rng.normal(0, 1, (len(seg), 64)).astype(np.float32)
    want = JEncDec(jcfg).enc_layer_apply(_jlayer(raw["enc_layers"], 1),
                                         jnp.asarray(x), seg=jnp.asarray(seg),
                                         pos=jnp.asarray(pos))
    model, p = EncDecLM(cfg), _params(cfg, raw)
    t = [torch.from_numpy(a) for a in (x, seg, pos)]
    got = model.enc_layer_apply(p["enc_layers"][1], t[0], seg=t[1], pos=t[2])
    live = seg >= 0
    _close(got.numpy()[live], np.asarray(want)[live])
    # a causal encoder is another function: far outside the tolerance
    from repro_torch.models import attention
    blk = attention.attention_block

    def causal_block(*a, **kw):
        return blk(*a, **dict(kw, causal=True))
    import repro_torch.models.encdec as encdec
    encdec.attention_block = causal_block
    try:
        bad = model.enc_layer_apply(p["enc_layers"][1], t[0], seg=t[1],
                                    pos=t[2])
    finally:
        encdec.attention_block = blk
    with pytest.raises(AssertionError):
        _close(bad.numpy()[live], np.asarray(want)[live], rtol=1e-2)


@pytest.mark.parametrize("S_lens", [(12, 30), (33, 21), (50, 70)])
def test_cross_attend_and_decoder_layer_match_jax(S_lens):
    """T = 24 + 20 token rows (and 4 pad rows) against S frames of the two
    segments: fewer, as many or more than the tokens."""
    jcfg, cfg, raw = _model()
    rng = np.random.default_rng(sum(S_lens))
    seg, pos = _packed([24, 20], 4)
    seg_m, _ = _packed(list(S_lens), 3)
    x = rng.normal(0, 1, (len(seg), 64)).astype(np.float32)
    mem = rng.normal(0, 1, (len(seg_m), 64)).astype(np.float32)
    jm = JEncDec(jcfg)
    lp = _jlayer(raw["dec_layers"], 0)
    J = dict(seg=jnp.asarray(seg), pos=jnp.asarray(pos))
    want_x = jm.cross_attend(lp["cross"], jnp.asarray(x), jnp.asarray(mem),
                             seg_q=J["seg"], seg_mem=jnp.asarray(seg_m))
    from repro.models.model import LayerCtx
    want_l, _ = jm.dec_layer_apply(
        lp, jnp.asarray(x), pos=J["pos"], seg=J["seg"],
        memory=jnp.asarray(mem), seg_mem=jnp.asarray(seg_m),
        ctx=LayerCtx(None, None, None, None), ctx_len=jnp.int32(0))
    model, p = EncDecLM(cfg), _params(cfg, raw)
    t = {k: torch.from_numpy(a) for k, a in
         dict(x=x, seg=seg, pos=pos, mem=mem, seg_m=seg_m).items()}
    got_x = model.cross_attend(p["dec_layers"][0]["cross"], t["x"], t["mem"],
                               seg_q=t["seg"], seg_mem=t["seg_m"])
    got_l = model.dec_layer_apply(p["dec_layers"][0], t["x"], pos=t["pos"],
                                  seg=t["seg"], memory=t["mem"],
                                  seg_mem=t["seg_m"])
    live = seg >= 0
    _close(got_x.numpy()[live], np.asarray(want_x)[live])
    _close(got_l.numpy()[live], np.asarray(want_l)[live])


def test_cross_attention_keeps_the_memory_not_its_keys():
    """Under autograd the op keeps the memory rows ``[S, D]`` (and q), not
    the projected keys and values ``[S, Hkv, Dh]``; its gradients are
    autograd's of the same products."""
    from repro_torch.models.attention import cross_attention
    g = torch.Generator().manual_seed(1)
    T, S, D, H, Dh = 20, 28, 64, 2, 16
    q = torch.randn(T, 4, Dh, generator=g, requires_grad=True)
    mem = torch.randn(S, D, generator=g, requires_grad=True)
    wk = torch.randn(H * Dh, D, generator=g, requires_grad=True)
    wv = torch.randn(H * Dh, D, generator=g, requires_grad=True)
    seg_q, _ = _packed([12, 8], 0)
    seg_m, _ = _packed([15, 13], 0)
    seg_q, seg_m = torch.from_numpy(seg_q), torch.from_numpy(seg_m)
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        y = cross_attention(q, mem, wk, wv, seg_q, seg_m, heads=H,
                            scale=0.25)
    assert (S, D) in shapes and (S, H, Dh) not in shapes
    (y * y).sum().backward()
    got = [t.grad.clone() for t in (q, mem, wk, wv)]
    for t in (q, mem, wk, wv):
        t.grad = None
    k = torch.nn.functional.linear(mem, wk).reshape(S, H, Dh)
    v = torch.nn.functional.linear(mem, wv).reshape(S, H, Dh)
    z = lambda n: torch.zeros(n, dtype=torch.int32)  # noqa: E731
    want = tref.flash_attention_reference(q, k, v, seg_q, seg_m, z(T), z(S),
                                          causal=False, scale=0.25)
    (want * want).sum().backward()
    for a, t in zip(got, (q, mem, wk, wv)):
        _close(a.numpy(), t.grad.numpy())


@pytest.mark.parametrize("T,S", [(64, 32), (64, 96), (96, 96)])
def test_plain_noncausal_and_cross_attention_match_pallas(T, S):
    """The port's plain attention, non-causal (the encoder's: T = S, the
    frames' positions) and cross (T != S, zero positions), against the
    Pallas kernel in interpret mode with ``causal=False``, and its
    gradient against ``jax.grad`` of the JAX reference attention."""
    rng = np.random.default_rng(T + S)
    Hq, Hkv, Dh = 4, 2, 16
    seg_q, pos_q = _packed([T // 2 + 3, T // 2 - 9], 6)
    if T == S:
        seg_kv, pos_kv = seg_q, pos_q
    else:
        seg_kv, _ = _packed([S // 2 - 5, S // 2 + 1], 4)
        pos_q, pos_kv = np.zeros(T, np.int32), np.zeros(S, np.int32)
    q = rng.standard_normal((T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((S, Hkv, Dh)).astype(np.float32)
    dout = rng.standard_normal((T, Hq, Dh)).astype(np.float32)
    meta = (seg_q, seg_kv, pos_q, pos_kv)
    pal = np.asarray(flash_attention_pallas(
        *map(jnp.asarray, (q, k, v, *meta)), causal=False, scale=0.25,
        block_q=32, block_kv=32, interpret=True))
    targs = [torch.from_numpy(a) for a in (q, k, v, *meta)]
    live = seg_q >= 0
    for got in (tref.blocked_flash_attention(*targs, causal=False,
                                             scale=0.25, block_kv=32),
                tref.flash_attention_reference(*targs, causal=False,
                                               scale=0.25)):
        np.testing.assert_allclose(got.numpy()[live], pal[live], rtol=2e-5,
                                   atol=2e-5)
    causal = tref.flash_attention_reference(*targs, causal=True, scale=0.25)
    if T == S:      # the encoder's positions: a causal limit shows
        assert np.abs(causal.numpy()[live] - pal[live]).max() > 1e-2

    def f(qq, kk, vv):
        o = jref.flash_attention_reference(qq, kk, vv,
                                           *map(jnp.asarray, meta),
                                           causal=False, scale=0.25)
        return (o * jnp.asarray(dout * live[:, None, None])).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = tref.flash_attention_grad(
        *targs, torch.from_numpy(dout * live[:, None, None]), causal=False,
        scale=0.25)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# the loss

def _loss_inputs(seed=3, lens=(30, 21, 9), pad=4):
    rng = np.random.default_rng(seed)
    seg, pos = _packed(list(lens), pad)
    T = len(seg)
    tokens = np.where(seg >= 0, rng.integers(0, 256, T), 0).astype(np.int32)
    targets = np.where(seg >= 0, rng.integers(0, 256, T), -1).astype(np.int32)
    targets[np.cumsum(lens) - 1] = -1
    frames = np.where((seg >= 0)[:, None],
                      rng.normal(0, 0.5, (T, 64)), 0).astype(np.float32)
    return frames, seg, pos, tokens, targets


def test_loss_and_grads_match_jax():
    jcfg, cfg, raw = _model()
    frames, seg, pos, tokens, targets = _loss_inputs()
    jm = JEncDec(jcfg)

    def f(p):
        loss, n = jm.loss(p, *map(jnp.asarray, (frames, seg, pos, tokens,
                                                targets, seg, pos)),
                          compute_dtype=jnp.float32)
        return loss / n
    jl, jg = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, raw))
    model = EncDecLM(cfg)
    p = _params(cfg, raw)
    from repro_torch.models.model import tree_leaves, tree_map
    p = tree_map(lambda a: a.requires_grad_(True), p)
    t = [torch.from_numpy(a) for a in (frames, seg, pos, tokens, targets)]
    loss, n = model.loss(p, t[0], t[1], t[2], t[3].long(), t[4].long(), t[1],
                         t[2], compute_dtype=torch.float32)
    (loss / n).backward()
    _close(float((loss / n).detach()), float(jl))
    want = _params(cfg, jax.tree.map(np.asarray, jg))
    for a, b in zip(tree_leaves(p), tree_leaves(want)):
        _close(a.grad.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the stage layout

@pytest.mark.parametrize("d_p", [2, 3, 4, 6])
@pytest.mark.parametrize("n_enc,n_dec", [(24, 24), (2, 2), (6, 3)])
def test_stage_layout_matches_encoder_stage_split(d_p, n_enc, n_dec):
    from repro.core.checkpointing import encoder_stage_split
    from repro.runtime.sharding import stack_grouped_stages
    from repro_torch.runtime.sharding import encdec_stage_layers
    enc_st, dec_st = encoder_stage_split(n_enc, n_dec, d_p)
    layout = encdec_stage_layers(n_enc, n_dec, d_p)
    assert [r for r, _ in layout] == ["encoder"] * enc_st + \
        ["decoder"] * dec_st
    L_ps = max(-(-n_enc // enc_st), -(-n_dec // dec_st))
    stacked = np.asarray(stack_grouped_stages(
        [({"a": jnp.arange(1, n_enc + 1)}, enc_st),
         ({"a": jnp.arange(1, n_dec + 1)}, dec_st)], L_ps)["a"])
    for (role, ids), row in zip(layout, stacked):
        assert [i + 1 for i in ids] == [int(x) for x in row if x]
    assert sorted(i for r, ids in layout if r == "encoder" for i in ids) \
        == list(range(n_enc))
    assert sorted(i for r, ids in layout if r == "decoder" for i in ids) \
        == list(range(n_dec))


def test_one_stage_is_refused():
    from repro_torch.runtime.encdec_pipeline import EncDecGeometry
    from repro_torch.runtime.sharding import encdec_stage_layers
    with pytest.raises(ValueError, match="encoder_stage_split"):
        encdec_stage_layers(24, 24, 1)
    with pytest.raises(ValueError, match="d_p >= 2"):
        EncDecGeometry(d_p=1)
    with pytest.raises(ValueError, match="v_stages=1"):
        EncDecGeometry(d_p=2, schedule="interleaved-1f1b", v_stages=2)
    from repro_torch.launch.train import main
    assert main(["--device", "cpu", "--arch", ARCH, "--reduced",
                 "--steps", "1", "--batch", "2", "--context", "64",
                 "--mesh", "1x1"]) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recompute_swiglu_is_bitwise_and_its_store_keeps_x_and_dy(dtype):
    """The encoder-decoder's MLP (``swiglu_apply(..., recompute=True)``,
    which keeps only its input) gives the bits of the MLP that keeps its
    gate and up projections, output and gradients; under the split
    backward its weight gradients come out of the store with the same
    bits, and until then the store holds ``x`` and ``dy`` (rows of D), no
    ``[T, d_ff]`` tensor."""
    from repro_torch.models.layers import deferred_weight_grads, swiglu_apply
    g = torch.Generator().manual_seed(3)
    T, D, F = 37, 16, 48
    x = torch.randn(T, D, generator=g).to(dtype).requires_grad_(True)
    p = {k: (torch.randn(s, generator=g) * 0.3).to(dtype).requires_grad_(True)
         for k, s in (("w_gate", (F, D)), ("w_up", (F, D)),
                      ("w_down", (D, F)))}
    dy = torch.randn(T, D, generator=g).to(dtype)
    leaves = [x, *p.values()]

    def run(recompute, store=None):
        for t in leaves:
            t.grad = None
        with deferred_weight_grads(store):
            y = swiglu_apply(p, x * 1, recompute=recompute)
            y.backward(dy)
        return [y.detach()] + [None if t.grad is None else t.grad.clone()
                               for t in leaves]
    want, got = run(False), run(True)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    store = []
    split = run(True, store)
    assert torch.equal(split[1], want[1]) and split[2:] == [None] * 3
    rows = [c.cell_contents for _, f in store
            for c in f.func.__closure__ or ()
            if isinstance(c.cell_contents, torch.Tensor)
            and c.cell_contents.shape[0] == T]      # not the weights
    assert rows and all(tuple(t.shape) == (T, D) for t in rows)
    made = {id(w): f() for w, f in store}
    for w, grad in zip(p.values(), want[2:]):
        assert torch.equal(made[id(w)], grad)
