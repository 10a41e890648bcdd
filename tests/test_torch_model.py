"""Port parity: the PyTorch model against the JAX ``DecoderLM``.

Same parameters (the JAX init, bridged through ``repro_torch.weights``),
same numpy inputs, float32, ``rtol = atol = 1e-5``: ``rms_norm``, rope,
``swiglu``, ``project_qkv``, ``layer_apply`` and ``forward_chunk`` with
and without a split-chunk context carry, on reduced gemma3-1b (6 layers,
so layer 5 is a global layer among window-8 locals), reduced llama3.2-3b
and reduced olmoe-1b-7b (4 experts, top-2: the MoE block by dispatch
against the reference's dense one). Plus the weight bridge for both
reference layouts (the stacked experts and the router included), and
its round trip through the pipeline's stage dicts (``to_stages``, then
``from_stages``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import DecoderLM as JaxDecoderLM
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.runtime.sharding import stack_stages
from repro.runtime.train_step import _pad_vocab
from repro_torch.configs import get_arch
from repro_torch.models import DecoderLM, layer_params
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import LayerCtx, unstack_layers
from repro_torch.weights import DENSE_LEAVES, from_jax, from_stages, to_stages
from test_torch_threads import torch_thread_share  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

ARCHS = {
    "gemma3-1b": dict(n_layers=6),
    "llama3.2-3b": dict(),
    "olmoe-1b-7b": dict(),
}


def _cfgs(name):
    kw = ARCHS[name]
    return jax_get_arch(name).reduced(**kw), get_arch(name).reduced(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    jcfg, tcfg = _cfgs(request.param)
    raw = _np_tree(JaxDecoderLM(jcfg).init(jax.random.PRNGKey(5)))
    return jcfg, tcfg, raw, from_jax(tcfg, raw, device="cpu")


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                               **(tol or TOL))


def _packed(T, n_seq, seed, ctx=0):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, T), n_seq - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [T]])
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    for s in range(n_seq):
        a, b = bounds[s], bounds[s + 1]
        seg[a:b] = s
        pos[a:b] = np.arange(b - a) + (ctx if s == 0 else 0)
    return seg, pos


def test_rms_norm_rope_swiglu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 3, 32)).astype(np.float32)
    g = rng.standard_normal(32).astype(np.float32) * 0.1
    _close(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(g)),
           tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(g)))
    pos = rng.integers(0, 300, 12).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               tlayers.apply_rope(torch.from_numpy(x),
                                  torch.from_numpy(pos), theta))
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.2 for n, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    h = rng.standard_normal((7, 32)).astype(np.float32)
    tp = {n: torch.from_numpy(np.ascontiguousarray(w.T))
          for n, w in p.items()}
    _close(jlayers.swiglu_apply({n: jnp.asarray(w) for n, w in p.items()},
                                jnp.asarray(h)),
           tlayers.swiglu_apply(tp, torch.from_numpy(h)))


def test_project_qkv(arch):
    jcfg, tcfg, raw, tparams = arch
    rng = np.random.default_rng(1)
    x = rng.standard_normal((10, jcfg.spec.d_model)).astype(np.float32)
    pos = rng.integers(0, 50, 10).astype(np.int32)
    jp = jax.tree.map(lambda a: a[2], raw["layers"])["attn"]
    tp = layer_params(tparams, 2)["attn"]
    for a, b in zip(jattn.project_qkv(jcfg, jp, jnp.asarray(x),
                                      jnp.asarray(pos)),
                    tattn.project_qkv(tcfg, tp, torch.from_numpy(x),
                                      torch.from_numpy(pos))):
        _close(a, b)


@pytest.mark.parametrize("layer", [0, 5])
def test_layer_apply(arch, layer):
    jcfg, tcfg, raw, tparams = arch
    layer = min(layer, jcfg.spec.n_layers - 1)
    T = 24
    seg, pos = _packed(T, 3, seed=layer)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, jcfg.spec.d_model)).astype(np.float32)
    w = jcfg.layer_window(layer)
    jl = JaxDecoderLM(jcfg)
    jp = jax.tree.map(lambda a: a[layer], raw["layers"])
    ctx = LayerCtx(None, None)
    ya, _ = jl.layer_apply(jp, jnp.asarray(x), pos=jnp.asarray(pos),
                           seg=jnp.asarray(seg),
                           ctx=type(jl.init_ctx(1, jnp.float32))(
                               None, None, None, None),
                           ctx_len=jnp.int32(0), window=w)
    yb, _ = DecoderLM(tcfg).layer_apply(
        layer_params(tparams, layer), torch.from_numpy(x),
        pos=torch.from_numpy(pos), seg=torch.from_numpy(seg), ctx=ctx,
        ctx_len=0, window=w)
    _close(ya, yb)


def test_forward_chunk_without_context(arch):
    jcfg, tcfg, raw, tparams = arch
    T = 40
    seg, pos = _packed(T, 3, seed=3)
    tokens = np.random.default_rng(3).integers(
        0, jcfg.spec.vocab, T).astype(np.int32)
    xa, _ = JaxDecoderLM(jcfg).forward_chunk(
        raw, jnp.asarray(tokens), jnp.asarray(seg), jnp.asarray(pos),
        compute_dtype=jnp.float32)
    xb, ctx = DecoderLM(tcfg).forward_chunk(
        tparams, torch.from_numpy(tokens).long(), torch.from_numpy(seg),
        torch.from_numpy(pos), compute_dtype=torch.float32)
    assert ctx is None
    _close(xa, xb)


def test_forward_chunk_with_context_carry(arch):
    """Two split chunks of one sequence: the second attends to the
    first's KV rows through the carry (window-masked on gemma3)."""
    jcfg, tcfg, raw, tparams = arch
    cap, T1, T2 = 48, 20, 16
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.spec.vocab, T1 + T2).astype(np.int32)
    jl, tl = JaxDecoderLM(jcfg), DecoderLM(tcfg)
    jctx = jl.init_ctx(cap, jnp.float32)
    tctx = tl.init_ctx(cap, torch.float32, device="cpu")
    off = 0
    for T in (T1, T2):
        tok = tokens[off:off + T]
        seg2, pos2 = _packed(T, 2, seed=T, ctx=off)
        xa, jctx = jl.forward_chunk(
            raw, jnp.asarray(tok), jnp.asarray(seg2), jnp.asarray(pos2),
            ctx=jctx, ctx_len=off, compute_dtype=jnp.float32)
        xb, tctx = tl.forward_chunk(
            tparams, torch.from_numpy(tok).long(), torch.from_numpy(seg2),
            torch.from_numpy(pos2), ctx=tctx, ctx_len=off,
            compute_dtype=torch.float32)
        _close(xa, xb)
        _close(jctx.k, tctx.k)
        _close(jctx.v, tctx.v)
        off += T


def test_bridge_raw_layout(arch):
    jcfg, tcfg, raw, tparams = arch
    s = jcfg.spec
    assert sorted(tparams) == sorted(raw)
    for name, a in raw["layers"]["attn"].items():
        b = tparams["layers"]["attn"][name].numpy()
        want = np.swapaxes(a, -1, -2) if name in DENSE_LEAVES else a
        np.testing.assert_array_equal(b, want)
    if s.n_experts:
        moe = tparams["layers"]["moe"]
        assert "mlp" not in tparams["layers"]
        for name, a in raw["layers"]["moe"].items():
            np.testing.assert_array_equal(moe[name].numpy(),
                                          np.swapaxes(a, -1, -2))
        assert moe["w_gate"].shape == (s.n_layers, s.n_experts,
                                       s.d_ff_expert, s.d_model)
        assert moe["w_down"].shape == (s.n_layers, s.n_experts, s.d_model,
                                       s.d_ff_expert)
        assert moe["router"].shape == (s.n_layers, s.n_experts, s.d_model)
    else:
        assert tparams["layers"]["mlp"]["w_down"].shape == (
            s.n_layers, s.d_model, s.d_ff)
    np.testing.assert_array_equal(tparams["embed"].numpy(), raw["embed"])
    _assert_stage_round_trip(tcfg, tparams, d_p=2)


def _assert_stage_round_trip(tcfg, params, d_p, v=1):
    """``to_stages`` then ``from_stages`` gives back every tensor."""
    back = from_stages(tcfg, to_stages(tcfg, params, d_p, v))
    want = unstack_layers(params)
    assert sorted(back) == sorted(want)
    flat_a, flat_b = jax.tree.leaves(back), jax.tree.leaves(want)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d_p,d_s", [(1, 1), (4, 3)])
def test_bridge_stage_layout(arch, d_p, d_s):
    """Stage-stacked ``[d_p, L_s, ...]`` leaves (with inert pad slots) and
    a vocab padded to ``d_s`` bridge to the same tensors as the raw
    layout."""
    jcfg, tcfg, raw, tparams = arch
    staged = {
        "stages": _np_tree(stack_stages(raw["layers"], d_p,
                                        jcfg.spec.n_layers)),
        "embed": np.asarray(_pad_vocab(jnp.asarray(raw["embed"]), d_s)),
        "final_norm": raw["final_norm"],
    }
    if "unembed" in raw:
        staged["unembed"] = np.asarray(_pad_vocab(jnp.asarray(
            raw["unembed"]), d_s))
    lead = jax.tree.leaves(staged["stages"])[0].shape[:2]
    assert lead == (d_p, -(-jcfg.spec.n_layers // d_p))
    got = from_jax(tcfg, staged, device="cpu")
    flat_a = jax.tree.leaves(got)
    flat_b = jax.tree.leaves(tparams)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert torch.equal(a, b)
    _assert_stage_round_trip(tcfg, got, d_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_gate_row_blocks_give_the_same_bits(monkeypatch, dtype):
    """``silu(g) * u`` and its gradient, computed over blocks of rows to
    bound the float32 temporaries, give the same bits as over the whole
    tensor (elementwise; blocks of whole 64-element vectors, so that the
    CPU's vectorised loops have no scalar tail), and the gradient is JAX's
    (float32). Through the fused down projection with an identity weight
    (a product with 1 and 0s: the gate's own bits)."""
    rng = np.random.default_rng(9)
    g0 = rng.standard_normal((37, 64)).astype(np.float32)
    u0 = rng.standard_normal((37, 64)).astype(np.float32)
    dy = torch.from_numpy(rng.standard_normal((37, 64)).astype(
        np.float32)).to(dtype)

    def run(rows):
        monkeypatch.setattr(tlayers, "SILU_BLOCK_BYTES", rows * 64 * 4)
        g, u = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                for a in (g0, u0))
        out = tlayers._SwiGLUDown.apply(g, u, torch.eye(64, dtype=dtype))
        out.backward(dy)
        return out.detach(), g.grad, u.grad
    whole, blocked = run(10 ** 6), run(5)
    for a, b in zip(whole, blocked):
        assert a.dtype == dtype and torch.equal(a, b)
    if dtype == torch.float32:
        def f(g, u):
            return jnp.sum(jax.nn.silu(g) * u * jnp.asarray(dy.numpy()))
        jg, ju = jax.grad(f, argnums=(0, 1))(jnp.asarray(g0), jnp.asarray(u0))
        _close(jg, whole[1])
        _close(ju, whole[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_backward_over_its_own_projections(monkeypatch, dtype):
    """Through ``swiglu_apply`` (g and u its own projections, which the
    backward overwrites with dg and du): the same bits as the backward
    that allocates them (the projections' outputs passed on as leaves),
    blocked or whole, and the leaves it was handed keep their values."""
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal((37, 32)).astype(np.float32)
    p0 = {n: rng.standard_normal(s).astype(np.float32) * 0.2 for n, s in
          (("w_gate", (64, 32)), ("w_up", (64, 32)), ("w_down", (32, 64)))}
    dy = torch.from_numpy(rng.standard_normal((37, 32)).astype(
        np.float32)).to(dtype)

    def run(rows, own):
        monkeypatch.setattr(tlayers, "SILU_BLOCK_BYTES", rows * 64 * 4)
        x = torch.from_numpy(x0).to(dtype).requires_grad_(True)
        p = {n: torch.from_numpy(w).to(dtype).requires_grad_(True)
             for n, w in p0.items()}
        if own:
            out = tlayers.swiglu_apply(p, x)
        else:
            g, u = (tlayers.linear(x, p[n]).detach().requires_grad_(True)
                    for n in ("w_gate", "w_up"))
            keep = (g.clone(), u.clone())
            out = tlayers._SwiGLUDown.apply(g, u, p["w_down"])
        out.backward(dy)
        if own:
            return out.detach(), p["w_down"].grad, p["w_gate"].grad, \
                p["w_up"].grad, x.grad
        assert torch.equal(g, keep[0]) and torch.equal(u, keep[1])
        dx = g.grad.mm(p["w_gate"].detach()) + u.grad.mm(p["w_up"].detach())
        return out.detach(), p["w_down"].grad, g.grad.t().mm(x.detach()), \
            u.grad.t().mm(x.detach()), dx
    want = run(10 ** 6, False)
    for rows in (10 ** 6, 5):
        for a, b in zip(want, run(rows, True)):
            assert a.dtype == dtype and torch.equal(a, b)


def test_tree_unflatten_holds_no_reference_cycle():
    """The tree ``tree_unflatten`` builds is freed as soon as its last
    reference goes, without the garbage collector: a trainer's gradient
    sums do not outlive its step (a cycle kept them a step longer)."""
    import gc
    import weakref

    from repro_torch.models.model import tree_unflatten
    template = {"b": [torch.zeros(2), {"c": torch.zeros(1)}],
                "a": torch.zeros(3)}
    leaves = [torch.ones(3), torch.ones(2), torch.ones(1)]
    refs = [weakref.ref(t) for t in leaves]
    gc.disable()
    try:
        tree = tree_unflatten(template, leaves)
        assert tree["a"] is leaves[0] and tree["b"][1]["c"] is leaves[2]
        del tree, leaves
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
