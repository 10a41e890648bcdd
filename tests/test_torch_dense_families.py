"""Port parity: the remaining decoder families against the JAX package, on
the CPU, float32, inputs from numpy seeds.

qwen3-4b (qk-norm), qwen2-vl-7b (M-RoPE; the vision stub's patches in
place of token embeddings) and stablelm-12b (untied head), each reduced
(``reduced(n_layers=2)``: d_model 64, 4 query heads and 2 KV heads of 16;
qwen2-vl's sections (4, 2, 2)). The JAX init is bridged through
``repro_torch.weights`` after every norm gain (``ln1``, ``ln2``,
``final_norm``, and qwen3-4b's ``q_norm`` and ``k_norm``) is drawn at
random, so that none of them is the identity. qwen2-vl-7b runs at true
3-D positions from ``mrope_positions_stub`` (an image span of 4 x 4
patches, then text) wherever the JAX function takes them.

* the port's registry is the JAX registry without seamless-m4t-v2, and
  its three new configs are the JAX configs, field for field;
* the weight bridge carries every leaf (qk-norm's gains, the untied
  ``unembed``);
* ``project_qkv`` (forward and ``jax.vjp``), ``forward_chunk`` on a packed
  chunk, and the split over two chunks with the KV carry against the JAX
  monolithic forward (``1e-5``);
* ``DecoderLM.loss`` and its gradient against ``jax.value_and_grad``
  (loss ``1e-5`` relative, each gradient leaf within ``1e-5`` of its
  largest value);
* ``ChunkedTrainer`` on a sequence split over 3 chunks with a non-zero
  remat table against ``jax.value_and_grad`` of the JAX loss over whole
  sequences (loss ``1e-5``, gradients ``rtol 1e-4, atol 1e-6``, as
  ``tests/test_torch_train.py``); the zeroed table gives the same bits;
* the vision path, layer by layer: token embeddings with the image span
  replaced by patch embeddings through each layer's ``layer_apply``
  (``1e-5`` after every layer); the same rows at text positions fall
  outside that limit, and so does qwen3-4b with its k-norm dropped.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_names as jax_arch_names
from repro.configs import get_arch as jget
from repro.models import DecoderLM as JLM
from repro.models import LayerCtx as JCtx
from repro.models import attention as jattn
from repro.models.frontends import vision_patch_stub as jax_patches
from repro_torch.configs import arch_names, get_arch
from repro_torch.core import ClusterSpec, CostModel, PlannerConfig, \
    plan_batch
from repro_torch.models import DecoderLM, layer_params
from repro_torch.models import attention as tattn
from repro_torch.models.frontends import mrope_positions_stub
from repro_torch.models.model import LayerCtx, tree_leaves, tree_map
from repro_torch.runtime.train_step import ChunkedTrainer
from repro_torch.weights import DENSE_LEAVES, from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

ARCHS = ("qwen3-4b", "qwen2-vl-7b", "stablelm-12b")
TOL = dict(rtol=1e-5, atol=1e-5)
# the image span of the qwen2-vl cases: a 4 x 4 grid of patches
GRID = (4, 4)
N_PATCH = GRID[0] * GRID[1]


@functools.lru_cache(maxsize=None)
def _model(arch, n_layers=2, seed=5):
    jcfg = jget(arch).reduced(n_layers=n_layers)
    cfg = get_arch(arch).reduced(n_layers=n_layers)
    raw = jax.tree.map(np.array, JLM(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    layers = raw["layers"]
    for tree, name in ((layers, "ln1"), (layers, "ln2"),
                       (raw, "final_norm"), (layers["attn"], "q_norm"),
                       (layers["attn"], "k_norm")):
        if name in tree:
            tree[name] = rng.normal(0.0, 0.3, tree[name].shape).astype(
                np.float32)
    return jcfg, cfg, raw


def _params(arch, n_layers=2):
    _, cfg, raw = _model(arch, n_layers)
    return from_jax(cfg, raw, device="cpu")


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                               **(tol or TOL))


def _positions3(arch, seg, pos):
    """qwen2-vl's ``[3, T]`` rows for a chunk whose segment 0 starts at
    row 0 with an image span: ``mrope_positions_stub`` on segment 0, text
    positions (``pos`` on each row) elsewhere; None for the other archs."""
    if arch != "qwen2-vl-7b":
        return None
    pos3 = np.stack([pos, pos, pos]).astype(np.int32)
    n0 = int((seg == 0).sum())
    pos3[:, :n0] = mrope_positions_stub(n0 - N_PATCH, N_PATCH, GRID).numpy()
    return pos3


def _packed(T, n_seq, seed):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(N_PATCH + 4, T - 4), n_seq - 1,
                              replace=False))
    bounds = np.concatenate([[0], cuts, [T - 5]])
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    for s in range(n_seq):
        a, b = bounds[s], bounds[s + 1]
        seg[a:b] = s
        pos[a:b] = np.arange(b - a)
    return seg, pos


def _jax_layer(raw, layer):
    return jax.tree.map(lambda a: jnp.asarray(a[layer]), raw["layers"])


# ---------------------------------------------------------------------------
# registry and weights

def test_registry_is_the_jax_registry_but_seamless():
    """The port's registry is the JAX registry, in its order: the
    encoder-decoder seamless-m4t-v2, the one architecture it once lacked,
    is in it too (``models/encdec.EncDecLM``)."""
    assert arch_names() == list(jax_arch_names())
    assert "seamless-m4t-v2" in arch_names()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_configs(arch):
    assert dataclasses.asdict(get_arch(arch)) == \
        dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(get_arch(arch).reduced()) == \
        dataclasses.asdict(jget(arch).reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carry_every_leaf(arch):
    _, cfg, raw = _model(arch)
    got = _params(arch)
    mine = DecoderLM(cfg).init(torch.Generator().manual_seed(0),
                               device="cpu")
    assert sorted(got) == sorted(mine)
    assert ("unembed" in got) == (arch != "qwen3-4b")
    assert ("q_norm" in got["layers"]["attn"]) == (arch == "qwen3-4b")
    jl = raw["layers"]["attn"]
    for name, t in got["layers"]["attn"].items():
        want = jl[name].shape[1:]
        if name in DENSE_LEAVES:
            want = want[::-1]
        assert tuple(t.shape[1:]) == tuple(want), name
        assert tuple(t.shape) == tuple(mine["layers"]["attn"][name].shape)
    if arch == "qwen3-4b":
        np.testing.assert_array_equal(got["layers"]["attn"]["k_norm"]
                                      .numpy(), jl["k_norm"])


# ---------------------------------------------------------------------------
# the attention block and the model

@pytest.mark.parametrize("arch", ARCHS)
def test_project_qkv_matches_jax(arch):
    jcfg, cfg, raw = _model(arch)
    rng = np.random.default_rng(1)
    T = 40
    seg, pos = _packed(T, 2, seed=1)
    pos3 = _positions3(arch, seg, pos)
    x = rng.standard_normal((T, 64)).astype(np.float32)
    cot = [rng.standard_normal(s).astype(np.float32)
           for s in ((T, 4, 16), (T, 2, 16), (T, 2, 16))]
    jp = _jax_layer(raw, 1)["attn"]
    jargs = (jnp.asarray(pos), None if pos3 is None else jnp.asarray(pos3))

    def f(p, xx):
        return jattn.project_qkv(jcfg, p, xx, *jargs)
    want, vjp = jax.vjp(f, jp, jnp.asarray(x))
    jgp, jgx = vjp(tuple(map(jnp.asarray, cot)))
    tp = {k: v.clone().requires_grad_(True) for k, v in
          layer_params(_params(arch), 1)["attn"].items()}
    xx = torch.from_numpy(x).requires_grad_(True)
    tpos = torch.from_numpy(pos)
    got = tattn.project_qkv(cfg, tp, xx, tpos, DecoderLM(cfg).rope_tables(
        tpos, None if pos3 is None else torch.from_numpy(pos3)))
    for a, b in zip(want, got):
        _close(a, b)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cot)).backward()
    _close(jgx, xx.grad)
    for name, t in tp.items():
        w = np.asarray(jgp[name])
        if name == "wo":                # the output projection: not here
            assert t.grad is None and not w.any()
            continue
        _close(w.T if name in DENSE_LEAVES else w, t.grad)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_chunk_matches_jax(arch):
    jcfg, cfg, raw = _model(arch)
    T = 72
    seg, pos = _packed(T, 3, seed=2)
    pos3 = _positions3(arch, seg, pos)
    tok = np.random.default_rng(2).integers(0, 512, T).astype(np.int32)
    want, _ = JLM(jcfg).forward_chunk(
        jax.tree.map(jnp.asarray, raw), *map(jnp.asarray, (tok, seg, pos)),
        positions3=None if pos3 is None else jnp.asarray(pos3),
        compute_dtype=jnp.float32)
    got, ctx = DecoderLM(cfg).forward_chunk(
        _params(arch), torch.from_numpy(tok).long(), torch.from_numpy(seg),
        torch.from_numpy(pos), compute_dtype=torch.float32,
        positions3=None if pos3 is None else torch.from_numpy(pos3))
    assert ctx is None
    # the live rows: a pad row attends no key, which the reference's
    # attention and the port's write differently (the port: zeros); the
    # loss test below holds the rows that carry a loss
    live = seg >= 0
    _close(np.asarray(want)[live], got[torch.from_numpy(live)])


@pytest.mark.parametrize("arch", ARCHS)
def test_split_chunks_with_the_carry_match_the_whole_forward(arch):
    """One 64-token sequence (qwen2-vl: an image span, then text) as two
    chunks with the KV carry equals the JAX package's forward of it whole,
    and its own split forward."""
    jcfg, cfg, raw = _model(arch)
    t, half = 64, 32
    seg = np.zeros(t, np.int32)
    pos = np.arange(t, dtype=np.int32)
    pos3 = _positions3(arch, seg, pos)
    tok = np.random.default_rng(3).integers(0, 512, t).astype(np.int32)
    jm, jraw = JLM(jcfg), jax.tree.map(jnp.asarray, raw)

    def p3(a, b):
        return None if pos3 is None else pos3[:, a:b]
    whole, _ = jm.forward_chunk(jraw, *map(jnp.asarray, (tok, seg, pos)),
                                positions3=None if pos3 is None
                                else jnp.asarray(pos3),
                                compute_dtype=jnp.float32)
    jctx = jm.init_ctx(t, jnp.float32)
    j1, jctx = jm.forward_chunk(
        jraw, *map(jnp.asarray, (tok[:half], seg[:half], pos[:half])),
        ctx=jctx, ctx_len=0, positions3=None if pos3 is None
        else jnp.asarray(p3(0, half)), compute_dtype=jnp.float32)
    j2, _ = jm.forward_chunk(
        jraw, *map(jnp.asarray, (tok[half:], seg[half:], pos[half:])),
        ctx=jctx, ctx_len=half, positions3=None if pos3 is None
        else jnp.asarray(p3(half, t)), compute_dtype=jnp.float32)
    model, params = DecoderLM(cfg), _params(arch)
    ctx = model.init_ctx(t, torch.float32, device="cpu")
    outs = []
    for a, b, c in ((0, half, 0), (half, t, half)):
        h, ctx = model.forward_chunk(
            params, torch.from_numpy(tok[a:b]).long(),
            torch.from_numpy(seg[a:b]), torch.from_numpy(pos[a:b]),
            ctx=ctx, ctx_len=c, compute_dtype=torch.float32,
            positions3=None if pos3 is None
            else torch.from_numpy(np.ascontiguousarray(p3(a, b))))
        outs.append(h)
    got = torch.cat(outs)
    _close(whole, got)
    _close(jnp.concatenate([j1, j2]), got)
    assert isinstance(ctx, LayerCtx) and ctx.k.shape[1] == t


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: a for k, v in tree.items()
                for n, a in _flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(arch):
    jcfg, cfg, raw = _model(arch)
    T = 80
    seg, pos = _packed(T, 3, seed=4)
    pos3 = _positions3(arch, seg, pos)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, 512, T).astype(np.int32)
    tgt = np.where(seg >= 0, rng.integers(0, 512, T), -1).astype(np.int32)

    def f(p):
        s, n = JLM(jcfg).loss(p, *map(jnp.asarray, (tok, tgt, seg, pos)),
                              positions3=None if pos3 is None
                              else jnp.asarray(pos3),
                              compute_dtype=jnp.float32)
        return s / n
    jloss, jgrads = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, raw))
    params = tree_map(lambda t: t.requires_grad_(True), _params(arch))
    s, n = DecoderLM(cfg).loss(
        params, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long(),
        torch.from_numpy(seg), torch.from_numpy(pos),
        positions3=None if pos3 is None else torch.from_numpy(pos3),
        compute_dtype=torch.float32)
    loss = s / n
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = _flat(jgrads)
    tflat = _flat(tree_map(lambda t: t.grad, params))
    assert sorted(jflat) == sorted(tflat)
    for name, g in tflat.items():
        w = np.asarray(jflat[name])
        if name.split(".")[-1] in DENSE_LEAVES:
            w = np.swapaxes(w, -1, -2)
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the chunked trainer

def _plan(cfg, lens):
    cm = CostModel(cfg.spec, ClusterSpec())
    # a tight budget: the ILP remats layers of some chunks
    return plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        capacity_bytes=cm.m_model_states(1) + 1e6))


@functools.lru_cache(maxsize=None)
def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    lens = [200] + [int(x) for x in rng.integers(24, 96, 5)]
    return lens, {i: rng.integers(0, 512, n).astype(np.int32)
                  for i, n in enumerate(lens)}


def _whole_sequences(jcfg, raw, corpus):
    """``jax.value_and_grad`` of the mean loss over every sequence run
    whole through the JAX ``DecoderLM.loss`` (text positions, as the JAX
    trainer runs qwen2-vl)."""
    model = JLM(jcfg)
    n, L = len(corpus), max(len(t) for t in corpus.values())
    tok = np.zeros((n, L), np.int32)
    tgt = np.full((n, L), -1, np.int32)
    seg = np.full((n, L), -1, np.int32)
    pos = np.zeros((n, L), np.int32)
    for i, t in corpus.items():
        tok[i, :len(t)] = t
        tgt[i, :len(t) - 1] = t[1:]
        seg[i, :len(t)] = 0
        pos[i, :len(t)] = np.arange(len(t))
    rows = tuple(map(jnp.asarray, (tok, tgt, seg, pos)))

    def mean_loss(p):
        s, c = jax.lax.map(
            lambda r: model.loss(p, *r, compute_dtype=jnp.float32), rows)
        return s.sum() / c.sum()
    loss, grads = jax.jit(jax.value_and_grad(mean_loss))(
        jax.tree.map(jnp.asarray, raw))
    return float(loss), grads


def _stacked(grads):
    def stack(trees, name=""):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees], k) for k in trees[0]}
        a = np.stack([t.detach().numpy() for t in trees])
        return np.swapaxes(a, -1, -2) if name in DENSE_LEAVES else a
    out = {k: v.detach().numpy() for k, v in grads.items() if k != "layers"}
    out["layers"] = stack(grads["layers"])
    return out


@functools.lru_cache(maxsize=None)
def _chunked(arch, policy="stage-aware"):
    _, cfg, raw = _model(arch)
    lens, corpus = _corpus()
    plan = _plan(cfg, lens)
    tr = ChunkedTrainer(cfg, from_jax(cfg, raw, device="cpu"), device="cpu",
                        compute_dtype=torch.float32)
    return plan, tr.loss_and_grads(plan, corpus, remat_policy=policy)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_trainer_matches_whole_sequences(arch):
    jcfg, cfg, raw = _model(arch)
    plan, res = _chunked(arch)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    assert max(s.n_chunks for s in plan.sequences) >= 3
    assert any(c.context > 0 for c in chunks)
    assert res.remat_layers > 0
    jloss, jgrads = _whole_sequences(jcfg, raw, _corpus()[1])
    np.testing.assert_allclose(res.loss, jloss, rtol=1e-5)
    got, want = jax.tree.leaves(_stacked(res.grads)), jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
    # remat recomputes, it does not change the math
    zeroed = _chunked(arch, "none")[1]
    assert zeroed.loss == res.loss and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(res.grads),
                                          tree_leaves(zeroed.grads)))


# ---------------------------------------------------------------------------
# the vision path and the planted faults

def test_vision_path_layer_by_layer():
    """The image span's token embeddings replaced by the vision stub's
    patches (the JAX ``test_mrope_vision_positions``), then each layer at
    the stub's 3-D positions, against the JAX ``layer_apply`` after every
    layer; at text positions the same rows fall outside the limit."""
    arch = "qwen2-vl-7b"
    jcfg, cfg, raw = _model(arch)
    n_text = 32
    T = N_PATCH + n_text
    seg = np.zeros(T, np.int32)
    pos = np.arange(T, dtype=np.int32)
    pos3 = mrope_positions_stub(n_text, N_PATCH, GRID).numpy()
    tok = np.random.default_rng(6).integers(0, 512, T).astype(np.int32)
    patches = np.array(jax_patches(jcfg, jax.random.PRNGKey(2), N_PATCH,
                                   jnp.float32))
    jm, model, params = JLM(jcfg), DecoderLM(cfg), _params(arch)
    jx = jm.embed(jax.tree.map(jnp.asarray, raw), jnp.asarray(tok),
                  jnp.float32).at[:N_PATCH].set(jnp.asarray(patches))
    x = model.embed(params, torch.from_numpy(tok).long(), torch.float32)
    x[:N_PATCH] = torch.from_numpy(patches)
    _close(jx, x)
    text = x
    rope = model.rope_tables(torch.from_numpy(pos), torch.from_numpy(pos3))
    for i, w in enumerate(cfg.layer_windows()):
        jx, _ = jm.layer_apply(
            _jax_layer(raw, i), jx, pos=jnp.asarray(pos),
            seg=jnp.asarray(seg), ctx=JCtx(None, None, None, None),
            ctx_len=jnp.int32(0), window=w, positions3=jnp.asarray(pos3))
        kw = dict(pos=torch.from_numpy(pos), seg=torch.from_numpy(seg),
                  ctx=LayerCtx(None, None), ctx_len=0, window=w)
        x, _ = model.layer_apply(layer_params(params, i), x, rope=rope,
                                 **kw)
        text, _ = model.layer_apply(layer_params(params, i), text, **kw)
        _close(jx, x)
    assert float((text - torch.from_numpy(np.asarray(jx))).abs().max()) \
        > 1e-3


def test_qk_norm_is_live():
    """qwen3-4b's forward without its k-norm falls outside the limit that
    the forward with it meets."""
    arch = "qwen3-4b"
    jcfg, cfg, raw = _model(arch)
    T = 48
    seg, pos = _packed(T, 2, seed=7)
    tok = np.random.default_rng(7).integers(0, 512, T).astype(np.int32)
    args = (torch.from_numpy(tok).long(), torch.from_numpy(seg),
            torch.from_numpy(pos))
    want, _ = JLM(jcfg).forward_chunk(
        jax.tree.map(jnp.asarray, raw), *map(jnp.asarray, (tok, seg, pos)),
        compute_dtype=jnp.float32)
    params = _params(arch)
    got, _ = DecoderLM(cfg).forward_chunk(params, *args,
                                          compute_dtype=torch.float32)
    live = seg >= 0
    _close(np.asarray(want)[live], got[torch.from_numpy(live)])
    plain = dataclasses.replace(cfg, spec=dataclasses.replace(
        cfg.spec, qk_norm=False))
    wrong, _ = DecoderLM(plain).forward_chunk(params, *args,
                                              compute_dtype=torch.float32)
    assert float((wrong - got)[torch.from_numpy(live)].abs().max()) > 1e-3
