"""Port parity: MLA (deepseek-v2-lite's latent attention) against the JAX
package, on the CPU, float32, inputs from numpy seeds.

Reduced deepseek-v2-lite (``reduced(n_layers=2)``: d_model 64, 4 heads of
Dh 16, rope channels rr 8, latent rank r 16, 4 experts top-2 plus 1
shared), the JAX init bridged through ``repro_torch.weights``:

* ``project_qkv``, ``mla_expand_ctx`` and ``attention_block`` (scale
  ``1/sqrt(Dh + rr)``, with and without a latent carry) equal the JAX
  functions, forward and ``jax.grad`` (``1e-5``);
* the plain attention at key width != value width, (24, 16) and MLA's
  (192, 128), equals ``flash_attention_pallas`` in interpret mode, and its
  gradient ``jax.grad`` of the JAX reference attention (``2e-5``);
* the weights carried across: ``DecoderLM.loss`` equals the JAX one;
* ``ChunkedTrainer`` on a sequence split over 3 chunks (the latent carry
  and its gradient hand-off) with a non-zero remat table equals
  ``jax.value_and_grad`` of the JAX loss over whole sequences (loss
  ``1e-5``, gradients ``rtol 1e-4, atol 1e-6``); the zeroed table gives
  the same bits;
* ``PipelineTrainer`` at 2x1 under the three schedules and the split
  backward equals ``ChunkedTrainer`` (loss ``1e-5``, each leaf within
  ``1e-4`` of its largest value), and the split equals the fused backward
  bit for bit;
* ``one_shot_generate`` emits the JAX package's ``one_shot_generate`` ids
  (1x1 mesh); the serving engines of both packages refuse MLA;
* the train CLI runs ``--arch deepseek-v2-lite``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import DecoderLM as JLM
from repro.models import attention as jattn
from repro_torch.configs import get_arch
from repro_torch.core import ClusterSpec, CostModel, PlannerConfig, \
    plan_batch
from repro_torch.kernels import ref as tref
from repro_torch.models import DecoderLM, layer_params
from repro_torch.models import attention as tattn
from repro_torch.models.model import tree_leaves
from repro_torch.runtime import sharding
from repro_torch.runtime.pipeline import PipelineGeometry
from repro_torch.runtime.train_step import ChunkedTrainer, PipelineTrainer
from repro_torch.weights import DENSE_LEAVES, from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

ARCH = "deepseek-v2-lite"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_LIMIT = 1e-4


@functools.lru_cache(maxsize=None)
def _model(n_layers=2, seed=5):
    jcfg = jget(ARCH).reduced(n_layers=n_layers)
    cfg = get_arch(ARCH).reduced(n_layers=n_layers)
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(seed)))
    return jcfg, cfg, raw


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


def _jax_attn(raw, layer):
    return jax.tree.map(lambda a: jnp.asarray(a[layer]),
                        raw["layers"])["attn"]


def _torch_attn(cfg, raw, layer, grad=False):
    p = layer_params(from_jax(cfg, raw, device="cpu"), layer)["attn"]
    return {k: v.clone().requires_grad_(grad) for k, v in p.items()}


# ---------------------------------------------------------------------------
# the attention block

def test_reduced_config_and_leaves():
    jcfg, cfg, raw = _model()
    s = cfg.spec
    assert (s.head_dim, s.qk_rope_dim, s.kv_lora_rank) == (16, 8, 16)
    assert (s.n_experts, s.top_k, s.n_shared_experts) == (4, 2, 1)
    # the port's copy of the config is the reference's
    assert dataclasses.asdict(get_arch(ARCH).spec) == \
        dataclasses.asdict(jget(ARCH).spec)
    jshapes = {k: v.shape[1:] for k, v in raw["layers"]["attn"].items()}
    tp = layer_params(DecoderLM(cfg).init(torch.Generator().manual_seed(0),
                                          device="cpu"), 0)["attn"]
    assert sorted(tp) == sorted(jshapes)
    for k, v in tp.items():
        want = jshapes[k][::-1] if k in DENSE_LEAVES else jshapes[k]
        assert tuple(v.shape) == tuple(want), k
    # the latent carry: [L, cap, 1, r + rr], no value buffer
    ctx = DecoderLM(cfg).init_ctx(5, torch.float32, device="cpu")
    assert tuple(ctx.k.shape) == (2, 5, 1, 24) and ctx.v is None


def test_project_qkv_and_expand_match_jax():
    jcfg, cfg, raw = _model()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((10, 64)).astype(np.float32)
    pos = rng.integers(0, 50, 10).astype(np.int32)
    jp, tp = _jax_attn(raw, 1), _torch_attn(cfg, raw, 1)
    jq, jrows, jv = jattn.project_qkv(jcfg, jp, jnp.asarray(x),
                                      jnp.asarray(pos))
    tq, trows, tv = tattn.project_qkv(cfg, tp, torch.from_numpy(x),
                                      torch.from_numpy(pos))
    assert jv.shape == (10, 1, 0) and tv is None
    assert tuple(tq.shape) == (10, 4, 24) and tuple(trows.shape) == \
        (10, 1, 24)
    _close(jq, tq)
    _close(jrows, trows)
    # the expansion of a carry's rows and the chunk's
    rows = rng.standard_normal((37, 1, 24)).astype(np.float32)
    jk, jvv = jattn.mla_expand_ctx(jcfg, jp, jnp.asarray(rows))
    tk, tvv = tattn.mla_expand_ctx(cfg, tp, torch.from_numpy(rows))
    assert tuple(tk.shape) == (37, 4, 24) and tuple(tvv.shape) == (37, 4, 16)
    _close(jk, tk)
    _close(jvv, tvv)


@pytest.mark.parametrize("ctx_len", [0, 21])
def test_attention_block_matches_jax(ctx_len):
    """The block (projection, expansion on ``[carry || chunk]`` latent
    rows, attention at key width 24 and value width 16, output
    projection) and its gradient in the parameters, the input and the
    carry's latent rows, against ``jax.grad`` of the JAX block."""
    jcfg, cfg, raw = _model()
    T, cap = 24, 48
    rng = np.random.default_rng(ctx_len + 3)
    x = rng.standard_normal((T, 64)).astype(np.float32)
    seg, pos = _packed(T, 2, seed=ctx_len, ctx=ctx_len)
    w_out = rng.standard_normal((T, 64)).astype(np.float32)
    ctx = rng.standard_normal((cap, 1, 24)).astype(np.float32)
    policy = jattn.make_local_attention_policy(jref.flash_attention_reference)
    jp = _jax_attn(raw, 0)

    def jloss(p, xx, ck):
        kw = dict(ctx_k=None, ctx_v=None, ctx_len=None)
        if ctx_len:
            kw = dict(ctx_k=ck, ctx_v=jnp.zeros((cap, 1, 0)),
                      ctx_len=jnp.int32(ctx_len))
        y, nk, _ = jattn.attention_block(jcfg, p, xx, pos=jnp.asarray(pos),
                                         seg=jnp.asarray(seg), window=0,
                                         attn_fn=policy, **kw)
        return (y * w_out).sum(), (y, nk)
    (_, (jy, jnk)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                            has_aux=True)(
        jp, jnp.asarray(x), jnp.asarray(ctx))
    tp = _torch_attn(cfg, raw, 0, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tc = torch.from_numpy(ctx).requires_grad_(True)
    ty, tnk, tnv = tattn.attention_block(
        cfg, tp, tx, pos=torch.from_numpy(pos), seg=torch.from_numpy(seg),
        ctx_k=tc if ctx_len else None, ctx_v=None, ctx_len=ctx_len, window=0,
        attn_fn=tattn.make_local_attention_policy())
    (ty * torch.from_numpy(w_out)).sum().backward()
    _close(jy, ty)
    assert tnv is None
    if ctx_len:
        # the new carry holds the context's and the chunk's latent rows
        _close(jnk[:ctx_len + T], tnk[:ctx_len + T])
        _close(jg[2], tc.grad)
    for name, g in jg[0].items():
        want = np.asarray(g)
        if name in DENSE_LEAVES:
            want = want.T
        _close(want, tp[name].grad)
    _close(jg[1], tx.grad)


def test_block_keeps_latent_rows_not_keys():
    """Under autograd the block's attention keeps the ``[S, 1, r + rr]``
    latent rows of the carry and the chunk, not the expanded keys ``[S,
    Hq, Dh + rr]`` and values ``[S, Hq, Dh]``: its backward makes them
    again (``attention._MLAAttention``)."""
    _, cfg, raw = _model()
    T, C = 40, 21
    rng = np.random.default_rng(8)
    seg, pos = _packed(T, 2, seed=8, ctx=C)
    x = torch.from_numpy(rng.standard_normal((T, 64)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((C, 1, 24)).astype(
        np.float32)).requires_grad_(True)
    tp = _torch_attn(cfg, raw, 0, grad=True)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, rows, _ = tattn.attention_block(
            cfg, tp, x.requires_grad_(True), pos=torch.from_numpy(pos),
            seg=torch.from_numpy(seg), ctx_k=ctx, ctx_v=None, ctx_len=C,
            window=0, attn_fn=tattn.make_local_attention_policy())
    S = rows.shape[0]                 # C + T rows padded to the KV tile
    assert S == 64 and tuple(rows.shape[1:]) == (1, 24)
    assert (S, 1, 24) in shapes
    assert (S, 4, 24) not in shapes and (S, 4, 16) not in shapes
    y.sum().backward()
    assert ctx.grad is not None and tp["w_uk"].grad is not None


# ---------------------------------------------------------------------------
# the plain attention at key width != value width

@pytest.mark.parametrize("Dk,Dv", [(24, 16), (192, 128)])
def test_plain_attention_at_two_widths(Dk, Dv):
    """``ref.blocked_flash_attention`` and the reference against the Pallas
    kernel (interpret mode), and ``ref.flash_attention_grad`` against
    ``jax.grad`` of the JAX reference attention, at MLA's shapes: every
    query head its own KV head, a context of segment 0 in front."""
    rng = np.random.default_rng(Dk)
    T, C, H = 64, 32, 4
    seg_q, pos_q = _packed(T, 2, seed=Dv, ctx=C)
    seg_kv = np.concatenate([np.zeros(C, np.int32), seg_q])
    pos_kv = np.concatenate([np.arange(C, dtype=np.int32), pos_q])
    q = rng.standard_normal((T, H, Dk)).astype(np.float32)
    k = rng.standard_normal((C + T, H, Dk)).astype(np.float32)
    v = rng.standard_normal((C + T, H, Dv)).astype(np.float32)
    dout = rng.standard_normal((T, H, Dv)).astype(np.float32)
    meta = (seg_q, seg_kv, pos_q, pos_kv)
    scale = 1.0 / np.sqrt(Dk)
    pal = flash_attention_pallas(*map(jnp.asarray, (q, k, v, *meta)),
                                 scale=scale, block_q=32, block_kv=32,
                                 interpret=True)
    targs = [torch.from_numpy(a) for a in (q, k, v, *meta)]
    for got in (tref.blocked_flash_attention(*targs, scale=scale,
                                             block_kv=32),
                tref.flash_attention_reference(*targs, scale=scale)):
        assert tuple(got.shape) == (T, H, Dv)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=2e-5,
                                   atol=2e-5)

    def f(qq, kk, vv):
        o = jref.flash_attention_reference(qq, kk, vv,
                                           *map(jnp.asarray, meta),
                                           scale=scale)
        return (o * dout).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = tref.flash_attention_grad(*targs, torch.from_numpy(dout),
                                    scale=scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# the model and the trainers

def test_model_loss_matches_jax():
    jcfg, cfg, raw = _model()
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 512, n).astype(np.int32) for n in (37, 20)]
    tok = np.concatenate(seqs + [np.zeros(7, np.int32)])
    seg = np.concatenate([np.full(len(s), i, np.int32)
                          for i, s in enumerate(seqs)] +
                         [np.full(7, -1, np.int32)])
    pos = np.concatenate([np.arange(len(s), dtype=np.int32) for s in seqs] +
                         [np.zeros(7, np.int32)])
    tgt = np.concatenate([np.append(s[1:], -1) for s in seqs] +
                         [np.full(7, -1, np.int32)]).astype(np.int32)
    js, jn = JLM(jcfg).loss(jax.tree.map(jnp.asarray, raw),
                            *map(jnp.asarray, (tok, tgt, seg, pos)),
                            compute_dtype=jnp.float32)
    ts, tn = DecoderLM(cfg).loss(
        from_jax(cfg, raw, device="cpu"),
        torch.from_numpy(tok).long(), torch.from_numpy(tgt).long(),
        torch.from_numpy(seg), torch.from_numpy(pos),
        compute_dtype=torch.float32)
    assert float(tn) == float(jn) == len(tok) - 7 - 2
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)


def _plan(cfg, lens, d_p):
    cm = CostModel(cfg.spec, ClusterSpec(d_p=d_p))
    # a tight budget: the ILP remats layers of some chunks on every stage
    cap = max(cm.m_model_states(p) for p in range(1, d_p + 1)) + 1e6
    return cm, plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        capacity_bytes=cap))


@functools.lru_cache(maxsize=None)
def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    lens = [200] + [int(x) for x in rng.integers(24, 96, 5)]
    return lens, {i: rng.integers(0, 512, n).astype(np.int32)
                  for i, n in enumerate(lens)}


def _jax_layout(grads):
    def stack(trees, name=""):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees], k) for k in trees[0]}
        a = np.stack([t.detach().cpu().numpy() for t in trees])
        return np.swapaxes(a, -1, -2) if name in DENSE_LEAVES else a
    out = {k: v.detach().cpu().numpy() for k, v in grads.items()
           if k != "layers"}
    out["layers"] = stack(grads["layers"])
    return out


def _whole_sequences(jcfg, raw, corpus):
    """``jax.value_and_grad`` of the mean loss over every sequence run
    whole through the JAX ``DecoderLM.loss``."""
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


@functools.lru_cache(maxsize=None)
def _chunked(n_layers, policy="stage-aware"):
    _, cfg, raw = _model(n_layers)
    lens, corpus = _corpus()
    _, plan = _plan(cfg, lens, 1)
    tr = ChunkedTrainer(cfg, from_jax(cfg, raw, device="cpu"), device="cpu",
                        compute_dtype=torch.float32)
    return plan, tr.loss_and_grads(plan, corpus, remat_policy=policy)


def _bitwise(a, b):
    return a.loss == b.loss and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a.grads),
                                          tree_leaves(b.grads)))


def test_chunked_step_matches_whole_sequences():
    """A 200-token sequence over 3 chunks hands on latent rows ``[C, 1, r +
    rr]`` and takes back their gradient, which flows through the
    expansion into ``w_uk``, ``w_uv`` and the projections; the planner
    remats layers of some chunks."""
    jcfg, cfg, raw = _model()
    plan, res = _chunked(2)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    assert max(s.n_chunks for s in plan.sequences) >= 3
    assert any(c.context > 0 for c in chunks)
    assert res.remat_layers > 0
    jloss, jgrads = _whole_sequences(jcfg, raw, _corpus()[1])
    np.testing.assert_allclose(res.loss, jloss, rtol=1e-5)
    got, want = jax.tree.leaves(_jax_layout(res.grads)), \
        jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
    # remat recomputes, it does not change the math
    assert _bitwise(res, _chunked(2, "none")[1])


def _pipeline(sched, split):
    _, cfg, raw = _model(4)
    lens, corpus = _corpus()
    cm, plan = _plan(cfg, lens, 2)
    v = sharding.layers_per_stage(4, 2) if sched == "interleaved-1f1b" else 1
    tr = PipelineTrainer(cfg, from_jax(cfg, raw, device="cpu"),
                         geometry=PipelineGeometry(d_p=2, schedule=sched,
                                                   v_stages=v,
                                                   split_bwd=split),
                         cards=["cpu"], compute_dtype=torch.float32,
                         cost_model=cm)
    return plan, tr.loss_and_grads(plan, corpus)


@pytest.mark.parametrize("sched,split", [
    ("gpipe-1f1b", False), ("interleaved-1f1b", False),
    ("zero-bubble-h1", False), ("zero-bubble-h1", True)])
def test_pipeline_equals_the_chunked_trainer(sched, split):
    """2x1: the latent carry crosses stages with its chunk (each stage its
    own layers' rows) and its gradient comes back through the hand-offs;
    the zero-bubble split defers the MLA weights' gradients (``w_uk`` and
    ``w_uv`` included) to its store."""
    plan, res = _pipeline(sched, split)
    assert max(s.n_chunks for s in plan.sequences) >= 3
    assert all(any(row) for row in plan.ckpt_table())
    assert res.remat_layers > 0 and res.pipeline["handoffs"] > 0
    want = _chunked(4)[1]
    assert res.n_valid == want.n_valid
    assert abs(res.loss - want.loss) <= 1e-5 * abs(want.loss)
    ga, gb = tree_leaves(res.grads), tree_leaves(want.grads)
    assert len(ga) == len(gb)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
                for a, b in zip(ga, gb))
    assert worst <= GRAD_LIMIT, worst
    if split:
        assert _bitwise(res, _pipeline(sched, False)[1])


# ---------------------------------------------------------------------------
# serving

def test_one_shot_generate_matches_jax():
    from repro.runtime.train_step import prepare_params
    from repro.serve.engine import one_shot_generate as jgen
    from repro_torch.serve.engine import one_shot_generate
    jcfg, cfg, raw = _model()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    stages = prepare_params(jcfg, raw, mesh, jnp.float32)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (13, 30)]
    want = jgen(jcfg, mesh, stages, prompts, 5, compute_dtype=jnp.float32)
    got = one_shot_generate(cfg, from_jax(cfg, jax.tree.map(np.asarray,
                                                            stages),
                                          device="cpu"),
                            prompts, 5, device="cpu")
    assert got == want


def test_engines_refuse_mla():
    """The JAX engine's page pool has no latent rows, and neither has the
    port's: both refuse MLA at the geometry."""
    from repro.runtime.serve_step import make_engine_geometry as jgeom
    from repro_torch.runtime.serve_step import make_engine_geometry
    jcfg, cfg, _ = _model()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    kw = dict(n_items=2, cap_t=16, n_pages=8, page_sz=8)
    with pytest.raises(NotImplementedError, match="MLA"):
        jgeom(jcfg, mesh, **kw)
    with pytest.raises(NotImplementedError, match="MLA"):
        make_engine_geometry(cfg, **kw)


def test_cli_trains_deepseek():
    from repro_torch.launch.train import main
    assert main(["--device", "cpu", "--arch", ARCH, "--reduced", "--layers",
                 "2", "--steps", "1", "--batch", "2", "--context",
                 "128"]) == 0
