"""Port parity: ZeRO-3 over the sequence-parallel axis
(``runtime/sharding.py``'s layout and gathers, ``SPStage`` and
``PipelineTrainer`` at ``d_s > 1``) against the JAX package, on the CPU.

* the shard dim of every leaf of every family in the registry (full
  widths, shapes from ``jax.eval_shape`` and the port's ``init`` on the
  meta device) at ``d_s`` 2 and 4 is the reference's ``zero3_dim`` minus
  the stack dims, through the dense leaves' transpose; the head rule and
  the vocabulary blocks are ``head_param_specs``' and ``_pad_vocab``'s;
* the gather of a reduced layer equals the reference's
  ``gather_layer_params`` and its transpose the reference's (``jax.vjp``)
  under ``jax.vmap`` with the model axis name; ``sp.all_gather`` and
  ``sp.reduce_scatter`` along any dim equal ``all_gather`` /
  ``psum_scatter`` with ``tiled=True``;
* the step in both modes equals whole-sequence JAX gradients (the limits
  of ``tests/test_torch_sp_pipeline.py``) under the three schedules, and
  ``per_tick`` equals ``per_step``;
* a ``per_tick`` forward keeps no gathered weight past its layer (the
  gathered copies counted through weak references), ``per_step`` keeps
  the stage's; a rank owns ``1 / d_s`` of the state but its whole leaves;
* a checkpoint saved at ``2 x 2`` ``per_tick`` loads at ``1 x 2``
  ``per_step`` and at ``2 x 1``, its state tree back bit for bit;
* planted faults (a gather in the wrong rank order, the split backward's
  reduce-scatter keeping each rank's own product) fall outside the limits.
"""

import contextlib
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.configs.registry import ARCHS as JARCHS
from repro.models import DecoderLM as JLM
from repro.runtime import sharding as jsh
from repro_torch.configs import get_arch
from repro_torch.core import ClusterSpec, CostModel, PlannerConfig, \
    plan_batch
from repro_torch.models import DecoderLM
from repro_torch.models.model import tree_leaves, unstack_layers
from repro_torch.runtime import sharding, sp
from repro_torch.runtime.pipeline import PipelineGeometry
from repro_torch.runtime.train_step import PipelineTrainer
from repro_torch.weights import DENSE_LEAVES, from_jax
from test_torch_pipeline import _jax_layout, _worst
from test_torch_sp_pipeline import case, trainer, whole, within
from test_torch_threads import torch_thread_share  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# the layout against zero3_dim and the head rule

def _jax_shapes(name):
    jcfg = jget(name)
    if jcfg.spec.is_encoder_decoder:
        from repro.models.encdec import EncDecLM as JEnc
        model = JEnc(jcfg)
    else:
        model = JLM(jcfg)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _port_shapes(name):
    cfg = get_arch(name)
    if cfg.spec.is_encoder_decoder:
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg).init(torch.Generator(), device="meta")
    return unstack_layers(DecoderLM(cfg).init(torch.Generator(),
                                              device="meta"))


@pytest.mark.parametrize("d_s", [2, 4])
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_zero3_dims_are_the_references(name, d_s):
    jtree, ptree = _jax_shapes(name), _port_shapes(name)
    stacks = [k for k in ("layers", "enc_layers", "dec_layers") if k in jtree]
    n = 0
    for key in stacks:
        ref = dict(_paths(jtree[key]))
        for path, leaf in _paths(ptree[key][0]):
            rshape = ref[path].shape
            nd = len(leaf.shape)
            # the port's leaf is the reference's per-layer leaf, transposed
            # on a dense one
            assert tuple(leaf.shape[sharding.ref_axis(path, nd, a)]
                         for a in range(nd)) == tuple(rshape[1:]), path
            want = jsh.zero3_dim(path, (1, 1, *rshape[1:]), d_s)
            got = sharding.zero3_dim(path, leaf.shape, d_s)
            if want is None:
                assert got is None, (path, rshape)
            else:
                assert got is not None, (path, rshape)
                assert sharding.ref_axis(path, nd, got) + \
                    sharding.STACK_DIMS == want, (path, rshape, got, want)
            spec = sharding._leaf_shard(path, leaf.shape, d_s)
            assert spec.gathered == (not jsh.EP_PATH_RE.search(path))
            n += 1
    assert n > 5
    # the head rule: vocabulary rows (the reference pads V to d_s and the
    # port drops the padding: the same blocks), final norm if divisible
    heads = {k: v.shape for k, v in jtree.items()
             if k in ("embed", "unembed", "final_norm")}
    want_specs = jsh.head_param_specs(
        {k: jnp.zeros((1,) * len(s)) for k, s in heads.items()}, d_s)
    for k, shape in heads.items():
        spec = sharding._leaf_shard(k, tuple(ptree[k].shape), d_s)
        if len(shape) >= 2:
            V = shape[0]
            padded = -(-V // d_s) * d_s
            blocks = [(r * padded // d_s, min(padded // d_s,
                                              max(0, V - r * padded // d_s)))
                      for r in range(d_s)]
            assert spec.dim == 0 and not spec.gathered
            assert list(spec.sizes) == [b[1] for b in blocks]
            assert tuple(want_specs[k]) == ("model", None)
        else:
            assert (spec.dim == 0) == (shape[0] % d_s == 0)
            assert spec.gathered


def test_the_verify_families_keep_their_whole_leaves_small():
    """At full width the leaves kept whole on every rank are few and
    small: what each rank keeps beside its ``1 / d_s`` share."""
    for name in ("gemma3-1b", "hymba-1.5b", "olmoe-1b-7b",
                 "deepseek-v2-lite", "qwen3-4b"):
        tree = _port_shapes(name)
        stage = {"layers": dict(enumerate(tree["layers"])),
                 **{k: tree[k] for k in ("embed", "final_norm", "unembed")
                    if k in tree}}
        for d_s in (2, 4):
            lay = sharding.shard_layout(stage, d_s)
            total = sum(t.numel() for t in tree_leaves(tree))
            whole = sum(t.numel() for t, s in zip(tree_leaves(stage),
                                                  tree_leaves(lay))
                        if s.whole)
            assert whole < 1e-3 * total, (name, d_s, whole)


# ---------------------------------------------------------------------------
# the collectives and the gather against the reference's under vmap

@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("d", [2, 4])
def test_collectives_along_a_dim_match_jax(d, dim):
    rng = np.random.default_rng(dim + 10 * d)
    shape = [4, 6, 8]
    shape[dim] = 2 * d
    xs = rng.standard_normal((d, *shape)).astype(np.float32)
    shard = np.split(xs[0], d, axis=dim)
    gathered = jax.vmap(lambda x: jax.lax.all_gather(
        x, "m", axis=dim, tiled=True), axis_name="m")(jnp.stack(shard))
    got = sp.all_gather([torch.from_numpy(s) for s in shard], dim=dim)
    assert np.array_equal(got.numpy(), np.asarray(gathered[0]))
    scat = jax.vmap(lambda x: jax.lax.psum_scatter(
        x, "m", scatter_dimension=dim, tiled=True), axis_name="m")(
        jnp.asarray(xs))
    blocks = sp.reduce_scatter([torch.from_numpy(x) for x in xs],
                               [shape[dim] // d] * d, dim=dim)
    for r in range(d):
        np.testing.assert_allclose(blocks[r].numpy(), np.asarray(scat[r]),
                                   rtol=1e-6, atol=1e-6)


def _to_port_leaf(path, a):
    a = np.asarray(a)
    return np.swapaxes(a, -1, -2) if a.ndim >= 2 and \
        path.rsplit("/", 1)[-1] in DENSE_LEAVES else a


@pytest.mark.parametrize("d_s", [2, 4])
@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b",
                                  "deepseek-v2-lite", "hymba-1.5b"])
def test_layer_gather_and_its_transpose_match_jax(arch, d_s):
    """A reduced layer's leaves cut into ``d_s`` shards as the reference
    shards its stacked leaves: the port's gather of its ranks' shards is
    the reference's ``gather_layer_params`` under ``jax.vmap`` (EP leaves
    stay each rank's own), and a cotangent per rank comes back to each
    shard as the reference's ``jax.vjp`` brings it (the sum over ranks,
    split)."""
    jcfg, _, _, _, raw = case(arch, 8 if d_s == 4 else 4)
    lp = jax.tree.map(lambda a: np.asarray(a)[0], raw["layers"])
    stacked = jax.tree.map(lambda a: a[None, None], lp)
    dims = jsh.shard_dim_tree(stacked, d_s)

    def split(path, a):
        zd = jsh._lookup_path(dims, path)
        if zd is None:
            return np.stack([a] * d_s)
        return np.stack(np.split(a, d_s, axis=zd - 2))
    shards = jsh.tree_paths_map(split, lp)
    rng = np.random.default_rng(d_s)

    def gathered_shape(path, a):
        if jsh.EP_PATH_RE.search(path):
            return a.shape[1:]
        zd = jsh._lookup_path(dims, path)
        return a.shape[1:] if zd is None else np.asarray(
            jsh._lookup_path(lp, path)).shape
    cts = jsh.tree_paths_map(
        lambda path, a: rng.standard_normal(
            (d_s, *gathered_shape(path, a))).astype(np.float32), shards)
    f = jax.vmap(lambda t: jsh.gather_layer_params(t, dims, "model"),
                 axis_name="model")
    full, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, shards))
    (back,) = vjp(jax.tree.map(jnp.asarray, cts))

    # the port: its own layer layout and rank shards of the same leaves
    port_lp = {path: torch.from_numpy(np.array(_to_port_leaf(path, a)))
               for path, a in _paths(lp)}
    tree = {}
    for path, t in port_lp.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    layout = sharding.shard_layout({"layers": {0: tree}}, d_s)["layers"][0]
    cut = sharding.map_layout(lambda spec, a: sharding.shard_leaf(a, spec,
                                                                  d_s),
                              layout, tree)
    ranks = [sharding.map_layout(lambda spec, sh, r=r: sh[r].clone()
                                 .requires_grad_(True), layout, cut)
             for r in range(d_s)]
    got = sharding.gather_layer_params(ranks, layout)
    loss = 0.0
    for path, g in _paths(got):
        ct = np.asarray(jsh._lookup_path(cts, path))
        spec = jsh._lookup_path(layout, path)
        if isinstance(g, tuple):        # EP: each rank's own block
            assert not spec.gathered
            for r in range(d_s):
                want = _to_port_leaf(path, np.asarray(
                    jsh._lookup_path(full, path))[r])
                assert np.array_equal(g[r].detach().numpy(), want), path
                loss = loss + (g[r] * torch.from_numpy(
                    np.array(_to_port_leaf(path, ct[r])))).sum()
            continue
        for r in range(d_s):
            want = _to_port_leaf(path, np.asarray(
                jsh._lookup_path(full, path))[r])
            assert np.array_equal(g.detach().numpy(), want), path
            # rank r's use of the gathered leaf, weighted by its cotangent
            loss = loss + (g * torch.from_numpy(
                np.array(_to_port_leaf(path, ct[r])))).sum()
    loss.backward()
    for path, _ in _paths(got):
        spec = jsh._lookup_path(layout, path)
        ref = np.asarray(jsh._lookup_path(back, path))
        for r in range(d_s):
            shard = jsh._lookup_path(ranks[r], path)
            # a leaf whole on every rank: each copy takes every rank's
            # cotangent (shard_map's psum over the axis it is replicated
            # on, which the reference's norm factors assume)
            want = _to_port_leaf(path, ref.sum(0) if spec.whole else ref[r])
            np.testing.assert_allclose(shard.grad.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=path)


# ---------------------------------------------------------------------------
# the step in both modes against whole sequences

def _geom(d_p, d_s, policy, degree, sched, mode):
    from repro_torch.runtime.sharding import layers_per_stage
    from test_torch_sp_pipeline import N_LAYERS
    v = layers_per_stage(N_LAYERS, d_p) if sched == "interleaved-1f1b" \
        else 1
    return PipelineGeometry(d_p=d_p, d_s=d_s, policy=policy, d_s_eff=degree,
                            schedule=sched, v_stages=v,
                            split_bwd=sched == "zero-bubble-h1",
                            zero3_mode=mode)


def mode_trainer(arch, d_p, d_s, policy, degree, sched, mode, heads=4):
    tr, plan, corpus = trainer(arch, d_p, d_s, policy, degree, sched, heads)
    _, cfg, _, _, raw = case(arch, heads)
    tr = PipelineTrainer(cfg, from_jax(cfg, raw, device="cpu"),
                         geometry=_geom(d_p, d_s, policy, degree, sched,
                                        mode),
                         cards=["cpu"], compute_dtype=torch.float32,
                         cost_model=tr.cm)
    return tr, plan, corpus


@functools.lru_cache(maxsize=None)
def mode_run(arch, d_p, d_s, policy, degree, sched, mode, heads=4,
             fault=None):
    tr, plan, corpus = mode_trainer(arch, d_p, d_s, policy, degree, sched,
                                    mode, heads)
    with (zero3_fault(fault) if fault else contextlib.nullcontext()):
        return tr.loss_and_grads(plan, corpus)


@contextlib.contextmanager
def zero3_fault(fault):
    """A planted ZeRO-3 fault, as ``chip_smoke._zero3_fault``: "gather in
    the wrong rank order" concatenates the shards backwards; "reduce-scatter
    keeps own" gives each rank its block of its own product alone (the
    split backward's W pass)."""
    if fault == "gather in the wrong rank order":
        obj, name, real = sharding, "gather_shards", sharding.gather_shards

        def new(shards, dim):
            return real(list(shards)[::-1], dim)
    elif fault == "reduce-scatter keeps own":
        from repro_torch.runtime import pipeline
        obj, name = pipeline, "reduce_scatter_grads"

        def new(contribs, leaf):
            if leaf.spec.whole:
                return sharding.reduce_scatter_grads(contribs, leaf)
            for r, a in enumerate(leaf.accs):
                c = contribs[min(r, len(contribs) - 1)]
                a.add_(c.split(list(leaf.spec.sizes), dim=leaf.spec.dim)[r])
    else:
        raise ValueError(fault)
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


MODE_CASES = [
    ("gemma3-1b", 1, 2, "allgather_kv", 2, "gpipe-1f1b"),
    ("gemma3-1b", 2, 2, "allgather_kv", 2, "zero-bubble-h1"),
    ("gemma3-1b", 2, 2, "allgather_kv", 2, "interleaved-1f1b"),
    ("gemma3-1b", 1, 4, "allgather_kv", 2, "zero-bubble-h1"),
    ("olmoe-1b-7b", 1, 2, "ulysses", 2, "zero-bubble-h1"),
    ("olmoe-1b-7b", 2, 2, "allgather_kv", 2, "interleaved-1f1b"),
    ("deepseek-v2-lite", 2, 2, "allgather_kv", 2, "zero-bubble-h1"),
    ("hymba-1.5b", 1, 2, "allgather_kv", 2, "interleaved-1f1b"),
    ("hymba-1.5b", 2, 2, "allgather_kv", 2, "zero-bubble-h1"),
]


@pytest.mark.parametrize("mode", ["per_tick", "per_step"])
@pytest.mark.parametrize("arch,d_p,d_s,policy,degree,sched", MODE_CASES)
def test_zero3_step_matches_whole_sequences(arch, d_p, d_s, policy, degree,
                                            sched, mode):
    res = mode_run(arch, d_p, d_s, policy, degree, sched, mode)
    z = res.pipeline["zero3"]
    assert z["mode"] == mode and z["gathers"] > 0
    assert res.remat_layers > 0
    rel, worst, ok = within(res, arch)
    assert ok, (rel, worst)


@pytest.mark.parametrize("arch,d_p,d_s,policy,degree,sched", MODE_CASES)
def test_per_tick_equals_per_step(arch, d_p, d_s, policy, degree, sched):
    a = mode_run(arch, d_p, d_s, policy, degree, sched, "per_tick")
    b = mode_run(arch, d_p, d_s, policy, degree, sched, "per_step")
    assert abs(a.loss - b.loss) <= 1e-6 * abs(b.loss)
    assert _worst(_jax_layout(a.grads), _jax_layout(b.grads)) <= 1e-6
    za, zb = a.pipeline["zero3"], b.pipeline["zero3"]
    # per_tick gathers a layer for each chunk (and again under remat or
    # in the backward), per_step each leaf once
    assert za["gather_bytes"] > zb["gather_bytes"]
    assert za["peak_live_bytes"] < zb["peak_live_bytes"]


@pytest.mark.parametrize("fault", ["gather in the wrong rank order",
                                   "reduce-scatter keeps own"])
def test_zero3_faults_fall_outside_the_limits(fault):
    key = ("gemma3-1b", 2, 2, "allgather_kv", 2, "zero-bubble-h1",
           "per_tick")
    assert within(mode_run(*key), "gemma3-1b")[2]
    rel, worst, ok = within(mode_run(*key, fault=fault), "gemma3-1b")
    assert not ok, (fault, rel, worst)


# ---------------------------------------------------------------------------
# what stays alive, and what each rank owns

def test_per_tick_keeps_no_gathered_weight_past_its_layer(monkeypatch):
    """Weak references to every gathered copy of one stage's forward (no
    remat): after the forward, with its graph alive, none is left under
    ``per_tick`` (autograd saved the shards), all of them when the
    saved-tensor hooks are off (``per_step`` in disguise); the backward
    then gives both runs the same gradients."""
    arch = "gemma3-1b"
    tr, plan, corpus = mode_trainer(arch, 1, 2, "allgather_kv", 2,
                                    "gpipe-1f1b", "per_tick")
    st = tr.stages[0]
    model = tr.sp_model("allgather_kv", 2)
    made = []
    real = sharding._track

    def track(t):
        made.append(weakref.ref(t))
        real(t)
    monkeypatch.setattr(sharding, "_track", track)
    rng = np.random.default_rng(0)
    T, D = 128, tr.cfg.spec.d_model
    xs = [torch.from_numpy(rng.standard_normal((T // 2, D)).astype(
        np.float32)).requires_grad_(True) for _ in range(2)]
    seg = [torch.zeros(T // 2, dtype=torch.int32)] * 2
    pos = [torch.arange(r * T // 2, (r + 1) * T // 2, dtype=torch.int32)
           for r in range(2)]
    layers = st._layers(0)

    def forward(keep):
        made.clear()
        ctx = (contextlib.nullcontext() if keep else
               monkeypatch.context())
        with ctx as m:
            if m is not None:
                m.setattr(sharding.Zero3, "keep_shards",
                          lambda self: contextlib.nullcontext())
            hs, _ = model.run_layers_sp(layers, xs, seg, pos,
                                        zero3=st.zero3)
        gc.collect()
        alive = sum(r() is not None for r in made)
        return hs, alive, len(made)

    hs, alive, n = forward(True)
    assert n >= len(layers) * 5 and alive == 0, (n, alive)
    sum(h.square().sum() for h in hs).backward()
    grads = [x.grad.clone() for x in xs]
    for x in xs:
        x.grad = None
    hs2, alive2, n2 = forward(False)
    assert alive2 == n2 == n
    sum(h.square().sum() for h in hs2).backward()
    for a, x in zip(grads, xs):
        assert torch.equal(a, x.grad)


def test_ranks_own_their_share_of_the_state():
    """Each rank owns ``1 / d_s`` of the stage's elements but its whole
    leaves; the planner's per-rank charge covers it (the gate of
    ``chip_smoke.py``'s SP phases); the EP leaves are never gathered."""
    tr, plan, corpus = mode_trainer("olmoe-1b-7b", 2, 2, "allgather_kv", 2,
                                    "gpipe-1f1b", "per_tick")
    res = tr.loss_and_grads(plan, corpus)
    z = res.pipeline["zero3"]
    for p, (own, whole) in enumerate(zip(z["rank_state_bytes"],
                                         z["whole_state_bytes"])):
        full = sum(t.numel() for t in tree_leaves(tr._full(
            p, tr.params[p]))) * (4 + 16)
        for o, w in zip(own, whole):
            assert abs((o - w) - (full - w) / 2) <= 1, (o, w, full)
            assert o <= tr.cm.m_model_states(p + 1) * 20 / 18 + w + \
                z["uncounted_state_bytes"]
    ep = [leaf for lp in tr.stages[0].zero3.leaves.values()
          if isinstance(lp, dict)
          for path, leaf in _paths(lp) if sharding.EP_PATH_RE.search(path)]
    assert ep and all(not leaf.spec.gathered for leaf in ep)
    got = tr.stages[0].zero3.layer(next(iter(tr.blocks[0][0])))
    assert isinstance(got["moe"]["w_gate"], tuple)


# ---------------------------------------------------------------------------
# checkpoints across d_s and modes

def test_checkpoint_moves_across_meshes_and_modes():
    arch = "gemma3-1b"
    _, cfg, lens, corpus, raw = case(arch)
    tr, plan, corpus = mode_trainer(arch, 2, 2, "allgather_kv", 2,
                                    "gpipe-1f1b", "per_tick")
    tr.step(plan, corpus)
    saved = tr.state_tree()
    flat = tree_leaves(saved["params"]) + [
        x for k in ("master", "m", "v") for x in tree_leaves(saved[k])]
    assert any(float(x.abs().max()) > 0 for x in tree_leaves(saved["m"]))
    for d_p, d_s, mode in ((1, 2, "per_step"), (2, 1, None)):
        geom = PipelineGeometry(
            d_p=d_p, d_s=d_s, policy="allgather_kv" if d_s > 1 else "none",
            zero3_mode=mode)
        other = PipelineTrainer(cfg, from_jax(cfg, raw, device="cpu"),
                                geometry=geom, cards=["cpu"],
                                compute_dtype=torch.float32)
        other.load_state(saved)
        back = other.state_tree()
        assert back["step"] == saved["step"] == 1
        got = tree_leaves(back["params"]) + [
            x for k in ("master", "m", "v") for x in tree_leaves(back[k])]
        assert len(got) == len(flat)
        assert all(torch.equal(a, b) for a, b in zip(got, flat))


# ---------------------------------------------------------------------------
# shared with tests/test_torch_compression.py

def sp_setup(arch, d_p, d_s, policy, degree, sched):
    """A reduced case's config, the port's parameters, cost model, a plan
    of at least two pipelines and the corpus."""
    _, cfg, lens, corpus, raw = case(arch)
    cm = CostModel(cfg.spec, ClusterSpec(d_p=d_p, d_s=d_s))
    cap = cm.with_sp(policy, degree).m_model_states(1) + 2e6 / d_s
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        capacity_bytes=cap, sp_policy=policy, sp_degree=degree,
        schedule=sched))
    return cfg, from_jax(cfg, raw, device="cpu"), cm, plan, corpus


def test_whole_oracle_is_the_reduced_case():
    loss, grads = whole("gemma3-1b")
    assert np.isfinite(loss) and grads["embed"].shape[1] == 64


def test_norm_counts_a_whole_leaf_once(monkeypatch):
    """At ``d_s = 3`` the reduced widths (64) divide by no dim of most
    leaves: they stay whole on every rank, each rank holding a copy and
    its gradient. The step's norm counts each once (the reference's
    ``_norm_factors``) and equals the whole-sequence gradients' norm; a
    norm that counts the copies ``d_s`` times falls outside."""
    tr, plan, corpus = mode_trainer("gemma3-1b", 1, 3, "allgather_kv", 3,
                                    "gpipe-1f1b", "per_tick")
    lay = tr.layouts[0]
    assert sum(s.whole for s in tree_leaves(lay)) > 5
    res, accs = tr._step_grads(plan, corpus)
    rel, worst, ok = within(tr.loss_and_grads(plan, corpus), "gemma3-1b")
    assert ok, (rel, worst)
    _, grads = whole("gemma3-1b")
    want = float(np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                             for g in jax.tree.leaves(grads))))
    got = float(tr.grad_norm(accs))
    assert abs(got - want) <= 1e-5 * want, (got, want)
    monkeypatch.setattr(PipelineTrainer, "norm_factors",
                        lambda self, p: [1.0] * len(tree_leaves(
                            self.params[p])))
    bad = float(tr.grad_norm(accs))
    assert abs(bad - want) > 1e-3 * want, (bad, want)
