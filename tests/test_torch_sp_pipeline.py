"""Port parity: the training step on a sequence-parallel axis
(``PipelineTrainer`` with ``d_s > 1``: ``runtime/{sp,ep,pipeline}.py``)
against the JAX package, on the CPU, float32, inputs from numpy seeds.

Reduced configs (d_model 64, 4 query heads of 16, vocab 256; 8 for
ulysses at ``d_s = 4``), 8 layers, a batch with a sequence split over 3
chunks and a tight memory budget, so that the stage-aware ILP remats
layers. The plans pin their SP point (the planner's ``sp_policy`` and
``sp_degree``). The oracle is ``jax.value_and_grad`` of the JAX loss over
whole sequences (the JAX multi-device executor cannot be one on this
tree: ``ROADMAP.md`` §3): loss within ``1e-5`` relative, each leaf within
``1e-4`` of its largest value, as ``tests/test_torch_pipeline.py``.

* gemma3-1b (allgather_kv, ``Hkv = 1``), llama3.2-3b (ulysses),
  olmoe-1b-7b (ulysses and allgather_kv with expert parallelism),
  deepseek-v2-lite (allgather_kv over latent rows) at ``(d_p, d_s)`` in
  (1, 2), (2, 2), (1, 4), at ``d_s_eff < d_s`` (replica groups), under
  gpipe-1f1b, interleaved-1f1b and zero-bubble-h1 (the split backward);
  the SSM families run from ``tests/test_torch_sp_pipeline_ssm.py``;
* bit for bit: two runs, and the remat table against a zeroed one; the
  split backward equals the fused one within float32 rounding;
* a planted fault (the CE's log-sum-exps summed, not merged) falls
  outside the limits;
* the CLI trains ``--mesh 2x2`` and logs ``[sp]``.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import DecoderLM as JLM
from repro_torch.configs import get_arch
from repro_torch.core import ClusterSpec, CostModel, PlannerConfig, \
    plan_batch
from repro_torch.models.model import tree_leaves
from repro_torch.runtime.pipeline import PipelineGeometry
from repro_torch.runtime.sharding import layers_per_stage
from repro_torch.runtime.train_step import PipelineTrainer
from repro_torch.weights import from_jax
from test_torch_pipeline import _jax_layout, _worst
from test_torch_threads import torch_thread_share  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

N_LAYERS = 8
GRAD_LIMIT = 1e-4


def _small(heads):
    return dict(d_model=64, n_heads=heads, head_dim=64 // heads, vocab=256)


@functools.lru_cache(maxsize=None)
def case(arch, heads=4, seed=0):
    jcfg = jget(arch).reduced(n_layers=N_LAYERS, **_small(heads))
    cfg = get_arch(arch).reduced(n_layers=N_LAYERS, **_small(heads))
    rng = np.random.default_rng(seed)
    lens = [200] + [int(x) for x in rng.integers(24, 96, 5)]
    corpus = {i: rng.integers(0, 256, n).astype(np.int32)
              for i, n in enumerate(lens)}
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(seed)))
    return jcfg, cfg, lens, corpus, raw


@functools.lru_cache(maxsize=None)
def whole(arch, heads=4):
    """``jax.value_and_grad`` of the mean loss over whole sequences."""
    jcfg, _, _, corpus, raw = case(arch, heads)
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
    return float(loss), jax.tree.map(np.asarray, grads)


def sp_plan(cfg, lens, d_p, d_s, policy, degree, schedule):
    cm = CostModel(cfg.spec, ClusterSpec(d_p=d_p, d_s=d_s))
    # a tight budget (a rank's share): the ILP remats layers of some chunks
    cap = max(cm.with_sp(policy, degree).m_model_states(p)
              for p in range(1, d_p + 1)) + 2e6 / d_s
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        capacity_bytes=cap, sp_policy=policy, sp_degree=degree,
        schedule=schedule))
    return cm, plan


def trainer(arch, d_p, d_s, policy, degree, sched, heads=4, split=None):
    _, cfg, lens, corpus, raw = case(arch, heads)
    cm, plan = sp_plan(cfg, lens, d_p, d_s, policy, degree, sched)
    assert (plan.sp.policy, plan.sp.d_s_eff) == (policy, degree)
    v = layers_per_stage(N_LAYERS, d_p) if sched == "interleaved-1f1b" \
        else 1
    geom = PipelineGeometry(
        d_p=d_p, d_s=d_s, policy=policy, d_s_eff=degree, schedule=sched,
        v_stages=v, split_bwd=(sched == "zero-bubble-h1") if split is None
        else split)
    tr = PipelineTrainer(cfg, from_jax(cfg, raw, device="cpu"),
                         geometry=geom, cards=["cpu"],
                         compute_dtype=torch.float32, cost_model=cm)
    return tr, plan, corpus


@contextlib.contextmanager
def sp_fault(fault):
    """A planted SP fault (undone on exit), as ``chip_smoke._sp_fault``:
    "lse summed" adds the vocabulary blocks' log-sum-exps; "fold skips
    a_prod" makes each rank's decay product 1 in the SSM fold; "halo from
    own rows" hands each rank its own last rows as its conv halo (a model
    made inside the block takes it)."""
    from repro_torch.models import ssm
    from repro_torch.runtime import sp
    if fault == "lse summed":
        obj, name, new = sp, "merge_lse", lambda lses: lses.sum(0)
    elif fault == "fold skips a_prod":
        obj, name = ssm, "shard_decay"

        def new(p, dt_in, live, reset):
            return torch.ones_like(p["a_log"], dtype=torch.float32)
    else:
        obj, name, real = sp, "make_sp_conv_tail_exchange", \
            sp.make_sp_conv_tail_exchange

        def new():
            exchange = real()

            def own_rows(xs, lives, resets, carried):
                _, tail = exchange(xs, lives, resets, carried)
                return [x[-carried.shape[0]:].to(carried.dtype)
                        for x in xs], tail
            return own_rows
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


@functools.lru_cache(maxsize=None)
def run(arch, d_p, d_s, policy, degree, sched, heads=4, split=None,
        remat="stage-aware", fault=None):
    tr, plan, corpus = trainer(arch, d_p, d_s, policy, degree, sched, heads,
                               split)
    with (sp_fault(fault) if fault else contextlib.nullcontext()):
        return tr.loss_and_grads(plan, corpus, remat_policy=remat)


def within(res, arch, heads=4):
    loss, grads = whole(arch, heads)
    rel = abs(res.loss - loss) / abs(loss)
    worst = _worst(_jax_layout(res.grads), grads)
    return rel, worst, rel <= 1e-5 and worst <= GRAD_LIMIT


def bitwise(a, b):
    return a.loss == b.loss and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a.grads),
                                          tree_leaves(b.grads)))


def check_whole(arch, d_p, d_s, policy, degree, sched, heads=4):
    res = run(arch, d_p, d_s, policy, degree, sched, heads)
    assert res.remat_layers > 0
    assert (res.pipeline["sp_policy"], res.pipeline["d_s_eff"],
            res.pipeline["d_s"]) == (policy, degree, d_s)
    assert res.pipeline["collectives"] > 0
    rel, worst, ok = within(res, arch, heads)
    assert ok, (rel, worst)


CASES = [
    ("gemma3-1b", 1, 2, "allgather_kv", 2, "gpipe-1f1b", 4),
    ("gemma3-1b", 2, 2, "allgather_kv", 2, "zero-bubble-h1", 4),
    ("gemma3-1b", 2, 2, "allgather_kv", 2, "interleaved-1f1b", 4),
    ("gemma3-1b", 1, 4, "allgather_kv", 4, "zero-bubble-h1", 4),
    ("gemma3-1b", 1, 4, "allgather_kv", 2, "gpipe-1f1b", 4),
    ("gemma3-1b", 2, 2, "none", 1, "interleaved-1f1b", 4),
    ("llama3.2-3b", 1, 2, "ulysses", 2, "zero-bubble-h1", 4),
    ("llama3.2-3b", 2, 2, "ulysses", 2, "interleaved-1f1b", 4),
    ("llama3.2-3b", 1, 4, "ulysses", 4, "gpipe-1f1b", 8),
    ("llama3.2-3b", 2, 4, "ulysses", 2, "zero-bubble-h1", 8),
    ("olmoe-1b-7b", 1, 2, "ulysses", 2, "zero-bubble-h1", 4),
    ("olmoe-1b-7b", 2, 2, "allgather_kv", 2, "gpipe-1f1b", 4),
    ("deepseek-v2-lite", 1, 2, "allgather_kv", 2, "gpipe-1f1b", 4),
    ("deepseek-v2-lite", 2, 2, "allgather_kv", 2, "interleaved-1f1b", 4),
]


@pytest.mark.parametrize("arch,d_p,d_s,policy,degree,sched,heads", CASES)
def test_sp_step_matches_whole_sequences(arch, d_p, d_s, policy, degree,
                                         sched, heads):
    check_whole(arch, d_p, d_s, policy, degree, sched, heads)


def test_reduced_plans_split_a_sequence_and_remat():
    for arch, d_p, d_s, policy, degree, sched, heads in CASES:
        _, cfg, lens, _, _ = case(arch, heads)
        _, plan = sp_plan(cfg, lens, d_p, d_s, policy, degree, sched)
        assert max(s.n_chunks for s in plan.sequences) >= 3
        assert any(any(row) for row in plan.ckpt_table())


def test_sp_steps_are_bitwise_repeatable():
    """Two runs, and the remat table against a zeroed one, bit for bit;
    the split backward equals the fused one within float32 rounding (a
    weight that ``d_s`` ranks share takes ``d_s`` products: the split adds
    them to its sum one by one, autograd sums them first)."""
    key = ("gemma3-1b", 2, 2, "allgather_kv", 2, "zero-bubble-h1")
    a = run(*key)
    tr, plan, corpus = trainer(*key)
    assert bitwise(a, tr.loss_and_grads(plan, corpus))
    zeroed = run(*key, remat="none")
    assert a.remat_layers > zeroed.remat_layers == 0
    assert bitwise(a, zeroed)
    fused = run(*key, split=False)
    assert abs(fused.loss - a.loss) <= 1e-12 * abs(a.loss)
    assert _worst(_jax_layout(fused.grads), _jax_layout(a.grads)) <= 1e-6


def test_summed_lse_falls_outside_the_limits():
    key = ("gemma3-1b", 1, 2, "allgather_kv", 2, "gpipe-1f1b")
    assert within(run(*key), "gemma3-1b")[2]
    rel, worst, ok = within(run(*key, fault="lse summed"), "gemma3-1b")
    assert not ok, (rel, worst)


def test_geometry_checks_and_remaining_refusals():
    with pytest.raises(ValueError, match="must divide"):
        PipelineGeometry(d_p=1, d_s=4, policy="allgather_kv", d_s_eff=3)
    with pytest.raises(ValueError, match="meaningless"):
        PipelineGeometry(d_p=1, d_s=2, policy="ulysses", d_s_eff=1)
    g = PipelineGeometry(d_p=2, d_s=4, policy="allgather_kv", d_s_eff=2)
    assert g.sp_rep == 2
    # ZeRO-3: per_tick by default at d_s > 1, per_step on request, nothing
    # at d_s = 1; any other mode refused; the hand-off stays refused
    assert g.zero3_mode == "per_tick"
    assert PipelineGeometry(d_p=1, d_s=2, policy="allgather_kv",
                            zero3_mode="per_step").zero3_mode == "per_step"
    assert PipelineGeometry(d_p=2).zero3_mode is None
    assert PipelineGeometry(d_p=2, zero3_mode="per_step").d_s == 1
    with pytest.raises(ValueError, match="zero3_mode"):
        PipelineGeometry(d_p=1, d_s=2, policy="allgather_kv",
                         zero3_mode="per_layer")
    with pytest.raises(NotImplementedError, match="item 2"):
        PipelineGeometry(d_p=1, overlap_handoff=True)
    from repro_torch.runtime import sp
    _, cfg, _, _, raw = case("gemma3-1b")
    with pytest.raises(NotImplementedError, match="item 2"):
        PipelineTrainer(cfg, from_jax(cfg, raw, device="cpu"), geometry=g,
                        cards=["cpu", "cpu", "cpu"],
                        compute_dtype=torch.float32)


def test_cli_trains_a_2x2_mesh_and_logs_sp():
    from repro_torch.launch.train import TrainConfig, main, train
    assert main(["--device", "cpu", "--reduced", "--mesh", "2x2", "--steps",
                 "2", "--batch", "4", "--context", "128"]) == 0
    lines = []
    cfg = get_arch("gemma3-1b").reduced(n_layers=4)
    _, hist = train(cfg, TrainConfig(
        steps=2, global_batch=4, context=256, compute_dtype="float32",
        d_p=2, d_s=2, sp_policy="allgather_kv", sp_degree=2),
        device="cpu", log=lines.append)
    sp = [ln for ln in lines if ln.startswith("[sp]")]
    assert sp == ["[sp] policy=allgather_kv d_s_eff=2/2 (pinned)"]
    assert all(np.isfinite(h["loss"]) and h["sp_policy"] == "allgather_kv"
               and h["collective_bytes"] > 0 for h in hist)
    assert all(" sp allgather_kv d_s_eff 2/2 " in ln for ln in lines
               if ln.startswith("step"))
