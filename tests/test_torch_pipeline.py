"""Port parity: the pipeline executor (``runtime/{sharding,program,
executor,pipeline}.py`` and ``train_step.PipelineTrainer``) against the
JAX package, on the CPU, float32, inputs from numpy seeds.

Reduced configs: d_model 64, vocab 256, 4 query heads of 16; 4 layers
where the JAX pipeline runs, 8 where the port's gradients are held (two
layers per stage at ``d_p = 4``, so that interleaving has virtual stages
there too).

* placement: the stage layers, the interleaved layer order and the active
  mask equal the JAX functions;
* action lists: at ``v = 1`` the plan's own stage schedule; at ``v > 1``
  forwards in ``simulate_occupancy``'s order and backwards in ``f2b`` order
  per virtual stage; each ``W`` after its ``B``; a circular list raises;
* dense loss: ``d_p = 2`` equals JAX's ``pipeline_loss_fn`` (run in a
  subprocess on two forced host devices) on the same plan and parameters
  within ``1e-5`` relative;
* gradients: every schedule at ``d_p`` in {2, 4}, split on and off, for
  gemma3-1b and hymba-1.5b (a sequence over 3 chunks with pad rows in
  front of the carries, a non-zero remat table on every stage) against
  ``jax.value_and_grad`` of the JAX loss over whole sequences: loss
  ``1e-5`` relative, each leaf within ``1e-4`` of its largest value;
* bit for bit: the split backward equals the fused one, the remat table
  equals a zeroed table, ``d_p = 1`` equals ``ChunkedTrainer``, the tied
  embedding's two copies after a step;
* MoE layers (reduced olmoe-1b-7b, 4 experts, top-2): ``d_p = 2`` under
  gpipe-1f1b and zero-bubble-h1 with the split equals ``ChunkedTrainer``
  on the one-stage plan and the whole-sequence JAX gradients at the
  limits above, and the split (whose weight-gradient store takes each
  stacked expert leaf whole) equals the fused backward bit for bit;
* three planted faults fall outside those limits;
* the CLI runs ``--mesh 2x1`` and pins the schedule's ``v``; what the
  sequence-parallel axis still refuses raises.

The per-arch gradient cases (against the whole sequences, the split's and
the remat table's bits), the MoE cases and the planted faults run from
``tests/test_torch_pipeline_{gemma,hymba,hymba4,moe}.py``, which import
this file's cases and checks: each file computes its arch's whole-sequence
oracle and runs once, and the files run side by side under ``pytest -n``.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

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
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.schedule import get_schedule, simulate_occupancy
from repro_torch.models.model import tree_leaves
from repro_torch.runtime import sharding
from repro_torch.runtime.executor import PipelineExecutor
from repro_torch.runtime.pipeline import PipelineGeometry, PipelineStage
from repro_torch.runtime.program import Action, stage_programs
from repro_torch.runtime.train_step import ChunkedTrainer, PipelineTrainer
from repro_torch.weights import DENSE_LEAVES, from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

SMALL = dict(d_model=64, n_heads=4, head_dim=16, vocab=256)
ARCHS = ("gemma3-1b", "hymba-1.5b")
SCHEDULES = ("gpipe-1f1b", "interleaved-1f1b", "zero-bubble-h1")
GRAD_LIMIT = 1e-4


# ---------------------------------------------------------------------------
# placement

@pytest.mark.parametrize("d_p,L,v", [(2, 4, 1), (2, 4, 2), (4, 26, 1),
                                     (2, 26, 13)])
def test_placement_matches_jax(d_p, L, v):
    from repro.runtime import sharding as jsh
    L_s = sharding.layers_per_stage(L, d_p)
    assert L_s == -(-L // d_p)
    np.testing.assert_array_equal(
        sharding.interleaved_layer_order(d_p, L_s, v),
        np.asarray(jsh.interleaved_layer_order(d_p, L_s, v)))
    ids = sharding.stage_layers(d_p, L, v)
    stacked = jsh.stack_stages({"a": jnp.arange(1, L + 1)}, d_p, L, v=v)
    np.testing.assert_array_equal(np.where(ids < L, ids + 1, 0),
                                  np.asarray(stacked["a"]))
    np.testing.assert_array_equal(sharding.stage_active_mask(d_p, L, v),
                                  np.asarray(jsh.stage_active_mask(d_p, L,
                                                                   v)))
    blocks = sharding.stage_blocks(d_p, L, v)
    assert sorted(i for b in blocks for blk in b for i in blk) == \
        list(range(L))
    # the layer order a chunk walks around the ring is the model's own
    ring = [i for j in range(v) for p in range(d_p) for i in blocks[p][j]]
    assert ring == list(range(L))


def test_stage_devices_go_round_the_cards():
    cards = [torch.device("cpu"), torch.device("meta")]
    assert sharding.stage_devices(4, cards) == cards * 2
    assert sharding.stage_devices(3, cards[:1]) == [cards[0]] * 3


# ---------------------------------------------------------------------------
# reduced cases and their oracles

def _plan(cfg, lens, d_p, **kw):
    cm = CostModel(cfg.spec, ClusterSpec(d_p=d_p))
    # a tight budget: the ILP remats layers of some chunks on every stage
    cap = max(cm.m_model_states(p) for p in range(1, d_p + 1)) + 1e6
    return cm, plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        capacity_bytes=cap, **kw))


@functools.lru_cache(maxsize=None)
def _case(arch, n_layers=8, seed=0):
    jcfg = jget(arch).reduced(n_layers=n_layers, **SMALL)
    cfg = get_arch(arch).reduced(n_layers=n_layers, **SMALL)
    rng = np.random.default_rng(seed)
    lens = [200] + [int(x) for x in rng.integers(24, 96, 5)]
    corpus = {i: rng.integers(0, 256, n).astype(np.int32)
              for i, n in enumerate(lens)}
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(seed)))
    return jcfg, cfg, lens, corpus, raw


@functools.lru_cache(maxsize=None)
def _whole(arch):
    """``jax.value_and_grad`` of the mean loss over whole sequences (each
    run unchunked through the JAX ``DecoderLM.loss``)."""
    jcfg, _, _, corpus, raw = _case(arch)
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


def _jax_layout(grads):
    """Port gradients (model structure, per-layer list, [d_out, d_in]) ->
    the reference's raw layout."""
    def stack(trees, name=""):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees], k) for k in trees[0]}
        a = np.stack([t.detach().cpu().numpy() for t in trees])
        return np.swapaxes(a, -1, -2) if name in DENSE_LEAVES else a
    out = {k: v.detach().cpu().numpy() for k, v in grads.items()
           if k != "layers"}
    out["layers"] = stack(grads["layers"])
    return out


def _worst(got, want):
    """The largest over leaves of max |g - g_want| / max |g_want|."""
    la, lb = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(la) == len(lb)
    return max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                 1e-30)
               for a, b in zip(la, lb))


def _v(sched, d_p, n_layers=8):
    return sharding.layers_per_stage(n_layers, d_p) \
        if sched == "interleaved-1f1b" else 1


def _trainer(arch, d_p, sched, split, cards=("cpu",)):
    _, cfg, lens, corpus, raw = _case(arch)
    cm, plan = _plan(cfg, lens, d_p)
    geom = PipelineGeometry(d_p=d_p, schedule=sched,
                            v_stages=_v(sched, d_p), split_bwd=split)
    tr = PipelineTrainer(cfg, from_jax(cfg, raw, device="cpu"),
                         geometry=geom, cards=list(cards),
                         compute_dtype=torch.float32, cost_model=cm)
    return tr, plan, corpus


@functools.lru_cache(maxsize=None)
def _run(arch, d_p, sched, split, policy="stage-aware"):
    tr, plan, corpus = _trainer(arch, d_p, sched, split)
    return tr.loss_and_grads(plan, corpus, remat_policy=policy)


def _within(res, arch):
    loss, grads = _whole(arch)
    rel = abs(res.loss - loss) / abs(loss)
    worst = _worst(_jax_layout(res.grads), grads)
    return rel, worst, rel <= 1e-5 and worst <= GRAD_LIMIT


def _bitwise(a, b):
    return a.loss == b.loss and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a.grads),
                                          tree_leaves(b.grads)))


# ---------------------------------------------------------------------------
# action lists

@pytest.mark.parametrize("d_p", [2, 4])
def test_action_lists_follow_the_schedules(d_p):
    _, cfg, lens, _, _ = _case("hymba-1.5b")
    _, plan = _plan(cfg, lens, d_p)
    for pipe in plan.pipelines:
        n = pipe.n_chunks
        fused = stage_programs(pipe, d_p)
        assert [[(a.op, a.chunk) for a in row] for row in fused] == \
            [[(t.op.value, t.chunk) for t in row] for row in pipe.schedule]
        split = stage_programs(pipe, d_p, split=True)
        for p, row in enumerate(split):
            assert [a for a in row if a.op != "W"] == fused[p]
            for a in row:
                if a.op == "W":
                    assert row.index(Action("B", a.chunk)) < row.index(a)
            assert sum(a.op == "W" for a in row) == n
        v = 2
        ring = stage_programs(pipe, d_p, v=v)
        grid = simulate_occupancy(get_schedule("interleaved-1f1b", v), n,
                                  d_p).grid
        b2f = pipe.b2f
        for p, row in enumerate(ring):
            assert [(a.chunk, a.vstage) for a in row if a.op == "F"] == \
                [r[p] for r in grid if r[p] is not None]
            for j in range(v):
                assert [a.chunk for a in row if a.op == "B" and
                        a.vstage == j] == b2f


class _Dummy:
    device = torch.device("cpu")

    def forward(self, k, j, x):
        return torch.zeros(1)

    def backward(self, k, j, g):
        return torch.zeros(1)

    def carry_grad_ready(self, k, j):
        return True


def test_circular_action_lists_raise():
    progs = [[Action("B", 0), Action("F", 0)],
             [Action("F", 0), Action("B", 0)]]
    with pytest.raises(RuntimeError, match=r"stuck.*B\(0,0\)"):
        PipelineExecutor([_Dummy(), _Dummy()], progs).run()


# ---------------------------------------------------------------------------
# the dense loss against the JAX pipeline

_JAX_PIPELINE = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    jax.config.update("jax_default_matmul_precision", "highest")
    from repro.configs import get_arch
    from repro.core import ClusterSpec, CostModel, PlannerConfig, plan_batch
    from repro.data import materialize_plan
    from repro.models import DecoderLM
    from repro.runtime import TrainStepBuilder, make_geometry
    from repro.runtime.pipeline import pipeline_loss_fn
    from repro.runtime.sharding import shard_dim_tree, shard_map_compat
    from repro.runtime.train_step import prepare_params

    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch).reduced(n_layers=4, **SMALL)
        mesh = jax.make_mesh((2, 1), ("data", "model"))
        cm = CostModel(cfg.spec, ClusterSpec(d_p=2, d_s=1))
        rng = np.random.default_rng(SEED)
        lens = [200] + [int(x) for x in rng.integers(24, 96, 5)]
        corpus = {i: rng.integers(0, 256, n).astype(np.int32)
                  for i, n in enumerate(lens)}
        plan = plan_batch(cm, lens, PlannerConfig(fixed_k=3,
                                                  bucket_rounding=16))
        b = materialize_plan(plan, corpus)
        n_chunks, cap = b.tokens.shape
        batch = {"tokens": np.where(b.seg >= 0, b.tokens, 0),
                 "targets": b.targets, "seg": b.seg,
                 "pos": np.where(b.seg >= 0, b.pos, 0),
                 "ctx_len": b.ctx_len}
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        ctx_cap = max(int(c) for c in b.ctx_len) + cap
        geom = make_geometry(cfg, mesh, n_chunks=n_chunks, cap=cap,
                             ctx_cap=ctx_cap, l_ckpt=0,
                             compute_dtype=jnp.float32)
        builder = TrainStepBuilder(cfg, mesh, geom, param_dtype=jnp.float32)
        raw = DecoderLM(cfg).init(jax.random.PRNGKey(SEED), jnp.float32)
        params = prepare_params(cfg, raw, mesh, jnp.float32)
        pspecs, _, bspecs = builder.specs(jax.eval_shape(lambda: params))
        loss_fn = pipeline_loss_fn(cfg, geom, shard_dim_tree(
            params["stages"], 1), pod_axis=None)
        mapped = jax.jit(shard_map_compat(
            loss_fn, mesh=mesh, in_specs=(pspecs, bspecs),
            out_specs=(P(), P()), check_vma=False))
        s, n = mapped(params, batch)
        out[arch] = {"sum": float(s), "n": float(n), "plan": plan.dumps()}
    print("RESULT " + json.dumps(out))
""")


@functools.lru_cache(maxsize=None)
def _jax_pipeline(archs, seed=0):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    head = f"ARCHS = {list(archs)!r}\nSMALL = {SMALL!r}\nSEED = {seed}\n"
    r = subprocess.run([sys.executable, "-c", head + _JAX_PIPELINE],
                       capture_output=True, text=True, env=env, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{r.stdout}\n"
                             f"{r.stderr[-4000:]}")
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch", ["gemma3-1b", "llama3.2-3b"])
def test_dense_loss_matches_jax_pipeline(arch):
    res = _jax_pipeline(("gemma3-1b", "llama3.2-3b"))[arch]
    _, cfg, _, corpus, raw = _case(arch, n_layers=4)
    plan = ExecutionPlan.loads(res["plan"])
    assert len(plan.ckpt_table()) == 2
    geom = PipelineGeometry(d_p=2, schedule=plan.schedule,
                            v_stages=plan.v_stages)
    tr = PipelineTrainer(cfg, from_jax(cfg, raw, device="cpu"),
                         geometry=geom, cards=["cpu"],
                         compute_dtype=torch.float32)
    got = tr.loss_and_grads(plan, corpus, remat_policy="none")
    assert got.n_valid == int(res["n"])
    want = res["sum"] / res["n"]
    assert abs(got.loss - want) <= 1e-5 * abs(want)


# ---------------------------------------------------------------------------
# gradients against the whole-sequence JAX loss

def test_reduced_plans_split_a_sequence_and_remat_every_stage():
    for arch in ARCHS:
        _, cfg, lens, _, _ = _case(arch)
        for d_p in (2, 4):
            _, plan = _plan(cfg, lens, d_p)
            chunks = [c for p in plan.pipelines for c in p.chunks]
            assert max(s.n_chunks for s in plan.sequences) >= 3
            assert any(c.has_dependents and c.tokens % 64 for c in chunks)
            assert all(any(row) for row in plan.ckpt_table())


def check_whole_sequences(arch, d_p, sched, split):
    """``test_pipeline_matches_whole_sequences`` (run from the per-arch
    files)."""
    res = _run(arch, d_p, sched, split)
    assert res.remat_layers > 0
    assert res.pipeline["handoffs"] > 0
    if sched != "interleaved-1f1b":
        # the plan's own order: the planner's model gives its estimate
        _, cfg, lens, _, _ = _case(arch)
        est = [max(p.est_peak_mem[s] for p in _plan(cfg, lens, d_p)[1]
                   .pipelines) for s in range(d_p)]
        np.testing.assert_allclose(res.pipeline["order_peak_mem"], est,
                                   rtol=1e-12)
    rel, worst, ok = _within(res, arch)
    assert ok, (rel, worst)


# ---------------------------------------------------------------------------
# bit for bit

def check_split_is_fused(arch, d_p, sched):
    """``test_split_backward_is_the_fused_one``."""
    assert _bitwise(_run(arch, d_p, sched, True),
                    _run(arch, d_p, sched, False))


def check_remat_table_bits(arch, d_p, sched):
    """``test_remat_table_does_not_change_the_bits``."""
    base = _run(arch, d_p, sched, sched == "zero-bubble-h1")
    zeroed = _run(arch, d_p, sched, sched == "zero-bubble-h1", "none")
    # (the interleaved order still remats the forwards it takes past a
    # stage's budget: program.Action.remat)
    assert base.remat_layers > zeroed.remat_layers
    assert zeroed.remat_layers == 0 or sched == "interleaved-1f1b"
    assert _bitwise(base, zeroed)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_stage_is_the_chunked_trainer(arch, split):
    _, cfg, lens, corpus, raw = _case(arch)
    _, plan = _plan(cfg, lens, 1)
    params = from_jax(cfg, raw, device="cpu")
    want = ChunkedTrainer(cfg, params, device="cpu",
                          compute_dtype=torch.float32).loss_and_grads(
                              plan, corpus)
    got = PipelineTrainer(cfg, params, geometry=PipelineGeometry(
        d_p=1, split_bwd=split), cards=["cpu"],
        compute_dtype=torch.float32).loss_and_grads(plan, corpus)
    assert want.remat_layers == got.remat_layers > 0
    assert _bitwise(got, want)


MOE = "olmoe-1b-7b"


def check_moe_pipeline(sched, split):
    """``test_moe_pipeline_equals_the_chunked_trainer``."""
    _, cfg, lens, corpus, raw = _case(MOE)
    _, plan = _plan(cfg, lens, 2)
    assert max(s.n_chunks for s in plan.sequences) >= 3
    assert all(any(row) for row in plan.ckpt_table())
    res = _run(MOE, 2, sched, split)
    assert res.remat_layers > 0 and res.pipeline["handoffs"] > 0
    want = ChunkedTrainer(cfg, from_jax(cfg, raw, device="cpu"),
                          device="cpu", compute_dtype=torch.float32
                          ).loss_and_grads(_plan(cfg, lens, 1)[1], corpus)
    assert res.n_valid == want.n_valid
    assert abs(res.loss - want.loss) <= 1e-5 * abs(want.loss)
    worst = _worst(_jax_layout(res.grads), _jax_layout(want.grads))
    assert worst <= GRAD_LIMIT, worst
    rel, worst, ok = _within(res, MOE)
    assert ok, (rel, worst)


def check_moe_split_is_fused():
    """``test_moe_split_backward_is_the_fused_one``."""
    assert _bitwise(_run(MOE, 2, "zero-bubble-h1", True),
                    _run(MOE, 2, "zero-bubble-h1", False))


def test_tied_copies_take_the_same_update():
    tr, plan, corpus = _trainer("gemma3-1b", 2, "zero-bubble-h1", True,
                                cards=("cpu", "cpu"))
    first, last = tr.params[0]["embed"], tr.params[-1]["embed"]
    assert first is not last and torch.equal(first, last)
    before = first.detach().clone()
    # the global norm counts the tied weight once: the model's gradients'
    grads = tree_leaves(tr.loss_and_grads(plan, corpus).grads)
    want = float(torch.sqrt(sum(g.square().sum() for g in grads)))
    for step in range(2):
        res = tr.step(plan, corpus)
        assert np.isfinite(res.loss)
        if step == 0:
            assert res.grad_norm == pytest.approx(want, rel=1e-6)
        assert torch.equal(first, last)
    assert not torch.equal(first, before)


# ---------------------------------------------------------------------------
# planted faults

def _fault_run(fault):
    arch = "hymba-1.5b"
    sched = "interleaved-1f1b" if fault == "wrong virtual stage" \
        else "zero-bubble-h1"
    tr, plan, corpus = _trainer(arch, 2, sched, sched == "zero-bubble-h1")
    patches = []
    if fault == "stream gradient dropped":
        orig = PipelineExecutor._send_grad
        sent = []

        def faulty(self, s, k, g):
            if s % self.d_p == 1 and not sent:
                sent.append(k)
                g = torch.zeros_like(g)
            orig(self, s, k, g)
        patches.append((PipelineExecutor, "_send_grad", orig, faulty))
    elif fault == "tied gradient dropped":
        orig = PipelineTrainer._sum_tied

        def faulty(self, accs):
            accs[-1][self.tied[1]].zero_()
            orig(self, accs)
        patches.append((PipelineTrainer, "_sum_tied", orig, faulty))
    else:
        orig = PipelineStage.forward

        def faulty(self, k, j, x):
            # the stream meant for virtual stage 1 runs through stage 0's
            # virtual stage 0 instead (chunk 0 only)
            if self.p == 0 and j == 1 and k == 0:
                blocks, self.blocks = self.blocks, [self.blocks[0]] * 2 + \
                    self.blocks[2:]
                try:
                    return orig(self, k, j, x)
                finally:
                    self.blocks = blocks
            return orig(self, k, j, x)
        patches.append((PipelineStage, "forward", orig, faulty))
    for obj, name, _, new in patches:
        setattr(obj, name, new)
    try:
        return tr.loss_and_grads(plan, corpus)
    finally:
        for obj, name, old, _ in patches:
            setattr(obj, name, old)


FAULTS = ("stream gradient dropped", "tied gradient dropped",
          "wrong virtual stage")


def check_fault_caught(fault):
    """``test_planted_faults_fall_outside_the_limits``."""
    assert _within(_run("hymba-1.5b", 2, "zero-bubble-h1", True),
                   "hymba-1.5b")[2]
    rel, worst, ok = _within(_fault_run(fault), "hymba-1.5b")
    assert not ok, (fault, rel, worst)


# ---------------------------------------------------------------------------
# the CLI

def test_cli_runs_two_stages_and_pins_v():
    from repro_torch.launch.train import TrainConfig, main, train
    assert main(["--device", "cpu", "--reduced", "--mesh", "2x1", "--steps",
                 "2", "--batch", "4", "--context", "128"]) == 0
    cfg = get_arch("hymba-1.5b").reduced()
    seen = []
    trainer, hist = train(
        cfg, TrainConfig(steps=2, global_batch=4, context=256,
                         compute_dtype="float32", d_p=2,
                         schedule="interleaved-1f1b"),
        device="cpu", log=lambda *a: None,
        on_step=lambda step, plan, corpus, trainer: seen.append(
            (plan.schedule, plan.v_stages)))
    assert trainer.geom.v_stages > 1
    assert seen == [("interleaved-1f1b", trainer.geom.v_stages)] * 2
    assert all(np.isfinite(h["loss"]) and h["handoffs"] > 0 and
               len(h["stage_plan_mem_gb"]) == 2 for h in hist)


def test_cli_refuses_a_sequence_parallel_axis():
    """What the SP axis still refuses: a stage's SP ranks across cards
    (the per-rank driver, item 2: ZeRO-3 gave each rank its own shards);
    the encoder-decoder at ``S > 1`` trains (its frame-sharded memory);
    the geometry takes ``d_s > 1`` with the reference's checks."""
    from repro_torch.launch.train import main
    assert main(["--device", "cpu", "--reduced", "--arch",
                 "seamless-m4t-v2", "--mesh", "2x2", "--steps", "1",
                 "--batch", "2", "--context", "128"]) == 0
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        main(["--device", "cpu", "--reduced", "--mesh", "1x2", "--cards",
              "2", "--steps", "1", "--batch", "2", "--context", "128"])
    assert PipelineGeometry(d_p=2, d_s=2, policy="allgather_kv").d_s_eff == 2
    with pytest.raises(ValueError, match="needs d_s > 1"):
        PipelineGeometry(d_p=2, policy="allgather_kv")


@pytest.mark.parametrize("d_p", [1, 2])
def test_trainers_free_their_parameters_without_the_collector(d_p):
    """After ``launch/train.train`` (two float32 steps of reduced gemma3-1b
    on one stage or two), dropping the trainer frees its parameters at
    once, with the garbage collector off: no reference cycle (the trainer's
    gradient hooks, a SwiGLU gradient carrying its projection's graph)
    keeps a trainer's states on the card into the next phase."""
    import gc
    import weakref

    from repro_torch.launch.train import TrainConfig, train
    cfg = get_arch("gemma3-1b").reduced(n_layers=4)
    loop = TrainConfig(steps=2, global_batch=4, context=256, seed=0,
                       compute_dtype="float32", d_p=d_p)
    gc.collect()
    gc.disable()
    try:
        trainer, _ = train(cfg, loop, device="cpu", log=lambda s: None)
        params = trainer.params[0] if d_p > 1 else trainer.params
        refs = [weakref.ref(trainer), weakref.ref(params["embed"])]
        del trainer, params
        assert [r() is None for r in refs] == [True, True]
    finally:
        gc.enable()
