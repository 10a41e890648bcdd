"""Port parity: the port's trainer against the JAX trainer, and the
hybrid family's chunked step, float32 on the CPU (the JAX init bridged
through ``repro_torch.weights``):

* two steps of the port's trainer equal two steps of the JAX trainer
  (``repro.launch.train.train`` on a 1x1 mesh, latency hiding off) from
  the same parameters: losses ``rtol 1e-5``, final parameters
  ``atol 1e-6`` (reduced gemma3-1b and olmoe-1b-7b).

On reduced hymba-1.5b (the hybrid attention + mamba family):

* one chunked step (a sequence split over 3 chunks whose split slices are
  not multiples of 64 rows, so pad rows sit in front of the carry; the
  KV and ``(h, conv_tail)`` carries with their gradient hand-off; the
  planner's non-zero remat table) equals ``jax.value_and_grad`` of the
  JAX ``DecoderLM.loss`` on each whole sequence, summed and divided by the
  valid tokens (an oracle without chunks, so without the reference's pad
  rows in front of a carry): loss ``rtol 1e-5``, gradients ``rtol 1e-4,
  atol 1e-6``;
* two steps of the port's trainer equal two steps of the JAX trainer on a
  batch the planner gives one chunk per step.

The chunked step of the dense and MoE families is in
``tests/test_torch_train.py``, whose helpers this file imports.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jget
from repro.core import ClusterSpec as JCluster
from repro.models import DecoderLM as JLM
from repro_torch.configs import get_arch
from repro_torch.core import ClusterSpec, CostModel, PlannerConfig, \
    plan_batch
from repro_torch.models.model import tree_leaves, unstack_layers
from repro_torch.runtime.train_step import ChunkedTrainer
from repro_torch.weights import from_jax

from test_torch_train import SMALL, _assert_tree_close, _jax_layout
from test_torch_threads import torch_thread_share  # noqa: F401


def test_two_steps_match_jax_trainer():
    _two_steps_match_jax_trainer("gemma3-1b")


def test_olmoe_two_steps_match_jax_trainer():
    _two_steps_match_jax_trainer("olmoe-1b-7b")


def _two_steps_match_jax_trainer(arch):
    from repro.launch.train import TrainLoopConfig
    from repro.launch.train import train as jtrain
    from repro_torch.launch.train import TrainConfig, train
    seed = 0
    jcfg, cfg = jget(arch).reduced(), get_arch(arch).reduced()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    loop = dict(steps=2, global_batch=4, context=256, dataset="github",
                seed=seed)
    jparams, _, jhist = jtrain(
        jcfg, mesh, TrainLoopConfig(**loop, compute_dtype="float32",
                                    lint="off", cache_dir=""),
        log=lambda *a: None)
    raw = jax.tree.map(np.asarray,
                       JLM(jcfg).init(jax.random.PRNGKey(seed), jnp.float32))
    # the JAX trainer plans for its default cluster: give the port the same
    jcl = JCluster(d_p=1, d_s=1)
    cluster = ClusterSpec(d_p=1, d_s=1, flops_per_chip=jcl.flops_per_chip,
                          hbm_bytes=jcl.hbm_bytes, hbm_bw=jcl.hbm_bw,
                          link_bw=jcl.ici_bw, net_bw=jcl.dcn_bw)
    trainer, hist = train(cfg, TrainConfig(**loop, compute_dtype="float32"),
                          device="cpu", params=from_jax(cfg, raw,
                                                        device="cpu"),
                          cluster=cluster, log=lambda *a: None)
    assert [h["tokens"] for h in hist] == [h["tokens"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    want = unstack_layers(from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu"))
    for a, b in zip(tree_leaves(trainer.params), tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-6,
                                   rtol=0)


def _hymba_case(seed=0):
    jcfg = jget("hymba-1.5b").reduced(**SMALL)
    cfg = get_arch("hymba-1.5b").reduced(**SMALL)
    rng = np.random.default_rng(seed)
    lens = [200] + [int(x) for x in rng.integers(24, 96, 5)]
    corpus = {i: rng.integers(0, 256, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec())
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
        capacity_bytes=cm.m_model_states(1) + 1e6))
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(seed)))
    return jcfg, cfg, corpus, plan, raw


def _whole_sequence_loss(jcfg, corpus):
    """Mean loss over every sequence's valid tokens, each sequence run
    whole through the JAX ``DecoderLM.loss`` (padded to one length with
    trailing pad rows, which no live row sees), jitted once."""
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
    return jax.jit(jax.value_and_grad(mean_loss))


def test_hymba_chunked_step_matches_whole_sequences():
    jcfg, cfg, corpus, plan, raw = _hymba_case()
    chunks = [c for p in plan.pipelines for c in p.chunks]
    assert max(s.n_chunks for s in plan.sequences) >= 3
    # pad rows in front of a carry: a chunk with dependents whose rows are
    # cut to a multiple of 64 beyond its tokens
    assert any(c.has_dependents and c.tokens % 64 for c in chunks)
    assert any(d > 0 for d in plan.ckpt_table()[0])
    jloss, jgrads = _whole_sequence_loss(jcfg, corpus)(
        jax.tree.map(jnp.asarray, raw))
    tr = ChunkedTrainer(cfg, from_jax(cfg, raw, device="cpu"), device="cpu",
                        compute_dtype=torch.float32)
    res = tr.loss_and_grads(plan, corpus)
    assert res.remat_layers > 0
    np.testing.assert_allclose(res.loss, float(jloss), rtol=1e-5)
    _assert_tree_close(_jax_layout(res.grads), jgrads, rtol=1e-4, atol=1e-6)


def test_hymba_two_steps_match_jax_trainer():
    from repro.launch.train import TrainLoopConfig
    from repro.launch.train import train as jtrain
    from repro_torch.launch.train import TrainConfig, train
    arch, seed = "hymba-1.5b", 0
    jcfg, cfg = jget(arch).reduced(), get_arch(arch).reduced()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    loop = dict(steps=2, global_batch=4, context=256, dataset="github",
                seed=seed)
    jparams, _, jhist = jtrain(
        jcfg, mesh, TrainLoopConfig(**loop, compute_dtype="float32",
                                    lint="off", cache_dir=""),
        log=lambda *a: None)
    raw = jax.tree.map(np.asarray,
                       JLM(jcfg).init(jax.random.PRNGKey(seed), jnp.float32))
    jcl = JCluster(d_p=1, d_s=1)
    cluster = ClusterSpec(d_p=1, d_s=1, flops_per_chip=jcl.flops_per_chip,
                          hbm_bytes=jcl.hbm_bytes, hbm_bw=jcl.hbm_bw,
                          link_bw=jcl.ici_bw, net_bw=jcl.dcn_bw)
    trainer, hist = train(cfg, TrainConfig(**loop, compute_dtype="float32"),
                          device="cpu", params=from_jax(cfg, raw,
                                                        device="cpu"),
                          cluster=cluster, log=lambda *a: None)
    assert [h["chunks"] for h in hist] == [1, 1]
    assert [h["tokens"] for h in hist] == [h["tokens"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    want = unstack_layers(from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu"))
    for a, b in zip(tree_leaves(trainer.params), tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-6,
                                   rtol=0)
