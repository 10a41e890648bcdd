"""Port parity: the encoder-decoder's pipelined trainer
(``runtime/encdec_pipeline.py``, ``train_step.EncDecTrainer``) against
the JAX package, on the CPU, float32, inputs from numpy seeds.

Reduced seamless-m4t-v2 as in ``tests/test_torch_encdec.py`` (2 encoder
and 2 decoder layers, d_model 64, 4 query and 2 KV heads of 16), six
sequences of 33 to 150 tokens with as many frames each (numpy), planned
with ``fixed_k=1`` into chunks of at most 160 tokens. At ``d_p`` 2 and 4
under gpipe-1f1b, interleaved-1f1b (``v = 1``) and zero-bubble-h1 (the
split backward), with a stage-aware remat table whose encoder and decoder
rows differ, the loss and every gradient leaf equal ``jax.value_and_grad``
of the JAX ``EncDecLM.loss`` over the whole sequences within 1e-5
relative (``RTOL``); so does the trainer's own whole-batch
``sequence_loss_and_grads``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import EncDecLM as JEncDec
from test_torch_encdec import _close, _model, _params
from test_torch_threads import torch_thread_share  # noqa: F401

LENS = (150, 60, 41, 95, 33, 70)


@functools.lru_cache(maxsize=None)
def _corpus(seed=7):
    rng = np.random.default_rng(seed)
    corpus = {i: rng.integers(0, 256, n).astype(np.int32)
              for i, n in enumerate(LENS)}
    frames = {i: rng.normal(0, 0.5, (n, 64)).astype(np.float32)
              for i, n in enumerate(LENS)}
    return corpus, frames


@functools.lru_cache(maxsize=None)
def _whole():
    """``jax.value_and_grad`` of the mean loss over whole sequences, each
    encoded and decoded unchunked by the JAX ``EncDecLM.loss``."""
    jcfg, cfg, raw = _model()
    corpus, frames = _corpus()
    jm = JEncDec(jcfg)

    def f(p):
        tot = n = 0.0
        for sid in sorted(corpus):
            toks = corpus[sid]
            L = len(toks)
            seg = jnp.zeros(L, jnp.int32)
            pos = jnp.arange(L, dtype=jnp.int32)
            tgt = jnp.asarray(np.append(toks[1:], -1).astype(np.int32))
            loss, nv = jm.loss(p, jnp.asarray(frames[sid]), seg, pos,
                               jnp.asarray(toks), tgt, seg, pos,
                               compute_dtype=jnp.float32)
            tot, n = tot + loss, n + nv
        return tot / n
    loss, g = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, raw))
    return float(loss), _params(cfg, jax.tree.map(np.asarray, g))


def _encdec_plan(cfg, d_p, schedule, table):
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    cm = CostModel(cfg.spec, ClusterSpec(d_p=d_p))
    plan = plan_batch(cm, list(LENS), PlannerConfig(
        fixed_k=1, bucket_rounding=16, remat_mode="stage_aware",
        v_stages=1, sp_degree=1, schedule=schedule, token_capacity=160))
    n = plan.n_chunks
    for pipe in plan.pipelines:     # encoder and decoder rows that differ
        pipe.ckpt = [[table[p][k % len(table[p])]
                      for k in range(pipe.n_chunks)] for p in range(d_p)]
    assert plan.k_split == 1 and n >= 2
    return cm, plan


TABLES = {2: ((1, 0, 2), (2, 1, 0)), 4: ((1, 0), (0, 1), (1, 1), (0, 0))}


@pytest.mark.parametrize("schedule", ["gpipe-1f1b", "interleaved-1f1b",
                                      "zero-bubble-h1"])
@pytest.mark.parametrize("d_p", [2, 4])
def test_pipelined_trainer_matches_jax(d_p, schedule):
    from repro_torch.core.schedule import get_schedule
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.encdec_pipeline import EncDecGeometry
    from repro_torch.runtime.train_step import EncDecTrainer
    jcfg, cfg, raw = _model()
    corpus, frames = _corpus()
    cm, plan = _encdec_plan(cfg, d_p, schedule, TABLES[d_p])
    split = get_schedule(schedule, 1).split_bwd
    geom = EncDecGeometry(d_p=d_p, schedule=schedule, split_bwd=split)
    tr = EncDecTrainer(cfg, _params(cfg, raw), geometry=geom, cards=["cpu"],
                       compute_dtype=torch.float32, cost_model=cm)
    tframes = {k: torch.from_numpy(v) for k, v in frames.items()}
    res = tr.loss_and_grads(plan, corpus, tframes)
    assert res.remat_layers > 0
    rows = [r for r in plan.ckpt_table()]
    assert rows[0] != rows[-1]
    want_loss, want = _whole()
    _close(res.loss, want_loss)
    for a, b in zip(tree_leaves(res.grads), tree_leaves(want)):
        _close(a.numpy(), b.numpy())
    if d_p == 2 and schedule == "gpipe-1f1b":
        # the whole-batch step on the same parameters equals both
        ref = tr.sequence_loss_and_grads(corpus, tframes)
        _close(ref.loss, want_loss)
        for a, b in zip(tree_leaves(ref.grads), tree_leaves(want)):
            _close(a.numpy(), b.numpy())
