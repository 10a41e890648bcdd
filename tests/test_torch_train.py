"""Port parity: the port's chunked training step and trainer against the
JAX package's.

On reduced gemma3-1b, llama3.2-3b and olmoe-1b-7b (4 experts, top-2: the
port's dispatched MoE block against the reference's dense one) in
float32, with the JAX init bridged through ``repro_torch.weights``:

* one chunked step (a sequence split over 3 chunks with the KV carry and
  its dKV hand-off, packed hybrid chunks, two pipelines, the planner's own
  non-zero remat table) equals ``jax.value_and_grad`` of the single-device
  ``reference_loss`` oracle of ``tests/test_runtime_pipeline.py``: loss
  ``rtol 1e-5``, gradients ``rtol 1e-4, atol 1e-6`` (float32 sums taken in
  another order over a few hundred tokens);
* remat and chunking do not change the math: the step with the plan's
  table, with the table zeroed, and one unchunked forward and backward per
  sequence agree (``rtol 1e-5``);
* AdamW equals ``repro.optim.adamw_update`` (``rtol 1e-5``: the port
  computes the schedule and bias corrections in double, the reference in
  float32).

Two steps of the port's trainer against the JAX trainer, and the hybrid
family's chunked step, are in ``tests/test_torch_train_steps.py`` (which
imports this file's helpers), so that the two files run side by side
under ``pytest -n``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.core import ClusterSpec as JCluster
from repro.core import CostModel as JCost
from repro.core import PlannerConfig as JConfig
from repro.core import plan_batch as jplan
from repro.data.batching import materialize_chunks as jmat
from repro.models import DecoderLM as JLM
from repro_torch.configs import get_arch
from repro_torch.core import ClusterSpec, CostModel, PlannerConfig, \
    plan_batch
from repro_torch.models.model import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime.train_step import ChunkedTrainer
from repro_torch.weights import DENSE_LEAVES, from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

ARCHS = ("gemma3-1b", "llama3.2-3b", "olmoe-1b-7b")
SMALL = dict(n_layers=4, d_model=64, n_heads=4, head_dim=16, vocab=256)


def reference_loss(cfg, raw_params, chunks, corpus, cap, ctx_cap):
    """The single-device oracle: every chunk in order through
    ``DecoderLM.forward_chunk`` with the context carry threaded through."""
    model = JLM(cfg)
    total, count = jnp.float32(0), jnp.float32(0)
    cb = jmat(chunks, corpus, cap)
    ctx = model.init_ctx(ctx_cap, jnp.float32)
    for k in range(cb.tokens.shape[0]):
        tok = jnp.asarray(cb.tokens[k])
        tgt = jnp.asarray(cb.targets[k])
        sg = jnp.asarray(cb.seg[k])
        ps = jnp.asarray(cb.pos[k])
        h, ctx = model.forward_chunk(raw_params, tok, sg, ps, ctx=ctx,
                                     ctx_len=int(cb.ctx_len[k]),
                                     compute_dtype=jnp.float32)
        s, n = model.chunk_loss(raw_params, h, tgt, sg)
        total += s
        count += n
    return total, count


def _case(arch, seed=0):
    jcfg, cfg = jget(arch).reduced(**SMALL), get_arch(arch).reduced(**SMALL)
    rng = np.random.default_rng(seed)
    lens = [192] + [int(x) for x in rng.integers(24, 96, 5)]
    corpus = {i: rng.integers(0, 256, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec())
    # a tight memory budget: the ILP checkpoints some layers of some chunks
    conf = dict(fixed_k=3, bucket_rounding=16, remat_mode="stage_aware",
                capacity_bytes=cm.m_model_states(1) + 1e6)
    plan = plan_batch(cm, lens, PlannerConfig(**conf))
    jc = JCost(jcfg.spec, JCluster(d_p=1, d_s=1, flops_per_chip=989e12,
                                   hbm_bytes=80e9, hbm_bw=3.35e12,
                                   ici_bw=450e9, dcn_bw=50e9))
    jp = jplan(jc, lens, JConfig(**conf))
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(seed)))
    return jcfg, cfg, corpus, plan, jp, raw


def _jax_layout(grads):
    """Port gradients (per-layer list, [d_out, d_in]) -> the reference's
    raw layout ([L, ...] stacked, [d_in, d_out])."""
    def stack(trees, name=""):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees], k) for k in trees[0]}
        a = np.stack([t.detach().cpu().numpy() for t in trees])
        return np.swapaxes(a, -1, -2) if name in DENSE_LEAVES else a
    out = {k: v.detach().cpu().numpy() for k, v in grads.items()
           if k != "layers"}
    out["layers"] = stack(grads["layers"])
    return out


def _assert_tree_close(a, b, **tol):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _case(request.param)


def test_plan_exercises_carry_packing_and_remat(case):
    _, _, _, plan, jp, _ = case
    chunks = [c for p in plan.pipelines for c in p.chunks]
    assert max(s.n_chunks for s in plan.sequences) >= 3
    assert any(c.kind.value == "hybrid" for c in chunks)
    assert any(d > 0 for d in plan.ckpt_table()[0])
    d = plan.to_json()
    e = jp.to_json()
    d.pop("solve_time"), e.pop("solve_time")
    assert d == e


def test_chunked_step_matches_reference_oracle(case):
    jcfg, cfg, corpus, plan, jp, raw = case
    chunks = [c for p in jp.pipelines for c in p.chunks]
    cap = jp.chunk_capacity
    ctx_cap = max(c.context for c in chunks) + cap

    def mean_loss(p):
        s, n = reference_loss(jcfg, p, chunks, corpus, cap, ctx_cap)
        return s / n
    jloss, jgrads = jax.value_and_grad(mean_loss)(
        jax.tree.map(jnp.asarray, raw))
    tr = ChunkedTrainer(cfg, from_jax(cfg, raw, device="cpu"), device="cpu",
                        compute_dtype=torch.float32)
    res = tr.loss_and_grads(plan, corpus)
    assert res.remat_layers > 0
    np.testing.assert_allclose(res.loss, float(jloss), rtol=1e-5)
    _assert_tree_close(_jax_layout(res.grads), jgrads, rtol=1e-4, atol=1e-6)


def test_remat_and_chunking_do_not_change_the_math(case):
    _, cfg, corpus, plan, _, raw = case
    tr = ChunkedTrainer(cfg, from_jax(cfg, raw, device="cpu"), device="cpu",
                        compute_dtype=torch.float32)
    runs = [tr.loss_and_grads(plan, corpus),
            tr.loss_and_grads(plan, corpus, remat_policy="none"),
            tr.sequence_loss_and_grads(corpus)]
    assert runs[0].remat_layers > 0 and runs[1].remat_layers == 0
    for r in runs[1:]:
        assert r.n_valid == runs[0].n_valid
        np.testing.assert_allclose(r.loss, runs[0].loss, rtol=1e-5)
        for a, b in zip(tree_leaves(r.grads), tree_leaves(runs[0].grads)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)


def test_adamw_matches_reference():
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import adamw_update as jupdate
    from repro.optim import init_opt_state as jinit
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = dict(warmup_steps=2, total_steps=10, grad_clip=0.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jinit(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = init_opt_state(tp)
    for step in range(4):
        grads = {k: rng.standard_normal(s).astype(np.float32) * (step + 1)
                 for k, s in shapes.items()}
        jp, jst, jm = jupdate(JAdamW(**cfg), jp,
                              {k: jnp.asarray(v) for k, v in grads.items()},
                              jst, grad_scale=jnp.float32(0.25))
        tp, tst, tm = adamw_update(
            AdamWConfig(**cfg), tp,
            {k: torch.from_numpy(v) for k, v in grads.items()}, tst,
            grad_scale=0.25)
        tol = dict(rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **tol)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), **tol)
        for k in shapes:
            for a, b in ((tp[k], jp[k]), (tst["m"][k], jst["m"][k]),
                         (tst["v"][k], jst["v"][k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("block", [7, 12, 1 << 30])
def test_adamw_blocks_keep_the_bits(monkeypatch, block):
    """The update walks each leaf in blocks of rows (``UPDATE_BLOCK``
    elements; its temporaries stay a block's) and gives the whole leaf's
    bits: blocks of 7 and 12 elements over leaves of 3 x 4, 5 x 3, 2 x 2 x
    3 and a 0-d one against one block a leaf."""
    import repro_torch.optim.adamw as adamw
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5, 3), "c": (2, 2, 3), "d": ()}
    runs = []
    for size in (block, 1 << 30):
        monkeypatch.setattr(adamw, "UPDATE_BLOCK", size)
        n = len(adamw._blocks(torch.zeros(5, 3)))
        assert n == (1 if size > 15 else -(-5 // max(1, size // 3)))
        params = {k: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for k, s in shapes.items()}
        params = {k: v.clone() for k, v in sorted(params.items())}
        state = init_opt_state(params)
        g = torch.Generator().manual_seed(2)
        for step in range(3):
            grads = {k: torch.randn(s, generator=g) for k, s in
                     shapes.items()}
            adamw.adamw_update(AdamWConfig(warmup_steps=1), params, grads,
                               state)
        runs.append([params, state["master"], state["m"], state["v"]])
        rng = np.random.default_rng(1)
    for a, b in zip(*runs):
        for k in shapes:
            assert torch.equal(a[k], b[k]), k


def test_model_loss_matches_jax(case):
    """``DecoderLM.loss`` (one context-free packed chunk: forward, final
    norm, fused cross-entropy) equals the JAX model's, float32 ``1e-5``."""
    from repro_torch.models import DecoderLM
    jcfg, cfg, corpus, _, _, raw = case
    seqs = [corpus[1], corpus[2]]
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
        *(torch.from_numpy(a).long() if a is tok or a is tgt
          else torch.from_numpy(a) for a in (tok, tgt, seg, pos)),
        compute_dtype=torch.float32)
    assert float(tn) == float(jn) == len(tok) - 7 - 2
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)


def test_memory_peak_summary_replays_the_trace():
    """``memory_peak_summary`` replays an allocation history: the peak
    counts the blocks allocated before the window (the baseline), a block
    counts from its ``alloc`` to its ``free_completed``, and the blocks
    live at the peak are grouped by their innermost frame of the port."""
    from repro_torch.runtime.profile import memory_peak_summary

    def frame(name, line):
        return {"filename": f"/x/src/repro_torch/{name}", "line": line,
                "name": "f"}
    trace = [
        {"action": "alloc", "addr": 1, "size": 300,
         "frames": [frame("models/layers.py", 7)]},
        {"action": "alloc", "addr": 2, "size": 100,
         "frames": [{"filename": "/lib/torch/x.py", "line": 1, "name": "g"},
                    frame("models/layers.py", 9)]},
        {"action": "alloc", "addr": 3, "size": 100,
         "frames": [frame("models/layers.py", 9)]},
        {"action": "free_requested", "addr": 1, "size": 300},
        {"action": "free_completed", "addr": 1, "size": 300},
        {"action": "free_completed", "addr": 99, "size": 50},  # pre-window
        {"action": "alloc", "addr": 4, "size": 200, "frames": []},
    ]
    out = memory_peak_summary({"device_traces": [trace]}, 1000)
    assert out["peak_gb"] == 1500 / 1e9
    assert out["baseline_gb"] == 1000 / 1e9
    assert out["window_live_at_peak_gb"] == 500 / 1e9
    sites = {(r["site"], r["count"]): r["total_gb"]
             for r in out["live_at_peak"]}
    assert sites == {("models/layers.py:7 f", 1): 300 / 1e9,
                     ("models/layers.py:9 f", 2): 200 / 1e9}


def test_memory_snapshot_needs_the_card(tmp_path, capsys):
    """``launch/train.py --memory-snapshot`` records the CUDA allocator's
    history: on the CPU it refuses before training, writes nothing and
    says why (tests/test_torch_gpu.py drives it on the card)."""
    from repro_torch.launch.train import main
    path = tmp_path / "snap.pickle"
    rc = main(["--device", "cpu", "--reduced", "--steps", "1", "--batch",
               "2", "--context", "64", "--memory-snapshot", str(path)])
    assert rc == 2 and not path.exists()
    assert "--memory-snapshot" in capsys.readouterr().err

