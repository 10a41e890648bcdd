"""Port parity: the encoder-decoder on the sequence-parallel and pod axes
(``runtime/encdec_pipeline.EncDecSPStage``, ``train_step.EncDecTrainer``
at ``d_s > 1`` and ``n_pods > 1``, ``EncDecLM``'s SP hooks) against the
JAX package, on the CPU, float32, inputs from numpy seeds.

Reduced seamless-m4t-v2 (``tests/test_torch_encdec._model``: 2 encoder and
2 decoder layers, d_model 64, 4 query and 2 KV heads of 16) and the six
sequences of ``tests/test_torch_encdec_pipeline.py``, planned at the
reference's SP point (``fixed_k=1``, allgather_kv over every rank) into
chunks of at most 160 tokens, under a remat table whose encoder and
decoder rows differ. The oracle is that file's ``_whole()``:
``jax.value_and_grad`` of the JAX ``EncDecLM.loss`` over whole sequences
(the JAX multi-device executor cannot be one on this tree: ``ROADMAP.md``
§3). At ``(d_p, d_s)`` (2, 2), (2, 4) and (4, 2) under gpipe-1f1b,
interleaved-1f1b at ``v = 1`` and zero-bubble-h1, in both ZeRO-3 modes,
and on 2 pods at (2, 1) and (2, 2), the loss and every gradient leaf are
within 1e-5 relative (``RTOL``). Also:

* each rank owns its ``1 / d_s`` share of its stage's state (the bytes
  ``state_bytes`` reports, counted here from the shards), within the
  charge ``rank_charges`` gives its stage;
* a rank whose block of a chunk is all padding hands back zero gradients
  for it, and the step still equals the oracle;
* two planted faults fall outside the limit: each rank's cross-attention
  reading its own rank's frames only, and a rank's memory gradient
  dropped on its way back to the encoder;
* two runs are equal bit for bit; the geometry holds the reference's SP
  pin, and the CLI trains ``--mesh 2x2``.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import ClusterSpec, CostModel, PlannerConfig, \
    plan_batch
from repro_torch.core.schedule import get_schedule
from repro_torch.models.model import tree_leaves
from repro_torch.runtime.encdec_pipeline import EncDecGeometry
from repro_torch.runtime.train_step import EncDecTrainer
from test_torch_encdec import RTOL, _model, _params
from test_torch_encdec_pipeline import LENS, TABLES, _corpus, _whole
from test_torch_threads import torch_thread_share  # noqa: F401


def _sp_plan(cfg, d_p, d_s, schedule, n_pods=1):
    cm = CostModel(cfg.spec, ClusterSpec(d_p=d_p, d_s=d_s))
    plan = plan_batch(cm, list(LENS), PlannerConfig(
        fixed_k=1, bucket_rounding=16, remat_mode="stage_aware",
        v_stages=1, sp_policy="allgather_kv" if d_s > 1 else "auto",
        sp_degree=d_s, schedule=schedule, token_capacity=160))
    table = TABLES[d_p]
    for pipe in plan.pipelines:     # encoder and decoder rows that differ
        pipe.ckpt = [[table[p][k % len(table[p])]
                      for k in range(pipe.n_chunks)] for p in range(d_p)]
    assert plan.k_split == 1
    if d_s > 1:
        assert (plan.sp.policy, plan.sp.d_s_eff) == ("allgather_kv", d_s)
    if n_pods > 1:
        plan = split_pipelines(plan, n_pods)
    return cm, plan


def split_pipelines(plan, n):
    """``plan``'s one pipeline cut into ``n`` pipelines of consecutive
    chunks (each its own backward order, its schedule made again), so that
    every pod of ``n`` takes one: at these lengths and ``K = 1`` the
    planner makes one pipeline of four chunks."""
    import dataclasses
    (pipe,) = plan.pipelines
    subs = []
    for idx in np.array_split(np.arange(pipe.n_chunks), n):
        a, b = int(idx[0]), int(idx[-1]) + 1
        order = sorted(range(a, b), key=lambda i: pipe.f2b[i])
        subs.append(dataclasses.replace(
            pipe, chunks=pipe.chunks[a:b],
            f2b=[order.index(i) for i in range(a, b)], schedule=[],
            ckpt=[row[a:b] for row in pipe.ckpt], ckpt_diag=[]))
    return dataclasses.replace(plan, pipelines=subs)


def trainer(d_p, d_s, schedule, mode="per_tick", n_pods=1):
    _, cfg, raw = _model()
    cm, plan = _sp_plan(cfg, d_p, d_s, schedule, n_pods)
    geom = EncDecGeometry(d_p=d_p, schedule=schedule,
                          split_bwd=get_schedule(schedule, 1).split_bwd,
                          d_s=d_s, zero3_mode=mode if d_s > 1 else None)
    tr = EncDecTrainer(cfg, _params(cfg, raw), geometry=geom, cards=["cpu"],
                       compute_dtype=torch.float32, cost_model=cm,
                       n_pods=n_pods)
    return tr, plan


def _frames():
    corpus, frames = _corpus()
    return corpus, {k: torch.from_numpy(v) for k, v in frames.items()}


@contextlib.contextmanager
def encdec_sp_fault(fault):
    """A planted fault (undone on exit), as ``chip_smoke._encdec_sp_fault``:
    "cross-attention over its own rank's frames" gives each rank's
    cross-attention its own memory block in place of the gathered one;
    "a rank's memory gradient dropped" zeroes rank 1's block of the memory
    gradient the last stage hands back."""
    from repro_torch.runtime import sp
    from repro_torch.runtime.executor import PipelineExecutor
    if fault == "cross-attention over its own rank's frames":
        obj, name = sp, "gather_memory"

        def new(memory, seg_mem):
            return list(zip(memory, seg_mem))
    elif fault == "a rank's memory gradient dropped":
        obj, name = PipelineExecutor, "_send_grad"
        orig = PipelineExecutor._send_grad

        def new(self, s, k, g):
            if s == self.d_p - 1:
                g = (g[0], torch.zeros_like(g[1]), *g[2:])
            orig(self, s, k, g)
    else:
        raise ValueError(fault)
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


@functools.lru_cache(maxsize=None)
def run(d_p, d_s, schedule, mode="per_tick", n_pods=1, fault=None):
    tr, plan = trainer(d_p, d_s, schedule, mode, n_pods)
    corpus, frames = _frames()
    with (encdec_sp_fault(fault) if fault else contextlib.nullcontext()):
        return tr.loss_and_grads(plan, corpus, frames)


def worst(res):
    """The loss's relative difference from the oracle and the largest
    gradient leaf's (relative to the leaf's largest value)."""
    want_loss, want = _whole()
    rel = abs(res.loss - want_loss) / abs(want_loss)
    err = 0.0
    for a, b in zip(tree_leaves(res.grads), tree_leaves(want)):
        a, b = a.double().numpy(), b.double().numpy()
        err = max(err, np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    return rel, err


def within(res):
    rel, err = worst(res)
    return rel <= RTOL and err <= RTOL, (rel, err)


CASES = [(2, 2, "gpipe-1f1b", "per_tick"),
         (2, 2, "gpipe-1f1b", "per_step"),
         (2, 2, "interleaved-1f1b", "per_tick"),
         (2, 2, "interleaved-1f1b", "per_step"),
         (2, 2, "zero-bubble-h1", "per_tick"),
         (2, 2, "zero-bubble-h1", "per_step"),
         (2, 4, "gpipe-1f1b", "per_tick"),
         (2, 4, "interleaved-1f1b", "per_step"),
         (2, 4, "zero-bubble-h1", "per_step"),
         (4, 2, "gpipe-1f1b", "per_step"),
         (4, 2, "interleaved-1f1b", "per_tick"),
         (4, 2, "zero-bubble-h1", "per_tick")]


@pytest.mark.parametrize("d_p,d_s,schedule,mode", CASES)
def test_sp_step_matches_jax(d_p, d_s, schedule, mode):
    res = run(d_p, d_s, schedule, mode)
    assert res.remat_layers > 0
    pipe = res.pipeline
    assert (pipe["sp_policy"], pipe["d_s_eff"], pipe["d_s"]) == \
        ("allgather_kv", d_s, d_s)
    z = pipe["zero3"]
    assert z["mode"] == mode and z["gathers"] > 0
    # one memory gather a decoder stage and chunk, its bytes counted
    dec_stages = sum(st.role == "decoder" for st in trainer(
        d_p, d_s, schedule, mode)[0].stages)
    assert pipe["memory_gathers"] == dec_stages * res.chunks
    assert 0 < pipe["memory_bytes"] < pipe["collective_bytes"]
    ok, errs = within(res)
    assert ok, errs


@pytest.mark.parametrize("d_s", [1, 2])
def test_pods_match_jax(d_s):
    res = run(2, d_s, "gpipe-1f1b", n_pods=2)
    assert res.pipeline["n_pods"] == 2
    assert all(c > 0 for c in res.pipeline["pod_chunks"])
    assert sum(res.pipeline["pod_n_valid"]) == res.n_valid
    ok, errs = within(res)
    assert ok, errs


def test_pods_step_keeps_replicas_equal():
    tr, plan = trainer(2, 2, "zero-bubble-h1", n_pods=2)
    corpus, frames = _frames()
    res = tr.step(plan, corpus, frames)
    assert np.isfinite(res.loss) and res.grad_norm > 0
    for pod in tr.replicas:
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tr.params), tree_leaves(pod.params)))
    with pytest.raises(NotImplementedError, match="compressed"):
        _, cfg, raw = _model()
        EncDecTrainer(cfg, _params(cfg, raw), geometry=tr.geom,
                      cards=["cpu"], compute_dtype=torch.float32,
                      n_pods=2, compress_pod_grads=True)


def test_sp_steps_are_bitwise_repeatable():
    key = (2, 2, "zero-bubble-h1", "per_tick")
    a = run(*key)
    tr, plan = trainer(*key)
    b = tr.loss_and_grads(plan, *_frames())
    assert a.loss == b.loss
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.grads),
                                                  tree_leaves(b.grads)))


@pytest.mark.parametrize("fault", ["cross-attention over its own rank's "
                                   "frames",
                                   "a rank's memory gradient dropped"])
def test_planted_faults_fall_outside_the_limit(fault):
    key = (2, 2, "gpipe-1f1b", "per_tick")
    assert within(run(*key))[0]
    ok, errs = within(run(*key, fault=fault))
    assert not ok, (fault, errs)


@pytest.mark.parametrize("d_p,d_s", [(2, 2), (4, 2), (2, 4)])
def test_ranks_own_their_share_of_the_state(d_p, d_s):
    """Each rank owns ``1 / d_s`` of its stage's elements but its whole
    leaves, as ``state_bytes`` reports (counted here from the shards and
    the stage's whole tree), under the charge of its stage's parameters
    (``rank_charges``, float32 here: 4 bytes a live parameter where the
    charge counts 2) plus its whole leaves and its share of what the
    planner's count leaves out."""
    tr, plan = trainer(d_p, d_s, "gpipe-1f1b")
    sb = tr.state_bytes()
    charge = tr.rank_charges(tr.cm)
    per = 4 + 16
    for p, (own, whole) in enumerate(zip(sb["rank_state_bytes"],
                                         sb["whole_state_bytes"])):
        full = sum(t.numel() for t in tree_leaves(tr._full(
            p, tr.params[p]))) * per
        for r, (o, w) in enumerate(zip(own, whole)):
            assert o == sum(t.numel() for t in tree_leaves(
                tr.params[p][r])) * per
            assert abs((o - w) - (full - w) / d_s) <= 1, (p, r, o, w, full)
            assert o <= charge[p] * per / 18 + w + \
                sb["uncounted_state_bytes"], (p, r, o, charge[p])
    # the embedding's vocabulary blocks and the norms' shards
    first = [st.role for st in tr.stages].index("decoder")
    lay = tr.layouts[first]
    assert lay["embed"].sizes == (256 // d_s,) * d_s
    assert not lay["embed"].gathered
    assert lay["enc_norm"].dim == 0 and lay["enc_norm"].gathered
    assert tr.layouts[-1]["final_norm"].dim == 0


def test_a_block_of_padding_hands_back_zero_gradients(monkeypatch):
    """At (2, 4) a short chunk's rows round up to 256 (64 a rank), so
    the last ranks' blocks of its frames and tokens are all padding: the
    stream gradients the decoder stage hands back for those blocks (the
    memory's) and the encoder's input blocks are zero; the step equals the
    oracle."""
    from repro_torch.runtime.encdec_pipeline import EncDecSPStage
    tr, plan = trainer(2, 4, "gpipe-1f1b")
    seen = []
    real = EncDecSPStage.backward

    def backward(self, k, j, g):
        out = real(self, k, j, g)
        segs = self.inputs(k)[1]
        if out is not None:
            for r, seg in enumerate(segs):
                if bool((seg < 0).all()):
                    seen.append((self.p, k, r, float(out[r].abs().max())))
        return out
    monkeypatch.setattr(EncDecSPStage, "backward", backward)
    res = tr.loss_and_grads(plan, *_frames())
    assert seen, "no chunk had a rank block of padding only"
    assert all(x == 0.0 for *_, x in seen), seen
    ok, errs = within(res)
    assert ok, errs


def test_geometry_holds_the_references_pin():
    g = EncDecGeometry(d_p=2, d_s=2)
    assert (g.policy, g.d_s_eff, g.zero3_mode) == ("allgather_kv", 2,
                                                   "per_tick")
    assert EncDecGeometry(d_p=2).policy == "none"
    assert EncDecGeometry(d_p=2, d_s=2, zero3_mode="per_step").zero3_mode \
        == "per_step"
    with pytest.raises(ValueError, match="reference's SP point"):
        EncDecGeometry(d_p=2, d_s=2, policy="ulysses")
    with pytest.raises(ValueError, match="reference's SP point"):
        EncDecGeometry(d_p=2, d_s=4, d_s_eff=2)
    with pytest.raises(ValueError, match="v_stages=1"):
        EncDecGeometry(d_p=2, d_s=2, v_stages=2)
    with pytest.raises(ValueError, match="d_p >= 2"):
        EncDecGeometry(d_p=1, d_s=2)
    with pytest.raises(ValueError, match="zero3_mode"):
        EncDecGeometry(d_p=2, d_s=2, zero3_mode="per_layer")


def test_cli_trains_seamless_at_2x2_and_logs_its_sp_fields():
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import TrainConfig, main, train
    assert main(["--device", "cpu", "--reduced", "--arch",
                 "seamless-m4t-v2", "--mesh", "2x2", "--steps", "1",
                 "--batch", "4", "--context", "128"]) == 0
    lines = []
    cfg = get_arch("seamless-m4t-v2").reduced()
    _, hist = train(cfg, TrainConfig(
        steps=1, global_batch=4, context=256, compute_dtype="float32",
        d_p=2, d_s=2, n_pods=2), device="cpu", log=lines.append)
    assert "[sp] policy=allgather_kv d_s_eff=2/2 (pinned)" in lines
    h = hist[0]
    assert np.isfinite(h["loss"]) and h["n_pods"] == 2
    assert h["frame_rows_per_rank"] > 0 and h["memory_gather_bytes"] > 0
    assert all(" frames/rank " in ln for ln in lines if ln.startswith("step"))
    with pytest.raises(ValueError, match="reference's SP point"):
        train(cfg, TrainConfig(steps=1, global_batch=4, context=256,
                               compute_dtype="float32", d_p=2, d_s=2,
                               sp_policy="ulysses"), device="cpu",
              log=lines.append)
