"""Port parity: the pods' int8 gradient all-reduce with error feedback
(``repro_torch/optim/compression.py``) against the JAX package's
``optim/compression.py`` on the CPU, and the pod axis of
``PipelineTrainer`` (``n_pods``, ``compress_pod_grads``).

* ``q8_psum`` / ``compressed_psum`` equal the reference's ``_q8_psum`` /
  ``compressed_psum`` under ``jax.vmap`` with the pod axis name, bit for
  bit: the sum, every pod's new error, and a second round with the errors
  fed back;
* the reference's ``test_compression_error_feedback_converges``, ported;
* a reduced float32 step on 2 pods (each a ``1 x 2`` ZeRO-3 pipeline)
  equals the one-pod step, and its compressed run stays within the
  quantisation bound ``n_pods * scale / 2`` of the uncompressed sum.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import _q8_psum
from repro.optim.compression import compressed_psum as jax_compressed_psum
from repro_torch.models.model import tree_leaves
from repro_torch.optim.compression import (compressed_psum, init_error_state,
                                           q8_psum)
from test_torch_threads import torch_thread_share  # noqa: F401


def _grads(rng, n_pods, shapes, scales):
    return [{f"g{i}": (rng.standard_normal(s) * c).astype(np.float32)
             for i, (s, c) in enumerate(zip(shapes, scales))}
            for _ in range(n_pods)]


def _jax_round(grads, errs):
    """The reference over the pods: ``jax.vmap`` with axis ``"pod"``."""
    stack = lambda ts: jax.tree.map(  # noqa: E731
        lambda *a: jnp.stack(a), *ts)
    f = jax.vmap(lambda g, e: jax_compressed_psum(g, e, "pod"),
                 axis_name="pod")
    s, e = f(stack(grads), stack(errs))
    return (jax.tree.map(np.asarray, s), jax.tree.map(np.asarray, e))


def _torch_tree(t):
    return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}


SHAPES = [(7, 33), (64,), (3, 5, 8), (1,)]
SCALES = [1.0, 1e-3, 250.0, 0.0]


@pytest.mark.parametrize("n_pods", [2, 4])
def test_compressed_psum_is_the_reference_bit_for_bit(n_pods):
    rng = np.random.default_rng(n_pods)
    grads = _grads(rng, n_pods, SHAPES, SCALES)
    errs = [{k: np.zeros_like(v) for k, v in g.items()} for g in grads]
    for _ in range(2):                          # the errors fed back
        want_s, want_e = _jax_round(grads, errs)
        got_s, got_e = compressed_psum([_torch_tree(g) for g in grads],
                                       [_torch_tree(e) for e in errs])
        for k in grads[0]:
            for q in range(n_pods):
                assert np.array_equal(got_s[k].numpy(), want_s[k][q]), k
                assert np.array_equal(got_e[q][k].numpy(), want_e[k][q]), k
        errs = [{k: v.numpy() for k, v in e.items()} for e in got_e]
        grads = _grads(rng, n_pods, SHAPES, SCALES)


def test_q8_psum_of_one_leaf_is_the_reference_and_bounded():
    rng = np.random.default_rng(7)
    gs = [rng.standard_normal((16, 16)).astype(np.float32) for _ in range(3)]
    es = [(rng.standard_normal((16, 16)) * 1e-3).astype(np.float32)
          for _ in range(3)]
    f = jax.vmap(lambda g, e: _q8_psum(g, e, "pod"), axis_name="pod")
    want_s, want_e = (np.asarray(x) for x in f(jnp.stack(gs),
                                               jnp.stack(es)))
    got_s, got_e = q8_psum([torch.from_numpy(g) for g in gs],
                           [torch.from_numpy(e) for e in es])
    assert np.array_equal(got_s.numpy(), want_s[0])
    for q in range(3):
        assert np.array_equal(got_e[q].numpy(), want_e[q])
    # each pod's residual is at most half a step: the sum within 3 * s / 2
    scale = max(np.abs(g + e).max() for g, e in zip(gs, es)) / 127.0
    exact = sum(g + e for g, e in zip(gs, es))
    assert np.abs(got_s.numpy() - exact).max() <= 3 * scale / 2 * 1.0001


def test_compression_error_feedback_converges():
    """The reference's test: quantised with error feedback (one pod),
    averaged over steps the bias vanishes."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 1, (256,)).astype(np.float32))
    err = init_error_state({"g": g})
    total = torch.zeros_like(g)
    steps = 50
    for _ in range(steps):
        out, (err,) = compressed_psum([{"g": g}], [err])
        total = total + out["g"]
    np.testing.assert_allclose((total / steps).numpy(), g.numpy(), rtol=0,
                               atol=2e-2)


def test_dropping_the_error_feedback_keeps_the_bias():
    """Without the residual fed back, a repeated gradient's rounding error
    adds up: the mean's error stays at the one-step error, far above the
    converged one (the planted fault of ``chip_smoke.py``)."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 1, (256,)).astype(np.float32))
    zero = init_error_state({"g": g})
    fed, dropped = torch.zeros_like(g), torch.zeros_like(g)
    err = zero
    for _ in range(50):
        out, (err,) = compressed_psum([{"g": g}], [err])
        fed = fed + out["g"]
        out, _ = compressed_psum([{"g": g}], [zero])
        dropped = dropped + out["g"]
    bound = float(g.abs().max()) / 127 / 2
    assert float((fed - 50 * g).abs().max()) <= bound * 1.001
    assert float((dropped - 50 * g).abs().max()) > 10 * bound


# ---------------------------------------------------------------------------
# the pod axis of the trainer

@functools.lru_cache(maxsize=None)
def _pod_case():
    from test_torch_zero3 import sp_setup
    return sp_setup("gemma3-1b", 1, 2, "allgather_kv", 2, "gpipe-1f1b")


def _pod_trainer(n_pods, compress=False):
    from repro_torch.runtime.pipeline import PipelineGeometry
    from repro_torch.runtime.train_step import PipelineTrainer
    cfg, params, cm, plan, corpus = _pod_case()
    geom = PipelineGeometry(d_p=1, d_s=2, policy="allgather_kv", d_s_eff=2)
    return PipelineTrainer(cfg, params, geometry=geom, cards=["cpu"],
                           compute_dtype=torch.float32, cost_model=cm,
                           n_pods=n_pods, compress_pod_grads=compress)


def test_pod_plans_take_whole_pipelines():
    from repro_torch.runtime.train_step import pod_plans
    _, _, _, plan, _ = _pod_case()
    assert len(plan.pipelines) >= 2
    for n in (2, 3):
        subs = pod_plans(plan, n)
        assert len(subs) == n
        assert [p for s in subs for p in s.pipelines] == plan.pipelines
        assert sum(s.n_chunks for s in subs) == plan.n_chunks
    assert pod_plans(plan, 1) == [plan]


def test_two_pods_equal_the_one_pod_step():
    from test_torch_sp_pipeline import _jax_layout, _worst
    _, _, _, plan, corpus = _pod_case()
    one = _pod_trainer(1).loss_and_grads(plan, corpus)
    two = _pod_trainer(2).loss_and_grads(plan, corpus)
    assert two.n_valid == one.n_valid
    assert two.pipeline["n_pods"] == 2 and sum(
        two.pipeline["pod_chunks"]) == plan.n_chunks
    # the pods differentiate their summed losses and scale the sum by
    # 1 / n_valid (the reference's order), the one pod seeds each chunk
    # with 1 / n_valid: float32 rounding apart (~1e-6 of a leaf's largest
    # value), within the 1e-5 the card's verify phase holds them to
    assert abs(two.loss - one.loss) <= 1e-6 * abs(one.loss)
    assert _worst(_jax_layout(two.grads), _jax_layout(one.grads)) <= 1e-5


def test_compressed_pods_stay_within_the_quantisation_bound():
    """Each pod's gradient sums, summed through int8 (the trainer's
    ``reduce_pods``), against their plain sum: each element within
    ``n_pods * scale / 2`` (scaled by ``1 / n_valid`` as the step scales
    them); two steps of the compressed trainer keep their pods' states
    equal and their losses finite."""
    _, _, _, plan, corpus = _pod_case()
    tr = _pod_trainer(2, compress=True)
    runs = tr.pod_runs(plan, corpus)
    n_valid = sum(r.n_valid for r, _ in runs)
    accs = [a for _, a in runs]
    plain = [[sum(a[p][i] for a in accs) / n_valid
              for i in range(len(accs[0][p]))] for p in range(len(accs[0]))]
    from repro_torch.optim.compression import q8_scale
    scales = [[float(q8_scale([a[p][i] for a in accs],
                              [torch.zeros_like(accs[0][p][i])] * 2))
               for i in range(len(accs[0][p]))] for p in range(len(accs[0]))]
    got = tr.reduce_pods(accs, n_valid)
    worst = max(float((g - w).abs().max()) / (2 * s / 2 / n_valid)
                for gp, wp, sp in zip(got, plain, scales)
                for g, w, s in zip(gp, wp, sp) if s > 1e-30)
    assert worst <= 1.0001, worst
    assert tr.err is not None and any(
        float(e.abs().max()) > 0 for e in tree_leaves(tr.err[1]))
    tr2 = _pod_trainer(2, compress=True)
    losses = [tr2.step(plan, corpus).loss for _ in range(2)]
    assert all(np.isfinite(losses))
    for a, b in zip(tree_leaves(tr2.pods[0].params),
                    tree_leaves(tr2.pods[1].params)):
        assert torch.equal(a, b)
