"""Port parity: the port's serving engine against the JAX engine.

The JAX ``ServeEngine`` runs on a ``(1, 1)`` ("data", "model") mesh on the
CPU; its float32 stage-layout parameters are bridged into the port, and
both engines serve the same trace. Output ids must be equal for every
request, on reduced gemma3-1b (6 layers: window-8 locals and one global
layer), reduced llama3.2-3b and reduced olmoe-1b-7b (the MoE block on
every row of a step, pad rows included, against the JAX engine's
expert-parallel block at one shard). The port must also agree with itself
across k=2 / k=1, prefix cache on / off, chunked / whole-prompt prefill,
preemption under page pressure, and with its own ``one_shot_generate``;
and its ``prompt_slices`` must equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.core import ClusterSpec as JaxClusterSpec
from repro.core import CostModel as JaxCostModel
from repro.core.chunking import prompt_slices as jax_prompt_slices
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_arch
from repro_torch.core import ClusterSpec, CostModel, prompt_slices
from repro_torch.serve.engine import (EngineConfig, Request, ServeEngine,
                                      one_shot_generate)
from repro_torch.weights import from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

ARCHS = {"gemma3-1b": dict(n_layers=6), "llama3.2-3b": dict(),
         "olmoe-1b-7b": dict()}
GEOM = dict(n_items=4, cap_t=16, n_pages=48, page_sz=8, pages_per_seq=8)


def _trace(cls, vocab, n=8, seed=7, lo=3, hi=40, max_new=5, spread=0.5,
           sys_prompt=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
        if sys_prompt is not None:
            p = np.concatenate([sys_prompt, p])
        out.append(cls(req_id=i, prompt=p, max_new_tokens=max_new,
                       arrival=float(i) * spread))
    return out


def _run(cfg, params, reqs, **econf):
    eng = ServeEngine(cfg, EngineConfig(**{**GEOM, **econf}), params=params,
                      device="cpu")
    res = eng.run(reqs)
    return eng, {r: res[r].output_ids for r in res}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def served(request):
    """(port cfg, bridged params, JAX engine ids) for one arch."""
    name = request.param
    jcfg = jax_get_arch(name).reduced(**ARCHS[name])
    cfg = get_arch(name).reduced(**ARCHS[name])
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jeng = JaxServeEngine(jcfg, mesh, JaxEngineConfig(**GEOM, k=1),
                          param_dtype=jnp.float32, seed=3)
    jres = jeng.run(_trace(JaxRequest, cfg.spec.vocab))
    params = from_jax(cfg, jax.tree.map(np.asarray, jeng.params),
                      device="cpu")
    return cfg, params, {r: jres[r].output_ids for r in jres}


def test_engine_ids_equal_jax_engine(served):
    cfg, params, jax_ids = served
    eng, got = _run(cfg, params, _trace(Request, cfg.spec.vocab))
    assert len(got) == len(jax_ids) == 8
    assert got == jax_ids
    assert eng.stats()["completed"] == 8


def test_engine_matches_own_one_shot_and_k2(served):
    cfg, params, jax_ids = served
    reqs = _trace(Request, cfg.spec.vocab)
    ref = one_shot_generate(cfg, params, [r.prompt for r in reqs], 5,
                            device="cpu")
    assert {i: ref[i] for i in range(len(ref))} == jax_ids
    eng, got_k2 = _run(cfg, params, reqs, k=2)
    assert got_k2 == jax_ids
    assert eng.spec_stats.drafted > 0


def test_chunked_prefill_matches_whole_prompt(served):
    cfg, params, _ = served
    reqs = lambda: _trace(Request, cfg.spec.vocab, n=6, seed=5, lo=10,  # noqa: E731
                          hi=30, max_new=4)
    _, chunked = _run(cfg, params, reqs(), n_items=6, cap_t=8)
    _, whole = _run(cfg, params, reqs(), cap_t=32)
    assert chunked == whole


def test_prefix_cache_on_off(served):
    cfg, params, _ = served
    sysp = np.random.default_rng(17).integers(
        0, cfg.spec.vocab, 16).astype(np.int32)
    reqs = lambda: _trace(Request, cfg.spec.vocab, n=6, seed=9, lo=2,  # noqa: E731
                          hi=12, max_new=4, spread=2.0, sys_prompt=sysp)
    on, ids_on = _run(cfg, params, reqs(), n_pages=64)
    off, ids_off = _run(cfg, params, reqs(), n_pages=64, prefix_cache=False)
    assert ids_on == ids_off
    hits = on.stats()["kv_pool"]["prefix_hit_rows"]
    assert hits > 0
    assert off.stats()["prefill_tokens_fed"] - \
        on.stats()["prefill_tokens_fed"] == hits


def test_prompt_slices_equal_jax():
    for name in ARCHS:
        jcm = JaxCostModel(jax_get_arch(name).spec,
                           JaxClusterSpec(d_p=1, d_s=1))
        cm = CostModel(get_arch(name).spec, ClusterSpec())
        for cap in (8, 16, 64, 512):
            for ln in list(range(1, 80)) + [513, 1000, 2047, 4096, 9999]:
                assert prompt_slices(cm, ln, cap) == \
                    jax_prompt_slices(jcm, ln, cap), (name, cap, ln)


def test_preemption_keeps_outputs(served):
    """Page pressure with preemption on: streams lose their pages and
    resume-prefill, and every request still emits the JAX engine's ids."""
    cfg, params, jax_ids = served
    eng, got = _run(cfg, params, _trace(Request, cfg.spec.vocab),
                    n_pages=12, preempt_waiting_steps=1)
    assert got == jax_ids
    assert sum(r.preempted for r in eng.results.values()) > 0


def test_windowed_layers_gather_only_their_window():
    """``pack_step`` gathers, for a layer with window ``w``, exactly the
    whole-context key rows that a query at position ``>= base`` can see
    (position ``> base - w``), in the same order; the step's own rows
    follow unchanged."""
    from repro_torch.kernels.flash_attention import BLOCK_KV
    from repro_torch.runtime.serve_step import (PackedSegment,
                                                make_engine_geometry,
                                                pack_step)
    cfg = get_arch("gemma3-1b").reduced(n_layers=6)
    geom = make_engine_geometry(cfg, n_items=2, cap_t=16, n_pages=20,
                                page_sz=8)
    assert geom.windows == (0, 8)
    table = [4, 2, 9, 7, 1]
    segs = [PackedSegment(0, 0, 3, [1] * 5, 30, table, False),
            PackedSegment(0, 5, 5, [2], 6, [11], True),
            PackedSegment(1, 0, 3, [1] * 4, 35, table, False)]
    b = pack_step(geom, segs, "cpu")
    T, full, win = 32, b.kv[0], b.kv[8]
    base = np.array([30, 6])                  # step segment ids 0 and 1
    for kv in (full, win):
        assert len(kv.ctx_rows) % BLOCK_KV == 0
        assert len(kv.seg) == len(kv.pos) == len(kv.ctx_rows) + T
        assert kv.seg[-T:].tolist() == b.seg.tolist()
        assert kv.pos[-T:].tolist() == b.pos.tolist()
    fseg, fpos = full.seg[:-T].numpy(), full.pos[:-T].numpy()
    assert sorted(fseg[fseg >= 0].tolist()) == [0] * 30 + [1] * 6
    keep = (fseg >= 0) & (fpos > base[np.maximum(fseg, 0)] - 8)
    wseg = win.seg[:-T].numpy()
    live = wseg >= 0
    assert wseg[live].tolist() == fseg[keep].tolist()
    assert win.pos[:-T].numpy()[live].tolist() == fpos[keep].tolist()
    assert win.ctx_rows.numpy()[live].tolist() == \
        full.ctx_rows.numpy()[keep].tolist()
    assert fpos[keep].tolist() == list(range(23, 30)) + list(range(6))


def test_greedy_head_tie_rule():
    """Vocabulary-tiled greedy head: the lowest id of the maximum wins,
    within a tile and across tiles, as ``np.argmax`` over full logits."""
    import torch

    from repro_torch.runtime.serve_step import HEAD_BLOCK_V, greedy_ids
    V, D = 2 * HEAD_BLOCK_V + 10, 8
    w = torch.zeros(V, D)
    h = torch.ones(2, D)
    for i in (HEAD_BLOCK_V + 3, 2 * HEAD_BLOCK_V + 1, 7, 9):
        w[i] = 1.0
    assert greedy_ids(h, w).tolist() == [7, 7]
    w[7] = w[9] = 0.5
    assert greedy_ids(h, w).tolist() == [HEAD_BLOCK_V + 3] * 2
    assert greedy_ids(h, w, vocab_true=HEAD_BLOCK_V).tolist() == [7, 7]
    rng = np.random.default_rng(0)
    hr = rng.standard_normal((5, D)).astype(np.float32)
    wr = rng.standard_normal((V, D)).astype(np.float32)
    assert greedy_ids(torch.from_numpy(hr), torch.from_numpy(wr)).tolist() \
        == np.argmax(hr @ wr.T, axis=1).tolist()
