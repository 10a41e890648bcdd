"""Port parity: the serving engine on a ``(d_p, d_s)`` mesh against the JAX
engine at the same mesh.

The JAX ``ServeEngine`` runs once per module in a subprocess with four
fake CPU devices (as ``tests/test_serve_engine.py`` runs it), at the
meshes ``(2, 1)``, ``(1, 2)``, ``(2, 2)`` and ``(1, 4)``, on reduced
gemma3-1b (window-8 layers and one global layer), llama3.2-3b and
olmoe-1b-7b (expert parallelism over the ranks); it saves its float32
stage-layout parameters, every request's ids and, after ``SNAP`` steps
(before any request finishes), its global pool with the running requests'
page tables. The port's engine, given the same parameters through
``from_jax``, must emit the same ids and hold the same committed rows
(read through each request's page table, the ranks' blocks of the JAX pool
at ``r * (n_pages_loc + 1)``), within 1e-5 of their largest magnitude. It
must also agree with itself across k=2 / k=1, chunked / whole-prompt
prefill and preemption, copy pages across ranks for a shared system
prompt, refuse what the reference refuses, slice prompts as the reference
does at each mesh, and record the reference's ``engine`` telemetry event.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (JAX on the CPU in this process too)
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import ClusterSpec as JaxClusterSpec
from repro.core import CostModel as JaxCostModel
from repro.core.chunking import prompt_slices as jax_prompt_slices
from repro.runtime.serve_step import EngineGeometry as JaxEngineGeometry
from repro.runtime.serve_step import engine_pool_struct
from repro_torch.configs import get_arch
from repro_torch.core import ClusterSpec, CostModel, prompt_slices
from repro_torch.kernels.flash_attention import BLOCK_KV
from repro_torch.runtime import serve_step as ss
from repro_torch.serve import engine as port_engine
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.telemetry import StepTimeline
from repro_torch.weights import from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

ARCHS = {"gemma3-1b": dict(n_layers=5), "llama3.2-3b": dict(),
         "olmoe-1b-7b": dict()}
MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))
GEOM = dict(n_items=4, cap_t=16, n_pages=24, page_sz=8, pages_per_seq=6)
SEED = 3            # the JAX engines' parameter seed
SNAP = 4            # steps before the pool snapshot: nothing has finished
COW_MESHES = ((1, 2), (2, 2))
ROW_TOL = 1e-5


def trace(cls, vocab, n=8, seed=7, lo=3, hi=28, max_new=6, spread=0.4,
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


def sys_trace(cls, vocab):
    """Requests behind a shared 12-token system prompt, arriving while
    the first still runs: each adopts its first page and, partly, its
    second, whose first write copies it (to a page of any rank)."""
    sysp = np.random.default_rng(17).integers(0, vocab, 12).astype(np.int32)
    return trace(cls, vocab, n=8, seed=9, lo=2, hi=14, max_new=6,
                 spread=0.5, sys_prompt=sysp)


def drive(eng, reqs, snap_at=None, on_snap=None):
    """``ServeEngine.run``'s loop (the same for both engines), calling
    ``on_snap(eng)`` after step ``snap_at``; returns each request's ids."""
    pending = sorted(reqs, key=lambda r: r.arrival)
    i = 0
    while i < len(pending) or eng.n_active:
        while i < len(pending) and pending[i].arrival <= eng.sim_time:
            eng.submit(pending[i])
            i += 1
        if not eng.n_active and i < len(pending):
            eng.sim_time = pending[i].arrival
            continue
        eng.step()
        if eng.step_count == snap_at:
            on_snap(eng)
    return {r: eng.results[r].output_ids for r in eng.results}


def snapshot(eng):
    """The running requests' page tables and committed rows, and how many
    requests have finished."""
    run = [st for st in eng._running if st.committed]
    return {"tables": {st.req.req_id: list(eng.pool.table_of(st.req.req_id))
                       for st in run},
            "committed": {st.req.req_id: st.committed for st in run},
            "finished": len(eng.results)}


_ORACLE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    from test_torch_serve_mesh import (ARCHS, COW_MESHES, GEOM, MESHES,
                                       SEED, SNAP, drive, snapshot,
                                       sys_trace, trace)
    from repro.configs import get_arch
    from repro.runtime.serve_step import make_engine_geometry
    from repro.serve import EngineConfig, Request, ServeEngine
    from repro.telemetry import StepTimeline

    out = {}
    for name, kw in ARCHS.items():
        cfg = get_arch(name).reduced(**kw)
        V = cfg.spec.vocab
        for dp, ds in MESHES:
            mesh = jax.make_mesh((dp, ds), ("data", "model"))
            eng = ServeEngine(cfg, mesh, EngineConfig(**GEOM),
                              param_dtype=jnp.float32, seed=SEED)
            rec = {}
            if (dp, ds) == MESHES[0]:
                rec["params"] = jax.tree.map(np.asarray, eng.params)

            def on_snap(e):
                rec["snap"] = snapshot(e)
                rec["pool"] = {k: np.asarray(v)
                               for k, v in e.pool_state.items()}
            rec["ids"] = drive(eng, trace(Request, V), SNAP, on_snap)
            if name == "llama3.2-3b" and (dp, ds) in COW_MESHES:
                tl = StepTimeline(name="serve")
                eng = ServeEngine(cfg, mesh, EngineConfig(**GEOM),
                                  params=eng.params, param_dtype=jnp.float32,
                                  cache=eng.cache, timeline=tl)
                res = eng.run(sys_trace(Request, V))
                rec["sys_ids"] = {r: res[r].output_ids for r in res}
                rec["sys_cow"] = eng.pool.stats.cow_copies
                rec["events"] = [dict(e) for e in tl.events()]
            out[(name, dp, ds)] = rec
    mesh = jax.make_mesh((1, 2), ("data", "model"))
    cfg = get_arch("llama3.2-3b").reduced()
    out["refusals"] = {}
    for what, kw in (("cap_t", dict(cap_t=15, n_pages=24)),
                     ("n_pages", dict(cap_t=16, n_pages=23))):
        try:
            make_engine_geometry(cfg, mesh, n_items=4, page_sz=8, **kw)
            out["refusals"][what] = None
        except Exception as e:
            out["refusals"][what] = type(e).__name__
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


def _cfg(name):
    return get_arch(name).reduced(**ARCHS[name])


def _engine(name, mesh, params, **kw):
    return ServeEngine(_cfg(name), EngineConfig(**{**GEOM, **kw}),
                       params=params, d_p=mesh[0], d_s=mesh[1], device="cpu")


def _port_run(name, mesh, params):
    """The port's run of the oracle's trace: ids, and at step ``SNAP`` the
    snapshot and each running request's committed K and V rows."""
    cfg = _cfg(name)
    eng = _engine(name, mesh, params)
    rec = {"engine": eng}

    def on_snap(e):
        rec["snap"] = snapshot(e)
        rec["rows"] = {rid: [ss.read_rows(cfg, e.geom, e.pool_state, table,
                                          rec["snap"]["committed"][rid], nm)
                             for nm in ("cache_k", "cache_v")]
                       for rid, table in rec["snap"]["tables"].items()}
    rec["ids"] = drive(eng, trace(Request, cfg.spec.vocab), SNAP, on_snap)
    return rec


def _port_cow_run(mesh, params):
    """The shared-prompt trace through ``run`` with a timeline, every
    copy-on-write pair recorded."""
    name, pairs = "llama3.2-3b", []
    real = port_engine.copy_pages

    def spy(geom, pool, prs):
        pairs.extend(prs)
        return real(geom, pool, prs)
    port_engine.copy_pages = spy
    try:
        tl = StepTimeline(name="serve")
        eng = ServeEngine(_cfg(name), EngineConfig(**GEOM), params=params,
                          d_p=mesh[0], d_s=mesh[1], device="cpu",
                          timeline=tl)
        res = eng.run(sys_trace(Request, _cfg(name).spec.vocab))
    finally:
        port_engine.copy_pages = real
    return {"ids": {r: res[r].output_ids for r in res}, "pairs": pairs,
            "engine": eng, "events": [dict(e) for e in tl.events()]}


CASES = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, port)``: the JAX engines' records (from a subprocess with
    four CPU devices, saved under ``tmp_path``) and the port's runs of the
    same traces with the same parameters (the JAX engine's ``SEED``
    parameters at the first mesh through ``from_jax``: the padded rows and
    slots of other meshes are dropped, the rest is the same ``DecoderLM.
    init``)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(here, "..", "src"),
                                         here])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _ORACLE, str(tmp / "jax.pkl")],
                       capture_output=True, text=True, env=env, timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"the JAX engines' subprocess failed:\n"
                             f"{r.stdout}\n{r.stderr[-4000:]}")
    with open(tmp / "jax.pkl", "rb") as f:
        jax_recs = pickle.load(f)
    params = {name: from_jax(_cfg(name), jax_recs[(name, *MESHES[0])]
                             ["params"], device="cpu") for name in ARCHS}
    port = {(name, *mesh): _port_run(name, mesh, params[name])
            for name, mesh in CASES}
    for mesh in COW_MESHES:
        port[("cow", *mesh)] = _port_cow_run(mesh, params["llama3.2-3b"])
    port["params"] = params
    return jax_recs, port


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_mesh_ids_equal_jax_engine(runs, name, mesh):
    jax_recs, port = runs
    want = jax_recs[(name, *mesh)]["ids"]
    assert len(want) == 8
    assert port[(name, *mesh)]["ids"] == want


def _jax_rows(geom, pool, table, n, L):
    """A request's committed rows ``[L, n, Hkv, Dh]`` from the JAX engine's
    global pool ``[d_p, L_s, n_pages + d_s, page_sz, Hkv, Dh]``."""
    rows = np.arange(n)
    rank, loc = np.divmod(np.asarray(table)[rows // geom.page_sz],
                          geom.n_pages_loc)
    idx = rank * (geom.n_pages_loc + 1) + loc
    flat = pool.reshape(-1, *pool.shape[2:])[:L]     # stages' slots in order
    return flat[:, idx, rows % geom.page_sz]


def _row_errors(jrec, prec, name):
    """Each running request's largest K/V row error against the JAX pool,
    over the largest magnitude of its rows."""
    geom, L = prec["engine"].geom, _cfg(name).spec.n_layers
    out = []
    for rid, table in jrec["snap"]["tables"].items():
        n = jrec["snap"]["committed"][rid]
        for name_, got in zip(("cache_k", "cache_v"), prec["rows"][rid]):
            want = _jax_rows(geom, jrec["pool"][name_], table, n, L)
            out.append(np.abs(got.numpy() - want).max() / np.abs(want).max())
    return out


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_mesh_pool_rows_equal_jax_pool(runs, name, mesh):
    """After ``SNAP`` steps, with every request still running, each
    committed row of every layer equals the JAX pool's, read through the
    same page table from the rank that owns its page."""
    jrec, prec = runs[0][(name, *mesh)], runs[1][(name, *mesh)]
    assert jrec["snap"]["finished"] == prec["snap"]["finished"] == 0
    assert prec["snap"] == jrec["snap"]
    geom = prec["engine"].geom
    ranks = {p // geom.n_pages_loc for t in jrec["snap"]["tables"].values()
             for p in t}
    assert ranks == set(range(mesh[1]))      # every rank holds pages
    assert max(_row_errors(jrec, prec, name)) <= ROW_TOL


@pytest.mark.parametrize("fault", ("rank partial dropped",
                                   "page owner shifted by one rank"))
def test_pool_rows_catch_planted_faults(runs, monkeypatch, fault):
    """The pool-row comparison fails a planted fault of the mesh path:
    the last rank's partial left out of the log-sum-exp merge, or every
    rank reading the pages of the next rank (the writes stay right)."""
    import dataclasses

    from repro_torch.runtime import sp
    name, mesh = "llama3.2-3b", (1, 2)
    if fault == "rank partial dropped":
        real = sp.merge_partials
        monkeypatch.setattr(sp, "merge_partials",
                            lambda outs, lses: real(outs[:-1], lses[:-1]))
    else:
        real_pack = port_engine.pack_step

        def pack(geom, segs, device):
            b = real_pack(geom, segs, device)
            shift = [dataclasses.replace(sg, table=[
                (p + geom.n_pages_loc) % geom.n_pages for p in sg.table])
                for sg in segs]
            for rr, rs in zip(b.ranks, real_pack(geom, shift, device).ranks):
                rr.kv = rs.kv
            return b
        monkeypatch.setattr(port_engine, "pack_step", pack)
    prec = _port_run(name, mesh, runs[1]["params"][name])
    jrec = runs[0][(name, *mesh)]
    assert prec["snap"] == jrec["snap"]
    assert max(_row_errors(jrec, prec, name)) > 100 * ROW_TOL
    assert max(_row_errors(jrec, runs[1][(name, *mesh)], name)) <= ROW_TOL


@pytest.mark.parametrize("mesh", COW_MESHES,
                         ids=[f"{m[0]}x{m[1]}" for m in COW_MESHES])
def test_cow_copies_cross_ranks(runs, mesh):
    """A shared system prompt makes copy-on-write copies; at least one
    copies a page to another rank, and every request still emits the JAX
    engine's ids."""
    jrec, prec = runs[0][("llama3.2-3b", *mesh)], runs[1][("cow", *mesh)]
    eng, pairs = prec["engine"], prec["pairs"]
    assert prec["ids"] == jrec["sys_ids"]
    assert len(pairs) == eng.pool.stats.cow_copies == jrec["sys_cow"] > 0
    n_loc = eng.geom.n_pages_loc
    assert any(s // n_loc != d // n_loc for s, d in pairs), pairs
    assert eng.stats()["collective_bytes"] > 0


@pytest.mark.parametrize("mesh", COW_MESHES,
                         ids=[f"{m[0]}x{m[1]}" for m in COW_MESHES])
def test_engine_event_has_the_reference_fields(runs, mesh):
    """``run`` with a timeline records one ``engine`` event with the
    reference's fields, its counts equal to the JAX engine's and its
    ``bucket`` the geometry as a string."""
    jrec, prec = runs[0][("llama3.2-3b", *mesh)], runs[1][("cow", *mesh)]
    eng = prec["engine"]
    (want,), (got,) = jrec["events"], prec["events"]
    assert got.keys() == want.keys()
    assert got["kind"] == want["kind"] == "engine"
    for key in ("step", "completed", "steps", "occupancy"):
        assert got[key] == want[key]
    assert got["bucket"] == str(eng.geom)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_mesh_k2_equals_k1(runs, name):
    """Speculative k=2 at 2x2 emits the JAX engine's k=1 ids."""
    mesh = (2, 2)
    eng = _engine(name, mesh, runs[1]["params"][name], k=2)
    got = drive(eng, trace(Request, _cfg(name).spec.vocab))
    assert got == runs[0][(name, *mesh)]["ids"]
    assert eng.spec_stats.drafted > 0


@pytest.mark.parametrize("mesh", ((2, 2), (1, 4)), ids=["2x2", "1x4"])
def test_mesh_chunked_prefill_matches_whole_prompt(runs, mesh):
    name = "gemma3-1b"
    params, V = runs[1]["params"][name], _cfg(name).spec.vocab

    def reqs():
        return trace(Request, V, n=6, seed=5, lo=10, hi=30, max_new=4)
    chunked = drive(_engine(name, mesh, params, n_items=6, cap_t=8), reqs())
    whole = drive(_engine(name, mesh, params, cap_t=32), reqs())
    assert chunked == whole


def test_mesh_preemption_keeps_outputs(runs):
    """Page pressure with preemption at 2x2: streams lose their pages and
    resume-prefill, and every request still emits the JAX engine's ids."""
    name, mesh = "llama3.2-3b", (2, 2)
    eng = _engine(name, mesh, runs[1]["params"][name], n_pages=12,
                  preempt_waiting_steps=1)
    got = drive(eng, trace(Request, _cfg(name).spec.vocab))
    assert got == runs[0][(name, *mesh)]["ids"]
    assert sum(r.preempted for r in eng.results.values()) > 0


@pytest.mark.parametrize("what", ("cap_t", "n_pages"))
def test_geometry_refuses_as_reference(runs, what):
    """``cap_t % d_s`` and ``n_pages % d_s`` raise the reference's
    ``ValueError``; the engine refuses before it allocates anything."""
    assert runs[0]["refusals"][what] == "ValueError"
    kw = dict(cap_t=15, n_pages=24) if what == "cap_t" else \
        dict(cap_t=16, n_pages=23)
    with pytest.raises(ValueError, match=what):
        ss.make_engine_geometry(get_arch("llama3.2-3b").reduced(),
                                n_items=4, page_sz=8, d_s=2, **kw)
    with pytest.raises(ValueError, match=what):
        ServeEngine(get_arch("llama3.2-3b").reduced(),
                    EngineConfig(**{**GEOM, **kw}), d_s=2, device="cpu")


@pytest.mark.parametrize("mesh", MESHES,
                         ids=[f"{m[0]}x{m[1]}" for m in MESHES])
def test_mesh_prompt_slices_equal_jax(mesh):
    """The engine plans prompt slices with its mesh's cost model, and at
    each mesh those equal the reference's."""
    eng = ServeEngine(_cfg("llama3.2-3b"), EngineConfig(**GEOM), d_p=mesh[0],
                      d_s=mesh[1], device="cpu")
    assert (eng._cm.cluster.d_p, eng._cm.cluster.d_s) == mesh
    for name in ARCHS:
        cm = CostModel(get_arch(name).spec,
                       ClusterSpec(d_p=mesh[0], d_s=mesh[1]))
        jcm = JaxCostModel(jax_get_arch(name).spec,
                           JaxClusterSpec(d_p=mesh[0], d_s=mesh[1]))
        for cap in (16, 64, 512):
            for ln in list(range(1, 70)) + [513, 1000, 2047, 4096, 9999]:
                assert prompt_slices(cm, ln, cap) == \
                    jax_prompt_slices(jcm, ln, cap), (name, mesh, cap, ln)


@pytest.mark.parametrize("mesh", MESHES + ((1, 1),),
                         ids=[f"{m[0]}x{m[1]}" for m in MESHES + ((1, 1),)])
def test_pool_layout_and_bytes_equal_reference(mesh):
    """``pool[name][p][r]`` is ``[L_s, n_pages_loc + 1, page_sz, Hkv,
    Dh]``; all of them hold the bytes of the reference's
    ``engine_pool_struct``."""
    cfg, jcfg = _cfg("gemma3-1b"), jax_get_arch("gemma3-1b").reduced(
        **ARCHS["gemma3-1b"])
    geom = ss.make_engine_geometry(cfg, n_items=4, cap_t=16, n_pages=24,
                                   page_sz=8, d_p=mesh[0], d_s=mesh[1],
                                   compute_dtype=torch.float32)
    pool = ss.init_pool(cfg, geom, "cpu")
    L_s = -(-cfg.spec.n_layers // mesh[0])
    assert geom.layers_per_stage == L_s and geom.n_pages_loc == 24 // mesh[1]
    assert len(pool["cache_k"]) == mesh[0]
    for stage in pool["cache_k"] + pool["cache_v"]:
        assert len(stage) == mesh[1]
        for t in stage:
            assert t.shape == (L_s, 24 // mesh[1] + 1, 8, cfg.spec.n_kv_heads,
                               cfg.spec.head_dim)
    jgeom = JaxEngineGeometry(n_items=4, cap_t=16, n_pages=24, page_sz=8,
                              pages_per_seq=24, k=1, d_p=mesh[0], d_s=mesh[1],
                              layers_per_stage=L_s,
                              compute_dtype=np.float32)
    want = sum(int(np.prod(st.shape)) * 4
               for st in engine_pool_struct(jcfg, jgeom).values())
    got = sum(t.numel() * t.element_size()
              for stages in pool.values() for ranks in stages for t in ranks)
    assert ss.pool_bytes(cfg, geom)["total"] == got == want
    assert ss.pool_bytes(cfg, geom)["per_rank"] == got // (mesh[0] * mesh[1])


def test_copy_pages_across_ranks_and_sentinel():
    """A copy writes the destination's owner from the source's owner on
    every stage's every slot; the sentinel ``n_pages`` copies nothing."""
    cfg = _cfg("llama3.2-3b")
    geom = ss.make_engine_geometry(cfg, n_items=1, cap_t=4, n_pages=8,
                                   page_sz=2, d_p=2, d_s=2,
                                   compute_dtype=torch.float32)
    pool = ss.init_pool(cfg, geom, "cpu")
    g = torch.Generator().manual_seed(0)
    for stages in pool.values():
        for ranks in stages:
            for t in ranks:
                t.copy_(torch.randn(t.shape, generator=g))
    before = {k: [[t.clone() for t in r] for r in v] for k, v in pool.items()}
    ss.copy_pages(geom, pool, [(1, 6), (8, 2), (3, 8), (5, 0)])
    for name, stages in pool.items():
        for p, ranks in enumerate(stages):
            old = before[name][p]
            # 1 (rank 0, local 1) -> 6 (rank 1, local 2)
            assert torch.equal(ranks[1][:, 2], old[0][:, 1])
            # 5 (rank 1, local 1) -> 0 (rank 0, local 0)
            assert torch.equal(ranks[0][:, 0], old[1][:, 1])
            changed = [(r, i) for r in range(2) for i in range(5)
                       if not torch.equal(ranks[r][:, i], old[r][:, i])]
            assert changed == [(0, 0), (1, 2)]


def test_pack_step_places_each_row_on_its_owner():
    """For any page table, every committed row a window's layer sees is
    gathered exactly once, on the rank owning its page, at that page's
    local row; the union over ranks is the one-rank gather list; each
    row's write goes to its owner and to the other ranks' trash pages."""
    cfg = get_arch("gemma3-1b").reduced(n_layers=6)
    one = ss.make_engine_geometry(cfg, n_items=2, cap_t=16, n_pages=20,
                                  page_sz=8)
    four = ss.make_engine_geometry(cfg, n_items=2, cap_t=16, n_pages=20,
                                   page_sz=8, d_s=4)
    table = [4, 17, 9, 7, 11]
    segs = [ss.PackedSegment(0, 0, 3, [1] * 5, 30, table, False),
            ss.PackedSegment(0, 5, 5, [2], 6, [13], True),
            ss.PackedSegment(1, 0, 3, [1] * 4, 35, table, False)]
    b1, b4 = ss.pack_step(one, segs, "cpu"), ss.pack_step(four, segs, "cpu")
    n_loc, ps, T = four.n_pages_loc, 8, 32
    for w in one.windows:
        ref = b1.kv[w]
        live = ref.seg[:-T] >= 0
        want = sorted(zip(ref.seg[:-T][live].tolist(),
                          ref.pos[:-T][live].tolist(),
                          ref.ctx_rows[live].tolist()))
        got = []
        for r, rr in enumerate(b4.ranks):
            kv = rr.kv[w]
            n_ctx = len(kv.ctx_rows)
            assert n_ctx % BLOCK_KV == 0 and (n_ctx > 0 or r == 0)
            assert len(kv.seg) == n_ctx + (T if r == 0 else 0)
            ok = kv.seg[:n_ctx] >= 0
            for s, p, row in zip(kv.seg[:n_ctx][ok].tolist(),
                                 kv.pos[:n_ctx][ok].tolist(),
                                 kv.ctx_rows[ok].tolist()):
                page, loc = divmod(row, ps)
                glob = r * n_loc + page
                got.append((s, p, glob * ps + loc))
            assert (kv.ctx_rows[~ok] == n_loc * ps).all()
        assert sorted(got) == want
    for t in range(T):
        w1 = int(b1.ranks[0].write_rows[t])
        owners = [r for r, rr in enumerate(b4.ranks)
                  if int(rr.write_rows[t]) // ps != n_loc]
        if w1 // ps == one.trash_page:
            assert owners == []
        else:
            page, loc = divmod(w1, ps)
            assert owners == [page // n_loc]
            assert int(b4.ranks[owners[0]].write_rows[t]) == \
                (page % n_loc) * ps + loc


def test_serve_cli_mesh(tmp_path):
    """``launch/serve.py --mesh 2x2`` serves on the CPU, verifies against
    the one-shot path and spills the engine event; SP ranks across cards
    are refused, naming the per-rank driver."""
    from repro_torch.launch.serve import main
    stats = tmp_path / "stats.json"
    assert main(["--device", "cpu", "--arch", "llama3.2-3b", "--reduced",
                 "--mesh", "2x2", "--requests", "3", "--context-limit", "40",
                 "--max-new", "3", "--verify", "1", "--telemetry-dir",
                 str(tmp_path), "--stats-json", str(stats)]) == 0
    st = json.loads(stats.read_text())
    assert st["mesh"] == "2x2" and st["completed"] == 3
    assert st["pool_bytes_per_rank"] > 0 and st["collective_bytes"] > 0
    events = [json.loads(ln) for ln in
              (tmp_path / "timeline-serve.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events] == ["engine"]
    assert main(["--device", "cpu", "--arch", "llama3.2-3b", "--reduced",
                 "--mesh", "1x2", "--cards", "2", "--requests", "1"]) == 2
