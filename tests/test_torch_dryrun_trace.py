"""The dry-run's trace (``repro_torch.launch.dryrun``) against real runs of
the same units on the CPU, and its helpers against the JAX package.

* At reduced sizes on a 2x2 mesh (decode: two pods of 2x2), for
  gemma3-1b, hymba-1.5b, olmoe-1b-7b, deepseek-v2-lite (at the kernels'
  MLA widths, q/k 192, v 128) and seamless-m4t-v2: the unit traced on
  the meta device and the same unit built on the CPU (real parameters,
  the plain versions of the kernels) give outputs, carries and gradients
  of equal shapes and dtypes, equal collectives (``collective_counts``),
  as many plain calls on the CPU as the kernels' calls on meta, the same
  bytes a rank holds, and (train) those bytes are a CPU
  ``PipelineTrainer.state_bytes``' (or ``EncDecTrainer``'s).
* ``analytic_collectives`` equals the JAX function on the same geometry;
  ``decode_state_bytes`` and ``init_decode_state`` with pods equal the
  JAX ``decode_state_struct`` with its pod dim; ``telemetry_report`` and
  its one-line summary equal the JAX ones on a port run's
  ``--telemetry-dir``.
* ``configs/shapes``, ``configs/llama_paper`` (the specs' fields, the
  cluster's under the port's names, ``CostModel`` numbers) and
  ``launch/mesh``; ``abstract_params`` against each family's ``init``;
  the meta route's pair count against the mask; the MoE dispatch's
  balanced split on meta.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_threads import torch_thread_share  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


def _cfg(name):
    from repro_torch.configs import get_arch
    cfg = get_arch(name).reduced()
    if cfg.spec.kv_lora_rank > 0:
        # the reduced MLA widths (24, 16) are no kernel pair: the kernels'
        # (192, 128), still a few narrow heads
        cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
            cfg.spec, head_dim=128, qk_rope_dim=64))
    return cfg


def _model(cfg):
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.model import DecoderLM
    return EncDecLM(cfg) if cfg.spec.is_encoder_decoder else DecoderLM(cfg)


UNITS = [("gemma3-1b", "train"), ("hymba-1.5b", "train"),
         ("olmoe-1b-7b", "train"), ("deepseek-v2-lite", "train"),
         ("seamless-m4t-v2", "train"), ("gemma3-1b", "prefill"),
         ("hymba-1.5b", "prefill"), ("gemma3-1b", "decode"),
         ("hymba-1.5b", "decode"), ("seamless-m4t-v2", "decode")]


@pytest.mark.parametrize("name,kind", UNITS)
def test_unit_traced_on_meta_matches_a_cpu_run(name, kind):
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.analysis import (collective_counts,
                                             collective_snapshot)
    from repro_torch.launch.mesh import make_mesh
    cfg = _cfg(name)
    shape = ShapeSpec(f"{kind}_small", 128 if kind == "decode" else 256, 8,
                      kind)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model")) \
        if kind == "decode" else make_mesh((2, 2), ("data", "model"))
    meta_cell = dr.build_cell(cfg, shape, mesh=mesh)
    traces = [dr.trace_unit(u) for u in meta_cell.units]
    assert traces and all(t["trace_peak_bytes"] > 0 for t in traces)
    params = _model(cfg).init(torch.Generator().manual_seed(0),
                              device="cpu", dtype=BF16)
    cpu = dr.build_cell(cfg, shape, mesh=mesh, device="cpu", params=params)
    assert cpu.rec["plan"] == meta_cell.rec["plan"]
    assert cpu.stage_bytes == meta_cell.stage_bytes
    assert cpu.totals == meta_cell.totals
    for unit, tr in zip(cpu.units, traces):
        assert unit.rank_bytes == tr["rank_bytes"]
        before = collective_snapshot()
        calls = (ops.flash_attention.plain_calls,
                 ops.fused_cross_entropy.plain_calls,
                 ops.mamba_scan.plain_calls)
        out = unit.run()
        plain = (ops.flash_attention.plain_calls - calls[0],
                 ops.fused_cross_entropy.plain_calls - calls[1],
                 ops.mamba_scan.plain_calls - calls[2])
        assert [list(s) for s in out["signature"]] == tr["signature"]
        assert collective_counts(before, out["handoffs"]) == \
            tr["collectives"]
        k = {n: v["calls"] for n, v in tr["kernel_ops"].items()}
        # a plain call serves an attention forward (A) or backward (both
        # A' passes), a CE block's forward (B) or backward (C1 with C2),
        # a scan's forward (D) or backward (D')
        want = (k.get("flash_fwd_mma_kernel", 0)
                + k.get("flash_bwd_dq_kernel", 0),
                k.get("ce_fwd_mma_kernel", 0)
                + k.get("ce_bwd_dh_mma_kernel", 0),
                k.get("mamba_scan_fwd_emit_kernel", 0)
                + k.get("mamba_scan_bwd_tile_kernel", 0))
        assert plain == want and sum(want) > 0
        assert k.get("flash_bwd_dkdv_kernel", 0) == \
            k.get("flash_bwd_dq_kernel", 0)
        if kind == "train" and cfg.spec.ssm_state:
            assert k["mamba_scan_fwd_summary_kernel"] == \
                k["mamba_scan_fwd_emit_kernel"]
    if kind == "train":
        sb = cpu.holder.state_bytes()["rank_state_bytes"]
        assert sb == meta_cell.stage_bytes


@pytest.mark.parametrize("name,kind,policy,zero3", [
    ("gemma3-1b", "train", "allgather_kv", "per_tick"),
    ("qwen3-4b", "train", "ulysses", "per_step"),
    ("hymba-1.5b", "prefill", "allgather_kv", "per_tick"),
    ("olmoe-1b-7b", "train", "allgather_kv", "per_tick"),
    ("falcon-mamba-7b", "train", "none", "per_tick"),
    ("seamless-m4t-v2", "train", "allgather_kv", "per_tick"),
    ("llama3.2-3b", "decode", None, None),
    ("deepseek-v2-lite", "decode", None, None)])
def test_analytic_collectives_match_jax(name, kind, policy, zero3):
    from repro.configs import get_arch as jget
    from repro.launch.analysis import analytic_collectives as jac

    from repro_torch.configs import get_arch
    from repro_torch.launch.analysis import BucketDims, analytic_collectives
    from repro_torch.runtime.encdec_pipeline import EncDecGeometry
    from repro_torch.runtime.pipeline import PipelineGeometry
    from repro_torch.runtime.serve_step import make_decode_geometry
    cfg, jcfg = get_arch(name), jget(name)
    d_p, d_s = 4, 8
    if kind == "decode":
        geom = make_decode_geometry(cfg, d_p=d_p, d_s=d_s, batch_per_pod=64,
                                    cache_len=4096)
        jgeom = SimpleNamespace(**{k: getattr(geom, k) for k in (
            "n_micro", "bm", "d_p", "d_s", "layers_per_stage")})
        got, want = analytic_collectives(cfg, geom, kind), \
            jac(jcfg, jgeom, kind)
    else:
        table = ((1, 0, 2), (0, 0, 1), (2, 1, 0), (0, 0, 0))
        dims = BucketDims(n_chunks=3, cap=2048, ctx_cap=4096, l_ckpt=2,
                          layers_per_stage=-(-cfg.spec.n_layers // d_p),
                          ckpt_table=table)
        if cfg.spec.is_encoder_decoder:
            geom = EncDecGeometry(d_p=d_p, d_s=d_s, zero3_mode=zero3)
        else:
            geom = PipelineGeometry(d_p=d_p, d_s=d_s, policy=policy,
                                    d_s_eff=4 if zero3 == "per_step" else 0,
                                    zero3_mode=zero3)
        jgeom = SimpleNamespace(
            n_chunks=3, cap=2048, d_p=d_p, d_s=d_s, d_s_eff=geom.d_s_eff,
            layers_per_stage=dims.layers_per_stage, policy=geom.policy,
            zero3_mode=zero3, ckpt_table=table, l_ckpt=2)
        got, want = analytic_collectives(cfg, geom, kind, dims), \
            jac(jcfg, jgeom, kind)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    assert any(v > 0 for v in got.values())


@pytest.mark.parametrize("name", ["gemma3-1b", "hymba-1.5b",
                                  "deepseek-v2-lite", "seamless-m4t-v2",
                                  "falcon-mamba-7b"])
def test_decode_state_with_pods_matches_jax(name):
    from repro.configs import get_arch as jget
    from repro.runtime import serve_step as jss

    from repro_torch.configs import get_arch
    from repro_torch.runtime import serve_step as ss
    cfg = get_arch(name).reduced()
    geom = ss.make_decode_geometry(cfg, d_p=2, d_s=2, batch_per_pod=6,
                                   cache_len=64)
    jgeom = jss.DecodeGeometry(
        batch_per_pod=6, cache_len=64, d_p=2, d_s=2,
        layers_per_stage=geom.layers_per_stage, n_micro=geom.n_micro)
    want = jss.decode_state_struct(jget(name).reduced(), jgeom, 2)
    nbytes = sum(int(np.prod(st.shape)) * np.dtype(st.dtype).itemsize
                 for st in want.values())
    assert ss.decode_state_bytes(geom, cfg, n_pods=2) == nbytes
    assert ss.decode_state_bytes(geom, cfg, n_pods=1) * 2 == nbytes
    state = ss.init_decode_state(cfg, geom, ["meta"] * 2, n_pods=2)
    assert state["n_pods"] == 2 and state["tokens"].shape == \
        want["tokens"].shape
    held = 0
    for key, st in want.items():
        got = state[key]
        blocks = [got] if key == "tokens" else got if key == "memory" \
            else [t for r in got for t in r]
        assert all(t.shape[0] == 2 for t in blocks), key    # the pod dim
        held += sum(t.numel() * t.element_size() for t in blocks)
    assert held == nbytes
    with pytest.raises(NotImplementedError, match="only lowers"):
        ss.decode_step(None, geom, [], state, ["meta"] * 2)


def test_telemetry_report_matches_jax(tmp_path):
    from repro.launch.analysis import format_telemetry_report as jfmt
    from repro.launch.analysis import telemetry_report as jrep

    from repro_torch.launch.analysis import (format_telemetry_report,
                                             telemetry_report)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "gemma3-1b", "--reduced", "--steps", "3", "--batch", "4",
         "--context", "256", "--telemetry-dir", str(tmp_path),
         "--replan", "observe"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    # a torn tail line (a live run's) is skipped by both
    with open(tmp_path / "timeline-train.jsonl", "a") as f:
        f.write('{"kind": "step", "wall')
    (tmp_path / "calibration.json").write_text(json.dumps(
        {"fp0": {"version": 3}}))
    got, want = telemetry_report(str(tmp_path)), jrep(str(tmp_path))
    assert got == want
    assert got["steps"]["count"] == 3 and got["journal_steps"] == 3
    assert format_telemetry_report(got) == jfmt(want)


def test_shapes_equal_jax():
    from repro.configs.shapes import SHAPES as JSHAPES

    from repro_torch.configs.shapes import SHAPES
    assert list(SHAPES) == list(JSHAPES)
    for k, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JSHAPES[k])


def test_llama_paper_equals_jax():
    from repro.configs import llama_paper as jlp
    from repro.core import CostModel as JCostModel
    from repro.core.plan import Chunk as JChunk
    from repro.core.plan import ChunkKind as JKind
    from repro.core.plan import Slice as JSlice

    from repro_torch.configs import arch_names, llama_paper as lp
    from repro_torch.core import CostModel
    from repro_torch.core.plan import Chunk, ChunkKind, Slice
    for name in ("llama_7b", "llama_13b", "llama_30b"):
        cfg, jcfg = getattr(lp, name)(), getattr(jlp, name)()
        assert dataclasses.asdict(cfg.spec) == dataclasses.asdict(jcfg.spec)
        assert cfg.spec.name not in arch_names()     # not in the registry
    c, jc = lp.paper_cluster(), jlp.paper_cluster()
    same = {f.name for f in dataclasses.fields(c)} - {"link_bw", "net_bw"}
    assert {k: getattr(c, k) for k in same} == \
        {k: getattr(jc, k) for k in same}
    assert (c.link_bw, c.net_bw) == (jc.ici_bw, jc.dcn_bw) == (200e9, 50e9)
    assert lp.paper_cluster(2, 4).n_devices == 8
    for name in ("llama_7b", "llama_30b"):
        cm = CostModel(getattr(lp, name)().spec, c)
        jcm = JCostModel(getattr(jlp, name)().spec, jc)
        # the tail chunk of an 8,192-token sequence behind its 4,096 rows
        ch = Chunk(ChunkKind.SPLIT, 4096, (Slice(0, 4096, 4096, True),))
        jch = JChunk(JKind.SPLIT, 4096, (JSlice(0, 4096, 4096, True),))
        for f in ("t_comp", "t_comp_bwd", "t_sp_comm", "t_p2p"):
            assert getattr(cm, f)(ch) == pytest.approx(getattr(jcm, f)(jch),
                                                       rel=1e-12), f
        assert cm.m_act(1, ch, 2) == pytest.approx(jcm.m_act(1, jch, 2),
                                                   rel=1e-12)
        assert cm.m_model_states(1) == pytest.approx(jcm.m_model_states(1),
                                                     rel=1e-12)
        assert cm.token_capacity() == jcm.token_capacity()


def test_mesh():
    from repro_torch.launch.mesh import make_mesh, production_mesh
    one, two = production_mesh(), production_mesh(multi_pod=True)
    assert (one.shape, one.axes, one.d_p, one.d_s, one.n_pods,
            one.n_devices, one.name) == ((16, 16), ("data", "model"), 16,
                                         16, 1, 256, "16x16")
    assert (two.shape, two.axes, two.d_p, two.d_s, two.n_pods,
            two.n_devices, two.name) == ((2, 16, 16),
                                         ("pod", "data", "model"), 16, 16,
                                         2, 512, "2x16x16")
    m = make_mesh((4,), ("model",))
    assert (m.d_p, m.d_s, m.n_pods) == (1, 4, 1)
    for bad in (((2, 2), ("model", "data")), ((2,), ("x",)),
                ((2, 2), ("data",)), ((0, 2), ("data", "model"))):
        with pytest.raises(ValueError):
            make_mesh(*bad)


@pytest.mark.parametrize("name", ["gemma3-1b", "llama3.2-3b", "qwen3-4b",
                                  "qwen2-vl-7b", "stablelm-12b",
                                  "olmoe-1b-7b", "deepseek-v2-lite",
                                  "hymba-1.5b", "falcon-mamba-7b",
                                  "seamless-m4t-v2"])
def test_abstract_params_are_init_shapes(name):
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import abstract_params
    from torch.utils._pytree import tree_flatten
    cfg = get_arch(name).reduced()
    real = _model(cfg).init(torch.Generator().manual_seed(0), device="cpu",
                            dtype=BF16)
    shapes = abstract_params(cfg, BF16)
    (a, ta), (b, tb) = tree_flatten(real), tree_flatten(shapes)
    assert ta == tb
    assert [(x.shape, x.dtype) for x in a] == [(y.shape, y.dtype)
                                               for y in b]
    assert all(y.device.type == "meta" for y in b)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
@pytest.mark.parametrize("T,S", [(96, 96), (64, 320), (160, 64)])
def test_meta_pair_count_is_the_mask(T, S, causal, window):
    from repro_torch.kernels import meta
    i = np.arange(T)[:, None] + (S - T)
    j = np.arange(S)[None, :]
    mask = np.ones((T, S), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= i - j < window
    assert meta.attention_pairs(T, S, causal=causal, window=window) == \
        int(mask.sum())


def test_meta_route_books_the_kernels_and_runs_no_plain_version():
    from repro_torch.kernels import meta, ops
    m = torch.device("meta")
    meta.reset()
    plain = (ops.flash_attention.plain_calls,
             ops.fused_cross_entropy.plain_calls, ops.mamba_scan.plain_calls)
    T, S, H, D = 100, 100, 2, 64
    q = torch.empty((T, H, D), dtype=BF16, device=m, requires_grad=True)
    k = torch.empty((S, H, D), dtype=BF16, device=m, requires_grad=True)
    i32 = dict(dtype=torch.int32, device=m)
    seg, pos = torch.empty(T, **i32), torch.empty(T, **i32)
    out = ops.flash_attention(q, k, k, seg, seg, pos, pos)
    out.sum().backward()
    h = torch.empty((T, 64), dtype=BF16, device=m, requires_grad=True)
    w = torch.empty((512, 64), dtype=BF16, device=m, requires_grad=True)
    loss, _ = ops.fused_cross_entropy(
        h, w, torch.empty(T, dtype=torch.int64, device=m),
        torch.empty(T, dtype=torch.bool, device=m))
    loss.backward()
    assert (out.shape, q.grad.shape, k.grad.shape, h.grad.shape,
            w.grad.shape) == ((T, H, D), (T, H, D), (S, H, D), (T, 64),
                              (512, 64))
    t = meta.snapshot()
    Tp, Sp = 128, 128                       # padded to the tiles
    pairs = meta.attention_pairs(Tp, Sp, causal=True)
    assert t["flash_fwd_mma_kernel"] == {"calls": 1, "ops": H * 256 * pairs}
    assert t["flash_bwd_dq_kernel"]["ops"] == H * (4 * 64 + 2 * 64) * pairs
    assert t["flash_bwd_dkdv_kernel"]["ops"] == H * 8 * 64 * pairs
    assert t["flash_bwd_tiles_kernel"]["calls"] == 1
    from repro_torch.kernels.cross_entropy import TOKEN_MULTIPLE
    Tc = -(-T // TOKEN_MULTIPLE) * TOKEN_MULTIPLE
    assert t["ce_fwd_mma_kernel"]["ops"] == 2 * Tc * 512 * 64
    assert t["ce_bwd_dh_mma_kernel"]["ops"] == 4 * Tc * 512 * 64
    assert t["ce_bwd_dw_mma_kernel"]["ops"] == 4 * Tc * 512 * 64
    assert (ops.flash_attention.plain_calls,
            ops.fused_cross_entropy.plain_calls,
            ops.mamba_scan.plain_calls) == plain


def test_moe_group_sizes_balanced_on_meta():
    from repro_torch.models.moe import group_sizes
    flat = torch.empty(7 * 2, dtype=torch.int64, device="meta")
    assert group_sizes(flat, 4) == [4, 4, 3, 3]
    real = torch.tensor([0, 2, 2, 3, 0, 0])
    assert group_sizes(real, 4) == [3, 0, 2, 1]
