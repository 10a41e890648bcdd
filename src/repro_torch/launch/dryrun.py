"""Multi-pod dry-run: plan, size and trace every (arch x shape x mesh) cell
without a card.

Counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell's step on 512 placeholder CPU devices and records XLA's
memory and cost analyses. The port has no compiler to ask, so it runs its
own parts on ``torch.device("meta")`` (shapes and dtypes, no memory; this
module never initialises CUDA and never falls back from a card). For each
cell it:

1. runs the port's PLANNER on the shape's workload at the mesh's
   ``ClusterSpec(d_p, d_s, n_pods)`` (the H100's numbers unless ``cluster``
   says otherwise), with the reference's pins: a prefill cell plans at the
   full model axis, the encoder-decoder with ``fixed_k=1, v_stages=1,
   sp_degree=d_s``, decode takes ``make_decode_geometry`` at the shape's
   length;
2. builds the geometry with the port's classes (``PipelineGeometry``,
   ``EncDecGeometry``, ``DecodeGeometry``; a cell's chunk dims in
   ``launch/analysis.BucketDims``);
3. sizes each rank's holding through the port's own constructors on meta:
   ``PipelineTrainer`` / ``EncDecTrainer`` (with ``n_pods``) for train
   cells (compute-dtype parameters, float32 gradient sums, AdamW master, m
   and v), ``DecodeStepBuilder``'s prefill stages and their context
   buffers for prefill, its parameters and the decode state
   (``init_decode_state`` with ``n_pods``) for decode; parameters are
   built from shapes (:func:`abstract_params`);
4. traces one unit on meta (:func:`trace_unit`): train and prefill, the
   plan's largest chunk (rows and context) through the last stage, which
   holds the head, and through the stage with the largest estimate if
   that is another; all ``d_s_eff`` ranks of the stage, the forward and
   (train) the backward at the plan's remat depth; decode, one tick of the
   first stage at all its ranks. A ``TorchDispatchMode`` tallies the live
   bytes above the holding (each allocation rounded to the CUDA caching
   allocator's 512 bytes), ``torch.utils.flop_counter``'s aten flops, the
   kernels' calls and operations (their meta route,
   ``kernels/meta``) and the collectives (``launch/analysis.
   collective_counts``);
5. writes one JSON per cell (``telemetry/stats_io.atomic_write_json``)
   under the reference's file names, with the reference's keys where they
   mean the same thing.

The sizes are computations of the dry-run, not measurements.
``chip_smoke.py``'s ``dryrun`` phase builds the same units on the card
(:func:`build_cell` with real parameters) and holds each against its
trace.

Where the trace would read values: the MoE dispatch's group sizes
(``models/moe.group_sizes``: the balanced split on meta); the decode's ids
(``runtime/serve_step``'s engine and ``DecodeStepBuilder.step``), which the
decode unit stops before; ``models/model.py``'s embedding scale, a host
scalar. The planner and the batching read the corpus on the host (a
synthetic corpus of the shape's lengths, drawn from ``seed``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out runs/dryrun
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["META", "abstract_params", "Unit", "Cell", "build_cell",
           "trace_unit", "card_launches", "measure_unit", "run_cell",
           "all_cells", "cell_tag", "main"]

META = torch.device("meta")
COMPUTE_DTYPE = torch.bfloat16  # the trainers' and the decode's, as run
ALLOC_ROUND = 512               # the CUDA caching allocator's block size


def _cell_skip_reason(cfg, shape) -> str:
    if shape.needs_subquadratic and not cfg.supports_long_decode:
        return ("skipped: pure full-attention arch at 500K decode "
                "(DESIGN.md §4.1)")
    return ""


def all_cells():
    from repro_torch.configs import arch_names
    from repro_torch.configs.shapes import SHAPES
    return [(arch, shape) for arch in arch_names() for shape in SHAPES]


def cell_tag(arch: str, shape: str, multi_pod: bool, note: str = "") -> str:
    """The reference's file name of a cell's record (without ``.json``)."""
    tag = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
    return f"{tag}__{note}" if note else tag


# ---------------------------------------------------------------------------
# parameters from shapes

def abstract_params(cfg, dtype=torch.float32, device=META) -> Dict:
    """The model's parameter dict with ``DecoderLM.init``'s (or
    ``EncDecLM.init``'s) structure, shapes and dtype, as empty tensors on
    ``device`` (meta: nothing allocated), built from the config's widths."""
    from repro_torch.models.config import LayerKind
    s = cfg.spec
    D, Dh, Hq, Hkv = s.d_model, s.head_dim, s.n_heads, s.n_kv_heads

    def t(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    def dense(d_in, d_out):
        return t(d_out, d_in)

    def mlp(d_ff):
        return {"w_gate": dense(D, d_ff), "w_up": dense(D, d_ff),
                "w_down": dense(d_ff, D)}

    def attn():
        if s.kv_lora_rank > 0:
            r, rr = s.kv_lora_rank, s.qk_rope_dim
            return {"wq": dense(D, Hq * (Dh + rr)), "w_dkv": dense(D, r),
                    "w_kr": dense(D, rr), "w_uk": dense(r, Hq * Dh),
                    "w_uv": dense(r, Hq * Dh), "wo": dense(Hq * Dh, D)}
        p = {"wq": dense(D, Hq * Dh), "wk": dense(D, Hkv * Dh),
             "wv": dense(D, Hkv * Dh), "wo": dense(Hq * Dh, D)}
        if s.qk_norm:
            p["q_norm"], p["k_norm"] = t(Dh), t(Dh)
        return p

    if s.is_encoder_decoder:
        def layer(dec: bool) -> Dict:
            lp = {"ln1": t(D), "attn": attn()}
            if dec:
                lp["ln_x"] = t(D)
                lp["cross"] = {"wq": dense(D, Hq * Dh),
                               "wk": dense(D, Hkv * Dh),
                               "wv": dense(D, Hkv * Dh),
                               "wo": dense(Hq * Dh, D)}
            lp["ln2"] = t(D)
            lp["mlp"] = mlp(s.d_ff)
            return lp
        return {"embed": t(s.vocab, D),
                "enc_layers": [layer(False)
                               for _ in range(s.n_encoder_layers)],
                "enc_norm": t(D),
                "dec_layers": [layer(True) for _ in range(s.n_layers)],
                "final_norm": t(D)}

    from repro_torch.models.ssm import dt_rank_of
    kind = cfg.layer_kind
    lp: Dict = {"ln1": t(D)}
    if kind != LayerKind.MAMBA:
        lp["attn"] = attn()
    if kind in (LayerKind.MAMBA, LayerKind.HYBRID):
        di, ds, R = s.inner, s.ssm_state, dt_rank_of(cfg)
        lp["mamba"] = {"in_proj": dense(D, 2 * di),
                       "conv_w": t(s.ssm_conv, di), "conv_b": t(di), "x_proj": dense(di, R + 2 * ds),
                       "dt_proj": dense(R, di), "dt_bias": t(di),
                       "a_log": t(di, ds), "d_skip": t(di),
                       "out_proj": dense(di, D)}
    if kind != LayerKind.MAMBA:
        lp["ln2"] = t(D)
        if s.n_experts > 0:
            E, Fe = s.n_experts, s.d_ff_expert
            lp["moe"] = {"router": dense(D, E), "w_gate": t(E, Fe, D),
                         "w_up": t(E, Fe, D), "w_down": t(E, D, Fe)}
            if s.n_shared_experts > 0:
                lp["moe"]["shared"] = mlp(Fe * s.n_shared_experts)
        else:
            lp["mlp"] = mlp(s.d_ff)

    def stack(tree):
        if isinstance(tree, dict):
            return {k: stack(v) for k, v in tree.items()}
        return t(s.n_layers, *tree.shape)
    params = {"embed": t(s.vocab, D), "layers": stack(lp), "final_norm": t(D)}
    if not cfg.tie_embeddings:
        params["unembed"] = t(s.vocab, D)
    return params


# ---------------------------------------------------------------------------
# accounting

def _leaves(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def tensor_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (each leaf counted)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND if n else 0


class _LiveBytes(TorchDispatchMode):
    """Live bytes of the storages the ops under it allocate on the meta
    device (the host's tensors are not the card's), and their peak: a
    storage is new when an op returns it and none of the op's inputs
    holds it; it is freed when its last reference goes. Each allocation is
    rounded up to :data:`ALLOC_ROUND` bytes, as the CUDA caching allocator
    rounds its blocks."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: Dict[int, bool] = {}

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._seen.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ins = {t.untyped_storage()._cdata
               for t in _leaves((args, kwargs or {}))}
        out = func(*args, **(kwargs or {}))
        for t in _leaves(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in ins or key in self._seen or st.device.type != "meta":
                continue
            n = _rounded(st.nbytes())
            self._seen[key] = True
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


# ---------------------------------------------------------------------------
# units and cells

@dataclass
class Unit:
    """One traced unit of a cell, ``name``: ``stage``'s ``ranks`` on one
    chunk (or decode tick); ``rank_bytes[r]`` what rank ``r`` holds (its tensors' exact bytes);
    ``run()`` runs it once (building its inputs first) and returns
    ``{"signature": [(name, shape, dtype)...], "handoffs": (count,
    bytes)}``; ``info``: the chunk, depth and rows it runs."""
    name: str
    stage: int
    ranks: int
    rank_bytes: List[int]
    run: Callable[[], Dict]
    info: Dict = field(default_factory=dict)


@dataclass
class Cell:
    """A planned cell: its record so far (``rec``), each stage's ranks'
    holding (``stage_bytes[p][r]``; on a card the stages without a unit
    are meta tensors, sized all the same), ``totals``: each component's
    bytes over every stage and rank of one pod (a tensor counted once:
    the ranks of a decode or prefill stage share its parameters), and its
    :class:`Unit`\\ s."""
    rec: Dict
    stage_bytes: List[List[int]]
    units: List[Unit]
    assumptions: List[str]
    totals: Dict[str, int] = field(default_factory=dict)
    build_s: float = 0.0
    holder: object = None       # the trainer or DecodeStepBuilder
    # what a rank holds that no unit reads (the AdamW states): kept alive
    keep: List = field(default_factory=list)


def _sig(name: str, t) -> List:
    if t is None:
        return []
    if isinstance(t, (list, tuple)):
        return [x for i, a in enumerate(t) for x in _sig(f"{name}[{i}]", a)]
    if hasattr(t, "_fields"):           # LayerCtx
        return [x for f in t._fields for x in _sig(f"{name}.{f}",
                                                   getattr(t, f))]
    return [(name, tuple(t.shape), str(t.dtype).replace("torch.", ""))]


def _corpus(n: int, length: int, vocab: int, seed: int) -> Dict:
    rng = np.random.default_rng(seed)
    return {sid: rng.integers(0, vocab, length, dtype=np.int64)
            for sid in range(n)}


def _largest(plan) -> tuple:
    """``(pipeline index, chunk index, global index)`` of the plan's
    largest chunk: the most rows with its context, then the most tokens."""
    best, base = None, 0
    for i, pipe in enumerate(plan.pipelines):
        for k, ch in enumerate(pipe.chunks):
            key = (ch.tokens + ch.context, ch.tokens)
            if best is None or key > best[0]:
                best = (key, i, k, base + k)
        base += pipe.n_chunks
    return best[1:]


def _block_rows(tokens: int, blocks: int) -> int:
    """A chunk's rows as the step cuts them for ``blocks`` SP ranks
    (``runtime/train_step.chunk_arrays``)."""
    from repro_torch.runtime.train_step import ROW_MULTIPLE
    q = ROW_MULTIPLE * blocks
    return -(-max(tokens, 1) // q) * q


def _grow(t: torch.Tensor, rows: int) -> torch.Tensor:
    """An empty carry's KV leaf (0 rows) as ``rows`` zero rows; any other
    leaf (the SSM state and tail) as zeros of its shape."""
    if t.shape[0] == 0:
        return t.new_zeros((rows, *t.shape[1:]))
    return torch.zeros_like(t)


# the last few plans: a cell built on meta and again on a card plans once
# (the planner is deterministic)
_PLANS: Dict[tuple, tuple] = {}


def _plan(cfg, shape, mesh, cluster, *, sp_policy, sp_degree, ckpt_policy):
    key = (cfg, shape, mesh, cluster, sp_policy, sp_degree, ckpt_policy)
    if key not in _PLANS:
        while len(_PLANS) >= 4:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = _solve(cfg, shape, mesh, cluster, sp_policy=sp_policy,
                             sp_degree=sp_degree, ckpt_policy=ckpt_policy)
    return _PLANS[key]


def _solve(cfg, shape, mesh, cluster, *, sp_policy, sp_degree, ckpt_policy):
    from repro_torch.core import CostModel, PlannerConfig, plan_batch
    per_pod = max(1, shape.global_batch // mesh.n_pods)
    cm = CostModel(cfg.spec, cluster)
    remat_mode = "stage_aware" if ckpt_policy == "stage-aware" \
        else "uniform"
    lengths = [shape.seq_len] * per_pod
    if cfg.spec.is_encoder_decoder:
        # encoder is pack-only: K=1; v_stages=1 (no interleaved grouped
        # stacking); the geometry runs the full model axis
        pc = PlannerConfig(fixed_k=1, remat_mode=remat_mode, v_stages=1,
                           sp_degree=mesh.d_s)
    else:
        # prefill cells pin the full model axis (the reference's)
        pc = PlannerConfig(remat_mode=remat_mode, sp_policy=sp_policy,
                           sp_degree=mesh.d_s if shape.kind == "prefill"
                           else sp_degree)
    return cm, plan_batch(cm, lengths, pc), per_pod


def build_cell(arch, shape_name, multi_pod: bool = False, *,
               mesh=None, device=META, params: Optional[Dict] = None,
               cluster=None, remat_override: Optional[int] = None,
               zero3_mode: str = "per_tick",
               ckpt_policy: str = "stage-aware", sp_policy: str = "auto",
               sp_degree: int = 0, note: str = "", seed: int = 0) -> Cell:
    """Plan cell ``(arch, shape, mesh)``, build its geometry, its ranks'
    holding on ``device`` and its units. ``arch`` and ``shape_name``: names
    or an ``ArchConfig`` and a ``ShapeSpec`` (the tests' reduced cells);
    ``mesh``: a ``launch/mesh.Mesh`` in place of the production mesh of
    ``multi_pod``. ``params``: the model's
    parameters (default :func:`abstract_params` on ``device``, which must
    then be meta); ``cluster``: the ``ClusterSpec`` whose numbers the
    planner takes (default the port's H100; its ``d_p``, ``d_s`` and
    ``n_pods`` are the mesh's). A skipped cell comes back with no units."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core import ClusterSpec
    from repro_torch.launch.mesh import production_mesh
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh = mesh or production_mesh(multi_pod)
    rec: Dict = {"arch": cfg.name, "shape": shape.name, "mesh": mesh.name,
                 "note": note}
    reason = _cell_skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return Cell(rec, [], [], [])
    t0 = time.perf_counter()
    cluster = (cluster or ClusterSpec()).with_(d_p=mesh.d_p, d_s=mesh.d_s,
                                               n_pods=mesh.n_pods)
    if params is None:
        if torch.device(device).type != "meta":
            raise ValueError("parameters from shapes live on meta: pass "
                             "params to build a cell on a card")
        params = abstract_params(cfg, COMPUTE_DTYPE)
    kw = dict(cfg=cfg, shape=shape, mesh=mesh, cluster=cluster,
              device=torch.device(device), params=params, rec=rec,
              dtype=COMPUTE_DTYPE, seed=seed)
    if shape.kind == "decode":
        cell = _decode_cell(**kw)
    elif cfg.spec.is_encoder_decoder:
        cell = _encdec_cell(**kw, ckpt_policy=ckpt_policy,
                            zero3_mode=zero3_mode)
    else:
        cell = _decoder_cell(**kw, ckpt_policy=ckpt_policy,
                             zero3_mode=zero3_mode, sp_policy=sp_policy,
                             sp_degree=sp_degree,
                             remat_override=remat_override)
    cell.rec["n_devices"] = mesh.n_devices
    cell.build_s = time.perf_counter() - t0
    return cell


def _memory_record(cell: Cell, estimates: Sequence[float],
                   capacity: float) -> None:
    per_stage = [max(b) for b in cell.stage_bytes]
    cell.rec["memory"] = {
        "argument_bytes": max(per_stage),
        "argument_bytes_per_stage": per_stage,
        "totals": dict(cell.totals),
        "plan_estimate_bytes": [float(x) for x in estimates],
        "capacity_bytes": float(capacity)}


def _distinct_bytes(trees) -> int:
    """Bytes of the tensors of ``trees``, each tensor object once (a
    stage's ranks may hold the same one)."""
    seen = {id(t): t for t in _leaves(trees)}
    return sum(t.numel() * t.element_size() for t in seen.values())


# -- train and prefill of the decoder families ------------------------------

def _decoder_cell(*, cfg, shape, mesh, cluster, device, params, rec, dtype,
                  seed, ckpt_policy, zero3_mode, sp_policy, sp_degree,
                  remat_override) -> Cell:
    from repro_torch.core.schedule import get_schedule
    from repro_torch.launch.analysis import BucketDims, analytic_collectives
    from repro_torch.runtime import sp as spmod
    from repro_torch.runtime.pipeline import PipelineGeometry
    d_p, d_s = mesh.d_p, mesh.d_s
    cm, plan, per_pod = _plan(cfg, shape, mesh, cluster, sp_policy=sp_policy,
                              sp_degree=sp_degree, ckpt_policy=ckpt_policy)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    cap = -(-plan.chunk_capacity // d_s) * d_s
    ctx_cap = max((c.context for c in chunks), default=0) + cap
    if remat_override is not None:
        l_ckpt, table, digest = remat_override, None, f"u{remat_override}"
    else:
        l_ckpt, table, digest = plan.ckpt_policy(len(chunks))
    d_s_eff = plan.sp.d_s_eff if plan.sp is not None else d_s
    policy = plan.sp.policy if plan.sp is not None else \
        spmod.choose_policy(cfg, d_s_eff)
    geom = PipelineGeometry(
        d_p=d_p, schedule=plan.schedule, v_stages=plan.v_stages,
        split_bwd=get_schedule(plan.schedule, plan.v_stages).split_bwd,
        d_s=d_s, policy=policy, d_s_eff=d_s_eff,
        zero3_mode=zero3_mode if d_s > 1 else None)
    dims = BucketDims(n_chunks=len(chunks), cap=cap, ctx_cap=ctx_cap,
                      l_ckpt=l_ckpt, layers_per_stage=-(-cfg.spec.n_layers
                                                        // d_p),
                      ckpt_table=table)
    rec["plan"] = {"K": plan.k_split, "n_chunks": len(chunks), "cap": cap,
                   "ctx_cap": ctx_cap, "l_ckpt": l_ckpt,
                   "ckpt_policy": ckpt_policy, "ckpt_digest": digest,
                   "l_ckpt_stage": plan.ckpt_per_stage_max(),
                   "schedule": plan.schedule, "v_stages": plan.v_stages,
                   "sp_policy": (plan.sp.policy if plan.sp is not None
                                 else "auto"),
                   "d_s_eff": d_s_eff, "pipelines": len(plan.pipelines),
                   "est_time_s": plan.est_total_time,
                   "solve_time_s": plan.solve_time}
    rec["geometry"] = {"n_chunks": dims.n_chunks, "cap": cap,
                       "ctx_cap": ctx_cap, "l_ckpt": l_ckpt,
                       "layers_per_stage": dims.layers_per_stage,
                       "policy": policy, "d_s_eff": d_s_eff,
                       "zero3_mode": zero3_mode}
    rec["analytic_collectives"] = analytic_collectives(cfg, geom, shape.kind,
                                                       dims)
    estimates = [max(p.est_peak_mem[s] for p in plan.pipelines
                     if p.est_peak_mem) for s in range(d_p)] \
        if any(p.est_peak_mem for p in plan.pipelines) else []
    if shape.kind == "train":
        cell = _train_units(cfg, shape, plan, geom, mesh, cm, device, params,
                            rec, dtype, seed, per_pod, estimates,
                            trainer_cls=None)
    else:
        cell = _prefill_units(cfg, plan, mesh, device, params, rec, dtype,
                              seed, estimates)
    _memory_record(cell, estimates, cluster.capacity_bytes)
    return cell


def _unit_stages(d_p: int, estimates: Sequence[float]) -> List[int]:
    """The last stage, and the stage with the largest estimate if it is
    another."""
    out = [d_p - 1]
    if estimates:
        top = int(np.argmax(estimates))
        if top != d_p - 1:
            out.append(top)
    return out


def _train_units(cfg, shape, plan, geom, mesh, cm, device, params, rec,
                 dtype, seed, per_pod, estimates, trainer_cls,
                 frames=None) -> Cell:
    from repro_torch.models.model import tree_leaves
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.train_step import PipelineTrainer
    cls = trainer_cls or PipelineTrainer
    on_meta = device.type == "meta"
    units_at = _unit_stages(geom.d_p, estimates)
    # on a card only the units' stages take memory: the others on meta
    cards = [device] if on_meta else \
        [device if p in units_at else META for p in range(geom.d_p)]
    trainer = cls(cfg, params, geometry=geom, cards=cards,
                  compute_dtype=dtype, cost_model=cm, n_pods=mesh.n_pods)
    d_s = geom.d_s
    corpus = _corpus(per_pod, shape.seq_len, cfg.spec.vocab, seed)
    assumptions = [
        "the unit's chunk: the plan's largest (rows with its context, then "
        "tokens), of a synthetic corpus of the shape's lengths",
        "a chunk with context reads a zero carry of its previous chunk's "
        "rows; a chunk with dependents takes a zero carry gradient",
        "attention operations count the causal (or window) mask of the "
        "padded rows: meta tensors carry no segments",
        "a stage's d_s ranks run in one process (the card's layout): "
        "trace_peak_bytes is the unit's, all ranks together",
    ]
    # a rank's holding: its parameters, and in training its float32
    # gradient sums and AdamW master, m and v (the encoder-decoder's
    # prefill cell holds the parameters only)
    train = shape.kind == "train"
    stage_bytes: List[List[int]] = []
    holds: Dict[int, tuple] = {}
    totals = {"params": 0, "grad_sums": 0, "adamw": 0} if train else \
        {"params": 0}
    for p, sp in enumerate(trainer.params):
        ranks = sp if d_s > 1 else [sp]
        totals["params"] += _distinct_bytes(sp)
        if not train:
            stage_bytes.append([tensor_bytes(tree) for tree in ranks])
            holds[p] = (None, None)
            continue
        accs = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for t in tree_leaves(sp)]
        opt = init_opt_state(sp)
        n = len(accs) // len(ranks)
        per = []
        for r, tree in enumerate(ranks):
            o = [opt[k][r] if d_s > 1 else opt[k]
                 for k in ("master", "m", "v")]
            per.append(tensor_bytes(tree) + tensor_bytes(accs[r * n:
                                                              (r + 1) * n])
                       + tensor_bytes(o))
        stage_bytes.append(per)
        totals["grad_sums"] += tensor_bytes(accs)
        totals["adamw"] += tensor_bytes([opt[k] for k in ("master", "m",
                                                          "v")])
        if p in units_at:
            holds[p] = (accs, opt)
    batch = trainer._materialize(plan, corpus)
    if frames is not None:
        from repro_torch.data.batching import frame_table
        table = frame_table(frames)
    else:
        table = None
    pi, k, gk = _largest(plan)
    pipe = plan.pipelines[pi]
    base = gk - k
    # (the encoder-decoder keeps its pinned SP point, as its trainer does)
    g = geom.for_plan(plan) if d_s > 1 and trainer_cls is None else geom
    depths = trainer._stage_depths(plan, "stage-aware")
    units = []
    for p in units_at:
        st = trainer.stages[p]
        j = geom.v_stages - 1 if p == geom.d_p - 1 else 0
        depth = depths[p][j][gk]
        units.append(Unit(
            name=f"stage {p}" + (" (last)" if p == geom.d_p - 1 else
                                 " (largest estimate)"),
            stage=p, ranks=d_s, rank_bytes=stage_bytes[p],
            run=_train_run(trainer, st, g, plan, pipe, base, k, j, depths[p],
                           batch, table, holds[p][0], device, dtype, seed,
                           backward=shape.kind == "train"),
            info={"chunk": gk, "tokens": pipe.chunks[k].tokens,
                  "context": pipe.chunks[k].context, "vstage": j,
                  "remat": int(depth), "d_s_eff": g.d_s_eff,
                  "rows": _block_rows(pipe.chunks[k].tokens,
                                      g.d_s_eff if d_s > 1 else 1)}))
    return Cell(rec, stage_bytes, units, assumptions, totals=totals,
                holder=trainer, keep=[holds])


def _train_run(trainer, st, g, plan, pipe, base, k, j, depths, batch, table,
               accs, device, dtype, seed, backward: bool) -> Callable:
    """The unit: chunk ``k`` of ``pipe`` through virtual stage ``j`` of
    stage ``st``: forward, then (train) backward and the split backward's
    W pass, as the executor runs them. Its hand-offs: the stream in and
    out, and (train) the gradients in and out."""
    from repro_torch.runtime.pipeline import carry_map

    encdec = trainer.cfg.spec.is_encoder_decoder
    sp_ranks = g.d_s > 1

    def run() -> Dict:
        torch.manual_seed(seed)
        ch = pipe.chunks[k]
        if sp_ranks:
            st.configure(trainer.sp_model(g.policy, g.d_s_eff), g.policy,
                         g.d_s_eff)
        if encdec:
            trainer._frames = table
        inputs = trainer._inputs(batch, pipe, base, device,
                                 g.d_s_eff if sp_ranks else None)
        scale = torch.tensor(1.0, dtype=torch.float32, device=device)
        # (a forward alone adds into no gradient sum)
        st.begin(pipe.chunks, inputs,
                 [[row[base + kk] for kk in range(pipe.n_chunks)]
                  for row in depths], scale,
                 accs if accs is not None else [None] * len(st.leaves))
        s = j * g.d_p + st.p
        x_in = None
        if encdec:
            x_in = _encdec_stream(trainer, st, inputs(k), device, dtype)
        elif s > 0:
            rows = _block_rows(ch.tokens, g.d_s_eff if sp_ranks else 1)
            D = trainer.cfg.spec.d_model
            if sp_ranks:
                x_in = tuple(torch.randn((rows // g.d_s_eff, D),
                                         device=device).to(dtype)
                             for _ in range(g.d_s))
            else:
                x_in = torch.randn((rows, D), device=device).to(dtype)
        prev = None
        if ch.context > 0:
            # the sequence's chunk before this one (its carry's rows)
            prev = next((kk for kk in reversed(range(k))
                         if pipe.chunks[kk].seq_id == ch.seq_id), k - 1)
            rows = _block_rows(pipe.chunks[prev].tokens,
                               g.d_s_eff if sp_ranks else 1)
            zc = st._zero_carry(len(st.blocks[j]))
            st.carries[j][ch.seq_id] = (prev, carry_map(
                lambda t: _grow(t, rows), zc))
        handoffs = [0, 0]

        def hand(x):
            parts = x if isinstance(x, tuple) else (x,)
            handoffs[0] += 1
            handoffs[1] += sum(e.numel() * e.element_size() for e in parts
                               if e is not None)
        if x_in is not None:
            hand(x_in)
        if backward:
            y = st.forward(k, j, x_in)
        else:
            with torch.no_grad():
                y = st.forward(k, j, x_in)
        sig = _sig("out", y)
        if y is not None:
            hand(y)
        rec = st.live[j][k]
        sig += _sig("carry_out", rec.get("ctx_out"))
        if backward:
            if rec.get("ctx_out") is not None:
                st.dkv[j][k] = carry_map(torch.zeros_like, rec["ctx_out"])
            gy = None if y is None else (
                tuple(None if t is None else torch.ones_like(t) for t in y)
                if isinstance(y, tuple) else torch.ones_like(y))
            if gy is not None:
                hand(gy)
            gx = st.backward(k, j, gy)
            if g.split_bwd:
                st.weight_grads(k, j)
            sig += _sig("stream_grad", gx)
            if gx is not None:
                hand(gx)
            if prev is not None:
                sig += _sig("carry_grad", st.dkv[j].pop(prev, None))
            sig += _sig("grad_sums", accs)
        st.live[j].clear()
        st.carries[j].clear()
        st.dkv[j].clear()
        st.inputs = st.acc = st.acc_of = None
        if sp_ranks:
            from repro_torch.models.model import tree_leaves
            for leaf in tree_leaves(st.sharded):
                leaf.accs = None
        if encdec:
            trainer._frames = None
        return {"signature": sig, "handoffs": tuple(handoffs)}
    return run


def _encdec_stream(trainer, st, inputs, device, dtype):
    """The stream an encoder-decoder stage receives for a chunk: None at
    the first stage; an encoder stage's (or the first decoder stage's)
    encoder rows; a later decoder stage's memory rows and decoder rows
    (each a tuple over the ranks at ``d_s > 1``)."""
    if st.p == 0:
        return None
    D = trainer.cfg.spec.d_model
    frames, _, _, tokens = inputs[:4]
    d = trainer.geom.d_s
    if d > 1:
        enc = tuple(torch.randn(f.shape[0], D, device=device).to(dtype)
                    for f in frames)
        dec = tuple(torch.randn(t.shape[0], D, device=device).to(dtype)
                    for t in tokens) if st.role == "decoder" and \
            not st.first_dec else (None,) * d
        return enc + dec
    enc = torch.randn(frames.shape[0], D, device=device).to(dtype)
    dec = torch.randn(tokens.shape[0], D, device=device).to(dtype) \
        if st.role == "decoder" and not st.first_dec else None
    return (enc, dec)


def _prefill_units(cfg, plan, mesh, device, params, rec, dtype, seed,
                   estimates) -> Cell:
    """The pipelined prefill (``DecodeStepBuilder``'s stages): a rank holds
    its stage's parameters (whole: a stage's ranks share them) and the
    context buffers of the sequence it continues."""
    from repro_torch.runtime.pipeline import carry_map
    from repro_torch.runtime.serve_step import DecodeStepBuilder
    d_p, d_s = mesh.d_p, mesh.d_s
    builder = DecodeStepBuilder(cfg, params, d_p=d_p, d_s=d_s,
                                compute_dtype=dtype, device=device)
    pi, k, gk = _largest(plan)
    ch = plan.pipelines[pi].chunks[k]
    units_at = _unit_stages(d_p, estimates)
    ctx_rows = _block_rows(ch.context, d_s) if ch.context else 0
    stage_bytes: List[List[int]] = []
    carries: Dict[int, object] = {}
    totals = {"params": 0, "context": 0}
    for p in range(d_p):
        zc = builder._zero_carry(p)
        ctx = carry_map(lambda t: _grow(t, ctx_rows), zc) if ctx_rows \
            else zc
        carries[p] = ctx
        per = tensor_bytes(builder.stages[p]) + tensor_bytes(list(ctx))
        stage_bytes.append([per] * d_s)
        totals["params"] += _distinct_bytes(builder.stages[p])
        totals["context"] += tensor_bytes(list(ctx))
    assumptions = [
        "the port's prefill runs one sequence a chunk: the plan's largest "
        "chunk (rows with its context) as one sequence's rows behind a "
        "zero context of its context rows",
        "prefill on d_s > 1 ranks runs the allgather_kv model "
        "(DecodeStepBuilder), whatever the plan's policy",
        "attention operations count the causal (or window) mask of the "
        "padded rows: meta tensors carry no segments",
        "a stage's ranks share its parameters and the replicated context "
        "(one process); each rank's holding counts both whole",
    ]
    units = []
    prompt = np.zeros(ch.context + ch.tokens, dtype=np.int64)
    for p in units_at:
        st = builder.pstages[p]

        def run(p=p, st=st) -> Dict:
            torch.manual_seed(seed)
            tok, seg, pos = builder._chunk(p, prompt, ch.context,
                                           ch.context + ch.tokens)
            x_in = None
            D = cfg.spec.d_model
            if p > 0:
                x_in = [torch.randn((t.shape[0], D), device=device).to(dtype)
                        for t in seg] if isinstance(seg, list) else \
                    torch.randn((seg.shape[0], D), device=device).to(dtype)
            with torch.no_grad():
                h, new = st.prefill(x_in, tok, seg, pos, carries[p],
                                    ch.context)
            n = 0 if x_in is None else 1
            b = 0 if x_in is None else tensor_bytes(x_in)
            return {"signature": _sig("out", h) + _sig("carry_out", new),
                    "handoffs": (n + (p < d_p - 1),
                                 b + (tensor_bytes(h) if p < d_p - 1
                                      else 0))}
        units.append(Unit(
            name=f"stage {p}" + (" (last)" if p == d_p - 1 else
                                 " (largest estimate)"),
            stage=p, ranks=d_s, rank_bytes=stage_bytes[p], run=run,
            info={"chunk": gk, "tokens": ch.tokens, "context": ch.context,
                  "rows": _block_rows(ch.tokens, d_s)}))
    return Cell(rec, stage_bytes, units, assumptions, totals=totals,
                holder=builder)


# -- the encoder-decoder's train and prefill --------------------------------

def _encdec_cell(*, cfg, shape, mesh, cluster, device, params, rec, dtype,
                 seed, ckpt_policy, zero3_mode) -> Cell:
    from repro_torch.core.checkpointing import encoder_stage_split
    from repro_torch.core.schedule import get_schedule
    from repro_torch.launch.analysis import BucketDims, analytic_collectives
    from repro_torch.runtime.encdec_pipeline import EncDecGeometry
    from repro_torch.runtime.train_step import EncDecTrainer
    s = cfg.spec
    d_p, d_s = mesh.d_p, mesh.d_s
    cm, plan, per_pod = _plan(cfg, shape, mesh, cluster, sp_policy="auto",
                              sp_degree=d_s, ckpt_policy=ckpt_policy)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    cap = -(-plan.chunk_capacity // d_s) * d_s
    l_max, table, digest = plan.ckpt_policy(len(chunks))
    enc_st, dec_st = encoder_stage_split(s.n_encoder_layers, s.n_layers, d_p)
    L_ps = max(-(-s.n_encoder_layers // enc_st), -(-s.n_layers // dec_st))
    geom = EncDecGeometry(
        d_p=d_p, schedule=plan.schedule,
        split_bwd=get_schedule(plan.schedule, 1).split_bwd, d_s=d_s,
        zero3_mode=zero3_mode if d_s > 1 else None)
    dims = BucketDims(n_chunks=len(chunks), cap=cap, ctx_cap=cap + d_s,
                      l_ckpt=l_max, layers_per_stage=L_ps, ckpt_table=table,
                      cap_enc=cap, enc_stages=enc_st)
    rec["plan"] = {"K": plan.k_split, "n_chunks": len(chunks), "cap": cap,
                   "schedule": plan.schedule, "ckpt_policy": ckpt_policy,
                   "ckpt_digest": digest,
                   "l_ckpt_stage": plan.ckpt_per_stage_max()}
    rec["geometry"] = {"n_chunks": len(chunks), "cap": cap, "cap_enc": cap,
                       "enc_stages": enc_st, "layers_per_stage": L_ps,
                       "policy": geom.policy, "l_ckpt": l_max}
    rec["analytic_collectives"] = analytic_collectives(cfg, geom, shape.kind,
                                                       dims)
    estimates = [max(p.est_peak_mem[q] for p in plan.pipelines
                     if p.est_peak_mem) for q in range(d_p)] \
        if any(p.est_peak_mem for p in plan.pipelines) else []
    corpus_len = shape.seq_len
    if device.type == "meta":
        frames = {sid: torch.empty((corpus_len, s.d_model), dtype=dtype,
                                   device=device) for sid in range(per_pod)}
    else:       # drawn on the device, kept on the host: a chunk's rows go
        from repro_torch.data.batching import sequence_frames  # as it runs
        frames = {sid: f.cpu() for sid, f in sequence_frames(
            cfg, _corpus(per_pod, corpus_len, s.vocab, seed), seed,
            device=device, dtype=dtype).items()}
    cell = _train_units(cfg, shape, plan, geom, mesh, cm, device, params,
                        rec, dtype, seed, per_pod, estimates,
                        trainer_cls=EncDecTrainer, frames=frames)
    cell.assumptions.append(
        "the encoder-decoder's plan keeps the reference's pin "
        f"(allgather_kv over all {d_s} ranks), whatever the plan's SP point")
    if shape.kind == "prefill":
        cell.assumptions.append(
            "the encoder-decoder's prefill cell is the stage-split "
            "pipeline's forward (the reference's), without gradients")
    _memory_record(cell, estimates, cluster.capacity_bytes)
    return cell


# -- decode -------------------------------------------------------------------

def _pod_view(state: Dict, n_pods: int, q: int = 0) -> Dict:
    """Pod ``q``'s part of a decode state with the pod dim."""
    if n_pods == 1:
        return state
    out = {k: v for k, v in state.items() if k not in ("n_pods",)}
    for name, v in state.items():
        if name == "tokens":
            out[name] = v[q]
        elif name == "memory":
            out[name] = [t[q] for t in v]
        elif isinstance(v, list):
            out[name] = [[t[q] for t in ranks] for ranks in v]
    return out


def _decode_cell(*, cfg, shape, mesh, cluster, device, params, rec, dtype,
                 seed) -> Cell:
    from repro_torch.launch.analysis import analytic_collectives
    from repro_torch.runtime.serve_step import (DecodeStepBuilder,
                                                _decode_layers,
                                                init_decode_state,
                                                make_decode_geometry)
    d_p, d_s, n_pods = mesh.d_p, mesh.d_s, mesh.n_pods
    per_pod = max(1, shape.global_batch // n_pods)
    geom = make_decode_geometry(cfg, d_p=d_p, d_s=d_s, batch_per_pod=per_pod,
                                cache_len=shape.seq_len,
                                compute_dtype=dtype)
    rec["plan"] = {"n_micro": geom.n_micro, "bm": geom.bm,
                   "cache_len": geom.cache_len}
    rec["geometry"] = {"n_micro": geom.n_micro, "cache_len": geom.cache_len,
                       "layers_per_stage": geom.layers_per_stage}
    rec["analytic_collectives"] = analytic_collectives(cfg, geom, "decode")
    builder = DecodeStepBuilder(cfg, params, d_p=d_p, d_s=d_s,
                                compute_dtype=dtype, device=device)
    # the first stage's state where the unit runs, the others on meta
    devs = [device] + [META] * (d_p - 1)
    state = init_decode_state(cfg, geom, devs, n_pods=n_pods)
    state["length"] = geom.cache_len
    stage_bytes: List[List[int]] = []
    for p in range(d_p):
        pb = tensor_bytes(builder.stages[p])
        per = []
        for r in range(d_s):
            own = [state[n][p][r] for n in ("cache_k", "cache_v", "ssm_h",
                                            "conv_tail") if n in state]
            if p == 0:
                own += [state["tokens"]] + ([state["memory"][r]]
                                            if "memory" in state else [])
            per.append(pb + tensor_bytes(own) // n_pods)
        stage_bytes.append(per)
    model = builder.model
    view = _pod_view(state, n_pods)

    def run() -> Dict:
        length = view["length"]
        x = model.embed(builder.stages[0], view["tokens"][0].long(), dtype)
        rope = None if cfg.spec.is_encoder_decoder else model.rope_tables(
            torch.full((geom.bm,), length, dtype=torch.int32, device=device))
        memory = view.get("memory")
        x = _decode_layers(model, geom, builder.stages[0], view, 0, 0, x,
                           rope, memory)
        return {"signature": _sig("out", x),
                "handoffs": (int(d_p > 1), tensor_bytes(x) * (d_p > 1))}

    assumptions = [
        f"one tick of the first stage: microbatch 0 ({geom.bm} sequences) "
        f"at row {geom.cache_len}, its cache full",
        "a stage's ranks share its parameters (the port's decode keeps "
        "them whole); each rank's holding counts them whole and its own "
        "blocks of the state",
        "attention operations count the causal (or window) mask of the "
        "padded rows: meta tensors carry no segments",
    ]
    if n_pods > 1:
        assumptions.append(f"the state's lead pod dim ({n_pods} pods, "
                           f"{per_pod} sequences each): a rank holds its "
                           f"pod's share; the tick runs pod 0")
    units = [Unit(name="stage 0 (first) tick", stage=0, ranks=d_s,
                  rank_bytes=stage_bytes[0], run=run,
                  info={"bm": geom.bm, "s_loc": geom.s_loc,
                        "length": geom.cache_len})]
    totals = {"params": sum(_distinct_bytes(st) for st in builder.stages),
              "decode_state": tensor_bytes([v for v in state.values()
                                            if isinstance(v, (list,
                                                              torch.Tensor))])}
    cell = Cell(rec, stage_bytes, units, assumptions, totals=totals,
                holder=builder)
    _memory_record(cell, [], cluster.capacity_bytes)
    return cell


# ---------------------------------------------------------------------------
# the trace

def trace_unit(unit: Unit) -> Dict:
    """Run ``unit`` once on meta under the tallies: ``trace_peak_bytes``
    (live bytes above the holding, all its ranks), ``flops`` (aten,
    ``torch.utils.flop_counter``), ``kernel_ops`` (each kernel's calls and
    operations, ``kernels/meta``), ``collectives`` (by kind), the
    ``signature`` of its outputs, carries and gradients, ``trace_s``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import meta
    from repro_torch.launch.analysis import (collective_counts,
                                             collective_snapshot)
    meta.reset()
    before = collective_snapshot()
    t0 = time.perf_counter()
    flops = FlopCounterMode(display=False)
    live = _LiveBytes()
    with flops, live:
        out = unit.run()
    return {"name": unit.name, "stage": unit.stage, "ranks": unit.ranks,
            "info": unit.info, "rank_bytes": list(unit.rank_bytes),
            "trace_s": round(time.perf_counter() - t0, 3),
            "trace_peak_bytes": live.peak,
            "flops": float(flops.get_total_flops()),
            "kernel_ops": meta.snapshot(),
            "collectives": collective_counts(before, out["handoffs"]),
            "signature": [list(s) for s in out["signature"]]}


def card_launches() -> Dict[str, int]:
    """Each kernel's launches so far, by the names the meta route books
    (``kernels/meta``), and the plain versions' calls (``plain_*``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cross_entropy import (ce_bwd_dh_cuda,
                                                   ce_bwd_dw_cuda,
                                                   ce_fwd_cuda)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda,
                                                     flash_bwd_tiles_cuda,
                                                     flash_combine_cuda)
    from repro_torch.kernels.mamba_scan import (mamba_scan_bwd_cuda,
                                                mamba_scan_fwd_cuda)
    out = dict(flash_attention_cuda.by_kernel)
    out.update({"flash_combine_kernel": flash_combine_cuda.launches,
                "flash_bwd_tiles_kernel": flash_bwd_tiles_cuda.launches,
                "flash_bwd_dq_kernel": flash_bwd_dq_cuda.launches,
                "flash_bwd_dkdv_kernel": flash_bwd_dkdv_cuda.launches})
    for w in (ce_fwd_cuda, ce_bwd_dh_cuda, ce_bwd_dw_cuda,
              mamba_scan_fwd_cuda, mamba_scan_bwd_cuda):
        out.update(w.by_kernel)
    out.update({"plain_attention": ops.flash_attention.plain_calls,
                "plain_cross_entropy": ops.fused_cross_entropy.plain_calls,
                "plain_mamba_scan": ops.mamba_scan.plain_calls})
    return out


def measure_unit(unit: Unit) -> Dict:
    """Run ``unit`` built on a card (:func:`build_cell` with ``device``
    a card and real parameters) once, as :func:`trace_unit` runs it on
    meta: ``peak_bytes`` (``max_memory_allocated`` after a reset, less what
    was allocated before, ``base_bytes``; ``requested_peak_bytes`` the same
    in the bytes asked for, before the allocator's rounding and its
    unsplit blocks), each kernel's ``launches`` in the
    run (by the meta route's names, with the plain versions' calls),
    ``collectives``, ``signature``, ``run_s``. cuBLAS's workspaces are made
    first (on this thread and autograd's), outside the measurement, and
    the allocator's free cached blocks released: a cached block larger
    than a request, which the allocator may hand out unsplit, would count
    whole in the peak, so an earlier run's cache would move it."""
    import gc

    from repro_torch.launch.analysis import (collective_counts,
                                             collective_snapshot)
    dev = torch.device("cuda", torch.cuda.current_device())
    for dt in (torch.bfloat16, torch.float32):
        w = torch.ones((64, 64), dtype=dt, device=dev, requires_grad=True)
        (w @ w).sum().backward()
    del w
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    was = card_launches()
    before = collective_snapshot()
    base = torch.cuda.memory_allocated()
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = unit.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    asked = torch.cuda.memory_stats()["requested_bytes.all.peak"] - asked
    now = card_launches()
    return {"name": unit.name, "peak_bytes": int(peak), "base_bytes": base,
            "requested_peak_bytes": int(asked),
            "launches": {k: now[k] - was.get(k, 0) for k in now
                         if now[k] != was.get(k, 0)},
            "collectives": collective_counts(before, out["handoffs"]),
            "signature": [list(s) for s in out["signature"]],
            "run_s": round(run_s, 3)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[Path] = None, remat_override=None,
             note: str = "", zero3_mode: str = "per_tick",
             ckpt_policy: str = "stage-aware", sp_policy: str = "auto",
             sp_degree: int = 0, cluster=None) -> dict:
    """One cell's record: plan, geometry, analytic collectives, each rank's
    holding and its units' traces. ``out_dir`` is the reference's
    argument (the caller writes the record)."""
    cell = build_cell(arch, shape_name, multi_pod, cluster=cluster,
                      remat_override=remat_override, zero3_mode=zero3_mode,
                      ckpt_policy=ckpt_policy, sp_policy=sp_policy,
                      sp_degree=sp_degree, note=note)
    rec = cell.rec
    if rec.get("status") == "skipped":
        return rec
    rec["build_s"] = round(cell.build_s, 3)
    t0 = time.perf_counter()
    units = [trace_unit(u) for u in cell.units]
    rec["trace_s"] = round(time.perf_counter() - t0, 3)
    rec["units"] = units
    mem = rec["memory"]
    top = max(units, key=lambda u: u["trace_peak_bytes"])
    peak = top["trace_peak_bytes"]
    mem["trace_peak_bytes"] = peak
    # a bound: a unit's ranks in one process hold more than one rank does
    mem["fits"] = bool(mem["argument_bytes"] + peak <= mem["capacity_bytes"])
    mem["rank_share_peak_bytes"] = peak // top["ranks"]
    rec["flops"] = sum(u["flops"] for u in units)
    ops: Dict[str, Dict[str, float]] = {}
    for u in units:
        for kname, v in u["kernel_ops"].items():
            o = ops.setdefault(kname, {"calls": 0, "ops": 0.0})
            o["calls"] += v["calls"]
            o["ops"] += v["ops"]
    rec["kernel_ops"] = ops
    rec["collectives_static"] = units[0]["collectives"]
    rec["assumptions"] = cell.assumptions
    rec["status"] = "ok"
    return rec


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="plan, size and trace (arch x shape x mesh) cells on "
                    "the meta device")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--remat", type=int, default=None)
    ap.add_argument("--zero3", default="per_tick",
                    choices=["per_tick", "per_step"])
    ap.add_argument("--ckpt-policy", default="stage-aware",
                    choices=["stage-aware", "uniform"],
                    help="per-stage remat axis of the sweep: the ILP's "
                         "per-(stage, chunk) vector (stage-aware) or its "
                         "collapsed max (uniform)")
    ap.add_argument("--sp-policy", default="auto",
                    choices=["auto", "none", "ulysses", "allgather_kv"],
                    help="pin the plan's SP policy (train cells only; "
                         "prefill always runs the full model axis)")
    ap.add_argument("--sp-degree", type=int, default=0,
                    help="pin the effective SP degree (0 = planner-chosen; "
                         "must divide the model-axis size)")
    ap.add_argument("--note", default="")
    ap.add_argument("--cache-dir", default="",
                    help="not ported: the compile cache's store is "
                         "ROADMAP.md queue 1, item 8")
    ap.add_argument("--lint", default="off",
                    choices=["off", "warn", "error"],
                    help="not ported: the program auditor is ROADMAP.md "
                         "queue 1, item 10")
    args = ap.parse_args(argv)

    if args.cache_dir:
        ap.error("--cache-dir: the port has no compile cache or its store "
                 "yet (ROADMAP.md queue 1, item 8)")
    if args.lint != "off":
        ap.error("--lint: the program auditor (the jaxpr and HLO passes) "
                 "is not ported (ROADMAP.md queue 1, item 10)")
    if not args.all and not (args.arch and args.shape):
        ap.error("name --arch and --shape, or --all")
    from repro_torch.telemetry.stats_io import atomic_write_json
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multipod]

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = cell_tag(arch, shape, mp, args.note)
            path = out_dir / f"{tag}.json"
            if path.exists():
                print(f"[skip-cached] {tag}")
                continue
            print(f"[run] {tag}", flush=True)
            try:
                rec = run_cell(arch, shape, mp, out_dir,
                               remat_override=args.remat, note=args.note,
                               zero3_mode=args.zero3,
                               ckpt_policy=args.ckpt_policy,
                               sp_policy=args.sp_policy,
                               sp_degree=args.sp_degree)
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
            # atomic: a concurrent sweep aggregator never reads a torn cell
            atomic_write_json(path, rec)
            if rec["status"] == "ok":
                mem = rec["memory"]
                print(f"  -> ok build={rec['build_s']}s "
                      f"trace={rec['trace_s']}s "
                      f"flops={rec.get('flops', 0):.3e} "
                      f"arg={mem['argument_bytes'] / 1e9:.3f}GB "
                      f"peak={mem.get('trace_peak_bytes', 0) / 1e9:.3f}GB "
                      f"fits={mem.get('fits')}", flush=True)
            else:
                print(f"  -> {rec['status']} "
                      f"{rec.get('reason', rec.get('error', ''))[:200]}",
                      flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
