"""The chunked training step: on one card (``d_p = d_s = 1``,
:class:`ChunkedTrainer`) and pipelined over ``d_p`` stages
(:class:`PipelineTrainer`).

Single-GPU counterpart of the JAX package's ``runtime/{train_step,
pipeline,executor}.py``. It runs an :class:`~repro_torch.core.ExecutionPlan`
as the planner laid it out:

* the plan's pipelines run one after another, their gradients summed
  (gradient accumulation between 1F1B pipelines);
* inside a pipeline, forward and backward ticks follow the plan's own
  stage schedule (``PipelinePlan.schedule[0]``): forwards in chunk order up
  to the in-flight window, backwards in ``core/schedule.backward_order``,
  so at most one window of the pipeline's residuals is alive — the memory
  model the checkpointing ILP solved against;
* a chunk with context ``C > 0`` continues its sequence: it attends to the
  KV carry that the sequence's previous chunk wrote (a carry starts empty
  and grows by each chunk's rows: ``models/attention``), and its mamba
  layers
  start from that chunk's state ``(h, conv_tail)``. The carry (every
  field of :class:`~repro_torch.models.LayerCtx`) is cut out of the
  autograd graph between the two chunks (fresh leaves), so the later
  chunk's backward, which runs first, leaves the carry's gradient — the
  paper's dKV term, and ``dh``, ``d tail`` for the SSM state — on those
  leaves, and the earlier chunk's backward starts from
  ``torch.autograd.backward([loss_k, carry_k], [scale, d carry])``. A
  chunk with dependents holds its sequence's slice alone, from row 0, so
  its last live row — where the SSM state is taken — is the slice's;
* chunk ``k`` recomputes the leading ``plan.ckpt_table()[0][k]`` layers in
  its backward (stage-aware remat, Eq. 9-11);
* every chunk's loss is seeded with ``1 / max(n_valid, 1)`` — the step's
  valid-token count, known from the chunk buffers before any backward —
  so the summed gradients are those of the mean loss; then AdamW.

Chunks are cut to their used tokens (rounded up to 64 rows) instead of the
plan's bucket capacity: on one card nothing is compiled per shape, and
padding rows carry no loss and attend to nothing.

:class:`PipelineTrainer` runs the same step over ``d_p`` stages
(``runtime/{sharding,program,executor,pipeline}.py``): each stage's layers,
AdamW master and moments on its own device (``runtime/sharding.
stage_devices``), each pipeline through the executor under the run's
schedule backend, the remat table's row per stage. Tied embeddings keep
a copy on the first stage's device and one on the last's: their
gradients are summed, both copies take the same update, and the step
checks they hold the same bits after it. The gradients' global norm spans
every stage and counts the tied weight once. On one stage its loss and
gradients are :class:`ChunkedTrainer`'s, bit for bit. With ``d_s > 1``
(the sequence-parallel axis) a stage is a ``pipeline.SPStage`` of ``d_s``
ranks, each owning its ZeRO-3 shards of the stage's parameters, gradient
sums and AdamW state; each step runs at its plan's SP point
(``PipelineGeometry.for_plan``, the decoder of :meth:`PipelineTrainer.
sp_model`) and each chunk's rows go to the ranks in row blocks
(:func:`chunk_arrays` with ``blocks``).
"""

from __future__ import annotations

import dataclasses
import functools
import gc
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plan import ExecutionPlan, PipelinePlan, TickOp
from repro_torch.core.schedule import build_schedule
from repro_torch.data.batching import ChunkBatch, materialize_plan
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import (DecoderLM, LayerCtx, tree_leaves,
                                      tree_map, tree_unflatten,
                                      unstack_layers)
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               square_sum)
from repro_torch.weights import (OPT_KEYS, from_stages, state_from_stages,
                                 state_to_stages, to_stages)

from .executor import PipelineExecutor, remat_tick_count
from .pipeline import PipelineGeometry, PipelineStage, SPStage
from .program import residual_peaks, stage_programs
from .sharding import (layers_per_stage, map_layout, shard_layout,
                       shard_leaf, stage_blocks, stage_devices, unshard_leaf)

__all__ = ["ChunkedTrainer", "PipelineTrainer", "EncDecTrainer",
           "StepResult", "remat_depths", "stage_remat", "chunk_arrays",
           "sequence_rows", "pod_plans", "ROW_MULTIPLE"]

ROW_MULTIPLE = 64      # chunk rows are cut to a multiple of this


def remat_depths(plan: ExecutionPlan, n_layers: int,
                 policy: str = "stage-aware") -> List[int]:
    """Remat depth of every chunk (all pipelines' chunks in order):
    the plan's per-chunk table on its (only) stage for ``"stage-aware"``,
    its largest entry everywhere for ``"uniform"``, 0 for ``"none"``."""
    table = plan.ckpt_table()
    row = table[0] if table else []
    if policy == "uniform":
        row = [plan.uniform_ckpt()] * len(row)
    elif policy == "none":
        row = [0] * len(row)
    elif policy != "stage-aware":
        raise ValueError(f"unknown remat policy {policy!r}")
    return [min(max(int(d), 0), n_layers) for d in row]


def _table(plan: ExecutionPlan, d_p: int, policy: str) -> List[List[int]]:
    """The plan's ``[d_p][chunks]`` remat table under ``policy``."""
    table = plan.ckpt_table()
    n = plan.n_chunks
    if not table:
        table = [[0] * n for _ in range(d_p)]
    if len(table) != d_p:
        raise ValueError(f"the plan's remat table has {len(table)} stage "
                         f"rows, the pipeline {d_p} stages")
    if policy == "uniform":
        return [[plan.uniform_ckpt()] * n for _ in range(d_p)]
    if policy == "none":
        return [[0] * n for _ in range(d_p)]
    if policy != "stage-aware":
        raise ValueError(f"unknown remat policy {policy!r}")
    return [[int(d) for d in row] for row in table]


def stage_remat(plan: ExecutionPlan, n_layers: int, d_p: int, v: int = 1,
                policy: str = "stage-aware") -> List[List[List[int]]]:
    """``depths[p][j][k]``: how many layers of stage ``p``'s virtual stage
    ``j`` chunk ``k`` (all pipelines' chunks in order) recomputes in its
    backward: the plan's table entry split ``ceil(l / v)`` over the
    virtual stages (``executor.remat_tick_count``), at most the block's
    real layers. (The step remats every layer of the forwards its
    interleaved order marks, ``program.Action.remat``.)"""
    table = _table(plan, d_p, policy)
    blocks = stage_blocks(d_p, n_layers, v)
    l_v = layers_per_stage(n_layers, d_p) // v
    return [[[min(remat_tick_count(table, p, k, v=v, l_max=l_v),
                  len(blocks[p][j])) for k in range(plan.n_chunks)]
             for j in range(v)] for p in range(d_p)]


@dataclass
class StepResult:
    loss: float                 # mean loss over the step's valid tokens
    n_valid: int
    chunks: int
    remat_layers: int           # sum of the chunks' remat depths
    grads: Optional[Dict] = None        # float32, mean-loss gradients
    grad_norm: Optional[float] = None   # set by the trainers' step
    # PipelineTrainer: hand-offs and their bytes, bytes copied between
    # cards, the schedule backend and v, whether the backward was split,
    # and each stage's peak under the order run in the planner's memory
    # model (program.residual_peaks; bytes, 0 without a cost model)
    pipeline: Optional[Dict] = None


def _rows(n: int) -> int:
    return -(-max(n, 1) // ROW_MULTIPLE) * ROW_MULTIPLE



def chunk_arrays(batch: ChunkBatch, k: int, tokens: int,
                 blocks: Optional[int] = None):
    """What the step feeds the model for chunk ``k`` of ``tokens`` used
    tokens: its rows cut to a multiple of ``ROW_MULTIPLE * blocks`` (padded
    past the buffer's width with seg = -1, target = -1) as int64 tokens
    and targets, int32 seg and pos. Padding rows read token 0 at position
    0, as the reference's step feeds them. ``blocks`` (a sequence-parallel
    group's ranks): each array as a list of its ``blocks`` contiguous row
    blocks, rank order (``data/batching.rank_blocks``)."""
    if blocks is not None:
        from repro_torch.data.batching import rank_blocks
        return rank_blocks(chunk_arrays(batch, k, -(-max(tokens, 1) // (
            ROW_MULTIPLE * blocks)) * ROW_MULTIPLE * blocks), blocks)
    n = _rows(tokens)

    def row(a, fill):
        r = a[k, :n]
        return np.pad(r, (0, n - len(r)), constant_values=fill)
    seg = row(batch.seg, -1)
    live = seg >= 0
    return (np.where(live, row(batch.tokens, 0), 0).astype(np.int64),
            row(batch.targets, -1).astype(np.int64),
            seg, np.where(live, row(batch.pos, 0), 0).astype(np.int32))


def sequence_rows(toks: np.ndarray):
    """One whole sequence as the unchunked reference steps feed it:
    ``(tokens, targets, seg, pos)`` over its rows cut to a multiple of
    ROW_MULTIPLE (int64 tokens and next-token targets, -1 past the last;
    seg 0 on its rows, -1 on the padding; int32 seg and pos)."""
    toks = np.asarray(toks, np.int64)
    n, rows = len(toks), _rows(len(toks))
    tgt = np.full(rows, -1, np.int64)
    tgt[:n - 1] = toks[1:]
    seg = np.full(rows, -1, np.int32)
    seg[:n] = 0
    pos = np.zeros(rows, np.int32)
    pos[:n] = np.arange(n)
    return np.pad(toks, (0, rows - n)), tgt, seg, pos


@torch.no_grad()
def _copy_into(dst, src) -> None:
    """Copy the tensors of tree ``src`` into tree ``dst``'s, leaf by leaf in
    :func:`tree_leaves`' order (a restore that changes no tensor's
    identity: parameters stay the same autograd leaves, with their
    hooks)."""
    d, s = tree_leaves(dst), tree_leaves(src)
    if len(d) != len(s):
        raise ValueError(f"{len(s)} leaves for a state of {len(d)}")
    for a, b in zip(d, s):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"a {b.dtype} {tuple(b.shape)} leaf for a "
                             f"{a.dtype} {tuple(a.shape)} one")
        a.copy_(b)


def _take_grad(sink: List, i: int, p: torch.Tensor) -> None:
    """A parameter's post-accumulate hook: its gradient added into
    ``sink[0][i]`` and dropped (left on the parameter when no backward of
    the trainer set ``sink[0]``)."""
    if sink[0] is not None:
        with torch.no_grad():
            sink[0][i].add_(p.grad)
        p.grad = None


class ChunkedTrainer:
    """Parameters, optimizer state and the chunked step of one model.

    ``params``: the port's parameter dict (stacked or per-layer ``layers``;
    any dtype), converted to live parameters of ``compute_dtype`` on
    ``device``, one autograd leaf per layer weight; the AdamW master is a
    float32 copy of the live values (as the reference copies its
    compute-dtype parameters), updated with the reference trainer's
    default :class:`AdamWConfig`."""

    def __init__(self, cfg: ArchConfig, params: Dict, *, device,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.model = DecoderLM(cfg)
        self.device = torch.device(device)
        self.dtype = compute_dtype
        self.adamw = AdamWConfig()
        self.params = tree_map(
            lambda a: a.detach().to(self.device, compute_dtype,
                                    copy=True).requires_grad_(True),
            unstack_layers(params))
        self.opt = init_opt_state(self.params)
        # the float32 sums a backward adds each parameter's gradient into
        # (set by _backward), through each leaf's post-accumulate hook; the
        # hooks hold this one-element list, not the trainer (a parameter's
        # hook holding the trainer that holds the parameter is a cycle,
        # which kept a trainer's states on the card after its last use)
        self._sink: List[Optional[List[torch.Tensor]]] = [None]
        for i, p in enumerate(tree_leaves(self.params)):
            p.register_post_accumulate_grad_hook(
                functools.partial(_take_grad, self._sink, i))

    # ------------------------------------------------------------------
    def _chunk(self, batch: ChunkBatch, k: int, tokens: int):
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in chunk_arrays(batch, k, tokens))

    def _zero_grads(self) -> List[torch.Tensor]:
        return [torch.zeros(p.shape, dtype=torch.float32, device=self.device)
                for p in tree_leaves(self.params)]

    def _backward(self, outs, grads, acc: List[torch.Tensor]) -> None:
        """Backward from ``outs`` seeded with ``grads``; the parameters'
        gradients are added into the float32 sums ``acc`` (so a bf16
        parameter's gradient is summed over chunks in float32), each as
        soon as autograd has it, and dropped: the backward holds no
        compute-dtype gradient beyond the one being added (the planner's
        memory model charges the float32 sums, not those; the untied
        heads alone take 1 GB each at stablelm-12b's 100,352 x 5,120)."""
        self._sink[0] = acc
        try:
            torch.autograd.backward(outs, grads)
        finally:
            self._sink[0] = None

    def _zero_carry(self) -> LayerCtx:
        """Empty carry as per-layer lists (None for fields the family
        lacks: KV of no rows for attention layers, zero ``(h, tail)`` for
        mamba layers)."""
        ctx = self.model.init_ctx(0, self.dtype, device=self.device)
        return LayerCtx(*[None if f is None else list(f.unbind(0))
                          for f in ctx])

    def _run_pipeline(self, pipe: PipelinePlan, batch: ChunkBatch, base: int,
                      remat: Sequence[int], scale: torch.Tensor,
                      acc: List[torch.Tensor]) -> torch.Tensor:
        """Forward and backward of one pipeline's chunks (global indices
        ``base + k``); adds the parameter gradients into ``acc`` and returns
        the pipeline's summed loss."""
        model, params = self.model, self.params
        chunks = pipe.chunks
        order = (pipe.schedule or build_schedule(
            len(chunks), 1, pipe.n_split, pipe.f2b))[0]
        carries: Dict[int, Tuple[int, LayerCtx]] = {}   # seq -> (k, carry)
        live: Dict[int, Dict] = {}                      # k -> residuals
        dkv: Dict[int, LayerCtx] = {}       # k -> the carry's gradient
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for tick in order:
            k = tick.chunk
            ch = chunks[k]
            if tick.op is TickOp.FWD:
                rec = {"prev": None, "ctx_in": None, "ctx_out": None}
                if ch.context > 0:
                    if ch.seq_id not in carries:
                        raise RuntimeError(
                            f"chunk {base + k} continues sequence "
                            f"{ch.seq_id}, whose previous chunk is not in "
                            f"this pipeline")
                    rec["prev"], out = carries.pop(ch.seq_id)
                    ctx = LayerCtx(*[
                        None if f is None else
                        [a.detach().requires_grad_(True) for a in f]
                        for f in out])
                    rec["ctx_in"] = ctx
                elif ch.has_dependents:
                    ctx = self._zero_carry()
                else:
                    ctx = None
                if ch.has_dependents and len(ch.slices) != 1:
                    raise RuntimeError(
                        f"chunk {base + k} has dependents but holds "
                        f"{len(ch.slices)} slices: the carry it hands on "
                        f"must be its sequence's alone")
                tokens, targets, seg, pos = self._chunk(batch, base + k,
                                                        ch.tokens)
                hidden, ctx_out = model.forward_chunk(
                    params, tokens, seg, pos, ctx=ctx, ctx_len=ch.context,
                    compute_dtype=self.dtype, remat=remat[base + k])
                loss, _ = model.chunk_loss(params, hidden, targets, seg)
                rec["loss"] = loss
                if ch.has_dependents:
                    rec["ctx_out"] = ctx_out
                    carries[ch.seq_id] = (k, ctx_out)
                live[k] = rec
                total = total + loss.detach()
            else:
                rec = live.pop(k)
                outs, grads = [rec["loss"]], [scale]
                if rec["ctx_out"] is not None:
                    if k not in dkv:
                        raise RuntimeError(
                            f"backward of chunk {base + k} before the "
                            f"backward of the chunk that continues it")
                    g = dkv.pop(k)
                    for f, gf in zip(rec["ctx_out"], g):
                        for t, gt in zip(f or (), gf or ()):
                            if gt is not None:
                                outs.append(t)
                                grads.append(gt)
                self._backward(outs, grads, acc)
                if rec["ctx_in"] is not None:
                    dkv[rec["prev"]] = LayerCtx(*[
                        None if f is None else [a.grad for a in f]
                        for f in rec["ctx_in"]])
                del rec, outs, grads
        if live or dkv:
            raise RuntimeError("pipeline schedule left chunks without a "
                               "backward")
        return total

    # ------------------------------------------------------------------
    def loss_and_grads(self, plan: ExecutionPlan,
                       corpus: Dict[int, np.ndarray], *,
                       remat_policy: str = "stage-aware") -> StepResult:
        """Loss of the mean over valid tokens and float32 gradients of the
        live parameters (in ``params``' structure); each chunk's remat
        depth is the plan's table under ``remat_policy``."""
        batch = materialize_plan(plan, corpus)
        n_valid = int(((batch.seg >= 0) & (batch.targets >= 0)).sum())
        n_chunks = sum(len(p.chunks) for p in plan.pipelines)
        depths = remat_depths(plan, self.cfg.spec.n_layers, remat_policy)
        if len(depths) != n_chunks:
            raise ValueError(f"{len(depths)} remat depths for {n_chunks} "
                             f"chunks")
        scale = torch.tensor(1.0 / max(n_valid, 1), dtype=torch.float32,
                             device=self.device)
        acc = self._zero_grads()
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        base = 0
        for pipe in plan.pipelines:
            total = total + self._run_pipeline(pipe, batch, base, depths,
                                               scale, acc)
            base += len(pipe.chunks)
        grads = tree_unflatten(self.params, acc)
        return StepResult(loss=float(total) / max(n_valid, 1),
                          n_valid=n_valid, chunks=n_chunks,
                          remat_layers=int(sum(depths)), grads=grads)

    def sequence_loss_and_grads(self, corpus: Dict[int, np.ndarray]
                                ) -> StepResult:
        """The chunked step's reference on the same kernels: one unchunked
        forward and backward per sequence (no carry, no remat), seeded
        with the same ``1 / n_valid``."""
        n_valid = sum(max(len(t) - 1, 0) for t in corpus.values())
        scale = torch.tensor(1.0 / max(n_valid, 1), dtype=torch.float32,
                             device=self.device)
        acc = self._zero_grads()
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for sid in sorted(corpus):
            toks, tgt, seg, pos = (torch.from_numpy(a).to(self.device)
                                   for a in sequence_rows(corpus[sid]))
            hidden, _ = self.model.forward_chunk(
                self.params, toks, seg, pos, compute_dtype=self.dtype)
            loss, _ = self.model.chunk_loss(self.params, hidden, tgt, seg)
            self._backward([loss], [scale], acc)
            total = total + loss.detach()
        return StepResult(loss=float(total) / max(n_valid, 1),
                          n_valid=n_valid, chunks=len(corpus),
                          remat_layers=0,
                          grads=tree_unflatten(self.params, acc))

    def step(self, plan: ExecutionPlan, corpus: Dict[int, np.ndarray], *,
             remat_policy: str = "stage-aware") -> StepResult:
        """One training step: :meth:`loss_and_grads`, then AdamW on the
        mean-loss gradients (clipped by their global norm)."""
        res = self.loss_and_grads(plan, corpus, remat_policy=remat_policy)
        _, _, m = adamw_update(self.adamw, self.params, res.grads, self.opt)
        res.grads = None
        res.grad_norm = float(m["grad_norm"])
        return res

    def state_tree(self) -> Dict:
        """The trainer's state as a checkpoint tree (``weights.
        state_from_stages``' layout): the live parameters, AdamW's master,
        m and v (the tensors themselves, not copies) and its step."""
        return {"params": self.params, "step": int(self.opt["step"]),
                **{k: self.opt[k] for k in OPT_KEYS}}

    def load_state(self, state: Dict) -> None:
        """Overwrite the parameters, AdamW's master, m, v and step with
        those of the checkpoint tree ``state``, in place."""
        _copy_into(self.params, state["params"])
        for k in OPT_KEYS:
            _copy_into(self.opt[k], state[k])
        self.opt["step"] = int(state["step"])


class PipelineTrainer:
    """Parameters, optimizer state and the pipelined step of one model on
    ``geometry.d_p`` stages, stage ``p`` on card ``p mod len(cards)``.

    ``params``: the port's parameter dict (any dtype), copied per stage
    (``weights.to_stages``) to live parameters of ``compute_dtype``;
    ``cost_model``, if given, lets interleaved schedules keep each
    stage's residuals within the plan's estimate
    (``program.stage_programs``). The AdamW state is made at the first
    :meth:`step` (or :meth:`load_state`, which then overwrites it).

    At ``d_s > 1`` each of a stage's ranks owns its ZeRO-3 shards
    (``runtime/sharding``): ``params[p]`` is the list of the ranks' trees,
    and the float32 gradient sums and AdamW's master, m and v follow them;
    the global norm counts a shard once and a leaf kept whole on every
    rank once (the reference's ``_norm_factors``).

    ``n_pods`` data-parallel replicas of the pipeline (the reference's pod
    axis, one process): a plan's pipelines split over them in order
    (:func:`pod_plans`), each pod's step from its summed loss, the
    gradients summed over the pods (through ``optim/compression`` with
    ``compress_pod_grads``, each pod keeping its error state) and scaled
    by ``1 / n_valid`` of all pods, then AdamW on every pod's shards with
    the same norm."""

    def __init__(self, cfg: ArchConfig, params: Dict, *,
                 geometry: PipelineGeometry, cards: Sequence,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 cost_model=None, n_pods: int = 1,
                 compress_pod_grads: bool = False):
        g = geometry
        self.cfg, self.geom, self.dtype, self.cm = cfg, g, compute_dtype, \
            cost_model
        self.model = DecoderLM(cfg)
        self.adamw = AdamWConfig()
        self.devices = stage_devices(g.d_p, cards, g.d_s)
        self.blocks = stage_blocks(g.d_p, cfg.spec.n_layers, g.v_stages)
        stages = to_stages(cfg, params, g.d_p, g.v_stages)
        self.n_params = sum(a.numel() for a in tree_leaves(params))
        if g.d_s > 1:
            self.layouts = [shard_layout(sp, g.d_s) for sp in stages]
            self.params = [self._shard(sp, lay, dev) for sp, lay, dev in
                           zip(stages, self.layouts, self.devices)]
            self.stages = [SPStage(self.model, p, g, self.blocks[p],
                                   self.params[p], self.devices[p],
                                   compute_dtype, self.layouts[p])
                           for p in range(g.d_p)]
        else:
            self.layouts = None
            self.params = [
                tree_map(lambda a, d=dev: a.detach().to(
                    d, compute_dtype, copy=True).requires_grad_(True), sp)
                for dev, sp in zip(self.devices, stages)]
            self.stages = [PipelineStage(self.model, p, g, self.blocks[p],
                                         self.params[p], self.devices[p],
                                         compute_dtype)
                           for p in range(g.d_p)]
        del stages
        self._sp_models: Dict = {}
        self._tie(0)
        self.opt = None
        if n_pods < 1:
            raise ValueError(f"n_pods must be >= 1, got {n_pods}")
        self.compress = compress_pod_grads
        self.replicas = [
            PipelineTrainer(cfg, params, geometry=g, cards=cards,
                            compute_dtype=compute_dtype, cost_model=cost_model)
            for _ in range(n_pods - 1)]
        self.err = None         # per pod: each stage's flat error sums

    @property
    def pods(self) -> List["PipelineTrainer"]:
        """The pods' trainers, this one first (the others: ``replicas``;
        a list holding the trainer itself would be a reference cycle)."""
        return [self, *self.replicas]

    def _shard(self, tree: Dict, layout: Dict, dev) -> List[Dict]:
        """A stage's tree -> the ranks' trees of their own shards (live
        parameters of the compute dtype on ``dev``)."""
        d_s = self.geom.d_s
        cut = map_layout(lambda spec, a: shard_leaf(
            a.detach().to(dev, self.dtype), spec, d_s), layout, tree)
        return [map_layout(lambda spec, sh, r=r: sh[r].requires_grad_(True),
                           layout, cut) for r in range(d_s)]

    def _leaf_specs(self, p: int) -> List:
        """Stage ``p``'s flat leaves' :class:`~.sharding.LeafShard` (rank
        major, as ``tree_leaves(params[p])``); None entries at ``d_s = 1``."""
        n = len(tree_leaves(self.params[p]))
        if self.layouts is None:
            return [None] * n
        return tree_leaves(self.layouts[p]) * self.geom.d_s

    def _tie(self, first: int) -> None:
        """The tied embedding's copies, on stage ``first`` and the last:
        ``tied_stages``; ``tied_pairs``, their flat leaf indices, a pair a
        rank, and ``tied``, rank 0's (None when one stage holds both
        uses)."""
        last = self.geom.d_p - 1
        self.tied_stages, self.tied, self.tied_pairs = (first, last), None, []
        if "embed" in self._tree(last) and first != last:
            self.tied_pairs = list(zip(self._leaf_index(first, "embed"),
                                       self._leaf_index(last, "embed")))
            self.tied = self.tied_pairs[0]

    def _tree(self, p: int) -> Dict:
        """Stage ``p``'s tree (rank 0's at ``d_s > 1``)."""
        return self.params[p][0] if self.layouts else self.params[p]

    def _leaf_index(self, p: int, key: str) -> List[int]:
        """The flat indices of stage ``p``'s leaf ``key`` (one a rank)."""
        trees = self.params[p] if self.layouts else [self.params[p]]
        leaves = tree_leaves(self.params[p])
        return [next(i for i, a in enumerate(leaves) if a is t[key])
                for t in trees]

    def _sum_tied(self, accs: List[List[torch.Tensor]]) -> None:
        """The tied embedding's gradient, the sum of its two copies', in
        both stages' sums, block by block (each copy's summed in its own
        stage's order, so the bits do not depend on how the stages
        interleave)."""
        p0, p1 = self.tied_stages
        for i0, i1 in self.tied_pairs:
            first, last = accs[p0][i0], accs[p1][i1]
            first.add_(last.to(first.device))
            last.copy_(first)

    # ------------------------------------------------------------------
    def loss_and_grads(self, plan: ExecutionPlan,
                       corpus: Dict[int, np.ndarray], *data,
                       remat_policy: str = "stage-aware") -> StepResult:
        """Loss of the mean over valid tokens and float32 gradients in the
        model's structure (``weights.from_stages``; tensors on their
        stages' devices; at ``d_s > 1`` gathered from the ranks' shard
        sums), the plan's pipelines one after another, each through the
        executor (with pods: the pods' summed gradients); ``data``: what
        the step takes beside the corpus."""
        res, accs = self._step_grads(plan, corpus, *data,
                                     remat_policy=remat_policy)
        res.grads = self._model_layout(accs)
        return res

    def _model_layout(self, accs: List[List[torch.Tensor]]) -> Dict:
        return from_stages(self.cfg, [
            self._full(p, tree_unflatten(self.params[p], a))
            for p, a in enumerate(accs)])

    def _step_grads(self, plan, corpus, *data, remat_policy="stage-aware"):
        """``(result, the float32 gradient sums of the mean loss)``: one
        pod's run, or every pod's runs and their sum."""
        if len(self.pods) == 1:
            return self._run(plan, corpus, *data, remat_policy=remat_policy)
        runs = self.pod_runs(plan, corpus, *data, remat_policy=remat_policy)
        n_valid = sum(r.n_valid for r, _ in runs)
        accs = self.reduce_pods([a for _, a in runs], n_valid)
        res = dataclasses.replace(
            runs[0][0], loss=sum(r.loss for r, _ in runs) / max(n_valid, 1),
            n_valid=n_valid, chunks=plan.n_chunks,
            remat_layers=sum(r.remat_layers for r, _ in runs))
        pipes = [r.pipeline for r, _ in runs]
        res.pipeline = dict(
            res.pipeline, n_pods=len(self.pods),
            compress_pod_grads=self.compress,
            pod_chunks=[r.chunks for r, _ in runs],
            pod_n_valid=[r.n_valid for r, _ in runs],
            order_peak_mem=[max(x) for x in zip(*(p["order_peak_mem"]
                                                  for p in pipes))],
            **{k: sum(p[k] for p in pipes) for k in (
                "handoffs", "handoff_bytes", "copied_bytes", "collectives",
                "collective_bytes", "memory_gathers", "memory_bytes")})
        if "zero3" in res.pipeline:     # (the pods run one after another)
            zs = [p["zero3"] for p in pipes]
            res.pipeline["zero3"] = dict(
                zs[0], peak_live_bytes=max(z["peak_live_bytes"] for z in zs),
                **{k: sum(z[k] for z in zs) for k in (
                    "gathers", "gather_bytes", "regathers",
                    "scatter_bytes")})
        return res, accs

    def pod_runs(self, plan, corpus, *data, remat_policy="stage-aware"):
        """Each pod's ``(result, gradient sums)`` on its share of ``plan``
        (:func:`pod_plans`), from its summed loss (the reference's pods
        differentiate their summed loss; the loss is its sum)."""
        out = []
        for pod, sub in zip(self.pods, pod_plans(plan, len(self.pods))):
            res, accs = pod._run(sub, corpus, *data,
                                 remat_policy=remat_policy, seed=1.0)
            res.loss *= max(res.n_valid, 1)          # the pod's summed loss
            out.append((res, accs))
        return out

    @torch.no_grad()
    def reduce_pods(self, pod_accs: List[List[List[torch.Tensor]]],
                    n_valid: int) -> List[List[torch.Tensor]]:
        """The pods' gradient sums summed in pod order (in place into pod
        0's), through int8 with error feedback when compressing, then
        scaled by ``1 / n_valid``: every pod's gradient for AdamW."""
        from repro_torch.optim.compression import init_error_state, q8_psum
        scale = 1.0 / max(n_valid, 1)
        if self.compress and self.err is None:
            self.err = [init_error_state(a) for a in pod_accs]
        total = pod_accs[0]
        for p in range(len(total)):
            for i, t in enumerate(total[p]):
                if self.compress:
                    errs = [e[p][i] for e in self.err]
                    summed, new = q8_psum([a[p][i] for a in pod_accs], errs)
                    for e, n in zip(errs, new):
                        e.copy_(n)
                    t.copy_(summed)
                    del summed, new
                else:
                    for a in pod_accs[1:]:
                        t.add_(a[p][i])
                t.mul_(scale)
        return total

    def _run(self, plan: ExecutionPlan, corpus: Dict[int, np.ndarray],
             *data, remat_policy: str = "stage-aware",
             seed: Optional[float] = None):
        """One pod's step: ``(result, the float32 gradient sums)``, each
        chunk's loss seeded with ``seed`` (default ``1 / n_valid``)."""
        g = self.geom.for_plan(plan) if self.geom.d_s > 1 else self.geom
        batch = self._materialize(plan, corpus)
        n_valid = int(((batch.seg >= 0) & (batch.targets >= 0)).sum())
        table = _table(plan, g.d_p, remat_policy)
        depths = self._stage_depths(plan, remat_policy)
        accs = [[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in tree_leaves(sp)] for sp in self.params]
        s = 1.0 / max(n_valid, 1) if seed is None else seed
        scales = [torch.tensor(s, dtype=torch.float32, device=d)
                  for d in self.devices]
        stats = {"handoffs": 0, "handoff_bytes": 0, "copied_bytes": 0}
        from . import sp
        from .sharding import ZSTATS, zstats_reset
        sp_before = dict(sp.STATS)
        if ZSTATS["live_bytes"]:
            # gathered copies of an earlier step that only a reference
            # cycle still holds (the first step's lazy imports leave one):
            # collected, so they neither take memory nor count as gathered
            gc.collect()
        zstats_reset()
        order_peaks = [0.0] * g.d_p
        total = torch.zeros((), dtype=torch.float32,
                            device=self.devices[-1])
        base = 0
        cm = self.cm
        if cm is not None and g.d_s > 1:
            cm = cm.with_sp(g.policy, g.d_s_eff)    # a rank's model
        if g.d_s > 1:
            for st in self.stages:
                st.zero3.gather_step()              # (per_step only)
        for pipe in plan.pipelines:
            n = pipe.n_chunks
            programs = stage_programs(
                pipe, g.d_p, v=g.v_stages, split=g.split_bwd, cm=cm,
                depths=[row[base:base + n] for row in table])
            if cm is not None and pipe.est_peak_mem:
                order_peaks = [max(a, b) for a, b in zip(
                    order_peaks, residual_peaks(
                        cm, pipe, programs,
                        [row[base:base + n] for row in table], g.v_stages))]
            for p, prog in enumerate(programs):     # forwards the order
                for a in prog:                      # remats past budget
                    if a.remat:
                        depths[p][a.vstage][base + a.chunk] = \
                            len(self.blocks[p][a.vstage])
            for p, st in enumerate(self.stages):
                if g.d_s > 1:
                    st.configure(self.sp_model(g.policy, g.d_s_eff),
                                 g.policy, g.d_s_eff)
                    inputs = self._inputs(batch, pipe, base, st.device,
                                          g.d_s_eff)
                else:
                    inputs = self._inputs(batch, pipe, base, st.device)
                st.begin(pipe.chunks, inputs,
                         [[row[base + k] for k in range(n)]
                          for row in depths[p]], scales[p], accs[p])
            ex = PipelineExecutor(self.stages, programs, v=g.v_stages)
            ex.run()
            for k in stats:
                stats[k] += ex.stats[k]
            for st in self.stages:
                loss = st.finish()
            total = total + loss        # the last stage's
            base += n
        if g.d_s > 1:
            for st in self.stages:
                st.zero3.release()
        self._sum_tied(accs)
        stats.update({f"collective_{k}" if k == "bytes" else k:
                      sp.STATS[k] - sp_before[k] for k in sp.STATS})
        if g.d_s > 1:
            stats["zero3"] = dict(
                {k: v for k, v in ZSTATS.items() if k != "live_bytes"},
                mode=g.zero3_mode, **self.state_bytes())
        return StepResult(
            loss=float(total) / max(n_valid, 1), n_valid=n_valid,
            chunks=plan.n_chunks,
            remat_layers=int(sum(d for p in depths for j in p for d in j)),
            pipeline=dict(stats, schedule=g.schedule, v=g.v_stages,
                          order_peak_mem=order_peaks,
                          split_bwd=g.split_bwd,
                          **({"sp_policy": g.policy, "d_s_eff": g.d_s_eff,
                              "d_s": g.d_s} if g.d_s > 1 else {}))), accs

    def state_bytes(self) -> Dict:
        """What each rank of each stage owns (``rank_state_bytes[p][r]``:
        its live parameters, float32 gradient sums, AdamW master, m and v)
        and, of that, the bytes of leaves kept whole on every rank
        (``whole_state_bytes[p][r]``); ``uncounted_state_bytes``: a rank's
        share of the parameters the planner's count
        (``ModelSpec.param_count``, the reference's) leaves out (the final
        norm, and norms and biases beside the projections), which its
        ``m_model_states`` cannot charge."""
        per = torch.tensor([], dtype=self.dtype).element_size() + 4 * 4
        uncounted = max(0, self.n_params - self.cfg.spec.param_count())
        own, whole = [], []
        for p, trees in enumerate(self.params):
            specs = tree_leaves(self.layouts[p])
            own.append([sum(a.numel() for a in tree_leaves(t)) * per
                        for t in trees])
            whole.append([sum(a.numel() for a, sp in zip(tree_leaves(t),
                                                         specs)
                              if sp.whole) * per for t in trees])
        return {"rank_state_bytes": own, "whole_state_bytes": whole,
                "uncounted_state_bytes": uncounted * per / self.geom.d_s}

    def rank_charges(self, cm) -> List[float]:
        """The planner's charge of a rank of each stage for its states
        (``cm.m_model_states``, a rank's ``1 / d_s``)."""
        return [cm.m_model_states(p + 1) for p in range(self.geom.d_p)]

    def sp_model(self, policy: str, d_s_eff: int) -> DecoderLM:
        """The decoder of one SP group at ``(policy, d_s_eff)``
        (``runtime/sp.make_model``, made once)."""
        from . import sp
        key = (policy, d_s_eff)
        if key not in self._sp_models:
            self._sp_models[key] = sp.make_model(self.cfg, policy, d_s_eff)
        return self._sp_models[key]

    def _materialize(self, plan: ExecutionPlan,
                     corpus: Dict[int, np.ndarray]) -> ChunkBatch:
        return materialize_plan(plan, corpus)

    def _stage_depths(self, plan: ExecutionPlan, policy: str
                      ) -> List[List[List[int]]]:
        return stage_remat(plan, self.cfg.spec.n_layers, self.geom.d_p,
                           self.geom.v_stages, policy)

    def _inputs(self, batch: ChunkBatch, pipe: PipelinePlan, base: int,
                device, blocks: Optional[int] = None):
        """``inputs(k)``: chunk ``k``'s rows on ``device`` and its rotation
        tables, made once per stage (its virtual stages share them);
        ``blocks``: each as a list over the SP group's row blocks."""
        cache: Dict[int, tuple] = {}

        def inputs(k: int):
            if k not in cache:
                arrays = chunk_arrays(batch, base + k,
                                      pipe.chunks[k].tokens, blocks)
                if blocks is None:
                    rows = [torch.from_numpy(a).to(device) for a in arrays]
                    cache[k] = (*rows, self.model.rope_tables(rows[3]))
                else:
                    rows = [[torch.from_numpy(a).to(device) for a in arr]
                            for arr in arrays]
                    cache[k] = (*rows, [self.model.rope_tables(p)
                                        for p in rows[3]])
            return cache[k]
        return inputs

    def norm_factors(self, p: int) -> List[float]:
        """Stage ``p``'s flat leaves' replication over the ranks (the
        reference's ``_norm_factors``): ``d_s`` for a leaf kept whole on
        every rank, 1 for a shard."""
        return [self.geom.d_s if sp is not None and sp.whole else 1.0
                for sp in self._leaf_specs(p)]

    def grad_norm(self, accs: List[List[torch.Tensor]]) -> torch.Tensor:
        """The global norm of the gradient sums: every stage's, the tied
        weight once, each leaf's squares over its :meth:`norm_factors`."""
        dev0 = self.devices[0]
        skip = {i1 for _, i1 in self.tied_pairs}
        sq = torch.zeros((), dtype=torch.float32, device=dev0)
        for p, acc in enumerate(accs):
            part = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            for i, (a, f) in enumerate(zip(acc, self.norm_factors(p))):
                if p == self.tied_stages[1] and i in skip:
                    continue
                sq_i = square_sum(a)
                part = part + (sq_i if f == 1.0 else sq_i / f)
            sq = sq + part.to(dev0)
        return sq.sqrt()

    def step(self, plan: ExecutionPlan, corpus: Dict[int, np.ndarray],
             *data, remat_policy: str = "stage-aware") -> StepResult:
        """One training step: the gradient sums (``data``: what the step
        takes beside the corpus; with pods, summed over them), then AdamW
        on every stage's (every rank's shards; every pod's) state with the
        global norm of all stages' gradients (the tied weight once);
        raises if the tied copies differ after it."""
        res, accs = self._step_grads(plan, corpus, *data,
                                     remat_policy=remat_policy)
        gnorm = self.grad_norm(accs)
        for pod in self.pods:
            pod._opt_state()
            for p, (sp, acc, st) in enumerate(zip(pod.params, accs,
                                                  pod.opt)):
                adamw_update(pod.adamw, sp, tree_unflatten(sp, acc), st,
                             gnorm=gnorm.to(pod.devices[p]))
            pod._check_tied()
        res.grad_norm = float(gnorm)
        return res

    def _check_tied(self) -> None:
        p0, p1 = self.tied_stages
        a, b = tree_leaves(self.params[p0]), tree_leaves(self.params[p1])
        for i0, i1 in self.tied_pairs:
            if not torch.equal(a[i0], b[i1].to(a[i0].device)):
                raise RuntimeError("the tied embedding's copies differ "
                                   "after the update")

    def _opt_state(self) -> List[Dict]:
        """Each stage's AdamW state (each rank's, over its shards), made
        (master from the live parameters, zero moments) the first time it
        is asked for."""
        if self.opt is None:
            self.opt = [init_opt_state(sp) for sp in self.params]
        return self.opt

    def _full(self, p: int, tree):
        """A stage's tree (parameters or AdamW state) whole: at ``d_s > 1``
        gathered from the ranks' shards (copies)."""
        if self.layouts is None:
            return tree
        return map_layout(lambda spec, *sh: unshard_leaf(sh, spec),
                          self.layouts[p], *tree)

    def state_tree(self) -> Dict:
        """The trainer's state as a checkpoint tree in the model's layout
        (``weights.state_from_stages``), which no pipeline depth, ``v``,
        ``d_s`` or ZeRO-3 mode shapes (at ``d_s > 1`` gathered from the
        ranks' shards)."""
        opts = self._opt_state()
        params = [self._full(p, t) for p, t in enumerate(self.params)]
        full = [dict({k: self._full(p, o[k]) for k in OPT_KEYS},
                     step=o["step"]) for p, o in enumerate(opts)]
        return state_from_stages(self.cfg, params, full)

    def load_state(self, state: Dict) -> None:
        """Overwrite every stage's (every rank's, every pod's) parameters,
        AdamW master, m, v and step with the checkpoint tree ``state``'s,
        re-staged for this trainer's ``d_p`` and ``v`` and cut into its
        ranks' shards (``weights.state_to_stages``; a tied embedding into
        both of its copies), in place."""
        g = self.geom
        params, opts = state_to_stages(self.cfg, state, g.d_p, g.v_stages)
        for pod in self.pods:
            for p, (sp, st, src_p, src_o) in enumerate(zip(
                    pod.params, pod._opt_state(), params, opts)):
                _copy_into(sp, self._cut(p, src_p))
                for k in OPT_KEYS:
                    _copy_into(st[k], self._cut(p, src_o[k]))
                st["step"] = src_o["step"]

    def _cut(self, p: int, tree):
        """A stage's whole tree as the ranks' trees of shards (itself at
        ``d_s = 1``)."""
        if self.layouts is None:
            return tree
        d_s = self.geom.d_s
        cut = map_layout(lambda spec, a: shard_leaf(a, spec, d_s),
                         self.layouts[p], tree)
        return [map_layout(lambda spec, sh, r=r: sh[r], self.layouts[p], cut)
                for r in range(d_s)]


def pod_plans(plan: ExecutionPlan, n_pods: int) -> List[ExecutionPlan]:
    """``plan`` split over ``n_pods`` pods: the reference splits its chunk
    list into ``n_pods`` equal runs (``launch/train.py``, a reshape of the
    chunk dim), which can cut a sequence whose carry then crosses pods
    (``ROADMAP.md`` §3); here each pod takes whole pipelines (a sequence's
    chunks share one), the cuts at the pipeline boundaries nearest to the
    reference's. A pod past the last pipeline runs none."""
    if n_pods == 1:
        return [plan]
    ends, n = [], 0
    for pipe in plan.pipelines:
        n += pipe.n_chunks
        ends.append(n)
    cuts = [0]
    for q in range(1, n_pods):
        want = q * n / n_pods
        best = min(range(cuts[-1], len(ends) + 1),       # (ties: later)
                   key=lambda i: (abs((ends[i - 1] if i else 0) - want), -i))
        cuts.append(best)
    cuts.append(len(plan.pipelines))
    return [dataclasses.replace(plan, pipelines=plan.pipelines[a:b])
            for a, b in zip(cuts, cuts[1:])]


class EncDecTrainer(PipelineTrainer):
    """The encoder-decoder's pipelined step (seamless-m4t-v2) on
    ``geometry.d_p >= 2`` stages (:mod:`.encdec_pipeline`): the leading
    ``encoder_stage_split`` stages run the encoder, the rest the decoder,
    stage ``p`` on card ``p mod len(cards)``; each stage's remat depth on a
    chunk is its row of the plan's stage-aware table (the encoder rows
    carry the ILP's encoder-role depths, ``core/checkpointing.
    stage_roles``), at most its layers. The tied embedding's two uses sit
    on the first decoder stage (the tokens' embedding) and on the last (the
    head): one leaf when they are one stage, else two copies whose
    gradients are summed as :class:`PipelineTrainer` sums them. AdamW as
    there. ``params``: ``EncDecLM``'s dict (any dtype); each step takes
    the corpus and its sequences' frames (``data/batching.
    sequence_frames``).

    At ``geometry.d_s > 1`` (the reference's SP point, allgather_kv over
    every rank) a stage is an ``encdec_pipeline.EncDecSPStage``: each rank
    owns its ZeRO-3 shards of the stage's layers, ``enc_norm`` and
    ``final_norm`` and its vocabulary block of each embedding copy (the
    tied pair summed rank by rank), with its float32 gradient sums and
    AdamW state, as :class:`PipelineTrainer` lays a decoder's out.
    ``n_pods`` replicas of the pipeline split a plan's pipelines
    (:func:`pod_plans`), their gradients summed plainly, as the
    reference's encoder-decoder cell sums them (``psum`` over its pod
    axis); it has no compressed pod sum, so ``compress_pod_grads``
    raises."""

    def __init__(self, cfg: ArchConfig, params: Dict, *,
                 geometry, cards: Sequence,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 cost_model=None, n_pods: int = 1,
                 compress_pod_grads: bool = False):
        from repro_torch.models.encdec import EncDecLM

        from .encdec_pipeline import EncDecSPStage, EncDecStage
        from .sharding import encdec_stage_layers
        g, s = geometry, cfg.spec
        if n_pods < 1:
            raise ValueError(f"n_pods must be >= 1, got {n_pods}")
        if compress_pod_grads:
            raise NotImplementedError(
                f"{cfg.name}: the reference's encoder-decoder cell sums its "
                f"pods' gradients with a plain psum (launch/dryrun.py); it "
                f"has no compressed pod sum for an encoder-decoder")
        self.cfg, self.geom, self.dtype, self.cm = cfg, g, compute_dtype, \
            cost_model
        self.model = EncDecLM(cfg)
        self.adamw = AdamWConfig()
        self.devices = stage_devices(g.d_p, cards, g.d_s)
        layout = encdec_stage_layers(s.n_encoder_layers, s.n_layers, g.d_p)
        self.blocks = [[ids] for _, ids in layout]
        stages = to_stages(cfg, params, g.d_p)
        self.n_params = sum(a.numel() for a in tree_leaves(params))
        first = [role for role, _ in layout].index("decoder")
        if g.d_s > 1:
            self.layouts = [shard_layout(sp, g.d_s) for sp in stages]
            self.params = [self._shard(sp, lay, dev) for sp, lay, dev in
                           zip(stages, self.layouts, self.devices)]
            self.stages = [EncDecSPStage(self.model, p, g, role, ids,
                                         self.params[p], self.devices[p],
                                         compute_dtype, p == first,
                                         self.layouts[p])
                           for p, (role, ids) in enumerate(layout)]
        else:
            self.layouts = None
            self.params = [
                tree_map(lambda a, d=dev: a.detach().to(
                    d, compute_dtype, copy=True).requires_grad_(True), sp)
                for dev, sp in zip(self.devices, stages)]
            self.stages = [EncDecStage(self.model, p, g, role, ids,
                                       self.params[p], self.devices[p],
                                       compute_dtype, p == first)
                           for p, (role, ids) in enumerate(layout)]
        del stages
        self._sp_models: Dict = {}
        self.compress, self.err = False, None
        self._tie(first)
        self.opt = None
        self._frames = None
        self.replicas = [
            EncDecTrainer(cfg, params, geometry=g, cards=cards,
                          compute_dtype=compute_dtype, cost_model=cost_model)
            for _ in range(n_pods - 1)]

    def sp_model(self, policy: str, d_s_eff: int):
        """The encoder-decoder of a stage's ranks: its self-attention
        through the allgather_kv policy over the lists of their blocks
        (made once)."""
        from repro_torch.models.encdec import EncDecLM

        from . import sp
        key = (policy, d_s_eff)
        if key not in self._sp_models:
            self._sp_models[key] = EncDecLM(
                self.cfg, attn_fn=sp.make_allgather_kv_policy())
        return self._sp_models[key]

    def rank_charges(self, cm) -> List[float]:
        """What the planner's count charges a rank of each stage for the
        parameters that stage holds, in ``cm.m_model_states``' bytes a
        parameter over ``d_s``: ``ModelSpec.param_count``'s terms placed
        where the layers live (an encoder layer's attention, MLP and norms;
        a decoder layer's with its cross-attention; the embedding on each
        stage holding a copy). ``m_model_states`` (the reference's) splits
        the whole count evenly over the stages and adds the embedding to
        stage 1: it charges the encoder stages the decoder's
        cross-attention and the first stage an embedding it does not hold
        (the encoder-decoder's first stage holds none)."""
        m = cm.model
        D, Dh, Hq, Hkv = m.d_model, m.head_dim, m.n_heads, m.n_kv_heads
        attn = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
        enc = attn + 3 * D * m.d_ff + 2 * D
        per = {"encoder": enc, "decoder": enc + attn}
        out = []
        for p, st in enumerate(self.stages):
            n = len(st.blocks[0]) * per[st.role]
            if "embed" in self._tree(p):
                n += m.vocab * D
            out.append(n * (2 + 4 + 4 + 4 + 4) / cm.cluster.d_s)
        return out

    def _run(self, plan: ExecutionPlan, corpus: Dict[int, np.ndarray],
             frames: Dict, *, remat_policy: str = "stage-aware",
             seed: Optional[float] = None):
        """:meth:`PipelineTrainer._run` with each sequence's frames
        ``frames[sid]`` (``[L, D]``, ``L`` its token count)."""
        if plan.k_split != 1:
            raise ValueError(f"the encoder-decoder runs packed chunks only: "
                             f"plan with fixed_k=1 (got K={plan.k_split})")
        from repro_torch.data.batching import frame_table
        self._frames = frame_table(frames)
        try:
            return super()._run(plan, corpus, remat_policy=remat_policy,
                                seed=seed)
        finally:
            self._frames = None

    def _materialize(self, plan, corpus):
        from repro_torch.data.batching import materialize_encdec_plan
        return materialize_encdec_plan(plan, corpus)

    def _stage_depths(self, plan, policy):
        table = _table(plan, self.geom.d_p, policy)
        return [[[min(int(d), len(b[0])) for d in row]]
                for row, b in zip(table, self.blocks)]

    def _inputs(self, batch, pipe, base, device, blocks=None):
        from .encdec_pipeline import stage_inputs
        cache: Dict[int, tuple] = {}
        table = self._frames

        def inputs(k: int):
            if k not in cache:
                cache[k] = stage_inputs(batch, base + k,
                                        pipe.chunks[k].tokens, table, device,
                                        blocks)
            return cache[k]
        return inputs

    def sequence_loss_and_grads(self, corpus: Dict[int, np.ndarray],
                                frames: Dict) -> StepResult:
        """The pipelined step's reference on the same kernels and the same
        parameters (every stage on one device): one unchunked
        ``EncDecLM.loss`` per sequence (its frames encoded whole, no remat),
        seeded with the same ``1 / n_valid``; gradients in
        ``from_stages``' structure (the tied embedding's one leaf holds
        both uses')."""
        dev = self.devices[0]
        if any(d != dev for d in self.devices):
            raise ValueError("sequence_loss_and_grads runs every stage's "
                             "parameters on one device")
        tree = from_stages(self.cfg, self.params)
        leaves = tree_leaves(tree)
        n_valid = sum(max(len(t) - 1, 0) for t in corpus.values())
        scale = torch.tensor(1.0 / max(n_valid, 1), dtype=torch.float32,
                             device=dev)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for p in leaves]
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for sid in sorted(corpus):
            toks, tgt, seg, pos = (torch.from_numpy(a).to(dev)
                                   for a in sequence_rows(corpus[sid]))
            fr = frames[sid].to(dev, self.dtype)
            fr = torch.cat([fr, fr.new_zeros((len(seg) - len(fr),
                                              fr.shape[1]))])
            loss, _ = self.model.loss(tree, fr, seg, pos, toks, tgt, seg,
                                      pos, compute_dtype=self.dtype)
            torch.autograd.backward([loss], [scale])
            with torch.no_grad():
                for a, p in zip(acc, leaves):
                    if p.grad is not None:
                        a.add_(p.grad)
                        p.grad = None
            total = total + loss.detach()
        return StepResult(loss=float(total) / max(n_valid, 1),
                          n_valid=n_valid, chunks=len(corpus),
                          remat_layers=0,
                          grads=tree_unflatten(tree, acc))
