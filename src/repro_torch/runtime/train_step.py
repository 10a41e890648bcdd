"""The chunked training step on one card (``d_p = d_s = 1``).

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
  KV carry that the sequence's previous chunk wrote. The carry is cut out
  of the autograd graph between the two chunks (a fresh leaf), so the
  later chunk's backward, which runs first, leaves the carry's gradient —
  the paper's dKV term — on that leaf, and the earlier chunk's backward
  starts from ``torch.autograd.backward([loss_k, carry_k], [scale, dKV])``;
* chunk ``k`` recomputes the leading ``plan.ckpt_table()[0][k]`` layers in
  its backward (stage-aware remat, Eq. 9-11);
* every chunk's loss is seeded with ``1 / max(n_valid, 1)`` — the step's
  valid-token count, known from the chunk buffers before any backward —
  so the summed gradients are those of the mean loss; then AdamW.

Chunks are cut to their used tokens (rounded up to 64 rows) instead of the
plan's bucket capacity: on one card nothing is compiled per shape, and
padding rows carry no loss and attend to nothing.
"""

from __future__ import annotations

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
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state

__all__ = ["ChunkedTrainer", "StepResult", "remat_depths", "chunk_arrays",
           "ROW_MULTIPLE"]

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


@dataclass
class StepResult:
    loss: float                 # mean loss over the step's valid tokens
    n_valid: int
    chunks: int
    remat_layers: int           # sum of the chunks' remat depths
    grads: Optional[Dict] = None        # float32, mean-loss gradients
    grad_norm: Optional[float] = None   # set by ChunkedTrainer.step


def _rows(n: int) -> int:
    return -(-max(n, 1) // ROW_MULTIPLE) * ROW_MULTIPLE


def chunk_arrays(batch: ChunkBatch, k: int, tokens: int):
    """What the step feeds the model for chunk ``k`` of ``tokens`` used
    tokens: its rows cut to a multiple of ROW_MULTIPLE (padded past the
    buffer's width with seg = -1, target = -1) as int64 tokens and
    targets, int32 seg and pos. Padding rows read token 0 at position 0,
    as the reference's step feeds them."""
    n = _rows(tokens)

    def row(a, fill):
        r = a[k, :n]
        return np.pad(r, (0, n - len(r)), constant_values=fill)
    seg = row(batch.seg, -1)
    live = seg >= 0
    return (np.where(live, row(batch.tokens, 0), 0).astype(np.int64),
            row(batch.targets, -1).astype(np.int64),
            seg, np.where(live, row(batch.pos, 0), 0).astype(np.int32))


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
        parameter's gradient is summed over chunks in float32)."""
        torch.autograd.backward(outs, grads)
        with torch.no_grad():
            for a, p in zip(acc, tree_leaves(self.params)):
                if p.grad is not None:
                    a.add_(p.grad)
                    p.grad = None

    def _zero_carry(self, cap: int) -> LayerCtx:
        s = self.cfg.spec
        shape = (cap, s.n_kv_heads, s.head_dim)
        mk = lambda: torch.zeros(shape, dtype=self.dtype,  # noqa: E731
                                 device=self.device)
        return LayerCtx([mk() for _ in range(s.n_layers)],
                        [mk() for _ in range(s.n_layers)])

    def _run_pipeline(self, pipe: PipelinePlan, batch: ChunkBatch, base: int,
                      remat: Sequence[int], scale: torch.Tensor,
                      acc: List[torch.Tensor]) -> torch.Tensor:
        """Forward and backward of one pipeline's chunks (global indices
        ``base + k``); adds the parameter gradients into ``acc`` and returns
        the pipeline's summed loss."""
        model, params = self.model, self.params
        chunks = pipe.chunks
        rows = [_rows(c.tokens) for c in chunks]
        # carry capacity: every chunk that reads or writes the carry
        # appends its rows at its context length, and they must fit
        cap = _rows(max([c.context + r for c, r in zip(chunks, rows)
                         if c.has_dependents or c.context > 0] or [0]))
        order = (pipe.schedule or build_schedule(
            len(chunks), 1, pipe.n_split, pipe.f2b))[0]
        carries: Dict[int, Tuple[int, LayerCtx]] = {}   # seq -> (k, carry)
        live: Dict[int, Dict] = {}                      # k -> residuals
        dkv: Dict[int, LayerCtx] = {}                   # k -> carry grad
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
                    ctx = LayerCtx(
                        [a.detach().requires_grad_(True) for a in out.k],
                        [a.detach().requires_grad_(True) for a in out.v])
                    rec["ctx_in"] = ctx
                elif ch.has_dependents:
                    ctx = self._zero_carry(cap)
                else:
                    ctx = None
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
                    for t, gt in zip(rec["ctx_out"].k + rec["ctx_out"].v,
                                     g.k + g.v):
                        if gt is not None:
                            outs.append(t)
                            grads.append(gt)
                self._backward(outs, grads, acc)
                if rec["ctx_in"] is not None:
                    dkv[rec["prev"]] = LayerCtx(
                        [a.grad for a in rec["ctx_in"].k],
                        [a.grad for a in rec["ctx_in"].v])
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
            toks = np.asarray(corpus[sid], np.int64)
            n, rows = len(toks), _rows(len(toks))
            tgt = np.full(rows, -1, np.int64)
            tgt[:n - 1] = toks[1:]
            seg = np.full(rows, -1, np.int32)
            seg[:n] = 0
            pos = np.zeros(rows, np.int32)
            pos[:n] = np.arange(n)
            dev = self.device
            hidden, _ = self.model.forward_chunk(
                self.params,
                torch.from_numpy(np.pad(toks, (0, rows - n))).to(dev),
                torch.from_numpy(seg).to(dev), torch.from_numpy(pos).to(dev),
                compute_dtype=self.dtype)
            loss, _ = self.model.chunk_loss(
                self.params, hidden, torch.from_numpy(tgt).to(dev),
                torch.from_numpy(seg).to(dev))
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
