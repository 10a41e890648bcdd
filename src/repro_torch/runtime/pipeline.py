"""The stage body of the decoder-only pipeline.

Counterpart of the JAX package's ``runtime/pipeline.py``
(``PipelineGeometry``, ``init_stage_ctx``, ``pipeline_loss_fn``). A
:class:`PipelineStage` holds one stage's parameters, on its device, and
runs the actions :class:`~repro_torch.runtime.executor.PipelineExecutor`
hands it:

* ``forward(k, j, x)``: the first virtual stage embeds the chunk's tokens;
  every virtual stage runs its own layers (``runtime/sharding.
  stage_blocks``; padded slots skipped) with their own context carry (KV
  for attention layers, ``(h, conv_tail)`` for mamba layers: the model's
  state-neutral pad rows included), the leading ``remat`` of them under
  checkpoint; the last virtual stage applies the final norm and the loss
  (``DecoderLM.chunk_loss``: kernels B, C1, C2);
* ``backward(k, j, g)``: from the stream's gradient (the loss's seed
  ``1 / n_valid`` at the last virtual stage) and, when a later chunk of the
  sequence continued this one, the carry's gradient that chunk's backward
  left on this stage (the paper's dKV term); returns the stream's
  gradient, and leaves the carry's for the chunk before;
* under the split backward, ``forward`` and ``backward`` run inside
  ``models.layers.deferred_weight_grads``: every linear layer (and the
  mixer's ``dt_proj``) keeps its ``(input, output gradient)`` pair, and
  ``weight_grads(k, j)`` (the ``W`` action) computes those products. The
  norms, the mixer's ``A``, ``D``, conv and ``dt`` bias, the embedding and
  the head's C2 take their gradients in ``B``.

The carries stay on their stage; only streams move. The parameters'
gradients are summed in float32 per stage, in the order of the stage's
backwards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.schedule import get_schedule
from repro_torch.models.layers import deferred_weight_grads
from repro_torch.models.model import DecoderLM, LayerCtx, tree_leaves

__all__ = ["PipelineGeometry", "PipelineStage"]


@dataclass(frozen=True)
class PipelineGeometry:
    """The run's pipeline: ``d_p`` stages, the schedule backend and its
    ``v`` virtual stages per stage (fixed for a run: they place the
    layers), and whether the backward is split. The reference's fields
    for the sequence-parallel axis and ZeRO-3 stay at their ``d_s = 1``
    values; others raise."""
    d_p: int
    schedule: str = "gpipe-1f1b"
    v_stages: int = 1
    split_bwd: bool = False
    d_s: int = 1
    policy: str = "none"
    zero3_mode: Optional[str] = None
    overlap_handoff: bool = False

    def __post_init__(self) -> None:
        if self.d_s != 1 or self.policy != "none":
            raise NotImplementedError(
                "the sequence-parallel axis (d_s > 1, an SP policy) is not "
                "ported: ROADMAP.md queue 1, item 4")
        if self.zero3_mode is not None:
            raise NotImplementedError(
                "ZeRO-3 gathers are not ported: ROADMAP.md queue 1, item 3")
        if self.overlap_handoff:
            raise NotImplementedError(
                "the double-buffered hand-off is not ported: ROADMAP.md "
                "queue 1, item 2")
        if self.d_p < 1:
            raise ValueError(f"d_p must be >= 1, got {self.d_p}")
        get_schedule(self.schedule, self.v_stages)      # validates

    @property
    def n_vstages(self) -> int:
        return self.d_p * self.v_stages


class PipelineStage:
    """Stage ``p``: ``params`` (``{"layers": {layer id: params}}`` and, as
    ``weights.to_stages`` lays them out, ``embed``, ``final_norm``,
    ``unembed``) on ``device``; ``blocks[j]`` the layer ids of its virtual
    stage ``j``."""

    def __init__(self, model: DecoderLM, p: int, geom: PipelineGeometry,
                 blocks: Sequence[Sequence[int]], params: Dict, device,
                 dtype: torch.dtype):
        self.model, self.p, self.geom = model, p, geom
        self.blocks = [list(b) for b in blocks]
        self.params, self.device, self.dtype = params, device, dtype
        self.leaves = tree_leaves(params)
        self.windows = model.cfg.layer_windows()

    # ------------------------------------------------------------------
    def begin(self, chunks, inputs: Callable[[int], tuple],
              depths: Sequence[Sequence[int]], scale: torch.Tensor,
              acc: List[torch.Tensor]) -> None:
        """Set up one pipeline: its ``chunks``; ``inputs(k)`` the chunk's
        ``(tokens, targets, seg, pos, rope tables)`` on this device;
        ``depths[j][k]`` the remat depth of virtual stage ``j`` on chunk
        ``k``; the loss's seed ``scale``; ``acc`` the float32 sums of the
        parameters' gradients (in ``tree_leaves`` order)."""
        v = self.geom.v_stages
        self.chunks, self.inputs = chunks, inputs
        self.depths, self.scale, self.acc = depths, scale, acc
        self.acc_of = {id(p): a for p, a in zip(self.leaves, acc)}
        self.carries = [{} for _ in range(v)]   # seq -> (k, carry out)
        self.live = [{} for _ in range(v)]      # k -> residuals
        self.dkv = [{} for _ in range(v)]       # k -> the carry's gradient
        self.wstore: Dict = {}                  # (k, j) -> deferred products
        self.loss = torch.zeros((), dtype=torch.float32, device=self.device)

    def finish(self) -> torch.Tensor:
        """The pipeline's summed loss (0 off the last stage)."""
        left = [(k, j) for j, lv in enumerate(self.live) for k in lv]
        if left or any(self.dkv) or self.wstore:
            raise RuntimeError(f"stage {self.p}: chunks left without a "
                               f"backward {left} or weight gradients "
                               f"{sorted(self.wstore)}")
        self.inputs = self.acc = self.acc_of = None
        return self.loss

    def carry_grad_ready(self, k: int, j: int) -> bool:
        rec = self.live[j].get(k)
        return rec is None or rec["ctx_out"] is None or k in self.dkv[j]

    def _layers(self, j: int):
        lp = self.params["layers"]
        return [(lp[i], self.windows[i]) for i in self.blocks[j]]

    def _zero_carry(self, n_layers: int) -> LayerCtx:
        ctx = self.model.init_ctx(0, self.dtype, n_layers,
                                  device=self.device)
        return LayerCtx(*[None if f is None else list(f.unbind(0))
                          for f in ctx])

    # ------------------------------------------------------------------
    def forward(self, k: int, j: int, x_in: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
        s, S = j * self.geom.d_p + self.p, self.geom.n_vstages
        ch = self.chunks[k]
        tokens, targets, seg, pos, rope = self.inputs(k)
        rec = {"prev": None, "ctx_in": None, "ctx_out": None, "x_in": None,
               "store": [] if self.geom.split_bwd else None}
        if s == 0:
            x = self.model.embed(self.params, tokens, self.dtype)
        else:
            x = rec["x_in"] = x_in.detach().requires_grad_(True)
        carries = self.carries[j]
        if ch.context > 0:
            if ch.seq_id not in carries:
                raise RuntimeError(
                    f"chunk {k} continues sequence {ch.seq_id}, whose "
                    f"previous chunk is not in this pipeline")
            rec["prev"], out = carries.pop(ch.seq_id)
            ctx = rec["ctx_in"] = LayerCtx(*[
                None if f is None else
                [a.detach().requires_grad_(True) for a in f] for f in out])
        elif ch.has_dependents:
            ctx = self._zero_carry(len(self.blocks[j]))
        else:
            ctx = None
        if ch.has_dependents and len(ch.slices) != 1:
            raise RuntimeError(f"chunk {k} has dependents but holds "
                               f"{len(ch.slices)} slices: the carry it "
                               f"hands on must be its sequence's alone")
        with deferred_weight_grads(rec["store"]):
            hidden, ctx_out = self.model.run_layers(
                self._layers(j), x, seg, pos, ctx=ctx, ctx_len=ch.context,
                remat=self.depths[j][k], rope=rope)
        if ch.has_dependents:
            rec["ctx_out"] = ctx_out
            carries[ch.seq_id] = (k, ctx_out)
        self.live[j][k] = rec
        if s < S - 1:
            rec["out"] = hidden
            return hidden.detach()
        loss, _ = self.model.chunk_loss(self.params, hidden, targets, seg)
        rec["out"] = loss
        self.loss = self.loss + loss.detach()
        return None

    def backward(self, k: int, j: int, g: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
        rec = self.live[j].pop(k)
        outs = [rec["out"]]
        grads = [self.scale if g is None else g]
        if rec["ctx_out"] is not None:
            if k not in self.dkv[j]:
                raise RuntimeError(f"backward of chunk {k} before the "
                                   f"backward of the chunk that continues it")
            for f, gf in zip(rec["ctx_out"], self.dkv[j].pop(k)):
                for t, gt in zip(f or (), gf or ()):
                    if gt is not None:
                        outs.append(t)
                        grads.append(gt)
        self._backward(k, j, rec, outs, grads)
        if rec["ctx_in"] is not None:
            self.dkv[j][rec["prev"]] = LayerCtx(*[
                None if f is None else [a.grad for a in f]
                for f in rec["ctx_in"]])
        return None if rec["x_in"] is None else rec["x_in"].grad

    def _backward(self, k: int, j: int, rec: Dict, outs, grads) -> None:
        """Backward from ``outs`` seeded with ``grads`` (the chunk's weight
        products deferred to its store under the split); the parameters'
        gradients added into the float32 sums."""
        with deferred_weight_grads(rec["store"]):
            torch.autograd.backward(outs, grads)
        with torch.no_grad():
            for a, p in zip(self.acc, self.leaves):
                if p.grad is not None:
                    a.add_(p.grad)
                    p.grad = None
        if rec["store"] is not None:
            self.wstore[(k, j)] = rec["store"]

    @torch.no_grad()
    def weight_grads(self, k: int, j: int) -> None:
        """The ``W`` action: the weight products ``B(k, j)`` deferred."""
        for w, product in self.wstore.pop((k, j)):
            self.acc_of[id(w)].add_(product())
