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

* ``prefill(x, tokens, seg, pos, ctx, ctx_len)``: the pipelined prefill
  (the reference's ``pipeline_loss_fn`` in mode ``"prefill"``): one chunk
  of one sequence forward through the stage's layers behind the
  sequence's carry, no residuals kept and no loss; the carry it returns
  is the sequence's cache (``runtime/serve_step.DecodeStepBuilder``).

With a sequence-parallel axis (``d_s > 1``) a stage is an :class:`SPStage`:
its ``d_s`` ranks live on its card, each owning its ZeRO-3 shards of the
stage's parameters (``runtime/sharding``), which the forward gathers per
layer and chunk (``per_tick``, the default) or once a step (``per_step``);
each chunk's rows split into ``d_s_eff`` contiguous blocks,
one a rank of each of the ``d_s / d_s_eff`` replica groups
(``runtime/sp.subgroup_info``); the stream is the tuple of the ranks'
blocks (rank ``m`` holds block ``m // r`` of group ``m % r``); the embedding
and the loss are vocabulary-parallel over the full ``d_s`` (the loss on
group 0's blocks only); each ``F``, ``B`` and ``W`` is one forward and one
backward over every rank; the carries follow the reference's
``init_stage_ctx`` (ulysses: head-sharded, one per rank; allgather_kv and
MLA: one replicated per group; the SSM state and conv tail: one per
group).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.schedule import get_schedule
from repro_torch.core.sp import SP_POLICIES
from repro_torch.models.layers import deferred_weight_grads
from repro_torch.models.model import DecoderLM, LayerCtx, tree_leaves

from .sharding import (ZERO3_MODES, ShardedLeaf, Zero3, map_layout,
                       reduce_scatter_grads)

__all__ = ["PipelineGeometry", "PipelineStage", "SPStage", "carry_leaves",
           "carry_map"]


@dataclass(frozen=True)
class PipelineGeometry:
    """The run's pipeline: ``d_p`` stages, the schedule backend and its
    ``v`` virtual stages per stage (fixed for a run: they place the
    layers), whether the backward is split, and the sequence-parallel
    axis: ``d_s`` ranks a stage, the policy and effective degree
    ``d_s_eff`` (0: ``d_s``) that a plan without its own SP point runs
    (a plan's ``sp`` overrides them: :meth:`for_plan`), with the
    reference's checks; ``zero3_mode`` (:data:`~.sharding.ZERO3_MODES`,
    ``"per_tick"`` at ``d_s > 1`` when None, as the reference's
    ``make_geometry``) sets the ZeRO-3 gather cadence, which changes
    nothing at ``d_s = 1``. The double-buffered hand-off raises."""
    d_p: int
    schedule: str = "gpipe-1f1b"
    v_stages: int = 1
    split_bwd: bool = False
    d_s: int = 1
    policy: str = "none"
    d_s_eff: int = 0
    zero3_mode: Optional[str] = None
    overlap_handoff: bool = False

    def __post_init__(self) -> None:
        if self.d_s < 1:
            raise ValueError(f"d_s must be >= 1, got {self.d_s}")
        if self.d_s_eff == 0:
            object.__setattr__(self, "d_s_eff", self.d_s)
        if self.d_s_eff < 1 or self.d_s % self.d_s_eff:
            raise ValueError(
                f"d_s_eff={self.d_s_eff} must divide d_s={self.d_s}")
        if self.policy not in SP_POLICIES:
            raise ValueError(f"unknown SP policy {self.policy!r}")
        if self.policy == "ulysses" and self.d_s_eff == 1:
            raise ValueError("ulysses at d_s_eff=1 is meaningless; the "
                             "planner emits policy 'none' there")
        if self.d_s == 1 and self.policy != "none":
            raise ValueError(f"policy {self.policy!r} needs d_s > 1")
        if self.zero3_mode is None and self.d_s > 1:
            object.__setattr__(self, "zero3_mode", "per_tick")
        if self.zero3_mode is not None and \
                self.zero3_mode not in ZERO3_MODES:
            raise ValueError(f"zero3_mode {self.zero3_mode!r}: one of "
                             f"{ZERO3_MODES}")
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

    @property
    def sp_rep(self) -> int:
        """Chunk-compute replication factor of the SP sub-grouping."""
        return self.d_s // self.d_s_eff

    def for_plan(self, plan) -> "PipelineGeometry":
        """This geometry at ``plan.sp``'s policy and degree (itself when
        the plan has none)."""
        if plan.sp is None or (plan.sp.policy, plan.sp.d_s_eff) == (
                self.policy, self.d_s_eff):
            return self
        return dataclasses.replace(self, policy=plan.sp.policy,
                                   d_s_eff=plan.sp.d_s_eff)


def carry_map(fn: Callable, tree):
    """``fn`` over the tensors of a carry tree (lists, tuples and
    :class:`LayerCtx` nest; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, LayerCtx):
        return LayerCtx(*[carry_map(fn, f) for f in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(carry_map(fn, t) for t in tree)
    return fn(tree)


def carry_leaves(tree) -> List:
    """The tensors of a carry tree in a fixed order (Nones kept, so two
    trees of one shape pair up)."""
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in carry_leaves(t)]
    return [tree]


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

    @torch.no_grad()
    def prefill(self, x_in, tokens, seg, pos, ctx, ctx_len: int):
        """Prefill mode: one chunk of one sequence forward through this
        stage's layers (virtual stage 0) behind the sequence's carry
        ``ctx`` (``ctx_len`` live rows), keeping nothing for a backward
        and applying no loss: ``(hidden, new carry)``. The first stage
        embeds ``tokens``. With the sequence-parallel model
        (``runtime/sp.make_model``), ``tokens``, ``seg``, ``pos`` and the
        stream are lists over the ranks' row blocks and ``ctx`` is in the
        policy's layout (:meth:`DecoderLM.run_layers_sp`)."""
        ranks = isinstance(seg, (list, tuple))
        if self.p == 0:
            x_in = (self.model.embed_sp(self.params, tokens, len(seg),
                                        self.dtype) if ranks else
                    self.model.embed(self.params, tokens, self.dtype))
        layers = PipelineStage._layers(self, 0)
        if ranks:
            return self.model.run_layers_sp(layers, list(x_in), seg, pos,
                                            ctx=ctx, ctx_len=ctx_len)
        return self.model.run_layers(layers, x_in, seg, pos, ctx=ctx,
                                     ctx_len=ctx_len)

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
        """The ``W`` action: the weight products ``B(k, j)`` deferred. A
        ZeRO-3 leaf's products (one a rank that used it) are
        reduce-scattered into the ranks' sums once its last one is made
        (``sharding.reduce_scatter_grads``)."""
        store = self.wstore.pop((k, j))
        left: Dict[int, int] = {}
        for w, _ in store:
            left[id(w)] = left.get(id(w), 0) + 1
        held: Dict[int, List] = {}
        for w, product in store:
            tgt = self.acc_of[id(w)]
            if not isinstance(tgt, ShardedLeaf):
                tgt.add_(product())
                continue
            held.setdefault(id(w), []).append(product())
            left[id(w)] -= 1
            if not left[id(w)]:
                reduce_scatter_grads(held.pop(id(w)), tgt)


class SPStage(PipelineStage):
    """Stage ``p`` with ``geom.d_s`` sequence-parallel ranks on its card
    (see the module docstring): ``params`` the list of the ranks' trees
    (each its own shards, ``sharding.shard_leaf``) and ``layout`` their
    :class:`~.sharding.LeafShard` tree; :meth:`configure` sets the step's
    SP model (``runtime/sp.make_model`` at the plan's policy and degree);
    ``inputs(k)`` gives chunk ``k``'s ``(tokens, targets, seg, pos, rope
    tables)`` as lists over its ``d_s_eff`` row blocks."""

    def __init__(self, model: DecoderLM, p: int, geom: PipelineGeometry,
                 blocks: Sequence[Sequence[int]], params: List[Dict],
                 device, dtype: torch.dtype, layout: Dict):
        super().__init__(model, p, geom, blocks, params, device, dtype)
        self.layout = layout
        self.sharded = map_layout(lambda spec, *sh: ShardedLeaf(sh, spec),
                                  layout, *params)
        self.zero3 = Zero3(geom.zero3_mode, self._zero3_keys())

    def _zero3_keys(self) -> Dict:
        """What :class:`~.sharding.Zero3` gathers: each layer id's
        :class:`~.sharding.ShardedLeaf` tree, and ``"final_norm"``'s."""
        keys = dict(self.sharded["layers"])
        if "final_norm" in self.sharded:
            keys["final_norm"] = self.sharded["final_norm"]
        return keys

    def _rank_rows(self, key: str) -> List[torch.Tensor]:
        """The ranks' shards of a vocabulary table (never gathered)."""
        return [t[key] for t in self.params]

    def begin(self, chunks, inputs, depths, scale, acc) -> None:
        super().begin(chunks, inputs, depths, scale, acc)
        n = len(acc) // self.geom.d_s
        for i, leaf in enumerate(tree_leaves(self.sharded)):
            leaf.accs = [acc[r * n + i] for r in range(self.geom.d_s)]
            self.acc_of[id(leaf)] = leaf

    def finish(self) -> torch.Tensor:
        for leaf in tree_leaves(self.sharded):
            leaf.accs = None
        return super().finish()

    def _layers(self, j: int):
        return [(i, self.windows[i]) for i in self.blocks[j]]

    def _backward(self, k: int, j: int, rec: Dict, outs, grads) -> None:
        super()._backward(k, j, rec, outs, grads)
        with torch.no_grad():               # per_step: the resident copies'
            for full, leaf in self.zero3.resident_leaves():   # gradients
                if full.grad is not None:
                    reduce_scatter_grads([full.grad], leaf)
                    full.grad = None

    def configure(self, model: DecoderLM, policy: str, d_s_eff: int) -> None:
        self.model, self.policy, self.d_s_eff = model, policy, d_s_eff
        self.rep = self.geom.d_s // d_s_eff

    def _groups(self, flat: Sequence) -> List[List]:
        """Rank-ordered stream -> replica groups' block lists."""
        r = self.rep
        return [[flat[k * r + j] for k in range(self.d_s_eff)]
                for j in range(r)]

    def _flat(self, groups: Sequence[Sequence]) -> List:
        r = self.rep
        return [groups[m % r][m // r] for m in range(self.geom.d_s)]

    def _zero_layer(self) -> LayerCtx:
        """One layer's empty carry in the policy's layout."""
        s, dev, dt = self.model.cfg.spec, self.device, self.dtype
        k = v = h = tail = None
        if self.model.has_attn:
            if s.kv_lora_rank > 0:
                k = [torch.zeros((0, 1, s.kv_lora_rank + s.qk_rope_dim),
                                 dtype=dt, device=dev)]
            elif self.policy == "ulysses":
                shape = (0, s.n_kv_heads // self.d_s_eff, s.head_dim)
                k = [torch.zeros(shape, dtype=dt, device=dev)
                     for _ in range(self.d_s_eff)]
                v = [torch.zeros(shape, dtype=dt, device=dev)
                     for _ in range(self.d_s_eff)]
            else:
                shape = (0, s.n_kv_heads, s.head_dim)
                k = [torch.zeros(shape, dtype=dt, device=dev)]
                v = [torch.zeros(shape, dtype=dt, device=dev)]
        if self.model.has_ssm:
            h = [torch.zeros((s.inner, s.ssm_state), dtype=torch.float32,
                             device=dev)]
            tail = [torch.zeros((s.ssm_conv - 1, s.inner), dtype=dt,
                                device=dev)]
        return LayerCtx(k, v, h, tail)

    def _zero_carry(self, n_layers: int):
        one = self._zero_layer()
        return [LayerCtx(*[None if f is None else
                           [[t.clone() for t in f] for _ in range(n_layers)]
                           for f in one]) for _ in range(self.rep)]

    def forward(self, k: int, j: int, x_in) -> Optional[tuple]:
        s, S = j * self.geom.d_p + self.p, self.geom.n_vstages
        ch = self.chunks[k]
        tokens, targets, segs, poss, ropes = self.inputs(k)
        rec = {"prev": None, "ctx_in": None, "ctx_out": None, "x_in": None,
               "store": [] if self.geom.split_bwd else None}
        if s == 0:
            xs = self.model.embed_sp({"embed": self._rank_rows("embed")},
                                     tokens, self.geom.d_s, self.dtype)
            groups = [xs] * self.rep
        else:
            rec["x_in"] = tuple(x.detach().requires_grad_(True)
                                for x in x_in)
            groups = self._groups(rec["x_in"])
        carries = self.carries[j]
        if ch.context > 0:
            if ch.seq_id not in carries:
                raise RuntimeError(
                    f"chunk {k} continues sequence {ch.seq_id}, whose "
                    f"previous chunk is not in this pipeline")
            rec["prev"], out = carries.pop(ch.seq_id)
            ctx = rec["ctx_in"] = carry_map(
                lambda a: a.detach().requires_grad_(True), out)
        elif ch.has_dependents:
            ctx = self._zero_carry(len(self.blocks[j]))
        else:
            ctx = [None] * self.rep
        if ch.has_dependents and len(ch.slices) != 1:
            raise RuntimeError(f"chunk {k} has dependents but holds "
                               f"{len(ch.slices)} slices: the carry it "
                               f"hands on must be its sequence's alone")
        hidden, ctx_out = [], []
        with deferred_weight_grads(rec["store"]):
            for g, xs in enumerate(groups):
                h, c = self.model.run_layers_sp(
                    self._layers(j), xs, segs, poss, ctx=ctx[g],
                    ctx_len=ch.context, remat=self.depths[j][k],
                    ropes=ropes, zero3=self.zero3)
                hidden.append(h)
                ctx_out.append(c)
        if ch.has_dependents:
            rec["ctx_out"] = ctx_out
            carries[ch.seq_id] = (k, ctx_out)
        self.live[j][k] = rec
        if s < S - 1:
            rec["out"] = self._flat(hidden)
            return tuple(h.detach() for h in rec["out"])
        # the loss on replica group 0's blocks (every token once)
        head = "unembed" if "unembed" in self.params[0] else "embed"
        with self.zero3.keep_shards():
            loss, _ = self.model.chunk_loss_sp(
                {"final_norm": self.zero3.layer("final_norm"),
                 head: self._rank_rows(head)}, hidden[0], targets, segs,
                self.geom.d_s)
        rec["out"] = [loss]
        self.loss = self.loss + loss.detach()
        return None

    def backward(self, k: int, j: int, g) -> Optional[tuple]:
        rec = self.live[j].pop(k)
        outs, grads = [], []
        for t, gt in zip(rec["out"], [self.scale] if g is None else g):
            if gt is not None:          # (a replica's stream: no gradient)
                outs.append(t)
                grads.append(gt)
        if rec["ctx_out"] is not None:
            if k not in self.dkv[j]:
                raise RuntimeError(f"backward of chunk {k} before the "
                                   f"backward of the chunk that continues it")
            for t, gt in zip(carry_leaves(rec["ctx_out"]),
                             carry_leaves(self.dkv[j].pop(k))):
                if gt is not None:
                    outs.append(t)
                    grads.append(gt)
        self._backward(k, j, rec, outs, grads)
        if rec["ctx_in"] is not None:
            self.dkv[j][rec["prev"]] = carry_map(lambda a: a.grad,
                                                 rec["ctx_in"])
        if rec["x_in"] is None:
            return None
        return tuple(x.grad for x in rec["x_in"])
