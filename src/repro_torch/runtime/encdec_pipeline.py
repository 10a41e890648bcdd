"""The stage body of the encoder-decoder pipeline (seamless-m4t-v2).

Counterpart of the JAX package's ``runtime/encdec_pipeline.py``
(``EncDecGeometry``, ``encdec_pipeline_loss_fn``'s ``tick``). The stages
split between the encoder and the decoder
(``runtime/sharding.encdec_stage_layers``), and a chunk's stream is the
pair ``(h_enc, h_dec)``:

* encoder stages advance ``h_enc`` over the chunk's frames (the first
  stage starts from the frontend stub's frames), non-causal, with no
  context carry; ``h_dec`` does not exist yet (None);
* the first decoder stage norms the finished ``h_enc`` once with
  ``enc_norm``: that is the memory; it embeds the chunk's tokens into
  ``h_dec``;
* decoder stages run their layers (causal self-attention, cross-attention
  to the memory, the MLP) over ``h_dec`` and hand the memory on unchanged;
* the last stage applies ``final_norm`` and the loss against the tied
  embedding (kernels B, C1, C2).

In the backward each decoder stage adds its layers' cross-attention
gradients into the memory's and hands the sum back with ``h_dec``'s; the
first decoder stage takes it through ``enc_norm`` to the last encoder
stage. Under the split backward a stage's linear layers (the
cross-attention's key and value projections included) leave their weight
products to its ``W`` action, as the decoder pipeline's do.

The encoder is pack-only (splitting a bidirectional encoder's input would
change the math): the plan is made with ``fixed_k=1``, as the reference's
train step makes it, and a chunk that continues a sequence raises. So no
stage carries context. ``v_stages`` is pinned to 1 (the reference's
grouped encoder + decoder stacking has no interleaved placement): the
three single-virtual-stage backends run, gpipe-1f1b, interleaved-1f1b at
``v = 1`` and zero-bubble-h1.

With a sequence-parallel axis (``d_s > 1``, the reference's
``encdec_pipeline_loss_fn`` over its model axis) a stage is an
:class:`EncDecSPStage`: its ``d_s`` ranks live on its card, each owning
its ZeRO-3 shards of the stage's layers, ``enc_norm`` and ``final_norm``
(``runtime/sharding``; ``per_tick`` or ``per_step`` gathers) and its
vocabulary block of the tied embedding; a chunk's frames and tokens split
into ``d_s`` row blocks, one a rank (:func:`stage_inputs`), and the
streams are the ranks' blocks: ``(memory_0 .. memory_{d-1}, h_dec_0 ..
h_dec_{d-1})``. The SP point is the reference's pin
(:func:`encdec_sp_pin`): allgather_kv over the whole ``d_s``, no replica
groups. The encoder and the decoder's self-attention run the allgather_kv
policy; a decoder stage gathers the ranks' memory blocks once a chunk
for its cross-attention (``sp.gather_memory``; the reference gathers each
layer's keys and values) and, in the backward, hands each rank's memory
gradient back summed over every rank's use; the embedding and the loss are
vocabulary-parallel. Under the split backward the ``W`` action
reduce-scatters each weight's products (the cross-attention's key and
value projections included) into the ranks' sums.

Serving takes another layout (:func:`prepare_encdec_decode_params`, the
reference's): the decoder layers over all ``d_p`` stages, the encoder kept
on the first for the prefill. An :class:`EncDecDecodeStage` encodes a
request's frames into its memory (the decode state's) and runs the prefill
of its prompt through its decoder layers behind the self-attention's KV
carry, which becomes the sequence's cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.schedule import get_schedule
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.layers import deferred_weight_grads
from repro_torch.models.model import LayerCtx

from .pipeline import PipelineGeometry, PipelineStage, SPStage
from .sharding import ZERO3_MODES

__all__ = ["EncDecGeometry", "EncDecStage", "EncDecSPStage",
           "EncDecDecodeStage", "encdec_sp_pin",
           "prepare_encdec_decode_params"]


def encdec_sp_pin(policy: str, degree: int, d_s: int) -> str:
    """The SP policy of an encoder-decoder on ``d_s`` ranks, from a
    requested ``policy`` (``"auto"`` or a name) and ``degree`` (0: any):
    the reference's pin, allgather_kv over the whole ``d_s``
    (``EncDecGeometry.policy`` in its ``runtime/encdec_pipeline.py``, and
    ``sp_degree=d_s`` in ``launch/dryrun.py``'s cell), or ``"none"`` at
    ``d_s = 1``; any other point raises."""
    want = "none" if d_s == 1 else "allgather_kv"
    if policy not in ("auto", want) or degree not in (0, d_s):
        raise ValueError(
            f"the encoder-decoder runs the reference's SP point: policy "
            f"{want!r} over the whole d_s={d_s} (its EncDecGeometry.policy "
            f"and the dry-run cell's sp_degree=d_s); got policy {policy!r} "
            f"at degree {degree}")
    return want


@dataclass(frozen=True)
class EncDecGeometry:
    """The run's encoder-decoder pipeline: ``d_p >= 2`` stages, the
    schedule backend, whether the backward is split; ``v_stages`` must be
    1. ``d_s`` sequence-parallel ranks a stage at the reference's SP
    point (:func:`encdec_sp_pin`: ``policy`` allgather_kv and ``d_s_eff =
    d_s`` at ``d_s > 1``; another request raises); ``zero3_mode`` as
    :class:`~.pipeline.PipelineGeometry`'s (``"per_tick"`` at ``d_s > 1``
    when None)."""
    d_p: int
    schedule: str = "gpipe-1f1b"
    v_stages: int = 1
    split_bwd: bool = False
    d_s: int = 1
    policy: str = "auto"
    d_s_eff: int = 0
    zero3_mode: Optional[str] = None

    def __post_init__(self) -> None:
        if self.v_stages != 1:
            raise ValueError(
                "encoder-decoder pipelines support v_stages=1 only (the "
                "grouped encoder + decoder layer stacking has no "
                f"interleaved placement); got {self.v_stages}")
        if self.d_p < 2:
            raise ValueError(
                f"an encoder-decoder pipeline needs d_p >= 2 (an encoder "
                f"and a decoder stage: core.checkpointing."
                f"encoder_stage_split); got {self.d_p}")
        if self.d_s < 1:
            raise ValueError(f"d_s must be >= 1, got {self.d_s}")
        object.__setattr__(self, "policy", encdec_sp_pin(
            self.policy, self.d_s_eff, self.d_s))
        object.__setattr__(self, "d_s_eff", self.d_s)
        if self.zero3_mode is None and self.d_s > 1:
            object.__setattr__(self, "zero3_mode", "per_tick")
        if self.zero3_mode is not None and \
                self.zero3_mode not in ZERO3_MODES:
            raise ValueError(f"zero3_mode {self.zero3_mode!r}: one of "
                             f"{ZERO3_MODES}")
        get_schedule(self.schedule, self.v_stages)      # validates

    @property
    def n_vstages(self) -> int:
        return self.d_p

    def for_plan(self, plan) -> "EncDecGeometry":
        """Itself: a plan's SP point must be the pinned one."""
        if plan.sp is not None:
            encdec_sp_pin(plan.sp.policy, plan.sp.d_s_eff, self.d_s)
        return self


def _leaf(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().requires_grad_(True)


class EncDecStage(PipelineStage):
    """Stage ``p`` of ``role`` (``"encoder"`` or ``"decoder"``) running the
    layers ``ids`` of its stack; ``params`` as ``weights.to_stages`` lays
    them out (``enc_layers`` or ``dec_layers``: id -> parameters, and
    ``embed``, ``enc_norm``, ``final_norm`` where they live);
    ``first_dec``: the first decoder stage (it norms the memory and embeds
    the tokens). ``inputs(k)`` (:meth:`begin`) gives chunk ``k``'s
    ``(frames, seg_enc, pos_enc, tokens, targets, seg, pos)`` on this
    device."""

    def __init__(self, model: EncDecLM, p: int, geom: EncDecGeometry,
                 role: str, ids: Sequence[int], params: Dict, device,
                 dtype: torch.dtype, first_dec: bool):
        super().__init__(model, p, geom, [ids], params, device, dtype)
        self.role, self.first_dec = role, first_dec
        key = "enc_layers" if role == "encoder" else "dec_layers"
        self.layer_params = [params[key][i] for i in ids]

    def carry_grad_ready(self, k: int, j: int) -> bool:
        return True

    # ------------------------------------------------------------------
    def forward(self, k: int, j: int, x_in: Optional[Tuple]
                ) -> Optional[Tuple]:
        if self.chunks[k].context > 0:
            raise RuntimeError(
                f"chunk {k} continues a sequence: the encoder-decoder runs "
                f"packed chunks only (plan with fixed_k=1)")
        frames, seg_e, pos_e, tokens, targets, seg, pos = self.inputs(k)
        last = self.p == self.geom.d_p - 1
        rec = {"x_in": None, "store": [] if self.geom.split_bwd else None}
        if x_in is not None:
            rec["x_in"] = tuple(_leaf(t) for t in x_in)
        remat, model = self.depths[0][k], self.model
        with deferred_weight_grads(rec["store"]):
            if self.role == "encoder":
                h = frames if x_in is None else rec["x_in"][0]
                out = (model.run_enc_layers(self.layer_params, h, seg_e,
                                            pos_e, remat=remat), None)
            else:
                if self.first_dec:
                    memory = model.enc_norm(self.params, rec["x_in"][0])
                    h = model.embed(self.params, tokens, self.dtype)
                else:
                    memory, h = rec["x_in"]
                out = (memory, model.run_dec_layers(
                    self.layer_params, h, seg, pos, memory, seg_e,
                    remat=remat))
        self.live[0][k] = rec
        if not last:
            rec["out"] = out
            return tuple(None if t is None else t.detach() for t in out)
        loss, _ = model.chunk_loss(self.params, out[1], targets, seg)
        rec["out"] = (loss,)
        self.loss = self.loss + loss.detach()
        return None

    def backward(self, k: int, j: int, g: Optional[Tuple]
                 ) -> Optional[Tuple]:
        rec = self.live[0].pop(k)
        pairs = zip(rec["out"], (self.scale,) if g is None else g)
        outs, grads = zip(*[(t, gt) for t, gt in pairs
                            if t is not None and gt is not None])
        self._backward(k, j, rec, list(outs), list(grads))
        if rec["x_in"] is None:
            return None
        return tuple(None if t is None else t.grad for t in rec["x_in"])


class EncDecSPStage(SPStage):
    """:class:`EncDecStage` with ``geom.d_s`` sequence-parallel ranks on its
    card (see the module docstring): ``params`` the list of the ranks'
    trees (each its own shards) and ``layout`` their
    :class:`~.sharding.LeafShard` tree; ``inputs(k)`` gives chunk ``k``'s
    ``(frames, seg_enc, pos_enc, tokens, targets, seg, pos)``, each a list
    of the ranks' row blocks; the stream is the flat tuple of the ranks'
    memory (or ``h_enc``) blocks, then their ``h_dec`` blocks (None on an
    encoder stage)."""

    def __init__(self, model: EncDecLM, p: int, geom: EncDecGeometry,
                 role: str, ids: Sequence[int], params: List[Dict], device,
                 dtype: torch.dtype, first_dec: bool, layout: Dict):
        self.role, self.first_dec, self.ids = role, first_dec, list(ids)
        self.key = "enc_layers" if role == "encoder" else "dec_layers"
        super().__init__(model, p, geom, [ids], params, device, dtype,
                         layout)

    def _zero3_keys(self) -> Dict:
        keys = dict(self.sharded[self.key])
        for name in ("enc_norm", "final_norm"):
            if name in self.sharded:
                keys[name] = self.sharded[name]
        return keys

    def carry_grad_ready(self, k: int, j: int) -> bool:
        return True

    def forward(self, k: int, j: int, x_in: Optional[Tuple]
                ) -> Optional[Tuple]:
        if self.chunks[k].context > 0:
            raise RuntimeError(
                f"chunk {k} continues a sequence: the encoder-decoder runs "
                f"packed chunks only (plan with fixed_k=1)")
        frames, seg_e, pos_e, tokens, targets, seg, pos = self.inputs(k)
        d, last = self.geom.d_s, self.p == self.geom.d_p - 1
        rec = {"x_in": None, "store": [] if self.geom.split_bwd else None}
        if x_in is not None:
            rec["x_in"] = tuple(_leaf(t) for t in x_in)
        remat, model, z = self.depths[0][k], self.model, self.zero3
        with deferred_weight_grads(rec["store"]):
            if self.role == "encoder":
                hs = list(frames) if x_in is None else list(rec["x_in"][:d])
                out = (*model.run_enc_layers_sp(self.ids, hs, seg_e, pos_e,
                                                remat=remat, zero3=z),
                       *[None] * d)
            else:
                if self.first_dec:
                    with z.keep_shards():
                        memory = model.enc_norm_sp(
                            {"enc_norm": z.layer("enc_norm")},
                            list(rec["x_in"][:d]))
                    hs = model.embed_sp({"embed": self._rank_rows("embed")},
                                        tokens, d, self.dtype)
                else:
                    memory = list(rec["x_in"][:d])
                    hs = list(rec["x_in"][d:])
                out = (*memory, *model.run_dec_layers_sp(
                    self.ids, hs, seg, pos, memory, seg_e, remat=remat,
                    zero3=z))
        self.live[0][k] = rec
        if not last:
            rec["out"] = out
            return tuple(None if t is None else t.detach() for t in out)
        with z.keep_shards():
            loss, _ = model.chunk_loss_sp(
                {"final_norm": z.layer("final_norm"),
                 "embed": self._rank_rows("embed")}, list(out[d:]), targets,
                seg, d)
        rec["out"] = (loss,)
        self.loss = self.loss + loss.detach()
        return None

    backward = EncDecStage.backward


def prepare_encdec_decode_params(cfg, params: Dict, d_p: int) -> list:
    """The decode layout (the reference's ``prepare_encdec_decode_params``):
    ``weights.to_stages(..., decode=True)``: stage ``p`` holds its decoder
    layers as ``layers``; the first also ``embed``, the encoder's
    ``enc_layers`` and ``enc_norm``; the last ``final_norm`` and the tied
    ``embed``."""
    from repro_torch.weights import to_stages
    return to_stages(cfg, params, d_p, decode=True)


class EncDecDecodeStage(PipelineStage):
    """Stage ``p`` of the decode layout (:func:`prepare_encdec_decode_params`)
    on ``device``: :meth:`encode` (the first stage) and :meth:`prefill`."""

    def __init__(self, model: EncDecLM, p: int, d_p: int,
                 blocks: Sequence[Sequence[int]], params: Dict, device,
                 dtype: torch.dtype):
        super().__init__(model, p, PipelineGeometry(d_p), blocks, params,
                         device, dtype)

    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """One request's frames ``[S, D]`` -> its memory ``[S, D]``: the
        encoder and ``enc_norm`` (``EncDecLM.encode``)."""
        n = frames.shape[0]
        seg = torch.zeros(n, dtype=torch.int32, device=self.device)
        pos = torch.arange(n, dtype=torch.int32, device=self.device)
        return self.model.encode(self.params, frames.to(self.device,
                                                        self.dtype), seg, pos)

    @torch.no_grad()
    def prefill(self, x_in, tokens, seg, pos, ctx, ctx_len: int, *,
                memory=None, seg_mem=None):
        """:meth:`PipelineStage.prefill` of the decoder layers: causal
        self-attention behind the carry ``ctx`` (``LayerCtx`` of lists of
        ``[C_cap, Hkv, Dh]``), cross-attention to ``memory`` (``seg_mem``
        its frames' segments), the MLP (``EncDecLM.dec_layer_carry``)."""
        x = self.model.embed(self.params, tokens, self.dtype) \
            if self.p == 0 else x_in
        nk, nv = [], []
        for l, (lp, _) in enumerate(PipelineStage._layers(self, 0)):
            x, k, v = self.model.dec_layer_carry(
                lp, x, pos=pos, seg=seg, memory=memory, seg_mem=seg_mem,
                ctx_k=ctx.k[l], ctx_v=ctx.v[l], ctx_len=ctx_len)
            nk.append(k)
            nv.append(v)
        return x, LayerCtx(nk, nv)


def stage_inputs(batch, k: int, tokens: int, table: torch.Tensor,
                 device, blocks: Optional[int] = None):
    """Chunk ``k``'s ``(frames, seg_enc, pos_enc, tokens, targets, seg,
    pos)`` on ``device``: rows cut as ``train_step.chunk_arrays`` cuts
    them, the frames gathered from ``table``
    (``data/batching.frame_table``; pad rows zero). ``blocks`` (the
    sequence-parallel ranks): the rows cut to a multiple of ``ROW_MULTIPLE
    * blocks`` and each array a list of its ``blocks`` contiguous row
    blocks, rank order (the frames' blocks sit at their tokens' rows)."""
    import numpy as np

    from .train_step import ROW_MULTIPLE, _rows, chunk_arrays
    if blocks is not None:
        q = ROW_MULTIPLE * blocks
        whole = stage_inputs(batch, k, -(-max(tokens, 1) // q) * q, table,
                             device)
        return tuple(list(a.chunk(blocks)) for a in whole)
    n = _rows(tokens)
    tok, tgt, seg, pos = chunk_arrays(batch, k, tokens)

    def row(a, fill):
        r = a[k, :n]
        return np.pad(r, (0, n - len(r)), constant_values=fill)
    seg_e = row(batch.seg_enc, -1)
    pos_e = np.where(seg_e >= 0, row(batch.pos_enc, 0), 0).astype(np.int32)
    idx = np.where(seg_e >= 0, row(batch.frame_idx, 0), 0)
    frames = table[torch.from_numpy(idx).to(table.device)].to(device)
    return (frames, *(torch.from_numpy(a).to(device) for a in
                      (seg_e, pos_e, tok, tgt, seg, pos)))

