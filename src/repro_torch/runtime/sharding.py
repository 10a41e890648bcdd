"""Layer placement of the pipeline: which global layers each stage, and
each virtual stage of it, runs, and which card each stage lives on.

Counterpart of the placement half of the JAX package's
``runtime/sharding.py`` (``stack_stages``, ``interleaved_layer_order``,
``stage_active_mask``) and of ``layers_per_stage`` in its
``runtime/train_step.py``. The reference stacks every stage's layers into
``[d_p, L_s, ...]`` arrays with inert padded slots, which its executor runs
as identity; here a stage keeps a map from its (virtual stage, slot) to the
global layer ids and skips the padded slots.

ZeRO-3 over a stage's ``d_s`` sequence-parallel ranks (the reference's
``zero3_dim``, ``shard_dim_tree``, ``gather_params``,
``gather_layer_params``, ``gather_stage_params`` and the head rule of
``head_param_specs``): :func:`shard_layout` gives every leaf of a stage
its :class:`LeafShard` and :func:`shard_leaf` cuts it into the ranks'
own tensors. The reference picks the dim on stage-stacked ``[d_p, L_s,
...]`` leaves; the port keeps per-layer leaves, so its dim is the
reference's minus :data:`STACK_DIMS`, taken through the transpose of the
dense leaves (the port stores ``[d_out, d_in]``, the reference ``[d_in,
d_out]``: ``weights.DENSE_LEAVES``), so that rank ``r`` holds the same
elements as the reference's rank ``r``. Expert weights (:data:`EP_PATH_RE`)
stay sharded on the expert dim and are never gathered (``runtime/ep.py``
runs each rank's own block); the embedding and an untied head on
vocabulary rows (``runtime/sp.row_blocks``: the reference's padded last
block, its padding dropped), never gathered either; the final norm where
``D % d_s == 0``; a leaf with no divisible dim stays whole on every rank.
Shards follow the full ``d_s`` at any ``d_s_eff``.

:class:`Zero3` gathers them on use: ``per_tick`` a layer for each chunk
(:meth:`Zero3.keep_shards` saves the shards, not the gathered weights,
for the backward, which gathers again), ``per_step`` the stage once a
step, kept until its last backward; each weight gradient lands in the
ranks' float32 shard sums (the gather's transpose, or
:func:`reduce_scatter_grads`). Its collectives count in
``runtime/sp.STATS`` and :data:`ZSTATS`. The ranks of a stage share its
card (one process): SP ranks across cards wait on the per-rank driver
(``ROADMAP.md``, queue 1, item 2).

The encoder-decoder's layout (:func:`encdec_stage_layers`) splits the
stages between the encoder and the decoder
(``core.checkpointing.encoder_stage_split``, the split the checkpointing
ILP's stage roles use): encoder stages hold encoder layers only, decoder
stages decoder layers only. The reference lifts encoder layers into the
decoder's structure (zero ``cross`` and ``ln_x`` slots) so that JAX can
stack one pytree; here each stage holds its own layers' parameters.
"""

from __future__ import annotations

import contextlib
import re
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.checkpointing import encoder_stage_split

__all__ = ["layers_per_stage", "interleaved_layer_order", "stage_layers",
           "stage_active_mask", "stage_blocks", "stage_devices",
           "encdec_stage_layers", "EP_PATH_RE", "STACK_DIMS", "zero3_dim",
           "ref_axis", "head_dim", "LeafShard", "shard_layout",
           "shard_leaf", "unshard_leaf", "ShardedLeaf", "Zero3",
           "ZERO3_MODES", "ZSTATS", "reduce_scatter_grads",
           "gather_params", "gather_layer_params", "gather_stage_params"]


def layers_per_stage(n_layers: int, d_p: int) -> int:
    """Layer slots per stage: ``ceil(L / d_p)`` (the last stages may hold
    padded slots)."""
    return -(-n_layers // d_p)


def interleaved_layer_order(d_p: int, layers_per_stage: int, v: int
                            ) -> np.ndarray:
    """Padded-layer permutation for ``interleaved-1f1b``: global virtual
    stage ``s = j * d_p + p`` (stage ``p``'s local virtual stage ``j``)
    owns the padded layers ``[s * L_v, (s + 1) * L_v)``, ``L_v =
    layers_per_stage / v``; ``order[p * L_s + j * L_v + l]`` is the padded
    layer in stage ``p``'s slot ``j * L_v + l``. Identity at ``v == 1``."""
    if layers_per_stage % v:
        raise ValueError(
            f"v={v} must divide layers_per_stage={layers_per_stage}")
    L_v = layers_per_stage // v
    p_idx, j, l = np.meshgrid(np.arange(d_p), np.arange(v), np.arange(L_v),
                              indexing="ij")
    return ((j * d_p + p_idx) * L_v + l).reshape(-1)


def stage_layers(d_p: int, n_layers: int, v: int = 1) -> np.ndarray:
    """``[d_p, L_s]`` padded global layer ids of each stage's slots (the
    reference's ``stack_stages`` of ``arange(L)``); ids ``>= n_layers``
    are padded slots."""
    L_s = layers_per_stage(n_layers, d_p)
    flat = np.arange(d_p * L_s)
    if v > 1:
        flat = flat[interleaved_layer_order(d_p, L_s, v)]
    return flat.reshape(d_p, L_s)


def stage_active_mask(d_p: int, n_layers: int, v: int = 1) -> np.ndarray:
    """``[d_p, L_s]`` bool: True where a real layer lives."""
    return stage_layers(d_p, n_layers, v) < n_layers


def stage_blocks(d_p: int, n_layers: int, v: int = 1
                 ) -> List[List[List[int]]]:
    """``blocks[p][j]``: the global layer ids that stage ``p``'s virtual
    stage ``j`` runs, in order, padded slots skipped (they sit at the end
    of the layer order, so a block's real layers lead it)."""
    ids = stage_layers(d_p, n_layers, v)
    L_v = ids.shape[1] // v
    return [[[int(i) for i in ids[p, j * L_v:(j + 1) * L_v] if i < n_layers]
             for j in range(v)] for p in range(d_p)]


def stage_devices(d_p: int, cards: Sequence, d_s: int = 1
                  ) -> List[torch.device]:
    """Stage ``p`` lives on card ``p mod len(cards)``: every stage on one
    card when one is given, one stage per card when there are ``d_p``. A
    stage's ``d_s`` sequence-parallel ranks live on its card, each with its
    own ZeRO-3 shards; more cards than stages would put a stage's ranks on
    several cards, which needs a process a rank: that raises."""
    if not cards:
        raise ValueError("stage_devices needs at least one card")
    if d_s > 1 and len(cards) > d_p:
        raise NotImplementedError(
            f"{len(cards)} cards for {d_p} stages of {d_s} SP ranks: SP "
            f"ranks across cards need the per-rank driver, which is not "
            f"ported: ROADMAP.md queue 1, item 2")
    return [torch.device(cards[p % len(cards)]) for p in range(d_p)]


def encdec_stage_layers(n_enc: int, n_dec: int, d_p: int
                        ) -> List[Tuple[str, List[int]]]:
    """Each stage's role (``"encoder"`` or ``"decoder"``) and the layer ids
    of that stack it runs: the leading ``encoder_stage_split`` stages take
    the encoder, the rest the decoder, each stage ``L_ps = max(ceil(n_enc /
    enc_stages), ceil(n_dec / dec_stages))`` layer slots of its stack (the
    reference's ``stack_grouped_stages``; ids past a stack's end are
    padded slots, skipped). ``d_p < 2`` raises: the split leaves no
    encoder stage (``encoder_stage_split(n_enc, n_dec, 1) == (0, 1)``)."""
    enc_st, dec_st = encoder_stage_split(n_enc, n_dec, d_p)
    if enc_st < 1 or dec_st < 1:
        raise ValueError(
            f"an encoder-decoder pipeline needs an encoder and a decoder "
            f"stage: encoder_stage_split({n_enc}, {n_dec}, {d_p}) = "
            f"{(enc_st, dec_st)}; use d_p >= 2")
    L_ps = max(-(-n_enc // enc_st), -(-n_dec // dec_st))

    def ids(q: int, n: int) -> List[int]:
        return [i for i in range(q * L_ps, (q + 1) * L_ps) if i < n]
    return ([("encoder", ids(q, n_enc)) for q in range(enc_st)]
            + [("decoder", ids(q, n_dec)) for q in range(dec_st)])


# ---------------------------------------------------------------------------
# ZeRO-3 over the sequence-parallel axis

EP_PATH_RE = re.compile(r"moe/(w_gate|w_up|w_down)$")
# the reference's zero3_dim counts the stage-stacked leaf's [d_p, L_s]
# lead; a port leaf is one layer's, so the port's dim is the reference's
# minus these (through the dense leaves' transpose: :func:`ref_axis`)
STACK_DIMS = 2
ZERO3_MODES = ("per_tick", "per_step")
HEAD_LEAVES = ("embed", "unembed", "final_norm", "enc_norm")
# a stage's stacks of layers (by id): the decoder's, the encoder-decoder's
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")


def _dense(path: str, ndim: int) -> bool:
    from repro_torch.weights import DENSE_LEAVES
    return ndim >= 2 and path.rsplit("/", 1)[-1] in DENSE_LEAVES


def ref_axis(path: str, ndim: int, axis: int) -> int:
    """The axis of the reference's per-layer leaf that the port's ``axis``
    holds (the last two swapped on a dense leaf; its own on any other).
    The reference's stage-stacked dim is this plus :data:`STACK_DIMS`."""
    if _dense(path, ndim) and axis >= ndim - 2:
        return 2 * ndim - 3 - axis
    return axis


def zero3_dim(path: str, shape: Sequence[int], d_s: int) -> Optional[int]:
    """The ZeRO-3 shard dim of one layer's leaf ``path`` (its key path in
    the layer, ``"attn/wq"``) of the port's ``shape``: the reference's
    ``zero3_dim`` (the first dim of its own layout divisible by ``d_s``;
    the expert dim of an :data:`EP_PATH_RE` leaf), as the port's axis;
    None: kept whole on every rank."""
    n = len(shape)
    if EP_PATH_RE.search(path):
        return 0
    ref = [shape[ref_axis(path, n, a)] for a in range(n)]
    for d in range(n):
        if ref[d] % d_s == 0:
            return ref_axis(path, n, d)     # (the swap is its own inverse)
    return None


def head_dim(name: str, shape: Sequence[int], d_s: int) -> Optional[int]:
    """The reference's ``head_param_specs``: the embedding and the untied
    head ``[V, D]`` on vocabulary rows (dim 0, any ``V``: the last block is
    shorter, ``sp.row_blocks``); the final norm where ``D % d_s == 0``;
    None: whole on every rank."""
    if len(shape) >= 2:
        return 0
    if shape and shape[0] % d_s == 0:
        return 0
    return None


@dataclass(frozen=True)
class LeafShard:
    """How a leaf is split over a stage's ``d_s`` ranks: along ``dim`` in
    blocks of ``sizes`` (rank order), or whole on every rank (``dim``
    None); ``gathered``: the forward gathers it (False for the expert and
    vocabulary blocks, which each rank runs as its own)."""
    dim: Optional[int]
    sizes: Optional[Tuple[int, ...]]
    gathered: bool = True

    @property
    def whole(self) -> bool:
        return self.dim is None


def _leaf_shard(path: str, shape: Sequence[int], d_s: int) -> LeafShard:
    from .sp import row_blocks
    top = path.split("/", 1)[0]
    if top in HEAD_LEAVES:
        dim = head_dim(top, shape, d_s)
        if dim is not None and len(shape) >= 2:
            return LeafShard(0, tuple(r for _, r in row_blocks(shape[0], d_s)),
                             gathered=False)
    else:
        dim = zero3_dim(path, shape, d_s)
    if dim is None:
        return LeafShard(None, None)
    if shape[dim] % d_s:
        raise ValueError(f"{path}: dim {dim} of {tuple(shape)} is not "
                         f"divisible by d_s={d_s}")
    return LeafShard(dim, (shape[dim] // d_s,) * d_s,
                     gathered=not EP_PATH_RE.search(path))


def shard_layout(tree, d_s: int, path: str = ""):
    """A stage's tree (``weights.to_stages``' layout: ``layers`` by id,
    ``embed``, ``final_norm``, ``unembed``; an encoder-decoder's
    ``enc_layers`` or ``dec_layers`` by id and ``enc_norm``) with a
    :class:`LeafShard` for each leaf (the layer leaves' paths drop the
    ``layers/<id>`` prefix, as the reference's stacked tree has none;
    ``enc_norm`` takes the final norm's rule, as the reference's cell
    shards it)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if path == "" and k in LAYER_STACKS:
                out[k] = {i: shard_layout(lp, d_s, "") for i, lp in v.items()}
            else:
                out[k] = shard_layout(v, d_s, f"{path}/{k}" if path else
                                      str(k))
        return out
    return _leaf_shard(path, tuple(tree.shape), d_s)


def shard_leaf(t: torch.Tensor, spec: LeafShard, d_s: int
               ) -> List[torch.Tensor]:
    """``t`` cut into the ranks' own tensors (fresh, contiguous): blocks
    of ``spec.sizes`` along ``spec.dim``, or a copy each of a whole leaf."""
    if spec.whole:
        return [t.clone() for _ in range(d_s)]
    return [b.contiguous().clone() for b in t.split(list(spec.sizes),
                                                     dim=spec.dim)]


def unshard_leaf(shards: Sequence[torch.Tensor], spec: LeafShard
                 ) -> torch.Tensor:
    """The whole leaf from the ranks' shards (rank 0's copy of a whole
    one), without autograd."""
    with torch.no_grad():
        if spec.whole:
            return shards[0].detach().clone()
        return torch.cat([s.detach() for s in shards], dim=spec.dim)


def map_layout(fn, layout, *trees):
    """``fn(spec, *leaves)`` over a layout and trees of its structure."""
    if isinstance(layout, dict):
        return {k: map_layout(fn, v, *(t[k] for t in trees))
                for k, v in layout.items()}
    return fn(layout, *trees)


# gathers, re-gathers, reduce-scatters and their bytes (the convention of
# ``runtime/sp.STATS``: a gather of d ranks moves (d - 1) whole leaves); the
# gathered bytes alive now and the most alive at once since the last reset
ZSTATS = {"gathers": 0, "gather_bytes": 0, "regathers": 0,
          "scatter_bytes": 0, "live_bytes": 0, "peak_live_bytes": 0}


def zstats_reset() -> None:
    for k in ZSTATS:
        if k != "live_bytes":
            ZSTATS[k] = 0
    ZSTATS["peak_live_bytes"] = ZSTATS["live_bytes"]


def _track(t: torch.Tensor) -> None:
    """Count ``t`` (a gathered leaf) as live until it is freed."""
    n = t.numel() * t.element_size()
    ZSTATS["live_bytes"] += n
    ZSTATS["peak_live_bytes"] = max(ZSTATS["peak_live_bytes"],
                                    ZSTATS["live_bytes"])
    weakref.finalize(t, _untrack, n)


def _untrack(n: int) -> None:
    ZSTATS["live_bytes"] -= n


def gather_shards(shards: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The ranks' shards of a leaf in rank order along ``dim``
    (``sp.all_gather``)."""
    from . import sp
    return sp.all_gather(shards, dim=dim)


class ShardedLeaf:
    """One leaf of a stage: its ranks' shards (autograd leaves), its
    :class:`LeafShard`, and the ranks' float32 gradient sums (``accs``,
    set by the trainer for a step). A gathered copy carries it as
    ``zero3_key`` (``models/layers.weight_key``), so a deferred weight
    gradient finds its shards."""

    def __init__(self, shards: Sequence[torch.Tensor], spec: LeafShard):
        self.shards, self.spec = list(shards), spec
        self.accs: Optional[List[torch.Tensor]] = None

    def gather(self) -> torch.Tensor:
        """The whole leaf for every rank's use, differentiable: the shards
        concatenated along the dim (``sp.all_gather``), or rank 0's copy of
        a whole leaf, whose gradient each copy takes (an all-reduce)."""
        if self.spec.whole:
            return _Replicate.apply(*self.shards)
        full = _Gather.apply(self.spec.dim, self.spec.sizes, *self.shards)
        _gathered(full, self)
        return full

    def gather_detached(self) -> torch.Tensor:
        """The whole leaf as an autograd leaf of its own (``per_step``):
        its gradient is handed to :func:`reduce_scatter_grads` after each
        backward."""
        if self.spec.whole:
            full = self.shards[0].detach()
        else:
            with torch.no_grad():
                full = gather_shards([s.detach() for s in self.shards],
                                     self.spec.dim)
            _gathered(full, self)
        full.requires_grad_(True)
        full.zero3_key = self
        return full



def _gathered(full: torch.Tensor, leaf: ShardedLeaf) -> None:
    ZSTATS["gathers"] += 1
    ZSTATS["gather_bytes"] += (len(leaf.shards) - 1) * full.numel() * \
        full.element_size()
    full.zero3_key = leaf
    _track(full)
    if _LIVE is not None:
        _LIVE[_storage_key(full)] = _Regather(leaf)


class _Gather(torch.autograd.Function):
    """The shards gathered along ``dim`` (:func:`gather_shards`); its
    transpose splits the summed gradient of every rank's use back into
    the ranks' blocks, a reduce-scatter counted in ``sp.STATS`` and
    :data:`ZSTATS`."""

    @staticmethod
    def forward(ctx, dim, sizes, *shards):
        ctx.dim, ctx.sizes = dim, sizes
        return gather_shards(shards, dim)

    @staticmethod
    def backward(ctx, g):
        from . import sp
        n = (len(ctx.sizes) - 1) * g.numel() * g.element_size()
        sp._count(n, "reduce-scatter")
        ZSTATS["scatter_bytes"] += n
        return (None, None, *g.split(list(ctx.sizes), dim=ctx.dim))


class _Replicate(torch.autograd.Function):
    """A whole leaf's copies -> rank 0's, for every rank; backward: the
    summed gradient of every use to each copy."""

    @staticmethod
    def forward(ctx, *copies):
        return copies[0].view_as(copies[0])

    @staticmethod
    def backward(ctx, g):
        return (g,) * len(ctx.needs_input_grad)


def reduce_scatter_grads(contribs: Sequence[torch.Tensor], leaf: ShardedLeaf
                         ) -> None:
    """Whole-leaf gradients of one leaf (the split backward's ``W`` pass:
    a product for each rank that used it; ``per_step``: the resident
    copy's gradient) reduce-scattered into the ranks' float32 sums: each
    one's block ``r`` added into rank ``r``'s sum (a whole leaf: all of
    it into every rank's), one after another in their order, so no
    whole-leaf temporary is made."""
    from . import sp
    for c in contribs:
        if leaf.spec.whole:
            for a in leaf.accs:
                a.add_(c)
            continue
        n = (len(leaf.accs) - 1) * c.numel() * c.element_size()
        sp._count(n, "reduce-scatter")
        ZSTATS["scatter_bytes"] += n
        for a, b in zip(leaf.accs, c.split(list(leaf.spec.sizes),
                                           dim=leaf.spec.dim)):
            a.add_(b)


# ``per_tick``: the gathered storages of the layer being run (storage
# identity, :func:`_storage_key` -> :class:`_Regather`), while :meth:`Zero3.keep_shards` is active
_LIVE: Optional[Dict[int, "_Regather"]] = None


class _Regather:
    """A saved gathered weight, gathered again from its shards the first
    time the backward unpacks it and kept until every node that saved it
    has run (the node's saved slots hold this object)."""

    def __init__(self, leaf: ShardedLeaf):
        self.leaf, self.full = leaf, None

    def get(self) -> torch.Tensor:
        if self.full is None:
            leaf = self.leaf
            with torch.no_grad():
                self.full = gather_shards([s.detach() for s in leaf.shards],
                                          leaf.spec.dim)
            ZSTATS["regathers"] += 1
            ZSTATS["gather_bytes"] += (len(leaf.shards) - 1) * \
                self.full.numel() * self.full.element_size()
            _track(self.full)
        return self.full


def _storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its data pointer would do on a
    card, but every meta storage has pointer 0)."""
    return t.untyped_storage()._cdata


def _pack(t: torch.Tensor):
    g = _LIVE.get(_storage_key(t)) if _LIVE else None
    if g is None:
        return t
    return (g, t.storage_offset(), tuple(t.shape), tuple(t.stride()))


def _unpack(x):
    if isinstance(x, torch.Tensor):
        return x
    g, off, size, stride = x
    return g.get().as_strided(size, stride, off)


def _resident(tree, out: List) -> None:
    # a module-level function: a nested one that calls itself is a
    # reference cycle, which kept a step's gathered copies alive until the
    # garbage collector ran
    if isinstance(tree, dict):
        for v in tree.values():
            _resident(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append((tree, tree.zero3_key))


class Zero3:
    """A stage's ZeRO-3 view of its layers in ``mode`` (:data:`ZERO3_MODES`):
    ``leaves`` maps each layer id (and ``"final_norm"``) to its
    :class:`ShardedLeaf` tree. :meth:`layer` gives the model a layer's
    parameters: gathered now (``per_tick``) or the step's resident copy
    (``per_step``, :meth:`gather_step`); EP leaves as the tuple of the
    ranks' shards."""

    def __init__(self, mode: str, leaves: Dict):
        if mode not in ZERO3_MODES:
            raise ValueError(f"zero3_mode {mode!r}: one of {ZERO3_MODES}")
        self.mode, self.leaves = mode, leaves
        self.resident: Optional[Dict] = None

    def _gather(self, tree):
        if isinstance(tree, dict):
            return {k: self._gather(v) for k, v in tree.items()}
        if not tree.spec.gathered:
            return tuple(tree.shards)
        if self.mode == "per_step":
            return tree.gather_detached()
        return tree.gather()

    def layer(self, key):
        """Layer ``key``'s parameters for the model (``key``: a layer id,
        or ``"final_norm"``)."""
        if self.mode == "per_step":
            if self.resident is None:
                raise RuntimeError("per_step gathers at the step's start "
                                   "(Zero3.gather_step)")
            return self.resident[key]
        return self._gather(self.leaves[key])

    def gather_step(self) -> None:
        """``per_step``: every leaf gathered once, kept until
        :meth:`release`."""
        if self.mode == "per_step":
            self.resident = {k: self._gather(v)
                             for k, v in self.leaves.items()}

    def resident_leaves(self) -> List[Tuple[torch.Tensor, ShardedLeaf]]:
        """``per_step``: the gathered autograd leaves and their shards."""
        out: List = []
        _resident(self.resident or {}, out)
        return out

    def release(self) -> None:
        self.resident = None

    @contextlib.contextmanager
    def keep_shards(self):
        """``per_tick``, around a layer run without remat: what autograd
        saves of a weight gathered inside is its shards (a
        :class:`_Regather`), so the gathered copy dies with the layer's
        forward and the backward gathers it again."""
        global _LIVE
        if self.mode != "per_tick":
            yield
            return
        prev, _LIVE = _LIVE, {}
        try:
            with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
                yield
        finally:
            _LIVE = prev


def gather_params(rank_trees, layout):
    """The reference's ``gather_params`` on the port's trees:
    ``rank_trees`` the ranks' trees, ``layout`` their :class:`LeafShard`
    tree; each gathered leaf whole along its dim (a whole leaf: rank 0's
    copy), the others (experts, vocabulary rows) as the tuple of the ranks'
    shards. Differentiable: the transpose of each gather splits the summed
    gradient of its uses into the ranks' blocks."""
    def one(spec, *shards):
        if not spec.gathered:
            return tuple(shards)
        return ShardedLeaf(shards, spec).gather()
    return map_layout(one, layout, *rank_trees)


def gather_layer_params(rank_layers, layout):
    """``per_tick``: one layer's parameters from its ranks' shards."""
    return gather_params(rank_layers, layout)


def gather_stage_params(rank_stages, layout):
    """``per_step``: a whole stage's parameters from its ranks' shards."""
    return gather_params(rank_stages, layout)
