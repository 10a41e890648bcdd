"""Layer placement of the pipeline: which global layers each stage, and
each virtual stage of it, runs, and which card each stage lives on.

Counterpart of the placement half of the JAX package's
``runtime/sharding.py`` (``stack_stages``, ``interleaved_layer_order``,
``stage_active_mask``) and of ``layers_per_stage`` in its
``runtime/train_step.py``. The reference stacks every stage's layers into
``[d_p, L_s, ...]`` arrays with inert padded slots, which its executor runs
as identity; here a stage keeps a map from its (virtual stage, slot) to the
global layer ids and skips the padded slots. A stage's sequence-parallel
ranks share its card and its parameters: the vocabulary's and the
experts' row blocks (``runtime/sp.row_blocks``, ``runtime/ep.py``) are
row views of them. ZeRO-3's gather functions and SP ranks across cards
are not ported (``ROADMAP.md``, queue 1, items 3 and 2).

The encoder-decoder's layout (:func:`encdec_stage_layers`) splits the
stages between the encoder and the decoder
(``core.checkpointing.encoder_stage_split``, the split the checkpointing
ILP's stage roles use): encoder stages hold encoder layers only, decoder
stages decoder layers only. The reference lifts encoder layers into the
decoder's structure (zero ``cross`` and ``ln_x`` slots) so that JAX can
stack one pytree; here each stage holds its own layers' parameters.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.checkpointing import encoder_stage_split

__all__ = ["layers_per_stage", "interleaved_layer_order", "stage_layers",
           "stage_active_mask", "stage_blocks", "stage_devices",
           "encdec_stage_layers"]


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
    stage's ``d_s`` sequence-parallel ranks live on its card and share its
    one copy of the parameters (the ``d_s`` ZeRO-3 shards of the planner's
    model, whole); more cards than stages would put a stage's ranks on
    several cards, each then needing a copy: that raises."""
    if not cards:
        raise ValueError("stage_devices needs at least one card")
    if d_s > 1 and len(cards) > d_p:
        raise NotImplementedError(
            f"{len(cards)} cards for {d_p} stages of {d_s} SP ranks: SP "
            f"ranks across cards (a parameter shard per card, ZeRO-3 over "
            f"d_s) are not ported: ROADMAP.md queue 1, items 3 and 2")
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
