"""Materialize an ExecutionPlan into the executor's fixed-shape chunk
buffers (the chunks are workload-balanced and capacity-
padded, so one bucket geometry serves many iterations). A copy of the JAX
package's ``data/batching.py``.

Conventions the executor depends on:

* within a chunk, the split/tail slice (s0) is segment 0 — the context rows
  of a split chunk always belong to segment 0;
* ``pos`` is the token's position within its OWNING sequence (split slices
  continue from their context offset);
* ``targets`` are next-token ids across the whole sequence — the target of
  a non-tail slice's last token is the first token of the next slice;
* padding positions carry seg = -1, target = -1;
* ``ctx_len[k]`` = the chunk's context length C_k (0 => the context buffer
  and SSM state implicitly reset).

The encoder-decoder's chunks (:func:`materialize_encdec_plan`) carry
frames beside the tokens: each sequence brings as many frames as tokens
(the reference's ``cap_enc = cap``), laid out as its tokens are, so a
sequence's frames carry its tokens' segment id (cross-attention pairs
rows by it) and its positions. The frames themselves are the frontend
stub's embeddings (:func:`sequence_frames`, a generator seeded per
sequence), gathered into a chunk's ``[cap_enc, D]`` rows by
``frame_idx`` (row 0 of :func:`frame_table` is the pad rows' zeros).

A sequence-parallel group takes a chunk's rows in contiguous blocks, one
a rank (:func:`rank_blocks`), as the reference shards a chunk's buffers
over its model axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.plan import Chunk, ExecutionPlan

__all__ = ["ChunkBatch", "EncDecChunkBatch", "frame_table",
           "materialize_chunks", "materialize_encdec_plan", "materialize_plan",
           "rank_blocks", "sequence_frames"]


@dataclass
class ChunkBatch:
    tokens: np.ndarray      # [n_chunks, cap] int32
    targets: np.ndarray
    seg: np.ndarray
    pos: np.ndarray
    ctx_len: np.ndarray     # [n_chunks] int32

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {"tokens": self.tokens, "targets": self.targets,
                "seg": self.seg, "pos": self.pos, "ctx_len": self.ctx_len}


def materialize_chunks(chunks: Sequence[Chunk],
                       corpus: Dict[int, np.ndarray],
                       cap: int) -> ChunkBatch:
    n = len(chunks)
    tokens = np.zeros((n, cap), np.int32)
    targets = np.full((n, cap), -1, np.int32)
    seg = np.full((n, cap), -1, np.int32)
    pos = np.zeros((n, cap), np.int32)
    ctx_len = np.zeros((n,), np.int32)

    for k, ch in enumerate(chunks):
        ctx_len[k] = ch.context
        off = 0
        for s_idx, sl in enumerate(ch.slices):
            toks = corpus[sl.seq_id]
            assert sl.start + sl.length <= len(toks), (sl, len(toks))
            t = toks[sl.start: sl.start + sl.length]
            nxt = np.full((sl.length,), -1, np.int32)
            # next-token targets across slice boundaries
            hi = min(sl.start + sl.length, len(toks) - 1)
            n_t = hi - sl.start
            if n_t > 0:
                nxt[:n_t] = toks[sl.start + 1: sl.start + 1 + n_t]
            end = off + sl.length
            assert end <= cap, f"chunk {k} overflows cap {cap}"
            tokens[k, off:end] = t
            targets[k, off:end] = nxt
            seg[k, off:end] = s_idx
            pos[k, off:end] = np.arange(sl.start, sl.start + sl.length)
            off = end
    return ChunkBatch(tokens, targets, seg, pos, ctx_len)


def materialize_plan(plan: ExecutionPlan, corpus: Dict[int, np.ndarray]
                     ) -> ChunkBatch:
    """All pipelines' chunks concatenated in execution order (gradient
    accumulation across 1F1B pipelines is the concatenated scan)."""
    chunks: List[Chunk] = []
    for p in plan.pipelines:
        chunks.extend(p.chunks)
    return materialize_chunks(chunks, corpus, plan.chunk_capacity)


@dataclass
class EncDecChunkBatch(ChunkBatch):
    seg_enc: np.ndarray     # [n_chunks, cap_enc] int32 (-1: pad frame)
    pos_enc: np.ndarray
    frame_idx: np.ndarray   # [n_chunks, cap_enc] int64 rows of frame_table


def materialize_encdec_plan(plan: ExecutionPlan,
                            corpus: Dict[int, np.ndarray]) -> EncDecChunkBatch:
    """:func:`materialize_plan` with each chunk's frames: ``cap_enc = cap``,
    a slice's frames at its tokens' rows with their segment id and
    positions, ``frame_idx`` the rows of :func:`frame_table` (sequences in
    sorted id order) that fill them."""
    b = materialize_plan(plan, corpus)
    start, off = {}, 1
    for sid in sorted(corpus):
        start[sid] = off
        off += len(corpus[sid])
    idx = np.zeros(b.seg.shape, np.int64)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    for k, ch in enumerate(chunks):
        row = 0
        for sl in ch.slices:
            idx[k, row:row + sl.length] = start[sl.seq_id] + sl.start + \
                np.arange(sl.length)
            row += sl.length
    return EncDecChunkBatch(b.tokens, b.targets, b.seg, b.pos, b.ctx_len,
                            seg_enc=b.seg.copy(), pos_enc=b.pos.copy(),
                            frame_idx=idx)


def sequence_frames(cfg, corpus: Dict[int, np.ndarray], seed: int, *,
                    device, dtype=None) -> Dict:
    """Each sequence's frames ``[L, D]`` (``L`` its token count) from
    ``models/frontends.audio_frame_stub``, drawn from a generator on
    ``device`` seeded with ``(seed, sequence id)``."""
    import torch

    from repro_torch.models.frontends import audio_frame_stub
    out = {}
    for sid in sorted(corpus):
        gen = torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + int(sid))
        out[sid] = audio_frame_stub(cfg, gen, len(corpus[sid]),
                                    device=device,
                                    dtype=dtype or torch.bfloat16)
    return out


def frame_table(frames: Dict):
    """The sequences' frames (sorted by id) in one ``[1 + sum L, D]``
    table behind a zero row, the rows ``frame_idx`` indexes."""
    import torch
    rows = [frames[sid] for sid in sorted(frames)]
    return torch.cat([rows[0].new_zeros((1, rows[0].shape[1])), *rows])


def rank_blocks(arrays: Sequence[np.ndarray], d: int
                ) -> List[List[np.ndarray]]:
    """Each of a chunk's row arrays (``[..., T]``: tokens, targets, seg,
    pos; M-RoPE's ``[3, T]`` positions) as its ``d`` contiguous blocks of
    ``T / d`` rows along the last axis, rank order (``T % d`` must be 0)."""
    out = []
    for a in arrays:
        T = a.shape[-1]
        if T % d:
            raise ValueError(f"{T} rows do not split into {d} blocks")
        b = T // d
        out.append([a[..., r * b:(r + 1) * b] for r in range(d)])
    return out
