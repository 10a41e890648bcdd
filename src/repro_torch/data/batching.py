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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.plan import Chunk, ExecutionPlan

__all__ = ["ChunkBatch", "materialize_plan", "materialize_chunks"]


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
