"""Sequence Processor — Alg. 1: workload-balanced sequence chunking.

A copy of the JAX package's ``core/chunking.py`` (pure Python and NumPy;
same outputs, which ``tests/test_torch_planner.py`` holds equal).

Turns a global batch of variable-length sequences into the three chunk kinds
of §III-A.1:

* the longest sequence is split into ``K`` *workload-balanced* slices (the
  "mesh"); every sequence longer than the first mesh slice is sharded by the
  mesh prefix, leaving a shorter *tail slice*;
* tail slices seed packing buckets (one per tail — packing two tails would
  force co-scheduling two long sequences, footnote 1 of the paper);
* short sequences are packed Best-Fit-Decreasing under a time threshold
  ``T_t`` and a token threshold ``T_m``, preferring the bucket with the
  lowest ``tot_time / tot_tokens`` (pairs long-ish shorts with cheap tails);
  ``T_t`` is loosened *per placement* when ``T_m`` cannot otherwise be met
  (the forced short lands in the cheapest feasible bucket and the threshold
  is restored for the rest of the batch).

The output order is the pipeline execution order: longest sequences first
(§III-C1's fundamental scheduling rule), slices in causal order, the hybrid
chunk (containing the tail) last within its sequence, batched chunks after.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .costs import CostModel
from .plan import Chunk, ChunkKind, SequenceInfo, Slice

__all__ = ["ChunkingResult", "chunk_sequences", "prompt_slices",
           "seq_workload"]


def seq_workload(cm: CostModel, length: int, context: int = 0) -> float:
    """Additive workload of one (sub)sequence: Eq. 1 without the chunk-level
    beta overhead (packing concatenates block-diagonal attention, so member
    workloads add)."""
    co, cl = cm.coeffs, cm.cluster
    c, s = float(context), float(length)
    quad = (c + s) ** 2 - c ** 2
    return (co.alpha1 * 0.5 * quad + co.alpha2 * s) / cl.n_devices


@dataclass
class _Bucket:
    tot_time: float = 0.0
    tot_tokens: int = 0
    tail: Optional[Slice] = None
    tail_context: int = 0
    shorts: List[Slice] = field(default_factory=list)

    @property
    def metric(self) -> float:
        if self.tot_tokens == 0:
            return 0.0
        return self.tot_time / self.tot_tokens

    def add(self, sl: Slice, time: float) -> None:
        self.shorts.append(sl)
        self.tot_time += time
        self.tot_tokens += sl.length


@dataclass
class ChunkingResult:
    chunks: List[Chunk]                  # pipeline execution order
    sequences: List[SequenceInfo]
    mesh: List[int]                      # Alg. 1's slice-length mesh
    t_t: float                           # T_t (line-1 value; loosening is
                                         # per-placement and never persists)
    t_m: int                             # token threshold
    k_split: int

    @property
    def max_chunk_tokens(self) -> int:
        return max((c.tokens for c in self.chunks), default=0)


def _mesh_thresholds(cm: CostModel, max_len: int, k: int,
                     capacity: Optional[int]) -> Tuple[List[int], float, int]:
    """Alg. 1 line 1: mesh + initial T_t + T_m.

    T_m derivation (the paper omits the closed form): the deepest chunks
    window holds ``d_p + K - 1`` chunks (Eq. 7 at p=1), all of whose
    activations must be resident, so a chunk may hold at most
    ``capacity / (d_p + K - 1)`` tokens — clamped below by the largest mesh
    slice (a slice must fit in one chunk).
    """
    mesh = cm.split_balanced(max_len, k)
    t_t = seq_workload(cm, mesh[0], 0) if mesh else 0.0
    cap = capacity if capacity is not None else cm.token_capacity()
    window = cm.cluster.d_p + max(k, 1) - 1
    t_m = max(int(cap / window), max(mesh) if mesh else 1)
    return mesh, t_t, t_m


def prompt_slices(cm: CostModel, length: int, capacity: int) -> List[int]:
    """Capacity-bounded, workload-balanced slices of ONE sequence — Alg. 1
    line 1 applied to a serving prompt (token-level PP reborn as chunked
    prefill). The smallest ``K`` whose balanced mesh fits ``capacity``
    tokens per slice is used, so later slices — which carry more causal
    context and therefore more attention work per token — get fewer tokens,
    exactly like the trainer's mesh.
    """
    if length <= 0:
        return []
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if length <= capacity:
        return [length]
    k = max(2, -(-length // capacity))
    while True:
        mesh = cm.split_balanced(length, k)
        if mesh and max(mesh) <= capacity:
            return mesh
        k += 1


def chunk_sequences(cm: CostModel, lengths: Sequence[int], k: int, *,
                    capacity: Optional[int] = None) -> ChunkingResult:
    """Alg. 1. ``lengths[i]`` is sequence i's token count."""
    if k < 1:
        raise ValueError("K must be >= 1")
    if not lengths:
        return ChunkingResult([], [], [], 0.0, 0, k)
    max_len = max(lengths)
    mesh, t_t, t_m = _mesh_thresholds(cm, max_len, k, capacity)

    # ---- line 2: shard long sequences by the mesh --------------------------
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    # per long sequence: list of split chunks + a tail slice
    long_parts: List[Tuple[int, List[Chunk], Slice, int]] = []
    shorts: List[Slice] = []
    for sid in order:
        ln = lengths[sid]
        if k == 1 or ln <= mesh[0]:
            shorts.append(Slice(seq_id=sid, start=0, length=ln, is_tail=True))
            continue
        splits: List[Chunk] = []
        off = 0
        for m_len in mesh[:-1]:
            remaining = ln - off
            if remaining <= m_len:
                break
            sl = Slice(seq_id=sid, start=off, length=m_len, is_tail=False)
            splits.append(Chunk(kind=ChunkKind.SPLIT, context=off, slices=(sl,)))
            off += m_len
        tail = Slice(seq_id=sid, start=off, length=ln - off, is_tail=True)
        long_parts.append((sid, splits, tail, off))

    # ---- lines 3-15: BFD packing -------------------------------------------
    buckets: List[_Bucket] = []
    for sid, _splits, tail, ctx in long_parts:
        b = _Bucket(tail=tail, tail_context=ctx)
        b.tot_time = seq_workload(cm, tail.length, ctx)
        b.tot_tokens = tail.length
        buckets.append(b)

    shorts.sort(key=lambda s: -seq_workload(cm, s.length))
    for s in shorts:
        t_s = seq_workload(cm, s.length)
        placed = False
        while not placed:
            if buckets:
                min_tok = min(b.tot_tokens for b in buckets)
            else:
                min_tok = t_m + 1  # force creation
            if min_tok + s.length > t_m:
                nb = _Bucket()
                nb.add(s, t_s)
                buckets.append(nb)
                placed = True
                break
            for b in sorted(buckets, key=lambda b: b.metric):
                if (b.tot_time + t_s <= t_t + 1e-18
                        and b.tot_tokens + s.length <= t_m):
                    b.add(s, t_s)
                    placed = True
                    break
            if not placed:
                # line 14: T_m cannot otherwise be met, so loosen T_t — for
                # THIS placement only. Force the short into the cheapest
                # token-feasible bucket (min tot_time, metric tie-break);
                # T_t itself stays put, so one outlier does not relax the
                # time threshold for every subsequent short (which would
                # silently degrade workload balance across the batch).
                feas = [b for b in buckets if b.tot_tokens + s.length <= t_m]
                if not feas:
                    nb = _Bucket()
                    nb.add(s, t_s)
                    buckets.append(nb)
                else:
                    t_min = min(b.tot_time for b in feas)
                    best = min((b for b in feas
                                if b.tot_time <= t_min + 1e-18),
                               key=lambda b: b.metric)
                    best.add(s, t_s)
                placed = True

    # ---- line 15-16: transform & order -------------------------------------
    chunks: List[Chunk] = []
    seq_chunks: Dict[int, List[int]] = {}

    def _note(cidx: int, sids: Sequence[int]) -> None:
        for sid in sids:
            seq_chunks.setdefault(sid, []).append(cidx)

    tail_bucket: Dict[int, _Bucket] = {
        b.tail.seq_id: b for b in buckets if b.tail is not None}

    # long sequences first, longest first (already sorted)
    for sid, splits, tail, ctx in long_parts:
        for ch in splits:
            chunks.append(ch)
            _note(len(chunks) - 1, [sid])
        b = tail_bucket[sid]
        kind = ChunkKind.HYBRID if b.shorts else ChunkKind.SPLIT
        ch = Chunk(kind=kind, context=ctx, slices=(tail, *b.shorts))
        chunks.append(ch)
        _note(len(chunks) - 1, [sid] + [s.seq_id for s in b.shorts])
    # pure batched buckets, heaviest first
    pure = [b for b in buckets if b.tail is None and b.shorts]
    pure.sort(key=lambda b: -b.tot_time)
    for b in pure:
        ch = Chunk(kind=ChunkKind.BATCHED, context=0, slices=tuple(b.shorts))
        chunks.append(ch)
        _note(len(chunks) - 1, [s.seq_id for s in b.shorts])

    sequences = [
        SequenceInfo(seq_id=sid, length=lengths[sid],
                     n_chunks=len(cids), chunk_ids=sorted(cids))
        for sid, cids in sorted(seq_chunks.items())
    ]
    return ChunkingResult(chunks=chunks, sequences=sequences, mesh=mesh,
                          t_t=t_t, t_m=t_m, k_split=k)
