"""Synthetic corpora, request traces and the plan's chunk buffers
(host-only; no torch)."""

from .batching import ChunkBatch, materialize_chunks, materialize_plan
from .synth import (PRESETS, sample_corpus_batch, sample_lengths,
                    sample_request_trace)

__all__ = ["ChunkBatch", "PRESETS", "materialize_chunks", "materialize_plan",
           "sample_corpus_batch", "sample_lengths", "sample_request_trace"]
