"""Synthetic corpora, request traces and the plan's chunk buffers
(host-only numpy; torch only where the encoder-decoder's frames are drawn
on a device)."""

from .batching import (ChunkBatch, EncDecChunkBatch, frame_table,
                       materialize_chunks, materialize_encdec_plan,
                       materialize_plan, sequence_frames)
from .synth import (PRESETS, sample_corpus_batch, sample_lengths,
                    sample_request_trace)

__all__ = ["ChunkBatch", "EncDecChunkBatch", "PRESETS", "frame_table",
           "materialize_chunks", "materialize_encdec_plan",
           "materialize_plan", "sample_corpus_batch", "sample_lengths",
           "sample_request_trace", "sequence_frames"]
