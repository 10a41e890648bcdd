"""Synthetic corpora and request traces (host-only; no torch)."""

from .synth import PRESETS, sample_lengths, sample_request_trace

__all__ = ["PRESETS", "sample_lengths", "sample_request_trace"]
