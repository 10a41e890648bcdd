"""Alg. 1 line 1 applied to one serving prompt (chunked prefill).

The trainer's full sequence chunker (packing, hybrid chunks) is ported with
the training slice; serving needs only :func:`prompt_slices`.
"""

from __future__ import annotations

from typing import List

from .costs import CostModel

__all__ = ["prompt_slices"]


def prompt_slices(cm: CostModel, length: int, capacity: int) -> List[int]:
    """Capacity-bounded, workload-balanced slices of ONE sequence. The
    smallest ``K`` whose balanced mesh fits ``capacity`` tokens per slice
    is used, so later slices — which carry more causal context and
    therefore more attention work per token — get fewer tokens, exactly
    like the trainer's mesh.
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
