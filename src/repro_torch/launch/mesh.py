"""Production meshes, as plain descriptions.

The JAX package's ``launch/mesh.py`` builds ``jax`` meshes over devices;
the port's mesh is a description only (:class:`Mesh`): its shape, its
axis names and the three degrees the planner and the trainers take
(``d_p``, ``d_s``, ``n_pods``). Making one needs no device. A run places
its ranks through ``runtime/sharding.stage_devices``, as it does without
a mesh.

Axis semantics (the reference's):
  pod   — data parallel across pods (gradient all-reduce, optionally int8)
  data  — pipeline stages d_p (stage-stacked params + stage hand-off)
  model — SP/FSDP/EP d_s (ulysses / allgather-KV, ZeRO-3, expert parallel)

The reference's ``configure_latency_hiding``, ``latency_hiding_active`` and
``LATENCY_HIDING_FLAGS`` set XLA flags so that the compiled stage hand-off
overlaps compute. They have no torch counterpart: the port's hand-off
between cards is a copy ordered by events (``runtime/executor.handoff``),
and its overlapped, double-buffered form is ``ROADMAP.md`` queue 1, item
2 (ii).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

__all__ = ["Mesh", "AXES", "production_mesh", "make_mesh"]

AXES = ("pod", "data", "model")


@dataclass(frozen=True)
class Mesh:
    """A mesh's ``shape`` over its ``axes`` (a subset of :data:`AXES` in
    that order; a missing axis has size 1)."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in length")
        if len(set(self.axes)) != len(self.axes) or \
                any(a not in AXES for a in self.axes) or \
                list(self.axes) != [a for a in AXES if a in self.axes]:
            raise ValueError(f"axes {self.axes} must be distinct names of "
                             f"{AXES}, in that order")
        if any(int(n) < 1 for n in self.shape):
            raise ValueError(f"mesh sizes must be >= 1: {self.shape}")

    def size(self, axis: str) -> int:
        return dict(zip(self.axes, self.shape)).get(axis, 1)

    @property
    def n_pods(self) -> int:
        return self.size("pod")

    @property
    def d_p(self) -> int:
        return self.size("data")

    @property
    def d_s(self) -> int:
        return self.size("model")

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the dry-run's mesh tag."""
        return "x".join(str(n) for n in self.shape)


def production_mesh(multi_pod: bool = False) -> Mesh:
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    with ``multi_pod`` ``(2, 16, 16)`` over ``("pod", "data", "model")``."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """Any mesh (tests, elastic rescale)."""
    return Mesh(tuple(int(n) for n in shape), tuple(axes))
