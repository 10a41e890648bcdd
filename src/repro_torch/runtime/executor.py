"""The pipeline executor: walks every stage's action list in one process.

Counterpart of the JAX package's ``runtime/executor.py``
(``run_stage_program``, ``ppermute_streams``, ``remat_tick_count``). The
reference is one controller too: a lockstep scan over every stage's
ticks, streams handed on by ``ppermute``, the backward its autodiff
transpose. Here :class:`PipelineExecutor` runs the lists of
:mod:`.program` in a dependency-driven, deterministic order:

* a stage's next action runs once its inputs exist: the upstream stream
  for ``F``; the downstream gradient for ``B`` (the loss's own seed at the
  last virtual stage) and, for a chunk whose sequence continues, the
  carry's gradient, which the stage itself holds once the later chunk's
  ``B`` has run; ``W`` after its ``B``;
* among the stages whose next action can run, the lowest runs first;
* when none can run, it raises, naming each stage's stuck action.

Streams move along ``core/schedule.stream_perm`` (a ring when ``v > 1``),
gradients the other way; a stream is a tensor, or a tuple of them (the
encoder-decoder hands on the pair ``(h_enc, h_dec)``, and the gradients
of both back). A hand-off between stages on one card passes the
tensor itself; between cards it is a ``.to(card, non_blocking=True)``
after the receiving card's stream waits on an event recorded on the
sender's. The stages only talk through these hand-offs, so a driver with
one process per stage can run the same stage bodies.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.schedule import stream_perm

from .program import Action

__all__ = ["PipelineExecutor", "remat_tick_count", "handoff"]


def remat_tick_count(table: Sequence[Sequence[int]], p: int, k: int, *,
                     v: int = 1, l_max: int) -> int:
    """The remat depth of stage ``p``'s virtual stage on chunk ``k``: the
    plan's ``table[p][k]`` split ``ceil(l / v)`` over the ``v`` virtual
    stages (the reference's memory-safe rounding), at most ``l_max``
    (the block's layer slots)."""
    return min(-(-int(table[p][k]) // v), l_max)


def handoff(t: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """``t`` on ``dst``: itself on the same device; otherwise a copy that
    ``dst``'s current stream orders after the sender's work so far."""
    if t.device == dst:
        return t
    if t.is_cuda and dst.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(dst).wait_event(ev)
    return t.to(dst, non_blocking=True)


class PipelineExecutor:
    """Runs one pipeline's per-stage action lists over ``stages``.

    ``stages[p]`` provides ``forward(k, j, x) -> stream or None`` (None at
    the last virtual stage, which folds the loss), ``backward(k, j, g) ->
    stream gradient or None`` (None at the first virtual stage),
    ``weight_grads(k, j)``, ``carry_grad_ready(k, j) -> bool`` and
    ``device``. ``stats`` counts the hand-offs and their bytes, and the
    bytes copied between cards."""

    def __init__(self, stages: Sequence, programs: List[List[Action]], *,
                 v: int = 1):
        if len(stages) != len(programs):
            raise ValueError(f"{len(programs)} action lists for "
                             f"{len(stages)} stages")
        self.stages, self.programs, self.v = stages, programs, v
        self.d_p = len(stages)
        self.links = set(stream_perm(self.d_p, ring=v > 1))
        self.stats = {"handoffs": 0, "handoff_bytes": 0, "copied_bytes": 0}
        self._fwd: Dict[Tuple[int, int], torch.Tensor] = {}
        self._bwd: Dict[Tuple[int, int], torch.Tensor] = {}

    def run(self) -> None:
        ptr = [0] * self.d_p
        left = sum(len(p) for p in self.programs)
        while left:
            for p in range(self.d_p):
                if ptr[p] < len(self.programs[p]) and \
                        self._ready(p, self.programs[p][ptr[p]]):
                    break
            else:
                stuck = {p: self.programs[p][ptr[p]]
                         for p in range(self.d_p)
                         if ptr[p] < len(self.programs[p])}
                raise RuntimeError(f"pipeline stuck: no stage can run its "
                                   f"next action {stuck}")
            self._run(p, self.programs[p][ptr[p]])
            ptr[p] += 1
            left -= 1
        if self._fwd or self._bwd:
            raise RuntimeError(f"hand-offs never taken: "
                               f"{sorted(self._fwd)} {sorted(self._bwd)}")

    # ------------------------------------------------------------------
    def _s(self, p: int, a: Action) -> int:
        return a.vstage * self.d_p + p

    def _ready(self, p: int, a: Action) -> bool:
        s = self._s(p, a)
        if a.op == "F":
            return s == 0 or (s, a.chunk) in self._fwd
        if a.op == "B":
            last = s == self.d_p * self.v - 1
            return (last or (s, a.chunk) in self._bwd) and \
                self.stages[p].carry_grad_ready(a.chunk, a.vstage)
        return True

    def _run(self, p: int, a: Action) -> None:
        s, k, st = self._s(p, a), a.chunk, self.stages[p]
        if a.op == "F":
            y = st.forward(k, a.vstage, self._fwd.pop((s, k), None))
            if y is not None:
                self._send_stream(s, k, y)
        elif a.op == "B":
            g = st.backward(k, a.vstage, self._bwd.pop((s, k), None))
            if g is not None:
                self._send_grad(s, k, g)
        else:
            st.weight_grads(k, a.vstage)

    def _send_stream(self, s: int, k: int, y: torch.Tensor) -> None:
        """Virtual stage ``s``'s output for chunk ``k`` to ``s + 1``."""
        self._fwd[(s + 1, k)] = self._move(s, s + 1, y)

    def _send_grad(self, s: int, k: int, g: torch.Tensor) -> None:
        """The gradient of virtual stage ``s``'s input to ``s - 1``."""
        self._bwd[(s - 1, k)] = self._move(s, s - 1, g)

    def _move(self, s: int, t: int, x):
        """One hand-off: a tensor, or a tuple of streams (None where a
        stage hands on no such stream: the encoder-decoder's pair)."""
        p, q = s % self.d_p, t % self.d_p
        if self.d_p > 1 and ((p, q) if t > s else (q, p)) not in self.links:
            raise RuntimeError(f"no hand-off from stage {p} to {q}")
        dst = self.stages[q].device
        self.stats["handoffs"] += 1
        parts = x if isinstance(x, tuple) else (x,)
        for e in parts:
            if e is None:
                continue
            nbytes = e.numel() * e.element_size()
            self.stats["handoff_bytes"] += nbytes
            if e.device != dst:
                self.stats["copied_bytes"] += nbytes
        moved = tuple(None if e is None else handoff(e, dst) for e in parts)
        return moved if isinstance(x, tuple) else moved[0]
