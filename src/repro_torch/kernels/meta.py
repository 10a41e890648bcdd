"""The kernels' meta route: what a kernel call costs, without a card.

On ``torch.device("meta")`` every wrapper of :mod:`.flash_attention`,
:mod:`.cross_entropy` and :mod:`.mamba_scan` takes the CUDA route's path
up to the launch: it checks the tensors as it would on the card, makes
the same outputs, workspaces and saved tensors (meta tensors: shapes and
dtypes, no memory), and in place of the launch books the call here with
the kernel's operations. It never runs the plain version, whose ``[T,
S]`` scores and ``[T, V]`` logits the kernels never hold. The wrappers'
``launches`` and ``by_kernel`` count the card's launches only.

Operations are the bound formulas of ``PERF.md`` §6:

* attention: ``2·Dk + 2·Dv`` per (query, key, head) for A; its backward's
  dq pass ``4·Dk + 2·Dv`` and dk/dv pass ``4·Dk + 4·Dv`` (the products
  each recomputes). Meta tensors carry no segments or positions, so the
  live pairs are those of the causal (or sliding-window) mask of the
  padded rows, the queries at the last rows of the keys
  (:func:`attention_pairs`); non-causal: every pair;
* cross-entropy: ``2·T·V·D`` per product, one in B, two in C1 and C2;
* the selective scan: 8 per (row, channel, state) for D, 16 for D′,
  booked on the function's main pass (D's emit pass, D′'s per-tile pass;
  the other passes book their calls with no operations).

The card's SM count decides the attention's key splits and the
cross-entropy's vocabulary splits; on meta it is the H100's,
:data:`H100_SMS`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["H100_SMS", "TALLY", "is_meta", "on_card", "tally", "reset",
           "snapshot", "attention_pairs"]

H100_SMS = 132              # SMs of an H100 SXM

# kernel name -> {"calls": n, "ops": operations} since the last reset
TALLY: Dict[str, Dict[str, float]] = {}


def is_meta(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "meta"


def on_card(t: torch.Tensor) -> bool:
    """The kernels' route: a CUDA tensor, or a meta one, which takes the
    same path up to the launch; a CPU tensor takes the plain version."""
    return t.is_cuda or t.device.type == "meta"


def tally(kernel: str, ops: float) -> None:
    """Book one call of ``kernel`` doing ``ops`` operations."""
    rec = TALLY.setdefault(kernel, {"calls": 0, "ops": 0.0})
    rec["calls"] += 1
    rec["ops"] += float(ops)


def reset() -> None:
    TALLY.clear()


def snapshot() -> Dict[str, Dict[str, float]]:
    return {k: dict(v) for k, v in TALLY.items()}


def attention_pairs(T: int, S: int, *, causal: bool, window: int = 0) -> int:
    """Live (query, key) pairs of one head over ``T`` query and ``S`` key
    rows with no segment data: every pair when not causal; causal, query
    ``i`` sits at key row ``S - T + i`` and sees the rows up to it (at
    most ``window`` of them when ``window > 0``)."""
    if not causal:
        n = np.full(T, S, dtype=np.int64)
    else:
        n = np.clip(np.arange(T, dtype=np.int64) + (S - T) + 1, 0, S)
    if window > 0:
        n = np.minimum(n, window)
    return int(n.sum())
