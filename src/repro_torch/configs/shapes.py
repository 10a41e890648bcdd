"""Assigned input shapes (one set, shared by all ten LM-family archs).

  train_4k     seq_len=4,096   global_batch=256   -> train_step
  prefill_32k  seq_len=32,768  global_batch=32    -> prefill_step
  decode_32k   seq_len=32,768  global_batch=128   -> serve_step (1 new token)
  long_500k    seq_len=524,288 global_batch=1     -> serve_step, sub-quadratic
                                                     archs only (see DESIGN.md)

A copy of the JAX package's ``configs/shapes.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

__all__ = ["ShapeSpec", "SHAPES"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"
    needs_subquadratic: bool = False


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode",
                           needs_subquadratic=True),
}
