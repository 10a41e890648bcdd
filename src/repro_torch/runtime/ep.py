"""Expert parallelism over an SP group's ranks.

Counterpart of the JAX package's ``runtime/ep.py`` (``make_moe_ep``, the
"gather" dispatch; its all-to-all dispatch is not implemented there
either). The group's token blocks are gathered; rank ``r`` routes every
token (the router is replicated) and runs its ``E / d`` experts
``[r E / d, (r + 1) E / d)`` over every token routed to them, through the
MoE block's dispatch (``models/moe.routed_experts``: one product per
non-empty expert, the experts' rows views of the stage's one copy of the
stacked weights); the float32 partial sums are reduce-scattered back to
the token blocks, cast to the compute dtype, and each rank adds its shared
experts on its own rows. Exact: no capacity, no dropped tokens.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from . import sp

__all__ = ["make_moe_ep"]


def make_moe_ep(d: int) -> Callable:
    """``moe_fn(cfg, p, xs) -> ys`` over a group of ``d`` ranks' normed rows
    ``xs`` (``d`` must divide the expert count)."""

    def moe_fn(cfg, p: Dict, xs: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        from repro_torch.models.layers import swiglu_apply
        from repro_torch.models.moe import routed_experts
        s = cfg.spec
        if s.n_experts % d:
            raise ValueError(f"expert parallelism over {d} ranks needs "
                             f"n_experts % {d} == 0, got {s.n_experts}")
        e_loc = s.n_experts // d
        x_full = sp.all_gather(xs)
        parts = [routed_experts(cfg, p, x_full,
                                experts=(r * e_loc, (r + 1) * e_loc))
                 for r in range(d)]
        ys = [y.to(x.dtype) for y, x in zip(
            sp.reduce_scatter(parts, [x.shape[0] for x in xs]), xs)]
        if s.n_shared_experts > 0:
            ys = [y + swiglu_apply(p["shared"], x) for y, x in zip(ys, xs)]
        return ys

    return moe_fn
