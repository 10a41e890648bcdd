"""Expert parallelism over a stage's sequence-parallel ranks.

Counterpart of the JAX package's ``runtime/ep.py`` (``make_moe_ep``, the
"gather" dispatch; its all-to-all dispatch is not implemented there
either). The group's token blocks are gathered; the router (a ZeRO-3
gathered weight) routes every token, and each rank that owns experts runs
its own block of them over every token routed to them, through the MoE
block's dispatch (``models/moe.routed_experts``: one product per
non-empty expert). Under ZeRO-3 the expert weights arrive as the tuple of
the ranks' shards along the expert dim (``runtime/sharding.EP_PATH_RE``,
never gathered): rank ``m`` of the full ``d_s`` runs experts ``[m E /
d_s, (m + 1) E / d_s)``, as the reference's EP spans the full model axis
at any ``d_s_eff``; a whole stacked weight (no ZeRO-3) splits into the
group's ``d`` ranks' blocks of views. The float32 partial sums are
reduce-scattered back to the group's token blocks, cast to the compute
dtype, and each rank adds its shared experts on its own rows. Exact: no
capacity, no dropped tokens.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from . import sp

__all__ = ["make_moe_ep", "moe_decode"]


def make_moe_ep(d: int) -> Callable:
    """``moe_fn(cfg, p, xs) -> ys`` over a group of ``d`` ranks' normed rows
    ``xs`` (the owners of the experts: the shards' count, else ``d``, must
    divide the expert count)."""

    def moe_fn(cfg, p: Dict, xs: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        from repro_torch.models.layers import swiglu_apply
        from repro_torch.models.moe import routed_experts
        s = cfg.spec
        sharded = isinstance(p["w_gate"], (list, tuple))
        n = len(p["w_gate"]) if sharded else d
        if s.n_experts % n:
            raise ValueError(f"expert parallelism over {n} ranks needs "
                             f"n_experts % {n} == 0, got {s.n_experts}")
        e_loc = s.n_experts // n
        x_full = sp.all_gather(xs)
        parts = []
        for r in range(n):
            pr = p if not sharded else dict(
                p, **{k: p[k][r] for k in ("w_gate", "w_up", "w_down")})
            parts.append(routed_experts(cfg, pr, x_full,
                                        experts=(r * e_loc, (r + 1) * e_loc)))
        ys = [y.to(x.dtype) for y, x in zip(
            sp.reduce_scatter(parts, [x.shape[0] for x in xs]), xs)]
        if s.n_shared_experts > 0:
            ys = [y + swiglu_apply(p["shared"], x) for y, x in zip(ys, xs)]
        return ys

    return moe_fn


def moe_decode(cfg, p: Dict, x: torch.Tensor, d: int) -> torch.Tensor:
    """The MoE block on a decode step's rows ``x [bm, D]`` over ``d`` ranks,
    as the reference's ``make_moe_ep`` serves its ``decode_step_fn``: every
    rank holds the same rows, so each rank's block of experts runs over
    the ``d`` gathered copies and the reduce-scatter hands each rank its
    copy's sums; rank 0's is returned (one rank: the routed block)."""
    if d == 1:
        from repro_torch.models.moe import moe_apply
        return moe_apply(cfg, p, x)
    return make_moe_ep(d)(cfg, p, [x] * d)[0]
