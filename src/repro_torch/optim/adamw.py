"""AdamW with float32 master weights, m and v.

Counterpart of the JAX package's ``optim/adamw.py`` on one card (``d_p =
d_s = 1``, so no shard sums the norm): live parameters stay in the compute
dtype (bf16 for full-size training), the master copy and both moments are
float32, gradients are clipped to ``grad_clip`` by their global norm, and
the learning rate follows linear warm-up then cosine decay. Unlike the
functional reference, the update runs in place on the state tensors and
the live parameters (under ``torch.no_grad``), which keeps one copy of
each on the card, a block of rows at a time (:data:`UPDATE_BLOCK`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.model import tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "lr_schedule", "global_norm",
           "square_sum", "adamw_update", "UPDATE_BLOCK"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init_opt_state(params) -> Dict[str, Any]:
    """Master = a float32 copy of the live parameters; zero moments."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    return {"master": master, "m": zeros(), "v": zeros(), "step": 0}


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


# AdamW's update and the gradients' norm walk each leaf in blocks of at
# most this many elements (slices of its rows), so their float32
# temporaries stay a block's: the planner charges the model states (bf16,
# master, m, v, gradient sum) and nothing for either, and whole-leaf
# temporaries of gemma3-1b's 262,144 x 1,152 tied embedding (1.2 GB in
# float32, a copy on each end stage of a pipeline) put a 2x1 step of 2
# layers 4.3 GB over its plan on the H100. Elementwise on slices, the
# update's bits are the whole leaf's; the norm's sum runs in blocks.
UPDATE_BLOCK = 1 << 24


def _blocks(a: torch.Tensor):
    """Indices of ``a``'s blocks: slices of its leading axis of at most
    :data:`UPDATE_BLOCK` elements each (the whole of a 0-d or small
    leaf)."""
    if a.dim() == 0 or a.numel() <= UPDATE_BLOCK:
        return [...]
    rows = max(1, UPDATE_BLOCK // max(1, a[0].numel()))
    return [slice(i, i + rows) for i in range(0, a.shape[0], rows)]


def square_sum(a: torch.Tensor) -> torch.Tensor:
    """The float32 sum of ``a``'s squares, a block of rows at a time
    (:func:`_blocks`: no temporary larger than a block)."""
    out = torch.zeros((), dtype=torch.float32, device=a.device)
    for sl in _blocks(a):
        out = out + a[sl].float().square().sum()
    return out


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (float32 scalar)."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        sq = sq + square_sum(g)
    return sq.sqrt()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, *,
                 grad_scale: float = 1.0,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict, Dict]:
    """One AdamW step. ``grad_scale`` rescales summed-loss gradients to
    per-token means (1 / n_valid); ``gnorm``, if given, is the unscaled
    gradients' global norm. Updates ``state`` and ``params`` in place and
    returns them with ``{"grad_norm", "lr"}``."""
    step = state["step"] + 1
    g_leaves = [g.float() if grad_scale == 1.0 else g.float() * grad_scale
                for g in tree_leaves(grads)]
    gnorm = (global_norm(g_leaves) if gnorm is None
             else gnorm.float() * grad_scale)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    for leaves in zip(tree_leaves(params), g_leaves,
                      tree_leaves(state["master"]), tree_leaves(state["m"]),
                      tree_leaves(state["v"])):
        for sl in _blocks(leaves[0]):
            p, g, mast, m, v = (a[sl] for a in leaves)
            g = g * clip
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = ((m / c1) / ((v / c2).sqrt() + cfg.eps)
                   + cfg.weight_decay * mast)
            mast.sub_(lr * upd)
            p.copy_(mast)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
