"""AdamW with float32 master weights, m and v.

Counterpart of the JAX package's ``optim/adamw.py`` on one card (``d_p =
d_s = 1``, so no shard sums the norm): live parameters stay in the compute
dtype (bf16 for full-size training), the master copy and both moments are
float32, gradients are clipped to ``grad_clip`` by their global norm, and
the learning rate follows linear warm-up then cosine decay. Unlike the
functional reference, the update runs in place on the state tensors and
the live parameters (under ``torch.no_grad``), which keeps one copy of
each on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.model import tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "lr_schedule", "global_norm",
           "adamw_update"]


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


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (float32 scalar)."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        sq = sq + g.float().square().sum()
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
    for p, g, mast, m, v in zip(tree_leaves(params), g_leaves,
                                tree_leaves(state["master"]),
                                tree_leaves(state["m"]),
                                tree_leaves(state["v"])):
        g = g * clip
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / c1) / ((v / c2).sqrt() + cfg.eps) + cfg.weight_decay * mast
        mast.sub_(lr * upd)
        p.copy_(mast)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
