"""Int8 gradient compression with error feedback for the all-reduce over
pods (data-parallel replicas of the pipeline).

Counterpart of the JAX package's ``optim/compression.py``. The reference
runs inside ``shard_map`` with a ``"pod"`` axis; the port holds the pods as
a list (one process, as the sequence-parallel ranks), so each function
takes one tensor per pod. Per leaf: ``g + err`` in float32, a symmetric
scale ``max|.| / 127`` maxed over the pods (every pod quantises with the
same scale) and floored at ``1e-30``, ``round`` (half to even, as
``jnp.round``) clipped to ``±127`` and cast to int8, the residual kept as
the pod's next error, the int8 values summed in int32 and multiplied by
the scale. The reference's bits, pod for pod.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.models.model import tree_leaves, tree_map, tree_unflatten

__all__ = ["init_error_state", "q8_psum", "compressed_psum", "q8_scale"]


def init_error_state(grads):
    """Zero float32 errors shaped as ``grads`` (a tree)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def q8_scale(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]
             ) -> torch.Tensor:
    """The pods' shared scale of one leaf: ``max |g + err| / 127`` maxed
    over the pods, at least ``1e-30``."""
    scale = None
    for g, e in zip(gs, errs):
        s = (g.float() + e).abs().max() / 127.0
        scale = s if scale is None else torch.maximum(scale, s)
    return torch.clamp(scale, min=1e-30)


def q8_psum(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One leaf over the pods (``gs[q]``, ``errs[q]``: pod ``q``'s gradient
    and error): ``(the float32 sum, each pod's new error)``, the
    reference's ``_q8_psum``."""
    scale = q8_scale(gs, errs)
    total, new_err = None, []
    for g, e in zip(gs, errs):
        g32 = g.float() + e
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        new_err.append(g32 - q.float() * scale)
        q32 = q.to(torch.int32)
        total = q32 if total is None else total + q32
    return total.float() * scale, new_err


def compressed_psum(grads_per_pod: Sequence, err_per_pod: Sequence):
    """The sum over pods of ``grads_per_pod`` (one tree a pod) through int8
    with error feedback: ``(the summed float32 tree, each pod's new error
    tree)``, leaf by leaf (:func:`q8_psum`)."""
    flat = [tree_leaves(g) for g in grads_per_pod]
    errs = [tree_leaves(e) for e in err_per_pod]
    summed, new = [], [[] for _ in flat]
    for i in range(len(flat[0])):
        s, ne = q8_psum([f[i] for f in flat], [e[i] for e in errs])
        summed.append(s)
        for out, x in zip(new, ne):
            out.append(x)
    template = grads_per_pod[0]
    return (tree_unflatten(template, summed),
            [tree_unflatten(template, n) for n in new])
