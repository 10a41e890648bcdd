"""InfiniPipe cost model, cut to what the serving slice needs.

A jax-free copy of the JAX package's analytic Eq. 1 coefficients and of
``CostModel.split_balanced`` (Alg. 1 line 1), which chunked prefill uses
to slice a prompt into workload-balanced chunks
(:func:`repro_torch.core.chunking.prompt_slices`). The planner's memory,
communication and recompute terms are ported with the training slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

from .plan import ClusterSpec, Coefficients, ModelSpec

__all__ = ["CostModel", "analytic_coefficients"]


def _linear_flops_per_token(m: ModelSpec) -> float:
    """Forward FLOPs per token that do NOT depend on context length (every
    matmul at 2 FLOPs per MAC, vocabulary head included)."""
    D, Dh, Hq, Hkv = m.d_model, m.head_dim, m.n_heads, m.n_kv_heads
    per_layer = 0.0
    if not m.attn_free:
        if m.kv_lora_rank > 0:
            r, rr = m.kv_lora_rank, m.qk_rope_dim
            per_layer += 2 * D * (Hq * (Dh + rr))
            per_layer += 2 * D * (r + rr)
            per_layer += 2 * r * (Hq * Dh * 2)
            per_layer += 2 * Hq * Dh * D
        else:
            per_layer += 2 * D * Hq * Dh
            per_layer += 2 * 2 * D * Hkv * Dh
            per_layer += 2 * Hq * Dh * D
    if m.ssm_state > 0:
        di, ds = m.d_inner or 2 * m.d_model, m.ssm_state
        per_layer += 2 * D * 2 * di
        per_layer += 2 * m.ssm_conv * di
        per_layer += 2 * di * (2 * ds + 2)
        per_layer += 9 * di * ds
        per_layer += 2 * di * D
    if m.n_experts > 0:
        per_layer += 2 * D * m.n_experts
        act = m.top_k + m.n_shared_experts
        per_layer += 2 * 3 * D * m.d_ff_expert * act
    elif m.d_ff > 0:
        per_layer += 2 * 3 * D * m.d_ff
    total = m.n_layers * per_layer
    total += 2 * D * m.vocab
    return total


def _attn_flops_per_token_pair(m: ModelSpec) -> float:
    """Forward FLOPs per (query, key) pair over the global layers."""
    if m.attn_free:
        return 0.0
    return 4.0 * m.n_heads * m.head_dim * m.n_global_layers()


def _local_attn_flops_per_token(m: ModelSpec) -> float:
    """Sliding-window layers: attention FLOPs per token (window-capped)."""
    if m.attn_free or m.local_window <= 0:
        return 0.0
    return 4.0 * m.n_heads * m.head_dim * m.n_local_layers() * m.local_window


def analytic_coefficients(m: ModelSpec, c: ClusterSpec) -> Coefficients:
    """Eq. 1's alpha1 (quadratic) and alpha2 (linear) from FLOP counts."""
    lin = _linear_flops_per_token(m) + _local_attn_flops_per_token(m)
    quad = _attn_flops_per_token_pair(m)
    return Coefficients(alpha1=quad / c.effective_flops,
                        alpha2=lin / c.effective_flops)


@dataclass
class CostModel:
    model: ModelSpec
    cluster: ClusterSpec
    coeffs: Optional[Coefficients] = None

    def __post_init__(self) -> None:
        if self.coeffs is None:
            self.coeffs = analytic_coefficients(self.model, self.cluster)

    def split_balanced(self, length: int, k: int) -> List[int]:
        """Slice ``length`` into K slices of (approximately) equal cost
        under the quadratic attention model. Earlier slices are longer
        (they have less context), the tail is shortest — the paper's mesh.

        Closed form: slice boundaries are at equal increments of the
        cumulative cost function  g(x) = 0.5*alpha1*x^2 + alpha2*x.
        """
        if k <= 1 or length <= 0:
            return [length] if length > 0 else []
        a1 = self.coeffs.alpha1 * 0.5
        a2 = self.coeffs.alpha2
        total = a1 * length ** 2 + a2 * length
        bounds = [0]
        for i in range(1, k):
            target = total * i / k
            if a1 > 0:
                x = (-a2 + math.sqrt(a2 * a2 + 4 * a1 * target)) / (2 * a1)
            else:
                x = target / a2 if a2 > 0 else length * i / k
            bounds.append(int(round(x)))
        bounds.append(length)
        # enforce monotone, nonzero slices (tiny sequences & large K)
        out: List[int] = []
        prev = 0
        for b in bounds[1:]:
            b = max(b, prev + 1) if b < length else b
            b = min(b, length)
            if b > prev:
                out.append(b - prev)
            prev = b
        if sum(out) != length:  # absorb rounding into the tail
            out[-1] += length - sum(out)
        return [s for s in out if s > 0]
