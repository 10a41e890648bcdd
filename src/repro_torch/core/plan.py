"""Specs shared by the cost model and the model code (host side, no torch).

A jax-free copy of the JAX package's ``core/plan.py`` specs, cut to what
the port's serving slice needs: :class:`ModelSpec` (the cost model's view
of an architecture), :class:`ClusterSpec` (the target hardware) and
:class:`Coefficients` (Eq. 1's cost coefficients).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ModelSpec", "ClusterSpec", "Coefficients"]


@dataclass(frozen=True)
class ModelSpec:
    """The subset of an architecture config the cost model needs.

    ``D`` = d_model, ``D_kv`` = total KV width (n_kv_heads * head_dim),
    ``L`` = n_layers, ``e`` = bytes per activation element.
    """

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # --- optional family extensions (not served by this slice) ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    attn_free: bool = False
    hybrid_parallel: bool = False
    local_window: int = 0         # sliding-window size for local layers
    local_global_ratio: int = 0   # N local layers per 1 global layer
    qk_norm: bool = False
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    tie_embeddings: bool = True
    bytes_per_act: int = 2        # e: bf16 activations

    def n_global_layers(self) -> int:
        """Number of full-attention (global) layers."""
        if self.attn_free:
            return 0
        if self.local_global_ratio <= 0:
            return self.n_layers
        period = self.local_global_ratio + 1
        return (self.n_layers + period - 1) // period

    def n_local_layers(self) -> int:
        if self.attn_free:
            return 0
        return self.n_layers - self.n_global_layers()


@dataclass(frozen=True)
class ClusterSpec:
    """Target hardware: one NVIDIA H100 SXM (989 TFLOP/s dense bf16,
    NVIDIA's data sheet). The mesh and memory terms join with the planner.
    ``split_balanced``, the only cost-model entry the serving slice calls,
    depends on the ratio of the model's quadratic and linear FLOP terms
    alone, so these rates do not move its output."""

    flops_per_chip: float = 989e12
    mfu: float = 0.5

    @property
    def effective_flops(self) -> float:
        return self.flops_per_chip * self.mfu


@dataclass
class Coefficients:
    """Eq. 1's whole-model cost coefficients.

    alpha1: seconds per (token-pair) of causal attention  [quadratic term]
    alpha2: seconds per token of position-independent work [linear term]
    """

    alpha1: float
    alpha2: float
