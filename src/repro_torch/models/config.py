"""Architecture configuration shared by the model code, configs/ and launch/.

``ArchConfig`` embeds the cost model's :class:`~repro_torch.core.ModelSpec`
and adds the executor-facing details (rope, norms, layer patterns). A
jax-free copy of the JAX package's ``models/config.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.core.plan import ModelSpec

__all__ = ["ArchConfig", "LayerKind"]


class LayerKind:
    ATTN = "attn"            # attention + MLP block
    MAMBA = "mamba"          # mamba mixer only
    HYBRID = "hybrid"        # parallel attn + mamba heads, then MLP
    MOE = "moe"              # attention + MoE block


@dataclass(frozen=True)
class ArchConfig:
    spec: ModelSpec
    # --- attention details ---
    rope_theta: float = 10000.0
    rope_kind: str = "rope"        # "rope" | "mrope" | "none"
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    rms_eps: float = 1e-6
    # sliding-window pattern: window size for "local" layers; 0 => all global
    local_window: int = 0
    local_global_ratio: int = 0    # N locals per 1 global; 0 => all global
    # --- families ---
    layer_kind: str = LayerKind.ATTN
    # --- embeddings ---
    tie_embeddings: bool = True
    embed_scale: bool = False      # gemma multiplies embeddings by sqrt(D)
    frontend: str = "none"
    is_encoder_decoder: bool = False
    supports_long_decode: bool = False

    @property
    def name(self) -> str:
        return self.spec.name

    def layer_window(self, idx: int) -> int:
        """Sliding window for layer ``idx`` (0 = full/global attention).

        gemma3 pattern: ``ratio`` local layers followed by 1 global layer.
        """
        if self.local_window <= 0:
            return 0
        if self.local_global_ratio <= 0:
            return self.local_window
        period = self.local_global_ratio + 1
        return 0 if (idx % period == period - 1) else self.local_window

    def layer_windows(self) -> List[int]:
        return [self.layer_window(i) for i in range(self.spec.n_layers)]

    def with_layers(self, n_layers: int) -> "ArchConfig":
        """The same model cut to ``n_layers`` layers, every width kept."""
        if n_layers < 1:
            raise ValueError(f"n_layers must be >= 1, got {n_layers}")
        return dataclasses.replace(self, spec=dataclasses.replace(
            self.spec, n_layers=n_layers))

    def reduced(self, *, n_layers: int = 4, d_model: int = 64,
                n_heads: int = 4, head_dim: int = 16, vocab: int = 512
                ) -> "ArchConfig":
        """A small same-family config for CPU tests (the same cut as the
        JAX package's ``ArchConfig.reduced``)."""
        s = self.spec
        kv = max(1, min(s.n_kv_heads, n_heads // 2)) if not s.attn_free else 0
        new_spec = dataclasses.replace(
            s,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads if not s.attn_free else 4,
            n_kv_heads=kv if not s.attn_free else 4,
            head_dim=head_dim,
            d_ff=0 if s.d_ff == 0 else d_model * 3,
            vocab=vocab,
            n_experts=4 if s.n_experts else 0,
            n_shared_experts=1 if s.n_shared_experts else 0,
            top_k=2 if s.top_k else 0,
            d_ff_expert=d_model if s.n_experts else 0,
            kv_lora_rank=16 if s.kv_lora_rank else 0,
            qk_rope_dim=8 if s.kv_lora_rank else 0,
            ssm_state=4 if s.ssm_state else 0,
            d_inner=2 * d_model if s.ssm_state else 0,
            n_encoder_layers=n_layers if s.is_encoder_decoder else 0,
        )
        return dataclasses.replace(
            self, spec=new_spec,
            local_window=min(self.local_window, 8) if self.local_window
            else 0,
            mrope_sections=(4, 2, 2) if self.rope_kind == "mrope"
            else self.mrope_sections,
        )
