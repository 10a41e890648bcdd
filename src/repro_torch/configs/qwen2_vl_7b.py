"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE, dynamic resolution. Backbone only — the ViT tower is a
stub providing precomputed patch embeddings (models/frontends.py).
[arXiv:2409.12191; hf]
"""

from repro_torch.core.plan import ModelSpec
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        spec=ModelSpec(
            name="qwen2-vl-7b",
            n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
            d_ff=18944, vocab=152064,
        ),
        rope_theta=1_000_000.0,
        rope_kind="mrope", mrope_sections=(16, 24, 24),
        tie_embeddings=False,
        frontend="vision",
    )
