"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff(expert)=1024
vocab=50304, 64 experts top-8. [arXiv:2409.02060; hf]
"""

from repro_torch.core.plan import ModelSpec
from repro_torch.models.config import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        spec=ModelSpec(
            name="olmoe-1b-7b",
            n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
            d_ff=1024, vocab=50304,
            n_experts=64, top_k=8, d_ff_expert=1024,
        ),
        rope_theta=10_000.0,
        layer_kind=LayerKind.MOE,
        tie_embeddings=False,
    )
