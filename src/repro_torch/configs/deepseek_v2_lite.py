"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (MLA kv_lora=512,
qk_rope=64) d_ff(expert)=1408 vocab=102400, 64 routed experts top-6 + 2
shared. All layers MoE, as the JAX package's config has them (the HF
model's dense first layer is homogenized for stage stacking).
[arXiv:2405.04434; hf]
"""

from repro_torch.core.plan import ModelSpec
from repro_torch.models.config import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        spec=ModelSpec(
            name="deepseek-v2-lite",
            n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
            d_ff=1408, vocab=102400,
            n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
            kv_lora_rank=512, qk_rope_dim=64,
        ),
        rope_theta=10_000.0,
        layer_kind=LayerKind.MOE,
        tie_embeddings=False,
    )
