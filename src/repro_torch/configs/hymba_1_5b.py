"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, parallel attention + mamba heads, ssm_state=16.
[arXiv:2411.13676; hf]
"""

from repro_torch.core.plan import ModelSpec
from repro_torch.models.config import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        spec=ModelSpec(
            name="hymba-1.5b",
            n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
            d_ff=5504, vocab=32001,
            ssm_state=16, d_inner=3200, hybrid_parallel=True,
        ),
        rope_theta=10_000.0,
        layer_kind=LayerKind.HYBRID,
        tie_embeddings=True,
        supports_long_decode=True,  # hybrid: SSM path is O(1) in context
    )
