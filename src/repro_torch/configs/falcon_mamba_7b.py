"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free mamba-1, d_inner=8192,
ssm_state=16, vocab=65024. [arXiv:2410.05355; unverified]
"""

from repro_torch.core.plan import ModelSpec
from repro_torch.models.config import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        spec=ModelSpec(
            name="falcon-mamba-7b",
            n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
            d_ff=0, vocab=65024,
            ssm_state=16, d_inner=8192, attn_free=True,
        ),
        rope_kind="none",
        layer_kind=LayerKind.MAMBA,
        tie_embeddings=True,
        supports_long_decode=True,  # O(1)-state SSM
    )
