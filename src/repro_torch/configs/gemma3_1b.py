"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.core.plan import ModelSpec
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        spec=ModelSpec(
            name="gemma3-1b",
            n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
            d_ff=6912, vocab=262144,
            local_window=512, local_global_ratio=5,
        ),
        rope_theta=1_000_000.0,
        local_window=512, local_global_ratio=5,
        tie_embeddings=True, embed_scale=True,
        supports_long_decode=True,
    )
