"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256. [hf:meta-llama/Llama-3.2-3B; unverified]
"""

from repro_torch.core.plan import ModelSpec
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        spec=ModelSpec(
            name="llama3.2-3b",
            n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
            d_ff=8192, vocab=128256,
        ),
        rope_theta=500_000.0,
        tie_embeddings=True,
    )
