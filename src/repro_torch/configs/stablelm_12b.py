"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b; hf]
"""

from repro_torch.core.plan import ModelSpec
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        spec=ModelSpec(
            name="stablelm-12b",
            n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
            d_ff=13824, vocab=100352,
        ),
        rope_theta=10_000.0,
        tie_embeddings=False,
    )
