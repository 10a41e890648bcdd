"""seamless-m4t-large-v2 [audio]: enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. Backbone only — the speech
feature extractor is a stub providing precomputed frame embeddings.
[arXiv:2308.11596; hf]
"""

from repro_torch.core.plan import ModelSpec
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        spec=ModelSpec(
            name="seamless-m4t-v2",
            n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
            d_ff=8192, vocab=256206,
            is_encoder_decoder=True, n_encoder_layers=24,
        ),
        rope_kind="none",
        tie_embeddings=True,
        frontend="audio",
        is_encoder_decoder=True,
    )
