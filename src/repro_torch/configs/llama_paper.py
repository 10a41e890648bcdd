"""The paper's own evaluation models: LLaMA-series 7B / 13B / 30B
(§V-A workloads), used by the paper-figure benchmarks with the paper's
A800 cluster spec (4 nodes x 8 GPUs; SP intra-node d_s=8, PP inter-node).

The JAX package's ``configs/llama_paper.py`` on the port's specs. The
port's :class:`~repro_torch.core.plan.ClusterSpec` names the two links
``link_bw`` (the reference's ``ici_bw``) and ``net_bw`` (its ``dcn_bw``).
Like the reference's, these configs are not in the registry: they are
cost-model inputs.
"""

from repro_torch.core.plan import ClusterSpec, ModelSpec
from repro_torch.models.config import ArchConfig

__all__ = ["llama_7b", "llama_13b", "llama_30b", "paper_cluster"]


def llama_7b() -> ArchConfig:
    return ArchConfig(spec=ModelSpec(
        name="llama-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=32, head_dim=128, d_ff=11008, vocab=32000,
        tie_embeddings=False))


def llama_13b() -> ArchConfig:
    return ArchConfig(spec=ModelSpec(
        name="llama-13b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=40, head_dim=128, d_ff=13824, vocab=32000,
        tie_embeddings=False))


def llama_30b() -> ArchConfig:
    return ArchConfig(spec=ModelSpec(
        name="llama-30b", n_layers=60, d_model=6656, n_heads=52,
        n_kv_heads=52, head_dim=128, d_ff=17920, vocab=32000,
        tie_embeddings=False))


def paper_cluster(d_p: int = 4, d_s: int = 8) -> ClusterSpec:
    """4x8 A800-80GB: NVLink 400GB/s intra-node, 400Gb/s IB inter-node."""
    return ClusterSpec(d_p=d_p, d_s=d_s, n_pods=1,
                       flops_per_chip=312e12,      # A800 bf16
                       hbm_bytes=80e9, hbm_bw=2.0e12,
                       link_bw=200e9,              # NVLink per direction
                       net_bw=50e9)                # 400Gb/s IB
