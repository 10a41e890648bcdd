"""Architecture registry: --arch <id> resolution for the port's launchers.

Holds every architecture of the JAX package's registry: the decoder
families (``models/model.DecoderLM``) and the encoder-decoder
seamless-m4t-v2 (``models/encdec.EncDecLM``).
"""

from typing import Callable, Dict, List

from repro_torch.models.config import ArchConfig

from . import (deepseek_v2_lite, falcon_mamba_7b, gemma3_1b, hymba_1_5b,
               llama32_3b, olmoe_1b_7b, qwen2_vl_7b, qwen3_4b,
               seamless_m4t_v2, stablelm_12b)

__all__ = ["ARCHS", "get_arch", "arch_names"]

ARCHS: Dict[str, Callable[[], ArchConfig]] = {
    "gemma3-1b": gemma3_1b.config,
    "llama3.2-3b": llama32_3b.config,
    "stablelm-12b": stablelm_12b.config,
    "qwen3-4b": qwen3_4b.config,
    "olmoe-1b-7b": olmoe_1b_7b.config,
    "deepseek-v2-lite": deepseek_v2_lite.config,
    "hymba-1.5b": hymba_1_5b.config,
    "qwen2-vl-7b": qwen2_vl_7b.config,
    "seamless-m4t-v2": seamless_m4t_v2.config,
    "falcon-mamba-7b": falcon_mamba_7b.config,
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]()


def arch_names() -> List[str]:
    return list(ARCHS)
