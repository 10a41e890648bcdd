"""Architecture registry: --arch <id> resolution for the port's launchers.

Holds the architectures of the families the port has (dense attention,
SSM and hybrid, MoE, MLA); the others join with the model families they
need.
"""

from typing import Callable, Dict, List

from repro_torch.models.config import ArchConfig

from . import (deepseek_v2_lite, falcon_mamba_7b, gemma3_1b, hymba_1_5b,
               llama32_3b, olmoe_1b_7b)

__all__ = ["ARCHS", "get_arch", "arch_names"]

ARCHS: Dict[str, Callable[[], ArchConfig]] = {
    "gemma3-1b": gemma3_1b.config,
    "llama3.2-3b": llama32_3b.config,
    "olmoe-1b-7b": olmoe_1b_7b.config,
    "deepseek-v2-lite": deepseek_v2_lite.config,
    "hymba-1.5b": hymba_1_5b.config,
    "falcon-mamba-7b": falcon_mamba_7b.config,
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]()


def arch_names() -> List[str]:
    return list(ARCHS)
