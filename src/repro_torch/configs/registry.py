"""Architecture registry: --arch <id> resolution for the port's launchers.

Holds the architectures the port serves so far; the others join with the
model families they need.
"""

from typing import Callable, Dict, List

from repro_torch.models.config import ArchConfig

from . import gemma3_1b, llama32_3b

__all__ = ["ARCHS", "get_arch", "arch_names"]

ARCHS: Dict[str, Callable[[], ArchConfig]] = {
    "gemma3-1b": gemma3_1b.config,
    "llama3.2-3b": llama32_3b.config,
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]()


def arch_names() -> List[str]:
    return list(ARCHS)
