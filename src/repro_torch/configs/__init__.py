from .registry import ARCHS, arch_names, get_arch

__all__ = ["ARCHS", "arch_names", "get_arch"]
