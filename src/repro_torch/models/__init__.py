from .config import ArchConfig, LayerKind
from .model import DecoderLM, LayerCtx, layer_params

__all__ = ["ArchConfig", "DecoderLM", "LayerCtx", "LayerKind",
           "layer_params"]
