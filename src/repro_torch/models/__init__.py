from .config import ArchConfig, LayerKind
from .model import DecoderLM, LayerCtx, layer_params, unstack_layers

__all__ = ["ArchConfig", "DecoderLM", "LayerCtx", "LayerKind",
           "layer_params", "unstack_layers"]
