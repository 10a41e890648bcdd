from .config import ArchConfig, LayerKind
from .encdec import EncDecLM
from .model import DecoderLM, LayerCtx, layer_params, unstack_layers

__all__ = ["ArchConfig", "DecoderLM", "EncDecLM", "LayerCtx", "LayerKind",
           "layer_params", "unstack_layers"]
