"""LM substrate of the port: the RWKV-6 model (``kind="rwkv"``) on the
hand-written chunked-WKV kernel, and the dense GQA transformer
(``kind="dense"``) on the hand-written flash-attention kernel, which
also trains."""
from .config import ModelConfig
from .lm import Model, layer_views, stack_layers

__all__ = ["Model", "ModelConfig", "layer_views", "stack_layers"]
