"""LM substrate of the port: the RWKV-6 model (``kind="rwkv"``) on the
hand-written chunked-WKV kernel."""
from .config import ModelConfig
from .lm import Model

__all__ = ["Model", "ModelConfig"]
