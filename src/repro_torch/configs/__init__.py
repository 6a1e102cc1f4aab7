"""Architecture registry of the port.

Every ported module defines ``CONFIG`` (the full published numbers) and
``SMOKE`` (a reduced config of the same family for CPU tests), copied
from the reference's ``configs/``.  ``get(name)`` returns the full
config, ``get_smoke(name)`` the reduced one; both take the module name
or its external id (``ALIASES``).  ``PORTED`` lists the architectures
ported so far; any other raises.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

PORTED = ("rwkv6_1_6b", "tinyllama_1_1b")

# canonical external ids → module names
ALIASES = {
    "qwen2.5-32b": "qwen2_5_32b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "llama3-405b": "llama3_405b",
    "granite-3-8b": "granite_3_8b",
    "dbrx-132b": "dbrx_132b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llava-next-34b": "llava_next_34b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "hymba-1.5b": "hymba_1_5b",
}


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in PORTED:
        raise NotImplementedError(f"architecture {name!r} is not ported yet; the port has "
                                  f"{list(PORTED)} (ROADMAP §1 item 7)")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
