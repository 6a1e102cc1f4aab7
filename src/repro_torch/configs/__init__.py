"""Architecture registry of the port.

Every ported module defines ``CONFIG`` (the full published numbers) and
``SMOKE`` (a reduced config of the same family for CPU tests), copied
from the reference's ``configs/``.  ``get(name)`` returns the module's
``CONFIG``, ``get_smoke(name)`` its ``SMOKE``, whatever their type, as
the reference's do: a ``ModelConfig`` for an LM, the paper's own
``BoostConfig`` for ``paper_rbrt``.  Both take the module name or its
external id (``ALIASES``).  ``PORTED`` lists the configs, every one of
the reference's; any other name raises.
"""
from __future__ import annotations

import importlib
from typing import Any

PORTED = ("rwkv6_1_6b", "tinyllama_1_1b", "granite_3_8b", "qwen2_5_32b", "llama3_405b",
          "paper_rbrt", "hymba_1_5b", "dbrx_132b", "llama4_scout_17b_a16e",
          "seamless_m4t_medium", "llava_next_34b")

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
        raise ValueError(f"unknown architecture {name!r}; the port has {list(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str) -> Any:
    return _module(name).CONFIG


def get_smoke(name: str) -> Any:
    return _module(name).SMOKE
