"""Architecture registry of the port.

Every ported module defines ``CONFIG`` (the full published numbers) and
``SMOKE`` (a reduced config of the same family for CPU tests), copied
from the reference's ``configs/``.  ``get(name)`` returns the module's
``CONFIG``, ``get_smoke(name)`` its ``SMOKE``, whatever their type, as
the reference's do: a ``ModelConfig`` for an LM, the paper's own
``BoostConfig`` for ``paper_rbrt``.  Both take the module name or its
external id (``ALIASES``).  ``PORTED`` lists the configs, every one of
the reference's; any other name raises.

Shapes (the reference's): seq_len × global_batch; decode_* and long_*
are one token against a seq_len cache.  ``long_500k`` applies only to a
sub-quadratic arch (RWKV-6, Hymba): :func:`cells` gives each LM arch's
shapes and :func:`all_cells` every (arch, shape) the dry run lowers.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Tuple

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


# the LM archs, in the reference's order
ARCHS = [
    "qwen2_5_32b",
    "tinyllama_1_1b",
    "llama3_405b",
    "granite_3_8b",
    "dbrx_132b",
    "llama4_scout_17b_a16e",
    "seamless_m4t_medium",
    "llava_next_34b",
    "rwkv6_1_6b",
    "hymba_1_5b",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str               # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
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


def cells(arch: str) -> List[str]:
    """The shapes that apply to ``arch`` (``long_500k`` only where it is
    sub-quadratic)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if get(arch).sub_quadratic:
        out.append("long_500k")
    return out


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in cells(a)]
