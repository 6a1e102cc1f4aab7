"""A generated database as plain numpy columns, handed alike to the port
and to the plain reference."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class TableData:
    name: str
    columns: Dict[str, np.ndarray]
    features: Tuple[str, ...]

    @property
    def n_rows(self) -> int:
        return len(next(iter(self.columns.values())))


@dataclasses.dataclass
class Dataset:
    """Tables in order (the first holds the label), joined by natural join
    on shared column names."""

    tables: List[TableData]
    label: Tuple[str, str]

    def table(self, name: str) -> TableData:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(name)

    def feature_order(self) -> List[Tuple[str, str]]:
        """The global feature order: tables in order, each table's features
        in order; a column belongs to the first table that holds it, and
        the label is no feature."""
        owner: Dict[str, str] = {}
        for t in self.tables:
            for c in t.columns:
                owner.setdefault(c, t.name)
        return [(t.name, c) for t in self.tables for c in t.features
                if owner[c] == t.name and (t.name, c) != tuple(self.label)]


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator of one stream of a run's seed (any whole number,
    beyond 64 bits too)."""
    return np.random.default_rng([abs(int(seed)) % (1 << 64), int(seed < 0), *stream])


def balanced_choice(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """n values of 0..k-1 that every seed draws as often (as near as n
    allows), in a seeded order."""
    out = np.arange(n) % k
    rng.shuffle(out)
    return out
