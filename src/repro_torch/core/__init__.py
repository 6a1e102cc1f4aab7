"""Core: relational boosted regression trees on PyTorch.

Public API:
    Schema, Table                    — relational data (schema.py)
    SumProd, materialize_join        — query engine (sumprod.py)
    semirings                        — Arithmetic/Channels/PolyCoeff/PolyFreq/...
    TableHashes, sketch_factors      — tensor sketch (sketch.py)
    Booster, BoostConfig             — Algorithms 1–3 (trainer.py)
    MaterializedBooster              — the paper's baseline (baseline.py)
    TreeArrays, predict_rows         — trees (tree.py)
    build_hist_plans, quantile_cuts  — histogram split plans (hist.py)
"""
from .baseline import MaterializedBooster
from .engine import DirectEngine, QueryEngine
from .hist import TableHistPlan, build_hist_plans, hist_scores, quantile_cuts
from .schema import NotAcyclicError, Schema, Table
from .semiring import Arithmetic, BooleanSR, Channels, PolyCoeff, PolyFreq, Tropical
from .sketch import Hash2, TableHashes, sketch_factors
from .sumprod import MessageCache, QueryCounter, SumProd, materialize_join, refresh_plan
from .trainer import BoostConfig, Booster, FitTrace
from .tree import TreeArrays, leaf_masks, predict_rows

__all__ = [
    "NotAcyclicError", "Schema", "Table",
    "Arithmetic", "BooleanSR", "Channels", "PolyCoeff", "PolyFreq", "Tropical",
    "Hash2", "TableHashes", "sketch_factors",
    "MessageCache", "QueryCounter", "SumProd", "materialize_join", "refresh_plan",
    "DirectEngine", "QueryEngine",
    "BoostConfig", "Booster", "FitTrace", "MaterializedBooster",
    "TreeArrays", "leaf_masks", "predict_rows",
    "TableHistPlan", "build_hist_plans", "hist_scores", "quantile_cuts",
]
