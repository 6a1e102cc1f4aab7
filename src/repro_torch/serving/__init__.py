"""Serving: compiled ensembles, one-pass batched scoring, micro-batching.

    compile_ensemble / CompiledEnsemble  — stacked-leaf one-pass scorer
    score_grouped / score_rows / score_fresh — entry points
    score_grouped_reference              — per-leaf loop (baseline)
    ModelRegistry / RelationalScoringService — versioned hot-swap + batcher
    StackedEnsembles / stack_ensembles   — A/B variants in one SumProd pass
"""
from .compile import CompiledEnsemble, compile_ensemble, contract, stack_table_factor
from .multi import StackedEnsembles, stack_ensembles
from .scorer import (
    score_fresh, score_grouped, score_grouped_reference, score_mean_rows, score_rows,
)
from .service import (
    LRUCache, ModelRegistry, RelationalScoringService, ServiceOverloadedError, ServiceStats,
)

__all__ = [
    "CompiledEnsemble", "compile_ensemble", "contract", "stack_table_factor",
    "score_fresh", "score_grouped", "score_grouped_reference", "score_mean_rows",
    "score_rows",
    "LRUCache", "ModelRegistry", "RelationalScoringService", "ServiceOverloadedError",
    "ServiceStats", "StackedEnsembles", "stack_ensembles",
]
