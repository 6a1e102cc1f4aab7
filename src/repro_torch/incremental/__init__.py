"""Incremental view maintenance for serving AND training.

    TableDelta                    — typed insert/delete/update batch
    DynamicTable / DynamicEdge    — capacity-padded mutable store + keys
    DynamicState / TableChange    — shared mutable schema mirror
    StateView                     — immutable pin of one state version
    MaintainedScorer              — delta-driven factors, path-restricted
                                    message refresh, versioned memo
    Snapshot                      — MVCC view pinned at one data_version
    MaintainedEngine              — boosting queries from cached messages
    IncrementalBooster            — delta-driven warm-start retraining
    WalWriter / WalReader         — crash-consistent delta log (LSN =
                                    data_version, group-committed fsyncs)
    WalFollower                   — tail a writer's log into a replica
    save_checkpoint / recover_*   — atomic checkpoints + tail replay
"""
from .deltas import DynamicEdge, DynamicTable, TableDelta
from .state import DynamicState, StateView, TableChange
from .maintain import MaintainedScorer, Snapshot
from .retrain import IncrementalBooster, MaintainedEngine, RefitReport
from .wal import WalCorruptError, WalFollower, WalReader, WalWriter
from .recover import (
    RecoveryReport, recover_scorer, recover_state, save_checkpoint,
)

__all__ = [
    "DynamicEdge", "DynamicTable", "TableDelta",
    "DynamicState", "StateView", "TableChange",
    "MaintainedScorer", "Snapshot",
    "IncrementalBooster", "MaintainedEngine", "RefitReport",
    "WalCorruptError", "WalFollower", "WalReader", "WalWriter",
    "RecoveryReport", "recover_scorer", "recover_state", "save_checkpoint",
]
