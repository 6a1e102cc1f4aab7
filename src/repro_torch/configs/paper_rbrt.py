"""The paper's own 'architecture': relational boosted regression trees.

Hyperparameters mirror the paper's variables (m trees, L leaves via
depth, τ tables, k), copied from the reference's ``configs/paper_rbrt.py``."""
from repro_torch.core.trainer import BoostConfig

CONFIG = BoostConfig(n_trees=8, depth=4, mode="sketch", sketch_k=256)
SMOKE = BoostConfig(n_trees=2, depth=2, mode="sketch", sketch_k=64)
