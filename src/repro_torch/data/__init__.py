"""Synthetic token streams and the prefetching pipeline of the LM trainer."""
from .pipeline import TokenPipeline
from .synthetic import SyntheticLM

__all__ = ["SyntheticLM", "TokenPipeline"]
