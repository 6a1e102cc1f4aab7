"""Synthetic token streams and the prefetching pipeline of the LM trainer."""
from .pipeline import TokenPipeline, relational_example_weights
from .synthetic import SyntheticLM

__all__ = ["SyntheticLM", "TokenPipeline", "relational_example_weights"]
