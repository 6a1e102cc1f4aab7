"""Segment-⊕ message emissions a fit (the trainer's ``sumprod.edges``
counter over the window's fits)."""
from rbrt_bench.lib.readers import per


def read(trace):
    return per(trace, "edges", "fits")
