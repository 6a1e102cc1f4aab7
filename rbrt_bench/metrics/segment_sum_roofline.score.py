"""segment_sum's share of its roofline over the scoring passes' calls, in percent."""
from rbrt_bench.lib.readers import roofline_pct


def read(trace):
    return roofline_pct(trace, "segment_sum")
