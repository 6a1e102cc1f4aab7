"""Join-tree CSRs the port rebuilds a refresh batch (``DynamicState.csr_builds``)."""
from rbrt_bench.lib.readers import per


def read(trace):
    return per(trace, "csr_builds", "batches")
