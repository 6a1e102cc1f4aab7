"""CUDA kernels a grouped scoring pass (the profiler's kernels over the passes)."""


def read(trace):
    n = trace.counters.get("passes")
    return trace.n_kernels / n if n else None
