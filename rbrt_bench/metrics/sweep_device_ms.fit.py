"""Device ms a fit of the split sweeps (the trainer's ``boost.sweep`` spans)."""
from rbrt_bench.lib.readers import device_ms_per


def read(trace):
    return device_ms_per(trace, ("boost.sweep",), "fits")
