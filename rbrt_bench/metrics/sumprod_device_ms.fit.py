"""Device ms a fit of the work launched inside the port's SumProd spans
(``sumprod.messages``, ``sumprod.emit``)."""
from rbrt_bench.lib.readers import device_ms_per


def read(trace):
    return device_ms_per(trace, ("sumprod.messages", "sumprod.emit"), "fits")
