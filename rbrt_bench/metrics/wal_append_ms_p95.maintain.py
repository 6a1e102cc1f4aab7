"""95th percentile of the WAL's append ms over the window's batches (the
port's ``wal.append_ms`` histogram, host file I/O)."""
from rbrt_bench.lib.readers import bucket_quantile


def read(trace):
    b = trace.counters.get("wal_append_buckets")
    return bucket_quantile(b, trace.counters["wal_bucket_res"], 0.95) if b else None
