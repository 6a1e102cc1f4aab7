"""Record the kernels' calls in a traced run.

While :func:`recording` is active, every call the port's semirings make
to ``segment_sum`` and ``poly_mul`` goes through a wrapper that notes the
call's logical shapes and its least time on the chip (``roofline.py``),
and runs the call inside a ``record_function`` range ``bench.<kernel>``,
so the trace's device time of the call is found whatever kernels
implement it.  The wrapper is installed where the semirings look the
entries up (``repro_torch.core.semiring``), and removed on exit.
"""
from __future__ import annotations

import contextlib
import math
from typing import List

from . import roofline

RANGE = "bench.{}"


def _segment_sum_call(vals, seg) -> dict:
    K, n, C = vals.shape
    return {"kernel": "segment_sum",
            "bound_s": roofline.segment_sum_bound_s(K, n, C, seg.n_keys, n,
                                                    vals.element_size())}


def _polymul_call(a, b) -> dict:
    import torch

    shape = torch.broadcast_shapes(a.shape, b.shape)
    B, k = math.prod(shape[:-1]), shape[-1]
    rows = lambda x: math.prod(x.shape[:-1])
    return {"kernel": "polymul",
            "bound_s": roofline.polymul_bound_s(rows(a), rows(b), B, k, a.element_size())}


@contextlib.contextmanager
def recording(calls: List[dict]):
    import torch
    from repro_torch.core import semiring

    orig_ss, orig_pm = semiring.segment_sum, semiring.poly_mul

    def segment_sum(vals, seg):
        with torch.profiler.record_function(RANGE.format("segment_sum")):
            out = orig_ss(vals, seg)
        calls.append(_segment_sum_call(vals, seg))
        return out

    def poly_mul(a, b):
        with torch.profiler.record_function(RANGE.format("polymul")):
            out = orig_pm(a, b)
        calls.append(_polymul_call(a, b))
        return out

    semiring.segment_sum, semiring.poly_mul = segment_sum, poly_mul
    try:
        yield calls
    finally:
        semiring.segment_sum, semiring.poly_mul = orig_ss, orig_pm
