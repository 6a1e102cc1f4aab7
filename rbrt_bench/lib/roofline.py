"""The least time the chip could take for a kernel call, from the call's
logical shapes.

Peaks are NVIDIA's published figures for one H100 SXM (80 GB HBM3, dense,
at the 700 W limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the
tensor cores, 989 TFLOP/s in bf16.  A call's bound is the larger of its
bytes over the bandwidth and its operations over the peak, each input
read once and each output written once.  The counts are the port's
PERF.md §6 formulas:

- segment_sum of values (K, n, C) over a CSR of ``n_keys`` keys and
  ``entries`` entries: bytes K·n·C·sz + 4·entries + 4·(n_keys + 1) +
  4·K·n_keys·C (float32 out), operations K·n·C additions;
- polymul of B products of length k: bytes (rows read of a + rows read
  of b + B rows written)·k·sz (with b whole: (a's rows + 2·B)·k·sz),
  operations B·(7.5·k·log₂k + 6·(k/2 + 1)), an FFT's count.
"""
from __future__ import annotations

import math

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def _peak(itemsize: int) -> float:
    return BF16_FLOPS if itemsize == 2 else F32_FLOPS


def bound_s(nbytes: float, ops: float, itemsize: int = 4) -> float:
    return max(nbytes / HBM_BYTES_S, ops / _peak(itemsize))


def segment_sum_counts(K: int, n: int, C: int, n_keys: int, entries: int,
                       itemsize: int = 4):
    nbytes = K * n * C * itemsize + 4 * entries + 4 * (n_keys + 1) + 4 * K * n_keys * C
    return nbytes, K * n * C


def polymul_counts(rows_a: int, rows_b: int, B: int, k: int, itemsize: int = 4):
    nbytes = (rows_a + rows_b + B) * k * itemsize
    ops = B * (7.5 * k * math.log2(k) + 6 * (k // 2 + 1))
    return nbytes, ops


def segment_sum_bound_s(K, n, C, n_keys, entries, itemsize=4) -> float:
    return bound_s(*segment_sum_counts(K, n, C, n_keys, entries, itemsize), itemsize)


def polymul_bound_s(rows_a, rows_b, B, k, itemsize=4) -> float:
    return bound_s(*polymul_counts(rows_a, rows_b, B, k, itemsize), itemsize)
