#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Kernels vs plain on the card, both built here from
   ``src/repro_torch/csrc/`` (one ``nvcc`` per source, in parallel):
   - the segment-⊕ kernel (``segment_sum.cu``) against its plain PyTorch
     version at the serve path's shapes (C = 3, 40, and 160 for phase 9's
     four stacked models, f32 and bf16; uniform, Zipf-skewed,
     empty-segment and one-key key sets; a key of more than
     ``ops.ITEM_ROWS`` entries is cut into work items, the one key into
     1,024) and at the histogram sweep's (a key column over 2 tiled
     copies of 2^20 stats rows).  Integer-valued inputs must match
     exactly; float inputs must satisfy |kernel − plain_f64|
     ≤ 1e-5 · Σ|v| per output element (Σ|v| over the element's segment,
     in float64).  Prints kernel, plain, ``index_add_`` and bound times;
   - the polymul kernel (``polymul.cu``) against its plain version in
     float64 at the coefficient fit's shapes ((4·2^20, 256) f32 and bf16,
     (2^18, 1024) f32, (1,048,579, 64) f32, a row count off the tile, and
     fit B's broadcast form, a (1, 2^20, 256) factor against (4, 2^20,
     256) messages, f32: all on the tensor cores) and, on the direct form,
     at (4·2^20 + 3, 250) f32.
     Integer-valued inputs must match exactly; float32 within
     2e-5 · (|a| ⊛ |b|) per coefficient, bfloat16 within that plus
     2^-8 · |exact| (the output's rounding).  Prints kernel, plain,
     ``torch.fft`` (the library route, never called by the port on the
     card) and bound times, and the largest |err| / limit;
   - the rwkv6_chunk kernel (``rwkv6_chunk.cu``) against its plain version
     in float64 at the RWKV-6 prefill's shape (8, 1024, 32, 64, c 16), one
     long prompt (1, 4096, 32, 64, 16), one prompt of the prefill's length
     (1, 1024, 32, 64, 16) and the reference test's (2, 64, 2, 32, 16) and
     (3, 48, 1, 16, 8), on numpy-seeded inputs (standard-normal r, k, v,
     u; log-decays uniform in [−2, −0.01]): |kernel − plain_f64| ≤ 2e-5 · W
     per element, W the plain WKV of |r|, |k|, |v|, |u| with the same
     decays, and the terminal state within 2e-5 per entry of the state of
     |k| and |v| with the same decays; output and state bit-equal on a
     second run.  Prints the sequence segments the wrapper chose, kernel
     (and, where it cut the sequence, the same call in one walk), plain
     (float32) and bound times; no single PyTorch call computes the WKV.
     Then every (hs, c) in one walk and in 4 segments with log-decays of
     −3.3 to −3.7 a token at c 16 (twice that at c 8), which put every
     chunk's cumulative decay just above the −60 where the factored form
     ends, held to the same gates; prints the largest err/W;
   - the flash_attention kernel (``flash_attention.cu``) against a dense
     softmax in float64 over the same inputs at the TinyLlama prefill's
     shape (B 8, S 2048, 32 query heads, 4 K/V heads, dh 64, causal) in
     bf16 and in float32, one long prompt (1, 8192, 32, 4, 64), Qwen2.5-32B
     / Llama-3 heads (2, 1024, 40, 8, 128), an encoder side (2, 512, 16,
     16, 64, not causal, f32), a ragged S (3, 1000, 8, 2, 32, f32) and the
     smoke config's (2, 24, 8, 1, 16, f32), on numpy-seeded standard-normal
     q, k, v: per element, |kernel − dense_f64| ≤ 2e-5 · max|v| in
     float32, and in bf16 ≤ 2⁻⁷ · (|o| + ‖p‖₂ · max|v|) for an output o of
     a row with probabilities p (the output's rounding, and the
     probabilities' rounding before P·V, which spreads as ‖p‖₂ over a
     row; ``ref.attention_limit``).  Prints kernel, plain (the blockwise
     twin), ``scaled_dot_product_attention`` (the library call, never
     called by the port) and bound times, the kernel's and the library's
     TFLOP/s and their ratio, and the largest |err| / limit.  The
     log-sum-exp output of the training forward, at every shape, within
     1e-4 + 1e-5 · |lse| of a float64 log-sum-exp.  Before the cases, the
     built library's SASS (``cuobjdump``, found beside ``nvcc`` or in
     Triton's package): per bf16 kernel the count of HGMMA (wgmma),
     UTMALDG (TMA loads) and SYNCS (mbarrier) instructions and its shared
     memory, failing if one has no HGMMA or no UTMALDG;
   - the count_sketch kernel (``count_sketch.cu``), both forms (buckets and
     signs as arrays; hashed inside the kernel, the compressor's) at the
     reference test's (n, k) = (100, 16), (1000, 64), (5000, 256), (512,
     128) and at every TinyLlama gradient leaf that the compressor
     sketches: ln_f (2,048, 2⁹), ln1/ln2 (45,056, 2¹³), w_down/w_gate/w_up
     (253,755,392, 2²⁵), wq/wo (92,274,688, 2²⁴), embed (66,060,288, 2²³)
     and wk/wv (11,534,336, 2²¹): per bucket j, |kernel − float64| ≤ 2⁻²³ ·
     m_j · W_j (m_j terms, W_j = Σ|x_t| over them; the atomics add in no
     fixed order), the route the plan did not take (bins or slabs, at the
     large leaves) too; the unsketch within 2⁻²³ · |value| of the plain
     version.  Prints the route, kernel (and the other route's), plain
     (int64 hashes and a float64 ``index_add_``), ``index_add_`` with the
     buckets precomputed (the library call, never called by the port) and
     bound times, and the unsketch's time, its library call's
     (``index_select`` of the sketch by the precomputed buckets, times the
     signs and the scale) and its bound.
2. Serve path at real size: star schema with 4,194,304 fact rows and
   4,096-row dimension tables; train 5 trees of depth 3 (sketch mode, no
   SSR), compile, ``score_grouped`` by every table, then 2,000 Zipf(1.3)
   requests through the micro-batching service with a hot swap.  Counts
   must equal the materialized-join oracle exactly and totals must be
   within 1e-4 · Σ|ŷ| of it per group; the kernel's launches must cover
   every message emission the query counters report.
3. Paper check: 262,144 fact rows, 3 trees of depth 3, exact vs sketched
   (k = 256) training with per-table SSR, plus the materialized baseline.
4. The paper's coefficient-domain sketch and histogram splits, at
   1,048,576 fact rows (``--coeff-n-fact``), 3 trees of depth 3:
   A, sketch k = 256 with per-table SSR in the frequency domain;
   B, A in the coefficient domain with A's hashes, whose every ⊗ is the
   polymul kernel: trees identical to A's, SSR within rtol 1e-3 of A's
   where above 1.0, and polymul launches equal to the fit's ⊗ count;
   C, histogram splits (256 bins, the segment-⊕ kernel route) without
   SSR: MSE within 5 % of var(y) of A's exact-split MSE and under half
   of var(y), the kernel route's first-level sweep within 2e-4 of the
   gather route's, and segment-⊕ launches on the histogram route.
   Prints each fit's time and counts, and the device time of one more
   tree of B split into the polymul kernel and the rest.
5. RWKV-6 1.6B serving at its full published width (24 layers, d_model
   2048, 32 heads of 64, d_ff 7168, vocab 65,536, bf16) with random weights
   from a ``torch.Generator`` seed: prefill 8 prompts of 1,024 numpy-seeded
   token ids (each layer's WKV state for the cache comes out of the
   kernel's call), then greedy-decode 64 tokens, after one untimed warm-up.
   Gates: (a) finite logits, padded ids masked; (b) the prefill's
   last-position logits with the plain WKV patched in (the module's
   function, by this script) against the kernel's: in a float32 twin of
   the model (the same weights upcast) within 1e-4 · max|logit| with the
   same greedy tokens, and in bf16 no further apart than the bf16 model
   is from its float32 twin (its own rounding, which 24 layers amplify
   past the reference's 2-layer band); (c) decode_step after
   prefill(S) against prefill(S + 1)'s last-position logits (the oracle
   of ``tests/test_archs.py``): in bf16 no further from the float32
   twin's prefill(S + 1) than twice the bf16 prefill(S + 1) is from it
   in this run (its own rounding; a cache or position fault moves the
   logits by O(1)), the reference's band (atol 0.08, rtol 0.05, from a
   2-layer model) printed only; float32 within 1e-4 · max|logit|; (d) rwkv6_chunk
   launches: one a layer per prefill, none while decoding.  Prints
   prefill ms, decode ms a token and tok/s, and the kernel's share of one
   prefill's device time (torch.profiler); ``--profile`` adds decode's
   idle share.
6. TinyLlama-1.1B dense-attention serving at its full published width and
   depth (22 layers, d_model 2048, 32 query heads and 4 K/V heads of 64,
   SwiGLU d_ff 5632, vocab 32,000, bf16) with random weights from a seed:
   prefill 8 prompts of 2,048 numpy-seeded ids into a KV cache with room
   for the decode tokens, then greedy-decode 64 tokens.  Gates as phase
   5's, with the model's own blockwise attention (the plain version, at
   the config's chunks, q 512 and kv 1024) in place of the kernel for (b),
   whose bf16 half is: at every layer of a bf16 prefill, the kernel's
   output on the model's own q, k, v within phase 1's bf16 limit of a
   dense float64 softmax, and the kernel- and plain-served models' logits
   no further apart than their two distances to the float32 twin added
   (the two bf16 attentions round at different places, so phase 5's bf16
   condition, kernel-vs-plain within the model's distance to its twin, is
   a coin toss here; the per-layer check is the evidence); and (c) at the
   first and the last decode step: decode after prefill(S)
   against prefill(S + t), bf16 at t = 1 as in phase 5, float32 within
   1e-4 · max|logit| at t = 1 and t = 64 (the step that shows the
   cache's room: the reference's S-slot cache has overwritten
   63 prompt positions by then); (d) flash_attention launches 22 times a
   prefill and none while decoding.  Prints the same times and the
   kernel's share of the prefill.

7. TinyLlama-1.1B training at its full published width and depth (bf16,
   random weights from a seed) through ``launch/train.py``'s ``build`` and
   ``launch/steps.make_train_step``: global batch 8 × 2,048 from the
   synthetic pipeline, 8 microbatches, remat, count-sketch gradient
   compression with ratio 8 and error feedback, AdamW; 4 steps after an
   untimed warm-up step.  Gates: (a) a finite loss at every step; (b)
   launches over the 4 steps: flash_attention 22 · 8 · 2 a step (forward
   and remat recompute), count_sketch 12 a step (one a gradient leaf, as
   the reference stacks them) and its unsketch 12, the other kernels 0;
   (c) a float32 twin cut to 4 layers (full width, batch 2 × 2,048, 2
   microbatches), one step served by the kernels and one by the plain
   versions with the same weights, batch and hashes: loss within 1e-5
   relative and each compressed gradient leaf within 1e-4 · max|g|.  The
   two parameter updates are printed, not gated: AdamW's first step is
   g/(|g| + eps), so where a compressed g is a few eps the gradients'
   float noise moves the update by up to ~10 % of max|Δp|; (d) ``launch/train.py``'s ``main`` at the smoke
   size on the card: 3 steps, the checkpoint restored bit for bit, one
   resumed step.  Prints each step's ms and loss, tokens/s, the
   compressor's ms a step (CUDA events) and the peak memory (allocated and
   reserved); ``--profile`` adds one traced step's busy/idle share and
   device time by kind.

8. Incremental maintenance and warm-start retraining, every refreshed
   message a segment-⊕ kernel launch; it runs right after phase 4, on
   the models phases 2 and 4 leave resident, which are freed before
   phase 5.  (a) Phase 2's schema and trees
   (not built or trained again) in a ``MaintainedScorer`` with a
   ``WalWriter`` (fsync every 8 appends) in a temporary directory; 32
   delta batches in ``delta_stream``'s mix, drawn with vectorised numpy:
   6 ops a batch, each on a table drawn uniformly, an insert with p 0.35,
   a delete with p 0.3, else an update, each op a block of rows: on
   ``fact`` 4,096 inserts (keys from the live dimension keys, 1 % newly
   minted), 1,024 deletes or 1,024 feature updates; on a dimension table
   4 inserts (keys the fact table minted, then fresh ones), 4 deletes or
   16 feature updates; batch 17 also inserts 2,048 rows into dim0, which
   must double its capacity.  After each batch
   ``grouped_cached("fact")`` and ``grouped_cached("dim0")``; prints the
   batch's ops, apply, refresh and CSR-rebuild ms (host clock after a
   synchronise), the CSRs built, the edges re-emitted against a full pass
   and the launches, and p50/p99 over the batches.  Gates: after batches
   16 and 32 the recompute oracle of both roots (one effective schema
   each time) bit-equal to the maintained
   scores; during the refreshes segment_sum launches equal to the edges
   the counter records, and more than 0; a snapshot pinned after batch
   19 scores bit-equal to its pin after batch 24; 2,000 Zipf(1.3) row
   requests through the service over the published scorer, each equal to
   ``grouped_cached``'s mean for its row; ``recover_scorer`` from the
   checkpoint of batch 16 and the closed log reaches version 32,
   bit-equal to the live scorer (prints its seconds, the records
   replayed and the log's bytes).  (b) Phase 4's schema: an
   ``IncrementalBooster`` of 3 sketch-mode trees of depth 3, then 4
   ``drift_stream`` batches of 16,384 rows, each followed by a refit of
   one tree: the new tree matches a scratch ``Booster`` on the effective
   schema warm-started from the same trees (``feat`` equal, ``thr`` within
   1e-6, leaves within rtol 1e-4 and atol 1e-5), with fewer edges, and
   the refit's segment_sum launches equal its edges, more than 0 in all.
   Prints refit and scratch seconds (the scratch's effective schema and
   split plans included, and printed apart), the edge ratio and the mask
   signatures' host ms.  No other kernel launches in phase 8.
   ``--profile`` adds one more batch's apply and refresh and one more
   refit, traced, after the gates.

9. The operated service, right after phase 8, on phase 2's schema and
   model; what it allocates is freed before phase 5, and it prints its
   peak memory.  (a) Phase 2's 2,000 Zipf(1.3) requests through
   ``serve_relational``'s own wiring (``wire``, ``drive``, ``finish``)
   with every telemetry flag on: tracing, the SLO
   ``latency=50ms@0.99,errors=0.01,staleness=5s``, a 4,096-span flight
   ring, the telemetry server on 127.0.0.1 port 0 and the sampler into a
   temporary file; half-way through the traffic (the requests wait for it)
   a client thread fetches ``/metricsz``, ``/healthz``, ``/statusz`` and
   ``/tracez`` (10 s timeout), and ``/metricsz`` once more after the last
   request.  Gates: every endpoint answers; the mid-traffic
   ``repro_service_requests`` is below the final one, which equals the
   service's own count; the Chrome
   trace parses and its ``service.batch`` events number the service's
   batches; a forced ``flight.trigger`` writes a dump that parses, with at
   most 4,096 spans; the 2,000 answers bit-equal to phase 2's
   ``grouped_cached`` means (and so are the same requests' answers with
   telemetry off, served first).  Prints QPS and p50/p99 with telemetry on
   and off, the SLO state and burn rates.  (b) Three more variants of phase
   2's model (seeds 7, 8 and 9, shrinkage 1/2, 1/4 and 1/8), all four
   published and stacked by ``registry.stacked()`` into one factor set of
   160 channels, scored by every table: each model's (Σŷ, count) bit-equal
   to its own ``score_grouped`` in float32; segment_sum launches of the
   stacked pass equal to the edges of one pass, and to 4 times that for
   the four separate passes; a bfloat16 stack's leaf counts within 2⁻⁸ ·
   |count| of the float32 stack's; ``stacked()`` the cached object until a
   ``swap``, then a new one.  Prints a stacked pass's ms against the four
   separate passes' per table (CUDA events).  (c) A writer
   ``MaintainedScorer`` over phase 2's model logs phase 8's batches to a
   temporary WAL and checkpoints after batch 8; a replica recovers from
   that checkpoint and log (``recover_scorer``) and a ``WalFollower``
   tails the log (10 ms polls) while the writer applies and refreshes
   batches 9-24, one every 50 ms, on a thread of its own, and a service
   over the replica, with a degrade-only staleness objective and
   ``extra_staleness``, answers Zipf(1.3) requests.  Gates: the follower
   applied through the writer's last LSN; both roots' grouped scores of
   the replica bit-equal to the writer's; 256 service answers equal the
   replica's ``grouped_cached`` means; the staleness objective never
   ``unhealthy``; no request shed or failed; segment_sum launched.  Prints
   the replication lag (per record) p50/p99, the writer's ms a batch and
   the launches.

Prints the card's name and power limit, the build time, each phase's
findings, a JSON line of kernel measurements, and as its last line
``{"ok": true, "device": {...}}``.  A failure ends the run where it
happens.  Needs a CUDA device and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published HBM3 rate
F32_OPS_PER_S = 67e12              # H100 SXM published float32 rate outside the tensor cores
FLOAT_RTOL = 1e-5                  # float inputs: |err| ≤ FLOAT_RTOL · Σ|v| per element
POLY_RTOL = 2e-5                   # polymul: |err| ≤ POLY_RTOL · (|a| ⊛ |b|), f32 sums of k products
BF16_ULP = 2.0 ** -8               # bf16 output rounding, relative
WKV_RTOL = 2e-5                    # rwkv6_chunk: |err| ≤ WKV_RTOL · W, W the WKV of |r|, |k|, |v|, |u|
BF16_OPS_PER_S = 989e12            # H100 SXM published dense bf16 tensor-core rate
LM_BAND = dict(atol=0.08, rtol=0.05)   # the reference's bf16 band (tests/test_archs.py), printed
DECODE_NOISE = 2.0                 # bf16 decode: |Δ| to the f32 twin ≤ this × bf16 prefill's
LM_F32_RTOL = 1e-4                 # float32 LM logits: |Δ| ≤ LM_F32_RTOL · max|logit|
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5    # flash lse: |err| ≤ LSE_ATOL + LSE_RTOL · |lse|
SKETCH_ROUND = 2.0 ** -23          # count_sketch: |err_j| ≤ SKETCH_ROUND · m_j · W_j per bucket
TRAIN_LOSS_RTOL = 1e-5             # float32 twin: kernel- vs plain-served step, loss
TRAIN_GRAD_RTOL = 1e-4             # ... compressed gradient, of max|g| per leaf
TRAIN_STEP_RTOL = 1e-4             # ... share of updates apart by more (printed only)
N_KEYS = 4096                      # dimension-table key domain of the serve path


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, min_total_s: float = 0.2, max_reps: int = 20, min_reps: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = int(min(max_reps, max(min_reps,
                                 min_total_s / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phase 1 --
def make_ids(rng, n: int, n_keys: int, dist: str) -> np.ndarray:
    if dist == "uniform":
        return rng.integers(0, n_keys, n)
    if dist == "zipf":                                  # one very long segment
        return np.minimum(rng.zipf(1.3, n) - 1, n_keys - 1)
    if dist == "even":                                  # every odd key is empty
        return 2 * rng.integers(0, n_keys // 2, n)
    if dist == "one":                                   # every row on one key
        return np.full(n, n_keys // 2)
    raise ValueError(dist)


def kernel_case(ops, ref, name, K, n, C, dtype, dist, n_keys=N_KEYS, seed=0, dev="cuda",
                tiles=1):
    """One shape: exactness on integer values, tolerance on float values,
    determinism, and timings.  Returns the shape's record.  ``tiles`` > 1
    is the histogram sweep's shape: a key column over that many tiled
    copies of the n rows (``bins + f·(B+1)``, the last bin of each copy
    empty), read in place through a CSR whose order is taken modulo n."""
    rng = np.random.default_rng(seed)
    if tiles > 1:
        nb = n_keys // tiles
        ids = (rng.integers(0, nb - 1, (tiles, n)) + np.arange(tiles)[:, None] * nb).reshape(-1)
        seg = ops.Segments.from_ids(ids, n_keys, dev, row_period=n)
    else:
        seg = ops.Segments.from_ids(make_ids(rng, n, n_keys, dist), n_keys, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    ints = torch.randint(0, 4, (K, n, C), generator=gen, device=dev).to(dtype)
    got = ops.segment_sum(ints, seg)
    want = ref.segment_sum_ref(ints, seg.order, seg.offsets, torch.float64)
    if not torch.equal(got.double(), want):
        raise AssertionError(f"{name}: integer-valued sums differ "
                             f"(max |err| {float((got.double() - want).abs().max())})")

    vals = torch.randn((K, n, C), generator=gen, device=dev).to(dtype)
    got = ops.segment_sum(vals, seg)
    again = ops.segment_sum(vals, seg)
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two runs of the kernel differ")
    want = ref.segment_sum_ref(vals, seg.order, seg.offsets, torch.float64)
    mag = ref.segment_sum_ref(vals.abs(), seg.order, seg.offsets, torch.float64)
    err = (got.double() - want).abs()
    if bool((err > FLOAT_RTOL * mag + 1e-30).any()):
        raise AssertionError(f"{name}: float sums outside {FLOAT_RTOL}·Σ|v| "
                             f"(max |err| {float(err.max())})")
    max_abs_err = float(err.max())
    del ints, want, mag, err, again

    kernel_ms = cuda_ms(lambda: ops.segment_sum(vals, seg))
    plain_ms = cuda_ms(lambda: ref.segment_sum_ref(vals, seg.order, seg.offsets),
                       max_reps=5)
    # yardstick only: one PyTorch call computing the same sums (atomics);
    # bf16 input accumulates into a bf16 output, index_add_'s only option;
    # the tiled values of the histogram shape are built outside the timing
    out_dtype = torch.float32 if dtype == torch.float32 else dtype
    lib_out = torch.zeros((K, n_keys, C), dtype=out_dtype, device=dev)
    lib_vals = vals.repeat(1, tiles, 1) if tiles > 1 else vals
    library_ms = cuda_ms(lambda: lib_out.zero_().index_add_(1, seg.ids, lib_vals))
    in_bytes = vals.element_size()
    entries = tiles * n
    nbytes = K * n * C * in_bytes + 4 * entries + 4 * (n_keys + 1) + 4 * K * n_keys * C
    # the least time for the same work: bytes (each input read once, the
    # output written once) or the K·n·C float32 adds, whichever is larger
    bound_ms = max(nbytes / HBM_BYTES_PER_S, K * n * C / F32_OPS_PER_S) * 1e3
    rec = {"case": name, "K": K, "n": n, "C": C, "n_keys": n_keys, "tiles": tiles,
           "dtype": str(dtype).replace("torch.", ""), "ids": dist,
           "max_segment": int(torch.diff(seg.offsets).max()),
           "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bytes": nbytes}
    log(f"  {name:<22} K={K} n={n} C={C} {rec['dtype']:<8} ids={dist:<7} "
        f"kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  "
        f"bound_ms {bound_ms:.4f}  max_abs_err {max_abs_err:.3e}")
    del vals, got, lib_out, lib_vals
    torch.cuda.empty_cache()
    return rec


def phase_kernel(ops, ref, dev="cuda"):
    n22, n18 = 1 << 22, 1 << 18
    cases = [
        ("c3_k1", 1, n22, 3, torch.float32, "uniform"),
        ("c3_k4", 4, n22, 3, torch.float32, "uniform"),
        ("leaves40_f32", 1, n22, 40, torch.float32, "uniform"),
        ("leaves40_bf16", 1, n22, 40, torch.bfloat16, "uniform"),
        ("stacked160_f32", 1, n22, 160, torch.float32, "uniform"),     # phase 9's A/B stack
        ("stacked160_bf16", 1, n22, 160, torch.bfloat16, "uniform"),
        ("polyfreq256_k4", 4, n18, 258, torch.float32, "uniform"),
        ("c3_zipf", 1, n22, 3, torch.float32, "zipf"),
        ("leaves40_zipf", 1, n22, 40, torch.float32, "zipf"),
        ("c3_empty_segments", 1, n22, 3, torch.float32, "even"),
        ("leaves40_empty_segments", 1, n22, 40, torch.float32, "even"),
        ("c3_one_key", 1, n22, 3, torch.float32, "one"),
        ("leaves40_one_key", 1, n22, 40, torch.float32, "one"),
    ]
    recs = [kernel_case(ops, ref, *c, dev=dev) for c in cases]
    # phase 4's histogram sweep on the fact table: 2 features × 257 bin
    # slots, stats of K = 4 nodes (C = 2K) over 2^20 rows
    recs.append(kernel_case(ops, ref, "hist_fact_k4", 1, 1 << 20, 8, torch.float32, "bins",
                            n_keys=2 * 257, dev=dev, tiles=2))
    return recs


def fft_flops(k: int) -> float:
    """Flops of one row's ⊗ in the FFT form: three real transforms of
    ~2.5·k·log2(k) each and k/2+1 complex products of 6 flops."""
    return 3 * 2.5 * k * math.log2(k) + 6 * (k // 2 + 1)


def poly_case(ops, ref, name, B, k, dtype, seed=0, dev="cuda", chunk=1 << 18, bcast=1):
    """One polymul shape: exactness on integer values, tolerance on float
    values against the float64 plain version (computed ``chunk`` rows at
    a time), determinism, and timings.  Returns the shape's record.
    ``bcast`` > 1 is fit B's broadcast form: a (1, B/bcast, k) factor
    against (bcast, B/bcast, k) messages, the factor read in place."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    chunks = [slice(r, min(r + chunk, B)) for r in range(0, B, chunk)]
    a_shape, b_shape = (1, B // bcast, k), (bcast, B // bcast, k)
    rows = lambda x: x.expand(b_shape).reshape(B, k)     # the rows the kernel reads
    # integers in {−lo..lo}: every partial sum (|·| ≤ lo²·k) is exact in the dtype
    lo = 2 if dtype == torch.float32 else 1
    if dtype == torch.float32 or k <= 256:
        ia, ib = (torch.randint(-lo, lo + 1, shape, generator=gen, device=dev).to(dtype)
                  for shape in (a_shape, b_shape))
        got = ops.poly_mul(ia, ib).reshape(B, k)
        ia, ib = rows(ia), ib.reshape(B, k)
        for c in chunks:
            want = ref.poly_mul_ref(ia[c], ib[c], torch.float64)
            if float((want - want.round()).abs().max()) > 1e-6:
                raise AssertionError(f"{name}: float64 plain version is off the integers")
            if not torch.equal(got[c].double(), want.round()):
                raise AssertionError(f"{name}: integer-valued products differ "
                                     f"(max |err| {float((got[c].double() - want).abs().max())})")
        del ia, ib, got, want
    a, b = (torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in (a_shape, b_shape))
    got = ops.poly_mul(a, b)
    if not torch.equal(got, ops.poly_mul(a, b)):
        raise AssertionError(f"{name}: two runs of the kernel differ")
    got, ra, rb = got.reshape(B, k), rows(a), b.reshape(B, k)
    max_abs_err, max_err_over_limit = 0.0, 0.0
    for c in chunks:
        want = ref.poly_mul_ref(ra[c], rb[c], torch.float64)
        tol = POLY_RTOL * ref.poly_mul_ref(ra[c].abs(), rb[c].abs(), torch.float64) + 1e-6
        if dtype == torch.bfloat16:
            tol += BF16_ULP * want.abs()
        err = (got[c].double() - want).abs()
        if bool((err > tol).any()):
            raise AssertionError(f"{name}: products outside tolerance (max |err| "
                                 f"{float(err.max())})")
        max_abs_err = max(max_abs_err, float(err.max()))
        max_err_over_limit = max(max_err_over_limit, float((err / tol).max()))
    del got, want, tol, err, ra, rb

    kernel_ms = cuda_ms(lambda: ops.poly_mul(a, b))
    plain_ms = cuda_ms(lambda: [ref.poly_mul_ref(rows(a)[c], b.reshape(B, k)[c], torch.float64)
                                for c in chunks], max_reps=3)
    # yardstick only: the torch.fft route (rfft, rfft, product, irfft) in
    # float32, which the port never calls on the card
    library_ms = cuda_ms(lambda: ref.poly_mul_ref(a, b))
    size = a.element_size()
    nbytes = (a.numel() + 2 * B * k) * size    # a and b read once, out written once
    flops = B * fft_flops(k)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_OPS_PER_S else "operations"
    direct = 2.0 * B * k * k
    rec = {"case": name, "B": B, "k": k, "dtype": str(dtype).replace("torch.", ""),
           "bcast": bcast, "max_abs_err": max_abs_err,
           "max_err_over_limit": max_err_over_limit, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "fft_flops": flops, "direct_flops": direct,
           "direct_tflops_per_s": direct / kernel_ms / 1e9}
    log(f"  {name:<22} B={B} k={k} {rec['dtype']:<8} kernel_ms {kernel_ms:.4f}  "
        f"plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms {bound_ms:.4f} "
        f"({bound_by})  direct-form {direct:.3e} flops = {rec['direct_tflops_per_s']:.2f} "
        f"TFLOP/s  max_abs_err {max_abs_err:.3e} ({max_err_over_limit:.3f} of the limit)")
    del a, b
    torch.cuda.empty_cache()
    return rec


def phase_polymul(ops, ref, dev="cuda"):
    cases = [
        ("pm256_f32", 4 << 20, 256, torch.float32),     # fit B's largest ⊗: K=4, n=2^20
        ("pm256_bf16", 4 << 20, 256, torch.bfloat16),
        ("pm1024_f32", 1 << 18, 1024, torch.float32),
        ("pm64_offtile_f32", (1 << 20) + 3, 64, torch.float32),
        ("pm250_offtile_f32", (4 << 20) + 3, 250, torch.float32),   # the direct form
    ]
    recs = [poly_case(ops, ref, *c, dev=dev) for c in cases]
    # fit B's broadcast form: a one-node level's (1, 2^20, 256) factor
    # against (4, 2^20, 256) messages
    recs.append(poly_case(ops, ref, "pm256_bcast_f32", 4 << 20, 256, torch.float32, dev=dev,
                          bcast=4))
    return recs


def wkv_flops(B: int, S: int, H: int, hs: int, c: int) -> int:
    """Operations of the chunked WKV on these shapes: per chunk and head,
    the pairwise decays of the strictly lower triangle (a difference, an
    exponential, two products and a sum a key: 5·c(c−1)/2·hs), the bonus
    diagonal (3·c·hs), A·v over the lower triangle and its diagonal
    (c(c+1)·hs), the two state products (4·c·hs²), the state's decay
    (2·hs²) and the elementwise cumsum, decays and sum (7·c·hs)."""
    per = (5 * c * (c - 1) // 2 * hs + 3 * c * hs + c * (c + 1) * hs + 4 * c * hs * hs
           + 2 * hs * hs + 7 * c * hs)
    return B * H * (S // c) * per


def wkv_case(ops, ref, name, B, S, H, hs, c, seed=0, dev="cuda"):
    """One rwkv6_chunk shape: the kernel's output and terminal state within
    WKV_RTOL · W of the plain version in float64 (W the output, or the
    state, of |r|, |k|, |v|, |u| with the same decays), both bit-equal on a
    second run, and timings.  Returns the shape's record."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hs), dtype=np.float32) for _ in range(3))
    logw = -rng.uniform(0.01, 2.0, (B, S, H, hs)).astype(np.float32)
    u = rng.standard_normal((H, hs), dtype=np.float32)
    args = [torch.from_numpy(x).to(dev) for x in (r, k, v, logw, u)]
    got, st = ops.rwkv6_chunk(*args, c, return_state=True)
    got2, st2 = ops.rwkv6_chunk(*args, c, return_state=True)
    if not (torch.equal(got, got2) and torch.equal(st, st2)):
        raise AssertionError(f"{name}: two runs of the kernel differ")
    del got2, st2
    want, want_st = ref.rwkv6_chunk_ref(*args, c, torch.float64, return_state=True)
    mag, mag_st = ref.rwkv6_chunk_ref(args[0].abs(), args[1].abs(), args[2].abs(), args[3],
                                      args[4].abs(), c, torch.float64, return_state=True)
    err, st_err = (got.double() - want).abs(), (st.double() - want_st).abs()
    if bool((err > WKV_RTOL * mag).any()) or bool((st_err > WKV_RTOL * mag_st).any()):
        raise AssertionError(f"{name}: WKV outside {WKV_RTOL}·W (max |err|/W "
                             f"{float((err / mag).max())}, state "
                             f"{float((st_err / mag_st).max())})")
    max_abs_err, max_rel_err = float(err.max()), float((err / mag).max())
    st_abs_err, st_rel_err = float(st_err.max()), float((st_err / mag_st).max())
    del got, st, want, want_st, mag, mag_st, err, st_err

    segs = ops.segments(B, H, S // c)
    kernel_ms = cuda_ms(lambda: ops.rwkv6_chunk(*args, c, return_state=True))
    # the same call in one walk (one segment), where the plan cuts the sequence
    one_walk_ms = (cuda_ms(lambda: ops._launch(args, c, 1, True)) if segs > 1
                   else kernel_ms)
    plain_ms = cuda_ms(lambda: ref.rwkv6_chunk_ref(*args, c, return_state=True), max_reps=3)
    # r, k, v, logw, u read once; the output and the state written once
    nbytes = 4 * (5 * B * S * H * hs + H * hs + B * H * hs * hs)
    flops = wkv_flops(B, S, H, hs, c)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_OPS_PER_S * 1e3
    rec = {"case": name, "B": B, "S": S, "H": H, "hs": hs, "chunk": c, "segments": segs,
           "max_abs_err": max_abs_err, "max_err_over_w": max_rel_err,
           "state_max_abs_err": st_abs_err, "state_max_err_over_w": st_rel_err,
           "ms": kernel_ms, "one_walk_ms": one_walk_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "flops": flops}
    log(f"  {name:<22} B={B} S={S} H={H} hs={hs} c={c} segments {segs} kernel_ms "
        f"{kernel_ms:.4f} (one walk {one_walk_ms:.4f})  plain_ms {plain_ms:.4f}  bound_ms "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']}; {flops:.3e} flops = {ops_ms:.4f} ms)  "
        f"max_abs_err {max_abs_err:.3e}  max err/W {max_rel_err:.3e}  state max_abs_err "
        f"{st_abs_err:.3e}  max err/W {st_rel_err:.3e}")
    del args
    torch.cuda.empty_cache()
    return rec


def phase_wkv(ops, ref, dev="cuda"):
    cases = [
        ("prefill_8x1024", 8, 1024, 32, 64, 16),        # phase 5's prefill
        ("long_1x4096", 1, 4096, 32, 64, 16),
        ("one_1x1024", 1, 1024, 32, 64, 16),            # one prompt of the prefill's length
        ("ref_test_hs32", 2, 64, 2, 32, 16),             # tests/test_kernels.py's off shapes
        ("ref_test_hs16_c8", 3, 48, 1, 16, 8),
    ]
    return [wkv_case(ops, ref, *c, dev=dev) for c in cases]


def wkv_strong_decay(ops, ref, dev="cuda"):
    """rwkv6_chunk where its factored decays are largest: every (hs, c) at
    (1, 16·c, 2, hs), in one walk and in 4 segments, with log-decays that
    put each chunk's cumulative decay in [−59.2, −52.8].  Output and state
    within WKV_RTOL · W of the plain version in float64; returns the
    largest err/W of each."""
    worst = {"max_err_over_w": 0.0, "state_max_err_over_w": 0.0}
    for hs in (16, 32, 64):
        for c in (8, 16):
            rng = np.random.default_rng(hs + c)
            S = 16 * c
            r, k, v = (rng.standard_normal((1, S, 2, hs), dtype=np.float32) for _ in range(3))
            logw = (-rng.uniform(3.3, 3.7, (1, S, 2, hs)) * (16 / c)).astype(np.float32)
            u = rng.standard_normal((2, hs), dtype=np.float32)
            args = [torch.from_numpy(x).to(dev) for x in (r, k, v, logw, u)]
            want, want_st = ref.rwkv6_chunk_ref(*args, c, torch.float64, return_state=True)
            mag, mag_st = ref.rwkv6_chunk_ref(args[0].abs(), args[1].abs(), args[2].abs(),
                                              args[3], args[4].abs(), c, torch.float64,
                                              return_state=True)
            for segs in (1, 4):
                got, st = ops._launch(args, c, segs, True)
                e = float(((got.double() - want).abs() / mag).max())
                es = float(((st.double() - want_st).abs() / mag_st).max())
                log(f"  strong_decay hs={hs} c={c} segments {segs}  max err/W {e:.3e}  state "
                    f"max err/W {es:.3e}")
                if not (e <= WKV_RTOL and es <= WKV_RTOL):
                    raise AssertionError(f"strong decay hs {hs} c {c} segments {segs}: WKV "
                                         f"outside {WKV_RTOL}·W ({e}, state {es})")
                worst = {"max_err_over_w": max(worst["max_err_over_w"], e),
                         "state_max_err_over_w": max(worst["state_max_err_over_w"], es)}
    return worst


def attn_case(ops, ref, name, B, S, N, Kh, dh, causal, dtype, seed=0, dev="cuda"):
    """One flash_attention shape: the kernel within ``ref.attention_limit``
    of a dense softmax in float64, determinism, and timings.  Returns the
    shape's record."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S, N, dh), dtype=np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Kh, dh), dtype=np.float32))
            .to(dev, dtype) for _ in range(2))
    got = ops.flash_attention_gqa(q, k, v, causal)
    if not torch.equal(got, ops.flash_attention_gqa(q, k, v, causal)):
        raise AssertionError(f"{name}: two runs of the kernel differ")
    want, lim = ref.attention_limit(q, k, v, causal)
    err = (got.double() - want).abs()
    vmax, max_abs_err = float(v.abs().max()), float(err.max())
    err_over_limit = float((err / lim).max())
    if not err_over_limit <= 1:
        raise AssertionError(f"{name}: attention outside its limit (max |err| / limit "
                             f"{err_over_limit}, max |err| {max_abs_err}, max|v| {vmax})")
    del got, want, lim, err
    # the log-sum-exp output of the training forward, against float64
    out_l, lse = ops.flash_attention_gqa(q, k, v, causal, return_lse=True)
    want_l = ref.attention_lse_dense(q, k, causal)
    lse_err = (lse.double() - want_l).abs()
    lse_over = float((lse_err / (LSE_ATOL + LSE_RTOL * want_l.abs())).max())
    if not (lse_over <= 1 and torch.equal(out_l, ops.flash_attention_gqa(q, k, v, causal))):
        raise AssertionError(f"{name}: lse outside {LSE_ATOL} + {LSE_RTOL}·|lse| (max |err| "
                             f"{float(lse_err.max())}), or its output differs without lse")
    lse_max_err = float(lse_err.max())
    del out_l, lse, want_l, lse_err

    kernel_ms = cuda_ms(lambda: ops.flash_attention_gqa(q, k, v, causal))
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal), max_reps=3)
    # yardstick only: one PyTorch call computing the same function, which
    # the port never calls
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    size = q.element_size()
    nbytes = (2 * B * S * N + 2 * B * S * Kh) * dh * size   # q, k, v read once, out written once
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * N * dh * pairs
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    rec = {"case": name, "B": B, "S": S, "N": N, "Kh": Kh, "dh": dh, "causal": causal,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": max_abs_err,
           "max_err_over_limit": err_over_limit, "max_abs_v": vmax,
           "lse_max_abs_err": lse_max_err, "lse_err_over_limit": lse_over,
           "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "flops": flops, "tflops_per_s": flops / kernel_ms / 1e9,
           "library_tflops_per_s": flops / library_ms / 1e9,
           "ms_over_library_ms": kernel_ms / library_ms}
    log(f"  {name:<22} B={B} S={S} N={N} Kh={Kh} dh={dh} {'causal' if causal else 'full'} "
        f"{rec['dtype']:<8} kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
        f"{library_ms:.4f}  bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']}; "
        f"{rec['tflops_per_s']:.1f} TFLOP/s, library {rec['library_tflops_per_s']:.1f}; "
        f"kernel/library {rec['ms_over_library_ms']:.3f})  max_abs_err {max_abs_err:.3e}  "
        f"max err/limit {err_over_limit:.3f}  lse max |err| {lse_max_err:.3e} (err/limit "
        f"{lse_over:.3f})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rec


SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS")   # wgmma, TMA tile loads, mbarrier operations


def attention_sass(ops, lib) -> dict:
    """The design of the built flash_attention library, read from its SASS
    (``cuobjdump``): per bf16 kernel (dh, causal) the count of each of
    SASS_OPS, and its dynamic shared memory.  Fails if a bf16 kernel has no
    HGMMA or no UTMALDG."""
    from repro_torch.kernels import _build

    sass = subprocess.run([_build.cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_attention_bf16_kernelILi(\d+)ELb(\d)", line)
            kernel = (f"bf16 dh {m.group(1)} {'causal' if m.group(2) == '1' else 'full'}"
                      if m else None)
            if kernel:
                counts[kernel] = dict.fromkeys(SASS_OPS, 0)
                counts[kernel]["smem_bytes"] = ops.bf16_smem_bytes(int(m.group(1)))
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if kernel and op:
            for name in SASS_OPS:
                counts[kernel][name] += op.group(1).startswith(name)
    if len(counts) != 8:
        raise AssertionError(f"flash_attention: {len(counts)} bf16 kernels in the SASS, not 8")
    for kernel, c in counts.items():
        log(f"  flash_attention SASS {kernel}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
        if not (c["HGMMA"] and c["UTMALDG"]):
            raise AssertionError(f"flash_attention {kernel}: no wgmma (HGMMA) or no TMA load "
                                 f"(UTMALDG) in its SASS")
    return counts


def phase_attn(ops, ref, dev="cuda"):
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("prefill_8x2048", 8, 2048, 32, 4, 64, True, bf16),     # phase 6's prefill
        ("prefill_8x2048_f32", 8, 2048, 32, 4, 64, True, f32),  # its float32 twin
        ("long_1x8192", 1, 8192, 32, 4, 64, True, bf16),
        ("heads_40x128", 2, 1024, 40, 8, 128, True, bf16),      # Qwen2.5-32B / Llama-3 heads
        ("encoder_2x512", 2, 512, 16, 16, 64, False, f32),
        ("ragged_3x1000", 3, 1000, 8, 2, 32, True, f32),        # S off the 64-row tile
        ("smoke_2x24", 2, 24, 8, 1, 16, True, f32),
    ]
    return [attn_case(ops, ref, *c, dev=dev) for c in cases]


def sketch_case(ops, ref, name, n, k, seed=0, dev="cuda"):
    """One count_sketch shape: both forms (the TPU kernel's arrays, and the
    hashed form that the compressor runs) within SKETCH_ROUND · m_j · W_j
    of the float64 sum per bucket j (m_j terms, W_j = Σ|x_t| over them:
    the atomics add in no fixed order), the unsketch within 2⁻²³ · |value|
    of the plain version, and timings.  Returns the shape's record."""
    from repro_torch.core.sketch import Hash2

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=dev)
    h = Hash2.make(np.random.default_rng(seed), k)
    idx = torch.arange(n, device=dev)
    b64, signs = h.bucket(idx), h.sign(idx)
    del idx
    want = torch.zeros(k, dtype=torch.float64, device=dev).index_add_(0, b64,
                                                                       x.double() * signs)
    lim = SKETCH_ROUND * torch.bincount(b64, minlength=k).double() * torch.zeros(
        k, dtype=torch.float64, device=dev).index_add_(0, b64, x.double().abs())
    b32 = b64.int()
    del b64
    worst, outs = {}, {"hashed": ops.count_sketch_hashed(x, h),
                       "arrays": ops.count_sketch(x, b32, signs, k)}
    for form, got in outs.items():
        err = (got.double() - want).abs()
        if bool((err > lim).any()):
            raise AssertionError(f"{name}: {form} sketch outside {SKETCH_ROUND}·m_j·W_j "
                                 f"(max |err| {float(err.max())})")
        worst[form] = (float(err.max()), float((err / lim.clamp(min=1e-300)).max()))
    sk = outs["hashed"]
    del outs, got
    scale = k / n
    est, state = torch.empty_like(x), torch.empty_like(x)
    ops.unsketch(x, sk, h, scale, est=est, state=state)
    want_e = ref.unsketch_ref(sk, h, n, scale)
    un_err = max(float(((est - want_e).abs() > 2.0 ** -23 * want_e.abs()).sum()),
                 float(((state - (x - want_e)).abs() > 2.0 ** -23 * (x - want_e).abs()).sum()))
    if un_err:
        raise AssertionError(f"{name}: unsketch off the plain version at {int(un_err)} elements")
    un_max = float((est - want_e).abs().max())

    # the route the plan did not take, where there is one (phase 1 keeps its time)
    route = ops.plan(n, k)
    alt = (ops.Plan("slabs", slabs=max(1, k // ops.SLAB_BUCKETS)) if route.route == "bins"
           else ops.Plan("bins") if ops.BIN_BUCKETS < k <= ops.BINS_MAX_K else None)
    if alt is not None:
        err = (ops._hashed(x, h, alt).double() - want).abs()
        if bool((err > lim).any()):
            raise AssertionError(f"{name}: the {alt.route} route outside {SKETCH_ROUND}·m_j·W_j")
        del err
    del want, lim, want_e

    kernel_ms = cuda_ms(lambda: ops.count_sketch_hashed(x, h))
    alt_ms = cuda_ms(lambda: ops._hashed(x, h, alt)) if alt is not None else None
    arrays_ms = cuda_ms(lambda: ops.count_sketch(x, b32, signs, k))   # with its range check
    unsketch_ms = cuda_ms(lambda: ops.unsketch(x, sk, h, scale, est=est, state=state))
    plain_ms = cuda_ms(lambda: ref.count_sketch_op(x, h), max_reps=3)
    # yardsticks only: one PyTorch call each, with the buckets precomputed
    library_ms = cuda_ms(lambda: torch.zeros(k, device=dev).index_add_(0, b32, x * signs))
    un_library_ms = cuda_ms(lambda: torch.index_select(sk, 0, b32) * signs * scale)
    nbytes = 4 * n + 4 * k                     # x read once, the sketch written once
    un_bytes = 4 * 3 * n + 4 * k               # x and sk read, est and state written
    rec = {"case": name, "n": n, "k": k, "route": route.route, "slabs": route.slabs,
           "max_abs_err": worst["hashed"][0],
           "max_err_over_limit": worst["hashed"][1], "arrays_max_abs_err": worst["arrays"][0],
           "unsketch_max_abs_err": un_max, "ms": kernel_ms, "arrays_ms": arrays_ms,
           "alt_route": None if alt is None else alt.route, "alt_ms": alt_ms,
           "unsketch_ms": unsketch_ms, "unsketch_bound_ms": un_bytes / HBM_BYTES_PER_S * 1e3,
           "unsketch_library_ms": un_library_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes}
    alt_txt = "" if alt is None else f" ({alt.route} route {alt_ms:.4f})"
    log(f"  {name:<22} n={n} k={k} {route.route} kernel_ms {kernel_ms:.4f}{alt_txt}  arrays_ms "
        f"{arrays_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms "
        f"{rec['bound_ms']:.4f}  unsketch_ms {unsketch_ms:.4f} (library {un_library_ms:.4f}, "
        f"bound {rec['unsketch_bound_ms']:.4f})  max_abs_err {worst['hashed'][0]:.3e} "
        f"(err/limit {worst['hashed'][1]:.3f})")
    del x, b32, signs, sk, est, state
    torch.cuda.empty_cache()
    return rec


def phase_sketch(ops, ref, dev="cuda"):
    cases = [
        ("ref_test_100_16", 100, 16),                     # tests/test_kernels.py's shapes
        ("ref_test_1000_64", 1000, 64),
        ("ref_test_5000_256", 5000, 256),
        ("ref_test_512_128", 512, 128),
        ("ln_f_leaf", 2_048, 1 << 9),                     # TinyLlama's ln_f
        ("norm_leaf", 45_056, 1 << 13),                   # TinyLlama's ln1, ln2 (22 × 2048)
        ("mlp_leaf", 253_755_392, 1 << 25),               # w_down, w_gate, w_up
        ("attn_q_o_leaf", 92_274_688, 1 << 24),           # wq, wo
        ("embed_leaf", 66_060_288, 1 << 23),              # embed.tok, embed.head
        ("attn_k_v_leaf", 11_534_336, 1 << 21),           # wk, wv (22 × 2048 × 256)
    ]
    return [sketch_case(ops, ref, *c, dev=dev) for c in cases]


# ------------------------------------------------------------------ phase 2 --
def oracle_check(schema, trees, scores, tag):
    """Counts exact and totals within 1e-4·Σ|ŷ| of materialize_join +
    predict_rows + bincount, for every grouping table in ``scores``."""
    from repro_torch.core import materialize_join, predict_rows

    J = materialize_join(schema)
    X = torch.stack([J[c].to(torch.float32) for (_, c) in schema.features], dim=1)
    preds = predict_rows(trees, X).double()
    worst = 0.0
    for name, (tot, cnt) in scores.items():
        rows = J["__rows__" + name]
        n = schema.table(name).n_rows
        want_cnt = torch.bincount(rows, minlength=n)
        if not torch.equal(cnt.double(), want_cnt.double()):
            raise AssertionError(f"{tag}: counts grouped by {name} differ from the oracle")
        want_tot = torch.bincount(rows, weights=preds, minlength=n)
        mag = torch.bincount(rows, weights=preds.abs(), minlength=n)
        err = (tot.double() - want_tot).abs()
        if bool((err > 1e-4 * mag + 1e-6).any()):
            raise AssertionError(f"{tag}: totals grouped by {name} off by up to "
                                 f"{float(err.max())}")
        worst = max(worst, float((err / (mag + 1e-12)).max()))
    return worst


def phase_serve(ops, n_fact: int, dev="cuda", profile: bool = False):
    from repro_torch.core import QueryCounter
    from repro_torch.launch import serve_relational as sr
    from repro_torch.obs import get_registry
    from repro_torch.relational.generators import star_schema
    from repro_torch.serving import (ModelRegistry, RelationalScoringService,
                                     compile_ensemble, score_grouped, score_mean_rows)

    args = argparse.Namespace(trees=5, depth=3, requests=2000, concurrency=256,
                              max_batch=64, max_wait_ms=1.0, cache_size=4096, zipf=1.3)
    times = {}
    t0 = time.perf_counter()
    schema = star_schema(seed=0, n_fact=n_fact, n_dim=N_KEYS, device=dev)
    sync(dev)
    times["schema_s"] = time.perf_counter() - t0
    log(f"  schema: tables { {t.name: t.n_rows for t in schema.tables} } "
        f"built in {times['schema_s']:.2f}s")

    reg = get_registry()
    edges0 = reg.counter("sumprod.edges").value
    sync(dev)
    ops.reset_launches()                                   # main path starts here
    t0 = time.perf_counter()
    trees = sr.train(schema, args)
    sync(dev)
    times["train_s"] = time.perf_counter() - t0
    counter = QueryCounter()
    t0 = time.perf_counter()
    ens = compile_ensemble(schema, trees, counter=counter)
    sync(dev)
    times["compile_s"] = time.perf_counter() - t0
    scores = {}
    for t in schema.tables:
        t0 = time.perf_counter()
        scores[t.name] = score_grouped(ens, t.name)
        sync(dev)
        times[f"score_grouped_{t.name}_s"] = time.perf_counter() - t0
    registry = ModelRegistry()
    registry.publish(ens)
    service = RelationalScoringService(registry, schema.label_table,
                                       max_batch=args.max_batch,
                                       max_wait_ms=args.max_wait_ms,
                                       cache_size=args.cache_size)
    t0 = time.perf_counter()
    served = asyncio.run(sr.drive(service, schema.table(schema.label_table).n_rows,
                                  args.requests, args.concurrency, args.zipf, registry,
                                  schema, args, counter))
    sync(dev)
    times["serve_and_swap_s"] = time.perf_counter() - t0
    launches = ops.launches                                # main path ends here
    train_edges = reg.counter("sumprod.edges").value - edges0
    serve_edges = counter.count * (schema.n_tables - 1)
    emissions = train_edges + serve_edges
    log(f"  phase times: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"  QueryCounter: training edges {train_edges}, serving passes {counter.count} "
        f"({serve_edges} edges); segment_sum launches {launches}")
    if not (launches > 0 and launches >= emissions):
        raise AssertionError(f"segment_sum launches {launches} do not cover the "
                             f"{emissions} message emissions of the main path")

    # correctness against the oracle, outside the counted run
    t0 = time.perf_counter()
    worst = oracle_check(schema, trees, scores, "serve")
    v2_ens = registry.get(served["swap_version"])[1]
    want = score_mean_rows(v2_ens, schema.label_table, served["swap_ids"]).cpu().numpy()
    np.testing.assert_allclose(np.asarray(served["swap_scores"]), want, rtol=1e-6, atol=1e-6)
    times["oracle_s"] = time.perf_counter() - t0
    log(f"  oracle: counts exact on every table, worst total error "
        f"{worst:.3e}·Σ|ŷ|; post-swap answers match v{served['swap_version']}")
    out = {"times": times, "launches": launches, "emissions": emissions,
           "train_edges": train_edges, "serve_passes": counter.count,
           "qps": served["qps"], "p50_ms": served["p50_ms"], "p99_ms": served["p99_ms"],
           "cache_hit_rate": served["cache_hit_rate"], "n_fact": n_fact}
    if profile:
        from repro_torch.core import BoostConfig, Booster
        booster = Booster(schema, BoostConfig(n_trees=1, depth=3, mode="sketch",
                                              ssr_mode="off"))
        out["profile"] = {
            "train_one_more_tree": profile_window(lambda: booster.boost(trees, 1)),
            "score_grouped_all_tables": profile_window(
                lambda: [score_grouped(ens, t.name) for t in schema.tables]),
        }
        for k, v in out["profile"].items():
            log(f"  profile {k}: wall {v['wall_ms']:.1f} ms, kernels busy "
                f"{v['device_busy_ms']:.1f} ms, idle share {v['idle_share']:.3f}; "
                f"top {v['top']}")
    return out, schema, trees, ens


def kernel_kind(name: str, split=()) -> str:
    """The class of a CUDA kernel by its name: one of the ``split`` kernels
    (a name or a tuple of names), a library matrix product, an elementwise
    pass, a reduction, or other."""
    for sp in (split,) if isinstance(split, str) else split:
        if sp and sp in name:
            return sp
    if any(t in name for t in ("nvjet", "gemm", "xmma", "cutlass")):
        return "gemm"
    return next((t for t in ("elementwise", "reduce") if t in name), "other")


def profile_window(fn, split=()) -> dict:
    """Device busy and idle share of one call, from a torch.profiler trace:
    the union of the CUDA kernels' intervals over the host wall time of the
    call (the profiler's own host overhead counts as idle).  ``split``
    names a kernel, or a tuple of them: their summed time comes back as
    ``split_ms``; ``by_kind`` sums the kernels' time by ``kernel_kind``."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                  for e in events if e.get("cat") == "kernel")
    if not kern:
        raise AssertionError("profiler trace holds no CUDA kernel")
    busy, end, by_name, by_kind = 0.0, -1.0, {}, {}
    for s, e, name in kern:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
        kind = kernel_kind(name, split)
        by_kind[kind] = by_kind.get(kind, 0.0) + (e - s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "idle_share": max(0.0, 1.0 - busy / 1e3 / wall_ms), "kernels": len(kern),
            "top": [(n[:60], round(ms, 3)) for n, ms in top],
            "by_kind": {k: round(v, 3) for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
            "split_ms": sum(by_kind.get(sp, 0.0)
                            for sp in ((split,) if isinstance(split, str) else split) if sp)}


# ------------------------------------------------------------------ phase 3 --
def phase_paper(n_fact: int, dev="cuda"):
    from repro_torch.core import (BoostConfig, Booster, MaterializedBooster,
                                  materialize_join, predict_rows)
    from repro_torch.relational.generators import star_schema

    t0 = time.perf_counter()
    sch = star_schema(seed=0, n_fact=n_fact, n_dim=N_KEYS, device=dev)
    J = materialize_join(sch)
    X = torch.stack([J[c].to(torch.float32) for (_, c) in sch.features], dim=1)
    y = J[sch.label_column]
    cfg = BoostConfig(n_trees=3, depth=3, mode="exact")
    te, tre = Booster(sch, cfg).fit()
    t_exact = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts, trs = Booster(sch, BoostConfig(n_trees=3, depth=3, mode="sketch", sketch_k=256)).fit()
    t_sketch = time.perf_counter() - t0
    t0 = time.perf_counter()
    tm = MaterializedBooster(X, y, cfg).fit()
    t_mat = time.perf_counter() - t0
    for a, b in zip(te, ts):
        if not torch.equal(a.feat, b.feat):
            raise AssertionError("paper: exact and sketched trees split on different features")
    errs = []
    for e, s in zip(tre.node_ssr, trs.node_ssr):
        np.testing.assert_allclose(s["fact"].cpu().numpy(), e["fact"].cpu().numpy(),
                                   rtol=2e-3, atol=1e-2)
        for tbl in e:
            if tbl != "fact":
                ee, ss = e[tbl].cpu().numpy(), s[tbl].cpu().numpy()
                m = ee > 1.0
                errs.append((np.abs(ss - ee) / ee)[m])
    mean_err = float(np.concatenate(errs).mean())
    if not mean_err < 0.2:
        raise AssertionError(f"paper: mean relative SSR error {mean_err} ≥ 0.2")
    diff = float((predict_rows(te, X) - predict_rows(tm, X)).abs().max())
    if not diff < 2e-2:
        raise AssertionError(f"paper: relational vs materialized predictions differ by {diff}")
    mse = float(torch.mean((y - predict_rows(te, X)) ** 2))
    log(f"  paper: exact fit {t_exact:.2f}s ({tre.queries} queries), sketched fit "
        f"{t_sketch:.2f}s ({trs.queries} queries), materialized fit {t_mat:.2f}s; "
        f"mean rel SSR err (dims) {mean_err:.4f}; max |rel − mat| {diff:.2e}; "
        f"MSE {mse:.4f} vs var(y) {float(torch.var(y)):.4f}")
    return {"exact_s": t_exact, "sketch_s": t_sketch, "materialized_s": t_mat,
            "queries_exact": tre.queries, "queries_sketch": trs.queries,
            "mean_rel_ssr_err": mean_err, "max_pred_diff": diff, "n_fact": n_fact}


# ------------------------------------------------------------------ phase 4 --
def coeff_products(cfg, schema, n_plans: int) -> int:
    """PolyCoeff ⊗ of one sketched fit with per-table SSR.  A level with M
    previous-tree leaves runs τ·(1 + M) sketched passes (trainer
    ``_table_stats``: the labeled sketch, then one per leaf; none while
    M = 0), and a pass ⊗-s each join-tree edge's message into its
    parent's factor once (sumprod ``node_factor``)."""
    total = 0
    for t in range(cfg.n_trees):
        M = t * 2 ** cfg.depth
        if M:
            total += cfg.depth * n_plans * (1 + M) * (schema.n_tables - 1)
    return total


def phase_coeff_hist(pops, sops, n_fact: int, dev="cuda"):
    from repro_torch.core import (BoostConfig, Booster, hist_scores, materialize_join,
                                  predict_rows)
    from repro_torch.core.tree import root_masks
    from repro_torch.relational.generators import star_schema

    t0 = time.perf_counter()
    sch = star_schema(seed=0, n_fact=n_fact, n_dim=N_KEYS, device=dev)
    sync(dev)
    times = {"schema_s": time.perf_counter() - t0}
    out = {"n_fact": n_fact, "times": times}

    # A: the frequency domain, the comparison
    cfg_a = BoostConfig(n_trees=3, depth=3, mode="sketch", sketch_k=256, ssr_mode="per_table",
                        sketch_domain="freq")
    t0 = time.perf_counter()
    ba = Booster(sch, cfg_a)
    ta, tra = ba.fit()
    sync(dev)
    times["fit_a_freq_s"] = time.perf_counter() - t0

    # B: the paper's coefficient domain; every ⊗ is the polymul kernel
    cfg_b = dataclasses.replace(cfg_a, sketch_domain="coeff")
    bb = Booster(sch, cfg_b, hashes=ba.hashes)
    sync(dev)
    pops.reset_launches()                                  # fit B's path starts here
    sops.reset_launches()
    t0 = time.perf_counter()
    tb, trb = bb.fit()
    sync(dev)
    times["fit_b_coeff_s"] = time.perf_counter() - t0
    pm_launches, ss_launches_b = pops.launches, sops.launches   # ... and ends here
    want_products = coeff_products(cfg_b, sch, len(bb.plans))
    if not (pm_launches > 0 and pm_launches == want_products):
        raise AssertionError(f"coeff fit: polymul launches {pm_launches} != the fit's "
                             f"{want_products} PolyCoeff products")
    for x, y in zip(ta, tb):
        if not (torch.equal(x.feat, y.feat) and torch.equal(x.thr, y.thr)):
            raise AssertionError("coeff fit: trees differ from the frequency-domain fit's")
    worst = 0.0
    for ea, eb in zip(tra.node_ssr, trb.node_ssr):
        for tn in ea:
            va, vb = ea[tn].double(), eb[tn].double()
            m = va > 1.0
            rel = ((vb - va).abs() / va)[m]
            if rel.numel():
                worst = max(worst, float(rel.max()))
    if not worst <= 1e-3:
        raise AssertionError(f"coeff fit: SSR off the frequency domain's by rtol {worst}")
    out.update(polymul_launches=pm_launches, coeff_products=want_products,
               segment_sum_launches_b=ss_launches_b,
               ssr_max_rel_diff=worst, queries_a=tra.queries, queries_b=trb.queries,
               edges_a=ba.counter.edges, edges_b=bb.counter.edges)
    log(f"  fit A (freq): {times['fit_a_freq_s']:.2f}s, {tra.queries} queries, "
        f"{ba.counter.edges} edges; fit B (coeff): {times['fit_b_coeff_s']:.2f}s, "
        f"{trb.queries} queries, {bb.counter.edges} edges; trees identical; SSR max rel "
        f"diff {worst:.3e}; polymul launches {pm_launches} = {want_products} ⊗")

    # C: histogram splits through the segment-⊕ kernel route
    cfg_c = BoostConfig(n_trees=3, depth=3, mode="sketch", ssr_mode="off", split_mode="hist",
                        hist_bins=256, hist_route="kernel")
    t0 = time.perf_counter()
    bc = Booster(sch, cfg_c)
    sync(dev)
    times["hist_plans_s"] = time.perf_counter() - t0
    sops.reset_launches()                                  # fit C's path starts here
    pops.reset_launches()
    t0 = time.perf_counter()
    tc, trc = bc.fit()
    sync(dev)
    times["fit_c_hist_s"] = time.perf_counter() - t0
    ss_launches = sops.launches                            # ... and ends here
    if pops.launches:
        raise AssertionError("hist fit: launched polymul without a coefficient sketch")
    hist_launches = ss_launches - bc.counter.edges         # the rest are message emissions
    want_hist = cfg_c.n_trees * cfg_c.depth * len(bc.plans)
    if not (hist_launches > 0 and hist_launches == want_hist):
        raise AssertionError(f"hist fit: {hist_launches} segment-⊕ launches on the histogram "
                             f"route, expected one per table and level ({want_hist})")
    J = materialize_join(sch)
    X = torch.stack([J[c].to(torch.float32) for (_, c) in sch.features], dim=1)
    y = J[sch.label_column].double()
    var = float(torch.var(y, unbiased=False))
    mse_e = float(torch.mean((y - predict_rows(ta, X).double()) ** 2))
    mse_h = float(torch.mean((y - predict_rows(tc, X).double()) ** 2))
    if not ((mse_h - mse_e) / var <= 0.05 and mse_h < 0.5 * var):
        raise AssertionError(f"hist fit: MSE {mse_h} against exact splits' {mse_e}, "
                             f"var(y) {var}")
    route_err = 0.0
    masks = {t.name: root_masks(sch, t.name) for t in sch.tables}     # the first level
    for tn, plan in bc.plans.items():
        c3 = bc.engine.grouped_c3(tn, masks)
        n, s_ = c3[..., 0], c3[..., 1]
        tot_n, tot_s = n.sum(1), s_.sum(1)
        kern = hist_scores(plan, n, s_, tot_n, tot_s, route="kernel")
        gath = hist_scores(plan, n, s_, tot_n, tot_s, route="gather")
        for x, g in zip(kern, gath):
            fin = torch.isfinite(g)
            if not (torch.equal(fin, torch.isfinite(x))
                    and torch.allclose(x[fin], g[fin], rtol=2e-4, atol=2e-4)):
                raise AssertionError(f"hist fit: kernel and gather routes differ on {tn}")
            if bool(fin.any()):
                route_err = max(route_err, float(((x - g).abs() / (g.abs() + 1.0))[fin].max()))
    out.update(hist_launches=hist_launches, segment_sum_launches=ss_launches,
               queries_c=trc.queries, edges_c=bc.counter.edges, mse_exact=mse_e,
               mse_hist=mse_h, var_y=var, hist_route_rel_err=route_err)
    log(f"  fit C (hist, kernel route): plans {times['hist_plans_s']:.2f}s, fit "
        f"{times['fit_c_hist_s']:.2f}s, {trc.queries} queries, {bc.counter.edges} edges; "
        f"segment_sum launches {ss_launches} ({hist_launches} on the histogram route); MSE "
        f"{mse_h:.4f} vs exact splits {mse_e:.4f}, var(y) {var:.4f}; kernel vs gather route "
        f"rel diff {route_err:.3e}")

    # device time of one more tree of B (the third, 16 previous leaves)
    if torch.device(dev).type == "cuda":
        prof = profile_window(lambda: bb.boost(tb[:2], 1), split="poly_mul")
        out["profile_fit_b_third_tree"] = prof
        log(f"  profile fit B, third tree: wall {prof['wall_ms']:.1f} ms, kernels busy "
            f"{prof['device_busy_ms']:.1f} ms (polymul {prof['split_ms']:.1f} ms, rest "
            f"{prof['device_busy_ms'] - prof['split_ms']:.1f} ms), idle share "
            f"{prof['idle_share']:.3f}; top {prof['top']}")
    return out, sch


# ------------------------------------------------------------------ phase 5 --
@contextlib.contextmanager
def swapped(module, name: str, plain):
    """``module.<name>`` (a kernel's wrapper) replaced by ``plain`` inside the block."""
    kernel = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def upcast(t):
    """LM parameters with every bfloat16 tensor in float32."""
    if isinstance(t, dict):
        return {k: upcast(v) for k, v in t.items()}
    if isinstance(t, list):
        return [upcast(v) for v in t]
    return t.float() if t.dtype == torch.bfloat16 else t


def layer_errors(model, params, tokens, module, name: str, plain, oracle):
    """Per layer of one prefill: the largest |error| / limit of the kernel
    (``module.<name>``) and of ``plain``, against ``oracle`` (giving the
    float64 result and the per-element limit), all three on the q, k, v
    that the served model gives that layer."""
    kernel = getattr(module, name)
    errs = []

    def checking(q, k, v, causal=True):
        out = kernel(q, k, v, causal)
        want, lim = oracle(q, k, v, causal)
        errs.append((float(((out.double() - want).abs() / lim).max()),
                     float(((plain(q, k, v, causal).double() - want).abs() / lim).max())))
        return out

    with swapped(module, name, checking):
        model.prefill(params, {"tokens": tokens})
    return errs


def phase_lm(wops, other_ops, cfg, plain, batch: int = 8, prompt: int = 1024,
             decode_tokens: int = 64, dev="cuda", profile: bool = False,
             max_len=None, check_last: bool = False, oracle=None):
    """LM serving (phases 5 and 6): prefill ``batch`` × ``prompt`` ids,
    greedy-decode ``decode_tokens``; the gates (a)–(d) of the module
    docstring.  ``wops``: the wrapper module of the kernel on the path;
    ``plain``: (module, name, plain function) to patch in for gate (b);
    ``max_len``: the prefill's cache room; ``check_last``: gate (c) also
    at the last decode step in float32; ``oracle``: the kernel's function
    in float64 with its per-element limit, which turns gate (b)'s bf16
    half into phase 6's (each layer's kernel output against it, and the
    two bf16 models' distances to the float32 twin)."""
    from repro_torch.models import Model

    kname = wops.__name__.split(".")[-2]
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    sync(dev)
    times = {"init_s": time.perf_counter() - t0}
    def count(t):
        if isinstance(t, dict):
            t = list(t.values())
        return sum(count(v) for v in t) if isinstance(t, list) else t.numel()

    n_params = count(params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (batch, prompt)))
    tokens = tokens.to(dev)
    V = cfg.vocab

    def masked(logits) -> bool:
        pad = logits[:, V:]
        return bool(torch.isfinite(logits[:, :V]).all()) and bool((pad == -1e30).all())

    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": tokens}, max_len)   # warm-up, not counted
        for _ in range(2):
            logits, cache = model.decode_step(params, cache, torch.argmax(logits, -1))
        sync(dev)

        for o in (wops, *other_ops):                                   # main path starts here
            o.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens}, max_len)
        sync(dev)
        times["prefill_s"] = time.perf_counter() - t0
        launches_prefill = wops.launches
        toks = torch.argmax(logits, -1)
        seq, finite = [toks], torch.ones((), dtype=torch.bool, device=dev)
        c = cache
        t0 = time.perf_counter()
        for step in range(decode_tokens):
            dl, c = model.decode_step(params, c, toks)
            if step == 0:
                first_decode = dl
            finite &= torch.isfinite(dl[:, :V]).all() & (dl[:, V:] == -1e30).all()
            toks = torch.argmax(dl, -1)
            seq.append(toks)
        sync(dev)
        times["decode_s"] = time.perf_counter() - t0
        launches = wops.launches                                       # ... and ends here
        others = {o.__name__: o.launches for o in other_ops}

        # (a) finite and masked
        if not (masked(logits) and bool(finite)):
            raise AssertionError("lm: prefill or decode logits not finite, or padded ids unmasked")
        # (d) launches: one a layer per prefill, none while decoding
        if not (launches_prefill == cfg.n_layers and launches == launches_prefill):
            raise AssertionError(f"lm: {kname} launched {launches_prefill} times in the "
                                 f"prefill and {launches - launches_prefill} while decoding; "
                                 f"expected {cfg.n_layers} and 0")
        if any(others.values()):
            raise AssertionError(f"lm: kernels off the LM path launched: {others}")

        # outside the counted run: the same weights in float32, and the plain
        # version patched into the module in place of the kernel
        m32 = Model(cfg.replace(dtype="float32"), device=dev)
        p32 = upcast(params)
        l32, c32 = m32.prefill(p32, {"tokens": tokens}, max_len)
        with swapped(*plain):
            plain_logits, _ = model.prefill(params, {"tokens": tokens})
            plain32, _ = m32.prefill(p32, {"tokens": tokens})
        maxdiff = lambda a, b: float((a - b).abs()[:, :V].max())
        # (b) kernel against plain inside the model: in float32 within
        # LM_F32_RTOL of the largest logit with the same greedy tokens.  In
        # bf16, without an oracle (phase 5), no further apart than the served
        # model is from its float32 twin (its own rounding).  With one (phase
        # 6: the two bf16 attentions round at different places, so the two
        # bf16 models are independent samples of rounding noise), each
        # layer's kernel output on the model's own q, k, v within the
        # oracle's per-element limit, and the two bf16 models no further
        # apart than their two distances to the float32 twin added
        diff_b, diff_b32 = maxdiff(logits, plain_logits), maxdiff(l32, plain32)
        noise, noise_plain = maxdiff(logits, l32), maxdiff(plain_logits, l32)
        lim_b32 = LM_F32_RTOL * float(l32[:, :V].abs().max())
        layer_err = None
        if oracle is None:
            bf16_ok = diff_b <= noise
        else:
            layer_err = layer_errors(model, params, tokens, *plain[:2], plain[2], oracle)
            log(f"  per layer, on the served bf16 model's own q, k, v: max |err| / limit "
                f"against the float64 oracle {max(e for e, _ in layer_err):.3f} for the "
                f"kernel, {max(e for _, e in layer_err):.3f} for the plain version; the "
                f"plain-served bf16 model vs the f32 twin {noise_plain:.4f}")
            bf16_ok = (all(e <= 1 for e, _ in layer_err) and diff_b <= noise + noise_plain)
        # (c) decode after prefill(S) against prefill(S + t).  bf16 at t = 1:
        # no further from the float32 twin's prefill(S + 1) than DECODE_NOISE
        # times the bf16 prefill(S + 1)'s own distance from it, over the same
        # logits in this run (a cache or position fault moves the logits by
        # O(1); rounding does not); the reference's band ratio is printed.
        # float32 within LM_F32_RTOL of the largest logit at t = 1 and, with
        # check_last, at the last step
        tokens_c = torch.cat([tokens, seq[0][:, None]], 1)
        longer, _ = model.prefill(params, {"tokens": tokens_c})
        longer32, _ = m32.prefill(p32, {"tokens": tokens_c})
        diff_c, noise_c = maxdiff(first_decode, longer32), maxdiff(longer, longer32)
        steps32 = decode_tokens if check_last else 1
        ids32, c = [], c32
        nxt32 = torch.argmax(l32, -1)
        for step in range(steps32):
            ids32.append(nxt32)
            dec32, c = m32.decode_step(p32, c, nxt32)
            if step == 0:
                first32 = dec32
            nxt32 = torch.argmax(dec32, -1)
        band_c = float(((first_decode[:, :V].float() - longer[:, :V].float()).abs()
                        / (LM_BAND["atol"] + LM_BAND["rtol"] * longer[:, :V].float().abs())).max())
        diffs_c32, lims_c32 = {}, {}
        for t, dl in {1: first32, steps32: dec32}.items():
            lt, _ = m32.prefill(p32, {"tokens": torch.cat([tokens, torch.stack(ids32[:t], 1)],
                                                          1)})
            diffs_c32[t], lims_c32[t] = maxdiff(dl, lt), LM_F32_RTOL * float(lt[:, :V].abs().max())
        diff_c32, lim_c32 = diffs_c32[1], lims_c32[1]
        log(f"  max |Δlogit|: kernel vs plain {kname} {diff_b:.4f} bf16 (the bf16 model vs its "
            f"f32 twin: {noise:.4f}), {diff_b32:.3e} f32 (limit {lim_b32:.3e}); bf16 decode "
            f"vs the f32 twin's prefill(S + 1) {diff_c:.4f} (limit {DECODE_NOISE} x the bf16 "
            f"prefill(S + 1)'s {noise_c:.4f}: {diff_c / (DECODE_NOISE * noise_c):.4f} of it; "
            f"the reference's band, atol {LM_BAND['atol']}, rtol {LM_BAND['rtol']}, against "
            f"the bf16 prefill(S + 1), not gated: {band_c:.4f}), f32 " + ", ".join(
                f"t = {t}: {diffs_c32[t]:.3e} (limit {lims_c32[t]:.3e})" for t in diffs_c32))
        if not (diff_b32 <= lim_b32 and torch.equal(l32.argmax(-1), plain32.argmax(-1))
                and bf16_ok):
            raise AssertionError(f"lm: kernel and plain {kname} disagree inside the model")
        if not (diff_c <= DECODE_NOISE * noise_c
                and all(diffs_c32[t] <= lims_c32[t] for t in diffs_c32)):
            raise AssertionError(f"lm ({cfg.name}): decode after prefill(S) is off prefill(S + t) "
                                 f"(bf16 {diff_c:.4f} from the f32 twin's prefill(S + 1), "
                                 f"limit {DECODE_NOISE * noise_c:.4f})")
        del m32, p32, c32, c, l32, plain32, dec32, first32, longer32

        prefill_ms = cuda_ms(lambda: model.prefill(params, {"tokens": tokens}, max_len),
                             max_reps=5)
        prof = profile_window(lambda: model.prefill(params, {"tokens": tokens}, max_len),
                              split=kname) if torch.device(dev).type == "cuda" else None
        decode_prof = None
        if profile:
            def steps(n=16):
                lg, c = logits, cache
                for _ in range(n):
                    lg, c = model.decode_step(params, c, torch.argmax(lg, -1))
            decode_prof = profile_window(steps)

    seqs = torch.stack(seq, 1).cpu().numpy()
    decode_ms = times["decode_s"] * 1e3 / decode_tokens
    out = {"arch": cfg.name, "n_params": n_params, "layers": cfg.n_layers, "batch": batch,
           "prompt": prompt, "decode_tokens": decode_tokens, "times": times,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "decode_tok_per_s": batch * decode_tokens / times["decode_s"],
           "launches": launches, "launches_prefill": launches_prefill,
           "launches_decode": launches - launches_prefill,
           "max_diff_kernel_vs_plain": diff_b, "max_diff_kernel_vs_plain_f32": diff_b32,
           "max_diff_bf16_vs_f32": noise, "max_diff_plain_bf16_vs_f32": noise_plain,
           "layer_err_over_limit": layer_err,
           "max_diff_decode_vs_f32_prefill": diff_c, "max_diff_prefill_vs_f32": noise_c,
           "decode_vs_noise_ratio": diff_c / (DECODE_NOISE * noise_c),
           "decode_vs_prefill_band_ratio": band_c,
           "max_diff_decode_vs_prefill_f32": diff_c32,
           "max_diff_decode_vs_prefill_f32_by_step": diffs_c32,
           "sample": seqs[0, :16].tolist()}
    log(f"  {cfg.name}: {n_params:,} parameters ({cfg.n_layers} layers, d {cfg.d_model}), "
        f"init {times['init_s']:.2f}s")
    log(f"  prefill {batch}x{prompt}: {times['prefill_s'] * 1e3:.1f} ms (counted run), "
        f"{prefill_ms:.1f} ms (mean, CUDA events); decode {decode_tokens} tokens: "
        f"{decode_ms:.2f} ms a token, {out['decode_tok_per_s']:.1f} tok/s")
    log(f"  {kname} launches {launches_prefill} in the prefill, "
        f"{launches - launches_prefill} while decoding; greedy row 0 {out['sample']}")
    if prof is not None:
        out["profile_prefill"] = prof
        out["kernel_share_of_prefill"] = prof["split_ms"] / prof["device_busy_ms"]
        log(f"  profile prefill: wall {prof['wall_ms']:.1f} ms, kernels busy "
            f"{prof['device_busy_ms']:.1f} ms ({kname} {prof['split_ms']:.1f} ms, share "
            f"{out['kernel_share_of_prefill']:.3f}), idle share {prof['idle_share']:.3f}; "
            f"by kind {prof['by_kind']}; top {prof['top']}")
    if decode_prof is not None:
        out["profile_decode_16"] = decode_prof
        log(f"  profile 16 decode steps: wall {decode_prof['wall_ms']:.1f} ms, kernels busy "
            f"{decode_prof['device_busy_ms']:.1f} ms ({decode_prof['kernels']} kernels), idle "
            f"share {decode_prof['idle_share']:.3f}; by kind {decode_prof['by_kind']}; top "
            f"{decode_prof['top']}")
    return out


# ------------------------------------------------------------------ phase 7 --
TRAIN_KERNELS = ("flash_attention", "count_sketch_", "unsketch_kernel")


def plain_attention(q, k, v, causal, return_lse):
    """The training forward's plain version: the model's blockwise attention
    at the config's chunks, with its log-sum-exp as the kernel gives it."""
    from repro_torch.kernels.flash_attention.ref import KV_CHUNK, Q_CHUNK, block_attn_fwd

    B, S, N, _ = q.shape
    pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    out, lse = block_attn_fwd(q, k, v, pos, pos, causal, None, Q_CHUNK, KV_CHUNK)
    return out.to(q.dtype), lse.reshape(B, N, S)


def plain_unsketch(x, sk, h, scale=1.0, est=None, state=None):
    """The compressor's unsketch by the plain version (``ref.unsketch_ref``)."""
    from repro_torch.kernels.count_sketch.ref import unsketch_ref

    e = unsketch_ref(sk, h, x.shape[0], scale)
    if state is not None:
        state.copy_(x - e)
    return e if est is None else est.copy_(e)


def train_twin(fops, cops, dev="cuda", n_layers=4, batch=2, seq=2048, n_micro=2):
    """One float32 train step of TinyLlama at full width cut to ``n_layers``
    layers, served by the kernels and then by the plain versions (the same
    weights, batch and hashes).  Returns the comparison's record; raises
    outside its limits (module docstring, phase 7)."""
    from repro_torch import configs
    from repro_torch.kernels.count_sketch import ref as cref
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model, stack_layers
    from repro_torch.optim import CountSketchCompressor, adamw, grad_compress
    from repro_torch.tree import leaves, map_tree, paths

    cfg = configs.get("tinyllama_1_1b").replace(dtype="float32", n_layers=n_layers)
    model = Model(cfg, device=dev)
    base = stack_layers(model.init(torch.Generator(device=dev).manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (batch, seq)))
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=5)

    def run():
        params = map_tree(torch.clone, base)
        comp, rec = CountSketchCompressor(ratio=8), []

        def compress(g):
            comp(g)
            rec.extend(t.clone() for t in leaves(g))
        step = make_train_step(model, ocfg, n_micro, compressor=compress)
        for o in (fops, cops):
            o.reset_launches()
        _, _, m = step(params, adamw.init(ocfg, params), {"tokens": toks.to(dev)})
        sync(dev)
        return float(m["loss"]), rec, params, (fops.launches, cops.launches)

    loss_k, g_k, p_k, launches_k = run()
    with swapped(fops, "flash_attention_gqa", plain_attention), \
            swapped(grad_compress, "count_sketch_hashed", cref.count_sketch_op), \
            swapped(grad_compress, "unsketch", plain_unsketch):
        loss_p, g_p, p_p, launches_p = run()

    if not (launches_k == (2 * n_layers * n_micro, 12) and launches_p == (0, 0)):
        raise AssertionError(f"train twin: launches {launches_k} (kernels) and {launches_p} "
                             f"(plain); expected ({2 * n_layers * n_micro}, 12) and (0, 0)")
    rec = {"layers": n_layers, "batch": batch, "seq": seq, "n_micro": n_micro,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p), "leaves": {}}
    ok = rec["loss_rel_diff"] <= TRAIN_LOSS_RTOL and math.isfinite(loss_k)
    for name, gk, gp, pk, pp, p0 in zip(paths(base), g_k, g_p, leaves(p_k), leaves(p_p),
                                        leaves(base)):
        g_rel = float((gk - gp).abs().max() / gp.abs().max())
        dk, dp = pk.double() - p0.double(), pp.double() - p0.double()
        scale = float(dp.abs().max())
        d = dk - dp
        rec["leaves"][name] = {
            "grad_rel": g_rel, "step_rel": float(d.abs().max()) / scale,
            "frac_over": float((d.abs() > TRAIN_STEP_RTOL * scale).double().mean())}
        ok &= g_rel <= TRAIN_GRAD_RTOL
    log(f"  float32 twin ({n_layers} layers, {batch} x {seq}, n_micro {n_micro}): loss kernel "
        f"{loss_k:.7f} plain {loss_p:.7f} (rel {rec['loss_rel_diff']:.2e}); per leaf max "
        f"|Δg|/max|g| {max(v['grad_rel'] for v in rec['leaves'].values()):.2e}, max "
        f"|ΔΔp|/max|Δp| {max(v['step_rel'] for v in rec['leaves'].values()):.2e}, share of "
        f"elements over {TRAIN_STEP_RTOL}·max|Δp| "
        f"{max(v['frac_over'] for v in rec['leaves'].values()):.2e} (printed, not gated); "
        f"launches {launches_k}")
    if not ok:
        raise AssertionError(f"train twin: kernel- and plain-served steps disagree: {rec}")
    return rec


def train_smoke_checkpoint(dev="cuda"):
    """``launch/train.py``'s ``main`` at the smoke size on the card: 3 steps
    with a checkpoint, the checkpoint restored bit for bit, then a resumed
    fourth step."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train as T
    from repro_torch.tree import leaves

    with tempfile.TemporaryDirectory() as d:
        flags = ["--device", dev, "--compress-grads", "8", "--log-every", "1", "--ckpt-dir", d]
        params = T.main(["--steps", "3", *flags])
        like = T.build(T.parser().parse_args(["--steps", "3", *flags]))
        like.pipe.stop()
        got = Checkpointer(d).restore(3, like.state())   # params, OptState, compressor state
        if not all(torch.equal(a, b) for a, b in zip(leaves(got[0]), leaves(params))):
            raise AssertionError("smoke train: checkpoint does not restore bit for bit")
        if int(got[2]["round"]) != 3:
            raise AssertionError("smoke train: the checkpoint holds compressor round "
                                 f"{int(got[2]['round'])}, not 3")
        T.main(["--steps", "4", "--resume", *flags])
        if Checkpointer(d).latest_step() != 4:
            raise AssertionError("smoke train: the resumed run did not checkpoint step 4")
    log("  smoke size on the card: 3 steps through launch.train.main, checkpoint restored bit "
        "for bit, resumed for step 4")


def phase_train(fops, cops, other_ops, steps: int = 4, batch: int = 8, seq: int = 2048,
                n_micro: int = 8, dev="cuda", profile: bool = False):
    """TinyLlama-1.1B training at full width (phase 7 of the module
    docstring) through ``launch/train.py``'s ``build`` (model, stacked
    params, AdamW state, pipeline) and ``launch/steps.make_train_step``,
    the compressor timed by CUDA events around its call."""
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as T

    args = T.parser().parse_args(["--full", "--steps", str(steps + 1), "--batch", str(batch),
                                  "--seq", str(seq), "--n-micro", str(n_micro),
                                  "--compress-grads", "8", "--ckpt-every", "0", "--device", dev])
    t0 = time.perf_counter()
    tr = T.build(args)
    sync(dev)
    init_s = time.perf_counter() - t0
    cfg = tr.model.cfg
    events = []

    def timed(g):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        tr.compressor(g)
        ev[1].record()
        events.append(ev)
        return g

    step_fn = S.make_train_step(tr.model, tr.ocfg, n_micro, compressor=timed)
    params, state = tr.params, tr.opt_state
    try:
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, tr.next_batch())           # warm-up
        sync(dev)
        warm_s, warm_loss = time.perf_counter() - t0, float(m["loss"])
        events.clear()
        torch.cuda.reset_peak_memory_stats()
        for o in (fops, cops, *other_ops):                                   # main path starts here
            o.reset_launches()
        step_s, losses, norms = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, tr.next_batch())
            sync(dev)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        launches = {"flash_attention": fops.launches, "count_sketch": cops.launches,
                    "count_sketch_unsketch": cops.unsketch_launches}              # ... and ends here
        others = {o.__name__: o.launches for o in other_ops}
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()   # the caching allocator's too
        comp_ms = [a.elapsed_time(b) for a, b in events]
        prof = profile_window(lambda: step_fn(params, state, tr.next_batch()),
                              split=TRAIN_KERNELS) if profile else None
    finally:
        tr.pipe.stop()
    want = {"flash_attention": 2 * cfg.n_layers * n_micro * steps, "count_sketch": 12 * steps,
            "count_sketch_unsketch": 12 * steps}
    if not all(math.isfinite(x) for x in losses + [warm_loss]):
        raise AssertionError(f"train: a loss is not finite: {warm_loss}, {losses}")
    if launches != want or any(others.values()):
        raise AssertionError(f"train: launches {launches}, expected {want}; off the path {others}")
    tokens = batch * seq
    mean_s = sum(step_s) / len(step_s)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch, "seq": seq,
           "n_micro": n_micro, "steps": steps, "compress_ratio": 8, "remat": cfg.remat,
           "init_s": init_s, "warmup_step_s": warm_s, "step_s": step_s,
           "step_ms_mean": mean_s * 1e3, "tokens_per_s": tokens / mean_s,
           "loss_warmup": warm_loss, "losses": losses, "grad_norms": norms,
           "compressor_ms": comp_ms, "peak_memory_bytes": peak,
           "peak_reserved_bytes": peak_reserved,
           "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
           "compressed_bytes": tr.compressor.compressed_bytes(params)}
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, global batch {batch} x {seq}, "
        f"n_micro {n_micro}, remat {cfg.remat}, compression 8; init {init_s:.2f}s, warm-up "
        f"step {warm_s:.2f}s (loss {warm_loss:.4f})")
    log(f"  steps: {', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, mean {mean_s * 1e3:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s; loss {', '.join(f'{x:.4f}' for x in losses)}; "
        f"grad norm {', '.join(f'{x:.3f}' for x in norms)}")
    log(f"  compressor {', '.join(f'{x:.2f}' for x in comp_ms)} ms a step (CUDA events); peak "
        f"memory {peak / 2 ** 30:.2f} GiB allocated, {peak_reserved / 2 ** 30:.2f} reserved; launches {launches} ({out['launches_per_step']} a "
        f"step); sketches {out['compressed_bytes'] / 1e6:.1f} MB a step")
    if prof is not None:
        out["profile_step"] = prof
        log(f"  profile one step: wall {prof['wall_ms']:.1f} ms, kernels busy "
            f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.3f}; by kind "
            f"{prof['by_kind']}; top {prof['top']}")
    out["twin_f32"] = train_twin(fops, cops, dev)
    train_smoke_checkpoint(dev)
    return out


# ------------------------------------------------------------------ phase 8 --
MAINTAIN_ROOTS = ("fact", "dim0")
MAINTAIN_BATCHES = 32
# relational/generators.delta_stream's batch mix: MIX_OPS ops a batch, each
# on a table drawn uniformly, an insert with p 0.35, a delete with p 0.3, else
# an update; at phase 2's scale each op moves a block of rows
MIX_OPS, MIX_P_INSERT, MIX_P_DELETE = 6, 0.35, 0.3
MAINTAIN_BLOCKS = {"fact": {"ins": 4096, "del": 1024, "upd": 1024},
                   "dim": {"ins": 4, "del": 4, "upd": 16}}


def pctl(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


class KeyMint:
    """Fresh join keys for the maintenance stream: ``new()`` mints past
    every key seen; fact rows take them first, and the dimension table
    inserts rows for them later (``pending``), so dangling fact rows
    come to join."""

    def __init__(self, schema):
        self.next = {c: int(schema.table(f"dim{i}").col(c).max()) + 1
                     for i, c in enumerate(("k0", "k1"))}
        self.pending = {c: [] for c in self.next}

    def new(self, col: str, n: int) -> np.ndarray:
        out = np.arange(self.next[col], self.next[col] + n, dtype=np.int64)
        self.next[col] += n
        return out


def draw_mix(rng, names) -> dict:
    """delta_stream's draw of one batch's ops: {table: {kind: ops}}."""
    mix = {n: {"ins": 0, "del": 0, "upd": 0} for n in names}
    for t, r in zip(rng.integers(len(names), size=MIX_OPS), rng.random(MIX_OPS)):
        kind = "ins" if r < MIX_P_INSERT else "del" if r < MIX_P_INSERT + MIX_P_DELETE else "upd"
        mix[names[t]][kind] += 1
    return mix


def maintain_batch(rng, ms, mint, blocks=MAINTAIN_BLOCKS, grow_rows=0):
    """One batch of phase 8(a) and its mix, drawn with vectorised numpy
    from the live slots: ``draw_mix``'s ops, each a block of rows
    (``blocks``).  Fact inserts take keys from the live dimension keys (1 %
    of them freshly minted); a dimension table's inserts take the keys the
    fact table minted, then fresh ones; deletes and updates hit distinct
    live rows; ``grow_rows`` more inserts into dim0."""
    from repro_torch.incremental import TableDelta

    mix = draw_mix(rng, ["fact", "dim0", "dim1"])
    mix["dim0"]["grow"] = grow_rows
    batch = []
    for name, ops in mix.items():
        dt = ms.tables[name]
        blk = blocks["fact" if name == "fact" else "dim"]
        n_ins = ops["ins"] * blk["ins"] + ops.get("grow", 0)
        n_del, n_upd = ops["del"] * blk["del"], ops["upd"] * blk["upd"]
        if not n_ins + n_del + n_upd:
            continue
        live = dt.live_slots()
        pick = live[rng.choice(len(live), n_del + n_upd, replace=False)]
        ins = None
        if n_ins and name == "fact":
            ins = {}
            for i, c in enumerate(("k0", "k1")):
                dim = ms.tables[f"dim{i}"]
                keys = dim.columns[c][dim.live_slots()][rng.integers(0, dim.n_live, n_ins)]
                fresh = rng.random(n_ins) < 0.01
                keys[fresh] = mint.new(c, int(fresh.sum()))
                mint.pending[c].extend(keys[fresh].tolist())
                ins[c] = keys.astype(dt.columns[c].dtype)
        elif n_ins:
            c = "k0" if name == "dim0" else "k1"
            owed, mint.pending[c] = mint.pending[c][:n_ins], mint.pending[c][n_ins:]
            ins = {c: np.concatenate([np.asarray(owed, np.int64),
                                      mint.new(c, n_ins - len(owed))]).astype(dt.columns[c].dtype)}
        feats = [f for f in dt.columns if f not in ("k0", "k1")]
        if ins is not None:
            ins.update({f: rng.standard_normal(n_ins).astype(dt.columns[f].dtype) for f in feats})
        upd_feats = [f for f in feats if f != "y"]
        batch.append(TableDelta(
            name, inserts=ins, deletes=pick[:n_del] if n_del else None,
            updates=(pick[n_del:], {f: rng.standard_normal(n_upd).astype(np.float32)
                                    for f in upd_feats}) if n_upd else None))
    return batch, mix


def audit_maintained(ms, roots, tag):
    """One effective schema (a pinned snapshot's), the recompute oracle
    of every root from it, bit-equal to the maintained scores."""
    t0 = time.perf_counter()
    snap = ms.snapshot(roots, pin_oracle=True)
    worst = 0.0
    for r in roots:
        for got, want in zip(ms.grouped_cached(r), snap.recompute_oracle(r)):
            worst = max(worst, float((got - want).abs().max()))
    if worst != 0.0:
        raise AssertionError(f"maintain: {tag} audit max|diff| {worst}, wants 0.0")
    return time.perf_counter() - t0


async def serve_maintained(ms, root, n_requests=2000, zipf=1.3):
    """Zipf row requests through the service over the published scorer;
    every answer must be grouped_cached's mean for its row."""
    from repro_torch.serving import ModelRegistry, RelationalScoringService

    registry = ModelRegistry()
    registry.publish(ms)
    svc = RelationalScoringService(registry, root, max_batch=64, max_wait_ms=1.0,
                                   cache_size=4096)
    n = ms.n_rows(root)
    ids = np.minimum(np.random.default_rng(2).zipf(zipf, n_requests) - 1, n - 1)
    await svc.start()
    t0 = time.perf_counter()
    got = []
    for chunk in np.array_split(ids, max(1, n_requests // 256)):
        got += await svc.score_many(chunk.tolist())
    dt = time.perf_counter() - t0
    await svc.stop()
    tot, cnt = ms.grouped_cached(root)
    want = (tot / torch.clamp(cnt, min=1.0))[torch.from_numpy(ids).to(tot.device)].cpu().numpy()
    bad = int(np.sum(np.asarray(got, np.float32) != want))
    if bad:
        raise AssertionError(f"maintain: {bad} of {n_requests} service answers differ from "
                             f"grouped_cached's means")
    snap = svc.stats_snapshot()
    return {"requests": n_requests, "qps": n_requests / dt, "p50_ms": snap["latency_ms"]["p50"],
            "p99_ms": snap["latency_ms"]["p99"], "cache_hit_rate": snap["cache_hit_rate"]}


def phase_maintain(ops, schema, trees, dev="cuda", profile=False, blocks=MAINTAIN_BLOCKS):
    """Phase 8(a): maintenance at phase 2's scale on phase 2's schema and
    trees (module docstring)."""
    import os
    import tempfile

    from repro_torch.core import QueryCounter
    from repro_torch.incremental import MaintainedScorer
    from repro_torch.incremental.recover import recover_scorer, save_checkpoint
    from repro_torch.incremental.wal import WalWriter, wal_path
    from repro_torch.serving import compile_ensemble

    roots, n_batches = MAINTAIN_ROOTS, MAINTAIN_BATCHES
    counter = QueryCounter()
    t0 = time.perf_counter()
    ms = MaintainedScorer(compile_ensemble(schema, trees), counter=counter)
    for r in roots:
        ms.grouped_cached(r)                              # the first, full passes
    sync(dev)
    setup_s = time.perf_counter() - t0
    full = sum(len(schema.join_tree(r).edges) for r in roots)
    csr_sides = len({(frozenset((e.child, e.parent)), e.child)      # the CSRs jt() keeps
                     for r in roots for e in schema.join_tree(r).edges})
    rng = np.random.default_rng(8)
    mint = KeyMint(schema)
    rec = {k: [] for k in ("apply_ms", "csr_ms", "csr_builds", "refresh_ms", "edges",
                           "launches", "mix")}
    out = {"n_fact": schema.table("fact").n_rows, "batches": n_batches, "roots": list(roots),
           "setup_s": setup_s, "full_pass_edges": full, "per_batch": rec}
    with tempfile.TemporaryDirectory() as tmp:
        wal_dir, ckpt_dir = os.path.join(tmp, "wal"), os.path.join(tmp, "ckpt")
        wal = WalWriter(wal_dir, sync_every=8).attach(ms.state)
        snap = pin = None
        for b in range(1, n_batches + 1):
            cap0 = ms.tables["dim0"].capacity
            batch, mix = maintain_batch(rng, ms, mint, blocks, grow_rows=2048 if b == 17 else 0)
            rec["mix"].append({t: {k: n for k, n in o.items() if n}       # tables it touched
                               for t, o in mix.items() if any(o.values())})
            t0 = time.perf_counter()
            ms.apply(batch)
            sync(dev)
            rec["apply_ms"].append((time.perf_counter() - t0) * 1e3)
            if b == 17 and not ms.tables["dim0"].capacity >= 2 * cap0:
                raise AssertionError(f"maintain: dim0 capacity {cap0} → "
                                     f"{ms.tables['dim0'].capacity}, expected it doubled")
            e0, csr0, builds0 = counter.edges, ms.state.csr_s, ms.state.csr_builds
            ops.reset_launches()                           # the refresh starts here
            t0 = time.perf_counter()
            for r in roots:
                ms.grouped_cached(r)
            sync(dev)
            rec["refresh_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["launches"].append(ops.launches)           # ... and ends here
            rec["edges"].append(counter.edges - e0)
            rec["csr_ms"].append((ms.state.csr_s - csr0) * 1e3)
            rec["csr_builds"].append(ms.state.csr_builds - builds0)
            log(f"  batch {b:>2}: apply {rec['apply_ms'][-1]:7.2f} ms, refresh "
                f"{rec['refresh_ms'][-1]:7.2f} ms (CSR {rec['csr_ms'][-1]:6.2f}, "
                f"{rec['csr_builds'][-1]} built), edges {rec['edges'][-1]}/{full}, segment_sum "
                f"launches {rec['launches'][-1]}; ops {rec['mix'][-1]}")
            if b in (16, n_batches):
                out[f"audit_{b}_s"] = audit_maintained(ms, roots, f"batch {b}")
            if b == 16:
                save_checkpoint(ms.state, ckpt_dir)
            if b == 19:                                    # pinned before batch 20
                snap = ms.snapshot(roots)
                pin = {r: [t.clone() for t in snap.grouped_cached(r)] for r in roots}
            if b == 24:
                for r in roots:
                    if not all(torch.equal(a, p) for a, p in zip(snap.score_grouped(r), pin[r])):
                        raise AssertionError(f"maintain: the snapshot of version 19 scores "
                                             f"{r} differently after batch 24")
                snap = pin = None
        wal.close()
        out["wal_bytes"] = os.path.getsize(wal_path(wal_dir))
        if rec["launches"] != rec["edges"] or not sum(rec["launches"]) > 0:
            raise AssertionError(f"maintain: refresh launches {rec['launches']} against the "
                                 f"counter's edges {rec['edges']}")
        out["service"] = asyncio.run(serve_maintained(ms, "fact"))
        t0 = time.perf_counter()
        ms2, rep = recover_scorer(compile_ensemble(schema, trees), wal_dir, ckpt_dir,
                                  counter=QueryCounter())
        for r in roots:
            if not all(torch.equal(a, b) for a, b in zip(ms2.grouped_cached(r),
                                                          ms.grouped_cached(r))):
                raise AssertionError(f"maintain: the recovered scorer differs on {r}")
        sync(dev)
        out["recovery_s"] = time.perf_counter() - t0
    if not (rep.recovered_lsn == ms2.data_version == n_batches and rep.checkpoint_lsn == 16):
        raise AssertionError(f"maintain: recovered {rep}, data_version {ms2.data_version}")
    if profile:                           # the recovered scorer takes one more batch
        batch, _ = maintain_batch(rng, ms2, mint, blocks)
        out["profile_apply"] = profile_window(lambda: ms2.apply(batch))
        out["profile_refresh"] = profile_window(lambda: [ms2.grouped_cached(r) for r in roots])
        for k in ("profile_apply", "profile_refresh"):
            v = out[k]
            log(f"  {k}: wall {v['wall_ms']:.1f} ms, kernels busy {v['device_busy_ms']:.1f} "
                f"ms, idle share {v['idle_share']:.3f}; by kind {v['by_kind']}")
    out.update(recovered_lsn=rep.recovered_lsn, replayed=rep.replayed,
               launches=sum(rec["launches"]), edges=sum(rec["edges"]),
               full_edges=full * n_batches, csr_builds=sum(rec["csr_builds"]),
               csr_builds_full=csr_sides * n_batches,
               refreshes_by_edges={e: rec["edges"].count(e) for e in sorted(set(rec["edges"]))},
               clean_tables=sum(len(ms.tables) - len(m) for m in rec["mix"]),
               capacities={t: dt.capacity for t, dt in ms.tables.items()})
    for k in ("apply_ms", "csr_ms", "refresh_ms"):
        out[k] = {"p50": pctl(rec[k], 50), "p99": pctl(rec[k], 99)}
    log(f"  maintain: setup {setup_s:.2f}s; over {n_batches} batches apply p50 "
        f"{out['apply_ms']['p50']:.2f} / p99 {out['apply_ms']['p99']:.2f} ms, refresh p50 "
        f"{out['refresh_ms']['p50']:.2f} / p99 {out['refresh_ms']['p99']:.2f} ms, CSR rebuild "
        f"p50 {out['csr_ms']['p50']:.2f} / p99 {out['csr_ms']['p99']:.2f} ms; edges "
        f"{out['edges']} of {out['full_edges']} full-pass (refreshes by edges "
        f"{out['refreshes_by_edges']}), CSRs built {out['csr_builds']} of "
        f"{out['csr_builds_full']}, {out['clean_tables']} of {len(ms.tables) * n_batches} "
        f"tables untouched by their batch, segment_sum launches {out['launches']}; audits "
        f"{out['audit_16_s']:.2f}s and {out[f'audit_{n_batches}_s']:.2f}s bit-equal; snapshot "
        f"of version 19 bit-equal after batch 24")
    log(f"  maintain: service {out['service']['requests']} Zipf(1.3) requests, "
        f"{out['service']['qps']:.0f} QPS, p50 {out['service']['p50_ms']:.2f} / p99 "
        f"{out['service']['p99_ms']:.2f} ms, every answer grouped_cached's; recovery "
        f"{out['recovery_s']:.2f}s (checkpoint 16 + {rep.replayed} replayed, WAL "
        f"{out['wal_bytes']} bytes) bit-equal to the live scorer")
    return out


def phase_retrain(ops, schema, n_batches=4, rows_per_batch=16384, dev="cuda", profile=False):
    """Phase 8(b): warm-start refits at phase 4's scale on phase 4's
    schema (module docstring)."""
    from repro_torch.core import BoostConfig, Booster
    from repro_torch.incremental import IncrementalBooster
    from repro_torch.relational.generators import drift_stream

    cfg = BoostConfig(n_trees=3, depth=3, mode="sketch", ssr_mode="off")
    t0 = time.perf_counter()
    ib = IncrementalBooster(schema, cfg)
    sync(dev)
    out = {"n_fact": schema.table("fact").n_rows, "setup_s": time.perf_counter() - t0,
           "refits": []}
    t0 = time.perf_counter()
    ib.fit()
    sync(dev)
    out["fit_s"] = time.perf_counter() - t0
    launches = 0
    for b, batch in enumerate(drift_stream(schema, ib.live_rows, seed=9, n_batches=n_batches,
                                           rows_per_batch=rows_per_batch)):
        frozen = list(ib.trees)
        sig0 = ib.engine.signature_s
        ops.reset_launches()                               # the refit starts here
        t0 = time.perf_counter()
        rep = ib.refit(deltas=batch, n_new_trees=1, drift_threshold=-math.inf)
        sync(dev)
        refit_s = time.perf_counter() - t0
        refit_launches = ops.launches                      # ... and ends here
        launches += refit_launches
        if refit_launches != rep.edges:
            raise AssertionError(f"retrain: refit {b} launched segment_sum {refit_launches} "
                                 f"times for {rep.edges} message emissions")
        t0 = time.perf_counter()                           # a scratch warm start:
        oracle = Booster(ib.effective_schema(), cfg, hashes=ib.booster.hashes)  # its schema,
        sync(dev)
        schema_s = time.perf_counter() - t0
        want, _ = oracle.boost(frozen, 1)                  # ... and its tree
        sync(dev)
        scratch_s = time.perf_counter() - t0
        got = ib.trees[-1]
        if not (torch.equal(got.feat, want[-1].feat)
                and torch.allclose(got.thr, want[-1].thr, rtol=1e-6, atol=1e-6)
                and torch.allclose(got.leaf, want[-1].leaf, rtol=1e-4, atol=1e-5)):
            raise AssertionError(f"retrain: refit {b} differs from the scratch warm start: "
                                 f"{got} against {want[-1]}")
        if not rep.edges < oracle.counter.edges:
            raise AssertionError(f"retrain: refit {b} emitted {rep.edges} edges, the scratch "
                                 f"warm start {oracle.counter.edges}")
        r = {"refit_s": refit_s, "scratch_s": scratch_s, "scratch_schema_s": schema_s,
             "edges": rep.edges,
             "scratch_edges": oracle.counter.edges, "edge_ratio": rep.edges / oracle.counter.edges,
             "signature_ms": (ib.engine.signature_s - sig0) * 1e3, "queries": rep.queries,
             "drift": rep.drift, "mse_after": rep.mse_after,
             "cache_hit_rate": rep.cache_hit_rate, "launches": refit_launches}
        out["refits"].append(r)
        log(f"  refit {b}: {refit_s:.2f}s against the scratch warm start's {scratch_s:.2f}s "
            f"(its schema and split plans {schema_s:.2f}s); "
            f"edges {rep.edges} / {oracle.counter.edges} = {r['edge_ratio']:.3f}; signatures "
            f"{r['signature_ms']:.1f} ms; segment_sum launches {refit_launches}; drift "
            f"{rep.drift:.3f}, mse {rep.mse_after:.4f}; trees match")
    if not launches > 0:
        raise AssertionError("retrain: no segment_sum launch in the refits")
    out["launches"] = launches
    if profile:                           # one more drift batch and refit
        batch = next(drift_stream(schema, ib.live_rows, seed=10, n_batches=1,
                                  rows_per_batch=rows_per_batch))
        v = out["profile_refit"] = profile_window(
            lambda: ib.refit(deltas=batch, n_new_trees=1, drift_threshold=-math.inf))
        log(f"  profile one more refit: wall {v['wall_ms']:.1f} ms, kernels busy "
            f"{v['device_busy_ms']:.1f} ms, idle share {v['idle_share']:.3f}; by kind "
            f"{v['by_kind']}")
    log(f"  retrain: setup {out['setup_s']:.2f}s, fit {out['fit_s']:.2f}s; {n_batches} refits, "
        f"segment_sum launches {launches}")
    return out


# ------------------------------------------------------------------ phase 9 --
OPERATED_SLO = "latency=50ms@0.99,errors=0.01,staleness=5s"
FLIGHT_RING = 4096
AB_VARIANTS = ((7, 0.5), (8, 0.25), (9, 0.125))   # (seed, shrinkage) of each A/B variant
FOLLOW_CHECKPOINT, FOLLOW_LAST = 8, 24            # writer checkpoints, then tails to here
FOLLOW_PERIOD_S = 0.05
ENDPOINTS = ("/metricsz", "/healthz", "/statusz", "/tracez")


def fetch(url: str, timeout: float = 10.0):
    """(HTTP status, body) of a GET; a 503 from /healthz is an answer."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def prom_value(text: str, name: str) -> float:
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    if m is None:
        raise AssertionError(f"operate: {name} missing from /metricsz")
    return float(m.group(1))


def grouped_means(ens, root, ids) -> np.ndarray:
    tot, cnt = ens.grouped_cached(root)
    return (tot / torch.clamp(cnt, min=1.0))[torch.from_numpy(np.asarray(ids)).to(tot.device)
                                              ].cpu().numpy()


def serve_args(tmp, telemetry: bool):
    """``serve_relational``'s arguments for phase 2's traffic, every
    telemetry flag on or off."""
    import os

    args = argparse.Namespace(
        trees=5, depth=3, requests=2000, concurrency=256, max_batch=64, max_wait_ms=1.0,
        cache_size=4096, zipf=1.3, trace=None, slo=None, flight=None, flight_latency_ms=None,
        metrics_port=None, sample=None, sample_interval=0.25)
    if telemetry:
        args.trace = os.path.join(tmp, "serve_trace.json")
        args.slo, args.flight, args.metrics_port = OPERATED_SLO, FLIGHT_RING, 0
        args.sample = os.path.join(tmp, "serve_samples.jsonl")
    return args


def operate_service(ops, schema, trees, ens, tmp, dev="cuda"):
    """Phase 9(a): phase 2's requests through ``serve_relational``'s
    wiring, telemetry off, then on (module docstring)."""
    from repro_torch.core import QueryCounter
    from repro_torch.launch import serve_relational as sr
    from repro_torch.serving import ModelRegistry, compile_ensemble

    group = schema.label_table
    n_rows = schema.table(group).n_rows
    out = {}
    for mode in ("off", "on"):
        args = serve_args(tmp, mode == "on")
        registry = ModelRegistry()
        counter = QueryCounter()
        registry.publish(compile_ensemble(schema, trees, counter=counter))
        w = sr.wire(args, registry, group)
        probe = None
        if mode == "on":
            w.flight.out_dir = tmp

            def probe(stage, url=w.telemetry.url):
                paths = ENDPOINTS if stage == "mid" else ENDPOINTS[:1]
                return {p: fetch(url(p)) for p in paths}
        sync(dev)
        ops.reset_launches()                               # the served run starts here
        served = asyncio.run(sr.drive(w.service, n_rows, args.requests, args.concurrency,
                                      args.zipf, registry, schema, args, counter,
                                      telemetry=w.telemetry, hot_swap=False, probe=probe))
        sync(dev)
        launches = ops.launches                            # ... and ends here
        if served["shed_chunks"] or w.service.stats.errors:
            raise AssertionError(f"operate[{mode}]: {served['shed_chunks']} chunks shed, "
                                 f"{w.service.stats.errors} errors")
        bad = int(np.sum(np.asarray(served["answers"], np.float32)
                         != grouped_means(ens, group, served["ids"])))
        if bad:
            raise AssertionError(f"operate[{mode}]: {bad} of {args.requests} answers differ "
                                 f"from phase 2's grouped_cached means")
        if launches != len(schema.join_tree(group).edges):
            raise AssertionError(f"operate[{mode}]: segment_sum launched {launches} times, "
                                 f"expected one pass's {len(schema.join_tree(group).edges)}")
        rec = {k: served[k] for k in ("qps", "p50_ms", "p99_ms", "batches", "cache_hit_rate")}
        rec["launches"] = launches
        if mode == "on":
            stats = w.service.stats_snapshot()
            dump = w.flight.trigger("chip_smoke forced dump", phase="9a")
            files = sr.finish(args, w)
            mid, end = served["probes"]["mid"], served["probes"]["end"]
            codes = {p: c for p, (c, _) in mid.items()}
            if (any(codes[p] != 200 for p in ENDPOINTS if p != "/healthz")
                    or codes["/healthz"] not in (200, 503) or end["/metricsz"][0] != 200):
                raise AssertionError(f"operate: endpoints answered {codes}, then "
                                     f"/metricsz {end['/metricsz'][0]}")
            n_mid = prom_value(mid["/metricsz"][1], "repro_service_requests")
            n_end = prom_value(end["/metricsz"][1], "repro_service_requests")
            if not n_mid < n_end == stats["requests"]:
                raise AssertionError(f"operate: repro_service_requests mid {n_mid}, end {n_end}, "
                                     f"service {stats['requests']}")
            doc = json.loads(Path(args.trace).read_text())
            n_batch_spans = sum(e["name"] == "service.batch" for e in doc["traceEvents"])
            if n_batch_spans != stats["batches"]:
                raise AssertionError(f"operate: {n_batch_spans} service.batch spans for "
                                     f"{stats['batches']} batches")
            if dump is None:
                raise AssertionError("operate: the forced flight trigger wrote no dump")
            fl = json.loads(Path(dump).read_text())["traceEvents"]
            n_spans = sum(e["ph"] == "X" for e in fl)
            if not (0 < n_spans <= FLIGHT_RING and [e["ph"] for e in fl].count("i") == 1):
                raise AssertionError(f"operate: the flight dump holds {n_spans} spans")
            health = json.loads(mid["/healthz"][1])
            rec.update(slo=served["slo"], health_mid=health["state"],
                       requests_mid=n_mid, requests_end=n_end, trace_spans=files["trace_spans"],
                       batch_spans=n_batch_spans, flight_dump_spans=n_spans,
                       samples=files["samples"],
                       tracez_spans=len(json.loads(mid["/tracez"][1])["spans"]))
        out[mode] = rec
        del registry, w
    on, off = out["on"], out["off"]
    slo = on["slo"]
    log(f"  operate (a): telemetry on {on['qps']:.0f} QPS, p50 {on['p50_ms']:.3f} / p99 "
        f"{on['p99_ms']:.3f} ms; off {off['qps']:.0f} QPS, p50 {off['p50_ms']:.3f} / p99 "
        f"{off['p99_ms']:.3f} ms; /metricsz requests mid {on['requests_mid']:.0f}, end "
        f"{on['requests_end']:.0f}; {on['batch_spans']} service.batch spans of "
        f"{on['trace_spans']}; flight dump {on['flight_dump_spans']} spans; "
        f"{on['samples']} samples; SLO {slo['state']} "
        + ", ".join(f"{n} burn {o['burn_fast']:.3f}/{o['burn_slow']:.3f} [{o['state']}]"
                    for n, o in slo["objectives"].items())
        + "; answers bit-equal to phase 2's")
    return out


def stacked_ab(ops, schema, trees, ens, dev="cuda"):
    """Phase 9(b): four variants in one stacked pass (module docstring)."""
    from repro_torch.core import BoostConfig, Booster
    from repro_torch.serving import ModelRegistry, compile_ensemble, stack_ensembles

    t0 = time.perf_counter()
    variants = [Booster(schema, BoostConfig(n_trees=5, depth=3, mode="sketch", ssr_mode="off",
                                            seed=seed, lr=lr)).fit()[0]
                for seed, lr in AB_VARIANTS]
    sync(dev)
    out = {"train_s": time.perf_counter() - t0, "tables": {}}
    models = [ens] + [compile_ensemble(schema, t) for t in variants]
    registry = ModelRegistry()
    versions = [registry.publish(m) for m in models]
    st = registry.stacked()
    C = st.factors[schema.names[0]].shape[1]
    if C != sum(m.total_leaves for m in models) or st.ensembles != models:
        raise AssertionError(f"stacked: {C} channels over {st.n_models} models")
    st16 = stack_ensembles([compile_ensemble(schema, m.trees, factor_dtype=torch.bfloat16)
                            for m in models])
    launches = 0
    for t in schema.names:
        edges = len(schema.join_tree(t).edges)
        sync(dev)
        ops.reset_launches()                               # the stacked pass starts here
        got = st.score_grouped(t)
        sync(dev)
        n_stacked = ops.launches                           # ... and ends here
        launches += n_stacked
        ops.reset_launches()
        own = [m.score_grouped(t) for m in models]
        sync(dev)
        n_separate = ops.launches
        if (n_stacked, n_separate) != (edges, len(models) * edges):
            raise AssertionError(f"stacked {t}: {n_stacked} launches stacked and {n_separate} "
                                 f"separate, for {edges} edges a pass")
        for m, ((tot, cnt), (want_tot, want_cnt)) in enumerate(zip(got, own)):
            if not (torch.equal(tot, want_tot) and torch.equal(cnt, want_cnt)):
                raise AssertionError(f"stacked {t}: model {m} differs from its own pass")
        del got, own
        c32 = st._sp(st._sem, st.factors, group_by=t)
        c16 = st16._sp(st16._sem, st16.factors, group_by=t).float()
        ratio = float(((c16 - c32).abs() / (BF16_ULP * c32.abs()).clamp(min=1e-30)).max())
        if not bool(((c16 - c32).abs() <= BF16_ULP * c32.abs()).all()):
            raise AssertionError(f"stacked {t}: bf16 counts past 2^-8 of the f32 ones "
                                 f"({ratio:.3f} of the limit)")
        del c32, c16
        rec = {"edges": edges, "launches_stacked": n_stacked, "launches_separate": n_separate,
               "stacked_ms": cuda_ms(lambda: st.score_grouped(t), max_reps=10),
               "separate_ms": cuda_ms(lambda: [m.score_grouped(t) for m in models], max_reps=10),
               "stacked_bf16_ms": cuda_ms(lambda: st16.score_grouped(t), max_reps=10),
               "bf16_err_over_limit": ratio}
        out["tables"][t] = rec
        log(f"  stacked (b) {t:<5}: one pass at C={C} {rec['stacked_ms']:.3f} ms (bf16 "
            f"{rec['stacked_bf16_ms']:.3f}) against 4 passes {rec['separate_ms']:.3f} ms; "
            f"launches {n_stacked} / {n_separate}; every model bit-equal to its own pass; "
            f"bf16 counts at {ratio:.3f} of 2^-8")
    if registry.stacked() is not st:
        raise AssertionError("stacked: stacked() did not return its cached object")
    registry.swap(versions[-1], models[1])
    st2 = registry.stacked()
    if st2 is st or st2.ensembles[-1] is not models[1] or registry.stacked() is not st2:
        raise AssertionError("stacked: a swap did not give a new stacked object")
    same = [all(torch.equal(a.leaf, b.leaf) for a, b in zip(trees, v)) for v in variants]
    out.update(channels=C, launches=launches, variants_equal_to_phase2=same)
    log(f"  stacked (b): variants trained in {out['train_s']:.2f}s (trees equal to phase 2's: "
        f"{same}); stacked() cached until a swap")
    return out


def follow_writer(ops, schema, trees, tmp, dev="cuda"):
    """Phase 9(c): a WAL-follower replica of a live writer (module
    docstring)."""
    import os
    import threading

    from repro_torch.core import QueryCounter
    from repro_torch.incremental import MaintainedScorer
    from repro_torch.incremental.recover import save_checkpoint
    from repro_torch.incremental.wal import WalWriter
    from repro_torch.launch import serve_relational as sr
    from repro_torch.serving import ModelRegistry, RelationalScoringService, compile_ensemble

    roots = MAINTAIN_ROOTS
    wal_dir = os.path.join(tmp, "wal")
    writer = MaintainedScorer(compile_ensemble(schema, trees), counter=QueryCounter())
    for r in roots:
        writer.grouped_cached(r)
    wal = WalWriter(wal_dir, sync_every=8).attach(writer.state)
    rng, mint = np.random.default_rng(8), KeyMint(schema)   # phase 8's batches

    def step(b):
        batch, _ = maintain_batch(rng, writer, mint, grow_rows=2048 if b == 17 else 0)
        writer.apply(batch)
        for r in roots:
            writer.grouped_cached(r)
        sync(dev)

    for b in range(1, FOLLOW_CHECKPOINT + 1):
        step(b)
    save_checkpoint(writer.state, os.path.join(wal_dir, "ckpt"))
    t0 = time.perf_counter()
    rcounter = QueryCounter()
    replica, follower, rep = sr.open_follower(compile_ensemble(schema, trees), wal_dir,
                                              poll_ms=10.0, counter=rcounter)
    replica.grouped_cached("fact")
    sync(dev)
    recover_s = time.perf_counter() - t0
    if (rep.checkpoint_lsn, rep.replayed) != (FOLLOW_CHECKPOINT, 0):
        raise AssertionError(f"follow: recovered {rep}")
    slo = sr.make_slo("staleness=5s", follower=True)
    extra = sr.follower_staleness(follower, grace_s=5.0)
    registry = ModelRegistry()
    registry.publish(replica)
    svc = RelationalScoringService(registry, "fact", max_batch=64, max_wait_ms=1.0,
                                   cache_size=4096, slo=slo, extra_staleness=extra)
    writer_ms, errors = [], []
    writer_edges0, replica_edges0 = writer.counter.edges, rcounter.edges

    def write():
        try:
            t_start = time.perf_counter()
            for k, b in enumerate(range(FOLLOW_CHECKPOINT + 1, FOLLOW_LAST + 1)):
                time.sleep(max(0.0, t_start + k * FOLLOW_PERIOD_S - time.perf_counter()))
                t = time.perf_counter()
                step(b)
                writer_ms.append((time.perf_counter() - t) * 1e3)
            wal.close()
        except BaseException as e:       # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    n_rows = schema.table("fact").n_rows
    ids = np.minimum(np.random.default_rng(3).zipf(1.3, 1 << 16) - 1, n_rows - 1)
    states, extras = [], []

    async def serve_tail(thread):
        await svc.start()
        answered, k = 0, 0
        while thread.is_alive():
            chunk = ids[(k * 256) % len(ids):][:256].tolist()
            answered += len(await svc.score_many(chunk))
            k += 1
            rep_ = slo.evaluate()
            states.append((rep_["state"], rep_["objectives"]["staleness"]["state"]))
            extras.append(extra())
            await asyncio.sleep(0.005)
        await svc.stop()
        return answered

    sync(dev)
    ops.reset_launches()                                   # the tail starts here
    thread = threading.Thread(target=write, name="wal-writer")
    t0 = time.perf_counter()
    thread.start()
    answered = asyncio.run(serve_tail(thread))
    thread.join()
    follower.stop(drain=True)
    sync(dev)
    tail_s = time.perf_counter() - t0
    launches = ops.launches                                # ... and ends here
    writer_edges, replica_edges = writer.counter.edges - writer_edges0, rcounter.edges - replica_edges0
    if errors:
        raise errors[0]
    if follower.applied_lsn != writer.data_version or writer.data_version != FOLLOW_LAST:
        raise AssertionError(f"follow: applied lsn {follower.applied_lsn}, writer at "
                             f"{writer.data_version}")
    for r in roots:
        if not all(torch.equal(a, b) for a, b in zip(replica.grouped_cached(r),
                                                      writer.grouped_cached(r))):
            raise AssertionError(f"follow: the replica's {r} scores differ from the writer's")
    stale_states = [s for _, s in states]
    if "unhealthy" in stale_states or svc.stats.shed or svc.stats.errors:
        raise AssertionError(f"follow: staleness states {sorted(set(stale_states))}, shed "
                             f"{svc.stats.shed}, errors {svc.stats.errors}")
    if not launches > 0:
        raise AssertionError("follow: no segment_sum launch during the tail")
    registry2 = ModelRegistry()
    registry2.publish(replica)
    svc2 = RelationalScoringService(registry2, "fact", max_batch=64, max_wait_ms=1.0)

    async def final():
        await svc2.start()
        try:
            return await svc2.score_many(ids[:256].tolist())
        finally:
            await svc2.stop()

    got = np.asarray(asyncio.run(final()), np.float32)
    bad = int(np.sum(got != grouped_means(replica, "fact", ids[:256])))
    if bad:
        raise AssertionError(f"follow: {bad} of 256 answers differ from the replica's means")
    lag = follower.apply_lag_s.summary()
    out = {"recover_s": recover_s, "tail_s": tail_s, "records": FOLLOW_LAST - FOLLOW_CHECKPOINT,
           "applied_lsn": follower.applied_lsn, "answered": answered,
           "lag_p50_s": lag["p50"], "lag_p99_s": lag["p99"], "lag_max_s": lag["max"],
           "writer_ms": {"p50": pctl(writer_ms, 50), "p99": pctl(writer_ms, 99)},
           "launches": launches, "writer_edges": writer_edges, "replica_edges": replica_edges,
           "slo_states": sorted(set(s for s, _ in states)),
           "staleness_states": sorted(set(stale_states)),
           "extra_staleness_max_s": max(extras, default=0.0),
           "service_staleness_s": svc.stats.staleness_s.value}
    log(f"  follow (c): recovered at lsn {rep.recovered_lsn} in {recover_s:.2f}s; tailed "
        f"{out['records']} records in {tail_s:.2f}s to lsn {follower.applied_lsn}, replication "
        f"lag p50 {lag['p50'] * 1e3:.1f} / p99 {lag['p99'] * 1e3:.1f} ms (max "
        f"{lag['max'] * 1e3:.1f}); writer p50 {out['writer_ms']['p50']:.1f} / p99 "
        f"{out['writer_ms']['p99']:.1f} ms a batch; {answered} requests answered during the "
        f"tail, SLO states {out['slo_states']}, staleness {out['staleness_states']} (extra max "
        f"{out['extra_staleness_max_s']:.3f}s); segment_sum launches {launches} (edges: writer "
        f"{out['writer_edges']}, replica {out['replica_edges']}); replica bit-equal to the "
        f"writer on {list(roots)}, 256 answers its means")
    return out


def phase_operate(ops, schema, trees, ens, dev="cuda"):
    """Phase 9 (module docstring): (a), (b) and (c), then their peak
    memory; returns their records."""
    import tempfile

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"service": operate_service(ops, schema, trees, ens, tmp, dev)}
        gc.collect()
        out["stacked"] = stacked_ab(ops, schema, trees, ens, dev)
        gc.collect()
        torch.cuda.empty_cache()
        out["follow"] = follow_writer(ops, schema, trees, tmp, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out.update(seconds=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches={"service": out["service"]["on"]["launches"],
                         "stacked": out["stacked"]["launches"],
                         "follow": out["follow"]["launches"]})
    log(f"  phase 9 took {out['seconds']:.1f}s, peak memory {out['peak_gib']:.2f} GiB "
        f"allocated; segment_sum launches {out['launches']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-fact", type=int, default=1 << 22, help="serve-phase fact rows")
    ap.add_argument("--paper-n-fact", type=int, default=1 << 18, help="paper-phase fact rows")
    ap.add_argument("--coeff-n-fact", type=int, default=1 << 20,
                    help="phase-4 fact rows (coefficient-domain and histogram fits)")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 2, trace one more training round and one scoring "
                         "pass per table, in phases 5 and 6 16 decode steps, in phase 7 "
                         "one more train step, and in phase 8 one more delta batch's apply "
                         "and refresh and one more refit, with torch.profiler and print the "
                         "device's busy and idle share")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import (count_sketch, flash_attention, polymul, rwkv6_chunk,
                                     segment_sum)
    from repro_torch.kernels.count_sketch import ops as cops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.polymul import ops as pops
    from repro_torch.kernels.rwkv6_chunk import ops as wops
    from repro_torch.kernels.segment_sum import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log("card (nvidia-smi name, power.limit):")
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}")

    t0 = time.perf_counter()
    sources = (segment_sum, polymul, rwkv6_chunk, flash_attention, count_sketch)
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source, started together
        builds = list(pool.map(lambda m: m.build(verbose=True), sources))
    log(f"build: {', '.join(lib.name for lib, _ in builds)} in "
        f"{time.perf_counter() - t0:.2f}s")
    for _, build_log in builds:
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    log("phase 1: segment_sum, polymul, rwkv6_chunk, flash_attention and count_sketch kernels "
        "vs plain versions on the card")
    shapes = phase_kernel(ops, ref)
    pshapes = phase_polymul(pops, polymul)
    wshapes = phase_wkv(wops, rwkv6_chunk)
    wstrong = wkv_strong_decay(wops, rwkv6_chunk)
    fsass = attention_sass(fops, builds[sources.index(flash_attention)][0])
    fshapes = phase_attn(fops, flash_attention)
    cshapes = phase_sketch(cops, count_sketch)
    log(f"phase 2: serve path at {args.n_fact} fact rows")
    serve, serve_schema, serve_trees, serve_ens = phase_serve(ops, args.n_fact,
                                                              profile=args.profile)
    log(f"phase 3: paper check at {args.paper_n_fact} fact rows")
    paper = phase_paper(args.paper_n_fact)
    log(f"phase 4: paper's coefficient-domain sketch and histogram splits at "
        f"{args.coeff_n_fact} fact rows")
    coeff, coeff_schema = phase_coeff_hist(pops, ops, args.coeff_n_fact)
    log(f"phase 8: incremental maintenance on phase 2's schema and trees "
        f"({MAINTAIN_BATCHES} delta batches, WAL, checkpoint, recovery), then warm-start "
        f"refits on phase 4's schema")
    t0 = time.perf_counter()
    for o in (pops, wops, fops, cops):
        o.reset_launches()
    maintain = phase_maintain(ops, serve_schema, serve_trees, profile=args.profile)
    retrain = phase_retrain(ops, coeff_schema, profile=args.profile)
    if any(o.launches for o in (pops, wops, fops, cops)):
        raise AssertionError("phase 8 launched a kernel other than segment_sum: "
                             f"{[(o.__name__, o.launches) for o in (pops, wops, fops, cops)]}")
    phase8_s = time.perf_counter() - t0
    log(f"  phase 8 took {phase8_s:.1f}s")
    log("phase 9: the operated service on phase 2's schema and model: telemetry on, four "
        "A/B variants in one stacked pass, a WAL-follower replica of a live writer")
    operate = phase_operate(ops, serve_schema, serve_trees, serve_ens)
    if any(o.launches for o in (pops, wops, fops, cops)):
        raise AssertionError("phase 9 launched a kernel other than segment_sum: "
                             f"{[(o.__name__, o.launches) for o in (pops, wops, fops, cops)]}")
    del serve_schema, serve_trees, serve_ens, coeff_schema   # phases 5-7 run without them
    gc.collect()                          # a scorer and its snapshots hold each other
    torch.cuda.empty_cache()
    lm_cfg = configs.get("rwkv6_1_6b")
    log(f"phase 5: {lm_cfg.name} serving at full width: prefill 8 x 1024, decode 64 tokens")
    from repro_torch.models import layers, rwkv6
    lm = phase_lm(wops, (ops, pops, fops, cops), lm_cfg,
                  (rwkv6, "rwkv6_chunk", rwkv6_chunk.rwkv6_chunk_ref), profile=args.profile)
    torch.cuda.empty_cache()
    dense_cfg = configs.get("tinyllama_1_1b")
    log(f"phase 6: {dense_cfg.name} serving at full width: prefill 8 x 2048 with cache room "
        f"for 64 decode tokens, decode 64 tokens")
    dense = phase_lm(fops, (ops, pops, wops, cops), dense_cfg,
                     (layers, "flash_attention_gqa", flash_attention.flash_attention_ref),
                     prompt=2048, max_len=2048 + 64, check_last=True, profile=args.profile,
                     oracle=flash_attention.attention_limit)
    torch.cuda.empty_cache()
    log(f"phase 7: {dense_cfg.name} training at full width: global batch 8 x 2048, n_micro 8, "
        f"count-sketch compression 8, 4 steps after a warm-up step")
    train = phase_train(fops, cops, (ops, pops, wops), profile=args.profile)

    head = next(s for s in shapes if s["case"] == "leaves40_f32")
    phead = next(s for s in pshapes if s["case"] == "pm256_f32")
    whead = next(s for s in wshapes if s["case"] == "prefill_8x1024")
    fhead = next(s for s in fshapes if s["case"] == "prefill_8x2048")
    chead = next(s for s in cshapes if s["case"] == "mlp_leaf")
    kernels = [{
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment_sum/segment_sum.py:45",
        "launches": serve["launches"], "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "library_ms": head["library_ms"],
        "shape": {k: head[k] for k in ("K", "n", "C", "n_keys", "dtype", "ids")},
        "launches_by_path": {"serve": serve["launches"],
                             "coeff_fit": coeff["segment_sum_launches_b"],
                             "hist_fit": coeff["segment_sum_launches"],
                             "hist_fit_histogram_route": coeff["hist_launches"],
                             "maintain": maintain["launches"],
                             "retrain": retrain["launches"],
                             "operate_service": operate["launches"]["service"],
                             "operate_stacked": operate["launches"]["stacked"],
                             "operate_follow": operate["launches"]["follow"]},
        "shapes": shapes,
    }, {
        "name": "polymul", "route": "cuda",
        "source": "src/repro_torch/csrc/polymul.cu",
        "replaces": "src/repro/kernels/polymul/polymul.py:44",
        "launches": coeff["polymul_launches"], "max_abs_err": phead["max_abs_err"],
        "ms": phead["ms"], "plain_ms": phead["plain_ms"], "bound_ms": phead["bound_ms"],
        "bound_by": phead["bound_by"], "library_ms": phead["library_ms"],
        "shape": {k: phead[k] for k in ("B", "k", "dtype")},
        "launches_by_path": {"coeff_fit": coeff["polymul_launches"]},
        "shapes": pshapes,
    }, {
        "name": "rwkv6_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_chunk.cu",
        "replaces": "src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py:60",
        "launches": lm["launches"], "max_abs_err": whead["max_abs_err"],
        "ms": whead["ms"], "plain_ms": whead["plain_ms"], "bound_ms": whead["bound_ms"],
        "bound_by": whead["bound_by"], "library_ms": None,   # no single PyTorch call
        "shape": {k: whead[k] for k in ("B", "S", "H", "hs", "chunk")},
        "launches_by_path": {"lm_prefill": lm["launches_prefill"],
                             "lm_decode": lm["launches_decode"]},
        "strong_decay": wstrong,
        "shapes": wshapes,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:66",
        "launches": dense["launches"], "max_abs_err": fhead["max_abs_err"],
        "ms": fhead["ms"], "plain_ms": fhead["plain_ms"], "bound_ms": fhead["bound_ms"],
        "bound_by": fhead["bound_by"], "library_ms": fhead["library_ms"],
        "shape": {k: fhead[k] for k in ("B", "S", "N", "Kh", "dh", "causal", "dtype")},
        "launches_by_path": {"lm_prefill": dense["launches_prefill"],
                             "lm_decode": dense["launches_decode"],
                             "lm_train_4_steps": train["launches"]["flash_attention"]},
        "sass_bf16": fsass,
        "shapes": fshapes,
    }, {
        "name": "count_sketch", "route": "cuda",
        "source": "src/repro_torch/csrc/count_sketch.cu",
        "replaces": "src/repro/kernels/count_sketch/count_sketch.py:45",
        "launches": train["launches"]["count_sketch"], "max_abs_err": chead["max_abs_err"],
        "ms": chead["ms"], "plain_ms": chead["plain_ms"], "bound_ms": chead["bound_ms"],
        "bound_by": chead["bound_by"], "library_ms": chead["library_ms"],
        "shape": {k: chead[k] for k in ("n", "k")},
        "launches_by_path": {"lm_train_4_steps": train["launches"]["count_sketch"],
                             "lm_train_4_steps_unsketch":
                                 train["launches"]["count_sketch_unsketch"]},
        "shapes": cshapes,
    }]
    log(json.dumps({"serve": serve, "paper": paper, "coeff_hist": coeff, "lm": lm,
                    "lm_dense": dense, "lm_train": train, "maintain": maintain,
                    "retrain": retrain, "phase8_s": phase8_s, "operate": operate}))
    log(json.dumps({"kernels": kernels}))
    # count: the cards this process sees (the run drives device 0)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
