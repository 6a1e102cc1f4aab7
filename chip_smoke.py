#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Kernels vs plain on the card, both built here from
   ``src/repro_torch/csrc/`` (one ``nvcc`` per source, in parallel):
   - the segment-⊕ kernel (``segment_sum.cu``) against its plain PyTorch
     version at the serve path's shapes (uniform, Zipf-skewed and
     empty-segment key sets) and at the histogram sweep's (a key column
     over 2 tiled copies of 2^20 stats rows).  Integer-valued inputs
     must match exactly; float inputs must satisfy |kernel − plain_f64|
     ≤ 1e-5 · Σ|v| per output element (Σ|v| over the element's segment,
     in float64).  Prints kernel, plain, ``index_add_`` and bound times;
   - the polymul kernel (``polymul.cu``) against its plain version in
     float64 at the coefficient fit's shapes ((4·2^20, 256) f32 and bf16,
     (2^18, 1024) f32, (1,048,579, 64) f32, a row count off the tile).
     Integer-valued inputs must match exactly; float32 within
     2e-5 · (|a| ⊛ |b|) per coefficient, bfloat16 within that plus
     2^-8 · |exact| (the output's rounding).  Prints kernel, plain,
     ``torch.fft`` (the library route, never called by the port on the
     card) and bound times.
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

Prints the card's name and power limit, the build time, each phase's
findings, a JSON line of kernel measurements, and as its last line
``{"ok": true, "device": {...}}``.  Needs a CUDA device and the
repository's ``src/`` beside it.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import math
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
N_KEYS = 4096                      # dimension-table key domain of the serve path


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, min_total_s: float = 0.2, max_reps: int = 20) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = int(min(max_reps, max(3, min_total_s / max(time.perf_counter() - t0, 1e-6))))
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
        ("polyfreq256_k4", 4, n18, 258, torch.float32, "uniform"),
        ("c3_zipf", 1, n22, 3, torch.float32, "zipf"),
        ("leaves40_zipf", 1, n22, 40, torch.float32, "zipf"),
        ("c3_empty_segments", 1, n22, 3, torch.float32, "even"),
        ("leaves40_empty_segments", 1, n22, 40, torch.float32, "even"),
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


def poly_case(ops, ref, name, B, k, dtype, seed=0, dev="cuda", chunk=1 << 18):
    """One polymul shape: exactness on integer values, tolerance on float
    values against the float64 plain version (computed ``chunk`` rows at
    a time), determinism, and timings.  Returns the shape's record."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    chunks = [slice(r, min(r + chunk, B)) for r in range(0, B, chunk)]
    # integers in {−lo..lo}: every partial sum (|·| ≤ lo²·k) is exact in the dtype
    lo = 2 if dtype == torch.float32 else 1
    if dtype == torch.float32 or k <= 256:
        ia, ib = (torch.randint(-lo, lo + 1, (B, k), generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        got = ops.poly_mul(ia, ib)
        for c in chunks:
            want = ref.poly_mul_ref(ia[c], ib[c], torch.float64)
            if float((want - want.round()).abs().max()) > 1e-6:
                raise AssertionError(f"{name}: float64 plain version is off the integers")
            if not torch.equal(got[c].double(), want.round()):
                raise AssertionError(f"{name}: integer-valued products differ "
                                     f"(max |err| {float((got[c].double() - want).abs().max())})")
        del ia, ib, got, want
    a, b = (torch.randn((B, k), generator=gen, device=dev).to(dtype) for _ in range(2))
    got = ops.poly_mul(a, b)
    if not torch.equal(got, ops.poly_mul(a, b)):
        raise AssertionError(f"{name}: two runs of the kernel differ")
    max_abs_err = 0.0
    for c in chunks:
        want = ref.poly_mul_ref(a[c], b[c], torch.float64)
        tol = POLY_RTOL * ref.poly_mul_ref(a[c].abs(), b[c].abs(), torch.float64) + 1e-6
        if dtype == torch.bfloat16:
            tol += BF16_ULP * want.abs()
        err = (got[c].double() - want).abs()
        if bool((err > tol).any()):
            raise AssertionError(f"{name}: products outside tolerance (max |err| "
                                 f"{float(err.max())})")
        max_abs_err = max(max_abs_err, float(err.max()))
    del got, want, tol, err

    kernel_ms = cuda_ms(lambda: ops.poly_mul(a, b))
    plain_ms = cuda_ms(lambda: [ref.poly_mul_ref(a[c], b[c], torch.float64) for c in chunks],
                       max_reps=3)
    # yardstick only: the torch.fft route (rfft, rfft, product, irfft) in
    # float32, which the port never calls on the card
    library_ms = cuda_ms(lambda: ref.poly_mul_ref(a, b))
    size = a.element_size()
    nbytes = 3 * B * k * size                  # a and b read once, out written once
    flops = B * fft_flops(k)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_OPS_PER_S else "operations"
    direct = 2.0 * B * k * k
    rec = {"case": name, "B": B, "k": k, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "fft_flops": flops, "direct_flops": direct,
           "direct_tflops_per_s": direct / kernel_ms / 1e9}
    log(f"  {name:<22} B={B} k={k} {rec['dtype']:<8} kernel_ms {kernel_ms:.4f}  "
        f"plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms {bound_ms:.4f} "
        f"({bound_by})  direct-form {direct:.3e} flops = {rec['direct_tflops_per_s']:.2f} "
        f"TFLOP/s  max_abs_err {max_abs_err:.3e}")
    del a, b
    torch.cuda.empty_cache()
    return rec


def phase_polymul(ops, ref, dev="cuda"):
    cases = [
        ("pm256_f32", 4 << 20, 256, torch.float32),     # fit B's largest ⊗: K=4, n=2^20
        ("pm256_bf16", 4 << 20, 256, torch.bfloat16),
        ("pm1024_f32", 1 << 18, 1024, torch.float32),
        ("pm64_offtile_f32", (1 << 20) + 3, 64, torch.float32),
    ]
    return [poly_case(ops, ref, *c, dev=dev) for c in cases]


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
    return out


def profile_window(fn, split: str = "") -> dict:
    """Device busy and idle share of one call, from a torch.profiler trace:
    the union of the CUDA kernels' intervals over the host wall time of the
    call (the profiler's own host overhead counts as idle).  ``split``
    names a kernel: its summed time comes back as ``split_ms``."""
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
    busy, end, by_name = 0.0, -1.0, {}
    for s, e, name in kern:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "idle_share": max(0.0, 1.0 - busy / 1e3 / wall_ms), "kernels": len(kern),
            "top": [(n[:60], round(ms, 3)) for n, ms in top],
            "split_ms": sum(ms for n, ms in by_name.items() if split and split in n)}


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
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-fact", type=int, default=1 << 22, help="serve-phase fact rows")
    ap.add_argument("--paper-n-fact", type=int, default=1 << 18, help="paper-phase fact rows")
    ap.add_argument("--coeff-n-fact", type=int, default=1 << 20,
                    help="phase-4 fact rows (coefficient-domain and histogram fits)")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 2, trace one more training round and one scoring "
                         "pass per table with torch.profiler and print the device's "
                         "busy and idle share")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import polymul, segment_sum
    from repro_torch.kernels.polymul import ops as pops
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
    with ThreadPoolExecutor(2) as pool:          # one nvcc per source, started together
        builds = list(pool.map(lambda m: m.build(verbose=True), (segment_sum, polymul)))
    log(f"build: {', '.join(lib.name for lib, _ in builds)} in "
        f"{time.perf_counter() - t0:.2f}s")
    for _, build_log in builds:
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    log("phase 1: segment_sum and polymul kernels vs plain versions on the card")
    shapes = phase_kernel(ops, ref)
    pshapes = phase_polymul(pops, polymul)
    log(f"phase 2: serve path at {args.n_fact} fact rows")
    serve = phase_serve(ops, args.n_fact, profile=args.profile)
    log(f"phase 3: paper check at {args.paper_n_fact} fact rows")
    paper = phase_paper(args.paper_n_fact)
    log(f"phase 4: paper's coefficient-domain sketch and histogram splits at "
        f"{args.coeff_n_fact} fact rows")
    coeff = phase_coeff_hist(pops, ops, args.coeff_n_fact)

    head = next(s for s in shapes if s["case"] == "leaves40_f32")
    phead = next(s for s in pshapes if s["case"] == "pm256_f32")
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
                             "hist_fit_histogram_route": coeff["hist_launches"]},
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
    }]
    log(json.dumps({"serve": serve, "paper": paper, "coeff_hist": coeff}))
    log(json.dumps({"kernels": kernels}))
    # the run drives one card, device 0
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
