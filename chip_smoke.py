#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Kernel vs plain on the card: the segment-⊕ kernel, built here from
   ``src/repro_torch/csrc/segment_sum.cu``, against its plain PyTorch
   version at the serve path's shapes (uniform, Zipf-skewed and
   empty-segment key sets).  Integer-valued inputs must match exactly;
   float inputs must satisfy |kernel − plain_f64| ≤ 1e-5 · Σ|v| per
   output element (Σ|v| over the element's segment, in float64).  Prints
   kernel, plain, ``index_add_`` and bound times for each shape.
2. Serve path at real size: star schema with 4,194,304 fact rows and
   4,096-row dimension tables; train 5 trees of depth 3 (sketch mode, no
   SSR), compile, ``score_grouped`` by every table, then 2,000 Zipf(1.3)
   requests through the micro-batching service with a hot swap.  Counts
   must equal the materialized-join oracle exactly and totals must be
   within 1e-4 · Σ|ŷ| of it per group; the kernel's launches must cover
   every message emission the query counters report.
3. Paper check: 262,144 fact rows, 3 trees of depth 3, exact vs sketched
   (k = 256) training with per-table SSR, plus the materialized baseline.

Prints the card's name and power limit, the build time, each phase's
findings, a JSON line of kernel measurements, and as its last line
``{"ok": true, "device": {...}}``.  Needs a CUDA device and the
repository's ``src/`` beside it.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published HBM3 rate
F32_OPS_PER_S = 67e12              # H100 SXM published float32 rate outside the tensor cores
FLOAT_RTOL = 1e-5                  # float inputs: |err| ≤ FLOAT_RTOL · Σ|v| per element
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


def kernel_case(ops, ref, name, K, n, C, dtype, dist, n_keys=N_KEYS, seed=0, dev="cuda"):
    """One shape: exactness on integer values, tolerance on float values,
    determinism, and timings.  Returns the shape's record."""
    rng = np.random.default_rng(seed)
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
    # bf16 input accumulates into a bf16 output, index_add_'s only option
    out_dtype = torch.float32 if dtype == torch.float32 else dtype
    lib_out = torch.zeros((K, n_keys, C), dtype=out_dtype, device=dev)
    library_ms = cuda_ms(lambda: lib_out.zero_().index_add_(1, seg.ids, vals))
    in_bytes = vals.element_size()
    nbytes = K * n * C * in_bytes + 4 * n + 4 * (n_keys + 1) + 4 * K * n_keys * C
    # the least time for the same work: bytes (each input read once, the
    # output written once) or the K·n·C float32 adds, whichever is larger
    bound_ms = max(nbytes / HBM_BYTES_PER_S, K * n * C / F32_OPS_PER_S) * 1e3
    rec = {"case": name, "K": K, "n": n, "C": C, "n_keys": n_keys,
           "dtype": str(dtype).replace("torch.", ""), "ids": dist,
           "max_segment": int(torch.diff(seg.offsets).max()),
           "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bytes": nbytes}
    log(f"  {name:<22} K={K} n={n} C={C} {rec['dtype']:<8} ids={dist:<7} "
        f"kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  "
        f"bound_ms {bound_ms:.4f}  max_abs_err {max_abs_err:.3e}")
    del vals, got, lib_out
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
    return [kernel_case(ops, ref, *c, dev=dev) for c in cases]


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


def profile_window(fn) -> dict:
    """Device busy and idle share of one call, from a torch.profiler trace:
    the union of the CUDA kernels' intervals over the host wall time of the
    call (the profiler's own host overhead counts as idle)."""
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
            "top": [(n[:60], round(ms, 3)) for n, ms in top]}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-fact", type=int, default=1 << 22, help="serve-phase fact rows")
    ap.add_argument("--paper-n-fact", type=int, default=1 << 18, help="paper-phase fact rows")
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
    lib, build_log = ops.build(verbose=True)
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f}s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    log("phase 1: segment_sum kernel vs plain version on the card")
    shapes = phase_kernel(ops, ref)
    log(f"phase 2: serve path at {args.n_fact} fact rows")
    serve = phase_serve(ops, args.n_fact, profile=args.profile)
    log(f"phase 3: paper check at {args.paper_n_fact} fact rows")
    paper = phase_paper(args.paper_n_fact)

    head = next(s for s in shapes if s["case"] == "leaves40_f32")
    kernels = [{
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment_sum/segment_sum.py:45",
        "launches": serve["launches"], "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "library_ms": head["library_ms"],
        "shape": {k: head[k] for k in ("K", "n", "C", "n_keys", "dtype", "ids")},
        "shapes": shapes,
    }]
    log(json.dumps({"serve": serve, "paper": paper}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
