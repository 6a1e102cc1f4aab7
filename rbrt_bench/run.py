"""Run one cell of the port's benchmark once.

    python3 rbrt_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and
a traffic mix; the mix names its loop.  The run generates the
configuration's tables from the seed, hands them to the port
(``src/repro_torch``), warms up the cell's own shapes (set-up), then
drives the mix for ``--seconds`` and prints the cell's end-to-end
metrics; with ``--trace 1`` it drives the mix's traced share of requests
under the profiler instead and prints the per-layer metrics.  After the
window it judges what the port produced against the plain reference
(``reference/``) and prints each number compared beside its limit
(``limits/<cell>.json``): last on standard error, and last in the
result, the JSON object that is the last line of standard output.

It exits with a code other than 0, printing no result, where there is
no CUDA device (or fewer than the cell asks for), or where the JAX stack
or the JAX package (``repro``) was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rbrt_bench.lib import env, registry  # noqa: E402


class NoDevice(SystemExit):
    pass


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def limits(workload: str, base: Path = registry.BENCH_DIR) -> dict:
    return json.loads((base / "limits" / f"{workload}.json").read_text())


def _traced_window(loop, st, requests: int, calls: list):
    """The loop's window under the profiler, with the port's spans on as
    profiler ranges; its ``fence`` (a synchronize while tracing) is kept
    off, so the traced path runs as the timed one does."""
    from rbrt_bench.lib import calls as kcalls, profile
    from repro_torch.core import trainer
    from repro_torch.obs import trace as ptrace

    out = {}
    fence = trainer.fence
    ptrace.enable_tracing(clear=True, torch_annotations=True)
    trainer.fence = lambda value: value
    try:
        with kcalls.recording(calls):
            tr = profile.traced(lambda: out.update(loop.window(st, 0, requests=requests)))
    finally:
        trainer.fence = fence
        ptrace.disable_tracing()
        ptrace.get_tracer().clear()
    tr.calls = calls
    return tr, out


def run(args, device: str = "cuda", need_chip: bool = True, t0: float = T0) -> dict:
    """One run; returns the result object (``correct`` and the rest)."""
    env.prepare()
    import torch

    bench = registry.benchmark()
    cell = registry.resolve(bench, args.workload)
    if need_chip and (not torch.cuda.is_available()
                      or torch.cuda.device_count() < cell["cell"]["chips"]):
        raise NoDevice(f"rbrt_bench: the cell needs {cell['cell']['chips']} CUDA device(s); "
                       f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                       f"{torch.cuda.device_count()} device(s)")
    ctx = SimpleNamespace(seed=args.seed, config=cell["config"], mix=cell["traffic"],
                          generator=cell["generator"], device=device)
    loop = cell["loop"]
    st = loop.setup(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    device_out = {}
    breakdown = None
    if args.trace:
        tr, res = _traced_window(loop, st, int(ctx.mix["trace_requests"]), [])
        tr.counters = dict(res["counters"], schema_build_s=st.schema_s)
        metrics = {}
        for m in cell["per_layer"]:
            v = registry.read_metric(m["name"], tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_out = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    else:
        res = loop.window(st, args.seconds)
        values = dict(res["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = (env.device_info(cell["cell"]["chips"]) if device == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    dev.update(device_out)

    got = loop.collect(st)
    del st
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.check(ctx, got)
    lim = limits(args.workload)
    checks = {k: {"value": float(v), "limit": float(lim[k])} for k, v in numbers.items()}
    correct = res["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    try:
        out = run(args)
    except NoDevice as e:
        print(str(e), file=sys.stderr)
        return 2
    bad = env.forbidden_modules()
    if bad:
        print(f"rbrt_bench: the run loaded {bad} (the JAX stack or the JAX package)",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
