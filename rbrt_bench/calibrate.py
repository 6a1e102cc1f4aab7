"""The readings that a cell's limits are set from, on the chip.

    python3 rbrt_bench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 3,4,5] [--requests 1] [--out <file>]

For each seed, in one process: the cell's set-up, ``--requests`` requests
of its timed path (the same entries and sizes as a run's window), the
collection and the check of what they produced: one line of numbers, the
lower readings.  For each control seed: the cell's control (``control``
of its loop: the reference put in the program's place in the next
lower precision, or the program's own lower-precision path), judged the
same way: the upper readings.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rbrt_bench.lib import env, registry  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--requests", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    env.prepare()
    import torch

    cell = registry.resolve(registry.benchmark(), a.workload)
    loop = cell["loop"]
    lines = []

    def emit(rec):
        rec = dict(rec, workload=a.workload)
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    seeds = [int(s) for s in a.seeds.split(",") if s]
    for seed in seeds:
        ctx = SimpleNamespace(seed=seed, config=cell["config"], mix=cell["traffic"],
                              generator=cell["generator"], device=a.device, warmup=False)
        t0 = time.perf_counter()
        st = loop.setup(ctx)
        res = loop.window(st, 0, requests=a.requests)
        got = loop.collect(st)
        del st
        gc.collect()
        if a.device == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        numbers = loop.check(ctx, got)
        emit({"kind": "program", "seed": seed, "numbers": numbers, "run_s": t1 - t0,
              "check_s": time.perf_counter() - t1, "e2e": res["e2e"]})
    for seed in [int(s) for s in a.control_seeds.split(",") if s]:
        ctx = SimpleNamespace(seed=seed, config=cell["config"], mix=cell["traffic"],
                              generator=cell["generator"], device=a.device)
        t0 = time.perf_counter()
        try:
            numbers = loop.control(ctx)
        except Exception as e:             # a control that crashes has failed
            numbers = {"error": repr(e)}
        emit({"kind": "control", "seed": seed, "numbers": numbers,
              "s": time.perf_counter() - t0})
        gc.collect()
        if a.device == "cuda":
            torch.cuda.empty_cache()
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
