"""RWKV-6 1.6B training (``chip_smoke.py`` phase 11(b)) and the WKV backward
kernel at its training shape (phase 1's ``train_1x2048`` row), for one
checkout of this repository.

    python3 compare_rwkv_train.py [--tree DIR]

``--tree`` names the checkout whose ``chip_smoke.py`` and ``src/`` are run
(default: the one holding this script), so that two versions are compared
on one card by running the script once for each, in turns (parent, change,
change, parent), within one call.  The kernels are built from that tree's
sources.  Phase 11(b)'s batches are drawn by sampling weights of 2²⁰
documents made from a seed (phase 11(a)'s fit does not change the step's
cost), it takes phase 11(b)'s 4 steps, and its gates hold as in
``chip_smoke.py``; one extra step is traced with ``torch.profiler`` (wall,
busy and idle time, device time by kernel kind).  The backward kernel's
wrapper is also timed on the host alone: the mean of 50 calls at the
training shape, none awaited.  Needs a CUDA device.  Prints the card's name and power limit
and, as its last line, one JSON object with the records.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

STEPS = 4                                       # phase 11(b)'s


def k1_host_us(wops, B=1, S=2048, H=32, hs=64, chunk=16, calls=50) -> float:
    """Host µs of one backward wrapper call at the training shape: the mean
    of ``calls`` calls, none awaited (the kernel runs behind them)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    r, k, v, do = (torch.randn(B, S, H, hs, device="cuda", generator=gen) for _ in range(4))
    logw = -torch.rand(B, S, H, hs, device="cuda", generator=gen) * 2.0
    u = torch.randn(H, hs, device="cuda", generator=gen)
    for _ in range(3):
        wops.rwkv6_chunk_bwd(r, k, v, logw, u, do, chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        wops.rwkv6_chunk_bwd(r, k, v, logw, u, do, chunk)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_rwkv_train: no CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import (count_sketch, flash_attention, polymul, rwkv6_chunk,
                                     segment_sum)
    from repro_torch.kernels.count_sketch import ops as cops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.polymul import ops as pops
    from repro_torch.kernels.rwkv6_chunk import ops as wops
    from repro_torch.kernels.segment_sum import ops as sops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sources = (segment_sum.build, polymul.build, rwkv6_chunk.build, rwkv6_chunk.build_bwd,
               flash_attention.build, count_sketch.build)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda build: build(), sources))
    k1 = smoke.wkv_bwd_case(wops, rwkv6_chunk, "train_1x2048", 1, 2048, 32, 64, 16)
    k1["host_us_a_call"] = k1_host_us(wops)
    print(f"  backward wrapper on the host: {k1['host_us_a_call']:.1f} µs a call", flush=True)
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(1 << 20)
    weights = np.exp(logits - logits.max())
    weights = (weights / weights.sum()).astype(np.float32)
    train = smoke.phase_rwkv_train(wops, cops, (sops, pops, fops), weights, steps=STEPS,
                                   profile=True)
    prof = train.get("profile_step") or {}
    out = {"tree": str(tree), "card": card, "k1": k1,
           "step_ms_mean": train["step_ms_mean"], "step_s": train["step_s"],
           "launches_per_step": train["launches_per_step"], "profile_step": prof,
           "twin_f32": train["twin_f32"]}
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
