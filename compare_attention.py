"""The flash_attention kernel's bf16 times at ``chip_smoke.py`` phase 1's
shapes, for one checkout of this repository.

    python3 compare_attention.py [--tree DIR]

``--tree`` names the checkout whose ``src/`` is run (default: the one
holding this script), so that two versions are compared on one card by
running the script once for each, in turns (parent, change, change,
parent), within one call.  The kernel is built from that tree's sources.
Each row is the mean of ``REPS`` launches between two CUDA events,
after a warm-up, on numpy-seeded standard-normal q, k, v; the windowed
rows run only where the tree's wrapper takes a ``window``.  Needs a CUDA
device.  Prints the card's name and power limit and, as its last line,
one JSON object with the rows.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# (case, B, S, N, Kh, dh, window): causal bf16 rows of phase 1
ROWS = (("prefill_8x2048", 8, 2048, 32, 4, 64, None),
        ("long_1x8192", 1, 8192, 32, 4, 64, None),
        ("granite_8x2048", 8, 2048, 32, 8, 128, None),
        ("hymba_8x2176_global", 8, 2176, 25, 5, 64, None),
        ("hymba_8x2176_w1024", 8, 2176, 25, 5, 64, 1024),
        ("long_1x16384_w1024", 1, 16384, 25, 5, 64, 1024))
REPS = 300                          # launches a row, between two CUDA events


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_attention: no CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.flash_attention import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    windows = "window" in inspect.signature(ops.flash_attention_gqa).parameters
    rows = []
    for case, B, S, N, Kh, dh, window in ROWS:
        if window is not None and not windows:
            continue
        rng = np.random.default_rng(0)
        q = torch.from_numpy(rng.standard_normal((B, S, N, dh), dtype=np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((B, S, Kh, dh), dtype=np.float32))
                for _ in range(2))
        q, k, v = (x.to("cuda", torch.bfloat16) for x in (q, k, v))
        kw = {} if window is None else {"window": window}
        for _ in range(5):
            ops.flash_attention_gqa(q, k, v, True, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            ops.flash_attention_gqa(q, k, v, True, **kw)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / REPS
        rows.append({"case": case, "window": window, "ms": ms})
        print(f"  {case:<22} {ms:.4f} ms", flush=True)
    print(json.dumps({"tree": str(tree), "card": card, "reps": REPS, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
