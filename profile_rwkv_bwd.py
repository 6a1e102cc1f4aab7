"""The WKV backward kernel (``src/repro_torch/csrc/rwkv6_chunk_bwd.cu``)
taken apart at the RWKV-6 1.6B training shape (B 1, S 2048, H 32, hs 64,
chunk 16), where ``chip_smoke.py`` phase 1 times it whole.

    python3 profile_rwkv_bwd.py

Builds four variants of the source as it stands, each with one edit, and
times each with CUDA events (three rounds of 20 launches):

- ``whole``: no edit;
- ``no_rebuild``: the forward walk that rebuilds the chunk states runs no
  chunk (the reverse walk then reads a scratch never written);
- ``no_reverse``: the reverse walk runs no chunk;
- ``laps``: ``clock64`` laps of thread 0 of the first CTA, summed over the
  chunks: the rebuild walk; loading a chunk (staging, the previous chunk's
  decays' gradient, the prefetch, the pairwise test); stage (1) (factors,
  Q, the partials); stage (2) (A, X, Y, G); stage (3) (the partials'
  exchange, dr, dk, du, dv).  Their shares are of that thread's cycles,
  barrier waits included; the laps add their own few cycles a chunk.

The cut variants compute wrong gradients and are timed only.  Needs a
CUDA device and ``nvcc``.  Prints the card's name and power limit and, as
its last line, one JSON object with the records.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SHAPE = (1, 2048, 32, 64, 16)                   # B, S, H, hs, chunk
STAGES = ("rebuild", "load", "stage1", "stage2", "stage3")
_LAPS = (
    ("  float s[16];\n",
     "  float s[16];\n  long long lap_t = clock64(), laps[5] = {0, 0, 0, 0, 0};\n"
     "  auto lap = [&](int i) { const long long t = clock64(); laps[i] += t - lap_t; lap_t = t; };\n"),
    ("  // ---- reverse walk\n", "  lap(0);\n  // ---- reverse walk\n"),
    ("    // (1) the factors", "    lap(1);\n    // (1) the factors"),
    ("    // (2) A's strict", "    lap(2);\n    // (2) A's strict"),
    ("    // (3) dr, dk, a, b", "    lap(3);\n    // (3) dr, dk, a, b"),
    ("    cb ^= 1;\n", "    cb ^= 1;\n    lap(4);\n"),
    ("  cluster.sync();                                        // no CTA leaves",
     "  __syncthreads();\n  if (blockIdx.x == 0 && tid == 0) {\n"
     "    for (int i = 0; i < 5; ++i) dw[i] = (float)laps[i];\n  }\n"
     "  cluster.sync();                                        // no CTA leaves"),
)
VARIANTS = {
    "whole": (),
    "no_rebuild": (("for (int64_t c = 0; c < n_chunks; ++c) {",
                    "for (int64_t c = 0; c < 0; ++c) {"),),
    "no_reverse": (("for (int64_t c = n_chunks - 1; c >= 0; --c) {",
                    "for (int64_t c = n_chunks - 1; c >= n_chunks; --c) {"),),
    "laps": _LAPS,
}


def variant(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel's source no longer holds {old.strip()!r} once")
        src = src.replace(old, new)
    return src


def build(_build, name: str, src: str, out: Path) -> ctypes.CDLL:
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.rwkv6_chunk_bwd_f32.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 3
                                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.rwkv6_chunk_bwd_f32.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_rwkv_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    B, S, H, hs, c = SHAPE
    src = (ROOT / "src/repro_torch/csrc/rwkv6_chunk_bwd.cu").read_text()
    sources = {name: variant(src, edits) for name, edits in VARIANTS.items()}
    rng = np.random.default_rng(0)
    r, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, H, hs), dtype=np.float32)).cuda()
                   for _ in range(4))
    w = torch.from_numpy(-rng.uniform(0.01, 2.0, (B, S, H, hs)).astype(np.float32)).cuda()
    u = torch.from_numpy(rng.standard_normal((H, hs), dtype=np.float32)).cuda()
    grads = [torch.empty_like(r) for _ in range(4)]
    du = torch.empty(B, H, hs, device="cuda")
    states = torch.empty(B, H, S // c, hs, hs, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": card, "shape": dict(zip("B S H hs chunk".split(), SHAPE)), "variants": {}}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: build(_build, *kv, Path(tmp)),
                                          sources.items())))
        for name, lib in libs.items():
            def launch():
                rc = lib.rwkv6_chunk_bwd_f32(*(x.data_ptr() for x in (r, k, v, w, u, do)),
                                             *(g.data_ptr() for g in grads), du.data_ptr(),
                                             states.data_ptr(), B, S, H, hs, c, stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed with cudaError_t {rc}")
            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            ms = []
            for _ in range(3):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(20):
                    launch()
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1) / 20)
            rec = {"ms": ms}
            if name == "laps":
                launch()
                cycles = grads[3].flatten()[:len(STAGES)].double().cpu().tolist()
                total = sum(cycles)
                rec["cycles"] = dict(zip(STAGES, cycles))
                rec["share"] = {s: x / total for s, x in zip(STAGES, cycles)}
                rec["cycles_a_chunk"] = {s: x / (S // c) for s, x in zip(STAGES, cycles)}
            out["variants"][name] = rec
            print(f"  {name:<11} ms {' '.join(f'{x:.4f}' for x in ms)}"
                  + (f"  share {', '.join(f'{s} {x:.3f}' for s, x in rec['share'].items())}"
                     if "share" in rec else ""), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
