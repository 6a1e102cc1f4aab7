"""Batched LM serving: prefill a prompt batch, then decode N tokens greedily.

The port of the reference's ``launch/serve.py`` for the ported configs
(``rwkv6_1_6b``, whose prefill runs the rwkv6_chunk kernel; the dense
configs such as ``tinyllama_1_1b``, whose prefill attention runs the
flash_attention kernel; ``hymba_1_5b``, whose windowed and global
attentions run that kernel beside the SSM branch; and the MoE configs
``dbrx_132b`` and ``llama4_scout_17b_a16e``, whose FFN is the routed
experts at capacity factor 4.0; the encoder–decoder
``seamless_m4t_medium``, whose encoder self-attention and decoder
cross-attention run the kernel non-causal; and ``llava_next_34b``, a
dense model after a patch front end).  Weights are random,
drawn from ``--seed``; prompts are token ids from numpy's
``default_rng(seed)``, and a front end's stub is the reference's: half of
``--prompt-len`` is ``patches`` before the other half's tokens, or
``src_frames`` for the encoder beside half as many tokens, (B, L/2, D)
N(0, 0.02²) from the same rng.  The prefill gives the KV cache room for
the prompt's tokens and every decode token (``max_len`` = tokens +
decode tokens; a model with meta tokens or patches adds their positions
itself).  PyTorch
compiles nothing ahead of a call, so the times printed are of the steady
state: each of prefill and decode runs once untimed first (building the
CUDA kernel on its first call).  Without ``--full`` the arch's reduced
(smoke) config is served.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b --full \\
        --batch 8 --prompt-len 2048 --decode-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_1_6b --full \\
        --batch 8 --prompt-len 1024 --decode-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b --full \\
        --batch 8 --prompt-len 2048 --decode-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4_scout_17b_a16e --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless_m4t_medium --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava_next_34b --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import Model


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6_1_6b")
    ap.add_argument("--full", action="store_true", help="the full published config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (configs.get if args.full else configs.get_smoke)(args.arch)
    model = Model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))
    batch = {"tokens": tokens.to(model.device)}
    half = args.prompt_len // 2
    stub = lambda: torch.from_numpy(
        (rng.standard_normal((args.batch, half, cfg.d_model)) * 0.02).astype(np.float32)
    ).to(model.device)
    if cfg.frontend == "patches":
        batch["patches"] = stub()
        batch["tokens"] = batch["tokens"][:, :args.prompt_len - half]
    if cfg.kind == "encdec":
        batch["src_frames"] = stub()
        batch["tokens"] = batch["tokens"][:, :half]
    max_len = batch["tokens"].shape[1] + args.decode_tokens

    def decode(logits, cache, n):
        toks = torch.argmax(logits, -1)
        out = [toks]
        for _ in range(n):
            logits, cache = model.decode_step(params, cache, toks)
            toks = torch.argmax(logits, -1)
            out.append(toks)
        return out

    with torch.inference_mode():
        logits, cache = model.prefill(params, batch, max_len)   # warm-up
        decode(logits, cache, 1)
        _sync(model.device)

        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_len)
        _sync(model.device)
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = decode(logits, cache, args.decode_tokens)
        _sync(model.device)
        t_decode = time.perf_counter() - t0

    seqs = torch.stack(out, 1).cpu().numpy()
    tput = args.batch * args.decode_tokens / t_decode
    print(f"{cfg.name} on {model.device}: prefill {t_prefill * 1e3:.1f} ms for "
          f"{args.batch}x{args.prompt_len}")
    print(f"decode: {t_decode * 1e3:.1f} ms for {args.decode_tokens} steps "
          f"({tput:.1f} tok/s; steady state after one warm-up call of each)")
    print("sampled continuations (greedy):")
    for row in seqs[: min(4, args.batch)]:
        print("  ", row[:16].tolist())
    return seqs


if __name__ == "__main__":
    main()
