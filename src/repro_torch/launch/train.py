"""LM training entry point: data pipeline → microbatched train step (float32
accumulation, optional count-sketch gradient compression, clip, AdamW)
→ watchdog → async checkpoints → bounded retries of the gradient stage.

The port of the reference's ``launch/train.py``: ``main`` builds the host
mesh (``launch.mesh.make_host_mesh``: every rank of the world as (data,
model), (1, 1) on one card; a ``torchrun`` world of several ranks joins
from the environment) and places the parameters, AdamW's state and every
batch on it by the reference's rules (``distributed/sharding.py``), as
the reference's ``main`` does; the step then runs placed
(``launch/steps.py``).  ``build(args)`` without a mesh gives the plain
one-process trainer.  Weights are random from a seed; the data is the
reference's synthetic token stream (``data/``), batch for batch the same ids; a
caller may put a ``TokenPipeline`` with ``example_weights`` in
``Trainer.pipe`` (the step reads a batch's tokens and ignores its
``doc_ids``).  A front end's batch adds the reference's stubs
(:func:`make_batch_for`): LLaVA-NeXT's ``patches``, (B, S/2, D) float32
N(0, 0.02²) from the batch's own rng, the tokens cut to S − S/2; an
encoder–decoder's ``src_frames`` of the same form, the tokens cut to S/2.
On the card every training attention of a dense, hybrid (Hymba), MoE or
encoder–decoder model runs the flash_attention kernel with the layer's
window (its forward, twice a block with remat; its backward is the plain
blockwise VJP over the window's band; non-causal in an encoder and in a
cross-attention), every WKV of an RWKV-6 model the
rwkv6_chunk kernel (twice a block with remat) and its gradient the
backward kernel, and every compressed gradient leaf
the count_sketch kernel.  Without ``--full`` the arch's reduced (smoke)
config is trained.  A checkpoint is labelled by the number of updates it
holds, and holds the compressor's round and error feedback beside the
parameters and AdamW's state; ``--resume`` restores the newest one and
goes on from its label, the pipeline sought there, so a resumed run ends
bit for bit where an uninterrupted one does.  (The reference labels an
intermediate save one update short and keeps no compressor state:
ROADMAP §3.)  ``--resume`` restores onto the run's mesh through
``runtime/elastic.restore_elastic``, whatever mesh wrote the checkpoint.
A failed gradient stage is run again
(it changes no state); a failure in the compressor or the optimizer,
which update the state in place, ends the run, and ``--resume`` goes on
from the newest checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3 --compress-grads 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_1_6b --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba_1_5b --device cpu --steps 3 \\
        --seq 72 --compress-grads 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx_132b --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch seamless_m4t_medium --device cpu \\
        --steps 3 --compress-grads 8
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 5 --batch 8 --seq 2048 \\
        --n-micro 8 --compress-grads 8 --ckpt-every 0
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.schema import resolve_device
from repro_torch.data import TokenPipeline
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import join_world, make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model, stack_layers
from repro_torch.optim import CountSketchCompressor, adamw
from repro_torch.runtime.elastic import restore_elastic
from repro_torch.runtime.fault import StepWatchdog, run_with_retries
from repro_torch.tree import map_tree


@dataclasses.dataclass
class Trainer:
    """Everything one run holds: the model, its stacked parameters and
    optimizer state, the step function, the compressor, the pipeline and
    the mesh they are placed on (None: plain tensors, one process)."""
    model: Model
    ocfg: adamw.AdamWConfig
    params: Dict[str, Any]
    opt_state: adamw.OptState
    step_fn: Any
    compressor: Any
    pipe: TokenPipeline
    mesh: Any = None
    history: list = dataclasses.field(default_factory=list)   # per step: seconds, metrics

    def state(self) -> tuple:
        """The checkpoint's tree: (params, OptState), and the compressor's
        :meth:`~CountSketchCompressor.state_tree` when it compresses."""
        held = (self.params, self.opt_state)
        return held if self.compressor is None else (
            *held, self.compressor.state_tree(self.params))

    def load_state(self, tree: tuple) -> None:
        self.params, self.opt_state = tree[0], tree[1]
        if self.compressor is not None:
            self.compressor.load_state_tree(tree[2])

    def next_batch(self) -> Dict[str, torch.Tensor]:
        """The pipeline's next batch on the model's device, placed on the
        mesh (rows over dp) where there is one."""
        b = {k: torch.from_numpy(v).to(self.model.device) for k, v in next(self.pipe).items()}
        return b if self.mesh is None else sharding.place(b, sharding.batch_shardings(self.mesh, b))

    def step(self, batch, on_failure=None) -> Dict[str, torch.Tensor]:
        """One train step on ``batch``.  The gradient stage is retried on
        failure; the compressor and AdamW, which update the state in place,
        are not: a failure there raises."""
        dev = self.model.device

        def grads(params, b):
            out = self.step_fn.grads(params, b)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out
        g, loss = run_with_retries(grads, self.params, batch, on_failure=on_failure)
        self.params, self.opt_state, metrics = self.step_fn.update(
            self.params, self.opt_state, g, loss)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return metrics


def state_shardings(mesh, state: tuple) -> tuple:
    """Where :meth:`Trainer.state`'s leaves go on ``mesh``: the parameters
    by the rules, AdamW's state as the reference's dry run places it, the
    compressor's round and error feedback unplaced (whole on every rank:
    the compressor sees each leaf whole)."""
    pshard = sharding.param_shardings(mesh, state[0])
    out = (pshard, sharding.opt_shardings(mesh, pshard, state[1]))
    return out if len(state) == 2 else (*out, map_tree(lambda _: sharding.UNPLACED, state[2]))


def make_batch_for(cfg, gen: SyntheticLM, rng, B: int, S: int) -> Dict[str, Any]:
    """One batch of the reference's ``launch/train.py``: B × S token ids
    of ``gen``, and for a front end its stub, (B, S/2, D) float32 from
    ``rng`` (``patches`` before S − S/2 tokens, or an encoder's
    ``src_frames`` beside S/2 tokens)."""
    b = {"tokens": gen.batch(rng, B, S)}
    if cfg.frontend == "patches":
        b["patches"] = rng.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32) * 0.02
        b["tokens"] = b["tokens"][:, : S - S // 2]
    if cfg.kind == "encdec":
        b["src_frames"] = rng.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32) * 0.02
        b["tokens"] = b["tokens"][:, : S // 2]
    return b


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--full", action="store_true", help="the full published config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers, an encoder-decoder's encoder "
                         "too (its width kept)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", type=int, default=0,
                    help="count-sketch ratio (0 = off)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def build(args, mesh=None) -> Trainer:
    """The run that ``args`` describes, before its first step (the
    pipeline's thread is running: ``trainer.pipe.stop()`` ends it), its
    parameters and AdamW's state placed on ``mesh`` where one is given."""
    cfg = (configs.get if args.full else configs.get_smoke)(args.arch)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers,
                          **({"enc_layers": args.layers} if cfg.kind == "encdec" else {}))
    model = Model(cfg, device=args.device)
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    compressor = (CountSketchCompressor(ratio=args.compress_grads)
                  if args.compress_grads else None)
    params = stack_layers(model.init(torch.Generator(device=model.device).manual_seed(0)))
    stub = cfg.frontend is not None or cfg.kind == "encdec"
    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=1, make_batch=functools.partial(
        make_batch_for, cfg, SyntheticLM(cfg.vocab, seed=1)) if stub else None)
    if mesh is None:
        opt_state = adamw.init(ocfg, params)
    else:           # AdamW's state made for the rank's own slices: no rank holds a whole moment
        params = sharding.place(params, sharding.param_shardings(mesh, params))
        held = adamw.init(ocfg, sharding.local(params))
        like = lambda t, p: DTensor.from_local(t, mesh, p.placements, run_check=False,
                                               shape=p.shape, stride=p.stride())
        opt_state = held._replace(m=map_tree(like, held.m, params),
                                  v=map_tree(like, held.v, params),
                                  master=map_tree(like, held.master, params) if held.master
                                  else ())
    return Trainer(model, ocfg, params, opt_state,
                   make_train_step(model, ocfg, args.n_micro, compressor=compressor),
                   compressor, pipe, mesh)


def main(argv=None):
    """Train as ``argv`` says; returns the final parameters, whole (plain
    tensors).  Leaves the process group it joined, if it joined one."""
    args = parser().parse_args(argv)
    resolve_device(args.device)                 # a CUDA device on a host without one raises
    joined = join_world(args.device)
    try:
        return sharding.gathered(run(args, make_host_mesh(args.device)).params)
    finally:
        if joined:
            dist.destroy_process_group()


def run(args, mesh=None) -> Trainer:
    """``main``'s run on ``mesh`` (None: plain tensors): resume if asked,
    the steps (each one's host seconds and metrics in ``Trainer.history``),
    the checkpoints, the last one blocking; returns the trainer."""
    tr = build(args, mesh)
    ckpt = Checkpointer(args.ckpt_dir)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()              # the updates it holds: the next step's index
        tr.load_state(ckpt.restore(start, tr.state()) if mesh is None else
                      restore_elastic(ckpt, start, tr.state(), mesh, state_shardings))
        tr.pipe.seek(start)
        print(f"resumed from step {start}")
    wd = StepWatchdog(on_straggler=lambda s, dt, ema: print(
        f"[watchdog] straggler step {s}: {dt:.2f}s vs ema {ema:.2f}s"))

    t_start = time.time()
    try:
        for step in range(start, args.steps):
            batch = tr.next_batch()
            t0 = time.perf_counter()
            with wd.time_step(step):
                metrics = tr.step(batch, on_failure=lambda a, e: print(f"[retry {a}] {e}"))
            m = {k: float(v) for k, v in metrics.items()}
            tr.history.append({"step": step, "s": time.perf_counter() - t0, **m})
            if step % args.log_every == 0 or step == args.steps - 1:
                print(json.dumps({"step": step, **{k: round(v, 4) for k, v in m.items()}}))
            done = step + 1                     # updates the state now holds
            if args.ckpt_every and done % args.ckpt_every == 0 and done < args.steps:
                ckpt.save(done, tr.state())
        ckpt.save(args.steps, tr.state(), blocking=True)
        print(f"done in {time.time() - t_start:.1f}s; straggler steps: {wd.straggler_steps}")
    finally:
        tr.pipe.stop()
    return tr


if __name__ == "__main__":
    main()
