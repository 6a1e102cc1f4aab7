"""Multi-pod dry run: every (architecture × input shape × mesh) cell run
on ``meta`` tensors over a fake process group of 256 or 512 ranks (the
reference's ``launch/dryrun.py``).  It shows that the distribution config
holds together, a placement or a step that does not fit failing here
without the hardware, and records what one rank would hold and exchange.

Each cell runs in a process of its own (``--cell``, started by
:func:`main`): a fake process group of the mesh's world size
(``torch.testing``'s ``FakeStore``: collectives return at once, and on
``meta`` tensors their meta kernels give the shapes) and
``init_device_mesh`` over it, this process rank 0.  The parameters are
built on ``meta`` (:class:`OnMeta`), placed by ``distributed/sharding.py``'s
rules, AdamW's state as the reference's ``opt_shardings``, the batch's
rows over dp, a decode cell's cache (``Model.init_cache`` on ``meta``) by
the cache rules.  Then the step runs on those meta tensors:
``steps.make_train_step`` for ``train_4k`` (microbatches as the
reference's ``n_micro``), ``steps.placed_prefill`` for ``prefill_32k`` and
``steps.placed_decode`` for ``decode_32k`` and ``long_500k``.

A cell's record, ``<out>/<arch>__<shape>__<mesh>.json``:
- ``per_device_bytes``: ``arguments`` and ``outputs``, exact, the bytes of
  this rank's local shards of the step's inputs and outputs; ``peak_live``,
  the most bytes live at once: the arguments plus every storage an
  operation made while it is alive (a ``TorchDispatchMode`` that follows
  each ``meta`` storage to its release).  XLA's memory analysis, which the
  reference records, differs: it reports a compiled program, whose fused
  operations make no intermediate buffers and whose buffers are reused and
  aliased by its scheduler; here every eager operation's output counts
  while it lives, and the caching allocator's rounding, its reserve and
  fragmentation are not counted.
- ``cost_analysis``: ``flops_per_device``, ``torch.utils.flop_counter``'s
  count of the ATen operations (the products of the rank's local
  tensors: the plain attention backward's among them) plus each kernel's
  operations by PERF.md §6's formulas (a kernel on ``meta`` runs no ATen
  operation: ``kernels/_build.meta_operations``), both also apart.
- ``collectives``: the reference's five names, each with the count and
  the result bytes of the ``c10d_functional`` operations of that kind the
  rank issues (a dispatch mode sees each; DTensor's redistributions issue
  them).
- ``lower_s``: the cell's seconds, placement and step (Python's time over
  every layer and microbatch of DTensor dispatch).
A cell that raises leaves its traceback in ``<...>.json.err``, the run
goes on, and the run exits 1; a cell whose record exists is skipped.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_1_1b --shape train_4k \\
        --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

:func:`run_cell` also takes an arch's smoke config and any data × model
or pod × data × model mesh (``"2x2"``), in a process whose fake group has
that mesh's size (:func:`fake_world`): the CPU tests' cells.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = (("all_gather", "all-gather"), ("allgather", "all-gather"),
         ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
         ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
         ("alltoall", "all-to-all"), ("permute", "collective-permute"))
PRODUCTION = {"16x16": False, "2x16x16": True}     # tag → multi_pod
SRC = Path(__file__).resolve().parents[2]


class OnMeta(TorchFunctionMode):
    """Every factory call made under it puts its tensor on ``meta`` (its
    generator dropped): a model's ``init`` gives the shapes and dtypes of
    its parameters and allocates nothing (the reference's
    ``jax.eval_shape``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


class Census(TorchDispatchMode):
    """Counts the collectives an operation issues (by the reference's
    names: count and result bytes) and the bytes of the storages the
    operations make, from their creation to their release, above
    ``base`` (the arguments' bytes): ``peak`` is the most live at once."""

    def __init__(self, base: int):
        super().__init__()
        self.census = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
        self.live: Dict[int, int] = {}
        self.now = self.peak = base

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.namespace in ("_c10d_functional", "c10d_functional", "c10d"):
            name = func._schema.name.split("::")[-1]
            kind = next((k for key, k in _KIND if key in name), None)
            if kind is not None:
                self.census[kind]["count"] += 1
                self.census[kind]["bytes"] += sum(t.numel() * t.element_size() for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.live:
                self.live[key] = st.nbytes()
                self.now += st.nbytes()
                weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.now)
        return out


def nbytes(tree) -> int:
    """Bytes of the rank's local tensors in ``tree`` (DTensors: their local
    shards)."""
    from torch.distributed.tensor import DTensor

    from ..tree import leaves

    total = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def mesh_spec(tag: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``"16x16"`` → ((16, 16), ("data", "model")); three sizes add "pod"."""
    shape = tuple(int(x) for x in tag.split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if names is None:
        raise ValueError(f"a mesh is data x model or pod x data x model, got {tag!r}")
    return shape, names


def fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world`` ranks
    (nothing if it is in one of that size already; another size raises)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"this process is in a world of {dist.get_world_size()} "
                               f"ranks, the cell needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape_name: str, mesh_tag: str, smoke: bool = False) -> Dict[str, Any]:
    """One cell in this process (:func:`fake_world` of the mesh's size: the
    cells a process runs share one world size); returns its record."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from .. import configs
    from ..distributed import sharding as S
    from ..kernels import _build
    from ..models import Model, stack_layers
    from ..optim import adamw
    from . import steps
    from .mesh import make_production_mesh

    t0 = time.time()
    shape, names = mesh_spec(mesh_tag)
    fake_world(math.prod(shape))
    mesh = (make_production_mesh(PRODUCTION[mesh_tag], device="cpu") if mesh_tag in PRODUCTION
            else init_device_mesh("cpu", shape, mesh_dim_names=names))
    cfg = (configs.get_smoke if smoke else configs.get)(arch)
    model = Model(cfg, device="meta")
    mode, specs = steps.input_specs(arch, shape_name, cfg)
    with OnMeta():
        params = stack_layers(model.init(torch.Generator()))
    pshard = S.param_shardings(mesh, params)
    P = S.place(params, pshard)
    G = configs.SHAPES[shape_name].global_batch
    if mode == "train":
        ocfg = adamw.AdamWConfig()
        opt = adamw.init(ocfg, params)
        args = (P, S.place(opt, S.opt_shardings(mesh, pshard, opt)),
                S.place(specs["batch"], S.batch_shardings(mesh, specs["batch"])))
        dp = math.prod(mesh.size(i) for i, n in enumerate(names) if n in ("pod", "data"))
        run = steps.make_train_step(model, ocfg, steps.n_micro(arch, G, dp))
    elif mode == "prefill":
        args = (P, S.place(specs["batch"], S.batch_shardings(mesh, specs["batch"])))
        run = lambda p, b: steps.placed_prefill(model, p, b)
    else:
        cache, tokens = specs["cache"], specs["tokens"]
        args = (P, S.place(cache, S.cache_shardings(mesh, cache)),
                S.place(tokens, S.batch_shardings(mesh, tokens)))
        run = lambda p, c, t: steps.placed_decode(model, p, c, t)
    del params
    arguments = nbytes(args)
    _build.reset_meta_operations()
    with Census(arguments) as census, FlopCounterMode(display=False) as flops:
        out = run(*args)
    kernel_ops = dict(_build.meta_operations)
    aten = int(flops.get_total_flops())
    return {
        "arch": arch, "shape": shape_name, "mode": mode, "mesh": mesh_tag,
        "world": math.prod(shape), "smoke": smoke, "lower_s": time.time() - t0,
        "per_device_bytes": {"arguments": arguments, "outputs": nbytes(out),
                             "peak_live": census.peak},
        "cost_analysis": {"flops_per_device": aten + sum(kernel_ops.values()),
                          "aten_flops": aten, "kernel_operations": kernel_ops},
        "collectives": census.census,
    }


def _one(args) -> int:
    """The ``--cell`` child: run the cell, write its record or its .err."""
    arch, shape_name, tag = args.cell
    path = os.path.join(args.out, f"{arch}__{shape_name}__{tag}.json")
    try:
        rec = run_cell(arch, shape_name, tag)
    except Exception:  # noqa: BLE001 — the cell's failure is its record
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        return 1
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--timeout", type=float, default=3600.0, help="seconds a cell")
    ap.add_argument("--cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"), help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    from .. import configs

    args = parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.cell:
        return _one(args)
    if args.all:
        cells = configs.all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        raise SystemExit("dryrun: give --arch and --shape, or --all")
    tags = {"single": ["16x16"], "multi": ["2x16x16"], "both": ["16x16", "2x16x16"]}[args.mesh]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))}
    n_fail = 0
    for arch, shape_name in cells:
        for tag in tags:
            name = f"{arch}__{shape_name}__{tag}"
            path = os.path.join(args.out, name + ".json")
            if os.path.exists(path):
                print(f"[skip] {name} (cached)")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", args.out,
                   "--cell", arch, shape_name, tag]
            try:
                rc = subprocess.run(cmd, env=env, timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                with open(path + ".err", "w") as f:
                    f.write(f"timed out after {args.timeout} s\n")
                rc = 1
            if rc != 0 or not os.path.exists(path):
                n_fail += 1
                err = path + ".err"
                last = (open(err).read().strip().splitlines() or ["?"])[-1] \
                    if os.path.exists(err) else f"exit code {rc}"
                print(f"[FAIL] {name}: {last}")
                continue
            with open(path) as f:
                rec = json.load(f)
            b = rec["per_device_bytes"]
            print(f"[ok]   {name}: arguments {b['arguments'] / 2**30:.2f} GiB, peak live "
                  f"{b['peak_live'] / 2**30:.2f} GiB a rank, {rec['lower_s']:.1f}s")
    print("dry-run complete;", f"{n_fail} FAILURES" if n_fail else "all passed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
