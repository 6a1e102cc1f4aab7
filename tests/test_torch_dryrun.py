"""The dry run (``launch/dryrun.py``) at the smoke size on fake process
groups, against the reference's placement rules, and the kernels' meta
paths and DTensor guards.

Each world runs in a subprocess of its own (a fake group is a process's
default group: never inside a pytest worker), with a timeout, started
together: 4 ranks on a (2, 2) mesh and 16 on (4, 4), each running the
cells of a dense (TinyLlama), an MoE (DBRX) and an RWKV-6 smoke config.
A cell's ``arguments`` equal the sum over its leaves of the local shard
bytes that the reference's specs give on a ``jax.sharding.AbstractMesh``
of the same shape (parameters, AdamW's step, moments, the batch; a
decode cell's cache and tokens).  A (1, 1) mesh's census is empty; a
training cell of 16 ranks gathers every sharded leaf in every
microbatch; a cell that raises leaves its ``.err`` and the run exits 1.
The world of 4 also checks that each kernel wrapper raises TypeError on
a DTensor operand.  In this process: each wrapper's meta path returns
the shapes and dtypes of its plain version's outputs, and counts the
call's operations."""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as rconfigs
from repro.distributed import sharding as rsharding
from repro.launch import steps as rsteps
from repro.models import Model as RModel
from repro.optim import adamw as radamw
from repro_torch.core.sketch import Hash2
from repro_torch.kernels import _build
from repro_torch.kernels.count_sketch import ops as cops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.polymul import ops as pops
from repro_torch.kernels.rwkv6_chunk import ops as wops
from repro_torch.kernels.segment_sum import ops as sops

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
ARCHS = ("tinyllama_1_1b", "dbrx_132b", "rwkv6_1_6b")
# (arch, shape): training where the Python time allows it, decode for each
CELLS = [("tinyllama_1_1b", "train_4k"), ("rwkv6_1_6b", "train_4k"),
         ("tinyllama_1_1b", "decode_32k"), ("dbrx_132b", "decode_32k"),
         ("dbrx_132b", "prefill_32k"), ("rwkv6_1_6b", "decode_32k")]
WORLDS = {"2x2": CELLS, "4x4": CELLS,
          "1x1": [("tinyllama_1_1b", "prefill_32k"), ("dbrx_132b", "prefill_32k")]}

_GUARDS = textwrap.dedent("""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.core.sketch import Hash2
    from repro_torch.kernels.count_sketch import ops as cops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.polymul import ops as pops
    from repro_torch.kernels.rwkv6_chunk import ops as wops
    from repro_torch.kernels.segment_sum import ops as sops
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    d = lambda *s: DTensor.from_local(torch.zeros(*s), mesh, [Replicate(), Replicate()])
    h = Hash2(1, 0, 3, 0, 16)
    seg = sops.Segments.from_ids(np.array([0, 1, 1]), 2, "cpu")
    calls = {
        "flash_attention": lambda: fops.flash_attention_gqa(d(1, 4, 2, 16), d(1, 4, 1, 16),
                                                            d(1, 4, 1, 16)),
        "rwkv6_chunk": lambda: wops.rwkv6_chunk(*(d(1, 16, 1, 16) for _ in range(4)),
                                                d(1, 16)),
        "segment_sum": lambda: sops.segment_sum(d(1, 3, 2), seg),
        "poly_mul": lambda: pops.poly_mul(d(2, 8), d(2, 8)),
        "count_sketch": lambda: cops.count_sketch_hashed(d(64), h),
        "count_sketch unsketch": lambda: cops.unsketch(d(64), d(16), h),
    }
    guards = {}
    for name, call in calls.items():
        try:
            call()
            guards[name] = "no error"
        except TypeError as e:
            guards[name] = str(e)
""")


def _script(tag, cells):
    shape = tuple(int(x) for x in tag.split("x"))
    return textwrap.dedent(f"""
        import json, sys
        import numpy as np, torch
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.launch import dryrun
        dryrun.fake_world({math.prod(shape)})
        out = {{"cells": [dryrun.run_cell(a, s, {tag!r}, smoke=True) for a, s in {cells!r}]}}
    """) + (_GUARDS + "out['guards'] = guards\n" if tag == "2x2" else "") + \
        "print('RESULT ' + json.dumps(out))\n"


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's records, the subprocesses run side by side; and a
    failing run of ``dryrun.main`` beside them."""
    procs = {tag: subprocess.Popen([sys.executable, "-c", _script(tag, cells)],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   env=_env())
             for tag, cells in WORLDS.items()}
    out = tmp_path_factory.mktemp("dryrun")
    failing = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "tinyllama_1_1b",
         "--shape", "no_such_shape", "--mesh", "single", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
    res = {}
    try:
        for tag, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, stderr[-3000:]
            line = next(x for x in stdout.splitlines() if x.startswith("RESULT "))
            res[tag] = json.loads(line[len("RESULT "):])
        stdout, _ = failing.communicate(timeout=TIMEOUT_S)
        res["failing"] = (failing.returncode, stdout, out)
    finally:
        for p in (*procs.values(), failing):
            p.kill()
    return res


def _local_bytes(spec, shape, itemsize, sizes):
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n *= d // math.prod(sizes[a] for a in axes)
    return n * itemsize


def _tree_bytes(shardings, shapes, sizes):
    return sum(_local_bytes(tuple(s.spec), x.shape, np.dtype(x.dtype).itemsize, sizes)
               for s, x in zip(jax.tree.leaves(shardings), jax.tree.leaves(shapes)))


def _reference_arguments(arch, shape_name, tag):
    """The cell's argument bytes a rank holds, by the reference's specs."""
    shape = tuple(int(x) for x in tag.split("x"))
    names = ("data", "model")
    mesh, sizes = AbstractMesh(shape, names), dict(zip(names, shape))
    cfg = rconfigs.get_smoke(arch)
    model = RModel(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    pshard = rsharding.param_shardings(mesh, params)
    total = _tree_bytes(pshard, params, sizes)
    spec = rconfigs.SHAPES[shape_name]
    if spec.mode == "train":
        opt = jax.eval_shape(lambda p: radamw.init(radamw.AdamWConfig(), p), params)
        total += 4 + 2 * _tree_bytes(pshard, opt.m, sizes)       # the step, m, v
    if spec.mode in ("train", "prefill"):
        batch = rsteps.batch_specs(cfg, spec)
        return total + _tree_bytes(rsharding.batch_shardings(mesh, batch), batch, sizes)
    cache = jax.eval_shape(lambda: model.init_cache(spec.global_batch, spec.seq_len))
    tokens = jax.ShapeDtypeStruct((spec.global_batch,), np.int32)
    return (total + _tree_bytes(rsharding.cache_shardings(mesh, cache), cache, sizes)
            + _tree_bytes(rsharding.batch_shardings(mesh, tokens), tokens, sizes))


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
@pytest.mark.parametrize("tag", ["2x2", "4x4"])
def test_arguments_equal_the_reference_specs(worlds, tag, cell):
    rec = next(r for r in worlds[tag]["cells"] if (r["arch"], r["shape"]) == cell)
    assert rec["world"] == math.prod(int(x) for x in tag.split("x"))
    assert rec["per_device_bytes"]["arguments"] == _reference_arguments(*cell, tag)
    assert rec["per_device_bytes"]["peak_live"] >= rec["per_device_bytes"]["arguments"]
    assert rec["cost_analysis"]["flops_per_device"] > 0


def test_training_gathers_every_sharded_leaf_every_microbatch(worlds):
    """On 16 ranks TinyLlama's 9 sharded leaves (embed.tok, head, wq, wk,
    wv, wo, w_gate, w_up, w_down) are gathered at least once a microbatch
    (twice for a block's under remat), and the gradients reduce-scattered;
    the kernel's operations are counted apart."""
    rec = next(r for r in worlds["4x4"]["cells"] if r["arch"] == "tinyllama_1_1b"
               and r["mode"] == "train")
    n_micro = 8                                    # steps.n_micro(arch, 256, dp 4)
    census = rec["collectives"]
    assert census["all-gather"]["count"] >= 9 * n_micro
    assert census["reduce-scatter"]["count"] >= 9 * n_micro
    assert census["all-reduce"]["count"] > 0
    assert rec["cost_analysis"]["kernel_operations"]["flash_attention"] > 0


def test_a_mesh_of_one_exchanges_nothing(worlds):
    assert len(worlds["1x1"]["cells"]) == len(WORLDS["1x1"])
    for rec in worlds["1x1"]["cells"]:
        assert all(v == {"count": 0, "bytes": 0} for v in rec["collectives"].values())


@pytest.mark.parametrize("tag", ["2x2", "4x4"])
def test_moe_flops_a_rank_do_not_grow_with_the_mesh(worlds, tag):
    """DBRX's prefill routes each microbatch whole over dp, and a dp rank's
    expert buffer holds its own tokens' pairs alone: the FLOPs summed over
    the mesh's ranks are at most the one-rank cell's (a buffer of the
    group's capacity on every rank would multiply the expert products by
    dp)."""
    flops = {t: next(r for r in worlds[t]["cells"] if (r["arch"], r["shape"])
                     == ("dbrx_132b", "prefill_32k"))["cost_analysis"]["flops_per_device"]
             for t in (tag, "1x1")}
    world = math.prod(int(x) for x in tag.split("x"))
    assert flops[tag] * world <= flops["1x1"], (flops, world)


def test_a_failing_cell_is_recorded_and_the_run_exits_1(worlds):
    rc, stdout, out = worlds["failing"]
    assert rc == 1 and "[FAIL]" in stdout and "1 FAILURES" in stdout
    err = out / "tinyllama_1_1b__no_such_shape__16x16.json.err"
    assert err.exists() and "no_such_shape" in err.read_text()


GUARDED = ("flash_attention", "rwkv6_chunk", "segment_sum", "poly_mul", "count_sketch",
           "count_sketch unsketch")


@pytest.mark.parametrize("name", GUARDED)
def test_a_kernel_wrapper_refuses_a_dtensor(worlds, name):
    msg = worlds["2x2"]["guards"][name]
    assert msg.startswith(f"{name.split(' ')[0]}") and "DTensor" in msg, msg


# ------------------------------------------------------ the meta paths --
def _pair(make):
    """(a CPU call's outputs, the same call's on meta), as lists."""
    as_list = lambda o: list(o) if isinstance(o, tuple) else [o]
    return as_list(make("cpu")), as_list(make("meta"))


def _z(dev, *shape, dtype=torch.float32):
    return torch.rand(*shape, dtype=dtype, device=dev) if dev == "cpu" else \
        torch.empty(*shape, dtype=dtype, device=dev)


META_CALLS = {
    "flash_attention": lambda dev: fops.flash_attention_gqa(
        _z(dev, 2, 24, 4, 16), _z(dev, 2, 24, 2, 16), _z(dev, 2, 24, 2, 16)),
    "flash_attention_lse_window": lambda dev: fops.flash_attention_gqa(
        _z(dev, 1, 24, 4, 16, dtype=torch.bfloat16), _z(dev, 1, 24, 1, 16, dtype=torch.bfloat16),
        _z(dev, 1, 24, 1, 16, dtype=torch.bfloat16), return_lse=True, window=8),
    "flash_attention_cross": lambda dev: fops.flash_attention_gqa(
        _z(dev, 2, 8, 4, 32), _z(dev, 2, 20, 2, 32), _z(dev, 2, 20, 2, 32), causal=False),
    "rwkv6_chunk": lambda dev: wops.rwkv6_chunk(
        *(_z(dev, 1, 32, 2, 16) for _ in range(3)), -_z(dev, 1, 32, 2, 16), _z(dev, 2, 16),
        return_state=True),
    "rwkv6_chunk_bwd": lambda dev: wops.rwkv6_chunk_bwd(
        *(_z(dev, 1, 32, 2, 16) for _ in range(3)), -_z(dev, 1, 32, 2, 16), _z(dev, 2, 16),
        _z(dev, 1, 32, 2, 16)),
    "segment_sum": lambda dev: sops.segment_sum(
        _z(dev, 2, 3, 5), sops.Segments.from_ids(np.array([0, 2, 2]), 4, "cpu")),
    "poly_mul": lambda dev: pops.poly_mul(_z(dev, 1, 3, 16), _z(dev, 2, 3, 16)),
    "count_sketch_hashed": lambda dev: cops.count_sketch_hashed(_z(dev, 64), Hash2(1, 0, 3, 0, 16)),
    "count_sketch": lambda dev: cops.count_sketch(
        _z(dev, 8), torch.zeros(8, dtype=torch.int32, device=dev),
        torch.ones(8, device=dev), 16),
    "unsketch": lambda dev: cops.unsketch(_z(dev, 64), _z(dev, 16), Hash2(1, 0, 3, 0, 16)),
}


@pytest.mark.parametrize("name", list(META_CALLS))
def test_meta_path_gives_the_plain_versions_shapes(name):
    _build.reset_meta_operations()
    plain, meta = _pair(META_CALLS[name])
    assert [(tuple(t.shape), t.dtype) for t in meta] == [(tuple(t.shape), t.dtype) for t in plain]
    assert all(t.device.type == "meta" for t in meta)
    assert sum(_build.meta_operations.values()) > 0


def test_meta_operations_follow_the_formulas():
    """flash_attention: 4·B·N·dh·pairs (causal S(S+1)/2; full S·Sk)."""
    _build.reset_meta_operations()
    META_CALLS["flash_attention"]("meta")
    assert _build.meta_operations == {"flash_attention": 4 * 2 * 4 * 16 * (24 * 25 // 2)}
    META_CALLS["flash_attention_cross"]("meta")
    assert _build.meta_operations["flash_attention"] == (4 * 2 * 4 * 16 * 300
                                                         + 4 * 2 * 4 * 32 * 8 * 20)
    assert fops.pairs(24, True, 8) == 8 * 9 // 2 + 16 * 8
    before = (fops.launches, wops.launches, sops.launches, pops.launches, cops.launches)
    for make in META_CALLS.values():
        make("meta")
    assert (fops.launches, wops.launches, sops.launches, pops.launches, cops.launches) == before
