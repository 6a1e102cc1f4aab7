"""The port's placement rules against the reference's, in one process
with no process group: the spec of every parameter, decode-cache and
batch leaf of the 10 LM configs at full size, on the production meshes
(16, 16) and (2, 16, 16) and on (2, 2) and (4, 1), equals the
reference's ``param_shardings`` / ``cache_shardings`` /
``batch_shardings`` on a ``jax.sharding.AbstractMesh`` of the same shape
over ``jax.eval_shape`` of its ``Model``.  The port's parameter tree is
built on ``meta`` (``launch.dryrun.OnMeta``) in the stacked layout; its
decode cache holds per-layer leaves, held against the reference's
stacked ones less the L axis (a hybrid's reference cache is per-layer
too); the port's cross-attention k, v (an encoder–decoder's ``xk``,
``xv``, which the reference recomputes) take the k rule's rows and their
K/V heads over tp (as the tensor-parallel cross-attention holds them).  Also:
``to_placements``, ``elastic.plan_mesh``, the shapes of
``configs.cells``/``all_cells`` and ``steps.batch_specs``."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro import configs as rconfigs
from repro.distributed import sharding as rsharding
from repro.launch import steps as rsteps
from repro.models import Model as RModel
from repro.runtime import elastic as relastic
from repro_torch import configs
from repro_torch.distributed import sharding as S
from repro_torch.launch import steps
from repro_torch.launch.dryrun import OnMeta
from repro_torch.models import Model, stack_layers
from repro_torch.runtime import elastic

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


def _norm(spec, ndim):
    """A spec as a tuple of ndim entries (a PartitionSpec's tail is None)."""
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _ref_specs(shardings, shapes):
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    dims = {rsharding._path_str(p): len(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    return {rsharding._path_str(p): _norm(s.spec, dims[rsharding._path_str(p)])
            for p, s in flat}


def _port_specs(shardings, tree):
    from repro_torch.tree import leaves
    return {p: _norm(s.spec, t.dim()) for p, s, t in
            zip(S.path_strings(tree), leaves(shardings), leaves(tree))}


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(the reference's abstract parameters, the port's on meta)."""
    ref = jax.eval_shape(RModel(rconfigs.get(arch)).init, jax.random.PRNGKey(0))
    with OnMeta():
        port = stack_layers(Model(configs.get(arch), device="meta").init(torch.Generator()))
    return ref, port


def _meshes(tag):
    shape, names = MESHES[tag]
    return JaxAbstractMesh(shape, names), S.AbstractMesh(shape, names)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_placement_equals_the_reference(arch, tag):
    ref, port = _params(arch)
    rmesh, pmesh = _meshes(tag)
    want = _ref_specs(rsharding.param_shardings(rmesh, ref), ref)
    got = _port_specs(S.param_shardings(pmesh, port), port)
    assert got == want
    if tag == "16x16" and arch == "tinyllama_1_1b":       # spot checks by hand
        assert got["embed/head"] == ("data", "model") and got["embed/tok"] == ("model", "data")
        assert got["layers/attn/wq"] == (None, "data", "model")
        assert got["layers/attn/wo"] == (None, "model", "data")


def _decode_shapes(arch):
    return [s for s in configs.cells(arch) if configs.SHAPES[s].mode == "decode"]


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cache_placement_equals_the_reference(arch, tag):
    rmesh, pmesh = _meshes(tag)
    cfg = configs.get(arch)
    for shape_name in _decode_shapes(arch):
        B, Sq = configs.SHAPES[shape_name].global_batch, configs.SHAPES[shape_name].seq_len
        src = Sq // 2 if cfg.is_encdec else 0
        rcache = jax.eval_shape(lambda: RModel(rconfigs.get(arch)).init_cache(B, Sq, src_len=src))
        want = _ref_specs(rsharding.cache_shardings(rmesh, rcache), rcache)
        pcache = steps.input_specs(arch, shape_name)[1]["cache"]
        got = _port_specs(S.cache_shardings(pmesh, pcache), pcache)
        stacked = isinstance(rcache["layers"], dict)
        for path, spec in got.items():
            parts = path.split("/")
            if parts[0] == "layers" and parts[-1] in ("xk", "xv"):     # the port's own
                tp = dict(zip(*reversed(MESHES[tag])))["model"]
                heads = "model" if cfg.kv_heads % tp == 0 else None
                assert spec == (got["/".join(parts[:-1] + ["k"])][0], None, heads, None), path
                continue
            if parts[0] == "layers" and stacked:
                ref = want["/".join(["layers"] + parts[2:])]
                assert ref[0] is None and spec == ref[1:], (shape_name, path)
            else:
                assert spec == want[path], (shape_name, path)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_batch_placement_equals_the_reference(arch, tag):
    rmesh, pmesh = _meshes(tag)
    for shape_name, shape in configs.SHAPES.items():
        rb = rsteps.batch_specs(rconfigs.get(arch), rconfigs.SHAPES[shape_name])
        pb = steps.batch_specs(configs.get(arch), shape)
        assert _port_specs(S.batch_shardings(pmesh, pb), pb) == \
            _ref_specs(rsharding.batch_shardings(rmesh, rb), rb)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_batch_specs_and_cells_equal_the_reference(arch):
    assert configs.cells(arch) == rconfigs.cells(arch)
    for shape_name, shape in configs.SHAPES.items():
        assert dataclasses_equal(shape, rconfigs.SHAPES[shape_name])
        rb = rsteps.batch_specs(rconfigs.get(arch), rconfigs.SHAPES[shape_name])
        pb = steps.batch_specs(configs.get(arch), shape)
        assert sorted(pb) == sorted(rb)
        for k in rb:
            assert tuple(pb[k].shape) == tuple(rb[k].shape), (shape_name, k)
            assert str(pb[k].dtype).replace("torch.", "") == str(jnp.dtype(rb[k].dtype))
            assert pb[k].device.type == "meta"


def dataclasses_equal(a, b):
    return (a.name, a.seq_len, a.global_batch, a.mode) == (b.name, b.seq_len, b.global_batch,
                                                          b.mode)


def test_all_cells_equal_the_reference():
    assert configs.ARCHS == rconfigs.ARCHS
    assert configs.all_cells() == rconfigs.all_cells()


def test_to_placements():
    m2 = S.AbstractMesh((16, 16), ("data", "model"))
    m3 = S.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert S.to_placements(m2, ("data", "model")) == (Shard(0), Shard(1))
    assert S.to_placements(m2, ("model", "data")) == (Shard(1), Shard(0))
    assert S.to_placements(m2, (None, "data", "model")) == (Shard(1), Shard(2))
    assert S.to_placements(m2, ()) == (Replicate(), Replicate())
    assert S.to_placements(m2, (None, "model")) == (Replicate(), Shard(1))
    assert S.to_placements(m3, (("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert S.to_placements(m3, ("model", ("pod", "data"))) == (Shard(1), Shard(1), Shard(0))
    assert S.to_placements(m3, (("pod", "data"),)) == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        S.to_placements(m3, (("data", "pod"),))
    # the spec a rule gives, turned into placements: dp rows of a batch
    assert S.batch_shardings(m3, {"t": torch.empty(64, 8, device="meta")})["t"].placements \
        == (Shard(0), Shard(0), Replicate())


def test_shard_of_a_dimension_the_axes_do_not_divide_stays_whole():
    m = S.AbstractMesh((16, 16), ("data", "model"))
    assert S.logical_to_spec(m, ("fsdp", "tp"), (4096, 8)) == ("data", None)
    assert S.logical_to_spec(m, ("fsdp", "tp"), (7, 4, 8192)) == (None, None, "model")
    assert S.logical_to_spec(m, ("fsdp", "tp"), (3, 4096, 8192)) == (None, "data", "model")


def test_plan_mesh_equals_the_reference():
    for n in range(1, 513):
        for mp in (1, 2, 4, 8, 16):
            assert elastic.plan_mesh(n, mp) == relastic.plan_mesh(n, mp), (n, mp)
    assert elastic.plan_mesh(512, 16) == (32, 16) and elastic.plan_mesh(24, 16) == (3, 8)


def test_constrain_is_a_no_op_outside_a_mesh():
    x = torch.randn(4, 8, 16)
    assert S.constrain(x, "dp", "tp", None) is x
    with S.use_mesh(S.AbstractMesh((1, 1), ("data", "model"))):
        assert S.constrain(x, "dp", None, None) is x
    with S.use_mesh(S.AbstractMesh((2, 2), ("data", "model"))):
        assert S.constrain(x, "dp", None, None) is x        # a rank's own rows
