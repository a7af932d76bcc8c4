"""The port's mesh and sharding rules (``emmax_torch.parallel``) against
``emmax_tpu.parallel``: mesh shapes and strategies, and the placement of
every leaf (spec, the local block's shape, one rank's bytes) of the tiny
tree on 8 gloo ranks and, by shapes alone, of the full-width
``prism-dinosiglip-224px+7b`` tree in bf16 and int4 (JAX:
``NamedSharding(mesh, spec).shard_shape``; the port: its meta-device
tree), at (1,8,1), (1,4,2) and (2,2,2); then ``shard_params`` ->
``gather_params`` gives the tree back bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.tree import leaves_with_path
from emmax_torch.parallel import mesh as t_mesh
from emmax_torch.parallel import sharding as t_sharding
from emmax_torch.serving.quant import quantize_vlm_params as t_quantize
from emmax_tpu.models.vlm import (emma_x_vlm_config, init_vlm_params,
                                  tiny_vlm_config)
from emmax_tpu.parallel import make_mesh, param_partition_specs
from emmax_tpu.parallel import mesh as j_mesh
from emmax_tpu.serving.quant import quantize_vlm_params as j_quantize
from torch_gloo_pool import GlooPool

MESHES = [(1, 8, 1), (1, 4, 2), (2, 2, 2)]
AXES = ("replica", "fsdp", "tensor")


@pytest.fixture(scope="module")
def pool():
    p = GlooPool()
    yield p
    p.close()


def _path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jax_table(params, shape):
    """{path: (spec, shard shape, shard bytes)} of the JAX package."""
    mesh = make_mesh(shape)
    specs = param_partition_specs(params, mesh)
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
        local = NamedSharding(mesh, spec).shard_shape(leaf.shape)
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        out[_path(path)] = (entries, tuple(local),
                            math.prod(local) * leaf.dtype.itemsize)
    return out


def test_mesh_shapes_and_strategies_match_jax():
    for shape, n in [((1, -1, 1), 8), ((2, -1, 2), 8), ((-1, 1, 1), 4),
                     ((1, 1, 1), 1), ((2, 2, 2), 8)]:
        assert t_mesh.resolve_mesh_shape(shape, n) == \
            j_mesh.resolve_mesh_shape(shape, n)
    for bad, n in [((-1, -1, 1), 8), ((3, -1, 1), 8), ((2, 2, 1), 8)]:
        with pytest.raises(AssertionError):
            j_mesh.resolve_mesh_shape(bad, n)
        with pytest.raises(ValueError):
            t_mesh.resolve_mesh_shape(bad, n)
    for strategy in ("fsdp-full-shard", "fsdp", "fsdp-shard-grad-op", "ddp"):
        for n, hosts in [(8, 1), (8, 2), (16, 4), (1, 1)]:
            assert t_mesh.strategy_to_mesh_shape(strategy, n, hosts) == \
                j_mesh.strategy_to_mesh_shape(strategy, n, hosts)
    with pytest.raises(ValueError):
        t_mesh.strategy_to_mesh_shape("zero-9", 8)
    assert t_mesh.AXIS_NAMES == AXES


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_tiny_tree_placement_matches_jax_on_gloo_ranks(pool, shape):
    """Every rank's spec and block shape equal JAX's for every leaf; the
    blocks gather back to the tree bit for bit; the DTensor placements
    name the split dims."""
    params = init_vlm_params(jax.random.PRNGKey(0), tiny_vlm_config())
    want = _jax_table(params, shape)
    host = jax.tree_util.tree_map(np.asarray, params)
    results = pool.run("placement", params=host, mesh_shape=shape)
    sizes = dict(zip(AXES, shape))
    coords = set()
    for r in results:
        assert r["round_trip_equal"]
        coords.add(tuple(r["coordinate"]))
        assert set(r["table"]) == set(want)
        for path, (spec, local) in r["table"].items():
            assert (spec, local) == want[path][:2], path
            placements = t_sharding.placements(spec, sizes)
            for axis, pl in zip(AXES, placements):
                dims = [d for d, e in enumerate(spec) if e == axis]
                assert (pl.is_shard(dims[0]) if dims else pl.is_replicate())
    assert len(coords) == 8


@pytest.fixture(scope="module")
def full_width_trees():
    """The 7B trees' shapes, bf16 and int4: JAX's by ``jax.eval_shape``,
    the port's on the meta device (traced once for every mesh)."""
    cfg = emma_x_vlm_config()

    def jax_tree(bits):
        p = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                   init_vlm_params(jax.random.PRNGKey(0),
                                                   cfg))
        return j_quantize(p, bits=4) if bits else p

    port = t_vlm.init_vlm_params(torch.Generator(), t_vlm.emma_x_vlm_config(),
                                 torch.bfloat16, "meta")
    return {bits: (jax.eval_shape(lambda: jax_tree(bits)),
                   t_quantize(port, bits=4) if bits else port)
            for bits in (None, 4)}


@pytest.mark.parametrize("bits", [None, 4], ids=["bf16", "int4"])
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_full_width_placement_matches_jax_by_shapes(full_width_trees, shape,
                                                    bits):
    """The 7B tree, shapes only: spec, block shape and one rank's bytes of
    every leaf equal JAX's (``NamedSharding.shard_shape``; nothing is
    allocated on either side). The int4 tree's ``q4`` / ``scale``
    sub-leaves are replicated in both."""
    jax_tree, tree = full_width_trees[bits]
    want = _jax_table(jax_tree, shape)
    sizes = dict(zip(AXES, shape))
    specs = t_sharding.param_partition_specs(tree, sizes)
    got = {}
    for path, leaf in leaves_with_path(tree):
        local = t_sharding.local_shape(leaf.shape, specs[path], sizes)
        got[path] = (specs[path], local,
                     math.prod(local) * leaf.element_size())
    assert got == want
    assert sum(v[2] for v in got.values()) == sum(v[2]
                                                  for v in want.values())


def test_batch_rows_follow_jax_batch_sharding():
    """A data leaf's rows per rank and its placements: the batch dim over
    (replica, fsdp) when it divides, else every row on every rank."""
    class Mesh:   # the coordinates a DeviceMesh reports, without a group
        mesh_dim_names = AXES

        def __init__(self, shape, coord):
            self.shape, self.coord = shape, coord

        def get_local_rank(self, axis):
            return self.coord[AXES.index(axis)]

    batch = np.arange(16).reshape(8, 2)
    jmesh = make_mesh((2, 2, 2))
    jarr = jax.device_put(batch, jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec(("replica", "fsdp"))))
    by_device = {s.device: np.asarray(s.data) for s in jarr.addressable_shards}
    for idx in np.ndindex(2, 2, 2):
        mesh = Mesh((2, 2, 2), idx)
        got = t_sharding.batch_rows({"x": batch}, mesh)["x"]
        np.testing.assert_array_equal(got, by_device[jmesh.devices[idx]])
    odd = np.arange(6)
    assert t_sharding.batch_rows(odd, Mesh((2, 2, 2), (1, 1, 0))) is odd
    shard = t_sharding.batch_sharding(Mesh((2, 2, 2), (0, 0, 0)), 2, 8)
    assert [p.is_shard(0) for p in shard] == [True, True, False]
    assert all(p.is_replicate() for p in
               t_sharding.batch_sharding(Mesh((2, 2, 2), (0, 0, 0)), 2, 6))
    assert all(p.is_replicate() for p in
               t_sharding.batch_sharding(Mesh((2, 2, 2), (0, 0, 0)), 0))
