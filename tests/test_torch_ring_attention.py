"""The port's ring attention (``emmax_torch.ops.ring_attention``) on 8 gloo
ranks against ``emmax_tpu.ops.ring_attention`` on the same mesh and
against plain attention, mirroring ``tests/test_ring_attention.py``:
causal and bidirectional, a key padding mask, and a ring on the tensor
axis. Each rank holds its block of the sequence and returns its block of
the output; the blocks are put back in axis order here. ``atol 2e-5``,
JAX's own.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from emmax_tpu.ops.attention import xla_attention
from emmax_tpu.ops.ring_attention import ring_attention
from emmax_tpu.parallel import make_mesh
from torch_gloo_pool import GlooPool

ATOL = 2e-5


@pytest.fixture(scope="module")
def pool():
    p = GlooPool()
    yield p
    p.close()


def _qkv(rng, B=2, L=64, H=2, D=16):
    return tuple(rng.normal(size=(B, L, H, D)).astype(np.float32)
                 for _ in range(3))


def _port(pool, q, k, v, mesh_shape, axis, causal, kv_mask=None):
    """The ranks' output blocks in axis order (ranks that differ on the
    other axes hold the same block and must agree)."""
    results = pool.run("ring", q=q, k=k, v=v, mesh_shape=mesh_shape,
                       axis_name=axis, causal=causal, kv_mask=kv_mask)
    blocks = {}
    for r in results:
        if r["index"] in blocks:
            np.testing.assert_array_equal(r["out"], blocks[r["index"]])
        blocks[r["index"]] = r["out"]
    return np.concatenate([blocks[i] for i in sorted(blocks)], axis=1)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_ring_and_reference(pool, causal):
    q, k, v = _qkv(np.random.default_rng(0))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = xla_attention(jq, jk, jv, causal=causal)
    jring = ring_attention(jq, jk, jv, mesh=make_mesh((1, 8, 1)),
                           axis_name="fsdp", causal=causal)
    out = _port(pool, q, k, v, (1, 8, 1), "fsdp", causal)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(jring), atol=ATOL)


def test_ring_with_padding_mask(pool):
    q, k, v = _qkv(np.random.default_rng(1))
    kv_mask = np.ones((2, 64), bool)
    kv_mask[0, :16] = False
    kv_mask[1, 50:] = False
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, kv_mask))
    ref = xla_attention(jq, jk, jv, kv_mask=jm, causal=True)
    jring = ring_attention(jq, jk, jv, mesh=make_mesh((1, 8, 1)),
                           axis_name="fsdp", kv_mask=jm, causal=True)
    out = _port(pool, q, k, v, (1, 8, 1), "fsdp", True, kv_mask)
    np.testing.assert_allclose(out[kv_mask], np.asarray(ref)[kv_mask],
                               atol=ATOL)
    # rows with no valid key: the same arithmetic as JAX's ring
    np.testing.assert_allclose(out, np.asarray(jring), atol=ATOL)


def test_ring_on_tensor_axis(pool):
    """The context axis can be any mesh axis: 2-way ``tensor`` of
    (1, 4, 2), each of the 4 fsdp ranks running its own ring."""
    q, k, v = _qkv(np.random.default_rng(2), L=32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = xla_attention(jq, jk, jv, causal=True)
    jring = ring_attention(jq, jk, jv, mesh=make_mesh((1, 4, 2)),
                           axis_name="tensor", causal=True)
    out = _port(pool, q, k, v, (1, 4, 2), "tensor", True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(jring), atol=ATOL)
