"""Port parity: int4 quantizers and the int4 matmul's plain version
(``emmax_torch.ops.int4_matmul``) against ``emmax_tpu.ops.int4_matmul``.

The packed bytes must be identical (a tree quantized by either package
runs in the other). The matmul is compared in fp32 with the JAX kernel run
through the Pallas interpreter: that kernel casts x to bf16 before its
dots, so x is drawn bf16-representable; tolerance 1e-5 relative and
absolute (fp32 sums in another order, and the kernel folds the mid-rise
+0.5 into a rowsum epilogue).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.ops import int4_matmul as t4
from emmax_tpu.ops import int4_matmul as j4


def _weight(seed, shape, zero_rows=0):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(
        np.float32)
    w[..., :zero_rows, :5] = 0.0    # a whole group of zeros -> scale 0
    return w


# (shape, group): stacked and unstacked, a group that shrinks (D=96 -> 16)
QUANT_CASES = [((256, 40), 128), ((3, 256, 40), 128), ((96, 24), 128),
               ((128, 36), 64)]


@pytest.mark.parametrize("shape,group", QUANT_CASES,
                         ids=[f"{s}-g{g}" for s, g in QUANT_CASES])
def test_quantizers_byte_identical(shape, group):
    w = _weight(sum(shape), shape, zero_rows=group)
    want = j4.quantize_weight_int4_np(w, group=group)
    want_scale = np.asarray(want["scale"]).view(np.uint16)
    got_np = t4.quantize_weight_int4_np(w, group=group)
    np.testing.assert_array_equal(got_np["q4"], want["q4"])
    np.testing.assert_array_equal(got_np["scale"], want_scale)
    got_t = t4.quantize_weight_int4(torch.from_numpy(w), group=group)
    np.testing.assert_array_equal(got_t["q4"].numpy(), want["q4"])
    np.testing.assert_array_equal(got_t["scale"].view(torch.uint16).numpy(),
                                  want_scale)
    assert got_t["scale"].dtype == torch.bfloat16


def test_dequantize_matches_and_zero_group_decodes_to_zero():
    w = _weight(7, (2, 128, 24), zero_rows=32)
    q = j4.quantize_weight_int4_np(w, group=32)
    want = np.asarray(j4.dequantize_weight_int4(q))
    got = t4.dequantize_weight_int4(params_from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.any(got[..., :32, :5]) and np.all(got[..., 32:, :5])


@pytest.mark.parametrize("M", [1, 44, 130])
def test_stacked_matmul_matches_interpret_kernel(M):
    L, D, F = 3, 256, 200                      # F ragged: not a 128 multiple
    q = j4.quantize_weight_int4_np(_weight(M, (L, D, F)))
    rng = np.random.default_rng(M + 1)
    x = (rng.standard_normal((M, D)).astype(ml_dtypes.bfloat16)
         .astype(np.float32))
    layer = 1
    want = np.asarray(j4.int4_matmul(
        jnp.asarray(x), {**{k: jnp.asarray(v) for k, v in q.items()},
                         "layer": jnp.int32(layer)}, impl="interpret"))
    tq = params_from_numpy(q)
    got = t4.int4_matmul(torch.from_numpy(x), {**tq, "layer": layer})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the unstacked form on the same layer, and a leading batch dim
    flat = t4.int4_matmul(torch.from_numpy(x).reshape(1, M, D),
                          {"q4": tq["q4"][layer], "scale": tq["scale"][layer]})
    torch.testing.assert_close(flat[0], got, rtol=0, atol=0)


def test_matmul_matches_xla_impl_small_group():
    D, F = 64, 48                              # tiny dims: group shrinks to 32
    q = j4.quantize_weight_int4_np(_weight(3, (D, F)))
    assert np.asarray(q["scale"]).shape == (2, F)
    x = np.random.default_rng(4).standard_normal((5, D)).astype(np.float32)
    want = np.asarray(j4.int4_matmul(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in q.items()},
        impl="xla"))
    got = t4.int4_matmul(torch.from_numpy(x), params_from_numpy(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_launch_shape_covers_every_group():
    for M, F, g_half in [(1, 4096, 16), (1, 32064, 16), (1, 4096, 43),
                         (448, 11008, 16), (3, 64, 1)]:
        mt, gps, splits = t4._launch_shape(M, F, g_half, sm_count=132)
        assert mt in (1, 2, 4, 8) and gps * splits >= g_half
        assert gps * (splits - 1) < g_half     # no empty split
        # fp32 x on the TF32 tensor cores: blocks of 8 or 32 rows of x
        mt, gps, splits = t4._launch_shape(M, F, g_half, sm_count=132,
                                           tensor_cores=True, tf32=True)
        assert mt in (8, 32) and gps * splits >= g_half
        assert gps * (splits - 1) < g_half
