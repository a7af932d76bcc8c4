"""Port parity: attention, norms and RoPE (``emmax_torch.ops``) against
``emmax_tpu.ops`` on the same numpy inputs, in fp32 on the CPU.

The port's flash wrapper takes its plain version for CPU tensors; it is
held against the JAX flash kernel run through the Pallas interpreter, and
the port's plain attention against ``xla_attention``. Tolerance: 1e-5
(fp32, sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.ops import attention as t_attn
from emmax_torch.ops import flash_attention as t_flash
from emmax_torch.ops import norms as t_norms
from emmax_torch.ops import rope as t_rope
from emmax_tpu.ops import attention as j_attn
from emmax_tpu.ops import flash_attention as j_flash
from emmax_tpu.ops import norms as j_norms
from emmax_tpu.ops import rope as j_rope

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, B, Lq, S, H, D, KVH=None):
    rng = np.random.default_rng(seed)
    KVH = KVH or H
    return (rng.standard_normal((B, Lq, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KVH, D)).astype(np.float32),
            rng.standard_normal((B, S, KVH, D)).astype(np.float32))


def _left_pad_mask(B, S, valid_from, valid_to):
    """[B, S]: row b holds slots [valid_from[b], valid_to) valid."""
    m = np.zeros((B, S), bool)
    for b in range(B):
        m[b, valid_from[b]:valid_to] = True
    return m


# (name, Lq, S, D, causal, q_offset, mask) — D 64/72/128 are the DINOv2,
# SigLIP and Llama head dims; lengths are not tile multiples.
FLASH_CASES = [
    ("bidir_d64", 21, 21, 64, False, 0, None),
    ("bidir_d72", 16, 16, 72, False, 0, None),
    ("causal_d128", 19, 19, 128, True, 0, None),
    ("cached_prefill_pad", 24, 40, 128, True, 0, ("pad", [5, 0], 24)),
    ("rect_offset", 10, 33, 64, True, 7, ("pad", [3, 0], 17)),
    ("fully_masked_rows", 12, 12, 72, True, 0, ("pad", [12, 4], 12)),
    ("decode_lq1", 1, 30, 64, True, 20, ("pad", [2, 0], 21)),
    ("decode_lq4", 4, 30, 64, True, 20, ("pad", [2, 0], 24)),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_jax_flash(case):
    name, Lq, S, D, causal, q_offset, mask = case
    B, H = 2, 2
    q, k, v = _qkv(len(name), B, Lq, S, H, D)
    kv_mask = None if mask is None else _left_pad_mask(B, S, mask[1], mask[2])
    want = np.asarray(j_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
        causal=causal, q_offset=q_offset))
    got = t_flash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask),
        causal=causal, q_offset=q_offset).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if name == "fully_masked_rows":
        # row 0's queries see no valid key: exact zeros, as the kernel
        assert not np.any(got[0])


def test_flash_sm_scale_default_and_explicit():
    q, k, v = _qkv(3, 1, 9, 9, 2, 16)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    base = t_flash.flash_attention(*args)
    explicit = t_flash.flash_attention(*args, sm_scale=16 ** -0.5)
    torch.testing.assert_close(base, explicit, rtol=0, atol=0)
    want = np.asarray(j_flash.flash_attention(
        *[jnp.asarray(a) for a in (q, k, v)], sm_scale=0.3))
    got = t_flash.flash_attention(*args, sm_scale=0.3).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal,q_offset,gqa", [
    (False, 0, 1), (True, 0, 1), (True, 6, 2), (True, 0, 2)])
def test_plain_attention_matches_xla_attention(causal, q_offset, gqa):
    B, Lq, S, H, D = 2, 7, 15, 4, 32
    q, k, v = _qkv(11, B, Lq, S, H, D, KVH=H // gqa)
    kv_mask = _left_pad_mask(B, S, [4, 0], 13)
    want = np.asarray(j_attn.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(kv_mask), causal=causal, q_offset=q_offset))
    got = t_attn.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=torch.from_numpy(kv_mask), causal=causal, q_offset=q_offset,
        impl="torch").numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_dispatch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 9, 9, 2, 16))
    # "auto" on CPU tensors is the plain path
    torch.testing.assert_close(
        t_attn.multi_head_attention(q, k, v, impl="auto"),
        t_attn.xla_attention(q, k, v), rtol=0, atol=0)
    # "cuda" on CPU tensors is the kernel's plain version
    torch.testing.assert_close(
        t_attn.multi_head_attention(q, k, v, impl="cuda"),
        t_flash.flash_attention_reference(q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError):
        t_attn.multi_head_attention(q, k, v, impl="pallas")


def test_norms_match():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 48)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(
        t_norms.rms_norm(*map(torch.from_numpy, (x, w)), 1e-5).numpy(),
        np.asarray(j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        **TOL)
    np.testing.assert_allclose(
        t_norms.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-6).numpy(),
        np.asarray(j_norms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), 1e-6)), **TOL)


def test_rope_matches():
    rng = np.random.default_rng(1)
    pos = np.array([[0, 0, 1, 2, 3, 40], [0, 1, 2, 3, 4, 5]], np.int32)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = t_rope.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(
        t_rope.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(j_rope.apply_rope(jnp.asarray(x), jc, js)), **TOL)
