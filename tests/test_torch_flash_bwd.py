"""Port parity: the flash-attention backward and the forward's LSE
(``emmax_torch.ops.flash_attention``) against ``emmax_tpu``'s, in fp32 on
the CPU.

The JAX side differentiates ``emmax_tpu.ops.flash_attention`` with
``jax.grad``: its ``custom_vjp`` runs the Pallas forward and the dQ and
dK/dV kernels through the Pallas interpreter, as
``tests/test_flash_attention.py`` runs them. The port's side is the
autograd ``FlashAttention`` (its CPU path: the plain forward, LSE and
backward) and the plain backward called directly. Tolerance: 1e-5 (fp32,
sums in another order), relative to the largest |reference| value.

The bf16 kernels on the card round once more than JAX: the tensor cores
take P in bf16 for dV = P^T dO. A numpy emulation of their roundings
(bf16 inputs, the forward's bf16 output for di, dS and P rounded to bf16
before their products, fp32 sums, bf16 outputs) is held to ``jax.grad``
and to the plain backward in bf16 at ``BF16_RTOL``, the card tests'
tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from emmax_torch.ops import flash_attention as t_flash
from emmax_tpu.ops import flash_attention as j_flash

TOL = 1e-5
BF16_RTOL = 2e-2


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _inputs(seed, B, Lq, S, H, D, pad):
    """q/k/v and the output cotangent from numpy, and the [B, S] mask
    with row 0 left-padded by ``pad`` (None when there is nothing to
    mask); ``pad >= S`` leaves row 0 with no valid key at all."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    do = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    mask = None
    if pad:
        mask = np.ones((B, S), bool)
        mask[0, :pad] = False
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask, causal, q_offset, fused):
    def f(q, k, v):
        out = j_flash.flash_attention(
            q, k, v, kv_mask=None if mask is None else jnp.asarray(mask),
            causal=causal, q_offset=q_offset, fused_bwd=fused)
        return jnp.sum(out * jnp.asarray(do))

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


# (name, B, Lq, S, H, D, causal, q_offset, pad): D 64/72/128 are the
# DINOv2, SigLIP and Llama head dims; lengths are not tile multiples.
CASES = [
    ("bidir_d64", 1, 21, 21, 2, 64, False, 0, 0),
    ("bidir_d72", 2, 16, 16, 2, 72, False, 0, 0),
    ("causal_d128", 1, 19, 19, 2, 128, True, 0, 0),
    ("causal_left_pad_d128", 2, 24, 24, 2, 128, True, 0, 5),
    ("rect_offset_left_pad_d64", 2, 10, 33, 2, 64, True, 7, 3),
    ("fully_masked_row_d72", 2, 12, 12, 2, 72, True, 0, 12),
]


@functools.lru_cache(maxsize=None)
def _case(case, fused):
    """(inputs, JAX grads) of a case, computed once per module."""
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    inputs = _inputs(len(name), B, Lq, S, H, D, pad)
    return inputs, _jax_grads(*inputs, causal, q_offset, fused)


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_autograd_function_matches_jax_grad(case, fused):
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    (q, k, v, do, mask), want = _case(case, fused)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    attn_impl = "cuda_fused" if fused else "cuda"
    from emmax_torch.ops.attention import multi_head_attention

    out = multi_head_attention(
        tq, tk, tv, kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, q_offset=q_offset, impl=attn_impl)
    (out * torch.from_numpy(do)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got.numpy(), ref)
    if pad >= S:   # row 0 sees no key: zero output, zero dq
        assert not out[0].any() and not tq.grad[0].any()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax_grad(case):
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    (q, k, v, do, mask), want = _case(case, False)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(kv_mask=None if mask is None else torch.from_numpy(mask),
              causal=causal, q_offset=q_offset)
    out = t_flash.flash_attention_reference(tq, tk, tv, **kw)
    lse = t_flash.flash_lse_reference(tq, tk, **kw)
    di = (out * tdo).sum(-1)
    got = t_flash.flash_attention_bwd_reference(tq, tk, tv, tdo, lse, di,
                                                **kw)
    for g, ref in zip(got, want):
        _close(g.numpy(), ref)


@pytest.mark.parametrize("causal,q_offset,pad,D", [
    (False, 0, 0, 64), (True, 0, 5, 128), (True, 9, 3, 72),
    (True, 0, 128, 64)])
def test_lse_matches_pallas_save_lse(causal, q_offset, pad, D):
    """``_flash_fwd(..., save_lse=True)`` on tile-aligned inputs (one q
    block of 16 rows, one kv block of 128 keys) against the port's LSE."""
    B, Lq, S, H = 2, 16, 128, 2
    q, k, v, _, mask = _inputs(D + pad, B, Lq, S, H, D, pad)
    kv = None if mask is None else jnp.asarray(
        mask.astype(np.int32)[:, None, :])
    o, lse = j_flash._flash_fwd(
        *(jnp.moveaxis(jnp.asarray(a), 1, 2) for a in (q, k, v)), kv,
        jnp.asarray(q_offset, jnp.int32), causal, D ** -0.5, Lq, S,
        save_lse=True)
    kw = dict(kv_mask=None if mask is None else torch.from_numpy(mask),
              causal=causal, q_offset=q_offset)
    got = t_flash.flash_lse_reference(torch.from_numpy(q),
                                      torch.from_numpy(k), **kw)
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(lse), 1, 2),
                               rtol=TOL, atol=TOL)
    out = t_flash.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    _close(out.numpy(), np.moveaxis(np.asarray(o), 1, 2))


def test_decode_queries_keep_the_plain_path_under_autograd():
    """Fewer than 8 queries never reach the Function (as in JAX): the
    gradient flows through the plain attention's ops."""
    q, k, v, do, mask = _inputs(5, 1, 4, 20, 2, 16, 3)
    tq = torch.from_numpy(q).requires_grad_()
    out = t_flash.flash_attention(tq, torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  kv_mask=torch.from_numpy(mask),
                                  causal=True, q_offset=16)
    assert out.grad_fn is not None
    assert "FlashAttention" not in type(out.grad_fn).__name__
    want = _jax_grads(q, k, v, do, mask, True, 16, False)
    (out * torch.from_numpy(do)).sum().backward()
    _close(tq.grad.numpy(), want[0])


def _bf16(a):
    """fp32 values rounded to bf16 (round to nearest even), kept fp32."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _tensor_core_grads(q, k, v, do, mask, causal):
    """numpy emulation of the bf16 tensor-core backward on bf16 inputs
    [B, L, H, D]: the forward's output rounded to bf16 for ``di``;
    ``p = exp(s - lse)``, exactly 0 where masked; dS rounded to bf16 for
    dQ and dK, P rounded to bf16 for dV; fp32 sums; bf16 outputs."""
    B, L, H, D = q.shape
    scale = np.float32(D ** -0.5)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    vis = np.ones((B, 1, L, L), bool)
    if mask is not None:
        vis &= mask[:, None, None, :]
    if causal:
        vis &= np.tril(np.ones((L, L), bool))
    m = np.where(vis, s, -np.inf).max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    e = np.where(vis, np.exp(s - m), 0.0)
    l = e.sum(-1, keepdims=True)
    lse = m + np.log(np.where(l == 0, 1.0, l))
    p = np.where(vis, np.exp(s - lse), 0.0).astype(np.float32)
    out = _bf16(np.einsum("bhqk,bkhd->bqhd", p, v))
    di = (out * do).sum(-1).transpose(0, 2, 1)[..., None]      # [B, H, L, 1]
    dp = np.einsum("bqhd,bkhd->bhqk", do, v)
    ds = _bf16(p * (dp - di) * scale)
    dq = np.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = np.einsum("bhqk,bqhd->bkhd", ds, q)
    dv = np.einsum("bhqk,bqhd->bkhd", _bf16(p), do)
    return [_bf16(g) for g in (dq, dk, dv)]


@functools.lru_cache(maxsize=None)
def _bf16_case():
    """bf16 inputs at D 128 over 197 causal tokens (row 0 left-padded by
    3 slots, row 1 right-padded by 20) and their emulated gradients."""
    q, k, v, do, _ = _inputs(11, 2, 197, 197, 2, 128, 0)
    q, k, v, do = (_bf16(a) for a in (q, k, v, do))
    mask = np.ones((2, 197), bool)
    mask[0, :3] = False
    mask[1, -20:] = False
    return (q, k, v, do), mask, _tensor_core_grads(q, k, v, do, mask, True)


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
def test_tensor_core_rounding_matches_jax_grad_in_bf16(fused):
    """The kernels' roundings against ``jax.grad`` through the Pallas
    backward (interpret mode) on the same bf16 inputs."""
    (q, k, v, do), mask, emul = _bf16_case()

    def f(q, k, v):
        out = j_flash.flash_attention(q, k, v, kv_mask=jnp.asarray(mask),
                                      causal=True, fused_bwd=fused)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    for got, ref in zip(emul, want):
        _close(got, np.asarray(ref.astype(jnp.float32)), BF16_RTOL)


def test_tensor_core_rounding_matches_plain_backward_in_bf16():
    """The kernels' roundings against the port's plain backward in bf16
    (the version the card tests hold the kernels to)."""
    (q, k, v, do), mask, emul = _bf16_case()
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    kw = dict(kv_mask=torch.from_numpy(mask), causal=True)
    out = t_flash.flash_attention_reference(tq, tk, tv, **kw)
    lse = t_flash.flash_lse_reference(tq, tk, **kw)
    di = (out.float() * tdo.float()).sum(-1)
    got = t_flash.flash_attention_bwd_reference(tq, tk, tv, tdo, lse, di,
                                                **kw)
    for ref, g in zip(emul, got):
        assert g.dtype == torch.bfloat16
        _close(ref, g.float().numpy(), BF16_RTOL)
