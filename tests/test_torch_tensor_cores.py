"""The roundings of the port's bf16 tensor-core kernels, emulated in numpy
on the CPU and held to ``emmax_tpu``'s Pallas kernels (interpret mode) and
to the port's plain versions. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``); these tests pin what they compute.

Flash forward (``csrc/flash_fwd.cu``, ``tc::fwd_kernel``): bf16 q/k/v;
S = q k^T in fp32 over tiles of 64 keys; the online softmax with the
running max (exp2 with log2(e) folded into the scale, masked p exactly 0);
P rounded to bf16 before P V, as JAX's ``p.astype(v.dtype)``; l summed
over the fp32 p; fp32 accumulators; the output rounded to bf16; the LSE
``m * scale + log(l)``, or the sentinel for a row with no valid key.
Tolerance against JAX and the plain version: ``BF16_RTOL`` (2e-2) relative
to the largest |reference|, the card tests' tolerance (measured: at most
2.5e-3 against JAX and 5.6e-3 against the plain version); the LSE at 1e-5.

int4 matmul (``csrc/int4_matmul.cu``, ``tc::int4_tc_kernel``): bf16 x;
each nibble's exact level q + 0.5; per group fp32 sums per nibble plane,
scaled per column, added in fp32; the output rounded to bf16. JAX's
stacked kernel rounds its fp32 total to bf16 once, so it is held to the
emulation's fp32 total within one bf16 rounding of the output: 2^-8
relative, plus 1e-6 of the largest value for fp32 sums in another order.
The plain version (which rounds the dequantized weight to bf16 first) is
held at ``BF16_RTOL`` (measured: at most 7.1e-3).
"""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.ops import flash_attention as t_flash
from emmax_torch.ops import int4_matmul as t4
from emmax_tpu.ops import flash_attention as j_flash
from emmax_tpu.ops import int4_matmul as j4

BF16_RTOL = 2e-2
NEG_INF = np.float32(-2.3819763e38)   # the masking sentinel of both
KV_TILE = 64                          # keys per stage of tc::fwd_kernel


def _bf16(a):
    """fp32 values rounded to bf16 (round to nearest even), kept fp32."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------ flash fwd --

def _tc_forward(q, k, v, mask, causal, q_offset, scale):
    """numpy emulation of ``tc::fwd_kernel`` on bf16-valued fp32 inputs
    [B, L, H, D]: returns (bf16-valued out [B, Lq, H, D], lse [B, Lq, H])."""
    B, Lq, H, D = q.shape
    S = k.shape[1]
    scale2 = np.float32(scale * np.log2(np.e))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)).astype(np.float32)
    vis = np.ones((B, 1, Lq, S), bool)
    if mask is not None:
        vis &= mask[:, None, None, :]
    if causal:
        vis &= (np.arange(S)[None, :]
                <= q_offset + np.arange(Lq)[:, None])[None, None]
    s = np.where(vis, s, -np.inf).astype(np.float32)
    m = np.full((B, H, Lq, 1), -np.inf, np.float32)
    l = np.zeros((B, H, Lq, 1), np.float32)
    acc = np.zeros((B, H, Lq, D), np.float32)
    vt = np.moveaxis(v, 1, 2).astype(np.float64)          # [B, H, S, D]
    with np.errstate(invalid="ignore", over="ignore"):
        for k0 in range(0, S, KV_TILE):
            st = s[..., k0:k0 + KV_TILE]
            m_new = np.maximum(m, st.max(-1, keepdims=True))
            dead = np.isneginf(m_new)
            mu = np.where(dead, 0, m_new * scale2).astype(np.float32)
            alpha = np.where(dead, 0, np.exp2((m - m_new) * scale2))
            p = np.exp2(st * scale2 - mu).astype(np.float32)   # masked: 0
            l = (alpha * l + p.sum(-1, keepdims=True)).astype(np.float32)
            pv = np.einsum("bhqk,bhkd->bhqd", _bf16(p).astype(np.float64),
                           vt[:, :, k0:k0 + KV_TILE])
            acc = (acc * alpha + pv).astype(np.float32)
            m = m_new
    live = l > 0
    out = np.where(live, acc / np.where(live, l, 1), 0).astype(np.float32)
    lse = np.where(live, m * np.float32(scale) + np.log(np.where(live, l, 1)),
                   NEG_INF).astype(np.float32)
    return (_bf16(np.moveaxis(out, 1, 2)),
            np.moveaxis(lse[..., 0], 1, 2).copy())


# (name, B, Lq, S, H, D, causal, q_offset, left pad of row 0): more keys
# than one 64-key tile, D 64 / 72 / 128, a rectangular causal offset, a
# row with no valid key
FWD_CASES = [
    ("bidir_d64", 1, 70, 70, 2, 64, False, 0, 0),
    ("bidir_d72", 2, 40, 130, 2, 72, False, 0, 9),
    ("causal_left_pad_d128", 2, 97, 97, 2, 128, True, 0, 13),
    ("rect_offset_d128", 2, 33, 160, 2, 128, True, 100, 5),
    ("row0_no_key_d64", 2, 24, 24, 2, 64, True, 0, 24),
]


@functools.lru_cache(maxsize=None)
def _fwd_case(case):
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    rng = np.random.default_rng(len(name) + D)
    q, k, v = (_bf16(rng.standard_normal(shape)) for shape in
               ((B, Lq, H, D), (B, S, H, D), (B, S, H, D)))
    mask = None
    if pad:
        mask = np.ones((B, S), bool)
        mask[0, :pad] = False
    out, lse = _tc_forward(q, k, v, mask, causal, q_offset, D ** -0.5)
    return (q, k, v, mask), out, lse


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_tensor_core_forward_rounding_matches_pallas(case):
    """The emulated kernel against ``flash_attention`` through the Pallas
    forward (interpret mode) on the same bf16 inputs; rows with no valid
    key are exact zeros in both."""
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    (q, k, v, mask), out, _ = _fwd_case(case)
    want = np.asarray(j_flash.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        kv_mask=None if mask is None else jnp.asarray(mask), causal=causal,
        q_offset=q_offset).astype(jnp.float32))
    assert _rel(out, want) <= BF16_RTOL
    dead = ~np.any(want != 0, axis=(2, 3))
    assert not out[dead].any()
    if pad >= S:
        assert dead[0].all() and not out[0].any()


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_tensor_core_forward_rounding_matches_plain_bf16(case):
    """The emulated kernel against the port's plain forward and LSE in
    bf16 (the versions the card tests hold the kernel to); the LSE of a
    row with no valid key is the sentinel bit for bit."""
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    (q, k, v, mask), out, lse = _fwd_case(case)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    kw = dict(kv_mask=None if mask is None else torch.from_numpy(mask),
              causal=causal, q_offset=q_offset)
    plain = t_flash.flash_attention_reference(tq, tk, tv, **kw)
    assert plain.dtype == torch.bfloat16
    assert _rel(out, plain.float().numpy()) <= BF16_RTOL
    want_lse = t_flash.flash_lse_reference(tq, tk, **kw).numpy()
    live = want_lse > -1e30
    np.testing.assert_array_equal(lse[~live], want_lse[~live])
    assert (lse[~live] == NEG_INF).all()
    np.testing.assert_allclose(lse[live], want_lse[live], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,q_offset,pad", [(False, 0, 0),
                                                 (True, 0, 5),
                                                 (True, 0, 128)])
def test_tensor_core_lse_matches_pallas_save_lse(causal, q_offset, pad):
    """The emulated LSE against ``_flash_fwd(..., save_lse=True)`` on
    tile-aligned bf16 inputs (one q block of 16 rows, 128 keys: two of
    the kernel's 64-key tiles); ``pad`` 128 leaves row 0 no key."""
    B, Lq, S, H, D = 2, 16, 128, 2, 128
    rng = np.random.default_rng(pad + 1)
    q, k, v = (_bf16(rng.standard_normal(shape)) for shape in
               ((B, Lq, H, D), (B, S, H, D), (B, S, H, D)))
    mask = np.ones((B, S), bool)
    mask[0, :pad] = False
    _, lse = _tc_forward(q, k, v, mask, causal, q_offset, D ** -0.5)
    _, want = j_flash._flash_fwd(
        *(jnp.moveaxis(jnp.asarray(a, jnp.bfloat16), 1, 2)
          for a in (q, k, v)),
        jnp.asarray(mask.astype(np.int32)[:, None, :]),
        jnp.asarray(q_offset, jnp.int32), causal, D ** -0.5, Lq, S,
        save_lse=True)
    want = np.moveaxis(np.asarray(want), 1, 2)
    live = want > -1e30
    np.testing.assert_array_equal(lse[~live], want[~live])
    np.testing.assert_allclose(lse[live], want[live], rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- int4 --

def _tc_int4(x, q4, scale):
    """numpy emulation of ``tc::int4_tc_kernel``: bf16-valued x [M, D],
    q4 [D/2, F] int8, scale [G, F] (float). Returns the fp32 total before
    the output's bf16 rounding."""
    b = q4.astype(np.int32)
    lo = ((b & 15) - 8).astype(np.float64) + 0.5           # exact levels
    hi = (b >> 4).astype(np.float64) + 0.5
    G, F = scale.shape
    gh, d2 = G // 2, q4.shape[0]
    group = d2 // gh
    xd = x.astype(np.float64)
    s = scale.astype(np.float64)
    tot = np.zeros((x.shape[0], F), np.float32)
    for g in range(gh):
        r = slice(g * group, (g + 1) * group)
        a_lo = (xd[:, r] @ lo[r]).astype(np.float32)        # fp32 sums
        a_hi = (xd[:, d2:][:, r] @ hi[r]).astype(np.float32)
        tot = (tot + a_lo * s[g] + a_hi * s[gh + g]).astype(np.float32)
    return tot


# (M, D, F, group): M 1 / 6 / 48 / 130 as decode, the batched engines,
# the tree verify and prefill give it; F ragged against the kernel's
# column tiles; groups of 128 and 32
INT4_CASES = [(1, 256, 200, 128), (6, 256, 200, 128), (48, 128, 72, 32),
              (130, 256, 200, 128)]


@functools.lru_cache(maxsize=None)
def _int4_case(case):
    M, D, F, group = case
    rng = np.random.default_rng(M + D)
    w = (rng.standard_normal((3, D, F)) * 0.02).astype(np.float32)
    q = j4.quantize_weight_int4_np(w, group=group)
    x = _bf16(rng.standard_normal((M, D)))
    layer = 2
    scale = np.asarray(q["scale"]).astype(np.float32)[layer]
    return q, x, layer, _tc_int4(x, q["q4"][layer], scale)


@pytest.mark.parametrize("case", INT4_CASES, ids=[str(c) for c in INT4_CASES])
def test_tensor_core_int4_rounding_matches_pallas(case):
    """The emulated kernel's fp32 total against the stacked Pallas kernel
    (interpret mode) on bf16 x: within one bf16 rounding of the output."""
    q, x, layer, tot = _int4_case(case)
    want = np.asarray(j4._int4_matmul_pallas_stacked(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(q["q4"]),
        jnp.asarray(q["scale"]), jnp.int32(layer),
        interpret=True).astype(jnp.float32))
    slack = 2.0 ** -8 * np.abs(tot) + 1e-6 * np.abs(tot).max()
    assert np.all(np.abs(want - tot) <= slack)
    # the kernel's own output is that total rounded once to bf16
    assert _rel(_bf16(tot), want) <= 2.0 ** -7


@pytest.mark.parametrize("case", INT4_CASES, ids=[str(c) for c in INT4_CASES])
def test_tensor_core_int4_rounding_matches_plain_bf16(case):
    """The emulated kernel against the port's plain version in bf16 (the
    version the card tests hold the kernel to)."""
    q, x, layer, tot = _int4_case(case)
    tq = params_from_numpy(q)
    plain = t4.int4_matmul_reference(torch.from_numpy(x).to(torch.bfloat16),
                                     tq["q4"][layer], tq["scale"][layer])
    assert plain.dtype == torch.bfloat16
    assert _rel(_bf16(tot), plain.float().numpy()) <= BF16_RTOL


LAUNCH = [(1, 4096, 16), (1, 32064, 16), (6, 11008, 16), (1, 4096, 43),
          (48, 11008, 16), (448, 32064, 16), (3, 64, 1)]
# the TF32 kernel's (fp32 x) cases: Emma-X's weights at M 1 / 13 / 43 /
# 448, D 11008's 43 groups a plane, a narrow F
LAUNCH_TF32 = [(1, 4096, 16), (1, 32064, 16), (1, 4096, 43),
               (13, 11008, 16), (43, 4096, 43), (448, 32064, 16),
               (448, 4096, 16), (3, 64, 1)]


@pytest.mark.parametrize(
    "M,F,g_half,tf32",
    [c + (False,) for c in LAUNCH] + [c + (True,) for c in LAUNCH_TF32],
    ids=["-".join(map(str, c)) for c in LAUNCH]
    + ["tf32-" + "-".join(map(str, c)) for c in LAUNCH_TF32])
def test_tensor_core_launch_shape_covers_every_group(M, F, g_half, tf32):
    """The tensor-core kernels' split-K: rows of x per warp (bf16) or
    block (TF32) 8 (M <= 8) or 32, every group in one split, no split
    empty."""
    mt, gps, splits = t4._launch_shape(M, F, g_half, sm_count=132,
                                       tensor_cores=True, tf32=tf32)
    assert mt == (8 if M <= 8 else 32)
    assert gps * splits >= g_half and gps * (splits - 1) < g_half
