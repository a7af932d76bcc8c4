"""The arithmetic of the port's fp32 flash forward on 3xTF32 tensor cores
and of the paged decode split over pages, emulated in numpy on the CPU and
held to ``emmax_tpu`` (the Pallas forward in interpret mode, the paged
engine's ``_gather2_attention``) and to the port's plain versions. The
kernels themselves run only on the card (``tests/test_torch_cuda.py``);
these tests pin what they compute.

3xTF32 forward (``csrc/flash_fwd.cu``, ``tf32::fwd_kernel``): fp32 q/k/v;
every operand x split as big = rna(x), small = rna(x - big), where rna
rounds to nearest (ties away from zero) at 13 dropped mantissa bits (the
tf32 pattern, ``cvt.rna.tf32.f32``); each mma.m16n8k8 adds small*big,
big*small and big*big, in that order, into fp32 (each MMA emulated as
exact products summed in fp64 and rounded once to fp32); S = q k^T per
k-step of 8 dims; stages of 64 keys, each split into two halves of 32
keys with their own online softmax (exp2 with log2(e) folded into the
scale, masked p exactly 0), the second half's state merged into the
first's at the end; O += P V per 8 keys with P's C fragment used as the
A fragment, so V's rows are read in the permuted key order (k index t <->
key 2t, t + 4 <-> key 2t + 1); P stays fp32; the LSE ``m * scale +
log(l)``, or the sentinel for a row with no valid key. Tolerance against
JAX and the plain version: ``FP32_RTOL`` (1e-4) relative to the largest
|reference|, the card tests' fp32 tolerance; the LSE at 1e-5. Measured:
the 3xTF32 emulation is within 1.1e-6 of both; a 1xTF32 emulation (one
product of the rounded operands) on the same inputs is 3.6e-4 to 5.6e-4
off, over the tolerance in every case with a row that sees a key, which
is why the kernel takes three products.

Split-and-merge paged decode (``csrc/paged_attention.cu``): each row's
page table is cut into ``splits(MP, ps)`` ranges of ``max(1, 128 // ps)``
pages, fixed by the shapes; each range gives an fp32 partial (max m, sum
l, accumulator) over its tokens below the row's length (an empty range
gives m = -inf, l = 0); the partials are merged in range order with the
weight 0 for an empty one; int8 pages scale the score by the K row's
scale / 127.5 and the probability by the V row's. Held to
``_gather2_attention`` and to the plain version within 1e-5 of the
largest |reference| in fp32 (the summation order differs).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.ops import flash_attention as t_flash
from emmax_torch.ops import paged_attention as t_pa
from emmax_tpu.ops import flash_attention as j_flash
from emmax_tpu.serving import paged as j_paged

FP32_RTOL = 1e-4
NEG_INF = np.float32(-2.3819763e38)   # the masking sentinel of both
STAGE, HALF = 64, 32                  # keys per stage and per warp pair
PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])   # k index -> key of 8


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------- 3xTF32 ---

def _rna(x):
    """fp32 -> tf32 (cvt.rna.tf32.f32): the 13 low mantissa bits rounded
    off, ties away from zero; kept as fp32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _split(x):
    big = _rna(x)
    return big, _rna(np.asarray(x, np.float32) - big)


def _mma(c, a, b):
    """c + a @ b with exact products summed in fp64, rounded to fp32."""
    return (c.astype(np.float64) + np.matmul(a.astype(np.float64),
                                             b.astype(np.float64))
            ).astype(np.float32)


def _products(c, a, b, three):
    """small*big + big*small + big*big in that order (three) or one
    product of the rounded operands."""
    if not three:
        return _mma(c, _rna(a), _rna(b))
    (ab, asm), (bb, bs) = _split(a), _split(b)
    return _mma(_mma(_mma(c, asm, bb), ab, bs), ab, bb)


def _tf32_forward(q, k, v, mask, causal, q_offset, scale, three=True):
    """numpy emulation of ``tf32::fwd_kernel`` on fp32 [B, L, H, D]:
    returns (out [B, Lq, H, D], lse [B, Lq, H])."""
    B, Lq, H, D = q.shape
    S = k.shape[1]
    DP = 64 if D <= 64 else 72 if D <= 72 else 128
    n_st = -(-S // STAGE)

    def heads(a, n):           # [B, n, H, D] -> zero-padded [B, H, n, DP]
        out = np.zeros((B, H, n, DP), np.float32)
        out[:, :, :a.shape[1], :D] = np.moveaxis(a, 1, 2)
        return out

    qh, kh, vh = heads(q, Lq), heads(k, n_st * STAGE), heads(v, n_st * STAGE)
    key = np.arange(n_st * STAGE)
    vis = np.broadcast_to(key < S, (B, Lq, n_st * STAGE)).copy()
    if mask is not None:
        vis[:, :, :S] &= mask[:, None, :]
    if causal:
        vis &= key[None, None] <= q_offset + np.arange(Lq)[None, :, None]
    vis = vis[:, None]                                   # [B, 1, Lq, keys]
    scale2 = np.float32(scale * np.log2(np.e))
    m = np.full((2, B, H, Lq, 1), -np.inf, np.float32)
    l = np.zeros((2, B, H, Lq, 1), np.float32)
    acc = np.zeros((2, B, H, Lq, DP), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for st in range(n_st):
            keys = slice(st * STAGE, (st + 1) * STAGE)
            s = np.zeros((B, H, Lq, STAGE), np.float32)
            for kk in range(DP // 8):
                d = slice(8 * kk, 8 * kk + 8)
                s = _products(s, qh[..., d],
                              np.swapaxes(kh[:, :, keys, d], 2, 3), three)
            s = np.where(vis[..., keys], s, -np.inf).astype(np.float32)
            for hf in range(2):
                sh = s[..., hf * HALF:(hf + 1) * HALF]
                m_new = np.maximum(m[hf], sh.max(-1, keepdims=True))
                dead = np.isneginf(m_new)
                mu = np.where(dead, 0, m_new * scale2).astype(np.float32)
                alpha = np.where(dead, 0, np.exp2((m[hf] - m_new) * scale2))
                p = np.exp2((sh.astype(np.float64) * scale2 - mu)
                            .astype(np.float32))              # masked: 0
                l[hf] = (alpha * l[hf] + p.sum(-1, keepdims=True)).astype(
                    np.float32)
                acc[hf] = (acc[hf] * alpha).astype(np.float32)
                m[hf] = m_new
                k0 = st * STAGE + hf * HALF
                for n in range(HALF // 8):
                    ks = k0 + 8 * n + PERM          # k index -> key row
                    acc[hf] = _products(acc[hf], p[..., 8 * n + PERM],
                                        vh[:, :, ks], three)
        mn = np.maximum(m[0], m[1])
        c = [np.where(np.isneginf(m[i]), 0, np.exp2((m[i] - mn) * scale2))
             for i in range(2)]
        lt = (l[0] * c[0] + l[1] * c[1]).astype(np.float32)
        at = (acc[0] * c[0] + acc[1] * c[1]).astype(np.float32)
    live = lt > 0
    out = np.where(live, at / np.where(live, lt, 1), 0).astype(np.float32)
    lse = np.where(live, mn * np.float32(scale)
                   + np.log(np.where(live, lt, 1)), NEG_INF).astype(np.float32)
    return (np.moveaxis(out[..., :D], 1, 2).copy(),
            np.moveaxis(lse[..., 0], 1, 2).copy())


# (name, B, Lq, S, H, D, causal, q_offset, left pad of row 0): D 64 and 72,
# lengths that are not multiples of the 32-row tile or the 64-key stage,
# a slot mask, a rectangular causal offset, left-padded (pad) rows, and a
# row with no valid key
TF32_CASES = [
    ("bidir_d64", 1, 70, 70, 2, 64, False, 0, 0),
    ("bidir_d72_mask", 2, 45, 130, 2, 72, False, 0, 9),
    ("causal_offset_d72", 2, 33, 100, 2, 72, True, 60, 5),
    ("causal_left_pad_d64", 2, 50, 50, 2, 64, True, 0, 13),
    ("row0_no_key_d72", 2, 24, 24, 1, 72, True, 0, 24),
]


@functools.lru_cache(maxsize=None)
def _tf32_case(case, three=True):
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    rng = np.random.default_rng(len(name) + D)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, Lq, H, D), (B, S, H, D), (B, S, H, D)))
    mask = None
    if pad:
        mask = np.ones((B, S), bool)
        mask[0, :pad] = False
    out, lse = _tf32_forward(q, k, v, mask, causal, q_offset, D ** -0.5,
                             three)
    return (q, k, v, mask), out, lse


def _torch_kw(mask, causal, q_offset):
    return dict(kv_mask=None if mask is None else torch.from_numpy(mask),
                causal=causal, q_offset=q_offset)


@pytest.mark.parametrize("case", TF32_CASES, ids=[c[0] for c in TF32_CASES])
def test_3xtf32_forward_matches_pallas(case):
    """The emulated kernel against ``flash_attention`` through the Pallas
    forward (interpret mode) on the same fp32 inputs; rows with no valid
    key are exact zeros in both."""
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    (q, k, v, mask), out, _ = _tf32_case(case)
    want = np.asarray(j_flash.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        kv_mask=None if mask is None else jnp.asarray(mask), causal=causal,
        q_offset=q_offset))
    assert _rel(out, want) <= FP32_RTOL
    dead = ~np.any(want != 0, axis=(2, 3))
    assert not out[dead].any()
    if pad >= S:
        assert dead[0].all() and not out[0].any()


@pytest.mark.parametrize("case", TF32_CASES, ids=[c[0] for c in TF32_CASES])
def test_3xtf32_forward_matches_plain(case):
    """The emulated kernel against the port's plain forward and LSE in
    fp32 (the versions the card tests hold the kernel to); the LSE of a
    row with no valid key is the sentinel bit for bit."""
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    (q, k, v, mask), out, lse = _tf32_case(case)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = _torch_kw(mask, causal, q_offset)
    plain = t_flash.flash_attention_reference(tq, tk, tv, **kw)
    assert _rel(out, plain.numpy()) <= FP32_RTOL
    want_lse = t_flash.flash_lse_reference(tq, tk, **kw).numpy()
    live = want_lse > -1e30
    np.testing.assert_array_equal(lse[~live], want_lse[~live])
    np.testing.assert_allclose(lse[live], want_lse[live], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", TF32_CASES, ids=[c[0] for c in TF32_CASES])
def test_one_tf32_product_misses_the_fp32_tolerance(case):
    """One TF32 product of the rounded operands, on the same inputs and in
    the same tile order, is off by more than ``FP32_RTOL`` wherever a row
    sees a key; the three products are within it."""
    name, B, Lq, S, H, D, causal, q_offset, pad = case
    (q, k, v, mask), out3, _ = _tf32_case(case)
    _, out1, _ = _tf32_case(case, three=False)
    plain = t_flash.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        **_torch_kw(mask, causal, q_offset)).numpy()
    assert _rel(out3, plain) <= FP32_RTOL < _rel(out1, plain)


@pytest.mark.parametrize("D", [64, 72])
@pytest.mark.parametrize("causal,pad", [(False, 0), (True, 5), (True, 128)])
def test_3xtf32_lse_matches_pallas_save_lse(D, causal, pad):
    """The emulated LSE against ``_flash_fwd(..., save_lse=True)`` on
    tile-aligned fp32 inputs (one q block of 16 rows, 128 keys: two of the
    kernel's 64-key stages); ``pad`` 128 leaves row 0 no key."""
    B, Lq, S, H = 2, 16, 128, 2
    rng = np.random.default_rng(D + pad)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, Lq, H, D), (B, S, H, D), (B, S, H, D)))
    mask = np.ones((B, S), bool)
    mask[0, :pad] = False
    _, lse = _tf32_forward(q, k, v, mask, causal, 0, D ** -0.5)
    _, want = j_flash._flash_fwd(
        *(jnp.moveaxis(jnp.asarray(a), 1, 2) for a in (q, k, v)),
        jnp.asarray(mask.astype(np.int32)[:, None, :]),
        jnp.asarray(0, jnp.int32), causal, D ** -0.5, Lq, S, save_lse=True)
    want = np.moveaxis(np.asarray(want), 1, 2)
    live = want > -1e30
    np.testing.assert_array_equal(lse[~live], want[~live])
    np.testing.assert_allclose(lse[live], want[live], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- paged decode ---

def _split_paged(q, k_pages, v_pages, lengths, table, k_scale=None,
                 v_scale=None):
    """numpy emulation of the split-and-merge paged decode on fp32 q
    [B, H, hd] (already scaled) and pages [KV, P, ps, hd] (fp32, or int8
    with [KV, P, ps, 1] scales). Only the page ids of tokens below a row's
    length are read."""
    B, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    G = H // KV
    MP = table.shape[1]
    pps = t_pa.split_pages(ps)
    n_split = t_pa.splits(MP, ps)
    assert pps == max(1, 128 // ps) and n_split == -(-MP // pps)
    out = np.zeros((B, H, hd), np.float32)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), MP * ps)
        for h in range(H):
            kv = h // G
            parts = []
            for sp in range(n_split):
                t = np.arange(sp * pps * ps, min(n, (sp + 1) * pps * ps))
                if not len(t):
                    parts.append((-np.inf, 0.0, np.zeros(hd)))
                    continue
                ids = np.clip(table[b, t // ps], 0, P - 1)
                kr = k_pages[kv, ids, t % ps].astype(np.float64)
                vr = v_pages[kv, ids, t % ps].astype(np.float64)
                s = kr @ q[b, h].astype(np.float64)
                pv = np.ones(len(t))
                if k_scale is not None:
                    s *= k_scale[kv, ids, t % ps, 0] / 127.5
                    pv = v_scale[kv, ids, t % ps, 0] / 127.5
                m = s.max()
                p = np.exp(s - m)
                parts.append((m, p.sum(), (p * pv) @ vr))
            mx = max(pm for pm, _, _ in parts)
            w = [0.0 if np.isneginf(pm) else np.exp(pm - mx)
                 for pm, _, _ in parts]
            den = sum(pl * c for (_, pl, _), c in zip(parts, w))
            num = sum(pa * c for (_, _, pa), c in zip(parts, w))
            out[b, h] = num / den if den > 0 else 0.0
    return out


# (name, KV, G, hd, page size, pages per row, lengths): several ranges per
# row (16-token pages: 8 a range; 128-token pages: one), ranges and whole
# pages past a row's length, a row of length 0, GQA with G = 4
PAGED_CASES = [
    ("mha_ps16", 2, 1, 32, 16, 12, (0, 1, 127, 128, 129, 192)),
    ("gqa4_ps16", 2, 4, 32, 16, 12, (0, 1, 127, 128, 129, 192)),
    ("ps128", 1, 2, 64, 128, 3, (0, 1, 127, 128, 129, 384)),
]


@functools.lru_cache(maxsize=None)
def _paged_case(case, quantized):
    name, KV, G, hd, ps, MP, lens = case
    B = len(lens)
    P = B * MP + 3
    rng = np.random.default_rng(len(name) + 7 * quantized)
    q = rng.standard_normal((B, KV * G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((KV, P, ps, hd)).astype(np.float32)
            for _ in range(2))
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = (tuple(np.array(x) for x in
                                  j_paged._row_quantize(jnp.asarray(a)))
                            for a in (k, v))
    table = rng.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32)
    lengths = np.array(lens, np.int32)
    return q, k, v, ks, vs, table, lengths


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_split_merge_paged_matches_gather2(case, quantized):
    """The emulation against ``_gather2_attention`` (which scales q itself
    and dequantizes int8 rows first) on the rows of nonzero length."""
    q, k, v, ks, vs, table, lengths = _paged_case(case, quantized)
    hd = q.shape[-1]
    got = _split_paged(q * hd ** -0.5, k, v, lengths, table, ks, vs)
    want = np.asarray(j_paged._gather2_attention(
        jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), jnp.asarray(table),
        jnp.asarray(lengths), page_size=k.shape[2]))[:, 0]
    live = lengths > 0
    assert _rel(got[live], want[live]) <= 1e-5


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_split_merge_paged_matches_plain(case, quantized):
    """The emulation against the port's plain paged attention, with the
    table entries past each row's length replaced by ids out of range
    (never read by the kernel, clamped by the plain version); a row of
    length 0 gives exact zeros."""
    q, k, v, ks, vs, table, lengths = _paged_case(case, quantized)
    ps = k.shape[2]
    junk = table.copy()
    for b, n in enumerate(lengths):
        junk[b, -(-int(n) // ps):] = -5 if b % 2 else 10 ** 6
    q = q * q.shape[-1] ** -0.5
    got = _split_paged(q, k, v, lengths, junk, ks, vs)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    want = t_pa.paged_attention_reference(
        t(q), t(k), t(v), t(lengths), t(table), k_scale=t(ks),
        v_scale=t(vs)).numpy()
    assert _rel(got, want) <= 1e-5
    assert not got[lengths == 0].any()


@pytest.mark.parametrize("MP,ps,n", [(6, 128, 6), (12, 16, 2), (24, 16, 3),
                                     (4, 5, 1), (3, 256, 3), (1, 64, 1)])
def test_split_count_depends_on_the_shapes_only(MP, ps, n):
    """``splits``: ranges of ``split_pages(ps)`` = max(1, 128 // ps)
    pages over MP pages, the count the C entry point checks; no length
    enters it."""
    assert t_pa.splits(MP, ps) == n
