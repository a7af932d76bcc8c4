"""The arithmetic of the port's fp32 flash backward on 3xTF32 tensor cores
(``csrc/flash_bwd.cu``, ``tf32::dq_kernel`` and ``tf32::dkv_kernel``),
emulated in torch on the CPU and held to ``emmax_tpu``'s ``jax.grad``
through the Pallas backward (interpret mode) and to the port's plain
backward. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``); these tests pin what they compute.

What is emulated: fp32 q/k/v/do with D zero-padded to 64, 72 or 128;
every operand x split as big = rna(x), small = rna(x - big), rna being
round to nearest (ties away from zero) at 13 dropped mantissa bits
(``cvt.rna.tf32.f32``); each mma.m16n8k8 adds small*big, big*small and
big*big, in that order, into fp32 (each MMA as exact products summed in
fp64 and rounded once). dQ kernel: S = Q K^T and dP = dO V^T per k-step
of 8 dims; P = exp2(s * scale * log2(e) - lse * log2(e)), exactly 0 where
masked; dS = P (dP - di) scale; dQ += dS K per 8 keys with dS's C
fragment used as the A fragment, so K's rows are read in the permuted
order (k index t <-> key 2t, t + 4 <-> key 2t + 1); stages of 32 keys,
the first 16 keys of each stage summed into one accumulator and the
other 16 into a second, the two added at the end. dK/dV kernel: S^T =
K Q^T and dP^T = V dO^T, P^T and dS^T, then dV += P^T dO and dK += dS^T Q
per 8 queries (dO's and Q's rows permuted the same way); at D <= 72 the
separate kernel gives each 16 keys two warps, which take alternate
8-query chunks into two accumulators added at the end, while D 128 and
the fused variant sum every chunk into one; the fused variant's dQ
partial of each 64-key tile is dS K over that tile's keys, 8 keys an MMA,
and the partials are summed in fp32.

Tolerance: 1e-5 relative to the largest |reference| (fp32, sums in
another order). Negative control: one TF32 product of the rounded
operands, on the same inputs and tile walk, is off by more than
``FP32_RTOL`` = 1e-4 (the card tests' fp32 tolerance), which is why the
kernels take three.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.ops import flash_attention as t_flash
from emmax_tpu.ops import flash_attention as j_flash

TOL = 1e-5
FP32_RTOL = 1e-4
LOG2E = 1.4426950408889634
KV_TILE = 64                           # keys per dK/dV block
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])   # k index -> row of 8


def _rel(got, want):
    got, want = (torch.as_tensor(np.array(a)).double() for a in (got, want))
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _rna(x):
    """fp32 -> tf32 (cvt.rna.tf32.f32): the 13 low mantissa bits rounded
    off, ties away from zero; kept as fp32."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    big = _rna(x)
    return big, _rna(x - big)


def _mma(c, a, b):
    """c + a @ b with exact products summed in fp64, rounded to fp32."""
    return (c.double() + a.double() @ b.double()).float()


def _products(c, a, b, three):
    """small*big + big*small + big*big in that order (three) or one
    product of the rounded operands."""
    if not three:
        return _mma(c, _rna(a), _rna(b))
    (ab, asm), (bb, bs) = _split(a), _split(b)
    return _mma(_mma(_mma(c, asm, bb), ab, bs), ab, bb)


def _tf32_backward(q, k, v, do, lse, di, mask, causal, q_offset, scale,
                   three=True):
    """torch emulation of the two kernels on fp32 [B, L, H, D] (``lse``,
    ``di`` [B, Lq, H]): returns (dq, dk, dv) of the separate kernels and
    (dq from the partials, dk, dv) of the fused one."""
    B, Lq, H, D = q.shape
    S = k.shape[1]
    DP = 64 if D <= 64 else 72 if D <= 72 else 128
    KW = 16                           # dQ keys per warp and stage
    Lp = -(-Lq // 32) * 32            # query rows in tiles of 32
    Sp = -(-S // KV_TILE) * KV_TILE

    def heads(a, n):           # [B, L, H, D] -> zero-padded [B, H, n, DP]
        out = torch.zeros(B, H, n, DP)
        out[:, :, :a.shape[1], :D] = a.permute(0, 2, 1, 3)
        return out

    qh, oh, kh, vh = heads(q, Lp), heads(do, Lp), heads(k, Sp), heads(v, Sp)
    qi, kj = torch.arange(Lp)[:, None], torch.arange(Sp)[None, :]
    vis = ((qi < Lq) & (kj < S)).expand(B, 1, Lp, Sp).clone()
    if mask is not None:
        vis[..., :S] &= mask[:, None, None, :]
    if causal:
        vis &= kj <= q_offset + qi
    rows = torch.zeros(2, B, H, Lp, 1)
    rows[0, :, :, :Lq, 0] = lse.permute(0, 2, 1) * np.float32(LOG2E)
    rows[1, :, :, :Lq, 0] = di.permute(0, 2, 1)
    lse2, dif = rows
    scale2 = torch.tensor(scale, dtype=torch.float32) * np.float32(LOG2E)
    sc = torch.tensor(scale, dtype=torch.float32)

    def grad_s(s, dp, lse2, dif, vis):   # -> (P, dS), masked P exactly 0
        e = (s.double() * scale2.double() - lse2.double()).float()
        p = torch.where(vis, torch.exp2(e), 0.0)
        return p, p * (dp - dif) * sc

    def products_over_d(a, b):       # a [.., m, DP] b [.., n, DP] -> m x n
        c = torch.zeros(*a.shape[:-1], b.shape[-2])
        for kk in range(DP // 8):
            d = slice(8 * kk, 8 * kk + 8)
            c = _products(c, a[..., d], b[..., d].transpose(-1, -2), three)
        return c

    # dQ kernel: A = Q / dO rows, B = K / V rows
    _, ds = grad_s(products_over_d(qh, kh), products_over_d(oh, vh), lse2,
                   dif, vis)
    acc = torch.zeros(2, B, H, Lp, DP)
    for st in range(Sp // (2 * KW)):
        for half in range(2):
            for n in range(KW // 8):
                keys = st * 2 * KW + half * KW + 8 * n + PERM
                acc[half] = _products(acc[half], ds[..., keys],
                                      kh[:, :, keys], three)
    dq = acc[0] + acc[1]

    # dK/dV kernel: A = K / V rows, B = Q / dO rows, transposed scores
    visT = vis.transpose(-1, -2)
    pT, dsT = grad_s(products_over_d(kh, qh), products_over_d(vh, oh),
                     lse2.transpose(-1, -2), dif.transpose(-1, -2), visT)
    def dkv(halves):           # 8-query chunks alternating over `halves`
        dk = torch.zeros(halves, B, H, Sp, DP)
        dv = torch.zeros(halves, B, H, Sp, DP)
        for n in range(Lp // 8):
            qs, w = 8 * n + PERM, n % halves
            dv[w] = _products(dv[w], pT[..., qs], oh[:, :, qs], three)
            dk[w] = _products(dk[w], dsT[..., qs], qh[:, :, qs], three)
        return (dk[0] + dk[1], dv[0] + dv[1]) if halves == 2 else (dk[0],
                                                                    dv[0])

    dk, dv = dkv(2 if DP <= 72 else 1)
    dk_fused, dv_fused = dkv(1)
    ds_fused = dsT.transpose(-1, -2)
    parts = []
    for j in range(Sp // KV_TILE):
        part = torch.zeros(B, H, Lp, DP)
        for kk in range(KV_TILE // 8):
            keys = j * KV_TILE + 8 * kk + PERM
            part = _products(part, ds_fused[..., keys], kh[:, :, keys], three)
        parts.append(part)
    dq_fused = torch.stack(parts).sum(dim=0)

    def back(a, n):            # [B, H, n', DP] -> [B, n, H, D]
        return a[:, :, :n, :D].permute(0, 2, 1, 3).contiguous()

    return ((back(dq, Lq), back(dk, S), back(dv, S)),
            (back(dq_fused, Lq), back(dk_fused, S), back(dv_fused, S)))


# (name, B, Lq, S, H, D, causal, q_offset, left pad of row 0, right pad of
# the last row): the DINOv2, SigLIP and Llama head dims; lengths that are
# not tile multiples (two dQ stages and two kv tiles at 70); a rectangular
# causal offset; a batch row with no valid key at all
CASES = [
    ("bidir_d64", 1, 70, 70, 1, 64, False, 0, 0, 0),
    ("bidir_right_pad_d72", 1, 40, 40, 1, 72, False, 0, 0, 6),
    ("causal_right_pad_d128", 1, 50, 50, 1, 128, True, 0, 0, 9),
    ("causal_offset_left_pad_d64", 1, 20, 75, 1, 64, True, 50, 4, 0),
    ("fully_masked_row_d72", 2, 24, 24, 1, 72, True, 0, 24, 0),
]


@functools.lru_cache(maxsize=None)
def _case(case, three=True):
    """(numpy inputs and mask, the plain forward's out / lse / di, the
    emulated grads) of a case."""
    name, B, Lq, S, H, D, causal, q_offset, lpad, rpad = case
    rng = np.random.default_rng(len(name) + D)
    q, do = (rng.standard_normal((B, Lq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(2))
    mask = None
    if lpad or rpad:
        mask = np.ones((B, S), bool)
        mask[0, :lpad] = False
        mask[-1, S - rpad:] = False
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = _torch_kw(mask, causal, q_offset)
    out = t_flash.flash_attention_reference(tq, tk, tv, **kw)
    lse = t_flash.flash_lse_reference(tq, tk, **kw)
    di = (out * tdo).sum(-1)
    # hundreds of tiny matmuls: one thread (torch's pool beside JAX's on a
    # few cores made them 100x slower)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        grads = _tf32_backward(tq, tk, tv, tdo, lse, di, kw["kv_mask"],
                               causal, q_offset, D ** -0.5, three)
    finally:
        torch.set_num_threads(threads)
    return (q, k, v, do, mask), (lse, di), grads


def _torch_kw(mask, causal, q_offset):
    return dict(kv_mask=None if mask is None else torch.from_numpy(mask),
                causal=causal, q_offset=q_offset)


@functools.lru_cache(maxsize=None)
def _jax_grads(case, fused):
    name, B, Lq, S, H, D, causal, q_offset, lpad, rpad = case
    (q, k, v, do, mask), _, _ = _case(case)

    def f(q, k, v):
        out = j_flash.flash_attention(
            q, k, v, kv_mask=None if mask is None else jnp.asarray(mask),
            causal=causal, q_offset=q_offset, fused_bwd=fused)
        return jnp.sum(out * jnp.asarray(do))

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_backward_matches_jax_grad(case, fused):
    """The emulated kernels against ``jax.grad`` through the Pallas
    forward and dQ / dK/dV kernels (interpret mode; ``fused_bwd`` picks
    JAX's fused dQ partials, and the fused kernel) on the same fp32
    inputs."""
    _, _, (separate, fused_grads) = _case(case)
    for got, want in zip(fused_grads if fused else separate,
                         _jax_grads(case, fused)):
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_backward_matches_plain(case):
    """The emulated kernels against the port's plain backward (the version
    the card tests hold the kernels to), fed the same LSE and di; query
    rows and keys that see nothing get exact zeros."""
    name, B, Lq, S, H, D, causal, q_offset, lpad, rpad = case
    (q, k, v, do, mask), (lse, di), grads = _case(case)
    kw = _torch_kw(mask, causal, q_offset)
    want = t_flash.flash_attention_bwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v, do)), lse, di, **kw)
    dense = t_flash._dense_mask(Lq, S, kw["kv_mask"], causal, q_offset,
                                torch.device("cpu"))
    for dq, dk, dv in grads:               # separate, fused
        for got, ref in zip((dq, dk, dv), want):
            assert _rel(got, ref) <= TOL
        if dense is not None:
            live = dense.expand(B, 1, Lq, S)[:, 0]
            dead_q, dead_k = ~live.any(dim=2), ~live.any(dim=1)
            assert not dq[dead_q].any()
            assert not dk[dead_k].any() and not dv[dead_k].any()
    if lpad >= S:              # batch row 0 sees no key at all
        assert dead_q[0].all()


@pytest.mark.parametrize("case", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_one_tf32_product_misses_the_fp32_tolerance(case):
    """One TF32 product of the rounded operands in each of the five
    products, on the same inputs and tile walk, is off by more than
    ``FP32_RTOL``; the three products are within it."""
    (q, k, v, do, mask), (lse, di), three = _case(case)
    _, _, one = _case(case, three=False)
    name, B, Lq, S, H, D, causal, q_offset, lpad, rpad = case
    want = t_flash.flash_attention_bwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v, do)), lse, di,
        **_torch_kw(mask, causal, q_offset))
    for three_grads, one_grads in zip(three, one):   # separate, fused
        err3 = max(_rel(g, w) for g, w in zip(three_grads, want))
        err1 = max(_rel(g, w) for g, w in zip(one_grads, want))
        assert err3 <= FP32_RTOL < err1
