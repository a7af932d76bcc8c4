"""The port's hand-written CUDA kernels against their plain versions, on
the card. Marked ``cuda``: without a card each test skips.

This file imports no JAX, so it runs where only PyTorch is installed
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, relative to the largest |reference| value: 1e-4 in fp32 (the
same inputs, sums in another order), 2e-2 in bf16 (the kernels keep fp32
where the plain versions round to bf16). The LSE is held at 1e-5
absolute (fp32 in both). The flash forward and backward run on the
tensor cores, bf16 directly and fp32 in 3xTF32. The bf16 forward rounds
P to bf16 before P V, as JAX does; the bf16 backward takes P in bf16 for
dV = P^T dO where the plain version (and JAX) keep it in fp32: one more
relative rounding of at most 2^-9 per term, well inside 2e-2; every
other product has bf16-exact operands and fp32 sums in both.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * max(scale, 1e-30), (err, scale)


FLASH = [  # (B, Lq, S, H, D, causal, q_offset, pad)
    (2, 9, 9, 2, 16, False, 0, 0),
    (1, 261, 261, 16, 64, False, 0, 0),
    (1, 256, 256, 4, 72, False, 0, 0),
    (2, 130, 200, 4, 128, True, 0, 17),
    (2, 33, 90, 2, 100, True, 40, 5),
    (1, 70, 70, 2, 128, True, 0, 70),      # every row fully masked
    (1, 610, 768, 32, 80, True, 0, 31),    # Phi-2's prefill: H 32, D 80
]


@pytest.mark.parametrize("case", FLASH, ids=[str(c) for c in FLASH])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, case, dtype):
    from emmax_torch.ops import flash_attention as fa

    B, Lq, S, H, D, causal, q_offset, pad = case
    g = torch.Generator(dev).manual_seed(0)
    qkv = torch.randn(B, Lq, 3 * H * D, device=dev, generator=g).to(dtype)
    q = qkv[..., :H * D].reshape(B, Lq, H, D)          # strided view
    cache = torch.randn(2, B, S + 3, H, D, device=dev, generator=g).to(dtype)
    k, v = cache[0, :, :S], cache[1, :, 3:]             # cache-like views
    mask = torch.zeros(B, S, dtype=torch.bool, device=dev)
    mask[:, pad:] = True
    kw = dict(kv_mask=mask if (pad or causal) else None, causal=causal,
              q_offset=q_offset)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    want = fa.flash_attention_reference(q, k, v, **kw)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
    dense = fa._dense_mask(Lq, S, kw["kv_mask"], causal, q_offset, dev)
    if dense is not None:
        dead = ~dense.any(dim=-1)[:, 0]                 # [B, Lq]
        assert not got[dead].any()                      # exact zeros


@pytest.mark.parametrize("case", FLASH, ids=[str(c) for c in FLASH])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_match_plain(dev, case, dtype):
    """dQ, dK/dV (separate and fused) and the forward's LSE against the
    plain versions, on strided q/k/v as the model gives them."""
    from emmax_torch.ops import flash_attention as fa

    B, Lq, S, H, D, causal, q_offset, pad = case
    g = torch.Generator(dev).manual_seed(2)
    qkv = torch.randn(B, Lq, 3 * H * D, device=dev, generator=g).to(dtype)
    q = qkv[..., :H * D].reshape(B, Lq, H, D)
    k = qkv[..., H * D:2 * H * D].reshape(B, Lq, H, D) if S == Lq else \
        torch.randn(B, S, H, D, device=dev, generator=g).to(dtype)
    v = torch.randn(B, S, H, D, device=dev, generator=g).to(dtype)
    do = torch.randn(B, Lq, H, D, device=dev, generator=g).to(dtype)
    mask = torch.zeros(B, S, dtype=torch.bool, device=dev)
    mask[:, pad:] = True
    if B > 1:
        mask[1, S - 5:] = False                     # right padding too
    kw = dict(kv_mask=mask if (pad or causal) else None, causal=causal,
              q_offset=q_offset)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want_lse = fa.flash_lse_reference(q, k, **kw)
    live = want_lse > -1e30                  # rows that see a valid key
    assert torch.equal(lse[~live], want_lse[~live])     # the sentinel
    if live.any():
        assert (lse[live] - want_lse[live]).abs().max().item() <= 1e-5 * max(
            1.0, want_lse[live].abs().max().item())
    di = (out.float() * do.float()).sum(-1)
    want = fa.flash_attention_bwd_reference(q, k, v, do, lse, di, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for fused in (False, True):
        got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, di, fused=fused,
                                          **kw)
        for a, b in zip(got, want):
            _close(a, b, tol)
        again = fa.flash_attention_bwd_cuda(q, k, v, do, lse, di,
                                            fused=fused, **kw)
        for a, b in zip(got, again):                # no atomics: the same
            assert torch.equal(a, b)                # bits every run


# bf16 backward on the tensor cores: (B, Lq, S, H, D, causal, q_offset,
# left pad, right pad of the last row, layout). Layouts: "qkv" views of one
# fused projection, "contig" separate tensors, "odd" views of a buffer whose
# rows are one element longer (D % 8 == 0 but rows not 16-byte aligned).
BWD_TC = [
    (2, 448, 448, 4, 128, True, 0, 0, 40, "qkv"),    # training, fewer heads
    (2, 97, 161, 2, 128, True, 64, 0, 7, "contig"),  # rectangular q_offset
    (1, 75, 75, 2, 128, True, 0, 0, 0, "odd"),
    (2, 75, 75, 3, 72, True, 0, 5, 3, "qkv"),       # D 72 -> 80
    (2, 70, 110, 2, 100, False, 0, 9, 0, "contig"),  # D 100 -> 112
    (2, 33, 33, 2, 64, True, 0, 33, 0, "qkv"),      # row 0 sees no key
    (2, 331, 331, 32, 80, True, 0, 0, 19, "qkv"),   # Phi-2's step, D 80
]


def _bwd_inputs(dev, case, seed=4, dtype=torch.bfloat16):
    B, Lq, S, H, D, causal, q_offset, lpad, rpad, layout = case
    g = torch.Generator(dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    if layout == "qkv":
        assert Lq == S
        qkv = rnd(B, Lq, 3, H, D)
        q, k, v = qkv.unbind(2)
    elif layout == "odd":
        assert Lq == S
        buf = rnd(B, Lq, 3 * H * D + 1)
        q, k, v = (buf[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D))
                   for i in range(3))
    else:
        q, k, v = rnd(B, Lq, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    do = rnd(B, Lq, H, D)
    mask = None
    if lpad or rpad:
        mask = torch.ones(B, S, dtype=torch.bool, device=dev)
        mask[0, :lpad] = False
        mask[-1, S - rpad:] = False
    kw = dict(kv_mask=mask, causal=causal, q_offset=q_offset)
    return q, k, v, do, kw


@pytest.mark.parametrize("case", BWD_TC, ids=[str(c) for c in BWD_TC])
def test_flash_backward_tensor_cores_match_plain(dev, case):
    """The bf16 tensor-core dQ and dK/dV (separate and fused) against the
    plain backward: ragged tiles, padded D, misaligned rows, strided views,
    rectangular causal offsets; exact zeros for rows that see no key and
    keys no query sees; the same bits on a rerun."""
    from emmax_torch.ops import flash_attention as fa

    q, k, v, do, kw = _bwd_inputs(dev, case)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    di = (out.float() * do.float()).sum(-1)
    want = fa.flash_attention_bwd_reference(q, k, v, do, lse, di, **kw)
    B, Lq, S = q.shape[0], q.shape[1], k.shape[1]
    dense = fa._dense_mask(Lq, S, kw["kv_mask"], kw["causal"],
                           kw["q_offset"], dev)
    dense = (torch.ones(1, 1, Lq, S, dtype=torch.bool, device=dev)
             if dense is None else dense).expand(B, 1, Lq, S)[:, 0]
    dead_q, dead_k = ~dense.any(dim=2), ~dense.any(dim=1)
    for fused in (False, True):
        got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, di, fused=fused,
                                          **kw)
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            _close(a, b, 2e-2)
        dq, dk, dv = got
        assert not dq[dead_q].any() and not dk[dead_k].any()
        assert not dv[dead_k].any()
        again = fa.flash_attention_bwd_cuda(q, k, v, do, lse, di,
                                            fused=fused, **kw)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


# the bf16 forward on the tensor cores: the backward's cases and one where
# every row of the batch sees no key
FWD_TC = BWD_TC + [(1, 70, 70, 2, 128, True, 0, 70, 0, "contig")]


@pytest.mark.parametrize("case", FWD_TC, ids=[str(c) for c in FWD_TC])
def test_flash_forward_tensor_cores_match_plain(dev, case):
    """The bf16 tensor-core forward against the plain version: ragged
    tiles, padded D, misaligned rows, strided views, rectangular causal
    offsets; rows that see no key are exact zeros with the LSE sentinel
    bit for bit; the same bits on a rerun, with and without the LSE."""
    from emmax_torch.ops import flash_attention as fa

    q, k, v, _, kw = _bwd_inputs(dev, case)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert out.dtype == torch.bfloat16
    _close(out, fa.flash_attention_reference(q, k, v, **kw), 2e-2)
    want_lse = fa.flash_lse_reference(q, k, **kw)
    live = want_lse > -1e30
    assert torch.equal(lse[~live], want_lse[~live])     # the sentinel
    assert not out[~live].any()                         # exact zeros
    if live.any():
        assert (lse[live] - want_lse[live]).abs().max().item() <= 1e-5 * max(
            1.0, want_lse[live].abs().max().item())
    again, lse2 = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    assert torch.equal(fa.flash_attention_cuda(q, k, v, **kw), out)


# the fp32 forward on the tensor cores in 3xTF32, same layouts: the
# towers' shapes (D 64 over 261 keys, D 72), D 128 with a rectangular
# causal offset and with rows not 16-byte aligned (4-byte copies), D 100
# padded to 128, and a row that sees no key
FWD_TF32 = [
    (1, 261, 261, 4, 64, False, 0, 0, 0, "qkv"),
    (2, 256, 256, 3, 72, False, 0, 0, 5, "qkv"),
    (2, 97, 161, 2, 128, True, 64, 0, 7, "contig"),
    (1, 75, 75, 2, 128, True, 0, 0, 0, "odd"),
    (2, 70, 110, 2, 100, False, 0, 9, 0, "contig"),
    (2, 33, 33, 2, 72, True, 0, 33, 0, "qkv"),
    # the zoo's towers: CLIP-336 577 tokens (D 64), SigLIP-384 729 (D 72)
    # and DINOv2-384 734 (D 64)
    (1, 577, 577, 16, 64, False, 0, 0, 0, "qkv"),
    (1, 729, 729, 16, 72, False, 0, 0, 0, "qkv"),
    (1, 734, 734, 4, 64, False, 0, 0, 0, "contig"),
]


@pytest.mark.parametrize("case", FWD_TF32, ids=[str(c) for c in FWD_TF32])
def test_flash_forward_3xtf32_matches_plain(dev, case):
    """The fp32 forward (3xTF32 on the tensor cores) against the plain
    version at 1e-4, its LSE at 1e-5; rows that see no key are exact zeros
    with the LSE sentinel bit for bit; the same bits on a rerun, with and
    without the LSE."""
    from emmax_torch.ops import flash_attention as fa

    q, k, v, _, kw = _bwd_inputs(dev, case, dtype=torch.float32)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert out.dtype == torch.float32
    _close(out, fa.flash_attention_reference(q, k, v, **kw), 1e-4)
    want_lse = fa.flash_lse_reference(q, k, **kw)
    live = want_lse > -1e30
    assert torch.equal(lse[~live], want_lse[~live])     # the sentinel
    assert not out[~live].any()                         # exact zeros
    if live.any():
        assert (lse[live] - want_lse[live]).abs().max().item() <= 1e-5 * max(
            1.0, want_lse[live].abs().max().item())
    again, lse2 = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    assert torch.equal(fa.flash_attention_cuda(q, k, v, **kw), out)


# the fp32 backward on the tensor cores in 3xTF32, same layouts: the
# towers' shapes (DINOv2 D 64 over 261 keys, SigLIP D 72 right-padded),
# the Llama training shape (D 128, causal, right-padded), a rectangular
# causal offset, rows not 16-byte aligned (4-byte copies), D 100 padded to
# 128 under a left pad, and a row that sees no key
BWD_TF32 = [
    (2, 261, 261, 4, 64, False, 0, 0, 0, "qkv"),
    (2, 256, 256, 3, 72, False, 0, 0, 5, "qkv"),
    (2, 448, 448, 2, 128, True, 0, 0, 40, "qkv"),
    (2, 97, 161, 2, 128, True, 64, 0, 7, "contig"),
    (1, 75, 75, 2, 128, True, 0, 0, 0, "odd"),
    (2, 70, 110, 2, 100, False, 0, 9, 0, "contig"),
    (2, 33, 33, 2, 72, True, 0, 33, 0, "qkv"),
]


@pytest.mark.parametrize("case", BWD_TF32, ids=[str(c) for c in BWD_TF32])
def test_flash_backward_3xtf32_matches_plain(dev, case):
    """The fp32 dQ and dK/dV (3xTF32 on the tensor cores; separate and
    fused) against the plain backward at 1e-4: ragged tiles, padded D,
    misaligned rows, strided views, rectangular causal offsets; exact zeros
    for rows that see no key and keys no query sees; the same bits on a
    rerun."""
    from emmax_torch.ops import flash_attention as fa

    q, k, v, do, kw = _bwd_inputs(dev, case, dtype=torch.float32)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    di = (out * do).sum(-1)
    want = fa.flash_attention_bwd_reference(q, k, v, do, lse, di, **kw)
    B, Lq, S = q.shape[0], q.shape[1], k.shape[1]
    dense = fa._dense_mask(Lq, S, kw["kv_mask"], kw["causal"],
                           kw["q_offset"], dev)
    dense = (torch.ones(1, 1, Lq, S, dtype=torch.bool, device=dev)
             if dense is None else dense).expand(B, 1, Lq, S)[:, 0]
    dead_q, dead_k = ~dense.any(dim=2), ~dense.any(dim=1)
    for fused in (False, True):
        got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, di, fused=fused,
                                          **kw)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            _close(a, b, 1e-4)
        dq, dk, dv = got
        assert not dq[dead_q].any() and not dk[dead_k].any()
        assert not dv[dead_k].any()
        again = fa.flash_attention_bwd_cuda(q, k, v, do, lse, di,
                                            fused=fused, **kw)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


def test_backward_counts_launches_by_dtype(dev):
    """dQ and dK/dV count each launch under the inputs' dtype."""
    from emmax_torch.ops import flash_attention as fa

    for kernel in (fa.DQ_KERNEL, fa.DKV_KERNEL):
        kernel.reset_counts()
    for dtype, fused in ((torch.float32, False), (torch.float32, True),
                         (torch.bfloat16, False)):
        q, k, v, do, kw = _bwd_inputs(dev, BWD_TF32[-1], dtype=dtype)
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        di = (out.float() * do.float()).sum(-1)
        fa.flash_attention_bwd_cuda(q, k, v, do, lse, di, fused=fused, **kw)
    assert fa.DQ_KERNEL.launches_by == {"float32": 1, "bfloat16": 1}
    assert fa.DKV_KERNEL.launches_by == {"float32": 2, "bfloat16": 1}
    assert (fa.DQ_KERNEL.launches, fa.DKV_KERNEL.launches) == (2, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_dq_partials_one_per_kv_tile(dev, dtype):
    """The fused dK/dV kernel writes ceil(S / BWD_KV_TILE) fp32 partials,
    exact zeros where a kv tile sees none of a row's keys (causal), and
    their sum is the separate kernel's dQ up to its bf16 rounding."""
    from emmax_torch.ops import flash_attention as fa

    B, Lq, S, H, D, q_offset = 2, 150, 200, 2, 128, 50
    g = torch.Generator(dev).manual_seed(5)
    q, do = (torch.randn(B, Lq, H, D, device=dev, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, H, D, device=dev, generator=g).to(dtype)
            for _ in range(2))
    kw = dict(causal=True, q_offset=q_offset)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    di = (out.float() * do.float()).sum(-1)
    (args, _keep), outs = fa.bwd_launch_args(q, k, v, do, lse, di,
                                             fused=True, **kw)
    fa.DKV_KERNEL.launch(*args)     # writes dk and dv too: keep `outs`
    part = outs[3]
    n_tiles = -(-S // fa.BWD_KV_TILE)
    assert part.shape == (n_tiles, B, Lq, H, D) and part.dtype == torch.float32
    for j in range(1, n_tiles):   # rows before the tile's first key
        first_row = j * fa.BWD_KV_TILE - q_offset
        assert not part[j, :, :first_row].any()
    dq = fa.flash_attention_bwd_cuda(q, k, v, do, lse, di, **kw)[0]
    _close(part.sum(dim=0), dq, 1e-4 if dtype == torch.float32 else 1e-2)


def test_autograd_function_launches_the_backward_kernels(dev):
    from emmax_torch.ops import flash_attention as fa
    from emmax_torch.ops.attention import multi_head_attention

    q, k, v = (torch.randn(2, 40, 2, 64, device=dev, requires_grad=True)
               for _ in range(3))
    for impl, dq_launches in (("cuda", 1), ("cuda_fused", 0)):
        before = (fa.KERNEL.launches, fa.DQ_KERNEL.launches,
                  fa.DKV_KERNEL.launches)
        out = multi_head_attention(q, k, v, causal=True, impl=impl)
        out.square().sum().backward()
        assert (fa.KERNEL.launches - before[0],
                fa.DQ_KERNEL.launches - before[1],
                fa.DKV_KERNEL.launches - before[2]) == (1, dq_launches, 1)
    ref = [t.detach().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_reference(*ref, causal=True).square().sum().backward()
    for t, r in zip((q, k, v), ref):
        _close(t.grad / 2, r.grad, 1e-4)           # two backward passes


INT4 = [  # (M, D, F, group); D 80 shrinks the group to 8: both dtypes
    # then run the scalar kernel, the others the tensor-core kernels
    (1, 256, 200, 128), (3, 64, 36, 32), (17, 128, 384, 64),
    (130, 512, 260, 128), (1, 11008, 512, 128), (5, 80, 36, 128),
]


@pytest.mark.parametrize("case", INT4, ids=[str(c) for c in INT4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_kernel_matches_plain(dev, case, dtype):
    from emmax_torch.ops import int4_matmul as im

    M, D, F, group = case
    g = torch.Generator(dev).manual_seed(1)
    w = torch.randn(3, D, F, device=dev, generator=g) * 0.02
    qw = im.quantize_weight_int4(w, group=group)
    x = torch.randn(M, D, device=dev, generator=g).to(dtype)
    got = im.int4_matmul(x, {**qw, "layer": 2})
    want = im.int4_matmul_reference(x, qw["q4"][2], qw["scale"][2])
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)


# bf16 x on the tensor cores: (M, D, F, group); F ragged against the
# 128- and 32-column tiles, groups of 32 / 64 / 128, units that walk one
# group and several, D 11008 (43 groups per plane, odd)
INT4_TC = [
    (2, 256, 200, 64), (6, 512, 4100, 128), (17, 128, 384, 32),
    (48, 1024, 1000, 64), (130, 1024, 4100, 64), (1, 11008, 4096, 128),
    # the speculative verifier's widths: draft_k 12 + 1, the (7, 5) tree
    (13, 4096, 4100, 128), (43, 11008, 1000, 128), (43, 4096, 4096, 128),
]


def _int4_exact(x, q4, scale):
    """x @ dequant(q4, scale) in float64, with the exact levels q + 0.5."""
    b = q4.to(torch.int32)
    w = torch.cat([(b & 15) - 8, b >> 4], dim=0).double() + 0.5
    group = w.shape[0] // scale.shape[0]
    w = w * scale.double().repeat_interleave(group, dim=0)
    return x.double() @ w


@pytest.mark.parametrize("case", INT4_TC, ids=[str(c) for c in INT4_TC])
def test_int4_tensor_cores_match_plain(dev, case):
    """The bf16 tensor-core kernel on a stacked view against the plain
    version (2e-2) and against the exact product: within one bf16
    rounding of the output (2^-8 relative) plus 1e-6 of the largest value
    for fp32 sums; the same bits on a rerun; an x that does not start on
    a 16-byte boundary gives the same bits."""
    from emmax_torch.ops import int4_matmul as im

    M, D, F, group = case
    g = torch.Generator(dev).manual_seed(3)
    w = torch.randn(3, D, F, device=dev, generator=g) * 0.02
    qw = im.quantize_weight_int4(w, group=group)
    assert qw["scale"].shape[-2] == D // group
    x = torch.randn(M, D, device=dev, generator=g).bfloat16()
    before = im.KERNEL.launches
    got = im.int4_matmul(x, {**qw, "layer": 1})
    assert im.KERNEL.launches == before + 1 and got.dtype == torch.bfloat16
    q4, scale = qw["q4"][1], qw["scale"][1]
    _close(got, im.int4_matmul_reference(x, q4, scale), 2e-2)
    exact = _int4_exact(x, q4, scale)
    slack = 2 ** -8 * exact.abs() + 1e-6 * exact.abs().max()
    assert bool(((got.double() - exact).abs() <= slack).all())
    assert torch.equal(im.int4_matmul_cuda(x, q4, scale), got)
    buf = torch.empty(M * D + 1, dtype=torch.bfloat16, device=dev)
    odd = buf[1:].view(M, D)
    odd.copy_(x)
    assert torch.equal(im.int4_matmul_cuda(odd, q4, scale), got)


# fp32 x on the TF32 tensor cores at Emma-X's weights (D, F): wq, w_gate,
# w_down and the lm_head (F 32064: its column blocks end ragged), at M 1
# (decode), 13 and 43 (the verifier's chunks) and 448 (the prefill)
INT4_TF32 = [(M, D, F) for M in (1, 13, 43, 448)
             for D, F in ((4096, 4096), (4096, 11008), (11008, 4096),
                          (4096, 32064))]


@pytest.mark.parametrize("case", INT4_TF32, ids=[str(c) for c in INT4_TF32])
def test_int4_tf32_matches_plain(dev, case):
    """The TF32 kernel (exact levels, x split into big + small) on a
    stacked view against the plain version at 1e-4 and against the exact
    product within 1e-5 of its largest value (fp32 sums); one launch,
    counted under float32; the same bits on a rerun and from an x that
    does not start on a 16-byte boundary (the wrapper copies it)."""
    from emmax_torch.ops import int4_matmul as im

    M, D, F = case
    g = torch.Generator(dev).manual_seed(5)
    q4 = torch.randint(-128, 128, (2, D // 2, F), dtype=torch.int8,
                       device=dev, generator=g)
    scale = (torch.rand((2, D // 128, F), device=dev, generator=g)
             * 0.02).bfloat16()
    x = torch.randn(M, D, device=dev, generator=g)
    before = im.KERNEL.launches_by.get("float32", 0)
    got = im.int4_matmul(x, {"q4": q4, "scale": scale, "layer": 1})
    assert im.KERNEL.launches_by["float32"] == before + 1
    assert got.dtype == torch.float32
    _close(got, im.int4_matmul_reference(x, q4[1], scale[1]), 1e-4)
    exact = _int4_exact(x, q4[1], scale[1])
    assert (got.double() - exact).abs().max() <= 1e-5 * exact.abs().max()
    assert torch.equal(im.int4_matmul_cuda(x, q4[1], scale[1]), got)
    buf = torch.empty(M * D + 1, device=dev)
    odd = buf[1:].view(M, D)
    odd.copy_(x)
    assert torch.equal(im.int4_matmul_cuda(odd, q4[1], scale[1]), got)


def test_int4_fp32_groups_off_the_tensor_cores_match_plain(dev):
    """A group that is not a multiple of 16 (D 72 gives 4, D 80 gives 8):
    the scalar kernel still serves it, in fp32 within 1e-4 of plain."""
    from emmax_torch.ops import int4_matmul as im

    g = torch.Generator(dev).manual_seed(6)
    for M, D, F in ((3, 72, 40), (9, 80, 36)):
        qw = im.quantize_weight_int4(
            torch.randn(D, F, device=dev, generator=g) * 0.02)
        assert (D // qw["scale"].shape[0]) % 16
        x = torch.randn(M, D, device=dev, generator=g)
        _close(im.int4_matmul(x, qw),
               im.int4_matmul_reference(x, qw["q4"], qw["scale"]), 1e-4)


# the zoo's int4 decoder weights (M, D, F), each at decode (M 1) and at
# a prefill's rows (768: CLIP-L/336's 576 patches and a 192-token bucket;
# 609 and 325: shorter prompts): Phi-2's wq / wk / wv / wo, w1, w2 and
# lm_head (with their biases), Mistral's wq / wo, wk / wv (4096 -> 1024,
# grouped-query attention), w_gate / w_up, w_down and lm_head
INT4_ZOO = [(1, 2560, 10240), (1, 10240, 2560), (1, 2560, 51200),
            (609, 2560, 10240), (609, 10240, 2560), (1, 4096, 1024),
            (325, 4096, 1024),
            (1, 2560, 2560), (768, 2560, 2560), (768, 2560, 10240),
            (768, 10240, 2560), (768, 2560, 51200), (768, 4096, 4096),
            (768, 4096, 1024), (1, 4096, 14336), (768, 4096, 14336),
            (1, 14336, 4096), (768, 14336, 4096), (1, 4096, 32064),
            (768, 4096, 32064)]


@pytest.mark.parametrize("case", INT4_ZOO, ids=[str(c) for c in INT4_ZOO])
def test_int4_zoo_shapes_with_bias_match_plain(dev, case):
    """Phi's biased linear (``models/phi._linear``: the int4 kernel, then
    the bias) against the plain product plus the bias (2e-2) and the
    exact product plus the bias (two bf16 roundings: the kernel's output,
    then the sum)."""
    from emmax_torch.models.phi import _linear
    from emmax_torch.ops import int4_matmul as im

    M, D, F = case
    g = torch.Generator(dev).manual_seed(5)
    w = torch.randn(2, D, F, device=dev, generator=g) * 0.02
    qw = im.quantize_weight_int4(w)
    del w
    x = torch.randn(M, D, device=dev, generator=g).bfloat16()
    b = (torch.randn(F, device=dev, generator=g) * 0.1).bfloat16()
    before = im.KERNEL.launches
    got = _linear(x, {**qw, "layer": 1}, b)
    assert im.KERNEL.launches == before + 1 and got.dtype == torch.bfloat16
    q4, scale = qw["q4"][1], qw["scale"][1]
    _close(got, im.int4_matmul_reference(x, q4, scale) + b, 2e-2)
    prod = _int4_exact(x, q4, scale)
    exact = prod + b.double()
    slack = (2 ** -8 * (prod.abs() + exact.abs())
             + 1e-6 * exact.abs().max())
    assert bool(((got.double() - exact).abs() <= slack).all())


def test_gqa_prefill_repeats_kv_into_the_kernel(dev):
    """Mistral's prefill: 32 query heads on 8 KV heads; ``multi_head_
    attention`` repeats K/V per query head and launches the bf16 kernel
    once, within 2e-2 of the plain path (which repeats them too)."""
    from emmax_torch.ops import flash_attention as fa
    from emmax_torch.ops.attention import multi_head_attention, xla_attention

    g = torch.Generator(dev).manual_seed(6)
    B, L, S, H, KV, D = 1, 333, 512, 32, 8, 128
    q = torch.randn(B, L, H, D, device=dev, generator=g).bfloat16()
    k, v = (torch.randn(B, S, KV, D, device=dev, generator=g).bfloat16()
            for _ in range(2))
    mask = torch.zeros(B, S, dtype=torch.bool, device=dev)
    mask[:, 13:L] = True
    kw = dict(kv_mask=mask, causal=True, q_offset=0)
    before = fa.KERNEL.launches
    got = multi_head_attention(q, k, v, impl="cuda", **kw)
    assert fa.KERNEL.launches == before + 1
    want = xla_attention(q, k, v, **kw)
    live = mask[0, :L]
    _close(got[:, live], want[:, live], 2e-2)


def test_quantizer_on_card_matches_cpu(dev):
    from emmax_torch.ops import int4_matmul as im

    w = torch.randn(2, 256, 72) * 0.02
    on_card = im.quantize_weight_int4(w.to(dev))
    on_cpu = im.quantize_weight_int4(w)
    assert torch.equal(on_card["q4"].cpu(), on_cpu["q4"])
    assert torch.equal(on_card["scale"].cpu(), on_cpu["scale"])
    np.testing.assert_array_equal(on_cpu["q4"].numpy(),
                                  im.quantize_weight_int4_np(w.numpy())["q4"])


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from emmax_torch.ops.flash_attention import flash_attention_cuda
    from emmax_torch.ops.int4_matmul import int4_matmul_cuda

    q = torch.zeros(1, 8, 2, 160, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 8, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 8, 2, 16, device=dev)
    with pytest.raises(ValueError, match="shapes"):      # KV heads != H
        flash_attention_cuda(q, q[:, :, :1], q[:, :, :1])
    x = torch.zeros(1, 64, device=dev)
    q4 = torch.zeros(32, 6, dtype=torch.int8, device=dev)   # F % 4 != 0
    scale = torch.zeros(2, 6, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="F % 4"):
        int4_matmul_cuda(x, q4, scale)


def test_launch_counters_count_launches(dev):
    from emmax_torch.ops import flash_attention as fa
    from emmax_torch.ops import int4_matmul as im

    q = torch.randn(1, 16, 2, 16, device=dev)
    before = fa.KERNEL.launches
    fa.flash_attention(q, q, q)
    fa.flash_attention(q[:, :4], q, q)       # Lq < 8: the plain path
    assert fa.KERNEL.launches == before + 1
    qw = im.quantize_weight_int4(torch.randn(64, 8, device=dev))
    before = im.KERNEL.launches
    im.int4_matmul(torch.randn(2, 64, device=dev), qw)
    assert im.KERNEL.launches == before + 1


# (B, KV, G, hd, page_size, pages per row); lengths cover 1, exactly one
# page, one past a page and the whole table
PAGED = [
    (4, 4, 1, 16, 16, 3),
    (4, 2, 4, 16, 16, 3),
    (4, 8, 1, 128, 128, 3),
    (4, 8, 4, 128, 128, 3),
    (3, 2, 3, 72, 5, 4),
]


def _paged_inputs(dev, case, qdt, kdt, seed=0):
    from emmax_torch.serving.paged import _row_quantize

    B, KV, G, hd, ps, MP = case
    g = torch.Generator(dev).manual_seed(seed)
    P = B * MP + 2
    q = (torch.randn(B, KV * G, hd, device=dev, generator=g)
         * hd ** -0.5).to(qdt)
    k, v = (torch.randn(KV, P, ps, hd, device=dev, generator=g)
            for _ in range(2))
    ks = vs = None
    if kdt == torch.int8:
        (k, ks), (v, vs) = _row_quantize(k), _row_quantize(v)
    else:
        k, v = k.to(kdt), v.to(kdt)
    # every row's page ids in reverse order; -1 past its length
    table = torch.arange(P - 1, P - 1 - B * MP, -1, dtype=torch.int32,
                         device=dev).reshape(B, MP)
    lengths = torch.tensor([1, ps, ps + 1, MP * ps][:B] + [MP * ps - 2]
                           * max(0, B - 4), dtype=torch.int32, device=dev)
    for b in range(B):
        table[b, -(-int(lengths[b]) // ps):] = -1
    return q, k, v, lengths, table, ks, vs


@pytest.mark.parametrize("case", PAGED, ids=[str(c) for c in PAGED])
@pytest.mark.parametrize("kdt", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["fp32", "bf16", "int8"])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16],
                         ids=["q_fp32", "q_bf16"])
def test_paged_attention_kernel_matches_plain(dev, case, kdt, qdt):
    from emmax_torch.ops import paged_attention as pa

    q, k, v, lengths, table, ks, vs = _paged_inputs(dev, case, qdt, kdt)
    before = pa.KERNEL.launches
    got = pa.paged_attention(q, k, v, lengths, table, k_scale=ks,
                             v_scale=vs)
    assert pa.KERNEL.launches == before + 1
    want = pa.paged_attention_reference(q, k, v, lengths, table, k_scale=ks,
                                        v_scale=vs)
    assert got.dtype == qdt
    _close(got, want, 1e-4 if qdt == torch.float32 else 2e-2)
    # a rerun gives the same bits
    assert torch.equal(pa.paged_attention(q, k, v, lengths, table,
                                          k_scale=ks, v_scale=vs), got)


def test_paged_attention_kernel_zero_length_row_and_checks(dev):
    from emmax_torch.ops import paged_attention as pa

    q, k, v, lengths, table, _, _ = _paged_inputs(
        dev, PAGED[0], torch.float32, torch.float32)
    lengths[0] = 0
    assert not pa.paged_attention(q, k, v, lengths, table)[0].any()
    with pytest.raises(ValueError, match="multiple of 8"):
        pa.paged_attention_cuda(q[..., :12], k[..., :12], v[..., :12],
                                lengths, table)
    with pytest.raises(ValueError, match="int8 pages need"):
        pa.paged_attention_cuda(q, k.to(torch.int8), v.to(torch.int8),
                                lengths, table)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention_cuda(q, k, v, lengths.long(), table)


# (B, KV, G, hd, page size, pages per row, lengths): several page ranges
# per row, with ranges wholly past a row's length, a row of length 0 and
# G = 8 (int8 pages take two chunks of 4 query heads)
PAGED_SPLIT = [
    (4, 8, 1, 128, 16, 24, [1, 130, 0, 384]),
    (3, 1, 8, 64, 32, 9, [33, 0, 288]),
    (6, 4, 4, 128, 128, 6, [1, 127, 128, 129, 458, 768]),
]


@pytest.mark.parametrize("case", PAGED_SPLIT,
                         ids=[str(c[:6]) for c in PAGED_SPLIT])
@pytest.mark.parametrize("kdt", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_paged_attention_split_ranges_rerun_and_graph_replay(dev, case, kdt):
    """The kernel splits each row's pages into ``splits(MP, ps)`` ranges:
    within 2e-2 of the plain version (bf16 q) with ranges wholly past a
    row's length, zeros for a row of length 0, the same bits on a rerun,
    and a CUDA graph of the call equal to the eager call, also when
    replayed after the lengths change in place on the device."""
    from emmax_torch.ops import paged_attention as pa
    from emmax_torch.serving.paged import _row_quantize

    B, KV, G, hd, ps, MP, lens = case
    assert pa.splits(MP, ps) > 1
    g = torch.Generator(dev).manual_seed(3)
    P = B * MP + 2
    q = (torch.randn(B, KV * G, hd, device=dev, generator=g)
         * hd ** -0.5).bfloat16()
    k, v = (torch.randn(KV, P, ps, hd, device=dev, generator=g)
            for _ in range(2))
    ks = vs = None
    if kdt == torch.int8:
        (k, ks), (v, vs) = _row_quantize(k), _row_quantize(v)
    else:
        k, v = k.to(kdt), v.to(kdt)
    table = torch.randperm(P, device=dev, generator=g)[:B * MP].reshape(
        B, MP).to(torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(k_scale=ks, v_scale=vs)
    got = pa.paged_attention_cuda(q, k, v, lengths, table, **kw)
    _close(got, pa.paged_attention_reference(q, k, v, lengths, table, **kw),
           2e-2)
    assert all(not got[b].any() for b in range(B) if lens[b] == 0)
    assert torch.equal(pa.paged_attention_cuda(q, k, v, lengths, table, **kw),
                       got)
    live = lengths.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = pa.paged_attention_cuda(q, k, v, live, table, **kw)
    graph.replay()
    assert torch.equal(replayed, got)
    live.copy_(lengths.flip(0))
    graph.replay()
    assert torch.equal(replayed, pa.paged_attention_cuda(
        q, k, v, lengths.flip(0).contiguous(), table, **kw))


def test_flash_forward_at_the_tail_refresh_shape(dev):
    """The speculative engine's prefix-KV tail refresh: 24 queries at
    q_offset = F - 24 attending causally into the whole cache (Lq < 8 is
    not it: 24 queries take the kernel), the prompt's left pad and the
    slots past F masked; bf16 (the serving dtype) and fp32."""
    from emmax_torch.ops import flash_attention as fa

    S, F, pad, H, D = 640, 384, 7, 32, 128
    mask = torch.zeros(1, S, dtype=torch.bool, device=dev)
    mask[0, pad:F] = True
    kw = dict(kv_mask=mask, causal=True, q_offset=F - 24)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        g = torch.Generator(dev).manual_seed(6)
        q = torch.randn(1, 24, H, D, device=dev, generator=g).to(dtype)
        cache = torch.randn(2, 1, S, H, D, device=dev, generator=g).to(dtype)
        before = fa.KERNEL.launches
        got = fa.flash_attention(q, cache[0], cache[1], **kw)
        assert fa.KERNEL.launches == before + 1
        _close(got, fa.flash_attention_reference(q, cache[0], cache[1],
                                                 **kw), tol)


def test_speculative_engine_on_card_gives_the_cpu_tokens(dev):
    """The tiny config in fp32 through the kernels: a tree engine with an
    int8 cache across three closed-loop frames (a tail refresh after a
    tail refresh) gives the CPU engine's tokens and steps."""
    from emmax_torch.models.vlm import init_vlm_params, tiny_vlm_config
    from emmax_torch.serving.engine import GenerateOptions, VisionCache
    from emmax_torch.serving.speculative import SpeculativeEngine
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer

    cfg = tiny_vlm_config(vocab_size=2048)
    params = init_vlm_params(torch.Generator().manual_seed(3), cfg)
    tok = ByteLevelTokenizer(vocab_size=2048)
    rng = np.random.default_rng(1)
    px = {n: torch.from_numpy(rng.normal(size=(1, v.img_size, v.img_size, 3))
                              .astype(np.float32)) for n, v in cfg.vision}
    frame = np.zeros((64, 64, 3), np.uint8)
    runs = []
    for device in (torch.device("cpu"), dev):
        eng = SpeculativeEngine(
            cfg, _to(params, device), tok,
            options=GenerateOptions(eos_id=tok.eos_id), draft_k=12,
            action_tree=(5, 3), quantized_cache=True, prefix_tail=24,
            vision_cache=VisionCache(threshold=0.0), device=device)
        out, prev = [], None
        for x in (100, 104, 108):
            prompt = ("In: What action should the robot take\nCURRENT "
                      f"GRIPPER: [{x:03d}, 090]\nOut:")
            ids = eng.generate_ids([prompt], _to(px, device),
                                   max_new_tokens=24, draft_context=prev,
                                   frame_key=frame)
            prev = ids[0]
            out.append((ids.tolist(), eng.last_steps, eng.last_prefill))
        runs.append(out)
    assert runs[0] == runs[1]
    assert [r[2] for r in runs[1]] == ["full", "tail", "tail"]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _tiny_checkpoint_dir(root, fmt):
    """A tiny checkpoint dir in the reference ``.pt`` layout or the OpenVLA
    Hugging Face layout, written by the port's exporters."""
    import json

    from emmax_torch.convert_weights import save_hf, save_reference_pt
    from emmax_torch.models.load import load

    cfg, params, _, _, _ = load("tiny", dtype=torch.float32, device="cpu",
                                seed=4)
    ids = {"vision_backbone_id": "tiny", "llm_backbone_id": "tiny",
           "arch_specifier": "no-align+fused-gelu-mlp",
           "image_resize_strategy": "resize-naive"}
    d = root / fmt
    if fmt == "pt":
        save_reference_pt(params, cfg, d / "checkpoints" / "latest.pt")
        (d / "config.json").write_text(json.dumps({"model": ids}))
    else:
        save_hf(params, cfg, ids, d, dtype=torch.float32)
    return d


@pytest.mark.parametrize("quantize", [None, "int4"])
@pytest.mark.parametrize("fmt", ["pt", "hf"])
def test_checkpoint_dir_on_card_gives_the_cpu_tokens(dev, fmt, quantize,
                                                     tmp_path):
    """``load_vla(dir)`` onto the card (fp32, through the kernels) gives
    the greedy tokens of the same dir loaded on the CPU."""
    from emmax_torch.models.load import load_vla

    d = _tiny_checkpoint_dir(tmp_path, fmt)
    frame = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    out = []
    for device in ("cpu", dev):
        vla = load_vla(d, dtype=torch.float32, quantize=quantize,
                       device=device)
        prompt = vla.get_prompt("pick the cup", gripper_position=(10, 20))
        out.append(vla.engine.generate_ids([prompt], vla._pixels(frame),
                                           max_new_tokens=16).tolist())
    assert out[0] == out[1]


def test_safetensors_reader_onto_the_card(dev, tmp_path):
    from emmax_torch.models.safetensors_io import (load_dir, load_file,
                                                   save_dir)

    sd = {"bf16": torch.randn(33, 7).to(torch.bfloat16),
          "f32": torch.randn(5), "i8": torch.arange(-5, 5, dtype=torch.int8),
          "bool": torch.tensor([True, False, True])}
    save_dir(sd, tmp_path, max_shard_bytes=64)
    for got in (load_dir(tmp_path, device=dev),
                load_file(sorted(tmp_path.glob("*.safetensors"))[0],
                          device=dev)):
        for k, v in got.items():
            assert v.device.type == "cuda"
            assert torch.equal(v.cpu(), sd[k]), k


def test_world_size_one_nccl_mesh_step_equals_unwrapped(dev):
    """A NCCL process group of one rank and its (1, 1, 1) mesh on the card:
    ``shard_params`` copies no leaf, and a train step through the mesh
    (the flash kernels, fp32) gives the unwrapped step's loss, grad norm
    and params bit for bit."""
    import socket

    import torch.distributed as dist

    from emmax_torch.models.tree import leaves_with_path
    from emmax_torch.models.vlm import init_vlm_params, tiny_vlm_config
    from emmax_torch.parallel import (initialize_distributed, make_mesh,
                                      shard_batch, shard_params)
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer)
    from emmax_torch.training.train_step import make_train_step

    cfg = tiny_vlm_config()
    rng = np.random.default_rng(0)
    B, L = 4, 12
    ids = rng.integers(3, 512, size=(B, L))
    ids[:, 0] = 1
    labels = ids.copy()
    labels[:, :4] = -100
    batch = {"input_ids": torch.from_numpy(ids).to(dev),
             "attention_mask": torch.ones(B, L, dtype=torch.bool,
                                          device=dev),
             "labels": torch.from_numpy(labels).to(dev),
             "pixel_values": {n: torch.from_numpy(rng.normal(
                 size=(B, v.img_size, v.img_size, 3)).astype(
                     np.float32)).to(dev) for n, v in cfg.vision}}

    def params():
        g = torch.Generator(dev).manual_seed(0)
        return init_vlm_params(g, cfg, torch.float32, dev)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh((1, 1, 1))
        results = []
        for m in (None, mesh):
            p = params()
            tx, _ = make_optimizer(p, learning_rate=1e-3, weight_decay=0.0,
                                   max_grad_norm=1.0,
                                   lr_scheduler_type="constant",
                                   total_steps=10, stage="vla-full-train")
            if m is not None:
                placed = shard_params(p, m)
                assert all(a.data_ptr() == b.data_ptr() for (_, a), (_, b)
                           in zip(leaves_with_path(p),
                                  leaves_with_path(placed)))
                p = placed
            step = make_train_step(cfg, tx, attn_impl="cuda", remat=True,
                                   compute_dtype=torch.float32, mesh=m)
            b = batch if m is None else shard_batch(batch, m)
            state, metrics = step(create_train_state(p, tx), b)
            results.append(({k: v.item() for k, v in metrics.items()},
                            [t.cpu() for _, t in
                             leaves_with_path(state.params)]))
    finally:
        dist.destroy_process_group()
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)
