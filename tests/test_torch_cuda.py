"""The port's hand-written CUDA kernels against their plain versions, on
the card. Marked ``cuda``: without a card each test skips.

This file imports no JAX, so it runs where only PyTorch is installed
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, relative to the largest |reference| value: 1e-4 in fp32 (the
same inputs, sums in another order), 2e-2 in bf16 (the kernels keep fp32
where the plain versions round to bf16). The LSE is held at 1e-5
absolute (fp32 in both). The bf16 flash backward runs on the tensor
cores, which take P in bf16 for dV = P^T dO where the plain version (and
JAX) keep it in fp32: one more relative rounding of at most 2^-9 per
term, well inside 2e-2; every other product has bf16-exact operands and
fp32 sums in both.
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
]


def _bwd_inputs(dev, case, seed=4):
    B, Lq, S, H, D, causal, q_offset, lpad, rpad, layout = case
    g = torch.Generator(dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

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
    (args, _keep), (_, _, _, part) = fa.bwd_launch_args(
        q, k, v, do, lse, di, fused=True, **kw)
    fa.DKV_KERNEL.launch(*args)
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


INT4 = [  # (M, D, F, group)
    (1, 256, 200, 128), (3, 64, 36, 32), (17, 128, 384, 64),
    (130, 512, 260, 128), (1, 11008, 512, 128),
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
