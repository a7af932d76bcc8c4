"""The port's hand-written CUDA kernels against their plain versions, on
the card. Marked ``cuda``: without a card each test skips.

This file imports no JAX, so it runs where only PyTorch is installed
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, relative to the largest |reference| value: 1e-4 in fp32 (the
same inputs, sums in another order), 2e-2 in bf16 (the kernels keep fp32
where the plain versions round to bf16).
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
