"""Flash-attention forward: the Hopper kernel's wrapper and plain version.

Port of ``emmax_tpu/ops/flash_attention.py`` (forward only; the backward
kernels belong to the training slice). The kernel, ``csrc/flash_fwd.cu``,
keeps the model layout ``[B, L, H, D]`` and reads q/k/v through their
strides, so a layer's view of the KV cache is passed without a copy.
It handles the shapes of the serving path:

- bidirectional ViT attention (DINOv2 D=64 over 261 tokens, SigLIP D=72
  over 256 tokens; D is padded on-chip),
- the cached Llama prefill: queries at slot ``q_offset`` attending
  causally into the whole cache (``Lq < S``) under the [B, S] slot mask.

Query rows that see no valid key (the pad rows of a left-padded prompt)
come out as exact zeros, as the TPU kernel's ``l == 0`` guard gives.
Fewer than 8 queries (decode) go to the plain path, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from emmax_torch.ops.attention import _dense_mask, xla_attention
from emmax_torch.ops.cuda_build import (CudaKernel, current_stream_ptr,
                                        torch_dtype_code)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("flash_fwd.cu", "emmax_flash_fwd",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                     ctypes.c_float, _I, _P])
MAX_HEAD_DIM = 128


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              kv_mask: Optional[torch.Tensor] = None,
                              causal: bool = False, q_offset: int = 0,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Plain version of the kernel: the plain path's arithmetic, with
    exact zeros for query rows that see no valid key."""
    out = xla_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                        q_offset=q_offset, sm_scale=sm_scale)
    mask = _dense_mask(q.shape[1], k.shape[1], kv_mask, causal, q_offset,
                       q.device)
    if mask is None:
        return out
    live = mask.any(dim=-1)[:, 0, :, None, None]          # [B|1, Lq, 1, 1]
    return torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kv_mask: Optional[torch.Tensor] = None,
                         causal: bool = False, q_offset: int = 0,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch ``csrc/flash_fwd.cu``. q [B, Lq, H, D]; k/v [B, S, H, D]
    (KV heads already repeated), any strides with unit stride on D;
    kv_mask [B, S]."""
    B, Lq, H, D = q.shape
    S = k.shape[1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda: q, k, v must be on one "
                         "CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention_cuda: q/k/v must share float32 "
                        f"or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape != (B, S, H, D):
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head dim {D} > "
                         f"{MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_cuda: q/k/v need unit stride on D")
    if q_offset < 0:
        raise ValueError(f"flash_attention_cuda: q_offset={q_offset} < 0")
    mask_u8 = None
    if kv_mask is not None:
        if kv_mask.shape != (B, S) or kv_mask.device != q.device:
            raise ValueError(f"flash_attention_cuda: kv_mask must be [B, S]"
                             f" = {(B, S)} on {q.device}, got "
                             f"{tuple(kv_mask.shape)} on {kv_mask.device}")
        mask_u8 = kv_mask.to(torch.bool).contiguous().view(torch.uint8)
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    if sm_scale is None:
        sm_scale = D ** -0.5
    strides = (ctypes.c_longlong * 13)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2), S)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  mask_u8.data_ptr() if mask_u8 is not None else None,
                  out.data_ptr(), B, H, Lq, S, D,
                  ctypes.cast(strides, ctypes.c_void_p), int(causal),
                  int(q_offset), float(sm_scale), torch_dtype_code(q.dtype),
                  current_stream_ptr(q.device))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, q_offset: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention in model layout q [B, Lq, H, D], k/v [B, S, H, D]
    (KV heads already repeated for GQA); kv_mask [B, S] bool.
    ``sm_scale`` defaults to ``D ** -0.5``.

    CUDA tensors launch the kernel; CPU tensors take its plain version.
    """
    if q.shape[1] < 8:  # decode: memory-bound, the plain path streams once
        return xla_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                             q_offset=q_offset)
    fn = flash_attention_cuda if q.is_cuda else flash_attention_reference
    return fn(q, k, v, kv_mask=kv_mask, causal=causal, q_offset=q_offset,
              sm_scale=sm_scale)
