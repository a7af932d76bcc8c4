"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Replaces the upstream Pallas TPU kernel
``jax.experimental.pallas.ops.tpu.paged_attention``, which
``emmax_tpu/serving/paged.py`` calls under ``paged_attn="kernel"``. Same
function: one query token per row attends over that row's pages.

- ``q`` [B, H, hd] (fp32 or bf16), already multiplied by ``hd ** -0.5``:
  the function applies no score scale, as the upstream kernel does not;
- ``k_pages`` / ``v_pages`` [KV, P, ps, hd] in fp32, bf16 or int8; int8
  pages come with fp32 per-row scales ``k_scale`` / ``v_scale``
  [KV, P, ps, 1] and decode as ``int8 * scale / 127.5``;
- ``lengths`` [B] int32 (tokens past a row's length are masked) and
  ``page_indices`` [B, MP] int32 global page ids, token ``t`` of row ``b``
  at offset ``t % ps`` of page ``page_indices[b, t // ps]``; ids are
  clamped into ``[0, P)``, as an XLA gather clamps them;
- query head ``k * G + g`` reads KV head ``k``; the output [B, H, hd] is
  in q's dtype, and a row of length 0 gives zeros.

``paged_attention`` launches ``csrc/paged_attention.cu`` for CUDA tensors
and runs the plain version for CPU tensors. The kernel splits each row's
page table into ``splits(MP, ps)`` ranges of pages (flash-decoding): each
range's fp32 partial (max, sum, accumulator) goes to a workspace taken
here beside the output, and a second kernel merges them in range order, so
one call launches two kernels (and counts one). The split count depends
on the shapes only, never on the lengths, so a call can be captured in a
CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from emmax_torch.ops.cuda_build import (CudaKernel, current_stream_ptr,
                                        torch_dtype_code)

MAX_INT8 = 127.5            # quantization_utils.MAX_INT8 of the TPU kernel
MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
MAX_HEAD_DIM = 128
SPLIT_TOKENS = 128          # a split's pages hold at least this many tokens
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("paged_attention.cu", "emmax_paged_attention",
                    [_P] * 9 + [_I] * 10 + [_P])


def split_pages(page_size: int) -> int:
    """Pages in one of the kernel's page ranges: ``max(1, 128 //
    page_size)``."""
    return max(1, SPLIT_TOKENS // page_size)


def splits(max_pages: int, page_size: int) -> int:
    """The kernel's number of page ranges per row over a table of
    ``max_pages``; it depends on the shapes only. The kernel works it out
    the same way; here it sizes the workspace."""
    return -(-max_pages // split_pages(page_size))


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, lengths: torch.Tensor,
                              page_indices: torch.Tensor, *,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version: gather each row's pages, dequantize, mask at the
    length, fp32 softmax (no score scale), fp32 products."""
    B, H, hd = q.shape
    kv, P, ps, _ = k_pages.shape
    S = page_indices.shape[1] * ps
    ids = page_indices.long().clamp(0, P - 1)            # [B, MP]

    def rows(pages, scale):
        g = pages[:, ids].float()                         # [KV, B, MP, ps, hd]
        if scale is not None:
            g = g * scale[:, ids].float() / MAX_INT8
        return g.reshape(kv, B, S, hd)

    k = rows(k_pages, k_scale)
    v = rows(v_pages, v_scale)
    q2 = q.float().reshape(B, kv, H // kv, hd)
    s = torch.einsum("bkgd,kbsd->bkgs", q2, k)
    valid = (torch.arange(S, device=q.device)[None]
             < lengths.to(q.device)[:, None])            # [B, S]
    s = s.masked_fill(~valid[:, None, None], MASK_VALUE)
    out = torch.einsum("bkgs,kbsd->bkgd", torch.softmax(s, dim=-1), v)
    out = torch.where((lengths.to(q.device) > 0)[:, None, None, None], out,
                      0.0)
    return out.reshape(B, H, hd).to(q.dtype)


def _require_cuda(name: str, tensors) -> None:
    dev = tensors[0].device
    if not (dev.type == "cuda" and all(t.device == dev for t in tensors)):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, lengths: torch.Tensor,
                         page_indices: torch.Tensor, *,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` (shapes and types as in the
    module docstring); raises on anything the kernel does not take."""
    name = "paged_attention_cuda"
    tensors = [q, k_pages, v_pages, lengths, page_indices]
    quantized = k_pages.dtype == torch.int8
    if quantized:
        if k_scale is None or v_scale is None:
            raise ValueError(f"{name}: int8 pages need k_scale and v_scale")
        tensors += [k_scale, v_scale]
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"{name}: scales are for int8 pages only")
    _require_cuda(name, tensors)
    dev = q.device
    B, H, hd = q.shape
    kv, P, ps, hd_k = k_pages.shape
    if (v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype
            or hd_k != hd or H % kv or lengths.shape != (B,)
            or page_indices.ndim != 2 or page_indices.shape[0] != B):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}, "
                         f"lengths {tuple(lengths.shape)}, page_indices "
                         f"{tuple(page_indices.shape)}")
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} must be a multiple of 8 "
                         f"and at most {MAX_HEAD_DIM}")
    if k_pages.dtype not in _KV_CODES:
        raise TypeError(f"{name}: pages must be float32, bfloat16 or int8, "
                        f"got {k_pages.dtype}")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise TypeError(f"{name}: lengths and page_indices must be int32")
    if quantized and (k_scale.shape != (kv, P, ps, 1)
                      or v_scale.shape != (kv, P, ps, 1)
                      or k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise ValueError(f"{name}: scales must be float32 "
                         f"{(kv, P, ps, 1)}")
    q = q.contiguous()
    tensors = [q, k_pages, v_pages, lengths.contiguous(),
               page_indices.contiguous()] + tensors[5:]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: pages and scales must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors[:3]):
        raise ValueError(f"{name}: q and the pages must be 16-byte aligned")
    MP = page_indices.shape[1]
    out = torch.empty_like(q)
    ws = torch.empty(splits(MP, ps) * B * H * (hd + 2), dtype=torch.float32,
                     device=dev)
    KERNEL.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  k_scale.data_ptr() if quantized else None,
                  v_scale.data_ptr() if quantized else None,
                  tensors[3].data_ptr(), tensors[4].data_ptr(),
                  out.data_ptr(), ws.data_ptr(),
                  B, H, kv, P, ps, MP, hd, split_pages(ps),
                  torch_dtype_code(q.dtype), _KV_CODES[k_pages.dtype],
                  current_stream_ptr(dev))
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    page_indices: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged decode attention (module docstring): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    fn = paged_attention_cuda if q.is_cuda else paged_attention_reference
    return fn(q, k_pages, v_pages, lengths, page_indices, k_scale=k_scale,
              v_scale=v_scale)
