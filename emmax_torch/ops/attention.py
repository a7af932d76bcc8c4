"""Attention dispatch: the plain PyTorch path and the flash kernel.

Port of ``emmax_tpu/ops/attention.py``. The model passes structured mask
information (``kv_mask`` [B, S] slot validity, ``causal``, and a scalar
``q_offset``: the cache slot of the first query) rather than a dense mask,
so the kernel can build masks per tile and skip tiles above the diagonal.
Per-row offsets and chunk masks belong to later serving engines.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38  # large negative for masking (fits bf16/fp32)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _dense_mask(q_len: int, kv_len: int, kv_mask: Optional[torch.Tensor],
                causal: bool, q_offset: int,
                device: torch.device) -> Optional[torch.Tensor]:
    """[B or 1, 1, q_len, kv_len] bool (True = attend)."""
    mask = None
    if causal:
        qi = torch.arange(q_len, device=device)[:, None] + q_offset
        kj = torch.arange(kv_len, device=device)
        mask = (kj[None, :] <= qi)[None, None]
    if kv_mask is not None:
        km = kv_mask[:, None, None, :].bool()
        mask = km if mask is None else (mask & km)
    return mask


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  kv_mask: Optional[torch.Tensor] = None,
                  causal: bool = False, q_offset: int = 0,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """The plain path: q [B, Lq, H, hd]; k/v [B, Lk, KVH, hd].

    Logits and softmax in fp32, probabilities cast to ``q.dtype`` before
    the PV product, as the JAX package's XLA path does. A fully-masked
    query row gets the average of v (softmax over equal sentinels).
    """
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _dense_mask(q.shape[1], k.shape[1], kv_mask, causal, q_offset,
                       q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def resolve_attn_impl(impl: str, x: torch.Tensor) -> str:
    """"auto" -> "cuda" for CUDA tensors, "torch" otherwise."""
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kv_mask: Optional[torch.Tensor] = None,
                         causal: bool = False, q_offset: int = 0,
                         impl: str = "auto") -> torch.Tensor:
    """Unified attention entry point.

    ``impl``: "torch" (the plain path), "cuda" (``flash_attention``: the
    kernels for CUDA tensors, their plain versions for CPU tensors),
    "cuda_fused" (the same forward; the backward folds dQ into the dK/dV
    kernel as fp32 partials, the counterpart of "pallas_fused") or "auto".
    """
    impl = resolve_attn_impl(impl, q)
    if impl == "torch":
        return xla_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                             q_offset=q_offset)
    if impl in ("cuda", "cuda_fused"):
        from emmax_torch.ops.flash_attention import flash_attention

        n_rep = q.shape[2] // k.shape[2]
        return flash_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                               kv_mask=kv_mask, causal=causal,
                               q_offset=q_offset,
                               fused_bwd=impl == "cuda_fused")
    raise ValueError(f"unknown attention impl {impl!r}")
