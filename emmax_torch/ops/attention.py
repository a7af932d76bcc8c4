"""Attention dispatch: the plain PyTorch path and the flash kernel.

Port of ``emmax_tpu/ops/attention.py``. The model passes structured mask
information (``kv_mask`` [B, S] slot validity, ``causal``, and
``q_offset``: the cache slot of the first query) rather than a dense mask,
so the kernel can build masks per tile and skip tiles above the diagonal.
``q_offset`` is a scalar, or a per-row [B] tensor for the batched engines
whose rows sit at their own cache cursors; per-row offsets take the plain
path, as in the JAX package. A ``chunk_mask`` (the speculative engine's
verification tree) replaces the causal relation inside the chunk and
always takes the plain path.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -2.3819763e38  # large negative for masking (fits bf16/fp32)
Offset = Union[int, torch.Tensor]


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def per_row(q_offset: Offset) -> bool:
    """Whether ``q_offset`` holds one cursor per row."""
    return isinstance(q_offset, torch.Tensor) and q_offset.ndim > 0


def _dense_mask(q_len: int, kv_len: int, kv_mask: Optional[torch.Tensor],
                causal: bool, q_offset: Offset, device: torch.device,
                chunk_mask: Optional[torch.Tensor] = None
                ) -> Optional[torch.Tensor]:
    """[B or 1, 1, q_len, kv_len] bool (True = attend). ``q_offset`` is a
    scalar or a per-row [B] tensor.

    ``chunk_mask`` ([q_len, q_len] bool) replaces the causal relation for
    the q_len tokens at cache slots [q_offset, q_offset + q_len): query i
    attends every past slot (< q_offset) and chunk slot j iff
    ``chunk_mask[i, j]``, the ancestor matrix of a speculative
    verification tree (each root-to-leaf path is verified as its own
    causal continuation in one forward)."""
    mask = None
    if chunk_mask is not None:
        qo = (q_offset.to(device) if per_row(q_offset)
              else torch.tensor([q_offset], device=device))        # [B|1]
        kj = torch.arange(kv_len, device=device)
        rel = kj[None, :] - qo[:, None]                            # [B, kv]
        in_chunk = (rel >= 0) & (rel < q_len)
        cm = chunk_mask.to(device=device, dtype=torch.bool)[
            :, torch.clamp(rel, 0, q_len - 1)].permute(1, 0, 2)  # [B, q, kv]
        allowed = torch.where(in_chunk[:, None, :], cm,
                              (rel < 0)[:, None, :])
        mask = allowed[:, None]
    elif causal:
        kj = torch.arange(kv_len, device=device)
        if per_row(q_offset):
            qi = (q_offset.to(device)[:, None]
                  + torch.arange(q_len, device=device)[None, :])  # [B, Lq]
            mask = (kj[None, None, :] <= qi[:, :, None])[:, None]
        else:
            qi = torch.arange(q_len, device=device)[:, None] + q_offset
            mask = (kj[None, :] <= qi)[None, None]
    if kv_mask is not None:
        km = kv_mask[:, None, None, :].bool()
        mask = km if mask is None else (mask & km)
    return mask


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  kv_mask: Optional[torch.Tensor] = None,
                  causal: bool = False, q_offset: Offset = 0,
                  sm_scale: Optional[float] = None,
                  chunk_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain path: q [B, Lq, H, hd]; k/v [B, Lk, KVH, hd];
    ``chunk_mask`` as in :func:`_dense_mask`.

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
                       q.device, chunk_mask)
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
                         causal: bool = False, q_offset: Offset = 0,
                         impl: str = "auto",
                         chunk_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Unified attention entry point.

    ``impl``: "torch" (the plain path), "cuda" (``flash_attention``: the
    kernels for CUDA tensors, their plain versions for CPU tensors),
    "cuda_fused" (the same forward; the backward folds dQ into the dK/dV
    kernel as fp32 partials, the counterpart of "pallas_fused") or "auto".
    A per-row ``q_offset`` and a ``chunk_mask`` (speculative tree
    verification, see :func:`_dense_mask`) take the plain path under every
    impl, as the JAX package sends them to XLA.
    """
    impl = resolve_attn_impl(impl, q)
    if impl == "torch" or chunk_mask is not None or (
            impl in ("cuda", "cuda_fused") and per_row(q_offset)):
        return xla_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                             q_offset=q_offset, chunk_mask=chunk_mask)
    if impl in ("cuda", "cuda_fused"):
        from emmax_torch.ops.flash_attention import flash_attention

        n_rep = q.shape[2] // k.shape[2]
        return flash_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                               kv_mask=kv_mask, causal=causal,
                               q_offset=q_offset,
                               fused_bwd=impl == "cuda_fused")
    raise ValueError(f"unknown attention impl {impl!r}")
