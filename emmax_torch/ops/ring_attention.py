"""Ring attention: context-parallel attention over a mesh axis, port of
``emmax_tpu/ops/ring_attention.py``.

Each rank of the axis holds one block of the sequence, ``[B, L/N, H, D]``
of q, k and v (and ``[B, L/N]`` of the key padding mask). K/V blocks go
round the ring N - 1 times with ``torch.distributed.batch_isend_irecv``
(to the next rank, from the previous one) while each rank merges every
block's attention into an online softmax. Causal masking uses global
positions: a block remembers the rank it came from. The per-block
attention is plain ``einsum`` as in JAX; nothing on the main path calls
this op, in either package.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38


def _block_attn(q, k, v, q_start: int, kv_start: int, kv_mask_blk,
                causal: bool, sm_scale: float):
    """One (q block x kv block) piece: (m [B, H, Lq, 1], p_sum
    [B, H, Lq, 1], pv [B, Lq, H, D]), p taken against the block's max m."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    Lq, Lk = q.shape[1], k.shape[1]
    mask = None
    if causal:
        qi = q_start + torch.arange(Lq, device=q.device)[:, None]
        kj = kv_start + torch.arange(Lk, device=q.device)[None, :]
        mask = (kj <= qi)[None, None]
    if kv_mask_blk is not None:
        km = kv_mask_blk[:, None, None, :]
        mask = km if mask is None else (mask & km)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p_sum = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return m, p_sum, pv


def _rotate(tensors, group, nxt: int, prv: int):
    """Send each tensor to global rank ``nxt`` and receive its
    replacement from ``prv`` (one ring step)."""
    import torch.distributed as dist

    ops, out = [], []
    for t in tensors:
        recv = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, recv, prv, group))
        out.append(recv)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis_name: str = "fsdp",
                   kv_mask: Optional[torch.Tensor] = None,
                   causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """This rank's block of the attention output, ``[B, L/N, H, D]``.

    ``q``/``k``/``v`` are this rank's blocks of the sequence split over
    ``axis_name`` of ``mesh`` (block i holds positions [i L/N,
    (i+1) L/N)); ``kv_mask`` [B, L/N] is its block of the key mask.
    Every rank of the axis calls it.
    """
    import torch.distributed as dist

    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    group = mesh.get_group(axis_name)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    idx = mesh.get_local_rank(axis_name)
    peers = dist.get_process_group_ranks(group)
    nxt, prv = peers[(idx + 1) % n], peers[(idx - 1) % n]
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    q_start = idx * Lq

    m_acc = torch.full((B, H, Lq, 1), float("-inf"), device=q.device)
    l_acc = torch.zeros((B, H, Lq, 1), device=q.device)
    o_acc = torch.zeros((B, Lq, H, D), device=q.device)
    k_blk, v_blk, km_blk = k, v, kv_mask
    for t in range(n):
        src = (idx - t) % n          # the rank this block started on
        m_new, p_sum, pv = _block_attn(q, k_blk, v_blk, q_start, src * Lk,
                                       km_blk, causal, sm_scale)
        m_next = torch.maximum(m_acc, m_new)
        alpha = torch.exp(m_acc - m_next)
        beta = torch.exp(m_new - m_next)
        l_acc = alpha * l_acc + beta * p_sum
        o_acc = (o_acc * alpha.transpose(1, 2)
                 + pv.float() * beta.transpose(1, 2))
        m_acc = m_next
        if t + 1 < n:
            blocks = [k_blk, v_blk] + ([km_blk] if km_blk is not None
                                       else [])
            blocks = _rotate(blocks, group, nxt, prv)
            k_blk, v_blk = blocks[0], blocks[1]
            km_blk = blocks[2] if km_blk is not None else None
    l_safe = torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
    return (o_acc / l_safe.transpose(1, 2)).to(q.dtype)
