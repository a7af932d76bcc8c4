"""Flash attention: the Hopper kernels' wrappers, their plain versions and
the autograd Function that joins them.

Port of ``emmax_tpu/ops/flash_attention.py``. Three hand-written kernels
keep the model layout ``[B, L, H, D]`` and read q/k/v through their
strides, so a layer's view of the KV cache (serving) or of a fused qkv
projection (the towers) is passed without a copy:

- ``csrc/flash_fwd.cu``: the forward (``_flash_fwd``), optionally also
  storing each row's log-sum-exp for the backward;
- ``csrc/flash_bwd.cu``: ``flash_bwd_dq`` (``_dq_kernel``) and
  ``flash_bwd_dkv`` (``_dkv_kernel``), the latter with the fused variant
  that also writes per-kv-tile fp32 dQ partials, summed here as JAX sums
  them.

bf16 inputs run on the tensor cores (``mma.sync`` through
``csrc/mma.cuh``, tiles through ``csrc/tc_tile.cuh``). fp32 inputs run on
them too, forward and backward, in 3xTF32 (each operand split into two
TF32 parts, three products; fp32's accuracy; tiles through
``csrc/tf32_tile.cuh``). Every wrapper counts its launches per dtype as
well (``launches_by``). The bf16 forward rounds each 64-key tile's
unnormalised P to bf16 before P V, as JAX's kernel does per tile (the
plain version rounds the normalised probabilities); the bf16 backward
rounds P to bf16 for dV = P^T dO, where the plain version and JAX keep
it in fp32.

They handle the shapes of the serving and training paths: bidirectional
ViT attention (DINOv2 D=64 over 261 tokens, SigLIP D=72 over 256 tokens;
D is padded on-chip), the cached Llama prefill (queries at slot
``q_offset`` attending causally into the whole cache, ``Lq < S``) and the
fused training sequence (causal, right-padded, ``Lq == S``), each under an
optional [B, S] slot mask. Query rows that see no valid key come out as
exact zeros with ``lse`` at the masking sentinel, as the TPU kernel's
``l == 0`` guard gives, and get zero gradients.

``FlashAttention`` is the counterpart of the ``custom_vjp`` ``_flash``:
its forward keeps the LSE, its backward computes ``di = rowsum(o * do)``
in fp32 and launches the two backward kernels (CUDA tensors) or runs the
plain backward (CPU tensors). Fewer than 8 queries (decode) go to the
plain path, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from emmax_torch.ops.attention import NEG_INF, _dense_mask, xla_attention
from emmax_torch.ops.cuda_build import (CudaKernel, current_stream_ptr,
                                        torch_dtype_code)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("flash_fwd.cu", "emmax_flash_fwd",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                     _I, ctypes.c_float, _I, _P])
_BWD_ARGS = [_P] * 11 + [_I] * 5 + [_P, _I, _I, ctypes.c_float, _I, _I, _P]
DQ_KERNEL = CudaKernel("flash_bwd.cu", "emmax_flash_bwd_dq", _BWD_ARGS,
                       name="flash_bwd_dq")
DKV_KERNEL = CudaKernel("flash_bwd.cu", "emmax_flash_bwd_dkv", _BWD_ARGS,
                        name="flash_bwd_dkv")
MAX_HEAD_DIM = 128
BWD_KV_TILE = 64    # keys per dK/dV block, both dtypes: one fused dQ
                    # partial per tile


# ---------------------------------------------------------------- plain --

def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              kv_mask: Optional[torch.Tensor] = None,
                              causal: bool = False, q_offset: int = 0,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Plain version of the forward kernel: the plain path's arithmetic,
    with exact zeros for query rows that see no valid key."""
    out = xla_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                        q_offset=q_offset, sm_scale=sm_scale)
    mask = _dense_mask(q.shape[1], k.shape[1], kv_mask, causal, q_offset,
                       q.device)
    if mask is None:
        return out
    live = mask.any(dim=-1)[:, 0, :, None, None]          # [B|1, Lq, 1, 1]
    return torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def _masked_scores(q, k, kv_mask, causal, q_offset, scale):
    """fp32 ``q k^T * scale`` [B, H, Lq, S] with masked entries at the
    sentinel, and the dense mask (None when nothing is masked)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _dense_mask(q.shape[1], k.shape[1], kv_mask, causal, q_offset,
                       q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    return s, mask


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if sm_scale is None else sm_scale


def flash_lse_reference(q: torch.Tensor, k: torch.Tensor, *,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False, q_offset: int = 0,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the forward's LSE output: ``m + log(l)`` per query
    row as fp32 [B, Lq, H]; a row with no valid key gets ``m``, the
    masking sentinel (``flash_attention.py:150-153``)."""
    s, mask = _masked_scores(q, k, kv_mask, causal, q_offset,
                             _scale(q, sm_scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    return lse[..., 0].permute(0, 2, 1).contiguous()


def flash_attention_bwd_reference(q, k, v, do, lse, di, *,
                                  kv_mask: Optional[torch.Tensor] = None,
                                  causal: bool = False, q_offset: int = 0,
                                  sm_scale: Optional[float] = None):
    """Plain version of the backward kernels, with their formulas
    (``_dq_kernel``, ``_dkv_kernel``): ``p = exp(s - lse)`` in fp32 with
    masked entries exactly 0; ``ds = p (dp - di) scale`` rounded to the
    inputs' dtype before the dQ and dK products; dV from the fp32 ``p``.
    ``lse`` and ``di`` are fp32 [B, Lq, H]. Returns (dq, dk, dv)."""
    scale = _scale(q, sm_scale)
    s, mask = _masked_scores(q, k, kv_mask, causal, q_offset, scale)
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - di.permute(0, 2, 1)[..., None]) * scale).to(
        q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).to(v.dtype)
    return dq, dk, dv


# -------------------------------------------------------------- kernels --

def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not (dev.type == "cuda" and all(t.device == dev for t in tensors)):
        raise ValueError(f"{name}: q, k, v (and the gradients) must be on "
                         f"one CUDA device")


def _checked_mask(name: str, q, k, v, kv_mask) -> Optional[torch.Tensor]:
    """Validate q [B, Lq, H, D], k/v [B, S, H, D] and kv_mask [B, S];
    returns the mask as contiguous uint8 (or None)."""
    B, Lq, H, D = q.shape
    S = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape != (B, S, H, D):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} > {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{name}: q/k/v need unit stride on D")
    if kv_mask is None:
        return None
    if kv_mask.shape != (B, S) or kv_mask.device != q.device:
        raise ValueError(f"{name}: kv_mask must be [B, S] = {(B, S)} on "
                         f"{q.device}, got {tuple(kv_mask.shape)} on "
                         f"{kv_mask.device}")
    return kv_mask.to(torch.bool).contiguous().view(torch.uint8)


def _bld(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kv_mask: Optional[torch.Tensor] = None,
                         causal: bool = False, q_offset: int = 0,
                         sm_scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch ``csrc/flash_fwd.cu``. q [B, Lq, H, D]; k/v [B, S, H, D]
    (KV heads already repeated), any strides with unit stride on D;
    kv_mask [B, S]. With ``return_lse`` returns (out, lse fp32 [B, Lq, H])."""
    _require_cuda("flash_attention_cuda", q, k, v)
    mask_u8 = _checked_mask("flash_attention_cuda", q, k, v, kv_mask)
    if q_offset < 0:
        raise ValueError(f"flash_attention_cuda: q_offset={q_offset} < 0")
    B, Lq, H, D = q.shape
    S = k.shape[1]
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Lq, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 13)(*_bld(q), *_bld(k), *_bld(v),
                                       *_bld(out), S)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  mask_u8.data_ptr() if mask_u8 is not None else None,
                  out.data_ptr(), lse.data_ptr() if return_lse else None,
                  B, H, Lq, S, D, ctypes.cast(strides, ctypes.c_void_p),
                  int(causal), int(q_offset), float(_scale(q, sm_scale)),
                  torch_dtype_code(q.dtype), current_stream_ptr(q.device),
                  variant=str(q.dtype).removeprefix("torch."))
    return (out, lse) if return_lse else out


def bwd_launch_args(q, k, v, do, lse, di, *,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, q_offset: int = 0,
                    sm_scale: Optional[float] = None, fused: bool = False):
    """Check the backward's inputs and allocate its outputs: returns the
    C entry points' argument tuple (shared by ``DQ_KERNEL`` and
    ``DKV_KERNEL``) and (dq, dk, dv, fp32 dQ partials or None)."""
    name = "flash_attention_bwd_cuda"
    _require_cuda(name, q, k, v, do, lse, di)
    mask_u8 = _checked_mask(name, q, k, v, kv_mask)
    B, Lq, H, D = q.shape
    S = k.shape[1]
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(3) != 1:
        raise ValueError(f"{name}: do must match q {tuple(q.shape)} "
                         f"{q.dtype} with unit stride on D, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for t, what in ((lse, "lse"), (di, "di")):
        if (t.dtype != torch.float32 or t.shape != (B, Lq, H)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous float32 "
                             f"{(B, Lq, H)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset={q_offset} < 0")
    dq = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=q.device)
    part = (torch.empty((-(-S // BWD_KV_TILE), B, Lq, H, D),
                        dtype=torch.float32, device=q.device)
            if fused else None)
    strides = (ctypes.c_longlong * 22)(*_bld(q), *_bld(k), *_bld(v),
                                       *_bld(do), *_bld(dq), *_bld(dk),
                                       *_bld(dv), S)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(),
            mask_u8.data_ptr() if mask_u8 is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            part.data_ptr() if fused else None, B, H, Lq, S, D,
            ctypes.cast(strides, ctypes.c_void_p), int(causal),
            int(q_offset), float(_scale(q, sm_scale)),
            torch_dtype_code(q.dtype), int(fused),
            current_stream_ptr(q.device))
    # the mask and strides must outlive the launches
    return (args, (mask_u8, strides)), (dq, dk, dv, part)


def flash_attention_bwd_cuda(q, k, v, do, lse, di, *,
                             kv_mask: Optional[torch.Tensor] = None,
                             causal: bool = False, q_offset: int = 0,
                             sm_scale: Optional[float] = None,
                             fused: bool = False):
    """Launch ``csrc/flash_bwd.cu``: ``flash_bwd_dq`` then
    ``flash_bwd_dkv``, or, with ``fused``, only ``flash_bwd_dkv`` writing
    fp32 dQ partials [ceil(S / 64), B, Lq, H, D] that are summed here.
    ``do`` has q's shape and dtype (unit stride on D); ``lse`` and ``di``
    are contiguous fp32 [B, Lq, H]. Returns (dq, dk, dv), contiguous."""
    (args, _keep), (dq, dk, dv, part) = bwd_launch_args(
        q, k, v, do, lse, di, kv_mask=kv_mask, causal=causal,
        q_offset=q_offset, sm_scale=sm_scale, fused=fused)
    variant = str(q.dtype).removeprefix("torch.")
    if not fused:
        DQ_KERNEL.launch(*args, variant=variant)
    DKV_KERNEL.launch(*args, variant=variant)
    if fused:
        dq = part.sum(dim=0).to(q.dtype)
    return dq, dk, dv


# ------------------------------------------------------------- autograd --

class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward, the counterpart of the JAX
    package's ``custom_vjp`` ``_flash`` (``flash_attention.py:469-492``).
    CUDA tensors go through the kernels, CPU tensors through the plain
    versions; ``fused_bwd`` picks the dK/dV kernel's fused dQ partials
    over the separate dQ kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, q_offset, sm_scale,
                fused_bwd):
        kw = dict(kv_mask=kv_mask, causal=causal, q_offset=q_offset,
                  sm_scale=sm_scale)
        if q.is_cuda:
            out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        else:
            out = flash_attention_reference(q, k, v, **kw)
            lse = flash_lse_reference(q, k, **kw)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.opts = (causal, q_offset, sm_scale, fused_bwd)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        causal, q_offset, sm_scale, fused = ctx.opts
        if do.stride(-1) != 1:
            do = do.contiguous()
        di = (out.float() * do.float()).sum(dim=-1)           # [B, Lq, H]
        kw = dict(kv_mask=kv_mask, causal=causal, q_offset=q_offset,
                  sm_scale=sm_scale)
        if q.is_cuda:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, do, lse, di,
                                                  fused=fused, **kw)
        else:
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, do, lse, di,
                                                       **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, q_offset: int = 0,
                    sm_scale: Optional[float] = None,
                    fused_bwd: bool = False) -> torch.Tensor:
    """Flash attention in model layout q [B, Lq, H, D], k/v [B, S, H, D]
    (KV heads already repeated for GQA); kv_mask [B, S] bool.
    ``sm_scale`` defaults to ``D ** -0.5``.

    CUDA tensors launch the kernels; CPU tensors take their plain
    versions. Where a gradient is wanted the call goes through
    :class:`FlashAttention`, which keeps the LSE for the backward.
    """
    if q.shape[1] < 8:  # decode: memory-bound, the plain path streams once
        return xla_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                             q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, kv_mask, causal, q_offset,
                                    sm_scale, fused_bwd)
    fn = flash_attention_cuda if q.is_cuda else flash_attention_reference
    return fn(q, k, v, kv_mask=kv_mask, causal=causal, q_offset=q_offset,
              sm_scale=sm_scale)

