"""Int4 weight-only matmul: quantizers, plain version, Hopper kernel wrapper.

Port of ``emmax_tpu/ops/int4_matmul.py``. The packed format is unchanged,
so a tree quantized by either package runs in the other:

- ``w [..., D, F]`` is quantized in groups of ``group`` input rows that
  share a per-output-channel bf16 scale, ``scale [..., D/group, F]``.
  Levels are mid-rise: stored code ``q in [-8, 7]`` decodes to
  ``(q + 0.5) * scale``. The scale is searched over ``SEARCH_FRACS`` of the
  absmax fit for the least reconstruction error, fitted against the
  bf16-rounded value.
- nibbles are packed half-split: byte ``b[p, f]`` holds row ``p`` in its
  low nibble, stored +8 (unsigned), and row ``p + D/2`` in its high nibble
  (two's complement, so ``(int8)b >> 4`` gives it) -> ``q4 [..., D/2, F]``
  int8.

``int4_matmul`` launches the hand-written kernel ``csrc/int4_matmul.cu``
for CUDA tensors and runs the plain version (dequantize, then matmul) for
CPU tensors. A stacked ``{"q4", "scale", "layer"}`` weight is read through
the view ``q4[layer]``: no per-layer copy is made.

With ``group % 16 == 0`` (every shape the quantizer gives a model) both
dtypes run on the tensor cores: each nibble becomes its exact level
``q + 0.5``, each group's products are summed in fp32 per nibble plane
and scaled per column, as JAX's kernel does. bf16 x takes bf16 MMAs (the
plain version rounds the dequantized weight to bf16 first); fp32 x takes
two TF32 MMAs, x split into big + small parts, which keeps fp32's
accuracy (JAX's Pallas kernel rounds x to bf16; the port holds fp32 x to
JAX's XLA route instead). Other groups run a scalar kernel with fp32
FMAs. Each launch also counts under x's dtype (``KERNEL.launches_by``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict

import numpy as np
import torch

from emmax_torch.ops.cuda_build import (CudaKernel, current_stream_ptr,
                                        torch_dtype_code)

DEFAULT_GROUP = 128
SEARCH_FRACS = tuple(np.linspace(0.55, 1.0, 10))

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("int4_matmul.cu", "emmax_int4_matmul",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])

_BN = 128           # scalar kernel: output columns per block


def _resolve_group(D: int, group: int) -> int:
    if D % 2:
        raise ValueError(f"D={D} not even (cannot split nibble planes)")
    while D % (2 * group) != 0:
        group //= 2
    return group


def _bf16_round_np(x: np.ndarray) -> np.ndarray:
    """float32 -> nearest bf16 (ties to even), returned as float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def quantize_weight_int4_np(w, group: int = DEFAULT_GROUP,
                            search: bool = True) -> Dict[str, np.ndarray]:
    """numpy quantizer: ``[..., D, F]`` -> ``{"q4": int8, "scale": uint16}``.

    ``scale`` holds the bf16 bit patterns (numpy has no bfloat16);
    ``emmax_torch.bridge.params_from_numpy`` turns them into a bf16 tensor.
    The arithmetic is that of the JAX package's numpy quantizer, so the
    bytes are identical.
    """
    w = np.asarray(w, np.float32)
    D = w.shape[-2]
    group = _resolve_group(D, group)
    G = D // group
    grouped = w.reshape(*w.shape[:-2], G, group, w.shape[-1])
    absmax = np.max(np.abs(grouped), axis=-2, keepdims=True)
    base = _bf16_round_np((absmax / 7.5).astype(np.float32))

    def levels(s):
        safe = np.where(s == 0, 1.0, s)
        return np.clip(np.floor(grouped / safe + 8), 0, 15) - 8

    scale = base
    if search:
        best = None
        for c in SEARCH_FRACS:
            s = _bf16_round_np(base * np.float32(c))
            mse = (((levels(s) + 0.5) * s - grouped) ** 2).sum(-2,
                                                               keepdims=True)
            if best is None:
                best, scale = mse, s
            else:
                scale = np.where(mse < best, s, scale)
                best = np.minimum(mse, best)
    q = levels(scale).astype(np.int32).reshape(w.shape)
    lo, hi = q[..., : D // 2, :], q[..., D // 2:, :]
    packed = ((hi << 4) | (lo + 8)).astype(np.int8)
    scale = np.ascontiguousarray(scale.reshape(*w.shape[:-2], G, w.shape[-1]))
    return {"q4": packed, "scale": (scale.view(np.uint32) >> 16)
            .astype(np.uint16)}


def _quantize_2d(w: torch.Tensor, group: int, search: bool):
    """One ``[D, F]`` weight; the torch twin of the numpy arithmetic.

    The candidate errors are summed over the group rows one row at a time:
    numpy reduces a non-innermost axis in that order, and any other order
    (torch's cascade sum, a GPU tree reduction) can flip near-tied
    candidates and change the bytes. Each candidate's error is built in
    place in one weight-sized buffer (no stack of ten fresh tensors: 7B trees
    are quantized with it).
    """
    D, F = w.shape
    G = D // group
    x = w.float().reshape(G, group, F)
    t = torch.empty_like(x)

    def levels(s):
        """clamp(floor(x / s + 8), 0, 15) - 8, into ``t``."""
        safe = torch.where(s == 0, torch.ones_like(s), s)
        torch.div(x, safe, out=t)
        return t.add_(8).floor_().clamp_(0, 15).sub_(8)

    scale = (x.abs().amax(dim=1, keepdim=True) / 7.5).to(
        torch.bfloat16).float()                                  # [G, 1, F]
    if search:
        base, best = scale, None
        for c in SEARCH_FRACS:
            s = (base * float(np.float32(c))).to(torch.bfloat16).float()
            err = levels(s).add_(0.5).mul_(s).sub_(x).square_()
            mse = err[:, 0].clone()
            for r in range(1, group):
                mse.add_(err[:, r])
            if best is None:
                best, scale = mse, s
            else:
                better = (mse < best)[:, None]
                scale = torch.where(better, s, scale)
                best = torch.minimum(mse, best)
    q = levels(scale).to(torch.int32).reshape(D, F)
    lo, hi = q[: D // 2], q[D // 2:]
    packed = ((hi << 4) | (lo + 8)).to(torch.int8)
    return packed, scale.reshape(G, F).to(torch.bfloat16)


def quantize_weight_int4(w: torch.Tensor, group: int = DEFAULT_GROUP,
                         search: bool = True) -> Dict[str, torch.Tensor]:
    """Torch twin of :func:`quantize_weight_int4_np`, on ``w``'s device.

    A stacked ``[L, D, F]`` weight is quantized one layer at a time into
    preallocated outputs, so a 7B tree quantizes on the card without an
    fp32 copy of a whole stacked leaf.
    """
    D, F = w.shape[-2], w.shape[-1]
    group = _resolve_group(D, group)
    lead = w.shape[:-2]
    flat = w.reshape(-1, D, F)
    q4 = torch.empty((flat.shape[0], D // 2, F), dtype=torch.int8,
                     device=w.device)
    scale = torch.empty((flat.shape[0], D // group, F), dtype=torch.bfloat16,
                        device=w.device)
    for i in range(flat.shape[0]):
        q4[i], scale[i] = _quantize_2d(flat[i], group, search)
    return {"q4": q4.reshape(*lead, D // 2, F),
            "scale": scale.reshape(*lead, D // group, F)}


def dequantize_weight_int4(qw: Dict[str, torch.Tensor],
                           dtype=torch.float32) -> torch.Tensor:
    """Unpack to ``[..., D, F]``: level ``q`` means ``(q + 0.5) * scale``."""
    b = qw["q4"].to(torch.int32)
    scale = qw["scale"]
    group = (2 * b.shape[-2]) // scale.shape[-2]
    lo = ((b & 15) - 8).float()
    hi = (b >> 4).float()
    w = torch.cat([lo, hi], dim=-2) + 0.5
    return (w * scale.float().repeat_interleave(group, dim=-2)).to(dtype)


def int4_matmul_reference(x2d: torch.Tensor, q4: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: dequantize, then one matmul."""
    w = dequantize_weight_int4({"q4": q4, "scale": scale}, dtype=x2d.dtype)
    return x2d @ w


def _launch_shape(M: int, F: int, g_half: int, sm_count: int,
                  tensor_cores: bool = False, tf32: bool = False):
    """(rows of x per block or warp, groups per split, splits) for the
    kernel's grid: the groups are split (split-K) until the units fill the
    card, which decode's few column tiles alone do not.

    Scalar kernel: a block of 128 columns and ``mt`` rows of x is a unit,
    about two per SM. bf16 tensor cores: a warp is a unit, of 64 columns
    and 8 rows of x (M <= 8) or 32 columns and 32 rows, about ten per SM
    (the fastest of the splits timed on an H100 at the Llama-2-7B shapes).
    TF32 tensor cores (``tf32``, fp32 x): at M <= 8 the same warp units,
    four neighbouring ones in a block sharing its 8 rows of x; above, a
    block of 4 warps sharing 32 rows of x is a unit, of 128 columns, about
    two per SM."""
    if tensor_cores and tf32 and M > 8:
        mt = 32
        units = -(-F // 128) * -(-M // mt)
        target = 2 * sm_count
    elif tensor_cores:
        mt = 8 if M <= 8 else 32
        units = -(-F // (64 if mt == 8 else 32)) * -(-M // mt)
        target = 10 * sm_count
    else:
        mt = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
        units = -(-F // _BN) * -(-M // mt)
        target = 2 * sm_count
    splits = max(1, min(g_half, -(-target // units)))
    gps = -(-g_half // splits)
    return mt, gps, -(-g_half // gps)


def _require_cuda(x2d, q4, scale) -> None:
    if not (x2d.is_cuda and q4.device == x2d.device
            and scale.device == x2d.device):
        raise ValueError("int4_matmul_cuda: x, q4 and scale must be on one "
                         "CUDA device")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, asked once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def int4_matmul_cuda(x2d: torch.Tensor, q4: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/int4_matmul.cu`` on ``x2d [M, D] @ dequant(q4, scale)``.

    ``q4 [D/2, F]`` int8 and ``scale [G, F]`` bf16 may be views of one
    layer of a stacked tensor; each must be contiguous.
    """
    M, D = x2d.shape
    D2, F = q4.shape
    G = scale.shape[0]
    _require_cuda(x2d, q4, scale)
    if q4.dtype != torch.int8 or scale.dtype != torch.bfloat16:
        raise TypeError(f"int4_matmul_cuda: q4 must be int8 and scale bf16, "
                        f"got {q4.dtype} / {scale.dtype}")
    if D2 * 2 != D or scale.shape[1] != F or D % G or (D // G) * G != D:
        raise ValueError(f"int4_matmul_cuda: shapes x {tuple(x2d.shape)}, "
                         f"q4 {tuple(q4.shape)}, scale {tuple(scale.shape)}")
    group = D // G
    if D2 % group or F % 4:
        raise ValueError(f"int4_matmul_cuda: needs D/2 % group == 0 and "
                         f"F % 4 == 0 (D={D}, group={group}, F={F})")
    if not (x2d.is_contiguous() and q4.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("int4_matmul_cuda: x, q4 and scale must be "
                         "contiguous")
    out = torch.empty((M, F), dtype=x2d.dtype, device=x2d.device)
    if M == 0:
        return out
    # bf16 x on the bf16 tensor-core kernel, fp32 x on the TF32 one; the
    # scalar kernel only where the group is not a multiple of 16
    tensor_cores = group % 16 == 0
    if tensor_cores and (q4.data_ptr() % 4 or scale.data_ptr() % 8):
        raise ValueError("int4_matmul_cuda: q4 must be 4-byte and scale "
                         "8-byte aligned")
    if tensor_cores and x2d.data_ptr() % 16:
        x2d = x2d.clone()       # the kernels copy x in aligned runs
    mt, gps, splits = _launch_shape(M, F, D2 // group, _sm_count(x2d.device),
                                    tensor_cores,
                                    tf32=x2d.dtype == torch.float32)
    part = (torch.empty((splits, M, F), dtype=torch.float32,
                        device=x2d.device) if splits > 1 else None)
    KERNEL.launch(x2d.data_ptr(), q4.data_ptr(), scale.data_ptr(),
                  part.data_ptr() if part is not None else None,
                  out.data_ptr(), M, D, F, group, gps, mt,
                  torch_dtype_code(x2d.dtype),
                  current_stream_ptr(x2d.device),
                  variant=str(x2d.dtype).removeprefix("torch."))
    return out


def int4_matmul(x: torch.Tensor, qw: Dict[str, Any]) -> torch.Tensor:
    """``x [..., D] @ dequant(qw) -> [..., F]``.

    ``qw`` is ``{"q4", "scale"}`` or the stacked ``{"q4", "scale",
    "layer"}`` form. CUDA tensors go through the kernel, CPU tensors
    through the plain version.
    """
    q4, scale = qw["q4"], qw["scale"]
    if "layer" in qw:
        q4, scale = q4[qw["layer"]], scale[qw["layer"]]
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x2d.is_cuda:
        out = int4_matmul_cuda(x2d.contiguous(), q4, scale)
    else:
        out = int4_matmul_reference(x2d, q4, scale)
    return out.reshape(*lead, out.shape[-1])
