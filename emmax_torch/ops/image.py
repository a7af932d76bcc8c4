"""Image preprocessing on tensors, port of ``emmax_tpu/ops/image.py``.

Inputs are uint8 (or float in [0, 255]) channels-last ``[..., H, W, 3]``;
outputs are normalized float32 ``[..., size, size, 3]`` on the input's
device.

The resize reproduces ``jax.image.resize(..., method="bicubic")``: a Keys
cubic kernel with a = -0.5, widened by the scale factor when downsampling
(antialiasing), with each output's weights renormalised to sum to one.
``torch.nn.functional.interpolate`` uses a = -0.75 and other edge handling,
so the two separable weight matrices are built here the way JAX builds
them and applied as two matmuls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ImageTransformConfig:
    size: int = 224
    resize_strategy: str = "resize-naive"   # resize-naive | resize-crop | letterbox
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    interpolation: str = "bicubic"


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_fill_lanczos_kernel`` with radius 3 (TF's Lanczos3)."""
    radius = 3.0
    y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, np.pi ** 2 * x * x,
                                                torch.ones_like(x)),
                      torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


_KERNELS = {"bicubic": _keys_cubic, "lanczos3": _lanczos3}


def resize_weights(in_size: int, out_size: int, device: torch.device,
                   kernel: str = "bicubic") -> torch.Tensor:
    """``[in_size, out_size]`` float32 weights (JAX's
    ``compute_weight_mat`` with antialiasing and zero translation) of the
    Keys cubic (a = -0.5) or the Lanczos3 kernel."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32,
                                          device=device)[:, None]).abs()
    weights = _KERNELS[kernel](x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize(img: torch.Tensor, h: int, w: int, method: str) -> torch.Tensor:
    """Bicubic resize of ``[..., H, W, C]`` float32 to ``[..., h, w, C]``."""
    if method not in ("bicubic", "cubic"):
        raise ValueError(f"unsupported interpolation {method!r}")
    H, W = img.shape[-3], img.shape[-2]
    if H != h:
        wh = resize_weights(H, h, img.device)
        img = torch.einsum("...hwc,hy->...ywc", img, wh)
    if W != w:
        ww = resize_weights(W, w, img.device)
        img = torch.einsum("...hwc,wx->...hxc", img, ww)
    return img


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img - mean) / std


def apply_transform(img: torch.Tensor,
                    cfg: ImageTransformConfig) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> normalized float32 [..., size, size, 3]."""
    img = img.to(torch.float32) / 255.0
    H, W = img.shape[-3], img.shape[-2]
    s = cfg.size
    if cfg.resize_strategy == "resize-naive":
        img = _resize(img, s, s, cfg.interpolation)
    elif cfg.resize_strategy == "resize-crop":
        # torchvision semantics: Resize truncates the long side and
        # CenterCrop offsets with int(round(diff / 2))
        if H < W:
            nh, nw = s, max(int(W * s / H), s)
        else:
            nh, nw = max(int(H * s / W), s), s
        img = _resize(img, nh, nw, cfg.interpolation)
        top, left = int(round((nh - s) / 2)), int(round((nw - s) / 2))
        img = img[..., top:top + s, left:left + s, :]
    elif cfg.resize_strategy == "letterbox":
        # symmetric border of int(diff / 2) per side, filled with the
        # uint8-quantized mean (the reference pads in uint8 space)
        ph = int((max(H, W) - H) / 2)
        pw = int((max(H, W) - W) / 2)
        fill = torch.tensor([int(float(m) * 255) / 255.0 for m in cfg.mean],
                            dtype=torch.float32, device=img.device)
        padded = fill.expand(*img.shape[:-3], H + 2 * ph, W + 2 * pw,
                             3).clone()
        padded[..., ph:ph + H, pw:pw + W, :] = img
        img = _resize(padded, s, s, cfg.interpolation)
    else:
        raise ValueError(f"unknown resize strategy {cfg.resize_strategy!r}")
    return normalize(img, cfg.mean, cfg.std)


def dinosiglip_transform_configs(size: int = 224,
                                 resize_strategy: str = "resize-naive"
                                 ) -> Dict[str, ImageTransformConfig]:
    """The Emma-X dual-tower transform: one image, two normalizations."""
    return {
        "dino": ImageTransformConfig(size, resize_strategy,
                                     IMAGENET_MEAN, IMAGENET_STD),
        "siglip": ImageTransformConfig(size, resize_strategy,
                                       SIGLIP_MEAN, SIGLIP_STD),
    }


def transform_configs_for_backbone(vision_backbone_id: str,
                                   resize_strategy: str,
                                   size: int = 224
                                   ) -> Dict[str, ImageTransformConfig]:
    """Per-tower transforms for every Prismatic vision backbone id (the
    size from the id: 336 for the CLIP-336 and DINO + CLIP-336 towers, 384
    for the 384 px towers). The JAX package gives DINO + CLIP-336 224 px
    images, which its 336 px towers cannot take."""
    if vision_backbone_id.startswith("dinosiglip"):
        size = 384 if "384" in vision_backbone_id else size
        return dinosiglip_transform_configs(size, resize_strategy)
    if vision_backbone_id.startswith("dinoclip"):
        size = 336 if "336" in vision_backbone_id else size
        return {"dino": ImageTransformConfig(size, resize_strategy,
                                             IMAGENET_MEAN, IMAGENET_STD),
                "clip": ImageTransformConfig(size, resize_strategy,
                                             CLIP_MEAN, CLIP_STD)}
    if vision_backbone_id.startswith("clip"):
        size = 336 if "336" in vision_backbone_id else size
        return {"clip": ImageTransformConfig(size, resize_strategy,
                                             CLIP_MEAN, CLIP_STD)}
    if vision_backbone_id.startswith("siglip"):
        size = 384 if "384" in vision_backbone_id else size
        return {"siglip": ImageTransformConfig(size, resize_strategy,
                                               SIGLIP_MEAN, SIGLIP_STD)}
    if vision_backbone_id.startswith("dinov2"):
        return {"dino": ImageTransformConfig(size, resize_strategy,
                                             IMAGENET_MEAN, IMAGENET_STD)}
    if vision_backbone_id.startswith("in1k"):
        return {"in1k": ImageTransformConfig(size, resize_strategy,
                                             IMAGENET_MEAN, IMAGENET_STD)}
    raise KeyError(f"unknown vision backbone {vision_backbone_id!r}")


def preprocess_for_towers(img: torch.Tensor,
                          configs: Dict[str, ImageTransformConfig]
                          ) -> Dict[str, torch.Tensor]:
    return {name: apply_transform(img, cfg) for name, cfg in configs.items()}
