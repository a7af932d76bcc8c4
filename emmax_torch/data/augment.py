"""Per-frame image augmentation on torch tensors, port of
``emmax_tpu/data/augment.py``.

Each op comes in two layers:

- a fixed-parameter op on a float image in [0, 1] (``[H, W, 3]`` or
  ``[N, H, W, 3]``) that computes what TF's op computes:
  ``crop_and_resize`` (``tf.image.crop_and_resize``'s bilinear sampling),
  ``adjust_brightness``, ``adjust_contrast``, ``adjust_saturation`` and
  ``adjust_hue`` (TF's RGB <-> HSV kernels), and the flips;
- a ``random_*`` op that draws those parameters, with the ranges of the
  JAX package's ops, from a ``numpy.random.Generator``.

``augment_image`` keys one generator per op by (frame index,
``augment_seed``, image index, op index): the draws are the port's own,
not TF's stateless Philox streams, and a pipeline's augmentations are a
pure function of those keys. ``OPENVLA_IMAGE_AUGMENT_KWARGS`` is the recipe
Emma-X and OpenVLA train with.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def _batched(image: torch.Tensor):
    return (image[None], True) if image.dim() == 3 else (image, False)


def crop_and_resize(image: torch.Tensor, box: Sequence[float],
                    size: Sequence[int]) -> torch.Tensor:
    """``tf.image.crop_and_resize`` of one normalized box (y1, x1, y2, x2)
    to ``size`` (h, w), bilinear, samples outside the image are 0."""
    img, squeeze = _batched(image.float())
    N, H, W, C = img.shape
    ch, cw = int(size[0]), int(size[1])
    y1, x1, y2, x2 = (torch.tensor(float(v), dtype=torch.float32)
                      for v in box)

    def coords(n, lo, hi, extent):
        i = torch.arange(n, dtype=torch.float32)
        if n > 1:
            scale = (hi - lo) * (extent - 1) / (n - 1)
            return lo * (extent - 1) + i * scale
        return (0.5 * (lo + hi) * (extent - 1)).expand(n)

    ys, xs = coords(ch, y1, y2, H), coords(cw, x1, x2, W)
    y_ok = (ys >= 0) & (ys <= H - 1)
    x_ok = (xs >= 0) & (xs <= W - 1)
    top, left = ys.floor(), xs.floor()
    bottom, right = ys.ceil(), xs.ceil()
    y_lerp = (ys - top)[:, None, None]
    x_lerp = (xs - left)[None, :, None]
    ti, bi = top.long().clamp(0, H - 1), bottom.long().clamp(0, H - 1)
    li, ri = left.long().clamp(0, W - 1), right.long().clamp(0, W - 1)
    out = []
    for n in range(N):
        im = img[n]
        tl, tr = im[ti][:, li], im[ti][:, ri]
        bl, br = im[bi][:, li], im[bi][:, ri]
        t = tl + (tr - tl) * x_lerp
        b = bl + (br - bl) * x_lerp
        v = t + (b - t) * y_lerp
        ok = (y_ok[:, None] & x_ok[None, :])[..., None]
        out.append(torch.where(ok, v, torch.zeros_like(v)))
    out = torch.stack(out)
    return out[0] if squeeze else out


def adjust_brightness(image: torch.Tensor, delta: float) -> torch.Tensor:
    return image + torch.tensor(delta, dtype=image.dtype)


def adjust_contrast(image: torch.Tensor, factor: float) -> torch.Tensor:
    """(x - mean) * factor + mean, the mean per image and channel."""
    mean = image.mean(dim=(-3, -2), keepdim=True)
    return (image - mean) * torch.tensor(factor, dtype=image.dtype) + mean


def _rgb_to_hsv(rgb: torch.Tensor):
    """TF's ``adjust_saturation`` RGB -> HSV (h in [0, 1))."""
    r, g, b = rgb.unbind(-1)
    v = torch.maximum(r, torch.maximum(g, b))
    rng = v - torch.minimum(r, torch.minimum(g, b))
    s = torch.where(v > 0, rng / torch.where(v > 0, v, torch.ones_like(v)),
                    torch.zeros_like(v))
    norm = 1.0 / (6.0 * rng)
    h = torch.where(r == v, norm * (g - b),
                    torch.where(g == v, norm * (b - r) + 2.0 / 6.0,
                                norm * (r - g) + 4.0 / 6.0))
    h = torch.where(rng <= 0.0, torch.zeros_like(h), h)
    h = torch.where(h < 0.0, h + 1, h)
    return h, s, v


def _hsv_to_rgb(h, s, v) -> torch.Tensor:
    c = s * v
    m = v - c
    dh = h * 6
    cat = dh.to(torch.int64)          # truncation, as static_cast<int>
    fmodu = torch.remainder(dh, 2.0)
    x = c * (1 - (fmodu - 1).abs())
    z = torch.zeros_like(c)
    table = [(c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c),
             (c, z, x)]
    rr, gg, bb = z, z, z
    for k, (a, b_, d) in enumerate(table):
        sel = cat == k
        rr = torch.where(sel, a, rr)
        gg = torch.where(sel, b_, gg)
        bb = torch.where(sel, d, bb)
    return torch.stack([rr + m, gg + m, bb + m], -1)


def adjust_saturation(image: torch.Tensor, factor: float) -> torch.Tensor:
    h, s, v = _rgb_to_hsv(image)
    s = (s * factor).clamp(0.0, 1.0)
    return _hsv_to_rgb(h, s, v)


def adjust_hue(image: torch.Tensor, delta: float) -> torch.Tensor:
    """TF's ``adjust_hue``: hue on [0, 6) from the min / mid / max of the
    pixel, shifted by 6 * delta and wrapped."""
    r, g, b = image.unbind(-1)
    rg, br_, bg = r < g, b < r, b > g
    gb = b < g
    brr = b > r
    # h_category and (max, mid, min), as adjust_hue_op.cc's branches
    cat = torch.where(rg, torch.where(br_, 1, torch.where(bg, 3, 2)),
                      torch.where(gb, 0, torch.where(brr, 4, 5)))
    vmax = torch.where(rg, torch.where(br_, g, torch.where(bg, b, g)),
                       torch.where(gb, r, torch.where(brr, b, r)))
    vmid = torch.where(rg, torch.where(br_, r, torch.where(bg, g, b)),
                       torch.where(gb, g, torch.where(brr, r, b)))
    vmin = torch.where(rg, torch.where(br_, b, torch.where(bg, r, r)),
                       torch.where(gb, b, torch.where(brr, g, g)))
    span = vmax - vmin
    flat = span == 0
    ratio = (vmid - vmin) / torch.where(flat, torch.ones_like(span), span)
    increase = (cat & 1) == 0
    h = cat.to(image.dtype) + torch.where(increase, ratio, 1 - ratio)
    h = torch.where(flat, torch.zeros_like(h), h)
    h = h + torch.tensor(delta * 6, dtype=image.dtype)
    h = torch.where(h < 0, h + 6, h)
    h = torch.where(h >= 6, h - 6, h)
    hc = h.to(torch.int64)
    ratio = h - hc.to(h.dtype)
    inc = (hc & 1) == 0
    ratio = torch.where(inc, ratio, 1 - ratio)
    mid = vmin + ratio * (vmax - vmin)
    R = torch.where(hc == 0, vmax, torch.where(hc == 1, mid, torch.where(
        (hc == 2) | (hc == 3), vmin, torch.where(hc == 4, mid, vmax))))
    G = torch.where(hc == 0, mid, torch.where((hc == 1) | (hc == 2), vmax,
                                              torch.where(hc == 3, mid,
                                                          vmin)))
    B = torch.where((hc == 0) | (hc == 1), vmin, torch.where(
        hc == 2, mid, torch.where((hc == 3) | (hc == 4), vmax, mid)))
    return torch.stack([R, G, B], -1)


def flip_left_right(image: torch.Tensor) -> torch.Tensor:
    return image.flip(-2)


def flip_up_down(image: torch.Tensor) -> torch.Tensor:
    return image.flip(-3)


# --- random ops: draw the parameters, then apply ------------------------------

def random_resized_crop(image, scale: Sequence[float],
                        ratio: Sequence[float], rng: np.random.Generator):
    """Random area-scale and log-aspect crop, resized back to the input
    size (torchvision semantics, aspect in pixel space)."""
    H, W = image.shape[-3], image.shape[-2]
    area = np.float32(rng.uniform(scale[0], scale[1] + 1e-9))
    log_ratio = np.float32(rng.uniform(math.log(ratio[0]),
                                       math.log(ratio[1]) + 1e-9))
    aspect = np.exp(log_ratio)
    img_aspect = np.float32(W) / np.float32(H)
    new_h = np.clip(np.sqrt(area * img_aspect / aspect), 0.0, 1.0)
    new_w = np.clip(np.sqrt(area * aspect / img_aspect), 0.0, 1.0)
    off_h = np.float32(rng.uniform()) * (1 - new_h)
    off_w = np.float32(rng.uniform()) * (1 - new_w)
    box = (off_h, off_w, off_h + new_h, off_w + new_w)
    return crop_and_resize(image, box, (H, W)).clamp(0.0, 1.0)


def random_brightness(image, max_delta: float, rng):
    return adjust_brightness(image, rng.uniform(-max_delta, max_delta)
                             ).clamp(0.0, 1.0)


def random_contrast(image, lower: float, upper: float, rng):
    return adjust_contrast(image, rng.uniform(lower, upper)).clamp(0.0, 1.0)


def random_saturation(image, lower: float, upper: float, rng):
    return adjust_saturation(image, rng.uniform(lower, upper)).clamp(0.0,
                                                                     1.0)


def random_hue(image, max_delta: float, rng):
    return adjust_hue(image, rng.uniform(-max_delta, max_delta)).clamp(0.0,
                                                                       1.0)


def random_flip_left_right(image, rng):
    return flip_left_right(image) if rng.uniform() < 0.5 else image


def random_flip_up_down(image, rng):
    return flip_up_down(image) if rng.uniform() < 0.5 else image


# list kwargs are splatted positionally (``random_brightness=[0.2]``), dict
# kwargs as keywords, as in dlimp's convention
AUGMENT_OPS = {
    "random_resized_crop": random_resized_crop,
    "random_brightness": random_brightness,
    "random_contrast": random_contrast,
    "random_saturation": random_saturation,
    "random_hue": random_hue,
    "random_flip_left_right": random_flip_left_right,
    "random_flip_up_down": random_flip_up_down,
}


def to_float(image: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1] (``tf.image.convert_image_dtype``)."""
    return image.to(torch.float32) * torch.tensor(1.0 / 255.0,
                                                  dtype=torch.float32)


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """float in [0, 1] -> uint8, saturating (``convert_image_dtype(...,
    saturate=True)``: scale by 255.5, clip, truncate)."""
    return (image * 255.5).clamp(0.0, 255.0).to(torch.uint8)


def augment_image(image: torch.Tensor, key: Sequence[int], *,
                  augment_order: List[str], **augment_kwargs
                  ) -> torch.Tensor:
    """The ops of ``augment_order`` with their kwargs; op ``i`` draws from
    ``numpy.random.default_rng([*key, i])``. uint8 images go through float
    [0, 1] and come back as uint8."""
    in_dtype = image.dtype
    if in_dtype != torch.float32:
        image = to_float(image)
    for i, name in enumerate(augment_order):
        if name not in AUGMENT_OPS:
            raise ValueError(f"unknown augmentation op: {name}")
        rng = np.random.default_rng([*(int(k) for k in key), i])
        args = augment_kwargs.get(name, [])
        if isinstance(args, dict):
            image = AUGMENT_OPS[name](image, rng=rng, **args)
        elif isinstance(args, (list, tuple)):
            image = AUGMENT_OPS[name](image, *args, rng)
        else:
            image = AUGMENT_OPS[name](image, args, rng)
    if in_dtype != torch.float32:
        image = to_uint8(image)
    return image


OPENVLA_IMAGE_AUGMENT_KWARGS: Dict = dict(
    random_resized_crop=dict(scale=[0.9, 0.9], ratio=[1.0, 1.0]),
    random_brightness=[0.2],
    random_contrast=[0.8, 1.2],
    random_saturation=[0.8, 1.2],
    random_hue=[0.05],
    augment_order=[
        "random_resized_crop",
        "random_brightness",
        "random_contrast",
        "random_saturation",
        "random_hue",
    ],
)
