"""Rotary position embeddings (Llama "rotate_half"), port of
``emmax_tpu/ops/rope.py``: frequencies ``theta^(-2i/d)``, cos/sin in fp32,
applied as ``x*cos + rotate_half(x)*sin``. Phi-2 rotates only the first
``rotary_dim`` channels of each head (``apply_partial_rope``, the JAX
package's ``models/phi._apply_partial_rope``).
"""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0):
    """positions [..., L] int -> (cos, sin) each [..., L, head_dim] fp32."""
    exponent = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim)
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * inv_freq        # [..., L, hd/2]
    angles = torch.cat([angles, angles], dim=-1)            # [..., L, hd]
    return torch.cos(angles), torch.sin(angles)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., L, n_heads, head_dim]; cos/sin [..., L, head_dim]."""
    dtype = x.dtype
    xf = x.float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return (xf * c + rotate_half(xf) * s).to(dtype)


def apply_partial_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                       rotary_dim: int) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` channels of each head in fp32 and
    pass the rest through; cos/sin [..., L, rotary_dim] come from
    ``rope_cos_sin(positions, rotary_dim)``."""
    rot = apply_rope(x[..., :rotary_dim], cos, sin)
    return torch.cat([rot, x[..., rotary_dim:]], dim=-1)
