"""Vision transformers (DINOv2 with registers, SigLIP), port of
``emmax_tpu/models/vit.py``.

- patch embedding is a reshape plus one matmul (a stride-p convolution);
- the feature contract is TIMM's ``get_intermediate_layers(n={depth-2})``:
  blocks ``0 .. depth-2`` run (the last one is skipped), no final norm,
  class and register tokens stripped;
- DINOv2's embedding order: pos-embed over [cls | patches], registers
  spliced in after the pos add;
- layer norm statistics in fp32, exact GELU (DINOv2) or tanh GELU (SigLIP);
- dtypes follow JAX's promotion: f32 pixels against bf16 weights run the
  tower in f32 (each weight is upcast where it is used);
- under a ``mesh`` the params are this rank's blocks and each block's
  weights (and the patch-embedding kernel) are gathered where they are
  used (``parallel/gather.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from emmax_torch.models.tree import ParamTree
from emmax_torch.ops.attention import multi_head_attention
from emmax_torch.ops.norms import layer_norm
from emmax_torch.parallel.constraints import constrain_batch_sharded
from emmax_torch.parallel.gather import gather, gather_tree, layer_blocks

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 14
    dim: int = 1024
    depth: int = 24
    n_heads: int = 16
    hidden_dim: int = 4096
    class_token: bool = True
    num_reg_tokens: int = 0
    layerscale: bool = False
    ls_init: float = 1e-5
    gelu_tanh: bool = False        # SigLIP uses gelu_pytorch_tanh
    norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_prefix(self) -> int:
        return int(self.class_token) + self.num_reg_tokens

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


# The two Emma-X towers (dinosiglip-vit-so-224px).
DINOV2_L_REG4 = ViTConfig(dim=1024, depth=24, n_heads=16, hidden_dim=4096,
                          class_token=True, num_reg_tokens=4, layerscale=True)
SIGLIP_SO400M = ViTConfig(dim=1152, depth=27, n_heads=16, hidden_dim=4304,
                          class_token=False, num_reg_tokens=0,
                          layerscale=False, gelu_tanh=True)


def init_vit_params(generator: torch.Generator, cfg: ViTConfig,
                    dtype: torch.dtype = torch.float32,
                    device="cpu") -> Params:
    """Random init with the JAX package's distributions (normal 0.02,
    zero biases, unit norms, layerscale at ``ls_init``)."""
    def normal(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, 0.02, generator=generator)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    L, D, Fh, P = cfg.depth, cfg.dim, cfg.hidden_dim, cfg.patch_size
    params: Params = {
        "patch_embed": {"kernel": normal(P * P * 3, D), "bias": full(0, D)},
        "pos_embed": normal(1, cfg.num_patches + int(cfg.class_token), D),
        "blocks": {
            "norm1_scale": full(1, L, D), "norm1_bias": full(0, L, D),
            "wqkv": normal(L, D, 3 * D), "bqkv": full(0, L, 3 * D),
            "wo": normal(L, D, D), "bo": full(0, L, D),
            "norm2_scale": full(1, L, D), "norm2_bias": full(0, L, D),
            "w1": normal(L, D, Fh), "b1": full(0, L, Fh),
            "w2": normal(L, Fh, D), "b2": full(0, L, D),
        },
        "final_norm": {"scale": full(1, D), "bias": full(0, D)},
    }
    if cfg.class_token:
        params["cls_token"] = normal(1, 1, D)
    if cfg.num_reg_tokens:
        params["reg_tokens"] = normal(1, cfg.num_reg_tokens, D)
    if cfg.layerscale:
        params["blocks"]["ls1"] = full(cfg.ls_init, L, D)
        params["blocks"]["ls2"] = full(cfg.ls_init, L, D)
    return params


def linear(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in the promoted dtype, as ``jnp`` computes it."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype) + b.to(dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, N, patch*patch*3] in (ph, pw, c) pixel order;
    non-divisible resolutions are cropped top-left."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images[:, :gh * patch, :gw * patch, :]
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def _embed(params: Params, cfg: ViTConfig, images: torch.Tensor,
           mesh=None) -> torch.Tensor:
    images = constrain_batch_sharded(images)
    x = constrain_batch_sharded(patchify(images, cfg.patch_size))
    x = linear(x, gather(params["patch_embed"]["kernel"], mesh),
               params["patch_embed"]["bias"])
    B = x.shape[0]
    if cfg.class_token:
        cls = params["cls_token"].expand(B, 1, cfg.dim).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)
    if cfg.num_reg_tokens:
        reg = params["reg_tokens"].expand(B, cfg.num_reg_tokens,
                                          cfg.dim).to(x.dtype)
        n_lead = 1 if cfg.class_token else 0
        x = torch.cat([x[:, :n_lead], reg, x[:, n_lead:]], dim=1)
    return x


def _block(h: torch.Tensor, p: Params, cfg: ViTConfig,
           attn_impl: str, mesh=None) -> torch.Tensor:
    p = gather_tree(p, mesh)
    B, L, D = h.shape
    x = layer_norm(h, p["norm1_scale"], p["norm1_bias"], cfg.norm_eps)
    qkv = linear(x, p["wqkv"], p["bqkv"])
    q, k, v = (t.reshape(B, L, cfg.n_heads, cfg.head_dim)
               for t in qkv.chunk(3, dim=-1))
    attn = multi_head_attention(q, k, v, impl=attn_impl).reshape(B, L, D)
    attn = linear(attn, p["wo"], p["bo"])
    if cfg.layerscale:
        attn = attn * p["ls1"].to(attn.dtype)
    h = h + attn
    x = layer_norm(h, p["norm2_scale"], p["norm2_bias"], cfg.norm_eps)
    x = linear(x, p["w1"], p["b1"])
    x = F.gelu(x, approximate="tanh" if cfg.gelu_tanh else "none")
    x = linear(x, p["w2"], p["b2"])
    if cfg.layerscale:
        x = x * p["ls2"].to(x.dtype)
    return h + x


def vit_forward(params: Params, cfg: ViTConfig, images: torch.Tensor, *,
                num_blocks: Optional[int] = None, strip_prefix: bool = True,
                final_norm: bool = False,
                attn_impl: str = "auto", mesh=None) -> torch.Tensor:
    """images [B, H, W, 3] (normalized) -> features [B, N(, +prefix), D].

    Defaults give the Emma-X feature contract: ``depth - 1`` blocks, no
    final norm, patches only.
    """
    if num_blocks is None:
        num_blocks = cfg.depth - 1
    h = constrain_batch_sharded(_embed(params, cfg, images, mesh))
    # unbound once: under autograd the stack's gradient is built once
    # (see ``llama.layer_list``)
    blocks = layer_blocks(params["blocks"], num_blocks, mesh)
    for p in blocks:
        h = _block(h, p, cfg, attn_impl, mesh)
    if final_norm:
        h = layer_norm(h, params["final_norm"]["scale"],
                       params["final_norm"]["bias"], cfg.norm_eps)
    if strip_prefix and cfg.num_prefix:
        h = h[:, cfg.num_prefix:]
    return h


class ViT(nn.Module):
    """One vision tower holding its weights; ``forward`` is
    :func:`vit_forward` with the Emma-X feature contract."""

    def __init__(self, cfg: ViTConfig, params: Params) -> None:
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    def forward(self, images: torch.Tensor,
                attn_impl: str = "auto") -> torch.Tensor:
        return vit_forward(self.params.tree(), self.cfg, images,
                           attn_impl=attn_impl)
