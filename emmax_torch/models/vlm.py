"""Prismatic-style VLM: fused vision towers + projector + Llama decoder.

Port of ``emmax_tpu/models/vlm.py`` for serving: the towers run on their
own normalized images, their features are concatenated on channels and
projected, and the patch embeddings are spliced after each row's BOS
(``fuse_multimodal``) before the decoder runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch import nn

from emmax_torch.models.llama import (LLAMA2_7B, Llama, LlamaConfig,
                                      init_llama_params, llama_forward)
from emmax_torch.models.projector import (Projector, init_projector_params,
                                          projector_forward)
from emmax_torch.models.vit import (DINOV2_L_REG4, SIGLIP_SO400M, ViT,
                                    ViTConfig, init_vit_params, vit_forward)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Static architecture description (towers as ordered (name, cfg))."""

    vision: Tuple[Tuple[str, ViTConfig], ...]
    llm: LlamaConfig
    arch_specifier: str = "no-align+fused-gelu-mlp"

    @property
    def vision_dim(self) -> int:
        return sum(cfg.dim for _, cfg in self.vision)

    @property
    def num_patches(self) -> int:
        counts = {cfg.num_patches for _, cfg in self.vision}
        if len(counts) != 1:
            raise ValueError(f"towers must agree on patch count: {counts}")
        return counts.pop()


def init_vlm_params(generator: torch.Generator, cfg: VLMConfig,
                    dtype: torch.dtype = torch.float32,
                    device="cpu") -> Params:
    """Random weights with the JAX init's distributions (not its values:
    ``torch.Generator`` and ``jax.random`` draw different numbers)."""
    return {
        "vision": {name: init_vit_params(generator, vcfg, dtype, device)
                   for name, vcfg in cfg.vision},
        "projector": init_projector_params(generator, cfg.arch_specifier,
                                           cfg.vision_dim, cfg.llm.dim,
                                           dtype, device),
        "llm": init_llama_params(generator, cfg.llm, dtype, device),
    }


def llm_apply(params: Params, llm_cfg: LlamaConfig,
              inputs_embeds: torch.Tensor, **kw):
    """Decoder dispatch by config type (the Llama family in this port)."""
    if not isinstance(llm_cfg, LlamaConfig):
        raise TypeError(f"unsupported decoder config {type(llm_cfg)}")
    return llama_forward(params, llm_cfg, inputs_embeds, **kw)


def encode_images(params: Params, cfg: VLMConfig,
                  pixel_values: Dict[str, torch.Tensor], *,
                  attn_impl: str = "auto") -> torch.Tensor:
    """Every tower on its own normalized image, concatenated on channels,
    then projected to the LLM width: -> [B, P, llm_dim]."""
    feats = [vit_forward(params["vision"][name], vcfg, pixel_values[name],
                         attn_impl=attn_impl)
             for name, vcfg in cfg.vision]
    fused = feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)
    return projector_forward(params["projector"], fused)


def fuse_multimodal(patch_embeds: torch.Tensor, input_embeds: torch.Tensor,
                    mask: torch.Tensor):
    """Splice patches after each row's BOS: [pads... | bos | patches | text].

    For a row whose first valid token sits at index ``p``, the fused row
    is text[:p+1] | patches | text[p+1:]. Patch slots are valid, except in
    a row that is all padding (it has no BOS, and its patch slots must not
    prefill live cache slots).

    Returns (embeds [B, L+P, D], mask [B, L+P], positions [B, L+P]).
    """
    B, P, D = patch_embeds.shape
    L = input_embeds.shape[1]
    F = L + P
    p = mask.to(torch.int32).argmax(dim=-1)                  # first valid
    row_live = mask.any(dim=-1, keepdim=True)                # [B, 1]
    j = torch.arange(F, device=mask.device)[None, :]         # [1, F]
    pe = p[:, None]
    is_patch = (j > pe) & (j <= pe + P)
    src_text = torch.where(j > pe, j - P, j)
    src = torch.where(is_patch, L + torch.clamp(j - pe - 1, 0, P - 1),
                      src_text)
    source = torch.cat([input_embeds, patch_embeds.to(input_embeds.dtype)],
                       dim=1)
    idx = torch.clamp(src, 0, F - 1)[..., None].expand(B, F, D)
    embeds = torch.gather(source, 1, idx)
    text_mask = torch.gather(mask.to(torch.bool), 1,
                             torch.clamp(src_text, 0, L - 1).expand(B, F))
    fused_mask = torch.where(is_patch, row_live, text_mask)
    positions = torch.clamp(
        torch.cumsum(fused_mask.to(torch.int32), dim=-1) - 1, min=0)
    return embeds, fused_mask, positions


# === Reference model shape: the Emma-X flagship ===
def emma_x_vlm_config() -> VLMConfig:
    return VLMConfig(
        vision=(("dino", DINOV2_L_REG4), ("siglip", SIGLIP_SO400M)),
        llm=LLAMA2_7B,
        arch_specifier="no-align+fused-gelu-mlp",
    )


def tiny_vlm_config(vocab_size: int = 512) -> VLMConfig:
    """Small config for tests and smoke runs (same structure, tiny dims)."""
    dino = ViTConfig(img_size=28, patch_size=14, dim=32, depth=3, n_heads=2,
                     hidden_dim=64, class_token=True, num_reg_tokens=4,
                     layerscale=True)
    siglip = ViTConfig(img_size=28, patch_size=14, dim=48, depth=4, n_heads=2,
                       hidden_dim=96, class_token=False, gelu_tanh=True)
    llm = LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=4, hidden_dim=128, max_seq_len=256)
    return VLMConfig(vision=(("dino", dino), ("siglip", siglip)), llm=llm)


class VLM(nn.Module):
    """The towers, projector and decoder of one VLM, holding the weights."""

    def __init__(self, cfg: VLMConfig, params: Params) -> None:
        super().__init__()
        self.cfg = cfg
        self.vision = nn.ModuleDict({name: ViT(vcfg, params["vision"][name])
                                     for name, vcfg in cfg.vision})
        self.projector = Projector(params["projector"])
        self.llm = Llama(cfg.llm, params["llm"])

    def tree(self) -> Params:
        """The weights as the nested dict the functional passes take."""
        return {"vision": {name: tower.params.tree()
                           for name, tower in self.vision.items()},
                "projector": self.projector.params.tree(),
                "llm": self.llm.params.tree()}

    def forward(self, pixel_values: Dict[str, torch.Tensor],
                attn_impl: str = "auto") -> torch.Tensor:
        """Patch embeddings [B, P, llm_dim] (:func:`encode_images`)."""
        return encode_images(self.tree(), self.cfg, pixel_values,
                             attn_impl=attn_impl)
