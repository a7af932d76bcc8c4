"""Backbone ids -> static configs and image transforms, port of
``emmax_tpu/models/materialize.py``: every vision and LLM backbone of the
Prismatic registries, so every registered ``model_id`` builds. An unknown
id raises a ``KeyError`` naming the known ones."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

from emmax_torch.models.llama import (LLAMA2_7B, LLAMA2_13B, MISTRAL_7B,
                                      LlamaConfig)
from emmax_torch.models.phi import PHI_2, PhiConfig
from emmax_torch.models.vit import (CLIP_L, CLIP_L_336, DINOV2_L_REG4,
                                    DINOV2_L_REG4_384, IN1K_L, SIGLIP_SO400M,
                                    SIGLIP_SO400M_384, ViTConfig)
from emmax_torch.models.vlm import VLMConfig
from emmax_torch.ops.image import (ImageTransformConfig,
                                   transform_configs_for_backbone)

# (tower name, config) pairs in the order their features are concatenated
VISION_BACKBONES: Dict[str, Tuple[Tuple[str, ViTConfig], ...]] = {
    "clip-vit-l": (("clip", CLIP_L),),
    "clip-vit-l-336px": (("clip", CLIP_L_336),),
    "siglip-vit-so400m": (("siglip", SIGLIP_SO400M),),
    "siglip-vit-so400m-384px": (("siglip", SIGLIP_SO400M_384),),
    "dinov2-vit-l": (("dino", DINOV2_L_REG4),),
    "in1k-vit-l": (("in1k", IN1K_L),),
    "dinoclip-vit-l-336px": (("dino", dataclasses.replace(DINOV2_L_REG4,
                                                          img_size=336)),
                             ("clip", CLIP_L_336)),
    "dinosiglip-vit-so-224px": (("dino", DINOV2_L_REG4),
                                ("siglip", SIGLIP_SO400M)),
    "dinosiglip-vit-so-384px": (("dino", DINOV2_L_REG4_384),
                                ("siglip", SIGLIP_SO400M_384)),
}

# (config, family); the family picks the prompt builder
LLM_BACKBONES: Dict[str, Tuple[Union[LlamaConfig, PhiConfig], str]] = {
    "llama2-7b-pure": (LLAMA2_7B, "llama2-pure"),
    "llama2-13b-pure": (LLAMA2_13B, "llama2-pure"),
    "llama2-7b-chat": (LLAMA2_7B, "llama2-chat"),
    "llama2-13b-chat": (LLAMA2_13B, "llama2-chat"),
    "vicuna-v15-7b": (LLAMA2_7B, "vicuna"),
    "vicuna-v15-13b": (LLAMA2_13B, "vicuna"),
    "mistral-v0.1-7b-pure": (MISTRAL_7B, "mistral"),
    "mistral-v0.1-7b-instruct": (MISTRAL_7B, "mistral-instruct"),
    "phi-2-3b": (PHI_2, "phi"),
}


def get_vision_config(vision_backbone_id: str):
    if vision_backbone_id not in VISION_BACKBONES:
        raise KeyError(f"unknown vision backbone {vision_backbone_id!r}; "
                       f"known: {sorted(VISION_BACKBONES)}")
    return VISION_BACKBONES[vision_backbone_id]


def get_llm_config(llm_backbone_id: str):
    """(decoder config, prompt family) of an LLM backbone id."""
    if llm_backbone_id not in LLM_BACKBONES:
        raise KeyError(f"unknown llm backbone {llm_backbone_id!r}; "
                       f"known: {sorted(LLM_BACKBONES)}")
    return LLM_BACKBONES[llm_backbone_id]


def get_image_transforms(vision_backbone_id: str, image_resize_strategy: str
                         ) -> Dict[str, ImageTransformConfig]:
    get_vision_config(vision_backbone_id)       # raises for an unknown id
    return transform_configs_for_backbone(vision_backbone_id,
                                          image_resize_strategy)


def get_vlm_config(model_id_or_cfg) -> VLMConfig:
    """The static VLMConfig of a registered ``model_id`` (or of a
    ``conf.ModelConfig`` instance)."""
    from emmax_torch.conf import ModelConfig

    if isinstance(model_id_or_cfg, str):
        mc = ModelConfig.get_choice_class(model_id_or_cfg)()
    else:
        mc = model_id_or_cfg
    vision = get_vision_config(mc.vision_backbone_id)
    llm, _family = get_llm_config(mc.llm_backbone_id)
    return VLMConfig(vision=vision, llm=llm, arch_specifier=mc.arch_specifier)
