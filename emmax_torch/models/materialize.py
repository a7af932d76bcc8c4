"""Backbone ids -> static configs and image transforms, port of
``emmax_tpu/models/materialize.py``. The port builds the backbones of the
Emma-X flagship; every other id raises a ``KeyError`` naming what it
builds."""

from __future__ import annotations

from typing import Dict, Tuple

from emmax_torch.models.llama import LLAMA2_7B, LlamaConfig
from emmax_torch.models.vit import DINOV2_L_REG4, SIGLIP_SO400M, ViTConfig
from emmax_torch.models.vlm import VLMConfig
from emmax_torch.ops.image import (ImageTransformConfig,
                                   transform_configs_for_backbone)

VISION_BACKBONES: Dict[str, Tuple[Tuple[str, ViTConfig], ...]] = {
    "dinosiglip-vit-so-224px": (("dino", DINOV2_L_REG4),
                                ("siglip", SIGLIP_SO400M)),
}

# family names, which pick the prompt builder
LLM_BACKBONES: Dict[str, Tuple[LlamaConfig, str]] = {
    "llama2-7b-pure": (LLAMA2_7B, "llama2-pure"),
}


def get_vision_config(vision_backbone_id: str):
    if vision_backbone_id not in VISION_BACKBONES:
        raise KeyError(f"vision backbone {vision_backbone_id!r} is not built "
                       f"by emmax_torch yet; it builds "
                       f"{sorted(VISION_BACKBONES)}")
    return VISION_BACKBONES[vision_backbone_id]


def get_llm_config(llm_backbone_id: str) -> Tuple[LlamaConfig, str]:
    if llm_backbone_id not in LLM_BACKBONES:
        raise KeyError(f"llm backbone {llm_backbone_id!r} is not built by "
                       f"emmax_torch yet; it builds {sorted(LLM_BACKBONES)}")
    return LLM_BACKBONES[llm_backbone_id]


def get_image_transforms(vision_backbone_id: str, image_resize_strategy: str
                         ) -> Dict[str, ImageTransformConfig]:
    get_vision_config(vision_backbone_id)       # raises for an unbuilt id
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
