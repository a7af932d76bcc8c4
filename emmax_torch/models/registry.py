"""Model ids the port loads, port of the part of
``emmax_tpu/models/registry.py`` (and ``emmax_tpu/conf/models.py``) that
maps the Emma-X base VLM and the tiny test config to their backbones."""

from __future__ import annotations

from typing import Dict

MODEL_REGISTRY: Dict[str, dict] = {
    "prism-dinosiglip-224px+7b": {
        "kind": "vlm",
        "description": "Prismatic VLM: dinosiglip-vit-so-224px + "
                       "llama2-7b-pure (no-align+fused-gelu-mlp, "
                       "resize-naive)",
        "vision_backbone_id": "dinosiglip-vit-so-224px",
        "llm_backbone_id": "llama2-7b-pure",
        "arch_specifier": "no-align+fused-gelu-mlp",
        "image_resize_strategy": "resize-naive",
    },
    "tiny": {
        "kind": "vlm",
        "description": "smoke-test scale: tiny towers and decoder "
                       "(tiny_vlm_config)",
        "vision_backbone_id": "tiny",
        "llm_backbone_id": "tiny",
        "arch_specifier": "no-align+fused-gelu-mlp",
        "image_resize_strategy": "resize-naive",
    },
}
