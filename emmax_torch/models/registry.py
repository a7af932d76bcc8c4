"""Model ids the port loads, port of ``emmax_tpu/models/registry.py``:
one entry per VLM id of ``conf/models.py`` (its backbones), plus the tiny
test config; ``models/materialize.py`` builds each id's backbones."""

from __future__ import annotations

from typing import Dict


def _build() -> Dict[str, dict]:
    from emmax_torch.conf.models import MODELS, ModelConfig

    registry: Dict[str, dict] = {}
    for mid in MODELS:
        mc = ModelConfig.get_choice_class(mid)()
        registry[mid] = {
            "kind": "vlm",
            "description": (f"Prismatic VLM: {mc.vision_backbone_id} + "
                            f"{mc.llm_backbone_id} ({mc.arch_specifier}, "
                            f"{mc.image_resize_strategy})"),
            "vision_backbone_id": mc.vision_backbone_id,
            "llm_backbone_id": mc.llm_backbone_id,
            "arch_specifier": mc.arch_specifier,
            "image_resize_strategy": mc.image_resize_strategy,
        }
    registry["tiny"] = {
        "kind": "vlm",
        "description": "smoke-test scale: tiny towers and decoder "
                       "(tiny_vlm_config)",
        "vision_backbone_id": "tiny",
        "llm_backbone_id": "tiny",
        "arch_specifier": "no-align+fused-gelu-mlp",
        "image_resize_strategy": "resize-naive",
    }
    return registry


MODEL_REGISTRY: Dict[str, dict] = _build()
