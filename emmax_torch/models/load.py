"""Model loading, port of ``emmax_tpu/models/load.py`` for registered ids.

``load(model_id)`` builds the config, random weights from a seeded
``torch.Generator`` on the chosen device (there are no real weights in
this environment), the tokenizer and the image transforms.
``quantize="int8"|"int4"`` quantizes the decoder's matmul weights and the
lm_head on that device. Loading checkpoints (run directories, reference
``.pt`` files, HF safetensors) belongs to a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from emmax_torch.models.materialize import (get_image_transforms,
                                            get_llm_config, get_vision_config)
from emmax_torch.models.registry import MODEL_REGISTRY
from emmax_torch.models.vlm import VLMConfig, init_vlm_params, tiny_vlm_config
from emmax_torch.ops.image import ImageTransformConfig
from emmax_torch.serving.engine import resolve_device
from emmax_torch.serving.quant import quantize_vlm_params
from emmax_torch.vla.tokenizer import load_tokenizer


def build_vlm(vision_backbone_id: str, llm_backbone_id: str,
              arch_specifier: str):
    """(VLMConfig, llm family) for a backbone pair ("tiny" = test scale)."""
    if vision_backbone_id == "tiny" or llm_backbone_id == "tiny":
        return tiny_vlm_config(), "llama2"
    llm, family = get_llm_config(llm_backbone_id)
    return VLMConfig(vision=get_vision_config(vision_backbone_id), llm=llm,
                     arch_specifier=arch_specifier), family


def load(model_id: str, dtype: torch.dtype = torch.bfloat16,
         tokenizer_path: Optional[str] = None,
         quantize: Optional[str] = None, device="cuda", seed: int = 0):
    """Load a VLM. Returns (cfg, params, tokenizer, transforms, family).

    Weights are random, drawn on ``device`` from ``torch.Generator`` seeded
    with ``seed``. ``quantize``: None, "int8" (per-channel) or "int4"
    (nibble-packed group-128, read by the int4 kernel).
    """
    if quantize not in (None, "int8", "int4"):
        raise ValueError(f"quantize={quantize!r}: expected 'int8' or 'int4'")
    if model_id not in MODEL_REGISTRY:
        raise KeyError(f"unknown model id {model_id!r}; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    device = resolve_device(device)
    entry = MODEL_REGISTRY[model_id]
    vid, resize = entry["vision_backbone_id"], entry["image_resize_strategy"]
    cfg, family = build_vlm(vid, entry["llm_backbone_id"],
                            entry["arch_specifier"])
    generator = torch.Generator(device)
    generator.manual_seed(seed)
    params = init_vlm_params(generator, cfg, dtype, device)
    if vid == "tiny":
        transforms = {n: ImageTransformConfig(size=v.img_size,
                                              resize_strategy=resize)
                      for n, v in cfg.vision}
    else:
        transforms = get_image_transforms(vid, resize)
    if quantize is not None:
        params = quantize_vlm_params(params,
                                     bits=4 if quantize == "int4" else 8)
    return cfg, params, load_tokenizer(tokenizer_path), transforms, family


def load_vla(model_id: str, dtype: torch.dtype = torch.bfloat16,
             tokenizer_path: Optional[str] = None, attn_impl: str = "auto",
             quantize: Optional[str] = None, device="cuda", seed: int = 0,
             norm_stats: Optional[dict] = None,
             proprio_stats: Optional[dict] = None,
             speculative: bool = False):
    """Load a VLA policy -> ``EmmaXVLA`` (see :func:`load`);
    ``speculative`` serves it on the closed-loop ``SpeculativeEngine``."""
    from emmax_torch.models.vla import EmmaXVLA

    cfg, params, tokenizer, transforms, family = load(
        model_id, dtype=dtype, tokenizer_path=tokenizer_path,
        quantize=quantize, device=device, seed=seed)
    return EmmaXVLA(cfg, params, tokenizer, transforms,
                    norm_stats=norm_stats, proprio_stats=proprio_stats,
                    llm_family=family, attn_impl=attn_impl,
                    speculative=speculative, device=device)
