"""Model definitions (vision towers, projector, Llama decoder, VLM, VLA)."""

from emmax_torch.models.llama import (LLAMA2_7B, Llama, LlamaConfig,
                                      init_kv_cache, init_llama_params,
                                      llama_forward)
from emmax_torch.models.projector import Projector, projector_forward
from emmax_torch.models.vit import (DINOV2_L_REG4, SIGLIP_SO400M, ViT,
                                    ViTConfig, init_vit_params, vit_forward)
from emmax_torch.models.vlm import (VLM, VLMConfig, emma_x_vlm_config,
                                    init_vlm_params, tiny_vlm_config)

__all__ = [
    "LlamaConfig", "ViTConfig", "VLMConfig", "LLAMA2_7B", "DINOV2_L_REG4",
    "SIGLIP_SO400M", "Llama", "Projector", "ViT", "VLM", "init_kv_cache",
    "init_llama_params", "init_vit_params", "init_vlm_params",
    "llama_forward", "projector_forward", "vit_forward",
    "emma_x_vlm_config", "tiny_vlm_config",
]
