"""Model definitions (vision towers, projector, Llama and Phi decoders,
VLM, VLA)."""

from emmax_torch.models.llama import (LLAMA2_7B, LLAMA2_13B, MISTRAL_7B,
                                      Llama, LlamaConfig, init_kv_cache,
                                      init_llama_params, llama_forward)
from emmax_torch.models.phi import (PHI_2, Phi, PhiConfig, init_phi_params,
                                    phi_forward)
from emmax_torch.models.projector import Projector, projector_forward
from emmax_torch.models.vit import (CLIP_L, CLIP_L_336, DINOV2_L_REG4,
                                    DINOV2_L_REG4_384, IN1K_L, SIGLIP_SO400M,
                                    SIGLIP_SO400M_384, ViT, ViTConfig,
                                    init_vit_params, vit_forward)
from emmax_torch.models.vlm import (VLM, VLMConfig, emma_x_vlm_config,
                                    init_vlm_params, llm_apply,
                                    tiny_vlm_config)

__all__ = [
    "LlamaConfig", "PhiConfig", "ViTConfig", "VLMConfig", "LLAMA2_7B",
    "LLAMA2_13B", "MISTRAL_7B", "PHI_2", "DINOV2_L_REG4",
    "DINOV2_L_REG4_384", "SIGLIP_SO400M", "SIGLIP_SO400M_384", "CLIP_L",
    "CLIP_L_336", "IN1K_L", "Llama", "Phi", "Projector", "ViT", "VLM",
    "init_kv_cache", "init_llama_params", "init_phi_params",
    "init_vit_params", "init_vlm_params", "llama_forward", "phi_forward",
    "llm_apply", "projector_forward", "vit_forward", "emma_x_vlm_config",
    "tiny_vlm_config",
]
