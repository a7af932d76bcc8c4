"""The Hugging Face configuration of an exported Emma-X, port of
``emmax_tpu/extern/hf_config.py``.

Two layers:

- plain Python, with no ``transformers`` needed: the backbone maps of the reference's Hub
  configuration (backbone id -> TIMM ids, resolutions, activation
  overrides, Hugging Face LLM path and family), their validation
  (:func:`validate_backbones`, ``ValueError`` on an unknown id), and
  :func:`emmax_vla_config_dict` / :func:`config_json_dict`, which build the
  ``to_dict()`` of ``EmmaXVLAConfig(...)`` and the ``config.json`` its
  ``save_pretrained`` writes without ``transformers``;
- ``EmmaXConfig`` / ``EmmaXVLAConfig``, subclasses of
  ``transformers.PretrainedConfig`` (``PrismaticConfig`` /
  ``OpenVLAConfig``), built on first access through the module's
  ``__getattr__``: importing this module does not import ``transformers``.

The dicts follow the layout of ``transformers`` 4.57: the generic
``PretrainedConfig`` attributes, ``dtype`` (once ``torch_dtype``), and a
``text_config`` from the family's config class defaults.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

# Backbone-id maps of the reference's Hub configuration, verbatim.
VISION_BACKBONE_TO_RESOLUTION: Dict[str, List[int]] = {
    "clip-vit-l": [224], "siglip-vit-so400m": [224], "dinov2-vit-l": [224],
    "in1k-vit-l": [224],
    "clip-vit-l-336px": [336],
    "siglip-vit-so400m-384px": [384],
    "dinoclip-vit-l-336px": [336, 336],
    "dinosiglip-vit-so-224px": [224, 224],
    "dinosiglip-vit-so-384px": [384, 384],
}
VISION_BACKBONE_TO_TIMM_ID: Dict[str, List[str]] = {
    "clip-vit-l": ["vit_large_patch14_clip_224.openai"],
    "clip-vit-l-336px": ["vit_large_patch14_clip_336.openai"],
    "dinov2-vit-l": ["vit_large_patch14_reg4_dinov2.lvd142m"],
    "in1k-vit-l": ["vit_large_patch16_224.augreg_in21k_ft_in1k"],
    "siglip-vit-so400m": ["vit_so400m_patch14_siglip_224"],
    "siglip-vit-so400m-384px": ["vit_so400m_patch14_siglip_384"],
    "dinoclip-vit-l-336px": ["vit_large_patch14_reg4_dinov2.lvd142m",
                             "vit_large_patch14_clip_336.openai"],
    "dinosiglip-vit-so-224px": ["vit_large_patch14_reg4_dinov2.lvd142m",
                                "vit_so400m_patch14_siglip_224"],
    "dinosiglip-vit-so-384px": ["vit_large_patch14_reg4_dinov2.lvd142m",
                                "vit_so400m_patch14_siglip_384"],
}
TIMM_OVERRIDE_ACT_LAYER: Dict[str, List[Optional[str]]] = {
    "clip-vit-l": ["quick_gelu"], "clip-vit-l-336px": ["quick_gelu"],
    "dinov2-vit-l": [None], "in1k-vit-l": [None],
    "siglip-vit-so400m": [None], "siglip-vit-so400m-384px": [None],
    "dinoclip-vit-l-336px": [None, "quick_gelu"],
    "dinosiglip-vit-so-224px": [None, None],
    "dinosiglip-vit-so-384px": [None, None],
}
LLM_BACKBONE_TO_HF_PATH: Dict[str, str] = {
    "llama2-7b-pure": "meta-llama/Llama-2-7b-hf",
    "llama2-13b-pure": "meta-llama/Llama-2-13b-hf",
    "llama2-7b-chat": "meta-llama/Llama-2-7b-chat-hf",
    "llama2-13b-chat": "meta-llama/Llama-2-13b-chat-hf",
    "vicuna-v15-7b": "lmsys/vicuna-7b-v1.5",
    "vicuna-v15-13b": "lmsys/vicuna-13b-v1.5",
    "mistral-v0.1-7b-pure": "mistralai/Mistral-7B-v0.1",
    "mistral-v0.1-7b-instruct": "mistralai/Mistral-7B-Instruct-v0.1",
    "phi-2-3b": "microsoft/phi-2",
}
LLM_BACKBONE_TO_HF_METACLASS: Dict[str, str] = {
    "llama2-7b-pure": "llama", "llama2-13b-pure": "llama",
    "llama2-7b-chat": "llama", "llama2-13b-chat": "llama",
    "vicuna-v15-7b": "llama", "vicuna-v15-13b": "llama",
    "mistral-v0.1-7b-pure": "mistral", "mistral-v0.1-7b-instruct": "mistral",
    "phi-2-3b": "phi",
}
VALID_VISION_BACKBONES = set(VISION_BACKBONE_TO_RESOLUTION)
VALID_LLM_BACKBONES = set(LLM_BACKBONE_TO_HF_PATH)

TRANSFORMERS_LAYOUT = "4.57.6"   # the layout the dicts below follow

# ``PretrainedConfig().to_dict()`` without ``transformers_version`` and
# ``model_type``.
_LABELS = {"id2label": {0: "LABEL_0", 1: "LABEL_1"},
           "label2id": {"LABEL_0": 0, "LABEL_1": 1}}
PRETRAINED_DEFAULTS: Dict[str, Any] = {
    "return_dict": True, "output_hidden_states": False, "torchscript": False,
    "dtype": None, "pruned_heads": {}, "tie_word_embeddings": True,
    "chunk_size_feed_forward": 0, "is_encoder_decoder": False,
    "is_decoder": False, "cross_attention_hidden_size": None,
    "add_cross_attention": False, "tie_encoder_decoder": False,
    "architectures": None, "finetuning_task": None, **_LABELS,
    "task_specific_params": None, "problem_type": None,
    "tokenizer_class": None, "prefix": None, "bos_token_id": None,
    "pad_token_id": None, "eos_token_id": None, "sep_token_id": None,
    "decoder_start_token_id": None, "max_length": 20, "min_length": 0,
    "do_sample": False, "early_stopping": False, "num_beams": 1,
    "temperature": 1.0, "top_k": 50, "top_p": 1.0, "typical_p": 1.0,
    "repetition_penalty": 1.0, "length_penalty": 1.0,
    "no_repeat_ngram_size": 0, "encoder_no_repeat_ngram_size": 0,
    "bad_words_ids": None, "num_return_sequences": 1, "output_scores": False,
    "return_dict_in_generate": False, "forced_bos_token_id": None,
    "forced_eos_token_id": None, "remove_invalid_values": False,
    "exponential_decay_length_penalty": None, "suppress_tokens": None,
    "begin_suppress_tokens": None, "num_beam_groups": 1,
    "diversity_penalty": 0.0, "_name_or_path": "", "tf_legacy_loss": False,
    "use_bfloat16": False, "output_attentions": False,
}
# Where each family's default config class departs from those.
_FAMILY = {"tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2}
TEXT_CONFIG_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "llama": {
        "vocab_size": 32000, "max_position_embeddings": 2048,
        "hidden_size": 4096, "intermediate_size": 11008,
        "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 32, "hidden_act": "silu",
        "initializer_range": 0.02, "rms_norm_eps": 1e-06,
        "pretraining_tp": 1, "use_cache": True, "rope_theta": 10000.0,
        "rope_scaling": None, "attention_bias": False,
        "attention_dropout": 0.0, "mlp_bias": False, "head_dim": 128,
        **_FAMILY, "model_type": "llama"},
    "mistral": {
        "vocab_size": 32000, "max_position_embeddings": 131072,
        "hidden_size": 4096, "intermediate_size": 14336,
        "num_hidden_layers": 32, "num_attention_heads": 32,
        "sliding_window": 4096, "head_dim": None, "num_key_value_heads": 8,
        "hidden_act": "silu", "initializer_range": 0.02,
        "rms_norm_eps": 1e-06, "use_cache": True, "rope_theta": 10000.0,
        "attention_dropout": 0.0, **_FAMILY, "model_type": "mistral"},
    "phi": {
        "vocab_size": 51200, "hidden_size": 2048, "intermediate_size": 8192,
        "num_hidden_layers": 24, "num_attention_heads": 32,
        "num_key_value_heads": 32, "resid_pdrop": 0.0, "embd_pdrop": 0.0,
        "attention_dropout": 0.0, "hidden_act": "gelu_new",
        "max_position_embeddings": 2048, "initializer_range": 0.02,
        "layer_norm_eps": 1e-05, "use_cache": True, "rope_theta": 10000.0,
        "rope_scaling": None, "partial_rotary_factor": 0.5,
        "qk_layernorm": False, **_FAMILY, "model_type": "phi"},
}

AUTO_MAP = {
    "AutoConfig": "configuration_emmax.EmmaXVLAConfig",
    "AutoModelForVision2Seq": "modeling_emmax.EmmaXForVision2Seq",
    "AutoProcessor": "processing_emmax.EmmaXProcessor",
}


def validate_backbones(vision_backbone_id: str, llm_backbone_id: str) -> None:
    """``ValueError`` unless both ids are the reference Hub config's."""
    if vision_backbone_id not in VALID_VISION_BACKBONES:
        raise ValueError(f"Vision backbone `{vision_backbone_id}` not in "
                         f"{sorted(VALID_VISION_BACKBONES)}")
    if llm_backbone_id not in VALID_LLM_BACKBONES:
        raise ValueError(f"LLM backbone `{llm_backbone_id}` not in "
                         f"{sorted(VALID_LLM_BACKBONES)}")


def _backbone_fields(vision_backbone_id, llm_backbone_id, arch_specifier,
                     use_fused_vision_backbone, image_resize_strategy,
                     llm_max_length, pad_token_id, pad_to_multiple_of,
                     output_projector_states) -> Dict[str, Any]:
    """``EmmaXConfig``'s own attributes (the reference's
    ``PrismaticConfig``)."""
    validate_backbones(vision_backbone_id, llm_backbone_id)
    if use_fused_vision_backbone is None:
        use_fused_vision_backbone = any(
            vision_backbone_id.startswith(v) for v in ("dinoclip",
                                                       "dinosiglip"))
    return {
        "vision_backbone_id": vision_backbone_id,
        "llm_backbone_id": llm_backbone_id,
        "arch_specifier": arch_specifier,
        "output_projector_states": output_projector_states,
        "use_fused_vision_backbone": use_fused_vision_backbone,
        "timm_model_ids": list(VISION_BACKBONE_TO_TIMM_ID[vision_backbone_id]),
        "timm_override_act_layers":
            list(TIMM_OVERRIDE_ACT_LAYER[vision_backbone_id]),
        "image_sizes": list(VISION_BACKBONE_TO_RESOLUTION[vision_backbone_id]),
        "image_resize_strategy": image_resize_strategy,
        "hf_llm_id": LLM_BACKBONE_TO_HF_PATH[llm_backbone_id],
        "llm_max_length": llm_max_length,
        "pad_token_id": pad_token_id,
        "pad_to_multiple_of": pad_to_multiple_of,
    }


def text_config_dict(llm_backbone_id: str,
                     text_config: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """``to_dict()`` of the family's config class built with
    ``text_config`` (keys set as given; no derived key is recomputed)."""
    meta = LLM_BACKBONE_TO_HF_METACLASS[llm_backbone_id]
    out = {**copy.deepcopy(PRETRAINED_DEFAULTS),
           **copy.deepcopy(TEXT_CONFIG_DEFAULTS[meta])}
    out.update(copy.deepcopy(text_config or {}))
    return out


def emmax_vla_config_dict(
        vision_backbone_id: str = "dinosiglip-vit-so-224px",
        llm_backbone_id: str = "llama2-7b-pure",
        arch_specifier: str = "no-align+fused-gelu-mlp",
        use_fused_vision_backbone: Optional[bool] = None,
        image_resize_strategy: str = "resize-naive",
        text_config: Optional[Dict[str, Any]] = None,
        llm_max_length: int = 2048, pad_token_id: int = 32000,
        pad_to_multiple_of: int = 64, output_projector_states: bool = False,
        norm_stats: Optional[Dict[str, Any]] = None, n_action_bins: int = 256,
        torch_dtype: Optional[str] = None,
        auto_map: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """``EmmaXVLAConfig(...).to_dict()`` without ``transformers``."""
    out = {**copy.deepcopy(PRETRAINED_DEFAULTS),
           "norm_stats": copy.deepcopy(norm_stats),
           "n_action_bins": n_action_bins,
           **_backbone_fields(vision_backbone_id, llm_backbone_id,
                              arch_specifier, use_fused_vision_backbone,
                              image_resize_strategy, llm_max_length,
                              pad_token_id, pad_to_multiple_of,
                              output_projector_states),
           "text_config": text_config_dict(llm_backbone_id, text_config),
           "transformers_version": TRANSFORMERS_LAYOUT,
           "model_type": "emmax-openvla"}
    if torch_dtype is not None:
        out["dtype"] = str(torch_dtype).removeprefix("torch.")
    if auto_map is not None:
        out["auto_map"] = dict(auto_map)
    return out


def config_json_dict(**kwargs: Any) -> Dict[str, Any]:
    """The ``config.json`` that ``EmmaXVLAConfig(**kwargs).save_pretrained``
    writes: ``PretrainedConfig.to_diff_dict``'s keys, those that are
    Emma-X's own or differ from the generic or class defaults, and of
    ``text_config`` those that are the family's own or differ from its
    class defaults (its ``model_type`` always)."""
    full = emmax_vla_config_dict(**kwargs)
    class_default = emmax_vla_config_dict()
    out: Dict[str, Any] = {}
    for key, value in full.items():
        if key == "text_config":
            meta = value["model_type"]
            family = {**PRETRAINED_DEFAULTS, **TEXT_CONFIG_DEFAULTS[meta]}
            out[key] = {k: v for k, v in value.items()
                        if k not in PRETRAINED_DEFAULTS or v != family[k]}
            out[key]["model_type"] = meta
        elif (key not in PRETRAINED_DEFAULTS or key == "transformers_version"
              or value != PRETRAINED_DEFAULTS[key]
              or (key in class_default and value != class_default[key])):
            out[key] = value
    return out


def write_config_json(out_dir, **kwargs: Any) -> Path:
    """``config.json`` in ``save_pretrained``'s layout (sorted keys, indent
    2); returns its path."""
    path = Path(out_dir) / "config.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(config_json_dict(**kwargs), indent=2,
                               sort_keys=True) + "\n")
    return path


_LAZY = ("EmmaXConfig", "EmmaXVLAConfig")


def _build_classes() -> Dict[str, type]:
    from transformers import PretrainedConfig
    from transformers.models.auto import CONFIG_MAPPING

    class EmmaXConfig(PretrainedConfig):
        """``PrismaticConfig``'s role."""

        model_type: str = "emmax-prismatic"
        is_composition: bool = False

        def __init__(self,
                     vision_backbone_id: str = "dinosiglip-vit-so-224px",
                     llm_backbone_id: str = "llama2-7b-pure",
                     arch_specifier: str = "no-align+fused-gelu-mlp",
                     use_fused_vision_backbone: Optional[bool] = None,
                     image_resize_strategy: str = "resize-naive",
                     text_config: Optional[Dict[str, Any]] = None,
                     llm_max_length: int = 2048, pad_token_id: int = 32000,
                     pad_to_multiple_of: int = 64,
                     output_projector_states: bool = False,
                     **kwargs: Any) -> None:
            fields = _backbone_fields(
                vision_backbone_id, llm_backbone_id, arch_specifier,
                use_fused_vision_backbone, image_resize_strategy,
                llm_max_length, pad_token_id, pad_to_multiple_of,
                output_projector_states)
            for key, value in fields.items():
                setattr(self, key, value)
            meta = LLM_BACKBONE_TO_HF_METACLASS[llm_backbone_id]
            if isinstance(text_config, PretrainedConfig):
                self.text_config = text_config
            else:
                self.text_config = CONFIG_MAPPING[meta](**(text_config or {}))
            super().__init__(pad_token_id=pad_token_id, **kwargs)

    class EmmaXVLAConfig(EmmaXConfig):
        """``OpenVLAConfig``'s role: the per-dataset un-normalization
        statistics and the action-bin count."""

        model_type: str = "emmax-openvla"

        def __init__(self, norm_stats: Optional[Dict[str, Any]] = None,
                     n_action_bins: int = 256, **kwargs: Any) -> None:
            self.norm_stats = norm_stats
            self.n_action_bins = n_action_bins
            super().__init__(**kwargs)

    classes = {"EmmaXConfig": EmmaXConfig, "EmmaXVLAConfig": EmmaXVLAConfig}
    for name, cls in classes.items():
        cls.__qualname__ = name
    return classes


def __getattr__(name: str):
    if name in _LAZY:
        globals().update(_build_classes())
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
