"""VLM model (architecture and pretrain-stage) configurations, the port's
copy of ``emmax_tpu/conf/models.py``.

Every ``model_id`` of the Prismatic registry resolves through
``ModelConfig.get_choice_class``; the checkpoint loader reads the
backbones of a run directory's ``{"vla": {"base_vlm": id}}`` here, and
``models/materialize.py`` builds every id's backbones.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

from emmax_torch.conf.registry import ChoiceRegistry


@dataclass
class ModelConfig(ChoiceRegistry):
    model_id: str = "prism-dinosiglip-224px+7b"
    arch_specifier: str = "no-align+fused-gelu-mlp"

    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    llm_backbone_id: str = "llama2-7b-pure"

    image_resize_strategy: str = "resize-naive"
    llm_max_length: int = 2048

    # Align stage
    align_epochs: int = 1
    align_max_steps: Optional[int] = None
    align_global_batch_size: int = 256
    align_per_device_batch_size: int = 16
    align_learning_rate: float = 1e-3
    align_weight_decay: float = 0.0
    align_max_grad_norm: float = 1.0
    align_lr_scheduler_type: str = "linear-warmup+cosine-decay"
    align_warmup_ratio: float = 0.03
    align_train_strategy: str = "fsdp-shard-grad-op"

    # Finetune stage
    finetune_epochs: int = 2
    finetune_max_steps: Optional[int] = None
    finetune_global_batch_size: int = 128
    finetune_per_device_batch_size: int = 16
    finetune_learning_rate: float = 2e-5
    finetune_weight_decay: float = 0.1
    finetune_max_grad_norm: float = 1.0
    finetune_lr_scheduler_type: str = "linear-warmup+cosine-decay"
    finetune_warmup_ratio: float = 0.03
    finetune_train_strategy: str = "fsdp-full-shard"

    enable_gradient_checkpointing: bool = True
    enable_mixed_precision_training: bool = True
    reduce_in_full_precision: bool = False


# model_id -> overrides
_MODELS: Dict[str, Dict] = {
    # LLaVa v1.5 reproductions
    "reproduction-llava-v15+7b": dict(arch_specifier="gelu-mlp",
                                      vision_backbone_id="clip-vit-l-336px",
                                      llm_backbone_id="vicuna-v15-7b",
                                      image_resize_strategy="letterbox",
                                      finetune_epochs=1),
    "reproduction-llava-v15+13b": dict(arch_specifier="gelu-mlp",
                                       vision_backbone_id="clip-vit-l-336px",
                                       llm_backbone_id="vicuna-v15-13b",
                                       image_resize_strategy="letterbox",
                                       finetune_epochs=1),
    # Prismatic ablation/series models
    "one-stage+7b": dict(arch_specifier="no-align+gelu-mlp",
                         vision_backbone_id="clip-vit-l-336px",
                         llm_backbone_id="vicuna-v15-7b",
                         image_resize_strategy="letterbox", finetune_epochs=1),
    "one-stage+13b": dict(arch_specifier="no-align+gelu-mlp",
                          vision_backbone_id="clip-vit-l-336px",
                          llm_backbone_id="vicuna-v15-13b",
                          image_resize_strategy="letterbox", finetune_epochs=1),
    "full-ft-multi-stage+7b": dict(arch_specifier="gelu-mlp",
                                   vision_backbone_id="clip-vit-l-336px",
                                   llm_backbone_id="vicuna-v15-7b",
                                   image_resize_strategy="letterbox", finetune_epochs=1),
    "full-ft-one-stage+7b": dict(arch_specifier="no-align+gelu-mlp",
                                 vision_backbone_id="clip-vit-l-336px",
                                 llm_backbone_id="vicuna-v15-7b",
                                 image_resize_strategy="letterbox", finetune_epochs=1),
    "in1k-224px+7b": dict(vision_backbone_id="in1k-vit-l",
                          llm_backbone_id="vicuna-v15-7b",
                          arch_specifier="no-align+gelu-mlp",
                          image_resize_strategy="letterbox", finetune_epochs=1),
    "dinov2-224px+7b": dict(vision_backbone_id="dinov2-vit-l",
                            llm_backbone_id="vicuna-v15-7b",
                            arch_specifier="no-align+gelu-mlp",
                            image_resize_strategy="letterbox", finetune_epochs=1),
    "clip-224px+7b": dict(vision_backbone_id="clip-vit-l",
                          llm_backbone_id="vicuna-v15-7b",
                          arch_specifier="no-align+gelu-mlp",
                          image_resize_strategy="letterbox", finetune_epochs=1),
    "siglip-224px+7b": dict(vision_backbone_id="siglip-vit-so400m",
                            llm_backbone_id="vicuna-v15-7b",
                            arch_specifier="no-align+gelu-mlp",
                            image_resize_strategy="letterbox", finetune_epochs=1),
    "clip-336px-resize-crop+7b": dict(vision_backbone_id="clip-vit-l-336px",
                                      llm_backbone_id="vicuna-v15-7b",
                                      arch_specifier="no-align+gelu-mlp",
                                      image_resize_strategy="resize-crop", finetune_epochs=1),
    "clip-336px-resize-naive+7b": dict(vision_backbone_id="clip-vit-l-336px",
                                       llm_backbone_id="vicuna-v15-7b",
                                       arch_specifier="no-align+gelu-mlp", finetune_epochs=1),
    "siglip-384px-letterbox+7b": dict(vision_backbone_id="siglip-vit-so400m-384px",
                                      llm_backbone_id="vicuna-v15-7b",
                                      arch_specifier="no-align+gelu-mlp",
                                      image_resize_strategy="letterbox", finetune_epochs=1),
    "siglip-384px-resize-crop+7b": dict(vision_backbone_id="siglip-vit-so400m-384px",
                                        llm_backbone_id="vicuna-v15-7b",
                                        arch_specifier="no-align+gelu-mlp",
                                        image_resize_strategy="resize-crop", finetune_epochs=1),
    "siglip-384px-resize-naive+7b": dict(vision_backbone_id="siglip-vit-so400m-384px",
                                         llm_backbone_id="vicuna-v15-7b",
                                         arch_specifier="no-align+gelu-mlp", finetune_epochs=1),
    "dinoclip-336px-letterbox+7b": dict(vision_backbone_id="dinoclip-vit-l-336px",
                                        llm_backbone_id="vicuna-v15-7b",
                                        arch_specifier="no-align+fused-gelu-mlp",
                                        image_resize_strategy="letterbox", finetune_epochs=1),
    "dinoclip-336px-resize-naive+7b": dict(vision_backbone_id="dinoclip-vit-l-336px",
                                           llm_backbone_id="vicuna-v15-7b",
                                           arch_specifier="no-align+fused-gelu-mlp",
                                           finetune_epochs=1),
    "dinosiglip-384px-letterbox+7b": dict(vision_backbone_id="dinosiglip-vit-so-384px",
                                          llm_backbone_id="vicuna-v15-7b",
                                          arch_specifier="no-align+fused-gelu-mlp",
                                          image_resize_strategy="letterbox", finetune_epochs=1),
    "dinosiglip-384px-resize-naive+7b": dict(vision_backbone_id="dinosiglip-vit-so-384px",
                                             llm_backbone_id="vicuna-v15-7b",
                                             arch_specifier="no-align+fused-gelu-mlp",
                                             finetune_epochs=1),
    # LLM ablations
    "llama2+7b": dict(vision_backbone_id="clip-vit-l-336px", llm_backbone_id="llama2-7b-pure",
                      arch_specifier="no-align+gelu-mlp",
                      image_resize_strategy="letterbox", finetune_epochs=1),
    "llama2+13b": dict(vision_backbone_id="clip-vit-l-336px", llm_backbone_id="llama2-13b-pure",
                       arch_specifier="no-align+gelu-mlp",
                       image_resize_strategy="letterbox", finetune_epochs=1),
    "llama2-chat+7b": dict(vision_backbone_id="clip-vit-l-336px", llm_backbone_id="llama2-7b-chat",
                           arch_specifier="no-align+gelu-mlp",
                           image_resize_strategy="letterbox", finetune_epochs=1),
    "llama2-chat+13b": dict(vision_backbone_id="clip-vit-l-336px", llm_backbone_id="llama2-13b-chat",
                            arch_specifier="no-align+gelu-mlp",
                            image_resize_strategy="letterbox", finetune_epochs=1),
    "mistral-v0.1+7b": dict(vision_backbone_id="clip-vit-l-336px",
                            llm_backbone_id="mistral-v0.1-7b-pure",
                            arch_specifier="no-align+gelu-mlp",
                            image_resize_strategy="letterbox", finetune_epochs=1),
    "mistral-instruct-v0.1+7b": dict(vision_backbone_id="clip-vit-l-336px",
                                     llm_backbone_id="mistral-v0.1-7b-instruct",
                                     arch_specifier="no-align+gelu-mlp",
                                     image_resize_strategy="letterbox", finetune_epochs=1),
    # reference Ext_Exp_3B_Phi_2 inherits Exp_7B_One_Stage
    # (models.py:287-289): CLIP-336 tower, no-align+gelu-mlp, letterbox
    "phi-2+3b": dict(vision_backbone_id="clip-vit-l-336px",
                     llm_backbone_id="phi-2-3b",
                     arch_specifier="no-align+gelu-mlp",
                     image_resize_strategy="letterbox", finetune_epochs=1),
    # Co-training ablations (run with multimodal-only data mixes;
    # reference models.py:295-305)
    "vicuna-no-cotraining+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="vicuna-v15-7b",
        arch_specifier="no-align+gelu-mlp",
        image_resize_strategy="letterbox", finetune_epochs=1),
    "llama2-no-cotraining+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="llama2-7b-pure",
        arch_specifier="no-align+gelu-mlp",
        image_resize_strategy="letterbox", finetune_epochs=1),
    # Train-time scaling (reference models.py:312-333)
    "train-1.25-epochs+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="vicuna-v15-7b",
        arch_specifier="no-align+gelu-mlp", image_resize_strategy="letterbox",
        finetune_epochs=1, finetune_max_steps=6500),
    "train-1.5-epochs+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="vicuna-v15-7b",
        arch_specifier="no-align+gelu-mlp", image_resize_strategy="letterbox",
        finetune_epochs=1, finetune_max_steps=7800),
    "train-2-epochs+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="vicuna-v15-7b",
        arch_specifier="no-align+gelu-mlp", image_resize_strategy="letterbox",
        finetune_epochs=2),
    "train-3-epochs+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="vicuna-v15-7b",
        arch_specifier="no-align+gelu-mlp", image_resize_strategy="letterbox",
        finetune_epochs=3),
    # Data scaling (run with the matching --dataset.type;
    # reference models.py:336-351)
    "llava-lvis4v+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="vicuna-v15-7b",
        arch_specifier="no-align+gelu-mlp",
        image_resize_strategy="letterbox", finetune_epochs=1),
    "llava-lrv+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="vicuna-v15-7b",
        arch_specifier="no-align+gelu-mlp",
        image_resize_strategy="letterbox", finetune_epochs=1),
    "llava-lvis4v-lrv+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="vicuna-v15-7b",
        arch_specifier="no-align+gelu-mlp",
        image_resize_strategy="letterbox", finetune_epochs=1),
    # Prisms (reference models.py:357-467)
    "prism-clip-controlled+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="llama2-7b-pure",
        arch_specifier="no-align+gelu-mlp", finetune_epochs=1),
    "prism-clip-controlled+13b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="llama2-13b-pure",
        arch_specifier="no-align+gelu-mlp", finetune_epochs=1),
    "prism-clip+7b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="llama2-7b-pure",
        arch_specifier="no-align+gelu-mlp", finetune_epochs=2),
    "prism-clip+13b": dict(
        vision_backbone_id="clip-vit-l-336px", llm_backbone_id="llama2-13b-pure",
        arch_specifier="no-align+gelu-mlp", finetune_epochs=2),
    "prism-siglip-controlled+7b": dict(
        vision_backbone_id="siglip-vit-so400m-384px",
        llm_backbone_id="llama2-7b-pure",
        arch_specifier="no-align+gelu-mlp", finetune_epochs=1),
    "prism-siglip-controlled+13b": dict(
        vision_backbone_id="siglip-vit-so400m-384px",
        llm_backbone_id="llama2-13b-pure",
        arch_specifier="no-align+gelu-mlp", finetune_epochs=1),
    "prism-siglip+7b": dict(
        vision_backbone_id="siglip-vit-so400m-384px",
        llm_backbone_id="llama2-7b-pure",
        arch_specifier="no-align+gelu-mlp", finetune_epochs=2),
    # NOTE: the reference's prism-siglip+13b really does use the CLIP tower
    # (models.py:423-429) — reproduced verbatim
    "prism-siglip+13b": dict(
        vision_backbone_id="clip-vit-l-336px",
        llm_backbone_id="llama2-13b-pure",
        arch_specifier="no-align+gelu-mlp", finetune_epochs=2),
    "prism-dinosiglip-controlled+7b": dict(
        vision_backbone_id="dinosiglip-vit-so-384px",
        llm_backbone_id="llama2-7b-pure", finetune_epochs=1),
    "prism-dinosiglip-controlled+13b": dict(
        vision_backbone_id="dinosiglip-vit-so-384px",
        llm_backbone_id="llama2-13b-pure", finetune_epochs=1),
    "prism-dinosiglip+7b": dict(
        vision_backbone_id="dinosiglip-vit-so-384px",
        llm_backbone_id="llama2-7b-pure", finetune_epochs=2),
    "prism-dinosiglip+13b": dict(
        vision_backbone_id="dinosiglip-vit-so-384px",
        llm_backbone_id="llama2-13b-pure", finetune_epochs=2),
    # Inference-optimized 224px Prisms (reference models.py:470-497)
    "dinosiglip-224px-resize-naive+7b": dict(
        llm_backbone_id="vicuna-v15-7b", finetune_epochs=1),
    "prism-dinosiglip-224px-controlled+7b": dict(finetune_epochs=1),
    # Flagship (Emma-X / OpenVLA base VLM)
    "prism-dinosiglip-224px+7b": dict(finetune_epochs=2),
    "prism-dinosiglip-224px+13b": dict(llm_backbone_id="llama2-13b-pure", finetune_epochs=2),
}


def _register(model_id: str, overrides: Dict) -> type:
    values = dict(model_id=model_id, **overrides)
    fields = [(k, type(v), field(default=v)) for k, v in values.items()]
    cls = dataclasses.make_dataclass(
        "Model_" + model_id.replace("+", "_").replace("-", "_").replace(".", "_"),
        fields, bases=(ModelConfig,))
    ModelConfig.register_subclass(model_id, cls)
    return cls


MODELS: Dict[str, type] = {mid: _register(mid, ov) for mid, ov in _MODELS.items()}
