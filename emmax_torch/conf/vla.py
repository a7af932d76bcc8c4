"""VLA experiment configurations, the port's copy of
``emmax_tpu/conf/vla.py``.

Experiments are generated from a compact table and registered under the
reference's ``vla_id`` strings, so ``VLAConfig.get_choice_class(id)``
resolves every experiment id. ``train_strategy`` picks the trainer's
(replica, fsdp, tensor) mesh (``parallel.mesh.strategy_to_mesh_shape``);
``mesh_shape`` is the JAX package's field, recorded as there;
``remat_policy`` picks the decoder's activation checkpointing
("none" | "block" | "full" | "dots").
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

from emmax_torch.conf.registry import ChoiceRegistry


@dataclass
class VLAConfig(ChoiceRegistry):
    vla_id: str = "prism-dinosiglip-224px+mx-moveonly-moveguided-single-policy"
    base_vlm: Union[str, Path] = "prism-dinosiglip-224px+7b"

    freeze_vision_backbone: bool = False
    freeze_llm_backbone: bool = False
    unfreeze_last_llm_layer: bool = False

    # Data mixture
    data_mix: str = "movement_policy"
    shuffle_buffer_size: int = 1000

    # Optimization
    epochs: int = 200
    max_steps: Optional[int] = None
    expected_world_size: int = -1           # -1 => every visible device
    global_batch_size: int = 32
    per_device_batch_size: int = -1          # -1 => global / world
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "constant"
    warmup_ratio: float = 0.0

    # the reference's strategy name -> the trainer's mesh:
    # fsdp-full-shard (1, N, 1), fsdp-shard-grad-op (hosts, N/hosts, 1),
    # ddp (N, 1, 1)
    train_strategy: str = "fsdp-full-shard"
    mesh_shape: Tuple[int, ...] = (1, -1, 1)   # (replica, fsdp, tensor)
    # none | block | full | dots ("dots" keeps the matmul outputs and
    # recomputes the elementwise ops; block and full coincide, the
    # checkpointed unit being the decoder layer)
    remat_policy: str = "block"

    # Mixed precision
    enable_gradient_checkpointing: bool = True
    enable_mixed_precision_training: bool = True
    reduce_in_full_precision: bool = True


# (vla_id, base_vlm, data_mix, overrides) — every experiment id from the
# reference registry (conf/vla.py:591-654). Emma-X experiments share the
# bridge defaults above; the OpenVLA-era configs carry their own scales.
_BRIDGE_BASE = dict(shuffle_buffer_size=256_000, epochs=1000,
                    expected_world_size=8, global_batch_size=256,
                    per_device_batch_size=32)
_EXPERIMENTS = [
    ("siglip-224px+mx-bridge", "siglip-224px+7b", "bridge", _BRIDGE_BASE),
    ("siglip-224px-icy+mx-bridge", "siglip-224px+7b", "bridge",
     {**_BRIDGE_BASE, "freeze_vision_backbone": True}),
    ("prism-dinosiglip-224px+mx-bridge", "prism-dinosiglip-224px+7b", "bridge", _BRIDGE_BASE),
    ("prism-dinosiglip-224px+mx-bridge-1gpu", "prism-dinosiglip-224px+7b", "bridge",
     {**_BRIDGE_BASE, "expected_world_size": 1, "global_batch_size": 32,
      "per_device_batch_size": 32, "shuffle_buffer_size": 100_000}),
    ("prism-dinosiglip-224px+mx-bridge-2gpu", "prism-dinosiglip-224px+7b", "bridge",
     {**_BRIDGE_BASE, "expected_world_size": 2, "global_batch_size": 64,
      "per_device_batch_size": 32, "shuffle_buffer_size": 100_000}),
    ("prism-dinosiglip-224px+mx-bridge-1gpu-bf16", "prism-dinosiglip-224px+7b", "bridge",
     {**_BRIDGE_BASE, "expected_world_size": 1, "global_batch_size": 32,
      "per_device_batch_size": 32, "reduce_in_full_precision": False}),
    # Emma-X GCOT experiments (defaults from VLAConfig)
    ("prism-dinosiglip-224px+mx-movement-only", None, "movement_only", {}),
    ("prism-dinosiglip-224px+mx-reason-position-movement", None, "reason_position_movement", {}),
    ("prism-dinosiglip-224px+mx-pred-all-aug-multiple-policy", None, "pred_all", {}),
    ("prism-dinosiglip-224px+mx-pred-all-single-policy", None, "pred_all", {}),
    ("prism-dinosiglip-224px+mx-noposition-moveguided-single-policy", None, "no_position", {}),
    ("prism-dinosiglip-224px+mx-noreason-moveguided-single-policy", None, "no_reason", {}),
    ("prism-dinosiglip-224px+mx-move-only-single-policy", None, "movement_policy", {}),
    ("prism-dinosiglip-224px+mx-moveonly-moveguided-single-policy", None, "movement_policy", {}),
    ("prism-dinosiglip-224px+mx-pred-all-moveguided-singlepolicy", None, "pred_all", {}),
    ("prism-dinosiglip-224px+mx-openvla-single-policy", None, "openvla", {}),
    ("prism-dinosiglip-224px+mx-pred-all-seggripper-singlepolicy", None, "pred_all", {}),
    ("prism-dinosiglip-224px+mx-pred-all-segsoft-singlepolicy", None, "pred_all", {}),
    ("prism-dinosiglip-224px+mx-pred-all-segnstep-singlepolicy", None, "pred_all", {}),
    ("prism-dinosiglip-224px+mx-pred-all-multiple-policy", None, "pred_all", {}),
    ("prism-dinosiglip-224px+mx-pred-all-multiple-policy-norm", None, "pred_all", {}),
    ("prism-dinosiglip-224px+mx-policy-only-multiple-policy", None, "action_policy_only", {}),
    ("prism-dinosiglip-224px+mx-no-movement-single-policy", None, "no_movement", {}),
    ("prism-dinosiglip-224px+mx-no-movement-multiple-policy", None, "no_movement", {}),
    ("prism-dinosiglip-224px+mx-aug-multi-policy-wposition", None, "pred_all", {}),
    # Phi smoke-test configs
    ("phi-2+3b-bridge", "phi-2+3b", "bridge",
     {"epochs": 10, "expected_world_size": 1, "global_batch_size": 16,
      "per_device_batch_size": 16, "shuffle_buffer_size": 100_000}),
    ("phi-2+3b-bridge-2gpu", "phi-2+3b", "bridge",
     {"epochs": 10, "expected_world_size": 2, "global_batch_size": 16,
      "per_device_batch_size": 8, "shuffle_buffer_size": 100_000}),
    ("phi-2+3b-bridge-2gpu-bf16", "phi-2+3b", "bridge",
     {"epochs": 10, "expected_world_size": 2, "global_batch_size": 16,
      "per_device_batch_size": 8, "shuffle_buffer_size": 100_000,
      "reduce_in_full_precision": False}),
    # OpenVLA OXE configs
    ("siglip-224px+mx-oxe-magic-soup", "siglip-224px+7b", "oxe_magic_soup",
     {**_BRIDGE_BASE, "expected_world_size": 64, "global_batch_size": 2048,
      "per_device_batch_size": 32, "shuffle_buffer_size": 1_000_000, "epochs": 1000}),
    ("prism-dinosiglip-224px+mx-oxe-magic-soup-plus", "prism-dinosiglip-224px+7b",
     "oxe_magic_soup_plus_minus",
     {**_BRIDGE_BASE, "expected_world_size": 64, "global_batch_size": 2048,
      "per_device_batch_size": 32, "shuffle_buffer_size": 1_000_000, "epochs": 1000}),
    # TDROID / DROID fine-tunes
    ("siglip-224px+mx-tdroid_carrot_in_bowl", "siglip-224px+7b", "tdroid_carrot_in_bowl", _BRIDGE_BASE),
    ("siglip-224px+mx-tdroid_pour_corn_in_pot", "siglip-224px+7b", "tdroid_pour_corn_in_pot", _BRIDGE_BASE),
    ("siglip-224px-icy+mx-tdroid_carrot_in_bowl", "siglip-224px+7b", "tdroid_carrot_in_bowl",
     {**_BRIDGE_BASE, "freeze_vision_backbone": True}),
    ("siglip-224px-last_layer+mx-tdroid_carrot_in_bowl", "siglip-224px+7b", "tdroid_carrot_in_bowl",
     {**_BRIDGE_BASE, "freeze_vision_backbone": True, "freeze_llm_backbone": True,
      "unfreeze_last_llm_layer": True}),
    ("siglip-224px-sandwich+mx-tdroid_carrot_in_bowl", "siglip-224px+7b", "tdroid_carrot_in_bowl",
     {**_BRIDGE_BASE, "freeze_llm_backbone": True, "unfreeze_last_llm_layer": True}),
    ("siglip-224px+mx-droid_wipe", "siglip-224px+7b", "droid_wipe", _BRIDGE_BASE),
]


def _make_experiment(vla_id: str, base_vlm: Optional[str], data_mix: str,
                     overrides: Dict) -> type:
    values = dict(vla_id=vla_id, data_mix=data_mix, **overrides)
    if base_vlm is not None:
        values["base_vlm"] = base_vlm
    fields = [(k, type(v) if v is not None else Optional[int], field(default=v))
              for k, v in values.items()]
    cls = dataclasses.make_dataclass(
        "Exp_" + vla_id.replace("+", "_").replace("-", "_"), fields, bases=(VLAConfig,))
    VLAConfig.register_subclass(vla_id, cls)
    return cls


EXPERIMENTS: Dict[str, type] = {
    spec[0]: _make_experiment(*spec) for spec in _EXPERIMENTS
}

# Flagship Emma-X policy (README's published run).
EMMA_X_FLAGSHIP_ID = "prism-dinosiglip-224px+mx-moveonly-moveguided-single-policy"
