"""Configuration: the VLM and VLA tables and CLI parsing."""

from emmax_torch.conf.models import ModelConfig
from emmax_torch.conf.registry import (ChoiceRegistry, config_to_dict,
                                       parse_config)
from emmax_torch.conf.vla import EMMA_X_FLAGSHIP_ID, VLAConfig

__all__ = ["ChoiceRegistry", "ModelConfig", "VLAConfig", "EMMA_X_FLAGSHIP_ID",
           "parse_config", "config_to_dict"]
