"""Configuration: the VLA experiment table and CLI parsing."""

from emmax_torch.conf.registry import (ChoiceRegistry, config_to_dict,
                                       parse_config)
from emmax_torch.conf.vla import EMMA_X_FLAGSHIP_ID, VLAConfig

__all__ = ["ChoiceRegistry", "VLAConfig", "EMMA_X_FLAGSHIP_ID",
           "parse_config", "config_to_dict"]
