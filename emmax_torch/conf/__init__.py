"""Configuration: the VLM, VLA and dataset tables and CLI parsing."""

from emmax_torch.conf.datasets import DatasetConfig
from emmax_torch.conf.models import ModelConfig
from emmax_torch.conf.registry import (ChoiceRegistry, config_to_dict,
                                       dump_config, parse_config)
from emmax_torch.conf.vla import EMMA_X_FLAGSHIP_ID, VLAConfig

__all__ = ["ChoiceRegistry", "DatasetConfig", "ModelConfig", "VLAConfig",
           "EMMA_X_FLAGSHIP_ID", "parse_config", "dump_config",
           "config_to_dict"]
