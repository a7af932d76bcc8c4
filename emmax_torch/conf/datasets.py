"""Pretraining-dataset configurations (the LLaVA v1.5 mixes), the port's
copy of ``emmax_tpu/conf/datasets.py``: the align stage's caption set and
each mix's finetune stage JSON, relative to ``dataset_root_dir``."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

from emmax_torch.conf.registry import ChoiceRegistry


@dataclass
class DatasetConfig(ChoiceRegistry):
    dataset_id: str = "llava-v15"
    align_stage_components: Tuple[Path, Path] = (
        Path("download/llava-laion-cc-sbu-558k/chat.json"),
        Path("download/llava-laion-cc-sbu-558k/"),
    )
    finetune_stage_components: Tuple[Path, Path] = (
        Path("download/llava-v1.5-instruct/llava_v1_5_mix665k.json"),
        Path("download/llava-v1.5-instruct/"),
    )
    dataset_root_dir: Path = Path("data/prismatic-vlms")


@DatasetConfig.register_subclass("llava-v15")
@dataclass
class LLaVaV15Config(DatasetConfig):
    dataset_id: str = "llava-v15"


@DatasetConfig.register_subclass("llava-multimodal")
@dataclass
class LLaVaMultimodalOnlyConfig(DatasetConfig):
    dataset_id: str = "llava-multimodal"
    finetune_stage_components: Tuple[Path, Path] = (
        Path("download/llava-v1.5-instruct/llava_v1_5_stripped625k.json"),
        Path("download/llava-v1.5-instruct/"),
    )


@DatasetConfig.register_subclass("llava-lvis4v")
@dataclass
class LLaVaLVIS4VConfig(DatasetConfig):
    dataset_id: str = "llava-lvis4v"
    finetune_stage_components: Tuple[Path, Path] = (
        Path("download/llava-v1.5-instruct/llava_v1_5_lvis4v_mix888k.json"),
        Path("download/llava-v1.5-instruct/"),
    )


@DatasetConfig.register_subclass("llava-lrv")
@dataclass
class LLaVaLRVConfig(DatasetConfig):
    dataset_id: str = "llava-lrv"
    finetune_stage_components: Tuple[Path, Path] = (
        Path("download/llava-v1.5-instruct/llava_v1_5_lrv_mix1008k.json"),
        Path("download/llava-v1.5-instruct/"),
    )


@DatasetConfig.register_subclass("llava-lvis4v-lrv")
@dataclass
class LLaVaLVIS4VLRVConfig(DatasetConfig):
    dataset_id: str = "llava-lvis4v-lrv"
    finetune_stage_components: Tuple[Path, Path] = (
        Path("download/llava-v1.5-instruct/"
             "llava_v1_5_lvis4v_lrv_mix1231k.json"),
        Path("download/llava-v1.5-instruct/"),
    )
