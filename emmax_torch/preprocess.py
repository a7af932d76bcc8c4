"""VLM pretraining data acquisition CLI, port of ``scripts/preprocess.py``.

Downloads and unpacks the LLaVA corpora (``llava-laion-cc-sbu-558k`` for
the align stage, ``llava-v1.5-instruct`` for finetune) and converts
OCR-VQA's images to JPG. Needs the network.

    python -m emmax_torch.preprocess --dataset_id llava-v1.5-instruct
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path

from emmax_torch.conf import parse_config
from emmax_torch.data.download import (DATASET_COMPONENTS, convert_to_jpg,
                                       download_extract)
from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)


@dataclass
class PreprocessConfig:
    dataset_id: str = "llava-v1.5-instruct"
    root_dir: Path = Path("data")


def main(cfg: PreprocessConfig) -> None:
    if cfg.dataset_id not in DATASET_COMPONENTS:
        raise SystemExit(f"unknown --dataset_id {cfg.dataset_id!r}; "
                         f"known: {sorted(DATASET_COMPONENTS)}")
    overwatch.info(f"Downloading & extracting `{cfg.dataset_id}` to "
                   f"`{Path(cfg.root_dir) / 'download'}`")
    download_extract(cfg.dataset_id, root_dir=cfg.root_dir)
    if cfg.dataset_id == "llava-v1.5-instruct":
        ocr_dir = (Path(cfg.root_dir) / "download" / cfg.dataset_id
                   / "ocr_vqa" / "images")
        if ocr_dir.is_dir():
            convert_to_jpg(ocr_dir)


if __name__ == "__main__":
    main(parse_config(PreprocessConfig, sys.argv[1:]))
