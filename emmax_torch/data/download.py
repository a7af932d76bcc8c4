"""Pretraining-data acquisition, port of ``emmax_tpu/data/download.py``.

The LLaVA align / instruct corpora (``DATASET_COMPONENTS``), fetched with
``curl`` and unpacked; the mixing of extra instruct sets (LRV,
LVIS-Instruct-4V) with a seed-7 shuffle; and OCR-VQA's image conversion to
JPG, which imports PIL only when it is called. Downloads need the network;
the mixing is local.
"""

from __future__ import annotations

import json
import random
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

DATASET_COMPONENTS: Dict[str, List[Dict]] = {
    "llava-laion-cc-sbu-558k": [
        {"name": "chat.json",
         "url": "https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/resolve/main/blip_laion_cc_sbu_558k.json",
         "extract": False},
        {"name": "images.zip",
         "url": "https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/resolve/main/images.zip",
         "extract": True},
    ],
    "llava-v1.5-instruct": [
        {"name": "llava_v1_5_mix665k.json",
         "url": "https://huggingface.co/datasets/liuhaotian/LLaVA-Instruct-150K/resolve/main/llava_v1_5_mix665k.json",
         "extract": False},
    ],
}


def download_with_progress(url: str, dest: Path) -> Path:
    """``curl -L --fail -o dest url``."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    overwatch.info(f"downloading {url} -> {dest}")
    subprocess.run(["curl", "-L", "--fail", "-o", str(dest), url], check=True)
    return dest


def download_extract(dataset_id: str, root_dir) -> None:
    """Each component of ``dataset_id`` into ``root/download/<id>/``
    (skipped when present), archives unpacked beside it."""
    root = Path(root_dir) / "download" / dataset_id
    for comp in DATASET_COMPONENTS[dataset_id]:
        dest = root / comp["name"]
        if dest.exists():
            continue
        download_with_progress(comp["url"], dest)
        if comp["extract"]:
            shutil.unpack_archive(dest, root)


def mix_instruct_datasets(base_json, extra_jsons: Sequence, out_json,
                          seed: int = 7) -> int:
    """Shuffle-merge LLaVA-format chat JSONs; returns the example count."""
    examples = json.loads(Path(base_json).read_text())
    for extra in extra_jsons:
        examples.extend(json.loads(Path(extra).read_text()))
    random.Random(seed).shuffle(examples)
    Path(out_json).parent.mkdir(parents=True, exist_ok=True)
    Path(out_json).write_text(json.dumps(examples))
    overwatch.info(f"mixed {len(examples)} examples -> {out_json}")
    return len(examples)


def convert_to_jpg(image_dir) -> None:
    """Every GIF / PNG of ``image_dir`` as a JPG beside it (a GIF's first
    frame, RGB); JPGs and stems already converted are skipped."""
    from PIL import Image

    image_dir = Path(image_dir)
    overwatch.info(f"Converting all images in `{image_dir}` to JPG")
    for image_fn in sorted(image_dir.iterdir()):
        if image_fn.suffix in {".jpg", ".jpeg"}:
            continue
        jpg_fn = image_dir / f"{image_fn.stem}.jpg"
        if jpg_fn.exists():
            continue
        if image_fn.suffix == ".gif":
            gif = Image.open(image_fn)
            gif.seek(0)
            gif.convert("RGB").save(jpg_fn)
        elif image_fn.suffix == ".png":
            Image.open(image_fn).convert("RGB").save(jpg_fn)
        else:
            raise ValueError(f"Unexpected image format `{image_fn.suffix}`")
