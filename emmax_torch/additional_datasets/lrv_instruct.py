"""LRV-Instruct -> LLaVA chat format, and its mixes; port of
``scripts/additional-datasets/lrv_instruct.py``.

Converts the raw LRV Visual Genome and chart JSONs (``{"image_id",
"question", "answer"}``) to LLaVA chat entries, checks that each image
exists, and writes the two mixes the reference publishes:

- ``llava_v1_5_lrv_mix1008k.json``: llava-v1.5 + LRV;
- ``llava_v1_5_lvis4v_lrv_mix1231k.json``: llava-v1.5 + LVIS-4V + LRV.

The order is the reference's (``random.seed(7)`` then 3 shuffles of the
concatenation), so a regenerated mix compares byte for byte. The raw
downloads are the reference's; this starts from the downloaded files.

    python -m emmax_torch.additional_datasets.lrv_instruct \\
        --base_dir data/download/llava-v1.5-instruct
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path
from typing import Dict, List, Optional

from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)


def convert_lrv_examples(examples: List[Dict], image_prefix: str,
                         image_suffix: str = "",
                         image_dir: Optional[Path] = None) -> List[Dict]:
    """Raw LRV entries -> LLaVA chat entries. ``image_prefix`` is the
    directory under the LLaVA data root (``lrv/lrv-vg`` or
    ``lrv/lrv-chart``); VG ids take a ``.jpg`` suffix, chart ids are file
    names. With ``image_dir`` every image must exist."""
    out = []
    for ex in examples:
        image_rel = f"{ex['image_id']}{image_suffix}"
        if image_dir is not None and not (Path(image_dir) / image_rel).exists():
            raise FileNotFoundError(f"Missing Image `{image_rel}`")
        out.append({
            "id": Path(str(ex["image_id"])).stem,
            "image": f"{image_prefix}/{image_rel}",
            "conversations": [
                {"from": "human",
                 "value": f"<image>\n{ex['question'].strip()}"},
                {"from": "gpt", "value": ex["answer"].strip()},
            ],
        })
    return out


def triple_shuffle(examples: List[Dict], seed: int = 7) -> List[Dict]:
    """The reference's order: ``random.seed(seed)``, then 3 shuffles in
    place."""
    random.seed(seed)
    for _ in range(3):
        random.shuffle(examples)
    return examples


def build_lrv_instruct(base_dir, *, verify_images: bool = True
                       ) -> Dict[str, int]:
    base_dir = Path(base_dir)
    lrv_dir = base_dir / "lrv"
    vg_examples: List[Dict] = []
    for fn in ("filter_cap1.json", "filter_cap_more1.json"):
        vg_examples.extend(json.loads((lrv_dir / fn).read_text()))
    chart_examples = json.loads(
        (lrv_dir / "chart_release_update.json").read_text())

    lrv_data = convert_lrv_examples(
        vg_examples, "lrv/lrv-vg", image_suffix=".jpg",
        image_dir=(lrv_dir / "lrv-vg") if verify_images else None)
    lrv_data += convert_lrv_examples(
        chart_examples, "lrv/lrv-chart",
        image_dir=(lrv_dir / "lrv-chart") if verify_images else None)

    counts = {}
    for base_name, out_name in (
            ("llava_v1_5_mix665k.json", "llava_v1_5_lrv_mix1008k.json"),
            ("llava_v1_5_lvis4v_mix888k.json",
             "llava_v1_5_lvis4v_lrv_mix1231k.json")):
        base = json.loads((base_dir / base_name).read_text())
        merged = triple_shuffle(base + lrv_data)
        (base_dir / out_name).write_text(json.dumps(merged))
        counts[out_name] = len(merged)
        overwatch.info(f"{out_name}: {len(merged)} examples")
    return counts


def main(argv=None) -> Dict[str, int]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--base_dir",
                        default="data/download/llava-v1.5-instruct")
    parser.add_argument("--skip_image_verification", action="store_true")
    args = parser.parse_args(argv)
    return build_lrv_instruct(args.base_dir,
                              verify_images=not args.skip_image_verification)


if __name__ == "__main__":
    main()
