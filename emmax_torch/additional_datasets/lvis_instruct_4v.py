"""The LVIS-Instruct-4V mix, port of
``scripts/additional-datasets/lvis_instruct_4v.py``.

Checks every image the LLaVA-format ``lvis_instruct4v_220k.json`` names
and writes ``llava_v1_5_lvis4v_mix888k.json`` in the reference's order
(``random.seed(7)`` then 3 shuffles). The raw JSON's download is the
reference's; this starts from the file.

    python -m emmax_torch.additional_datasets.lvis_instruct_4v \\
        --base_dir data/download/llava-v1.5-instruct
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from emmax_torch.additional_datasets.lrv_instruct import triple_shuffle
from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)


def build_lvis_instruct_4v(base_dir, *, verify_images: bool = True) -> int:
    base_dir = Path(base_dir)
    data = json.loads((base_dir / "lvis_instruct4v_220k.json").read_text())
    if verify_images:
        for ex in data:
            if not (base_dir / ex["image"]).exists():
                raise FileNotFoundError(f"Missing Image `{ex['image']}`")
    base = json.loads((base_dir / "llava_v1_5_mix665k.json").read_text())
    merged = triple_shuffle(base + data)
    out = base_dir / "llava_v1_5_lvis4v_mix888k.json"
    out.write_text(json.dumps(merged))
    overwatch.info(f"{out.name}: {len(merged)} examples")
    return len(merged)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--base_dir",
                        default="data/download/llava-v1.5-instruct")
    parser.add_argument("--skip_image_verification", action="store_true")
    args = parser.parse_args(argv)
    return build_lvis_instruct_4v(
        args.base_dir, verify_images=not args.skip_image_verification)


if __name__ == "__main__":
    main()
