"""Prismatic VLM pretraining datasets and the GCOT validation set, port of
``emmax_tpu/data/pretrain.py``.

``AlignDataset`` (one caption turn, supervision on the caption only) and
``FinetuneDataset`` (whole multi-turn conversations, supervision on the
GPT turns) read the LLaVA chat JSON ``[{"image": rel_path?,
"conversations": [{"from": "human"|"gpt", "value": ...}, ...]}, ...]``;
rows without an image are text-only (``collate_lm``'s
``multimodal_indices``). Images are decoded by ``image_loader(root, rel)``
(uint8 RGB ``[H, W, 3]``, or None without an image); the default,
``_load_image``, needs OpenCV, which is imported only when an image is
read. ``ValDataset`` is the GCOT validation set of
``emmax_torch.generate``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from emmax_torch.data.gcot import assemble_gcot_text, parse_image_path
from emmax_torch.models.llama import IGNORE_INDEX
from emmax_torch.vla.prompting import PromptBuilder


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading and writing images needs OpenCV (cv2), "
                          "which is not installed; pass the datasets an "
                          "image_loader") from e
    return cv2


def _load_image(root: Path, rel) -> Optional[np.ndarray]:
    if rel is None:
        return None
    cv2 = _cv2()
    img = cv2.imread(str(Path(root) / rel), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(Path(root) / rel)
    return img[..., ::-1].copy()


class _ChatDataset:
    """The chat JSON, its image root and tokenizer, and the modality /
    length table of the split-modality sampler."""

    def __init__(self, chat_json, image_dir, tokenizer,
                 image_loader=_load_image) -> None:
        with open(chat_json) as f:
            self.examples = json.load(f)
        self.image_dir = Path(image_dir)
        self.tokenizer = tokenizer
        self.image_loader = image_loader

    def __len__(self) -> int:
        return len(self.examples)

    def modality_lengths(self):
        """[(is_multimodal, approximate length)] without reading an image
        (words over all turns)."""
        return [(ex.get("image") is not None,
                 sum(len(turn["value"].split())
                     for turn in ex["conversations"]))
                for ex in self.examples]

    def _image(self, ex):
        return self.image_loader(self.image_dir, ex.get("image"))


class AlignDataset(_ChatDataset):
    """Caption-only alignment stage: ``<image> caption`` becomes ``{bos}
    caption{eos}`` (the patches go in after BOS); only the caption and
    EOS are supervised."""

    def __getitem__(self, idx: int) -> Dict:
        ex = self.examples[idx]
        caption = ex["conversations"][-1]["value"].replace("<image>",
                                                           "").strip()
        ids = self.tokenizer.encode(caption, add_special_tokens=True)
        ids = ids + [self.tokenizer.eos_id]
        labels = list(ids)
        labels[0] = IGNORE_INDEX  # BOS
        return {"image": self._image(ex), "input_ids": ids, "labels": labels}


class FinetuneDataset(_ChatDataset):
    """Multi-turn instruct stage: the whole conversation through the
    prompt builder; only the GPT turns' tokens are supervised."""

    def __init__(self, chat_json, image_dir, tokenizer,
                 prompt_style: str = "vicuna-v15",
                 image_loader=_load_image) -> None:
        super().__init__(chat_json, image_dir, tokenizer, image_loader)
        self.prompt_style = prompt_style

    def __getitem__(self, idx: int) -> Dict:
        ex = self.examples[idx]
        pb = PromptBuilder(self.prompt_style)
        input_ids: List[int] = []
        labels: List[int] = []
        for t, turn in enumerate(ex["conversations"]):
            wrapped = pb.add_turn(turn["from"], turn["value"])
            if t == 0:
                turn_ids = self.tokenizer.encode(pb.get_prompt(),
                                                 add_special_tokens=True)
            else:
                turn_ids = self.tokenizer.encode(wrapped,
                                                 add_special_tokens=False)
            input_ids.extend(turn_ids)
            labels.extend(turn_ids if turn["from"] == "gpt"
                          else [IGNORE_INDEX] * len(turn_ids))
        return {"image": self._image(ex), "input_ids": input_ids,
                "labels": labels}


class ValDataset:
    """Map-style GCOT val dataset: each item's raw frame, its prompt string
    (the "pure" prompt of the GCOT question) and its ground-truth text."""

    def __init__(self, data, action_tokenizer, frame_source,
                 data_mix: str = "movement_policy") -> None:
        if isinstance(data, (str, Path)):
            with open(data) as f:
                data = json.load(f)
        self.data = list(data)
        self.action_tokenizer = action_tokenizer
        self.frame_source = frame_source
        self.data_mix = data_mix

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        item = self.data[idx]
        key, frame_idx = parse_image_path(item["current_image_path"])
        image = self.frame_source.get_frame(key, frame_idx)
        prompt_str, gt = assemble_gcot_text(item, self.data_mix,
                                            self.action_tokenizer)
        pb = PromptBuilder("pure")
        pb.add_turn("human", prompt_str)
        return {"image": image, "prompt": pb.get_prompt(), "ground_truth": gt}


def make_synthetic_chat_json(path, n: int, with_images: bool = True,
                             image_dir: Optional[Path] = None,
                             text_only_every: int = 0) -> None:
    """Synthetic LLaVA-format data for tests and smoke runs: ``n``
    examples with seeded 64x64 JPEGs; with ``text_only_every=k`` every
    k-th example has no image (the mixed-modality corpora)."""
    cv2 = _cv2()
    examples = []
    rng = np.random.default_rng(0)
    for i in range(n):
        ex = {"conversations": [
            {"from": "human", "value": f"<image>\nWhat is in image {i}?"},
            {"from": "gpt", "value": f"A synthetic object number {i}."},
        ]}
        text_only = text_only_every and i % text_only_every == 0
        if with_images and image_dir is not None and not text_only:
            rel = f"img_{i}.jpg"
            img = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
            Path(image_dir).mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(Path(image_dir) / rel), img[..., ::-1])
            ex["image"] = rel
        examples.append(ex)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(examples, f)
